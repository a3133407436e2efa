"""Tiny copies of the benchmark's configurations, for CPU tests: the same
layer kinds and coloring codes at a few channels and 16 x 16 pixels."""

from __future__ import annotations

import argparse
import copy

import torch

from wcbench import run as bench_run
from wcbench.core import harness


def tiny_config(name: str) -> dict:
  cfg = copy.deepcopy(harness.config(name))
  cond = cfg["gan"]["num_classes"] > 0
  cfg["resolution"], cfg["batch_size"] = 16, 4
  cfg["generator"]["filters"] = [32, 16] if cond else [32, 32]
  cfg["discriminator"]["filters"] = [16, 32, 32]
  cfg["discriminator"]["downsample"] = [True, True, False]
  cfg["dataset"] = {"images": 64, "classes": 5 if cond else 0}
  if cond:
    cfg["gan"]["num_classes"] = 5
    cfg["generator"]["filters_emb"] = 3
  cfg["optim"]["total_outer_steps"] = 50
  return cfg


def run_cpu(cell: str, seed: int = 7, seconds: float = 0.5,
            traffic: dict = None, limits: dict = None, config: str = None,
            **changes):
  """(run, result) of ``cell`` on the CPU at the tiny copy of its
  configuration, or of ``config`` (a file under ``configs/``) in its
  place, with top-level ``changes``; the sample batches cut to 8."""
  bench = harness.benchmark()
  a = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=0)
  w = harness.workload(cell, bench)
  run = bench_run.make_run(a, torch.device("cpu"), bench,
                           cfg=dict(tiny_config(config or w["config"]),
                                    **changes),
                           limits=limits)
  run.traffic = dict(run.traffic, **(traffic or {}))
  if "batch" in run.traffic:
    run.traffic.update(batch=8, check_range=4, checked_batches=2)
  result = harness.driver(run.traffic["driver"]).run(run)
  return run, result


def dp_rank(ctx, cell: str, seed: int, changes: dict = None,
            fault: str = None):
  """One rank of ``cell`` on the CPU at its tiny configuration (with
  top-level ``changes``), in the group ``ctx`` holds
  (``wcgan_tpu_torch.parallel.launch``): on rank 0 whether it is correct,
  its numbers and its window's calls."""
  import torch.distributed as dist
  from wcbench.core import check
  bench = harness.benchmark()
  w = harness.workload(cell, bench)
  a = argparse.Namespace(workload=cell, seed=seed, seconds=0.0, trace=0,
                         rank=ctx.rank)
  run = bench_run.make_run(a, ctx.device, bench, group=ctx.group,
                           rank=ctx.rank, world=ctx.world_size,
                           cfg=dict(tiny_config(w["config"]),
                                    **(changes or {})))
  if fault is None:
    result = harness.driver(run.traffic["driver"]).run(run)
  else:
    from wcbench import control
    with control.FAULTS["train"][fault]():
      result = harness.driver(run.traffic["driver"]).run(run)
  dist.barrier(group=ctx.group)
  if ctx.rank != 0:
    return None
  ok, checks = check.judge(result.numbers, run.limits)
  return {"correct": ok, "checks": checks, "calls": result.window["calls"],
          "numbers": {k: v["value"] for k, v in result.numbers.items()},
          "loss_gap": result.numbers["change_gap"]["loss_gap"]}
