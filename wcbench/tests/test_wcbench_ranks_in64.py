"""The four-card cell ``train.in64_cwcsa_dp4`` rehearsed on the CPU: four
processes of one gloo group (``wcgan_tpu_torch.parallel.launch``), each
holding its shard of the data and its rows of the global batch, rank 0
checking against the reference on the global batch, at the tiny copy of
the conditional cWC-sa configuration.

In float32 each outer step follows the reference to rounding (the gates
of ``test_wcbench_ranks.py``). Over the traffic's chain of 8 the gradients
still do, but the change and the losses part by up to ~2e-4 on some seeds
(seed 41: 1.8e-4 and 1.2e-4 on two ranks, 1.1e-4 and 3.9e-4 on four; in
one process 8e-8 and 4e-7): the coloring biases ``beta_a`` feed a
convolution and the next whitening, which takes all but the border's
share of them out, so their gradients nearly cancel, a rank's rounding
moves them by another share of Adam's step, and the 8 steps carry that
into the rest. A wrong reduction moves every number by orders more."""

import argparse

import pytest

from wcgan_tpu_torch.parallel import launch

CELL = "train.in64_cwcsa_dp4"
FLOAT32 = {"dtype": "float32", "whitening_precision": "highest"}


def numbers_rank(ctx, seed, changes, traffic):
  """One rank of the cell at its tiny configuration (with top-level
  ``changes``) and its traffic (with ``traffic``'s changes); rank 0's
  numbers, each with where it was read."""
  import torch.distributed as dist
  from wcbench import run as bench_run
  from wcbench.core import harness
  from wcbench.tests import tiny
  bench = harness.benchmark()
  a = argparse.Namespace(workload=CELL, seed=seed, seconds=0.0, trace=0,
                         rank=ctx.rank)
  cfg = dict(tiny.tiny_config(harness.workload(CELL, bench)["config"]),
             **changes)
  run = bench_run.make_run(a, ctx.device, bench, group=ctx.group,
                           rank=ctx.rank, world=ctx.world_size, cfg=cfg)
  run.traffic = dict(run.traffic, **traffic)
  result = harness.driver(run.traffic["driver"]).run(run)
  dist.barrier(group=ctx.group)
  return result.numbers if ctx.rank == 0 else None


def _rank0(seed, changes=None, fault=None):
  return launch.launch("wcbench.tests.tiny:dp_rank", ["cpu"] * 4,
                       (CELL, seed, changes, fault), timeout=600)[0]


@pytest.mark.parametrize("steps,follow_gate", [(1, 1e-5), (8, 1e-3)])
def test_ranks_follow_the_reference_in_float32(steps, follow_gate):
  """Chains of ``steps``, the last one checked (the 24th outer step, or
  the third chain of 8)."""
  traffic = {"steps_per_call": steps, "checked_calls": 24 // steps}
  n = launch.launch(f"{__name__}:numbers_rank", ["cpu"] * 4,
                    (41, FLOAT32, traffic), timeout=600)[0]
  assert n["g_grad_gap"]["value"] < 1e-4, n
  assert n["d_grad_gap"]["value"] < 1e-4, n
  assert n["change_gap"]["loss_gap"] < follow_gate, n
  assert n["change_gap"]["value"] < follow_gate, n


def test_a_sound_run_is_correct():
  assert _rank0(42)["correct"]


@pytest.mark.parametrize("fault", ["no_exchange", "half_batch"])
def test_a_planted_fault_is_not_correct(fault):
  assert not _rank0(43, fault=fault)["correct"]
