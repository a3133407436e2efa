"""A cell on several cards: one process a card, in one NCCL group, each
running the cell's traffic on its rank of the global batch; rank 0 checks
what the timed path produced against the reference and prints the line.

``main`` (the process the driver starts) picks a free port on localhost,
starts ``run.py --rank r --port p`` for every card, and waits for all of
them; a rank that fails stops the others. Rank 0's standard output is
this process's.
"""

from __future__ import annotations

import argparse
import socket
import subprocess
import sys
import time

import torch

from wcbench.core import harness

GROUP_TIMEOUT_S = 600.0


def free_port() -> int:
  with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
    s.bind(("localhost", 0))
    return s.getsockname()[1]


def main(a: argparse.Namespace, bench: dict, chips: int) -> int:
  return spawn([str(harness.BENCH / "run.py"), "--workload", a.workload,
                "--seed", str(a.seed), "--seconds", str(a.seconds),
                "--trace", str(a.trace)], chips)


def spawn(argv, chips: int) -> int:
  """``python3 <argv> --port p --rank r`` for every card r, waited for;
  the first failing rank's exit code, or 0."""
  cmd = [sys.executable, *argv, "--port", str(free_port())]
  procs = [subprocess.Popen(cmd + ["--rank", str(r)],
                            stdout=None if r == 0 else subprocess.DEVNULL)
           for r in range(chips)]
  try:
    while True:
      codes = [p.poll() for p in procs]
      failed = [c for c in codes if c not in (None, 0)]
      if failed:
        harness.log(f"a rank failed (exit codes {codes})")
        return failed[0]
      if all(c == 0 for c in codes):
        return 0
      time.sleep(0.1)
  finally:
    for p in procs:
      if p.poll() is None:
        p.terminate()
    for p in procs:
      try:
        p.wait(timeout=20)
      except subprocess.TimeoutExpired:
        p.kill()
        p.wait()


def join(rank: int, world: int, port: int):
  """This process's card and its group (NCCL over localhost)."""
  from wcgan_tpu_torch.parallel import mesh
  device = torch.device("cuda", rank)
  torch.cuda.set_device(device)
  return device, mesh.init_group(rank, world, f"tcp://localhost:{port}",
                                 "nccl", GROUP_TIMEOUT_S)


def rank_run(a: argparse.Namespace, bench: dict, device: torch.device,
             group, world: int, **make):
  """This rank's run in ``group``: (run, result, every rank's memory peak
  and busy seconds)."""
  from wcbench import run as bench_run
  import torch.distributed as dist
  run = bench_run.make_run(a, device, bench, group=group, rank=a.rank,
                           world=world, **make)
  result = harness.driver(run.traffic["driver"]).run(run)
  mine = (result.memory_peak_bytes,
          result.slice.busy_s() if result.slice is not None else None)
  every = [None] * world
  dist.all_gather_object(every, mine, group=group)
  return run, result, every


def rank_main(a: argparse.Namespace, bench: dict) -> int:
  from wcbench import run as bench_run
  from wcgan_tpu_torch.parallel import mesh
  world = harness.workload(a.workload, bench)["chips"]
  device, group = join(a.rank, world, a.port)
  try:
    run, result, every = rank_run(a, bench, device, group, world)
    if a.rank != 0:
      return 0
    busy = [b for _, b in every if b is not None]
    return bench_run.report(run, result, bench, bench_run.device_of(
        run, result, peaks=[p for p, _ in every], busy=busy or None))
  finally:
    mesh.destroy_group()
