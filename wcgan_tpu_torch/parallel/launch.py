"""Start N ranks, each in a fresh interpreter, and join them.

``launch(target, devices, args)`` runs ``target(ctx, *args)`` once per
device in ``devices``, each in its own ``python -m
wcgan_tpu_torch.parallel.launch`` process inside one process group, and
returns what each rank's call returned (rank order). ``target`` is a
``"module:function"`` path of the port, so a rank imports nothing but the
port and what that module imports (never the caller's modules, such as a
test module). Arguments and results cross through ``torch.save`` files
in a fresh job directory, which also holds the ``file://`` rendezvous, so
that concurrent jobs never share a port or a store.

A rank that raises, dies or outlives ``timeout`` fails the whole job: the
others are terminated (then killed), and ``launch`` raises with the
failing rank's traceback. The group's own timeout makes a collective that
waits for a lost rank raise inside the survivors too.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, List, Optional, Sequence

import torch

from wcgan_tpu_torch.parallel import mesh

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_FORBIDDEN = ("wcgan_tpu", "jax", "jaxlib", "flax", "optax", "orbax")
# A collective waiting longer for another rank raises (a checkpoint that
# rank 0 writes while the others wait stays well inside it).
GROUP_TIMEOUT_S = 300.0


@dataclasses.dataclass
class RankContext:
  """What a rank's target is given: its group, rank, world size and
  device."""

  group: Any
  rank: int
  world_size: int
  device: torch.device


class RankFailed(RuntimeError):
  pass


def _resolve(target: str):
  module, _, name = target.partition(":")
  return getattr(importlib.import_module(module), name)


def launch(target: str, devices: Sequence[str], args: Sequence[Any] = (),
           timeout: Optional[float] = 120.0, quiet: bool = False
           ) -> List[Any]:
  """Run ``target(ctx, *args)`` on ``len(devices)`` ranks, rank r on
  ``devices[r]`` ('cpu' or 'cuda:N'), over ``mesh.backend_for(devices)``,
  and return the ranks' results. ``timeout`` bounds the whole job in
  seconds (None: no bound), ``GROUP_TIMEOUT_S`` each collective.
  ``quiet`` sends the ranks' stdout to the job directory instead of this
  process's (their stderr is always kept)."""
  devs = [torch.device(d) for d in devices]
  backend = mesh.backend_for(devs)
  job = tempfile.mkdtemp(prefix="wcgan_dp_")
  try:
    torch.save({"target": target, "devices": [str(d) for d in devs],
                "args": tuple(args), "backend": backend,
                "init_method": "file://" + os.path.join(job, "rendezvous")},
               os.path.join(job, "job.pt"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_PKG_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    procs = []
    try:
      for r in range(len(devs)):
        out = (open(os.path.join(job, f"rank{r}.out"), "w") if quiet
               else None)
        try:
          procs.append(subprocess.Popen(
              [sys.executable, "-m", "wcgan_tpu_torch.parallel.launch", job,
               str(r)], env=env, stdout=out))
        finally:
          if out is not None:
            out.close()
      _wait(procs, job, timeout)
    finally:
      _stop(procs)
    results = []
    for r in range(len(devs)):
      res = torch.load(os.path.join(job, f"rank{r}.pt"), weights_only=False)
      if res["modules"]:
        raise RankFailed(f"rank {r} of {target} imported {res['modules']}")
      results.append(res["result"])
    return results
  finally:
    shutil.rmtree(job, ignore_errors=True)


def _wait(procs, job: str, timeout: Optional[float]) -> None:
  """Wait for every rank; raise at the first failure or the deadline."""
  deadline = None if timeout is None else time.monotonic() + timeout
  while True:
    codes = [p.poll() for p in procs]
    failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
    if failed:
      r = failed[0]
      err = os.path.join(job, f"rank{r}.err")
      why = f"exit code {codes[r]} and no traceback (killed?)"
      if os.path.exists(err):
        with open(err) as f:
          why = f.read()
      raise RankFailed(f"rank {r} of {len(procs)} failed:\n{why}")
    if all(c == 0 for c in codes):
      return
    if deadline is not None and time.monotonic() > deadline:
      alive = [r for r, c in enumerate(codes) if c is None]
      raise RankFailed(f"ranks {alive} of {len(procs)} still running "
                       f"after {timeout} s")
    time.sleep(0.05)


def _stop(procs) -> None:
  """Terminate the ranks still running, then kill those that linger."""
  for p in procs:
    if p.poll() is None:
      p.terminate()
  for p in procs:
    try:
      p.wait(timeout=10)
    except subprocess.TimeoutExpired:
      p.kill()
      p.wait()


def _rank_main(job: str, rank: int) -> int:
  spec = torch.load(os.path.join(job, "job.pt"), weights_only=False)
  try:
    device = torch.device(spec["devices"][rank])
    world = len(spec["devices"])
    if device.type == "cuda":
      torch.cuda.set_device(device)
      # True float32, as the port's entry points pin it (whitening).
      torch.backends.cuda.matmul.allow_tf32 = False
      torch.backends.cudnn.allow_tf32 = False
    else:
      # CPU ranks share the host's cores.
      torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    group = mesh.init_group(rank, world, spec["init_method"],
                            spec["backend"], GROUP_TIMEOUT_S)
    ctx = RankContext(group=group, rank=rank, world_size=world,
                      device=device)
    try:
      result = _resolve(spec["target"])(ctx, *spec["args"])
    finally:
      mesh.destroy_group()
    modules = sorted(m for m in sys.modules if m.split(".")[0] in _FORBIDDEN)
    tmp = os.path.join(job, f"rank{rank}.pt.tmp")
    torch.save({"result": result, "modules": modules}, tmp)
    os.replace(tmp, os.path.join(job, f"rank{rank}.pt"))
    return 0
  except BaseException:
    with open(os.path.join(job, f"rank{rank}.err"), "w") as f:
      f.write(traceback.format_exc())
    raise


if __name__ == "__main__":
  raise SystemExit(_rank_main(sys.argv[1], int(sys.argv[2])))
