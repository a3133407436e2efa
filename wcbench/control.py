"""The readings that a cell's limits are set from, in one process:

  python3 wcbench/control.py --workload <cell> --first-seed <n> \\
      [--seeds 12] [--control-seeds 3] [--fault-seeds 3]

- ``program``: the cell's run with a short window (one call of the
  traffic's unit after set-up, or a second of sampling), on ``--seeds``
  seeds: the lower readings;
- ``control``: the reference with its activation products in float8
  (``Act('fp8')``, the step below the bf16 the configurations state) put
  in the program's place, against the float32 reference, on
  ``--control-seeds`` seeds: the upper readings;
- ``fault:<name>``: the program with a fault planted under the timed path
  (``FAULTS``), on ``--fault-seeds`` seeds.

One JSON line a reading on standard output, then a summary (the largest
program reading, the smallest control and fault readings, per number);
the same as a file under ``chiprun_out/`` when that directory exists.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
from pathlib import Path
from typing import Callable, Dict, Iterator

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
  sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from wcbench import run as bench_run  # noqa: E402
from wcbench.core import check, harness  # noqa: E402
from wcbench.drivers import sample, train  # noqa: E402
from wcbench.reference import wcgan  # noqa: E402


@contextlib.contextmanager
def half_batch() -> Iterator[None]:
  """Every loss a mean over the first half of its batch's rows."""
  from wcgan_tpu_torch.ops import losses
  saved = dict(losses.D_LOSSES), dict(losses.G_LOSSES)
  d, g = saved[0]["hinge"], saved[1]["hinge"]
  losses.D_LOSSES["hinge"] = lambda r, f: d(r[:len(r) // 2],
                                            f[:len(f) // 2])
  losses.G_LOSSES["hinge"] = lambda f: g(f[:len(f) // 2])
  try:
    yield
  finally:
    losses.D_LOSSES.clear()
    losses.D_LOSSES.update(saved[0])
    losses.G_LOSSES.clear()
    losses.G_LOSSES.update(saved[1])


@contextlib.contextmanager
def half_batch_d() -> Iterator[None]:
  """D's loss a mean over the first half of its real and its fake rows;
  G's loss as it is."""
  from wcgan_tpu_torch.ops import losses
  saved = dict(losses.D_LOSSES)
  d = saved["hinge"]
  losses.D_LOSSES["hinge"] = lambda r, f: d(r[:len(r) // 2],
                                            f[:len(f) // 2])
  try:
    yield
  finally:
    losses.D_LOSSES.clear()
    losses.D_LOSSES.update(saved)


@contextlib.contextmanager
def double_lr_d() -> Iterator[None]:
  """D's Adam at twice the learning rate the configuration states."""
  from wcgan_tpu_torch.train import state as st
  saved = st.state_from_modules

  def build(*args, **kwargs):
    out = saved(*args, **kwargs)
    out.d_sched.base_lr *= 2.0
    out.d_sched._write()
    return out

  st.state_from_modules = build
  try:
    yield
  finally:
    st.state_from_modules = saved


@contextlib.contextmanager
def stale_draws() -> Iterator[None]:
  """A graph whose random numbers are fixed at its capture: each replay
  draws the picks, flips and z that the capturing call drew (the state's
  generator put back to where it stood then). On the CPU, which captures
  nothing, every call after the first eager one does the same."""
  from wcgan_tpu_torch import compiled
  saved = compiled.Program.__call__

  def call(self, fn, key, inputs, device, state=None):
    stale = getattr(self, "_stale_draws", None)
    if stale is not None and state is not None:
      state.generator.set_state(stale)
    start = state.generator.get_state() if state is not None else None
    out = saved(self, fn, key, inputs, device, state)
    if stale is None and self.last in ("capture", "eager"):
      self._stale_draws = start
    return out

  compiled.Program.__call__ = call
  try:
    yield
  finally:
    compiled.Program.__call__ = saved


@contextlib.contextmanager
def unchanged_state() -> Iterator[None]:
  """No optimizer step: every update leaves the weights as they were."""
  from wcgan_tpu_torch.train import step
  saved = step._apply
  step._apply = lambda params, grads, opt, sched: None
  try:
    yield
  finally:
    step._apply = saved


@contextlib.contextmanager
def altered_image() -> Iterator[None]:
  """The sampling program's first image of a batch flipped upside down
  where it is produced."""
  from wcgan_tpu_torch.train.trainer import Trainer
  saved = Trainer._sample_body

  def body(self, kind, tensors, z, labels):
    imgs = saved(self, kind, tensors, z, labels)
    return torch.cat([imgs[:1].flip(1), imgs[1:]])

  Trainer._sample_body = body
  try:
    yield
  finally:
    Trainer._sample_body = saved


@contextlib.contextmanager
def no_exchange() -> Iterator[None]:
  """No exchange between the ranks: every mean over the ranks (the
  whitening moments, the losses and gradients) is this rank's own."""
  from wcgan_tpu_torch.parallel import mesh
  saved = mesh.pmean, mesh.pmean_many
  mesh.pmean = lambda x, group: x
  mesh.pmean_many = lambda tensors, group: list(tensors)
  try:
    yield
  finally:
    mesh.pmean, mesh.pmean_many = saved


# The window of a reading: one call of the training chain; enough sampling
# batches to pass every batch the check may keep.
READING_SECONDS = {"train": 0.0, "sample": 3.0}

FAULTS: Dict[str, Dict[str, Callable]] = {
    "train": {"half_batch": half_batch, "half_batch_d": half_batch_d,
              "stale_draws": stale_draws, "double_lr_d": double_lr_d,
              "unchanged_state": unchanged_state, "no_exchange": no_exchange},
    "sample": {"altered_image": altered_image},
}
# Faults a cell can have only across ranks.
ACROSS_RANKS = ("no_exchange",)


def program_numbers(run: harness.Run) -> Dict[str, dict]:
  result = harness.driver(run.traffic["driver"]).run(run)
  return result.numbers


def control_numbers(run: harness.Run) -> Dict[str, dict]:
  """The float8 reference in the program's place, against the float32
  reference, on the cell's inputs from ``run.seed``."""
  cfg, dev = run.cfg, run.device
  if run.traffic["driver"] == "train":
    chain, calls = run.traffic["steps_per_call"], run.traffic["checked_calls"]
    before, after, losses = train.reference_calls(
        cfg, run.seed, chain, calls, dev, wcgan.Act("fp8"), run.world)
    return train.numbers(cfg, run.seed, dev, run.world, chain, calls,
                         before, after, losses)
  prog = sample.Program(run)
  chosen = sample.chosen_batches(run)
  kept = []
  for i in range(run.traffic["check_range"]):
    z, y = prog.draw()
    if i in chosen:
      kept.append((z, y, None))
  prog.free()
  batch = run.traffic["batch"]
  low = sample.reference_images(cfg, run.seed, kept, batch, dev,
                                wcgan.Act("fp8"))
  ref = sample.reference_images(cfg, run.seed, kept, batch, dev,
                                wcgan.Act())
  return check.sample_numbers(low, ref)


def readings(make: Callable[[int], harness.Run], first_seed: int,
             seeds: int, control_seeds: int, fault_seeds: int,
             emit: Callable[[dict], None], faults=None) -> dict:
  """Every reading, each passed to ``emit``; returns the summary.
  ``faults`` names the faults to plant (all of the driver's that the
  cell can have by default). Under a group every rank runs the program's
  readings; rank 0 alone reads the numbers and the control."""
  rows = []
  probe = make(first_seed)
  lead = probe.rank == 0

  def note(kind, seed, numbers):
    if not lead:
      return
    row = {"kind": kind, "seed": seed,
           "numbers": {k: v["value"] for k, v in numbers.items()}}
    rows.append(row)
    emit(row)

  for i in range(seeds):
    run = make(first_seed + i)
    note("program", run.seed, program_numbers(run))
  for name, fault in FAULTS[probe.traffic["driver"]].items():
    if (faults is not None and name not in faults) or (
        name in ACROSS_RANKS and probe.world == 1):
      continue
    for i in range(fault_seeds):
      run = make(first_seed + seeds + i)
      with fault():
        note(f"fault:{name}", run.seed, program_numbers(run))
  for i in range(control_seeds if lead else 0):
    run = make(first_seed + seeds + fault_seeds + i)
    note("control", run.seed, control_numbers(run))
  return summarize(rows)


def summarize(rows) -> dict:
  out: Dict[str, dict] = {}
  for row in rows:
    for name, value in row["numbers"].items():
      entry = out.setdefault(name, {})
      if row["kind"] == "program":
        entry["lower"] = max(entry.get("lower", -math.inf), value)
      else:
        entry[row["kind"]] = min(entry.get(row["kind"], math.inf), value)
  return out


def main(argv=None) -> int:
  p = argparse.ArgumentParser(prog="wcbench/control.py",
                              description=__doc__.splitlines()[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--first-seed", type=int, required=True)
  p.add_argument("--seeds", type=int, default=12)
  p.add_argument("--control-seeds", type=int, default=3)
  p.add_argument("--fault-seeds", type=int, default=3)
  p.add_argument("--faults", default=None,
                 help="comma-separated faults to plant (default: all the "
                      "cell can have)")
  p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
  p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
  a = p.parse_args(argv)
  bench = harness.benchmark()
  chips = harness.workload(a.workload, bench)["chips"]
  if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
    harness.log(f"the readings are taken on {chips} CUDA card(s)")
    return 3
  if chips > 1 and a.rank is None:
    from wcbench.core import ranks
    return ranks.spawn([str(Path(__file__).resolve()), *(argv or sys.argv[1:])],
                       chips)
  group = None
  rank = a.rank or 0
  dev = torch.device("cuda", 0)
  if a.rank is not None:
    from wcbench.core import ranks
    dev, group = ranks.join(a.rank, chips, a.port)

  def make(seed: int) -> harness.Run:
    ns = argparse.Namespace(workload=a.workload, seed=seed, seconds=0.0,
                            trace=0)
    run = bench_run.make_run(ns, dev, bench, group=group, rank=rank,
                             world=chips)
    run.seconds = READING_SECONDS[run.traffic["driver"]]
    return run

  out_dir = ROOT / "chiprun_out"
  lines = []

  def emit(row):
    lines.append(row)
    print(json.dumps(row), flush=True)

  try:
    summary = readings(make, a.first_seed, a.seeds, a.control_seeds,
                       a.fault_seeds, emit,
                       a.faults.split(",") if a.faults else None)
  finally:
    if group is not None:
      from wcgan_tpu_torch.parallel import mesh
      mesh.destroy_group()
  if rank != 0:
    return 0
  record = {"workload": a.workload, "card": harness.card_info(dev),
            "summary": summary, "readings": lines}
  print(json.dumps({"summary": summary}), flush=True)
  if out_dir.is_dir():
    with open(out_dir / f"readings_{a.workload}.json", "w") as f:
      json.dump(record, f, indent=1)
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
