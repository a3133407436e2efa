"""One run of one cell of the benchmark of ``wcgan_tpu_torch`` (the
PyTorch/CUDA port of the WC-GAN trainer), from the root of a checkout:

  python3 wcbench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

A fresh process: it builds the cell's program (set-up: weights and data
from the seed on the device, the kernels from ``build/kernels`` in the
checkout, the warm-up and capture of the cell's own program), measures
the cell's traffic for ``--seconds``, checks what the timed path produced
against the plain reference (``wcbench/reference``), and prints one JSON
line as its last line of standard output:

  {"correct", "attempted", "failed", "metrics", "device"
   [, "breakdown" with --trace 1], "checks"}

With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer ones, from ``torch.profiler`` over a few more
calls after the untraced window. A cell on four chips starts one process
a card (NCCL); rank 0 prints. Without as many CUDA cards as the cell asks
for, or with JAX or the JAX package loaded, it prints no result and exits
with another code than 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
  sys.path.insert(0, str(ROOT))

from wcbench.core import harness  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
  p = argparse.ArgumentParser(prog="wcbench/run.py",
                              description=__doc__.splitlines()[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seed", type=int, required=True)
  p.add_argument("--seconds", type=float, required=True)
  p.add_argument("--trace", type=int, choices=(0, 1), default=0)
  p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
  p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
  a = p.parse_args(argv)
  if a.seed < 0:
    p.error("--seed takes a non-negative whole number")
  return a


def make_run(a: argparse.Namespace, device, bench: dict, group=None,
             rank: int = 0, world: int = 1, cfg: dict = None,
             limits: dict = None) -> harness.Run:
  w = harness.workload(a.workload, bench)
  return harness.Run(
      cell=a.workload, cfg=cfg or harness.config(w["config"]),
      traffic=harness.traffic(w["traffic"]),
      limits=limits or harness.cell(a.workload)["limits"], seed=a.seed,
      seconds=a.seconds, trace=bool(a.trace), device=device,
      chips=w["chips"], group=group, rank=rank, world=world)


def metrics_of(run: harness.Run, result: harness.Result, bench: dict
               ) -> dict:
  """The cell's metrics for this run, by name: end-to-end ones untraced,
  per-layer ones traced (a reader that finds nothing is left out)."""
  out = {}
  for m in harness.cell_metrics(run.cell, bench, run.trace):
    if run.trace:
      value = harness.metric_reader(m["name"])(Context(run, result))
    else:
      value = (result.setup_s if m["name"] == "setup_s"
               else result.e2e.get(m["name"]))
    if value is not None:
      out[m["name"]] = {"value": value, "unit": m["unit"]}
  return out


class Context:
  """What a per-layer metric's reader reads: the run (its configuration,
  traffic and chips), the untraced window and the traced slice."""

  def __init__(self, run: harness.Run, result: harness.Result):
    self.run, self.result = run, result
    self.cfg, self.traffic = run.cfg, run.traffic
    self.window, self.slice = result.window, result.slice
    self.chips = run.chips


def result_line(run: harness.Run, result: harness.Result, bench: dict,
                devices: dict) -> dict:
  from wcbench.core import check
  ok, checks = check.judge(result.numbers, run.limits)
  line = {"correct": bool(ok and result.failed == 0
                          and result.attempted > 0),
          "attempted": result.attempted, "failed": result.failed,
          "metrics": metrics_of(run, result, bench), "device": devices}
  if run.trace and result.slice is not None:
    line["breakdown"] = result.slice.breakdown()
  line["checks"] = checks
  return line


def device_of(run: harness.Run, result: harness.Result,
              peaks=None, busy=None) -> dict:
  import torch
  dev = run.device
  out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
         "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                  else "cpu"),
         "count": run.chips,
         "memory_peak_bytes": max(peaks or [result.memory_peak_bytes])}
  if run.trace and result.slice is not None:
    busy = busy or [result.slice.busy_s()]
    out["busy_s"] = sum(busy) / len(busy)
    out["window_s"] = result.slice.wall_s
  return out


def report(run: harness.Run, result: harness.Result, bench: dict,
           devices: dict) -> int:
  """Print the record and the checks on standard error and the result's
  line on standard output; 0, or 4 when JAX or the JAX package is
  loaded."""
  loaded = harness.forbidden_modules()
  if loaded:
    harness.log(f"refusing to report: {loaded} loaded in this process")
    return 4
  line = result_line(run, result, bench, devices)
  harness.log("device record", json.dumps(
      {**harness.card_info(run.device), "whitening_precision":
       run.cfg["whitening_precision"], "window": result.device_record,
       "setup_s": result.setup_s, "setup_stages_s": result.stages,
       "window_s": result.window["wall_s"],
       "calls": result.window["calls"],
       "launches_per_step": result.window.get("launches_per_step")}))
  harness.log("where the numbers were read", json.dumps(
      {k: {kk: vv for kk, vv in v.items() if kk != "value"}
       for k, v in result.numbers.items()}))
  for name, c in line["checks"].items():
    harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
  print(json.dumps(line), flush=True)
  return 0


def run_one(a: argparse.Namespace, device, bench: dict) -> int:
  run = make_run(a, device, bench)
  drv = harness.driver(run.traffic["driver"])
  result = drv.run(run)
  return report(run, result, bench, device_of(run, result))


def main(argv=None) -> int:
  a = parse_args(argv)
  os.environ.setdefault("USE_FLAX", "0")
  bench = harness.benchmark()
  if a.rank is not None:
    from wcbench.core import ranks
    return ranks.rank_main(a, bench)
  chips = harness.workload(a.workload, bench)["chips"]
  import torch
  if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
    harness.log(f"{a.workload} needs {chips} CUDA card(s); torch sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return 3
  if chips > 1:
    from wcbench.core import ranks
    return ranks.main(a, bench, chips)
  return run_one(a, torch.device("cuda", 0), bench)


if __name__ == "__main__":
  raise SystemExit(main())
