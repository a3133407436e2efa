"""The harness's common parts: a run's settings (``Run``) and result
(``Result``), the files it finds by name, the device record, and the last
line it prints.

Everything a cell uses is found by name under ``wcbench/``:

- ``BENCHMARK.json`` (at the checkout's root) names the cell's
  configuration, traffic, chips and metrics;
- ``configs/<config>.json``: the model, by its published widths;
- ``traffic/<traffic>.json``: the traffic mix, whose ``driver`` names the
  general driver (``drivers/<driver>.py``) that reads it;
- ``cells/<cell>.json``: the limits of the cell's comparison with the
  reference (``check.py``);
- ``metrics/<metric>.py``: one per-layer metric each, a ``read(ctx)``
  that returns a number or None where the cell has nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List

import torch

BENCH = Path(__file__).resolve().parent.parent          # wcbench/
ROOT = BENCH.parent                                     # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "wcgan_tpu")


def load_json(path: Path) -> dict:
  with open(path) as f:
    return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
  return load_json(root / "BENCHMARK.json")


def workload(name: str, bench: dict) -> dict:
  for w in bench["workloads"]:
    if w["name"] == name:
      return w
  raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
  return load_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
  return load_json(BENCH / "traffic" / f"{name}.json")


def cell(name: str) -> dict:
  return load_json(BENCH / "cells" / f"{name}.json")


def driver(name: str):
  return importlib.import_module(f"wcbench.drivers.{name}")


def metric_reader(name: str):
  """``metrics/<name>.py``'s ``read``; metric names hold dots, so the file
  is loaded by its path."""
  path = BENCH / "metrics" / f"{name}.py"
  spec = importlib.util.spec_from_file_location(
      f"wcbench.metrics.{name.replace('.', '_')}", path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module.read


def cell_metrics(name: str, bench: dict, traced: bool) -> List[dict]:
  """The metrics a run of cell ``name`` reports: its end-to-end metrics
  untraced, its per-layer ones traced (those listing the cell, or every
  cell that reports their end-to-end metric when they list none)."""
  e2e = [m for m in bench["end_to_end"]
         if name in m.get("workloads", [name])]
  if not traced:
    return e2e
  names = {m["name"] for m in e2e}
  return [m for m in bench["per_layer"]
          if name in m.get("workloads", [name] if m["moves"] in names
                           else [])]


def forbidden_modules() -> List[str]:
  """Loaded modules whose top-level name is JAX's or the JAX package's."""
  return sorted({m.split(".")[0] for m in sys.modules
                 if m.split(".")[0] in FORBIDDEN})


def sync(device: torch.device) -> None:
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def agreed_stop(run: "Run", stop: bool) -> bool:
  """Whether the window stops after this call: this process's answer, or
  rank 0's under a group (broadcast, so that every rank makes the same
  number of calls)."""
  if run.group is None:
    return stop
  import torch.distributed as dist
  flag = torch.tensor([int(stop)], device=run.device)
  dist.broadcast(flag, src=0, group=run.group)
  return bool(flag.item())


def device_init(device: torch.device) -> None:
  """Create the device's context (the process's first call to it)."""
  if device.type == "cuda":
    torch.zeros(1, device=device)
    torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
  if device.type != "cuda":
    return 0
  return int(torch.cuda.max_memory_allocated(device))


def process_age_s() -> float:
  """Seconds since this process started (its start time in /proc)."""
  with open("/proc/self/stat") as f:
    start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
  with open("/proc/uptime") as f:
    uptime = float(f.read().split()[0])
  return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Run:
  """One run of one cell on this process's device (one rank of a group
  on four chips)."""

  cell: str
  cfg: dict
  traffic: dict
  limits: Dict[str, float]
  seed: int
  seconds: float
  trace: bool
  device: torch.device
  chips: int = 1
  group: Any = None
  rank: int = 0
  world: int = 1


@dataclasses.dataclass
class Result:
  """What a driver hands back; ``numbers`` are the comparison's (rank 0)."""

  setup_s: float
  attempted: int
  failed: int
  window: dict
  memory_peak_bytes: int
  device_record: dict
  e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
  numbers: Dict[str, dict] = dataclasses.field(default_factory=dict)
  slice: Any = None
  slice_steps: int = 0
  stages: Dict[str, float] = dataclasses.field(default_factory=dict)


class Stages:
  """Seconds since process start at each named point of the set-up."""

  def __init__(self):
    self.marks: Dict[str, float] = {"imports": process_age_s()}

  def mark(self, name: str) -> None:
    self.marks[name] = process_age_s()


class DeviceRecord:
  """The card's SM clock, power draw and temperature (``nvidia-smi``)
  read as the window opens and as it closes; nothing runs beside the
  window itself."""

  QUERY = "clocks.sm,power.draw,temperature.gpu"
  KEYS = ("sm_clock_mhz", "power_draw_w", "temperature_c")

  def __init__(self, run: Run):
    self.run = run
    self.samples: List[List[float]] = []

  def _sample(self) -> None:
    if self.run.device.type != "cuda":
      return
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={self.QUERY}", "-i",
         str(self.run.device.index or 0), "--format=csv,noheader,nounits"],
        capture_output=True, text=True)
    try:
      self.samples.append([float(v) for v in out.stdout.split(",")])
    except ValueError:
      pass

  def __enter__(self):
    self._sample()
    return self

  def __exit__(self, *exc):
    self._sample()

  def summary(self) -> dict:
    return {k: [s[i] for s in self.samples]
            for i, k in enumerate(self.KEYS)}


def card_info(device: torch.device) -> dict:
  """The card's name, power limit, versions and switches, for the
  record printed on standard error."""
  info = {"torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "tf32_cudnn": torch.backends.cudnn.allow_tf32,
          "cudnn_benchmark": torch.backends.cudnn.benchmark}
  if device.type == "cuda":
    info["name"] = torch.cuda.get_device_name(device)
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "-i", str(device.index or 0),
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    info["power_limit"] = out.stdout.strip()
  return info


def log(*parts) -> None:
  print("wcbench:", *parts, file=sys.stderr, flush=True)
