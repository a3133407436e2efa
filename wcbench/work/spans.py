"""The program's own spans (``wcgan_tpu_torch/trace.py``), as the per-layer
metrics read them: a span's device time in the traced slice, through the
span map the program kept of its captured graph, and a span's host time
from the span table of this process (the harness reads the metrics in the
process that ran the cell).

Each function returns None where there is nothing to read: a program
without these spans, a program that kept no map of its graph, or a slice
in which not every call is one whole replay of the map's graph (a replay's
events are the map's nodes, one by one and in order; nothing is guessed).
"""

from __future__ import annotations

from typing import Iterable, Optional

# The programs the cells run, by the names the port gives them.
TRAIN_PROGRAM = "make_jit_dataset_step"
SAMPLE_PROGRAM = "Trainer.sample_u8"


def _trace():
  try:
    from wcgan_tpu_torch import trace
  except ImportError:
    return None
  return trace


def device_ms(ctx, program: str, names: Iterable[str]) -> Optional[float]:
  """Milliseconds in which the nodes of the spans ``names`` ran (the
  union of each span's nodes' intervals, summed over the spans, which do
  not nest), over every replay of ``program`` in the traced slice."""
  trace, s = _trace(), ctx.slice
  if trace is None or s is None or not s.calls:
    return None
  span_map = trace.maps().get(program)
  if span_map is None:
    return None
  events = sorted(s.kernels, key=lambda k: (k[1], k[2]))
  blocks = trace.replays(span_map, events)
  if len(blocks) != s.calls:
    return None
  names = list(names)
  total = 0.0
  for block in blocks:
    got = trace.attribute(span_map, block)
    if got is None or any(n not in got for n in names):
      return None
    total += sum(got[n]["busy_us"] for n in names)
  return total / 1e3


def host_s(names: Iterable[str]) -> Optional[float]:
  """Seconds of the host spans ``names`` in this process, summed; None
  where one never ran."""
  trace = _trace()
  if trace is None:
    return None
  table = trace.table()
  names = list(names)
  if any(n not in table for n in names):
    return None
  return sum(table[n]["s"] for n in names)


def calls(name: str) -> Optional[int]:
  """How many times the span ``name`` ran in this process."""
  trace = _trace()
  if trace is None:
    return None
  entry = trace.table().get(name)
  return entry["count"] if entry else None


def setup_s(program: str) -> Optional[float]:
  """Seconds of ``program``'s warm-up and capture, less the kernels'
  builds (``nvcc``) inside them."""
  trace = _trace()
  if trace is None:
    return None
  table = trace.table()
  parts = [table.get(f"{program}.{p}") for p in ("warm_up", "capture")]
  if any(p is None for p in parts):
    return None
  return sum(p["s"] - p["inner"].get("kernels.build", 0.0) for p in parts)
