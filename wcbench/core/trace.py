"""A traced slice of the window, reduced to what the per-layer metrics
read: the device's kernels (name, start, end), the slice's length, the
union of the kernels' intervals (busy) and the gaps between them, each
named by what the host was doing in it.

``torch.profiler`` (CPU and CUDA activities) traces a few more calls of
the cell's own traffic after the untraced window; the slice is a
``record_function`` range around them, which starts and ends with the
device's queue drained, and holds the kernels that start inside it. Device events and host events share the
profiler's clock (microseconds).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Tuple

import torch

SLICE = "wcbench.slice"


@dataclasses.dataclass
class Slice:
  """One traced slice: ``calls`` of the traffic's unit of work."""

  calls: int
  wall_s: float
  kernels: List[Tuple[str, float, float]]     # (name, start_us, end_us)
  host: List[Tuple[str, float, float]]        # host ops and runtime calls
  start_us: float
  end_us: float

  def busy_s(self) -> float:
    return sum(b - a for a, b in self.union()) / 1e6

  def union(self, match: Callable[[str], bool] = lambda name: True
            ) -> List[Tuple[float, float]]:
    """The intervals of the kernels whose name ``match``es, merged and
    clipped to the slice."""
    spans = sorted((max(a, self.start_us), min(b, self.end_us))
                   for n, a, b in self.kernels if match(n))
    out: List[List[float]] = []
    for a, b in spans:
      if b <= a:
        continue
      if out and a <= out[-1][1]:
        out[-1][1] = max(out[-1][1], b)
      else:
        out.append([a, b])
    return [(a, b) for a, b in out]

  def gaps(self) -> List[Tuple[float, float]]:
    """The slice's stretches with no kernel running."""
    out, at = [], self.start_us
    for a, b in self.union():
      if a > at:
        out.append((at, a))
      at = max(at, b)
    if self.end_us > at:
      out.append((at, self.end_us))
    return out

  def kernel_time_s(self, match: Callable[[str], bool]) -> float:
    """Seconds in which a kernel whose name ``match``es ran (the union of
    their intervals)."""
    return sum(b - a for a, b in self.union(match)) / 1e6

  def kernel_count(self) -> int:
    return len(self.kernels)

  def breakdown(self, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps by the host operation that was running in each (the innermost
    one at the gap's middle)."""
    by_name: Dict[str, float] = {}
    for n, a, b in self.kernels:
      by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
      mid = (a + b) / 2
      over = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
      named.append([min(over)[1] if over else "nothing traced",
                    (b - a) / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def short_name(name: str) -> str:
  """'void (anonymous namespace)::rows_apply_bf16<128>(...)' ->
  'rows_apply_bf16'; names at most 96 characters."""
  name = name.replace("(anonymous namespace)::", "").replace("void ", "")
  name = re.split(r"[<(]", name)[0].split("::")[-1] or name
  return name[:96]


def _is_annotation(event) -> bool:
  """A range laid over the kernels it holds (``record_function`` and the
  optimizer's ranges), not device work."""
  return bool(getattr(event, "is_user_annotation", False)) or \
      event.name.startswith(("Optimizer.", SLICE))


def profile(call: Callable[[], None], calls: int,
            device: torch.device) -> Slice:
  """``calls`` calls of ``call`` under ``torch.profiler``, the device's
  queue drained before and after. One call before the slice, under the
  profiler too, takes the profiler's own start-up out of it."""
  from torch.profiler import ProfilerActivity, profile as torch_profile
  torch.cuda.synchronize(device)
  with torch_profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
    call()
    torch.cuda.synchronize(device)
    with torch.profiler.record_function(SLICE):
      for _ in range(calls):
        call()
      torch.cuda.synchronize(device)
  kernels, host = [], []
  start = end = None
  for e in prof.events():
    a, b = e.time_range.start, e.time_range.end
    if e.name == SLICE and e.device_type == torch.autograd.DeviceType.CPU:
      start, end = a, b
    elif e.device_type == torch.autograd.DeviceType.CUDA:
      if not _is_annotation(e):
        kernels.append((short_name(e.name), a, b))
    else:
      host.append((short_name(e.name), a, b))
  if start is None:
    raise RuntimeError("the profiler recorded no slice range")
  return Slice(calls=calls, wall_s=(end - start) / 1e6,
               kernels=[k for k in kernels if k[1] >= start],
               host=host, start_us=start, end_us=end)
