"""The port's spans: named stretches of host work, on the host clock
always, on ``torch.profiler``'s clock while it records, and in the CUDA
graph they were captured into.

``with span(name):`` or ``begin(name)`` ... ``end(token)``:

- always adds one to the span's count and its host nanoseconds
  (``time.perf_counter_ns``) to a table for the process: ``table()``,
  ``reset()``; that is the whole cost while the profiler is off. The table
  also keeps, for each pair of names, the nanoseconds of one span spent
  inside open spans of the other (``table()[outer]["inner"]``);
- while ``torch.profiler`` records, also opens a ``record_function``
  range of the same name, so that the span lies on the device trace's
  clock (the benchmark's slice, the trainer's ``profile_dir`` trace);
- inside ``graph_map`` (``compiled.Program``'s capture of a CUDA graph),
  also notes the capture's dependency set where it begins and ends
  (``cuStreamGetCaptureInfo``). Before the capture ends, ``graph_map``
  orders the graph's kernel, memcpy and memset nodes by its edges and
  keeps, under the program's name (``maps()``), its ``SpanMap``: each
  span's ranges of those nodes' ordinals and each node's name. A replay
  launches the same graph: the spans add no node to it.

``replays`` finds a span map's replays in the device events of a profiled
slice (each node's name against the event's), and ``attribute`` gives
each span's device time in one replay: busy (the union of its nodes'
intervals) and idle inside its ranges. Neither guesses: a slice whose
events do not line up with the map gives nothing.

Spans are opened and closed by one thread at a time, which the table
relies on (it takes no lock): the caller's, or the autograd engine's while
the caller waits in a backward (``backward_span``).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import heapq
import time
import warnings
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.autograd import profiler as _profiler

# name -> [count, ns]; (outer, inner) -> ns of inner spans inside outer.
_TABLE: Dict[str, List[int]] = {}
_INNER: Dict[Tuple[str, str], int] = {}
_OPEN: List["span"] = []                 # open spans, oldest first
_CAPTURE: Optional["_Capture"] = None
_MAPS: Dict[str, "SpanMap"] = {}
_now = time.perf_counter_ns


class span:
  """The span ``name`` around a ``with`` block; ``begin`` and ``end``
  where its two ends lie in different functions."""

  __slots__ = ("name", "t0", "rf", "at")

  def __init__(self, name: str):
    self.name = name

  def __enter__(self) -> "span":
    self.rf = None
    if _profiler._is_profiler_enabled:
      self.rf = _profiler.record_function(self.name)
      self.rf.__enter__()
    self.at = None if _CAPTURE is None else _CAPTURE.position()
    _OPEN.append(self)
    self.t0 = _now()
    return self

  def __exit__(self, *exc) -> None:
    ns = _now() - self.t0
    if self.at is not None and _CAPTURE is not None:
      _CAPTURE.note(self.name, self.at, _CAPTURE.position())
    if self.rf is not None:
      self.rf.__exit__(None, None, None)
    if _OPEN[-1] is self:
      _OPEN.pop()
      at = len(_OPEN)
    else:
      at = _OPEN.index(self)
      del _OPEN[at]
    entry = _TABLE.get(self.name)
    if entry is None:
      entry = _TABLE[self.name] = [0, 0]
    entry[0] += 1
    entry[1] += ns
    for i in range(at):
      key = (_OPEN[i].name, self.name)
      _INNER[key] = _INNER.get(key, 0) + ns


def begin(name: str) -> span:
  """Open span ``name``; ``end`` closes it."""
  return span(name).__enter__()


def end(o: span) -> None:
  o.__exit__(None, None, None)


def table() -> Dict[str, dict]:
  """{name: {"count": spans ended, "s": their host seconds, "inner":
  {name: seconds of those spans that ran inside these}}}."""
  out = {n: {"count": c, "s": ns / 1e9, "inner": {}}
         for n, (c, ns) in _TABLE.items()}
  for (outer, inner), ns in _INNER.items():
    if outer in out:
      out[outer]["inner"][inner] = ns / 1e9
  return out


def reset() -> None:
  """Empty the table (open spans still count when they end)."""
  _TABLE.clear()
  _INNER.clear()


# --- the backward of a block ---------------------------------------------------


class _Edge(torch.autograd.Function):
  """The identity, whose backward opens (at a block's output) or closes
  (at its input) the span held in ``held``."""

  @staticmethod
  def forward(ctx, x, held, opens):
    ctx.held, ctx.opens = held, opens
    return x.view_as(x)

  @staticmethod
  def backward(ctx, grad):
    held = ctx.held
    if ctx.opens:
      held.append(begin(held[0]))
    elif len(held) > 1:
      end(held.pop())
    return grad, None, None


def backward_span(name: str, fn: Callable[..., torch.Tensor],
                  x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
  """``fn(x, *args, **kwargs)``, with a span ``name`` around its backward:
  from the gradient reaching its output to the gradient of ``x``. Only
  where grad is on and ``x`` takes one; the markers do no arithmetic."""
  if not (torch.is_grad_enabled() and x.requires_grad):
    return fn(x, *args, **kwargs)
  held: list = [name]
  out = fn(_Edge.apply(x, held, False), *args, **kwargs)
  return _Edge.apply(out, held, True)


# --- CUDA graphs ---------------------------------------------------------------


@dataclasses.dataclass
class SpanMap:
  """Where a captured program's spans lie in its graph: ``names[i]`` is
  the i-th kernel, memcpy or memset node's (in the order of the graph's
  edges; a kernel's symbol, 'Memcpy' or 'Memset'), and ``spans[name]``
  the half-open ranges of ordinals that each span of that name held."""

  program: str
  names: List[str]
  spans: Dict[str, List[Tuple[int, int]]]

  @property
  def nodes(self) -> int:
    return len(self.names)


def maps() -> Dict[str, SpanMap]:
  """The span map of each program's last capture, by program name."""
  return _MAPS


# CUgraphNodeType
_KERNEL, _MEMCPY, _MEMSET = 0, 1, 2
_DEVICE_NAMES = {_MEMCPY: "Memcpy", _MEMSET: "Memset"}


class _Driver:
  """The CUDA driver's graph queries, through ctypes on ``libcuda``."""

  def __init__(self):
    lib = ctypes.CDLL("libcuda.so.1")
    p, sz, u32 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint
    P = ctypes.POINTER
    self.info = lib.cuStreamGetCaptureInfo_v3
    self.info.argtypes = [p, P(ctypes.c_int), P(ctypes.c_uint64), P(p),
                          P(P(p)), P(p), P(sz)]
    self.nodes = lib.cuGraphGetNodes
    self.nodes.argtypes = [p, P(p), P(sz)]
    self.edges = lib.cuGraphGetEdges_v2
    self.edges.argtypes = [p, P(p), P(p), p, P(sz)]
    self.type = lib.cuGraphNodeGetType
    self.type.argtypes = [p, P(u32)]
    self.params = lib.cuGraphKernelNodeGetParams_v2
    self.params.argtypes = [p, p]
    self.func_name = lib.cuFuncGetName
    self.func_name.argtypes = [P(ctypes.c_char_p), p]
    self.kernel_name = lib.cuKernelGetName
    self.kernel_name.argtypes = [P(ctypes.c_char_p), p]
    for fn in (self.info, self.nodes, self.edges, self.type, self.params,
               self.func_name, self.kernel_name):
      fn.restype = ctypes.c_int
    self._names: Dict[int, str] = {}

  @staticmethod
  def check(err: int, what: str) -> None:
    if err != 0:
      raise RuntimeError(f"{what} failed: CUresult {err}")

  def capture(self, stream: int) -> Tuple[Optional[int], Tuple[int, ...]]:
    """(the graph being captured on ``stream``, the nodes the next
    captured work will depend on), or (None, ()) outside a capture."""
    status, graph = ctypes.c_int(), ctypes.c_void_p()
    deps, n = ctypes.POINTER(ctypes.c_void_p)(), ctypes.c_size_t()
    # Edge data is asked for too: without it the query is refused as
    # lossy where an edge carries some (programmatic launches).
    data = ctypes.c_void_p()
    self.check(self.info(stream, ctypes.byref(status), None,
                         ctypes.byref(graph), ctypes.byref(deps),
                         ctypes.byref(data), ctypes.byref(n)),
               "cuStreamGetCaptureInfo")
    if status.value != 1:           # CU_STREAM_CAPTURE_STATUS_ACTIVE
      return None, ()
    return graph.value, tuple(deps[i] for i in range(n.value))

  def walk(self, graph: int) -> Tuple[List[int], List[int], List[str]]:
    """Every node of ``graph`` in an order its edges allow (ties by the
    CUDA driver's node order), each node's count of kernel, memcpy and
    memset nodes up to it, and those nodes' names in order (a stream
    capture makes no child graph)."""
    n = ctypes.c_size_t()
    self.check(self.nodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    self.check(self.nodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    m = ctypes.c_size_t()
    self.check(self.edges(graph, None, None, None, ctypes.byref(m)),
               "cuGraphGetEdges")
    src, dst = (ctypes.c_void_p * m.value)(), (ctypes.c_void_p * m.value)()
    data = (ctypes.c_uint64 * m.value)()      # CUgraphEdgeData, 8 bytes
    if m.value:
      self.check(self.edges(graph, src, dst, data, ctypes.byref(m)),
                 "cuGraphGetEdges")
    index = {h: i for i, h in enumerate(nodes)}
    succ: List[List[int]] = [[] for _ in nodes]
    preds = [0] * len(nodes)
    for a, b in zip(src, dst):
      succ[index[a]].append(index[b])
      preds[index[b]] += 1
    ready = [i for i, k in enumerate(preds) if k == 0]
    heapq.heapify(ready)
    order, upto, names = [], [], []
    # One buffer for every node's type and kernel parameters
    # (CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern at byte 56).
    kind, params = ctypes.c_uint(), (ctypes.c_uint64 * 9)()
    kind_ref = ctypes.byref(kind)
    while ready:
      i = heapq.heappop(ready)
      node = nodes[i]
      order.append(node)
      self.check(self.type(node, kind_ref), "cuGraphNodeGetType")
      if kind.value == _KERNEL:
        self.check(self.params(node, params), "cuGraphKernelNodeGetParams")
        names.append(self._kernel(params[0], params[7]))
      elif kind.value in _DEVICE_NAMES:
        names.append(_DEVICE_NAMES[kind.value])
      upto.append(len(names))
      for j in succ[i]:
        preds[j] -= 1
        if preds[j] == 0:
          heapq.heappush(ready, j)
    if len(order) != len(nodes):
      raise RuntimeError("the captured graph has a cycle")
    return order, upto, names

  def _kernel(self, func: int, kern: int) -> str:
    """The name of a kernel node's function (or, where it has none, of
    its context-free kernel)."""
    key = func or kern
    name = self._names.get(key)
    if name is None:
      out = ctypes.c_char_p()
      if func:
        self.check(self.func_name(ctypes.byref(out), func), "cuFuncGetName")
      else:
        self.check(self.kernel_name(ctypes.byref(out), kern),
                   "cuKernelGetName")
      name = self._names[key] = out.value.decode(errors="replace")
    return name


_DRIVER: Optional[_Driver] = None


def _driver() -> _Driver:
  global _DRIVER
  if _DRIVER is None:
    _DRIVER = _Driver()
  return _DRIVER


class _Capture:
  """The spans of one capture, each with the capture's dependency sets
  where it began and where it ended."""

  def __init__(self, program: str):
    self.program = program
    self.driver = _driver()
    self.graph: Optional[int] = None
    self.noted: List[Tuple[str, Tuple[int, ...], Tuple[int, ...]]] = []

  def position(self) -> Optional[Tuple[int, ...]]:
    graph, deps = self.driver.capture(torch.cuda.current_stream().cuda_stream)
    if graph is None or graph != self.graph:
      return None
    return deps

  def note(self, name: str, at: Tuple[int, ...],
           until: Optional[Tuple[int, ...]]) -> None:
    if until is not None:
      self.noted.append((name, at, until))

  def span_map(self) -> SpanMap:
    order, upto, names = self.driver.walk(self.graph)
    count = dict(zip(order, upto))
    spans: Dict[str, List[Tuple[int, int]]] = {}
    for name, at, until in self.noted:
      lo = max((count[d] for d in at), default=0)
      hi = max((count[d] for d in until), default=0)
      spans.setdefault(name, []).append((lo, max(lo, hi)))
    return SpanMap(self.program, names, spans)


@contextlib.contextmanager
def graph_map(program: str) -> Iterator[None]:
  """Inside a CUDA-graph capture on the current stream: note where the
  spans begun and ended inside the block lie in the graph, and keep the
  graph's ``SpanMap`` under ``program`` (before the capture ends, while
  the graph is there to read). A map that cannot be read is left out,
  with a warning; the capture goes on."""
  global _CAPTURE
  try:
    cap = _Capture(program)
    cap.graph, _ = cap.driver.capture(torch.cuda.current_stream().cuda_stream)
  except (OSError, AttributeError, RuntimeError) as err:
    warnings.warn(f"no span map for {program}: {err}")
    cap = None
  _CAPTURE = cap
  try:
    yield
    if cap is not None and cap.graph is not None:
      try:
        _MAPS[program] = cap.span_map()
      except RuntimeError as err:
        warnings.warn(f"no span map for {program}: {err}")
  finally:
    _CAPTURE = None


# --- reading a profiled slice --------------------------------------------------


def matches(node: str, event: str) -> bool:
  """Whether a device event of the profiler (its short name: the kernel's
  name without namespaces and template arguments; 'Memcpy ...' or
  'Memset ...', or in a graph the CUDA driver's kernels 'memcpy32_post'
  and 'memset32') is the work of a node named ``node``."""
  event = event.strip()
  copy = event[:6].lower()
  if node in _DEVICE_NAMES.values():
    return copy == node.lower()
  return bool(event) and copy not in ("memcpy", "memset") and event in node


def replays(span_map: SpanMap, events: Sequence[Tuple[str, float, float]]
            ) -> List[Sequence[Tuple[str, float, float]]]:
  """The runs of ``events`` ((name, start, end) in start order) that are
  whole replays of the map's graph, node by node, in order."""
  names, n = span_map.names, span_map.nodes
  out, i = [], 0
  if not n:
    return out
  while i + n <= len(events):
    k = 0
    while k < n and matches(names[k], events[i + k][0]):
      k += 1
    if k == n:
      out.append(events[i:i + n])
      i += n
    else:
      i += 1
  return out


def _union(intervals: List[Tuple[float, float]]) -> float:
  total, at = 0.0, float("-inf")
  for a, b in sorted(intervals):
    if b > at:
      total += b - max(a, at)
      at = b
  return total


def attribute(span_map: SpanMap, events: Sequence[Tuple[str, float, float]]
              ) -> Optional[Dict[str, Dict[str, float]]]:
  """Each span's device time in one profiled replay of the map's graph:
  ``events`` are its (name, start_us, end_us) in start order, one a node.
  {span: {"busy_us": the union of its nodes' intervals, "idle_us": the
  time inside each of its ranges (first start to last end) with none of
  its nodes running, "nodes": its nodes}}; None where the events are not
  the map's nodes (another count, or a name that does not match)."""
  if len(events) != span_map.nodes or not all(
      matches(n, e[0]) for n, e in zip(span_map.names, events)):
    return None
  out = {}
  for name, ranges in span_map.spans.items():
    merged: List[List[int]] = []
    for lo, hi in sorted(r for r in ranges if r[1] > r[0]):
      if merged and lo <= merged[-1][1]:
        merged[-1][1] = max(merged[-1][1], hi)
      else:
        merged.append([lo, hi])
    busy = idle = 0.0
    nodes = 0
    for lo, hi in merged:
      iv = [(e[1], e[2]) for e in events[lo:hi]]
      b = _union(iv)
      busy += b
      idle += max(e for _, e in iv) - min(s for s, _ in iv) - b
      nodes += hi - lo
    out[name] = {"busy_us": busy, "idle_us": idle, "nodes": nodes}
  return out
