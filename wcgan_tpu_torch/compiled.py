"""The port's ``jax.jit``: a program run through static buffers, on CUDA as
one ``torch.cuda.CUDAGraph`` replay a call.

Every compiled program of the port is a ``Program``: the outer step and
its chains (``train.step.JitStep``, one process or one rank of an NCCL
group), ``Trainer.sample`` / ``sample_u8`` and the standing pass
(``train.trainer``), the scorer's InceptionV3 forward
(``evaluation.scorer``) and the bench's sampling forward. A program's
function takes its inputs (a tree of tensors, arrays and None: lists,
tuples and dicts) and reads everything else where it lies (parameters,
statistics, a device dataset). A call:

- copies the inputs into static buffers on the program's device (made at
  the warm-up; None stays None);
- the first call, and the first after ``invalidate()`` or after the
  binding key changes, runs the function eagerly on the static buffers
  (on CUDA on a side stream): the warm-up. It is a real call, and it makes
  what is made lazily (kernels built, Adam's slots, NCCL's communicator,
  cuDNN's algorithm choices); the key is taken again after it;
- on CUDA the next call captures the function on that stream (a state's
  ``generator`` registered with the graph, so that each replay draws fresh
  numbers and advances it as an eager call would), then replays it; later
  calls replay. A capture that fails raises, naming the call that could
  not be captured (``capture_failure``); nothing falls back to eager;
- the host-side counts a call advances (the kernels' launch counts
  ``cuda_wc.MOMENTS_LAUNCHES``, ``WC_APPLY_LAUNCHES``,
  ``mm_bf16x3.MM_BF16X3_LAUNCHES`` and ``MM_BF16X3_NS_LAUNCHES``,
  ``pool.AVG_POOL2X2_LAUNCHES`` and ``AVG_POOL2X2_COPIES``, the
  collectives of ``mesh.STATS``, and a state's ``step`` and ``g_version``)
  are those of the captured call, added on each replay;
- the outputs are new tensors on each call (clones of the graph's);
- ``torch.autograd`` anomaly detection stays on in a capture without its
  NaN check, which reads the device on the host.

On the CPU every call after the warm-up runs the function eagerly on the
static buffers. ``last`` says what the last call did: 'warm-up',
'capture', 'replay' or 'eager' (the CPU's), and ``calls`` counts each.

Each part of a call is a span (``trace``) named ``<name>.<part>``:
``key`` (the binding key), ``fill`` (the static buffers), ``warm_up``,
``capture``, ``launch`` (the replay), ``counts`` (the host counts) and
``clone`` (the outputs). A capture keeps the graph's span map in
``trace.maps()`` under the program's name.

The binding key is the caller's, and must hold everything the graph is
bound to: each tensor it reads in place, by identity and address
(``tensors_key``), the inputs' shapes, dtypes and devices (``spec``),
and the settings that chose its kernels at capture (``backend_key``),
the whitening precision among them.
"""

from __future__ import annotations

import traceback
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from wcgan_tpu_torch import trace
from wcgan_tpu_torch.ops import cuda_wc, mm_bf16x3, pool, whiten
from wcgan_tpu_torch.parallel import mesh

KINDS = ("warm-up", "capture", "replay", "eager")
# A call's spans (``trace``), each ``<name>.<part>``.
SPANS = ("key", "fill", "warm_up", "capture", "launch", "counts", "clone")


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
  if tree is None:
    return None
  if isinstance(tree, dict):
    return {k: _tree_map(fn, v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_tree_map(fn, v) for v in tree)
  return fn(tree)


def _leaves(tree: Any) -> Iterable[torch.Tensor]:
  if isinstance(tree, dict):
    tree = list(tree.values())
  if isinstance(tree, (list, tuple)):
    for v in tree:
      yield from _leaves(v)
  elif torch.is_tensor(tree):
    yield tree


def _host(a) -> torch.Tensor:
  if torch.is_tensor(a):
    return a
  # np.array copies: arrays from other frameworks are often read-only.
  return torch.from_numpy(np.array(a))


def _fill(static: Any, inputs: Any) -> None:
  """Copy ``inputs`` into the static buffers of the same tree."""
  if static is None:
    return
  if isinstance(static, dict):
    for k, buf in static.items():
      _fill(buf, inputs[k])
  elif isinstance(static, (list, tuple)):
    for buf, a in zip(static, inputs):
      _fill(buf, a)
  else:
    static.copy_(_host(inputs))


def spec(tree: Any) -> Any:
  """The shapes, dtypes and devices of a tree of inputs (arrays on the
  host), hashable."""
  if tree is None:
    return None
  if isinstance(tree, dict):
    return tuple(sorted((k, spec(v)) for k, v in tree.items()))
  if isinstance(tree, (list, tuple)):
    return tuple(spec(v) for v in tree)
  if torch.is_tensor(tree):
    return (tuple(tree.shape), tree.dtype, tree.device)
  a = np.asarray(tree)
  return (a.shape, a.dtype.str, "host")


def tensors_key(tensors: Iterable[torch.Tensor]) -> Tuple:
  """Each tensor's identity and address."""
  return tuple((id(t), t.data_ptr()) for t in tensors)


def module_key(module: torch.nn.Module) -> Tuple:
  """A module's identity, its configuration when it has one, and its
  parameters' and buffers' identities and addresses."""
  return (id(module), getattr(module, "cfg", None),
          tensors_key([*module.parameters(), *module.buffers()]))


def backend_key() -> Tuple:
  """The settings that choose the kernels when a graph is captured: TF32,
  cuDNN's determinism and autotuning, deterministic algorithms, the
  whitening precision (true float32 or K3's bf16x3)."""
  return (whiten.get_precision(),
          torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32,
          torch.backends.cudnn.deterministic,
          torch.backends.cudnn.benchmark,
          torch.are_deterministic_algorithms_enabled(),
          torch.get_float32_matmul_precision())


def capture_failure(name: str, err: BaseException) -> RuntimeError:
  """The error of a failed capture, naming the call that could not be
  captured: the innermost frame of the package (or of the kernels'
  wrapper) where it was raised."""
  frames = [f for f in traceback.extract_tb(err.__traceback__)
            if "wcgan_tpu_torch" in f.filename]
  where = (f" at {frames[-1].filename.split('wcgan_tpu_torch')[-1]}"
           f":{frames[-1].lineno} ({frames[-1].name}: {frames[-1].line})"
           if frames else "")
  return RuntimeError(f"CUDA graph capture of {name} failed{where}: "
                      f"{type(err).__name__}: {err}")


def _counts(state) -> Dict[Any, int]:
  """The host-side counts a call advances."""
  out: Dict[Any, int] = {"moments": cuda_wc.MOMENTS_LAUNCHES,
                         "wc_apply": cuda_wc.WC_APPLY_LAUNCHES,
                         "mm_bf16x3": mm_bf16x3.MM_BF16X3_LAUNCHES,
                         "mm_bf16x3_ns": mm_bf16x3.MM_BF16X3_NS_LAUNCHES,
                         "avg_pool2x2": pool.AVG_POOL2X2_LAUNCHES,
                         "avg_pool2x2_copies": pool.AVG_POOL2X2_COPIES}
  out.update({("calls", k): v for k, v in mesh.STATS.calls.items()})
  out.update({("bytes", k): v for k, v in mesh.STATS.bytes.items()})
  if state is not None:
    out.update(step=state.step, g_version=state.g_version)
  return out


def _put(counts: Dict[Any, int], state) -> None:
  cuda_wc.MOMENTS_LAUNCHES = counts["moments"]
  cuda_wc.WC_APPLY_LAUNCHES = counts["wc_apply"]
  mm_bf16x3.MM_BF16X3_LAUNCHES = counts["mm_bf16x3"]
  mm_bf16x3.MM_BF16X3_NS_LAUNCHES = counts["mm_bf16x3_ns"]
  pool.AVG_POOL2X2_LAUNCHES = counts["avg_pool2x2"]
  pool.AVG_POOL2X2_COPIES = counts["avg_pool2x2_copies"]
  mesh.STATS.reset()
  for k, v in counts.items():
    if isinstance(k, tuple):
      getattr(mesh.STATS, k[0])[k[1]] = v
  if state is not None:
    state.step, state.g_version = counts["step"], counts["g_version"]


class Program:
  """One compiled program (see the module's docstring), named ``name`` in
  the errors of its capture."""

  def __init__(self, name: str):
    self.name = name
    self._spans = {part: f"{name}.{part}" for part in SPANS}
    self.calls = dict.fromkeys(KINDS, 0)
    self.last: Optional[str] = None
    self._stream = None
    self.invalidate()

  def invalidate(self) -> None:
    """Drop the graph and the static buffers: the next call warms up
    again, the one after it captures anew."""
    self._graph = None
    self._key = None
    self._static = None
    self._out = None
    self._advance: Dict[Any, int] = {}

  def __call__(self, fn: Callable[[Any], Any], key: Callable[[], Any],
               inputs: Any, device: torch.device, state=None) -> Any:
    """``fn(static)`` on the static buffers of ``inputs``, bound to
    ``key()``; ``state``, when given, is the train state whose
    ``generator`` the graph registers and whose ``step`` and
    ``g_version`` a replay advances."""
    spans = self._spans
    with trace.span(spans["key"]):
      stale = self._key is None or self._key != key()
    if stale:
      self.invalidate()
      with trace.span(spans["fill"]):
        self._static = _tree_map(
            lambda a: torch.empty_like(_host(a), device=device), inputs)
        _fill(self._static, inputs)
      self._note("warm-up")
      with trace.span(spans["warm_up"]):
        out = self._warm_up(fn, device)
      # Bound to what the warm-up left (Adam's slots, say).
      with trace.span(spans["key"]):
        self._key = key()
      return out
    with trace.span(spans["fill"]):
      _fill(self._static, inputs)
    if device.type != "cuda":
      self._note("eager")
      return fn(self._static)
    if self._graph is None:
      with trace.span(spans["capture"]):
        self._capture(fn, device, state)
      self._note("capture")
    else:
      self._note("replay")
    with trace.span(spans["launch"]):
      self._graph.replay()
    with trace.span(spans["counts"]):
      counts = _counts(state)
      for k, v in self._advance.items():
        if v:
          counts[k] = counts.get(k, 0) + v
      _put(counts, state)
    with trace.span(spans["clone"]):
      return _tree_map(torch.Tensor.clone, self._out)

  def _note(self, kind: str) -> None:
    self.calls[kind] += 1
    self.last = kind

  def _side_stream(self, device) -> "torch.cuda.Stream":
    if self._stream is None:
      self._stream = torch.cuda.Stream(device)
    return self._stream

  def _warm_up(self, fn, device):
    if device.type != "cuda":
      return fn(self._static)
    current = torch.cuda.current_stream(device)
    side = self._side_stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
      out = fn(self._static)
    current.wait_stream(side)
    for t in _leaves(out):
      t.record_stream(current)
    return out

  def _capture(self, fn, device, state) -> None:
    """Capture one call of ``fn`` on the side stream; the host counts are
    put back, and what the call advanced them by is kept for the
    replays."""
    before = _counts(state)
    graph = torch.cuda.CUDAGraph()
    if state is not None and state.generator.device.type == "cuda":
      graph.register_generator_state(state.generator)
    current = torch.cuda.current_stream(device)
    side = self._side_stream(device)
    side.wait_stream(current)
    anomaly = torch.is_anomaly_enabled()
    try:
      with torch.cuda.stream(side), torch.autograd.set_detect_anomaly(
          anomaly, check_nan=False):
        with torch.cuda.graph(graph, stream=side), trace.graph_map(self.name):
          out = fn(self._static)
    except Exception as err:
      raise capture_failure(self.name, err) from err
    finally:
      after = _counts(state)
      _put(before, state)
    current.wait_stream(side)
    self._advance = {k: v - before.get(k, 0) for k, v in after.items()}
    self._graph, self._out = graph, out
