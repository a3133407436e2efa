"""The port's spans (``wcgan_tpu_torch/trace.py``) on the CPU: the table
and its nesting, the off path (no profiler range without a profiler), the
spans of a program's call and of ``Trainer.sample_u8`` under a CPU
``torch.profiler``, the WC block's backward span and its gradients, the
set-up spans, and the reading of a span map (``replays``, ``attribute``)
on synthetic maps and events. Where a span lies in a CUDA graph is held
on the card (``tests/test_torch_cuda.py``)."""

import subprocess
import types

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from wcgan_tpu_torch import compiled, trace
from wcgan_tpu_torch.models import layers as L

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh_table():
  trace.reset()
  yield
  trace.reset()


def _profiled_names(fn):
  """The names of the CPU events of ``fn()`` under torch.profiler."""
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    fn()
  return [e.name for e in prof.events()]


def test_table_counts_and_nesting():
  with trace.span("outer"):
    for _ in range(3):
      with trace.span("inner"):
        pass
  with trace.span("inner"):
    pass
  t = trace.table()
  assert t["outer"]["count"] == 1 and t["inner"]["count"] == 4
  assert set(t["outer"]["inner"]) == {"inner"}
  assert 0 < t["outer"]["inner"]["inner"] <= t["inner"]["s"]
  assert t["outer"]["inner"]["inner"] <= t["outer"]["s"]
  assert t["inner"]["inner"] == {}
  trace.reset()
  assert trace.table() == {}


def test_spans_closed_out_of_order_are_counted():
  """begin/end in another order than LIFO (a backward's span ends on the
  autograd engine's side): each counted once, the one opened first
  holding only what ended inside it."""
  a = trace.begin("a")
  b = trace.begin("b")
  trace.end(a)
  c = trace.begin("c")
  trace.end(c)
  trace.end(b)
  t = trace.table()
  assert {n: v["count"] for n, v in t.items()} == {"a": 1, "b": 1, "c": 1}
  assert t["a"]["inner"] == {} and set(t["b"]["inner"]) == {"c"}


def test_off_path_enters_no_profiler_range(monkeypatch):
  """Without a profiler no ``record_function`` is made, whatever runs a
  span: a program's call, the WC block and its backward."""
  def refuse(*args, **kwargs):
    raise AssertionError("record_function entered without a profiler")
  monkeypatch.setattr(autograd_profiler, "record_function", refuse)
  program = compiled.Program("p")
  x = torch.ones(3)
  for _ in range(2):
    program(lambda s: s[0] * 2, lambda: 0, [x], CPU)
  nc = L.NormColor(8)
  out = nc(torch.randn(16, 8, 2, 2, requires_grad=True).to(
      memory_format=torch.channels_last))
  out.sum().backward()
  assert trace.table()["wc.backward"]["count"] == 1


class _Graph:
  def replay(self):
    pass


def test_program_call_spans_under_the_profiler(monkeypatch):
  """Every span of a call on a program's CUDA path, under a CPU profiler:
  the warm-up's, then a capture's and a replay's (the graph is a stand-in
  on the CPU)."""
  program = compiled.Program("prog")

  def capture(fn, device, state):
    program._graph, program._out = _Graph(), fn(program._static)
  monkeypatch.setattr(program, "_capture", capture)
  fake_cuda = types.SimpleNamespace(type="cuda")
  x = torch.arange(4.0)
  names = _profiled_names(lambda: [
      program(lambda s: s[0] + 1, lambda: 0, [x], CPU),
      program(lambda s: s[0] + 1, lambda: 0, [x], fake_cuda),
      program(lambda s: s[0] + 1, lambda: 0, [x], fake_cuda)])
  for part in compiled.SPANS:
    assert f"prog.{part}" in names, part
  t = trace.table()
  assert {p: t[f"prog.{p}"]["count"] for p in compiled.SPANS} == {
      "key": 4, "fill": 3, "warm_up": 1, "capture": 1, "launch": 2,
      "counts": 2, "clone": 2}
  assert program.calls == {"warm-up": 1, "capture": 1, "replay": 1,
                           "eager": 0}


def _tiny_trainer(tmp_path):
  from wcgan_tpu_torch.data.base import ArrayDataset
  from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
  from wcgan_tpu_torch.models.generator import GeneratorConfig
  from wcgan_tpu_torch.train.state import OptimConfig, create_state
  from wcgan_tpu_torch.train.step import GANConfig
  from wcgan_tpu_torch.train.trainer import Trainer, TrainerConfig
  gan = GANConfig(z_dim=8)
  state = create_state(GeneratorConfig(z_dim=8, resolution=8,
                                       filters=(16,)),
                       DiscriminatorConfig(resolution=8, filters=(8, 8),
                                           downsample=(True, False)),
                       OptimConfig(), gan.training_ratio, CPU)
  ds = ArrayDataset(np.zeros((4, 8, 8, 3), np.uint8), None, 4, z_dim=8)
  return Trainer(ds, state, gan, TrainerConfig(
      name="t", output_dir=str(tmp_path), device_data=False))


def test_sample_u8_spans_under_the_profiler(tmp_path):
  """``Trainer.sample_u8``'s spans by name under a CPU profiler: its
  inputs and sampling state, its program's key, buffers and warm-up (the
  CPU's later calls run eagerly), and G's WC layers."""
  tt = _tiny_trainer(tmp_path)
  z = torch.randn(4, 8)
  names = _profiled_names(lambda: [tt.sample_u8(z) for _ in range(2)])
  for name in ("Trainer.sample_u8.inputs", "Trainer.sample_u8.state",
               "Trainer.sample_u8.key", "Trainer.sample_u8.fill",
               "Trainer.sample_u8.warm_up", "wc.forward"):
    assert name in names, name
  assert "wc.backward" not in names
  assert trace.table()["Trainer.sample_u8.inputs"]["count"] == 2


@pytest.mark.parametrize("coloring", ["uconv", "ucconv-sa"])
def test_wc_backward_span_leaves_the_gradients_exact(coloring):
  """The WC block's backward is the span ``wc.backward`` (under the
  profiler too), and its markers change no gradient: the input's and
  every parameter's equal, bit for bit, those of the unmarked block."""
  torch.manual_seed(0)
  nc = L.NormColor(8, coloring=coloring, num_classes=3, filters_emb=2,
                   generator=torch.Generator().manual_seed(1))
  x = torch.randn(6, 8, 4, 4).to(memory_format=torch.channels_last)
  labels = torch.tensor([0, 1, 2, 0, 1, 2])
  w = torch.randn(6, 8, 4, 4)

  def grads(forward):
    xi = x.clone().requires_grad_(True)
    out = forward(xi, labels, True, False)
    return torch.autograd.grad((out * w).sum(), [xi, *nc.parameters()])

  names = _profiled_names(lambda: grads(
      lambda *a: nc(a[0], a[1], train=a[2], update_stats=a[3])))
  assert "wc.backward" in names and "wc.forward" in names
  marked = grads(lambda *a: nc(a[0], a[1], train=a[2], update_stats=a[3]))
  plain = grads(nc._forward)
  assert len(marked) == len(plain) > 1
  for a, b in zip(marked, plain):
    assert torch.equal(a, b)
  t = trace.table()
  assert t["wc.backward"]["count"] == 2 and t["wc.forward"]["count"] == 2


def test_backward_span_needs_a_gradient():
  """No markers where no gradient flows: under no_grad, or where the
  block's input takes none."""
  nc = L.NormColor(4)
  x = torch.randn(8, 4, 2, 2).to(memory_format=torch.channels_last)
  with torch.no_grad():
    assert nc(x).grad_fn is None
  out = nc(x)
  assert "Edge" not in type(out.grad_fn).__name__
  assert trace.table()["wc.forward"]["count"] == 2


def test_state_create_is_counted_once(tmp_path):
  _tiny_trainer(tmp_path)
  t = trace.table()
  assert t["state.create"]["count"] == 1 and t["state.create"]["s"] > 0


def test_kernels_build_is_counted_where_nvcc_runs(monkeypatch, tmp_path):
  """``kernels.build`` counts a compile, and nothing for a library that is
  already built."""
  from wcgan_tpu_torch.ops import _build
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
  monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")

  def fake_nvcc(cmd, **kwargs):
    open(cmd[cmd.index("-o") + 1], "wb").close()
    return subprocess.CompletedProcess(cmd, 0, "", "")
  monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
  _build.compile_library("moments")
  _build.compile_library("moments")
  assert trace.table()["kernels.build"]["count"] == 1


def _map():
  """Four nodes: spans 'a' = 0-1, 'b' = 2-3, 'c' = 1-2 and 'd' = 0 and 3
  (two occurrences)."""
  return trace.SpanMap("p", ["_ZN2at6native6kernelILi4EEEvv", "Memcpy",
                             "gemm_kernel_sm90", "Memset"],
                       {"a": [(0, 2)], "b": [(2, 4)], "c": [(1, 3)],
                        "d": [(0, 1), (3, 4)], "none": [(2, 2)]})


EVENTS = [("kernel", 0.0, 2.0), ("Memcpy DtoD ", 3.0, 4.0),
          ("gemm_kernel_sm90", 4.0, 7.0), ("Memset ", 6.0, 8.0)]


def test_attribute_assigns_events_by_ordinal():
  got = trace.attribute(_map(), EVENTS)
  assert got == {
      "a": {"busy_us": 3.0, "idle_us": 1.0, "nodes": 2},
      "b": {"busy_us": 4.0, "idle_us": 0.0, "nodes": 2},
      "c": {"busy_us": 4.0, "idle_us": 0.0, "nodes": 2},
      "d": {"busy_us": 4.0, "idle_us": 0.0, "nodes": 2},
      "none": {"busy_us": 0.0, "idle_us": 0.0, "nodes": 0}}


@pytest.mark.parametrize("events", [
    EVENTS[:3], EVENTS + [("kernel", 9.0, 10.0)],
    [("other", 0.0, 2.0)] + EVENTS[1:],
    [EVENTS[1], EVENTS[0]] + EVENTS[2:]])
def test_attribute_refuses_events_that_are_not_the_map(events):
  assert trace.attribute(_map(), events) is None


def test_replays_finds_whole_replays_only():
  """Two replays between eager work (a fill before each, a copy after),
  and a third cut short: two found, each the map's nodes in order."""
  fill, copy = ("fill_kernel", -2.0, -1.0), ("Memcpy DtoH ", 9.0, 9.5)
  shifted = [(n, a + 20, b + 20) for n, a, b in EVENTS]
  events = [fill, *EVENTS, copy, fill, *shifted, copy, fill, *EVENTS[:3]]
  got = trace.replays(_map(), events)
  assert got == [EVENTS, shifted]
  assert trace.replays(trace.SpanMap("p", [], {}), events) == []


@pytest.mark.parametrize("node,event,want", [
    ("_ZN2at6native29vectorized_elementwise_kernelILi4EEEviT_",
     "vectorized_elementwise_kernel", True),
    ("_ZN12_GLOBAL__N_115rows_apply_bf16ILi128EEEvv", "rows_apply_bf16",
     True),
    ("mm_bf16x3_splitk", "mm_bf16x3_splitk", True),
    ("mm_bf16x3_splitk", "mm_bf16x3_rows", False),
    ("Memcpy", "Memcpy DtoD ", True),
    ("Memcpy", "memcpy32_post", True),
    ("Memset", "memset32", True),
    ("_ZN2at6native6kernelEv", "memset32", False),
    ("Memset", "Memcpy DtoD ", False),
    ("_ZN2at6native6kernelEv", "Memcpy DtoD ", False),
    ("_ZN2at6native6kernelEv", "", False)])
def test_matches(node, event, want):
  assert trace.matches(node, event) is want


class _FakeDriver:
  """A graph of six nodes in a chain: kernel, empty, kernel, memcpy,
  kernel, kernel; each node's count of device nodes up to it."""

  ORDER = [11, 12, 13, 14, 15, 16]
  UPTO = [1, 1, 2, 3, 4, 5]
  NAMES = ["k0", "k1", "Memcpy", "k2", "k3"]

  def walk(self, graph):
    return self.ORDER, self.UPTO, self.NAMES


def test_span_map_from_the_capture_positions():
  """A span's range runs from the device nodes before its first
  dependency set to those before its last: nested spans, a span with no
  node, a span begun at the capture's start."""
  cap = trace._Capture.__new__(trace._Capture)
  cap.program, cap.driver, cap.graph, cap.noted = "p", _FakeDriver(), 1, []
  cap.note("first", (), (12,))
  cap.note("outer", (12,), (16,))
  cap.note("inner", (13,), (14,))
  cap.note("empty", (14,), (14,))
  cap.note("lost", (14,), None)
  m = cap.span_map()
  assert m.nodes == 5 and m.names == _FakeDriver.NAMES
  assert m.spans == {"first": [(0, 1)], "outer": [(1, 5)],
                     "inner": [(2, 3)], "empty": [(3, 3)]}
