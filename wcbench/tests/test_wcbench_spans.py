"""The per-layer metrics that read the program's spans (``work/spans.py``)
on a synthetic traced slice and span table: each reads its spans' device
time over the replays of the program's graph, or its host spans' time,
and each gives nothing where the spans are missing or the slice does not
line up with the span map."""

import builtins
import types

import pytest

from wcbench.core import harness
from wcbench.core.trace import Slice
from wcbench.work import spans
from wcgan_tpu_torch import trace

# One replay: 8 nodes; a chain of two steps would repeat them.
NAMES = ["randint_kernel", "_ZN2at6native6gatherEv", "conv_fwd",
         "Memcpy", "gemm", "adam_kernel", "conv_fwd", "mm_bf16x3_nn"]
SPANS = {"step.draws": [(0, 2)], "step.fakes": [(2, 3)],
         "step.d_pass": [(3, 5)], "step.d_adam": [(5, 6)],
         "step.g_pass": [(6, 8)], "step.g_adam": [(8, 8)],
         "wc.forward": [(2, 3), (6, 7)], "wc.backward": [(7, 8)]}
SHORT = ["randint_kernel", "gather", "conv_fwd", "Memcpy DtoD ", "gemm",
         "adam_kernel", "conv_fwd", "mm_bf16x3_nn"]


def _replay(t0):
  """The 8 events of one replay from ``t0`` (us): each 1 us, 1 us apart."""
  return [(n, t0 + 2.0 * i, t0 + 2.0 * i + 1.0)
          for i, n in enumerate(SHORT)]


def _slice(calls=2, extra=None):
  """``calls`` replays, each after a fill kernel and before a copy (the
  eager work of a program's call)."""
  kernels = []
  for c in range(calls):
    t0 = 100.0 * c
    kernels += [("fill_kernel", t0, t0 + 1.0), *_replay(t0 + 10.0),
                ("Memcpy DtoD ", t0 + 50.0, t0 + 51.0)]
  kernels += extra or []
  return Slice(calls=calls, wall_s=1e-3, kernels=kernels, host=[],
               start_us=0.0, end_us=100.0 * calls)


def _ctx(s, steps=None):
  return types.SimpleNamespace(
      slice=s, result=types.SimpleNamespace(
          slice_steps=steps if steps is not None else s.calls))


@pytest.fixture
def mapped(monkeypatch):
  monkeypatch.setitem(trace.maps(), spans.TRAIN_PROGRAM,
                      trace.SpanMap(spans.TRAIN_PROGRAM, NAMES, SPANS))
  monkeypatch.setitem(trace.maps(), spans.SAMPLE_PROGRAM,
                      trace.SpanMap(spans.SAMPLE_PROGRAM, NAMES, SPANS))
  trace.reset()
  yield
  trace.reset()


@pytest.mark.parametrize("metric,want", [
    ("d_ms_per_step.train", 2e-3), ("g_ms_per_step.train", 3e-3),
    ("adam_ms_per_step.train", 1e-3), ("wc_ms_per_step.train", 3e-3),
    ("wc_ms_per_batch.sample", 2e-3)])
def test_device_span_readers(mapped, metric, want):
  """Each span's nodes' busy microseconds, over both replays, per step
  (one a call here) or per batch."""
  got = harness.metric_reader(metric)(_ctx(_slice()))
  assert got == pytest.approx(want)


def test_device_readers_per_step_of_a_chain(mapped):
  got = harness.metric_reader("d_ms_per_step.train")(_ctx(_slice(), 8))
  assert got == pytest.approx(2 * 2e-3 / 8)


@pytest.mark.parametrize("case", ["no_map", "partial", "misnamed",
                                  "no_slice", "more_calls"])
def test_device_readers_give_nothing_that_does_not_line_up(mapped,
                                                           monkeypatch,
                                                           case):
  s = _slice()
  if case == "no_map":
    monkeypatch.delitem(trace.maps(), spans.TRAIN_PROGRAM)
  elif case == "partial":
    s.kernels = s.kernels[:-3]
  elif case == "misnamed":
    s.kernels[3] = ("other", *s.kernels[3][1:])
  elif case == "no_slice":
    s = None
  else:
    s.calls = 3
  assert harness.metric_reader("d_ms_per_step.train")(_ctx(s, 2)) is None


def test_readers_without_the_programs_spans(monkeypatch):
  """A program without ``wcgan_tpu_torch.trace`` (the port before its
  spans): every reader gives nothing, and none raises."""
  real = builtins.__import__

  def no_trace(name, globals=None, locals=None, fromlist=(), level=0):
    if name == "wcgan_tpu_torch" and fromlist and "trace" in fromlist:
      raise ImportError("no trace")
    return real(name, globals, locals, fromlist, level)
  monkeypatch.setattr(builtins, "__import__", no_trace)
  for metric in ("d_ms_per_step.train", "g_ms_per_step.train",
                 "adam_ms_per_step.train", "wc_ms_per_step.train",
                 "wc_ms_per_batch.sample", "host_ms_per_batch.sample",
                 "setup_state_s.train", "setup_program_s.train"):
    assert harness.metric_reader(metric)(_ctx(_slice())) is None, metric


def test_host_span_readers(mapped):
  """The sampling program's host spans a batch (its launch left out), the
  state's set-up, and the chain's warm-up and capture less the builds
  inside them; nothing before the spans have run."""
  ctx = _ctx(_slice())
  assert harness.metric_reader("host_ms_per_batch.sample")(ctx) is None
  assert harness.metric_reader("setup_program_s.train")(ctx) is None
  for _ in range(4):
    for part in ("inputs", "state", "key", "fill", "launch", "counts",
                 "clone"):
      with trace.span(f"{spans.SAMPLE_PROGRAM}.{part}"):
        pass
  with trace.span("state.create"):
    pass
  with trace.span(f"{spans.TRAIN_PROGRAM}.warm_up"):
    with trace.span("kernels.build"):
      pass
  with trace.span(f"{spans.TRAIN_PROGRAM}.capture"):
    pass
  t = trace.table()
  p = spans.SAMPLE_PROGRAM
  want = sum(t[f"{p}.{part}"]["s"] for part in (
      "inputs", "state", "key", "fill", "counts", "clone")) * 1e3 / 4
  assert harness.metric_reader("host_ms_per_batch.sample")(ctx) == \
      pytest.approx(want)
  assert harness.metric_reader("setup_state_s.train")(ctx) == \
      t["state.create"]["s"]
  w, c = (t[f"{spans.TRAIN_PROGRAM}.{k}"] for k in ("warm_up", "capture"))
  assert harness.metric_reader("setup_program_s.train")(ctx) == \
      pytest.approx(w["s"] - t["kernels.build"]["s"] + c["s"])
