"""The work counts (``wcbench/work/counts.py``) against
``torch.utils.flop_counter.FlopCounterMode`` over the port's eager step and
eval forward (plain moments, whitening products in true float32), at the
configurations' full widths and a small batch, on the CPU."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from wcbench.core import harness, program
from wcbench.work import counts

TRAIN_CONFIGS = ("cifar10_wcres_high", "tinyin64_cwcsa")


def _plain(state):
  for m in list(state.g.modules()) + list(state.d.modules()):
    if hasattr(m, "use_kernel"):
      m.use_kernel = False


@pytest.mark.parametrize("name", TRAIN_CONFIGS)
def test_outer_step_flops_equal_the_flop_counter(name):
  from wcgan_tpu_torch.ops import whiten
  from wcgan_tpu_torch.train.step import make_outer_step
  cfg = harness.config(name)
  state, gan = program.build_state(cfg, torch.device("cpu"))
  _plain(state)
  b, k, res = 2, gan.training_ratio, cfg["resolution"]
  gen = torch.Generator().manual_seed(0)
  real = torch.randint(0, 256, (k, b, res, res, 3), generator=gen,
                       dtype=torch.uint8)
  labels = torch.randint(0, max(gan.num_classes, 1), (k, b), generator=gen)
  counter = FlopCounterMode(display=False)
  with whiten.precision("highest"), counter:
    make_outer_step(gan)(state, real, labels)
  assert counter.get_total_flops() == counts.outer_step_flops(cfg, b)


@pytest.mark.parametrize("name", TRAIN_CONFIGS)
def test_eval_forward_flops_equal_the_flop_counter(name):
  from wcgan_tpu_torch.ops import whiten
  cfg = harness.config(name)
  state, gan = program.build_state(cfg, torch.device("cpu"))
  z = torch.randn(3, cfg["z_dim"])
  y = torch.zeros(3, dtype=torch.long) if gan.num_classes else None
  counter = FlopCounterMode(display=False)
  with torch.no_grad(), whiten.precision("highest"), counter:
    state.g(z, y, train=False)
  assert counter.get_total_flops() == counts.eval_forward_flops(cfg, 3)


def test_headline_counts():
  """The JAX package's bench headline: 4,130,862,698,240 FLOPs an outer
  step at batch 64 (FlopCounterMode on the card), 42 K1 calls and 2,499
  K3 products a step under 'high' (the port's launch counters)."""
  cfg = harness.config("cifar10_wcres_high")
  assert counts.outer_step_flops(cfg, 64) == 4_130_862_698_240
  assert len(counts.k1_calls_per_step(cfg, 64, 2)) == 42
  assert len(counts.k3_calls_per_step(cfg, 64)) == 2_499
  assert len(counts.k3_calls_per_eval_forward(cfg)) == 7 * 45


def test_cwcsa_counts():
  cfg = harness.config("tinyin64_cwcsa")
  assert len(counts.k1_calls_per_step(cfg, 64, 2)) == 54


def test_least_time_is_the_larger_bound():
  call = counts.Call(flops=989e9, peak=counts.PEAK_BF16, bytes=0.0)
  assert call.least_s == pytest.approx(1e-3)
  call = counts.Call(flops=0.0, peak=counts.PEAK_BF16, bytes=3.35e9)
  assert call.least_s == pytest.approx(1e-3)
