"""The port's kernels on a CUDA card (marker ``cuda``; skipped without
one).

These need a GPU and nvcc, and import no JAX, so they run where the port
runs. tests/conftest.py imports JAX, so on such a machine skip it:

  python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

K1 is held against its plain float32 version on the same tensors, to
1e-4: the reference's own on-chip gate for its moments kernel, at every
width it takes in the CPU tests (8 to 512); at R >= 65,536, where plain
float32 drifts, against a float64 run of the same values instead. Two
calls must agree bitwise and cov must equal cov^T. bf16 input is the same
bf16 values on both sides, upcast. K2 is held against its
plain version to 5e-4 in float32 (the JAX package's gate between its
fused kernel and the composition, tests/test_pallas_wc.py) and, with
bf16 rows, to 2 bf16 ulps of the output's largest magnitude (both round
a float32 result once; the float32 results differ by far less). At
R = 262,144 its bf16 rows are also held against a float64 run of the same
fold: no further from it than twice the plain version's distance. K4,
D's 2x2 average pool, is held to ATen's ``F.avg_pool2d`` bit for bit,
forward, backward and double backward."""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wcgan_tpu_torch.ops import cuda_wc

pytestmark = pytest.mark.cuda
ATOL = 1e-4


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device("cuda", 0)


def _max_err(a, b):
  return max(float((x.double() - y.double()).abs().max())
             for x, y in zip(a, b))


def _k1_reference(x):
  """K1's yardstick: the plain float32 moments, or at R >= 65,536 a
  float64 run of the same values, because there plain float32 is itself
  off by up to ~5e-5 (C=512) and would take most of the gate."""
  if x.shape[0] < 65536:
    return cuda_wc.moments_reference(x)
  x64 = x.double()
  mean = x64.mean(dim=0)
  return mean, (x64 - mean).T @ (x64 - mean) / x64.shape[0]


# The ragged shapes of tests/test_pallas_wc.py, then the main path's C=256
# at its smallest and largest R.
@pytest.mark.parametrize("rows,cols", [(512, 16), (1000, 32), (64, 8),
                                       (130, 16), (1024, 256),
                                       (131072, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain(rows, cols, dtype, dev):
  gen = torch.Generator(device=dev).manual_seed(rows + cols)
  x = (torch.randn((rows, cols), generator=gen, device=dev) * 2 + 3).to(dtype)
  before = cuda_wc.MOMENTS_LAUNCHES
  mean, cov = cuda_wc.moments_cuda(x)
  torch.cuda.synchronize()
  assert cuda_wc.MOMENTS_LAUNCHES == before + 1
  assert mean.dtype == cov.dtype == torch.float32
  assert torch.equal(cov, cov.T)
  assert _max_err((mean, cov), _k1_reference(x)) <= ATOL


# Every width K1 takes in the CPU tests and the JAX package's headline
# width, zero-padded to 128-column tiles in shared memory, at ragged R
# and at the main path's largest R.
@pytest.mark.parametrize("rows", [130, 1000, 131072])
@pytest.mark.parametrize("cols", [8, 16, 32, 256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_every_width_repeatable_and_symmetric(rows, cols, dtype, dev):
  gen = torch.Generator(device=dev).manual_seed(7 * rows + cols)
  x = (torch.randn((rows, cols), generator=gen, device=dev) * 2 + 3).to(dtype)
  mean, cov = cuda_wc.moments_cuda(x)
  mean2, cov2 = cuda_wc.moments_cuda(x)
  torch.cuda.synchronize()
  assert torch.equal(mean, mean2) and torch.equal(cov, cov2)
  assert torch.equal(cov, cov.T)
  assert _max_err((mean, cov), _k1_reference(x)) <= ATOL


def test_k1_large_mean_keeps_diagonal(dev):
  """|mu| = 1000, sigma = 0.01: the mean is final before the products."""
  gen = torch.Generator(device=dev).manual_seed(0)
  x = torch.randn((4096, 256), generator=gen, device=dev) * 0.01 + 1000.0
  mean, cov = cuda_wc.moments_cuda(x)
  mean_p, cov_p = cuda_wc.moments_reference(x)
  diag = torch.diagonal(cov)
  assert float(diag.min()) >= 0
  assert float(((diag - 1e-4) / 1e-4).abs().max()) <= 0.2
  assert float(((mean - mean_p) / mean_p).abs().max()) <= 1e-6
  assert _max_err((cov,), (cov_p,)) <= 1e-6


def test_k1_gradient_matches_autograd_of_plain(dev):
  gen = torch.Generator(device=dev).manual_seed(1)
  x = torch.randn((4096, 256), generator=gen, device=dev) * 2 + 3
  w = torch.randn((256, 256), generator=gen, device=dev)
  grads = []
  for fn in (cuda_wc.moments, cuda_wc.moments_reference):
    xg = x.clone().requires_grad_(True)
    mean, cov = fn(xg)
    (torch.sum(cov * w) + torch.sum(mean ** 2)).backward()
    grads.append(xg.grad)
  assert _max_err(grads[:1], grads[1:]) <= ATOL


# The conditional slice's widths and row counts: the cWC-sa G whitens at
# C = 512, 256, 128 and 64 with R up to 524,288 (its G update at C=64);
# WC in D at C=128.
@pytest.mark.parametrize("rows,cols", [(1024, 512), (8192, 512),
                                       (1000, 512), (4096, 128),
                                       (131072, 128), (1000, 128),
                                       (262144, 64), (524288, 64),
                                       (1000, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_conditional_widths(rows, cols, dtype, dev):
  gen = torch.Generator(device=dev).manual_seed(3 * rows + cols)
  x = (torch.randn((rows, cols), generator=gen, device=dev) * 2 + 3).to(dtype)
  mean, cov = cuda_wc.moments_cuda(x)
  mean2, cov2 = cuda_wc.moments_cuda(x)
  torch.cuda.synchronize()
  assert torch.equal(mean, mean2) and torch.equal(cov, cov2)
  assert torch.equal(cov, cov.T)
  assert _max_err((mean, cov), _k1_reference(x)) <= ATOL


@pytest.mark.parametrize("rows,cols", [(4096, 128), (16384, 64)])
def test_k1_double_backward_matches_autograd_of_plain(rows, cols, dev):
  """The gradient of a gradient's norm through K1 (WGAN-GP with WC in D)
  against plain autograd over the two-pass formula, rtol 1e-4."""
  gen = torch.Generator(device=dev).manual_seed(rows)
  x = torch.randn((rows, cols), generator=gen, device=dev) * 1.5 + 2
  w = torch.randn((cols, cols), generator=gen, device=dev)
  outs = []
  for fn in (cuda_wc.moments, cuda_wc.moments_reference):
    xg = x.clone().requires_grad_(True)
    mean, cov = fn(xg)
    g, = torch.autograd.grad(torch.sum(cov * w) + torch.sum(mean ** 2), xg,
                             create_graph=True)
    hx, = torch.autograd.grad(torch.sum(g ** 2), xg)
    outs.append((g.detach(), hx))
  for a, b in zip(*outs):
    scale = float(b.abs().max())
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * scale)


def test_k1_refuses_what_it_does_not_take(dev):
  before = cuda_wc.MOMENTS_LAUNCHES
  with pytest.raises(TypeError, match="float32 or bfloat16"):
    cuda_wc.moments(torch.zeros((8, 4), dtype=torch.float16, device=dev))
  with pytest.raises(ValueError, match="contiguous"):
    cuda_wc.moments(torch.zeros((4, 8), device=dev).T)
  # TMA needs rows of a multiple of 16 bytes: C % 4 (float32), C % 8 (bf16).
  with pytest.raises(ValueError, match="16 bytes"):
    cuda_wc.moments(torch.zeros((8, 6), device=dev))
  with pytest.raises(ValueError, match="16 bytes"):
    cuda_wc.moments(torch.zeros((8, 12), dtype=torch.bfloat16, device=dev))
  assert cuda_wc.MOMENTS_LAUNCHES == before



# --- K2 whiten_color_apply ---------------------------------------------------


def _wc_inputs(rows, cols, gen, dev, cond=1e3):
  """Running statistics with a correlated covariance of condition
  ``cond`` (live WC layers reach ~1e3), rows drawn from them (so that the
  whitened rows are O(1), as in G), Gamma near 1/sqrt(C) scale."""
  q, _ = torch.linalg.qr(torch.randn((cols, cols), generator=gen, device=dev))
  eig = torch.logspace(0.0, -float(np.log10(cond)), cols, device=dev)
  cov = (q * eig) @ q.T
  mean = torch.randn((cols,), generator=gen, device=dev)
  x = mean + (torch.randn((rows, cols), generator=gen, device=dev)
              * eig.sqrt()) @ q.T
  gamma = torch.randn((cols, cols), generator=gen, device=dev) / cols ** 0.5
  beta = torch.randn((cols,), generator=gen, device=dev)
  return x, mean, cov, gamma, beta


def _bf16_gate(ref):
  """2 bf16 ulps of the largest |ref|."""
  top = float(ref.float().abs().max())
  return 2.0 * 2.0 ** (torch.floor(torch.log2(torch.tensor(top))).item() - 7)


@pytest.mark.parametrize("rows,cols", [(130, 16), (1000, 64), (1024, 256),
                                       (65536, 256), (1000, 512)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scaling", ["trace", "fro"])
def test_k2_matches_plain(rows, cols, dtype, scaling, dev):
  gen = torch.Generator(device=dev).manual_seed(rows + cols)
  x, mean, cov, gamma, beta = _wc_inputs(rows, cols, gen, dev)
  x = x.to(dtype)
  before = cuda_wc.WC_APPLY_LAUNCHES
  out = cuda_wc.whiten_color_apply(x, mean, cov, gamma, beta,
                                   scaling=scaling)
  torch.cuda.synchronize()
  assert cuda_wc.WC_APPLY_LAUNCHES == before + 1
  assert out.dtype == dtype and out.shape == x.shape
  ref = cuda_wc.whiten_color_apply_reference(x, mean, cov, gamma, beta,
                                             scaling=scaling)
  err = float((out.float() - ref.float()).abs().max())
  assert err <= (5e-4 if dtype == torch.float32 else _bf16_gate(ref)), err


def test_k2_identity_coloring_and_negative_diagonal(dev):
  """DecorrelationNorm's call (Gamma = I, beta = 0) on the covariance of
  tests/test_pallas_wc.py whose diagonal rounded negative."""
  gen = torch.Generator(device=dev).manual_seed(3)
  x, mean, cov, _, _ = _wc_inputs(200, 8, gen, dev, cond=10.0)
  # Feature 0 near-constant: its variance rounded negative, junk
  # covariances of the same magnitude.
  cov[0, :] = cov[:, 0] = 1e-8 * torch.randn((8,), generator=gen, device=dev)
  cov[0, 0] = -3e-8
  x[:, 0] = mean[0] + 1e-4 * torch.randn((200,), generator=gen, device=dev)
  args = (mean, cov, torch.eye(8, device=dev), torch.zeros(8, device=dev))
  out = cuda_wc.whiten_color_apply(x, *args)
  assert torch.isfinite(out).all()
  ref = cuda_wc.whiten_color_apply_reference(x, *args)
  assert float((out - ref).abs().max()) <= 5e-4


def test_k2_setup_matches_plain_fold(dev):
  gen = torch.Generator(device=dev).manual_seed(4)
  # cond 1e2: W = cov^{-1/2} then stays below 10, and so does M.
  _, mean, cov, gamma, beta = _wc_inputs(8, 256, gen, dev, cond=1e2)
  m, bias = cuda_wc.whiten_color_fold_cuda(mean, cov, gamma, beta)
  m_ref, bias_ref = cuda_wc.whiten_color_fold_reference(mean, cov, gamma,
                                                        beta)
  assert _max_err((m, bias), (m_ref, bias_ref)) <= 5e-4


def test_k2_refuses_what_it_does_not_take(dev):
  c = 16
  args = (torch.zeros(c, device=dev), torch.eye(c, device=dev),
          torch.eye(c, device=dev), torch.zeros(c, device=dev))
  before = cuda_wc.WC_APPLY_LAUNCHES
  with pytest.raises(TypeError, match="float32 or bfloat16"):
    cuda_wc.whiten_color_apply(
        torch.zeros((8, c), dtype=torch.float16, device=dev), *args)
  with pytest.raises(ValueError, match="contiguous"):
    cuda_wc.whiten_color_apply(torch.zeros((c, 8), device=dev).T, *args)
  with pytest.raises(ValueError, match="'trace' or 'fro'"):
    cuda_wc.whiten_color_apply(torch.zeros((8, c), device=dev), *args,
                               scaling="spectral")
  with pytest.raises(ValueError, match="C <= 512"):
    wide = 513
    cuda_wc.whiten_color_apply(
        torch.zeros((8, wide), device=dev), torch.zeros(wide, device=dev),
        torch.eye(wide, device=dev), torch.eye(wide, device=dev),
        torch.zeros(wide, device=dev))
  assert cuda_wc.WC_APPLY_LAUNCHES == before


def test_k2_eval_layers_launch_once_per_forward(dev):
  """kernel_eval=True sends every eval-mode WC layer of G through K2: 7
  launches for the headline G 256x3 (here narrow), none in train mode."""
  from wcgan_tpu_torch.device import place
  from wcgan_tpu_torch.models.generator import Generator, GeneratorConfig
  cfg = GeneratorConfig(z_dim=16, filters=(32, 32, 32), dtype="bfloat16",
                        kernel_eval=True)
  g = place(Generator(cfg, torch.Generator().manual_seed(0)), dev)
  z = torch.randn((4, 16), device=dev)
  before = cuda_wc.WC_APPLY_LAUNCHES
  g(z, train=True, update_stats=True)
  assert cuda_wc.WC_APPLY_LAUNCHES == before
  img = g(z, train=False)
  torch.cuda.synchronize()
  assert cuda_wc.WC_APPLY_LAUNCHES == before + 7
  assert img.dtype == torch.float32 and torch.isfinite(img).all()


def _k2_f64(x, mean, cov, gamma, beta, scaling):
  """x M^T + bias in float64 on the plain version's float32 fold."""
  m, bias = cuda_wc.whiten_color_fold_reference(mean, cov, gamma, beta,
                                                scaling=scaling)
  return x.double() @ m.double().T + bias.double()


@pytest.mark.parametrize("scaling", ["trace", "fro"])
def test_k2_large_r_bf16_against_float64(scaling, dev):
  """The main path's largest call (R = 262,144, C = 256, bf16 rows): both
  K2 and the plain version round to bf16, so each is up to half an ulp
  from float64; K2 within 2 ulps of plain and within 2x of its distance."""
  gen = torch.Generator(device=dev).manual_seed(11)
  x, mean, cov, gamma, beta = _wc_inputs(262144, 256, gen, dev)
  x = x.to(torch.bfloat16)
  out = cuda_wc.whiten_color_apply(x, mean, cov, gamma, beta,
                                   scaling=scaling)
  ref = cuda_wc.whiten_color_apply_reference(x, mean, cov, gamma, beta,
                                             scaling=scaling)
  exact = _k2_f64(x, mean, cov, gamma, beta, scaling)
  torch.cuda.synchronize()
  assert float((out.float() - ref.float()).abs().max()) <= _bf16_gate(ref)
  err_k2 = float((out.double() - exact).abs().max())
  err_plain = float((ref.double() - exact).abs().max())
  assert err_k2 <= 2 * err_plain, (err_k2, err_plain)


# Ragged R at the narrow widths (one 64-column slice, K padded to 64) and
# widths that cut the slices and K chunks unevenly: 72 and 136 (128-column
# slices), 264 and 392 (64-column slices, the last one ragged).
@pytest.mark.parametrize("rows,cols", [(1, 16), (127, 16), (4097, 16),
                                       (129, 64), (4099, 64), (300, 8),
                                       (300, 72), (300, 136), (300, 264),
                                       (300, 392)])
def test_k2_bf16_ragged_rows_and_widths(rows, cols, dev):
  gen = torch.Generator(device=dev).manual_seed(rows * cols)
  x, mean, cov, gamma, beta = _wc_inputs(rows, cols, gen, dev)
  x = x.to(torch.bfloat16)
  out = cuda_wc.whiten_color_apply(x, mean, cov, gamma, beta)
  ref = cuda_wc.whiten_color_apply_reference(x, mean, cov, gamma, beta)
  torch.cuda.synchronize()
  assert out.shape == x.shape and out.dtype == torch.bfloat16
  assert float((out.float() - ref.float()).abs().max()) <= _bf16_gate(ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_two_launches_equal_the_whole_call(dtype, dev):
  """The setup and the row apply launched apart give the whole call's
  result bitwise, and neither counts as a K2 launch."""
  gen = torch.Generator(device=dev).manual_seed(12)
  x, mean, cov, gamma, beta = _wc_inputs(4096, 256, gen, dev)
  x = x.to(dtype)
  before = cuda_wc.WC_APPLY_LAUNCHES
  workspace = cuda_wc.whiten_color_setup_cuda(mean, cov, gamma, beta)
  apart = cuda_wc.whiten_color_rows_cuda(x, workspace)
  assert cuda_wc.WC_APPLY_LAUNCHES == before
  whole = cuda_wc.whiten_color_apply(x, mean, cov, gamma, beta)
  again = cuda_wc.whiten_color_apply(x, mean, cov, gamma, beta)
  torch.cuda.synchronize()
  assert torch.equal(apart, whole) and torch.equal(whole, again)


@pytest.mark.parametrize("cols", [4, 12, 20, 520])
def test_k2_refuses_widths_it_does_not_take(cols, dev):
  """Below 8, not a multiple of 8 (bf16 rows must be 16-byte multiples for
  TMA), or above 512: refused before any launch, in both dtypes."""
  before = cuda_wc.WC_APPLY_LAUNCHES
  stats = (torch.zeros(cols, device=dev), torch.eye(cols, device=dev),
           torch.eye(cols, device=dev), torch.zeros(cols, device=dev))
  for dtype in (torch.float32, torch.bfloat16):
    with pytest.raises(ValueError, match="C % 8 == 0"):
      cuda_wc.whiten_color_apply(
          torch.zeros((8, cols), dtype=dtype, device=dev), *stats)
  with pytest.raises(ValueError, match="C % 8 == 0"):
    cuda_wc.whiten_color_fold_cuda(*stats)
  assert cuda_wc.WC_APPLY_LAUNCHES == before


# --- the trainer on the card: full state, standing statistics, EMA K2 -------

TRAIN_FLAGS = ["--device", "cuda", "--dataset", "synthetic",
               "--synthetic_size", "256", "--generator_filters", "32,32,32",
               "--discriminator_filters", "32,32", "--batch_size", "16",
               "--training_ratio", "2", "--z_dim", "16", "--bf16",
               "--batches_per_epoch", "2", "--steps_per_call", "2",
               "--display_ratio", "0", "--generator_ema", "0.9",
               "--name", "lane"]


def _trainer(tmp_path, *extra):
  from wcgan_tpu_torch.cli import run as trun
  return trun.build_experiment(trun.build_parser().parse_args(
      TRAIN_FLAGS + ["--output_dir", str(tmp_path / "o"),
                     "--checkpoints_dir", str(tmp_path / "c"), *extra]))


def _assert_bit_equal(a, b, where="state"):
  if isinstance(a, dict):
    assert a.keys() == b.keys(), where
    for k in a:
      _assert_bit_equal(a[k], b[k], f"{where}/{k}")
  elif isinstance(a, (list, tuple)):
    assert len(a) == len(b), where
    for i, (x, y) in enumerate(zip(a, b)):
      _assert_bit_equal(x, y, f"{where}/{i}")
  elif torch.is_tensor(a):
    assert a.dtype == b.dtype and a.device == b.device, where
    assert torch.equal(a, b), where
  else:
    assert a == b, where


def test_full_state_roundtrip_on_card_bit_equal(dev, tmp_path):
  tt = _trainer(tmp_path, "--number_of_epochs", "1", "--checkpoint_ratio",
                "1")
  tt.train()
  fresh = _trainer(tmp_path)
  fresh.restore_checkpoint(tt.checkpoint_path(0))
  assert fresh.state.g.nc_out.cov.is_cuda
  assert fresh.state.generator.device.type == "cuda"
  _assert_bit_equal(fresh.full_state(), tt.full_state())
  # The file loads on the card as it is.
  saved = torch.load(os.path.join(tt.checkpoint_path(0), "state.pt"),
                     map_location=dev, weights_only=True)
  assert saved["g"]["nc_out.cov"].is_cuda


def test_standing_stats_launch_k1_per_layer_and_batch(dev, tmp_path):
  """One standing recompute: 7 WC layers x ema_standing_stats batches of
  K1; a cached second call launches nothing; an outer step recomputes."""
  tt = _trainer(tmp_path, "--ema_standing_stats", "3")
  before = cuda_wc.MOMENTS_LAUNCHES
  first = tt.sampling_state()
  torch.cuda.synchronize()
  assert cuda_wc.MOMENTS_LAUNCHES == before + 7 * 3
  assert tt.sampling_state() is first
  assert cuda_wc.MOMENTS_LAUNCHES == before + 7 * 3
  tt.step_fn(tt.state, *tt._device_data)
  before = cuda_wc.MOMENTS_LAUNCHES
  assert tt.sampling_state() is not first
  assert cuda_wc.MOMENTS_LAUNCHES == before + 7 * 3


def test_ema_sampling_through_k2_matches_its_plain_version(dev, tmp_path,
                                                         monkeypatch):
  """generate() from the EMA weights with standing statistics: a G with
  kernel_eval=True sends every WC layer through K2 (7 a forward) and
  agrees with the same G whose layers call K2's plain version, within
  chip_smoke.py's sampling gates. (Against the split path, which rounds
  M to bf16 before its row product, the mean gap passes 1 level under
  standing statistics: that rounding is the split path's, PERF.md.)"""
  import dataclasses
  from wcgan_tpu_torch.device import place
  from wcgan_tpu_torch.models.generator import Generator
  from wcgan_tpu_torch.train.trainer import Trainer
  # The headline widths, where chip_smoke.py's gates were set.
  tt = _trainer(tmp_path, "--number_of_epochs", "1", "--checkpoint_ratio",
                "0", "--generator_filters", "256,256,256",
                "--discriminator_filters", "128,128,128,128", "--batch_size",
                "64")
  tt.train()
  g_k = place(Generator(dataclasses.replace(tt.state.g.cfg,
                                            kernel_eval=True),
                        torch.Generator().manual_seed(0)), dev)
  g_k.load_state_dict(tt.state.g.state_dict())
  fused = Trainer(tt.ds, dataclasses.replace(tt.state, g=g_k), tt.gan_cfg,
                  tt.cfg)
  before = cuda_wc.WC_APPLY_LAUNCHES
  imgs = fused.generate(64, batch=32)
  torch.cuda.synchronize()
  assert cuda_wc.WC_APPLY_LAUNCHES == before + 7 * 2
  assert np.array_equal(imgs, fused.generate(64, batch=32))
  monkeypatch.setattr(cuda_wc, "whiten_color_apply",
                      cuda_wc.whiten_color_apply_reference)
  fused.invalidate_sampling()   # the graphs hold K2's launches
  plain = fused.generate(64, batch=32)
  diff = np.abs(imgs.astype(np.int16) - plain.astype(np.int16))
  assert diff.mean() <= 1.0 and np.quantile(diff, 0.999) <= 4.0
  assert diff.max() <= 16


def test_window_staging_on_card(dev, tmp_path):
  """Datasets over --device_data_limit: each window is copied from pinned
  memory on a side stream and the training stream waits for it; the
  window staged for an epoch that will not run is released."""
  tt = _trainer(tmp_path, "--number_of_epochs", "2", "--checkpoint_ratio",
                "0", "--device_data_limit", str(32 * 32 * 3 * 80))
  assert tt._window_elems == 40 and tt._window_next is not None
  tt.train()
  imgs, labels = tt._device_data
  assert imgs.is_cuda and imgs.shape == (40, 32, 32, 3)
  assert labels.is_cuda and tt._window_next is None
  assert tt.state.step == 4
  # Epoch 1 trained on the second window the seed + 17 generator picked.
  rng = np.random.default_rng(17)
  rng.choice(256, 40, replace=False)
  second = np.sort(rng.choice(256, 40, replace=False))
  np.testing.assert_array_equal(imgs.cpu().numpy(), tt.ds.images[second])


# --- the conditional slice on the card -----------------------------------------


COND_FLAGS = ["--device", "cuda", "--dataset", "synthetic",
              "--synthetic_size", "256", "--generator_filters", "32,32,32",
              "--discriminator_filters", "32,32,32", "--batch_size", "16",
              "--training_ratio", "2", "--z_dim", "16", "--bf16",
              "--batches_per_epoch", "2", "--steps_per_call", "2",
              "--display_ratio", "0", "--checkpoint_ratio", "0",
              "--conditional", "--gan_type", "PROJECTIVE",
              "--generator_block_coloring", "ucconv",
              "--generator_last_coloring", "ucconv-sa", "--name", "cond"]


def test_conditional_training_and_generate_on_card(dev, tmp_path):
  """A conditional run on the card: 7 K1 launches a G forward, none of K2
  in conditional sampling, repeatable images."""
  from wcgan_tpu_torch.cli import run as trun
  tt = trun.build_experiment(trun.build_parser().parse_args(
      COND_FLAGS + ["--number_of_epochs", "1", "--output_dir",
                    str(tmp_path)]))
  before = cuda_wc.MOMENTS_LAUNCHES
  tt.train()
  torch.cuda.synchronize()
  # 2 outer steps x (2 D-phase G forwards + 1 G update) x 7 WC layers.
  assert cuda_wc.MOMENTS_LAUNCHES == before + 2 * 3 * 7
  k2 = cuda_wc.WC_APPLY_LAUNCHES
  imgs = tt.generate(64, batch=32)
  assert cuda_wc.WC_APPLY_LAUNCHES == k2
  assert np.array_equal(imgs, tt.generate(64, batch=32))


def test_wgan_gp_with_wc_in_d_on_card(dev):
  """One float32 WGAN-GP outer step with WC in D through K1 (its backward
  differentiated twice by the penalty) against the same step on plain
  moments, with deterministic kernels: within chip_smoke.py's STEP_RTOL,
  or within twice the distance that float32 rounding alone (the same
  batches in another order, plain moments) puts between two plain runs."""
  from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
  from wcgan_tpu_torch.models.generator import GeneratorConfig
  from wcgan_tpu_torch.train.state import OptimConfig, create_state
  from wcgan_tpu_torch.ops import pool
  from wcgan_tpu_torch.train.step import GANConfig, make_outer_step
  gan = GANConfig(loss="wgan-gp", gradient_penalty_weight=10.0,
                  gan_type="projection", num_classes=10, training_ratio=2,
                  z_dim=32)
  gen = torch.Generator().manual_seed(2)
  real = torch.randint(0, 256, (2, 16, 32, 32, 3), generator=gen,
                       dtype=torch.uint8)
  labels = torch.randint(0, 10, (2, 16), generator=gen)
  noise = {"z_d": torch.randn((2, 16, 32), generator=gen),
           "z_g": torch.randn((32, 32), generator=gen),
           "y_d": torch.randint(0, 10, (2, 16), generator=gen),
           "y_g": torch.randint(0, 10, (32,), generator=gen),
           "gp_eps": torch.rand((2, 16), generator=gen)}
  perm, gperm = torch.randperm(16, generator=gen), torch.randperm(
      32, generator=gen)
  reordered = (real[:, perm], labels[:, perm],
               {k: v[gperm] if k in ("z_g", "y_g") else v[:, perm]
                for k, v in noise.items()})
  results = []
  torch.use_deterministic_algorithms(True, warn_only=True)
  torch.backends.cudnn.deterministic = True
  try:
    for use_kernel, inputs in ((True, (real, labels, noise)),
                               (False, (real, labels, noise)),
                               (False, reordered)):
      g_cfg = GeneratorConfig(z_dim=32, filters=(64, 64, 64),
                              block_coloring="ucconv",
                              last_coloring="ucconv", num_classes=10,
                              use_kernel=use_kernel)
      d_cfg = DiscriminatorConfig(filters=(64, 64, 64, 64), norm="d",
                                  projection=True, num_classes=10,
                                  use_kernel=use_kernel)
      state = create_state(g_cfg, d_cfg, OptimConfig(), 2, dev, seed=3)
      before = cuda_wc.MOMENTS_LAUNCHES
      pooled = pool.AVG_POOL2X2_LAUNCHES
      metrics = make_outer_step(gan)(state, *inputs[:2], noise=inputs[2])
      results.append(({k: float(v) for k, v in metrics.items()},
                      cuda_wc.MOMENTS_LAUNCHES - before))
      # D's pools, the penalty's double backward among them, through K4.
      assert pool.AVG_POOL2X2_LAUNCHES > pooled
  finally:
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
  (m_k, n_k), (m_p, n_p), (m_r, _) = results
  # 2 x (G 7 + D 3 passes x 6) + G 7 + D 6.
  assert n_k == 2 * (7 + 3 * 6) + 7 + 6 and n_p == 0
  for k in m_p:
    assert np.isfinite(m_k[k])
    scale = max(1.0, abs(m_p[k]))
    spread = abs(m_r[k] - m_p[k]) / scale
    assert abs(m_k[k] - m_p[k]) / scale <= max(1e-3, 2 * spread), k


# --- slice 7: the DCGAN's widths, K2 at C = 128 and 64, remat ---------------

# (C, R) of the DCGAN G's 4 WC layers at batch 64 and the G update's 128,
# and batched_fake_gen's 5 x 64-row forward at its last layer.
@pytest.mark.parametrize("rows,cols", [(1024, 256), (4096, 256),
                                       (16384, 128), (65536, 64),
                                       (2048, 256), (8192, 256),
                                       (32768, 128), (131072, 64),
                                       (327680, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_dcgan_widths(rows, cols, dtype, dev):
  gen = torch.Generator(device=dev).manual_seed(5 * rows + cols)
  x = (torch.randn((rows, cols), generator=gen, device=dev) * 2 + 3).to(dtype)
  mean, cov = cuda_wc.moments_cuda(x)
  mean2, cov2 = cuda_wc.moments_cuda(x)
  torch.cuda.synchronize()
  assert torch.equal(mean, mean2) and torch.equal(cov, cov2)
  assert torch.equal(cov, cov.T)
  assert _max_err((mean, cov), _k1_reference(x)) <= ATOL


# The DCGAN G's eval-mode layers at C = 128 and 64 (a batch-256 generate
# forward, and a ragged R).
@pytest.mark.parametrize("rows,cols", [(65536, 128), (262144, 64),
                                       (1000, 128), (130, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scaling", ["trace", "fro"])
def test_k2_dcgan_widths(rows, cols, dtype, scaling, dev):
  gen = torch.Generator(device=dev).manual_seed(rows + 7 * cols)
  x, mean, cov, gamma, beta = _wc_inputs(rows, cols, gen, dev)
  xd = x.to(dtype)
  before = cuda_wc.WC_APPLY_LAUNCHES
  got = cuda_wc.whiten_color_apply_cuda(xd, mean, cov, gamma, beta,
                                        scaling=scaling)
  torch.cuda.synchronize()
  assert cuda_wc.WC_APPLY_LAUNCHES == before + 1
  ref = cuda_wc.whiten_color_apply_reference(xd, mean, cov, gamma, beta,
                                             scaling=scaling)
  assert got.dtype == dtype
  gate = 5e-4 if dtype == torch.float32 else _bf16_gate(ref)
  assert float((got.float() - ref.float()).abs().max()) <= gate


def test_dcgan_generate_launches_k2_per_layer(dev):
  """A DCGAN G in eval mode with kernel_eval=True: 4 K2 calls a forward
  (its 3 blocks' ``nc`` and ``nc_out``), no K1."""
  from wcgan_tpu_torch.device import place
  from wcgan_tpu_torch.models.generator import Generator, GeneratorConfig
  g = place(Generator(GeneratorConfig(arch="dcgan", z_dim=16,
                                      filters=(64, 64, 32), kernel_eval=True),
                      torch.Generator().manual_seed(0)), dev)
  z = torch.randn((32, 16), device=dev)
  k1, k2 = cuda_wc.MOMENTS_LAUNCHES, cuda_wc.WC_APPLY_LAUNCHES
  with torch.no_grad():
    out = g(z, train=False)
  torch.cuda.synchronize()
  assert out.shape == (32, 3, 32, 32) and bool(torch.isfinite(out).all())
  assert cuda_wc.WC_APPLY_LAUNCHES == k2 + 4
  assert cuda_wc.MOMENTS_LAUNCHES == k1


def test_remat_g_update_counts_the_recompute(dev):
  """One float32 outer step with remat in G: K1 runs 7 x 2 times in the D
  phase (2 D updates), 7 in the G update's forward and 6 more in its
  backward, where the 3 blocks' 2 WC layers each run again; the metrics
  agree with the step without remat (deterministic kernels) within
  chip_smoke.py's STEP_RTOL."""
  from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
  from wcgan_tpu_torch.models.generator import GeneratorConfig
  from wcgan_tpu_torch.train.state import OptimConfig, create_state
  from wcgan_tpu_torch.train.step import GANConfig, make_outer_step
  gan = GANConfig(training_ratio=2, z_dim=32)
  gen = torch.Generator().manual_seed(4)
  real = torch.randint(0, 256, (2, 16, 32, 32, 3), generator=gen,
                       dtype=torch.uint8)
  noise = {"z_d": torch.randn((2, 16, 32), generator=gen),
           "z_g": torch.randn((32, 32), generator=gen)}
  results = []
  torch.use_deterministic_algorithms(True, warn_only=True)
  torch.backends.cudnn.deterministic = True
  try:
    for remat in (True, False):
      g_cfg = GeneratorConfig(z_dim=32, filters=(64, 64, 64), remat=remat)
      state = create_state(g_cfg, DiscriminatorConfig(filters=(64,) * 4),
                           OptimConfig(), 2, dev, seed=3)
      before = cuda_wc.MOMENTS_LAUNCHES
      metrics = make_outer_step(gan)(state, real, None, noise=noise)
      results.append(({k: float(v) for k, v in metrics.items()},
                      cuda_wc.MOMENTS_LAUNCHES - before,
                      {n: b.clone() for n, b in state.g.named_buffers()}))
  finally:
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
  (m_r, n_r, s_r), (m_p, n_p, s_p) = results
  assert n_p == 2 * 7 + 7 and n_r == n_p + 6
  for k in m_p:
    assert np.isfinite(m_r[k])
    assert abs(m_r[k] - m_p[k]) <= 1e-3 * max(1.0, abs(m_p[k])), k
  for n in s_p:
    assert float((s_r[n] - s_p[n]).abs().max()) <= 1e-4, n


# --- the compiled step: CUDA graphs ---------------------------------------------


def test_k1_inside_a_capture_matches_plain(dev):
  """K1 captured in a CUDA graph (its launches on the capture stream, its
  workspace from the graph's pool), replayed on new rows written into the
  captured input, against the plain version."""
  x = torch.randn((16384, 256), device=dev, dtype=torch.bfloat16)
  cuda_wc.moments_cuda(x)
  graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  before = cuda_wc.MOMENTS_LAUNCHES
  with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
    mean, cov = cuda_wc.moments_cuda(x)
  torch.cuda.current_stream().wait_stream(side)
  assert cuda_wc.MOMENTS_LAUNCHES == before + 1
  for seed in (1, 2):
    x.copy_(torch.randn(x.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            seed)))
    graph.replay()
    assert _max_err((mean, cov), cuda_wc.moments_reference(x)) <= ATOL


def _jit_states(dev, d_fake_stats="batch", kernel_eval=None):
  from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
  from wcgan_tpu_torch.models.generator import GeneratorConfig
  from wcgan_tpu_torch.train.state import OptimConfig, create_state
  from wcgan_tpu_torch.train.step import GANConfig
  gan = GANConfig(training_ratio=2, z_dim=32, random_flip=True,
                  g_ema_decay=0.9, d_fake_stats=d_fake_stats)
  g_cfg = GeneratorConfig(z_dim=32, filters=(64, 64, 64),
                          kernel_eval=kernel_eval)
  states = [create_state(g_cfg, DiscriminatorConfig(filters=(64,) * 4),
                         OptimConfig(lr_decay_schedule="linear",
                                     total_outer_steps=20), 2, dev, seed=3,
                         g_ema_decay=0.9) for _ in range(2)]
  data = (torch.randint(0, 256, (256, 32, 32, 3), dtype=torch.uint8,
                        device=dev,
                        generator=torch.Generator(device=dev).manual_seed(4)),
          torch.zeros((256,), dtype=torch.int32, device=dev))
  return gan, states, data


def test_captured_chain_matches_the_eager_chain(dev):
  """make_jit_dataset_step (a chain of 3, float32, deterministic kernels)
  against the eager chain from the same state and generator: a warm-up,
  a capture and a replay against three eager chains, every parameter,
  buffer, Adam slot and EMA tensor within 1e-4 of its largest value, the
  generators equal, the host counts and K1's launches (21 a step) counted
  on each replay."""
  from wcgan_tpu_torch.train.state import full_state
  from wcgan_tpu_torch.train.step import (_multi, make_dataset_step,
                                          make_jit_dataset_step)
  gan, (jit_st, ref_st), data = _jit_states(dev)
  jit = make_jit_dataset_step(gan, 16, 3)
  eager = _multi(make_dataset_step(gan, 16), 3)
  torch.use_deterministic_algorithms(True, warn_only=True)
  torch.backends.cudnn.deterministic = True
  try:
    for call in range(3):
      before = cuda_wc.MOMENTS_LAUNCHES
      m_j = jit(jit_st, *data)
      launched = cuda_wc.MOMENTS_LAUNCHES - before
      m_e = eager(ref_st, *data)
      assert launched == 3 * 21, (call, launched)
      assert jit_st.step == ref_st.step == 3 * (call + 1)
      assert jit_st.g_version == ref_st.g_version
      for k in m_e:
        assert abs(float(m_j[k]) - float(m_e[k])) <= 1e-4 * max(
            1.0, abs(float(m_e[k]))), (call, k)
  finally:
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
  assert jit.calls == {"warm-up": 1, "capture": 1, "replay": 1, "eager": 0}
  assert torch.equal(jit_st.generator.get_state(),
                     ref_st.generator.get_state())
  got, want = full_state(jit_st), full_state(ref_st)
  assert got["g_sched"] == want["g_sched"] == {"last_epoch": 9}

  def tensors(st):
    out = {**{f"g.{k}": v for k, v in st.g.state_dict().items()},
           **{f"d.{k}": v for k, v in st.d.state_dict().items()},
           **{f"ema.{k}": v for k, v in st.g_ema.items()}}
    for m in ("g", "d"):
      opt = getattr(st, f"{m}_opt")
      for n, p in getattr(st, m).named_parameters():
        out.update({f"{m}_opt.{n}.{k}": v for k, v in opt.state[p].items()})
    return out

  a, b = tensors(jit_st), tensors(ref_st)
  assert a.keys() == b.keys()
  for k in b:
    scale = max(float(b[k].abs().max()), 1e-30)
    assert float((a[k] - b[k]).abs().max()) <= 1e-4 * scale, k


def test_captured_metrics_are_fresh_each_call(dev):
  from wcgan_tpu_torch.train.step import make_jit_dataset_step
  gan, (st, _), data = _jit_states(dev)
  jit = make_jit_dataset_step(gan, 16, 2)
  outs = [jit(st, *data) for _ in range(4)]
  kept = {k: v.clone() for k, v in outs[2].items()}
  jit(st, *data)
  torch.cuda.synchronize()
  assert jit.last == "replay"
  for k in kept:
    assert len({o[k].data_ptr() for o in outs}) == 4, k
    assert torch.equal(outs[2][k], kept[k]), k


def test_k2_captured_in_a_running_stats_step(dev):
  """d_fake_stats 'running' with kernel_eval: the D phase samples through
  K2 (7 WC layers x 2 D updates) inside the graph, K1 runs in the G
  update (7); a replay counts both. If the cooperative setup could not be
  captured, the capture would raise naming whiten_color_apply."""
  from wcgan_tpu_torch.train.step import make_jit_step
  gan, (st, _), (data, _) = _jit_states(dev, "running", True)
  step = make_jit_step(gan)
  real = data[:32].view(2, 16, 32, 32, 3)
  try:
    step(st, real, None)
    step(st, real, None)
  except RuntimeError as err:
    assert "whiten_color_apply" in str(err), err
    return
  k1, k2 = cuda_wc.MOMENTS_LAUNCHES, cuda_wc.WC_APPLY_LAUNCHES
  metrics = step(st, real, None)
  torch.cuda.synchronize()
  assert step.last == "replay"
  assert (cuda_wc.MOMENTS_LAUNCHES - k1, cuda_wc.WC_APPLY_LAUNCHES - k2) == \
      (7, 14)
  assert all(np.isfinite(float(v)) for v in metrics.values())


def test_trainer_captures_and_restores_on_card(dev, tmp_path):
  """The CLI's trainer runs the compiled chain on the card: a warm-up, a
  capture, replays; a restore invalidates it (the next call warms up, the
  one after captures anew) and Adam's counts stay on the card."""
  tt = _trainer(tmp_path)
  for _ in range(3):
    tt.step_fn(tt.state, *tt._device_data)
  assert tt.step_fn.calls == {"warm-up": 1, "capture": 1, "replay": 1,
                              "eager": 0}
  tt.save_checkpoint(0)
  tt.restore_checkpoint(tt.checkpoint_path(0))
  p = next(tt.state.g.parameters())
  assert tt.state.g_opt.state[p]["step"].is_cuda
  assert tt.state.g_opt.param_groups[0]["lr"] is tt.state.g_sched.lr
  for kind in ("warm-up", "capture", "replay"):
    tt.step_fn(tt.state, *tt._device_data)
    assert tt.step_fn.last == kind


def test_profile_dir_and_debug_nans_on_replays(dev, tmp_path):
  """--profile_dir traces the step calls after the capture (replays: K1's
  kernels are in the trace) and --debug_nans checks each replay's
  metrics; anomaly detection stays on through the capture."""
  import json
  prof = tmp_path / "prof"
  tt = _trainer(tmp_path, "--number_of_epochs", "3", "--batches_per_epoch",
                "4", "--profile_dir", str(prof), "--debug_nans")
  assert tt.cfg.debug_nans
  torch.autograd.set_detect_anomaly(True)
  try:
    tt.train()
  finally:
    torch.autograd.set_detect_anomaly(False)
  assert tt.step_fn.calls == {"warm-up": 1, "capture": 1, "replay": 4,
                              "eager": 0}
  log = (tmp_path / "o" / "lane" / "log.txt").read_text()
  assert "wrote profiler trace" in log and "(3 step calls)" in log
  names = {e.get("name", "") for e in json.loads(
      (prof / "trace.json").read_text())["traceEvents"]}
  assert any("centered_gram_tf32x3" in n for n in names)


# --- the compiled programs of sampling, scoring and the NCCL step ------------


def _deterministic_on():
  torch.use_deterministic_algorithms(True, warn_only=True)
  torch.backends.cudnn.deterministic = True


def _deterministic_off():
  torch.use_deterministic_algorithms(False)
  torch.backends.cudnn.deterministic = False


def _program(tt, kind, rows):
  (program,) = [p for (k, signature), p in tt._programs.items()
                if k == kind and signature[0][0][0] == rows]
  return program


def test_captured_sampling_with_k2_matches_eager(dev, tmp_path):
  """sample and sample_u8 of the EMA G with standing statistics and
  kernel_eval (K2 on its 7 WC layers): a warm-up, a capture, a replay,
  each equal to the eager forward on the same tensors (deterministic
  kernels), K2 7 a forward; after replayed step chains (their G updates
  move g_version alone; the standing statistics are recomputed into the
  tensors the graph reads) a replay still equals the eager forward."""
  from wcgan_tpu_torch.data import get_dataset
  from wcgan_tpu_torch.train.step import make_jit_dataset_step
  from wcgan_tpu_torch.train.trainer import Trainer, TrainerConfig
  gan, (st, _), data = _jit_states(dev, kernel_eval=True)
  ds = get_dataset("synthetic", batch_size=16, seed=0, z_dim=32,
                   synthetic_size=64)
  tt = Trainer(ds, st, gan, TrainerConfig(
      name="lane", output_dir=str(tmp_path), device_data=False,
      ema_standing_batches=2))
  z = torch.randn((32, 32), device=dev,
                  generator=torch.Generator(device=dev).manual_seed(1))
  _deterministic_on()
  try:
    for kind in ("warm-up", "capture", "replay"):
      k2 = cuda_wc.WC_APPLY_LAUNCHES
      img, u8 = tt.sample(z), tt.sample_u8(z)
      torch.cuda.synchronize()
      assert _program(tt, "sample", 32).last == kind
      assert cuda_wc.WC_APPLY_LAUNCHES - k2 == 2 * 7, kind
      assert torch.equal(img, tt.sample_eager(z)), kind
      assert torch.equal(u8, tt.sample_eager(z, u8=True)), kind
    step = make_jit_dataset_step(gan, 16, 2)
    for _ in range(3):
      step(st, *data)
    assert step.last == "replay"
    again = tt.sample(z)
    assert tt._standing_cache[0][0] == st.g_version == 6
    assert _program(tt, "sample", 32).last == "replay"
    assert torch.equal(again, tt.sample_eager(z))
    assert not torch.equal(again, img)
  finally:
    _deterministic_off()


def test_captured_standing_pass_matches_eager(dev, tmp_path):
  """The standing pass as a graph (3 batches: a warm-up, a capture with
  its replay, a replay; K1 7 each) against the same train-mode forwards
  run eagerly (deterministic kernels)."""
  from torch.func import functional_call
  from wcgan_tpu_torch.models import layers as L
  tt = _trainer(tmp_path)
  _deterministic_on()
  try:
    k1 = cuda_wc.MOMENTS_LAUNCHES
    got = tt.standing_g_state(tt.state.g_ema, 3, rng_seed=5)
    torch.cuda.synchronize()
    assert cuda_wc.MOMENTS_LAUNCHES - k1 == 7 * 3
    assert _program(tt, "standing_pass", 16).calls == {
        "warm-up": 1, "capture": 1, "replay": 1, "eager": 0}
    rng = np.random.default_rng(5)
    acc = {}
    with torch.no_grad(), L.capture_batch_moments(tt.state.g) as moments:
      for _ in range(3):
        functional_call(tt.state.g, tt.state.g_ema, tt._draw(rng, 16),
                        {"train": True, "update_stats": False})
        acc = {k: acc[k] + v if k in acc else v for k, v in moments.items()}
  finally:
    _deterministic_off()
  for k, v in acc.items():
    assert torch.equal(got[k], v * (1.0 / 3)), k


def test_captured_inception_forward_matches_eager(dev):
  """The scorer's InceptionV3 forward as a graph at batch 100 (true
  float32): a warm-up, a capture, a replay on new images, each against
  the eager network on the same images within 1e-5 of each output's
  largest value."""
  import types
  from wcgan_tpu_torch.evaluation import inception_v3, metrics
  from wcgan_tpu_torch.evaluation import scorer as t_scorer
  seen = []

  class Stop(Exception):
    pass

  real = t_scorer._activations

  def spy(apply_fn, *args, **kw):
    seen.append(apply_fn)
    raise Stop

  t_scorer._activations = spy
  try:
    try:
      t_scorer.make_scorer(None, compute_fid=False, samples_inception=100,
                           conv_tf32=False)(
          types.SimpleNamespace(device=dev, generate=lambda n: None))
    except Stop:
      pass
  finally:
    t_scorer._activations = real
  (apply_fn,) = seen
  net = inception_v3.init_params().to(dev).eval()
  gen = torch.Generator(device=dev).manual_seed(0)
  for _ in range(3):
    x = torch.randint(0, 256, (100, 32, 32, 3), dtype=torch.uint8,
                      device=dev, generator=gen)
    got = apply_fn(x)
    with torch.no_grad(), metrics.true_float32():
      pool, logits = net(inception_v3.preprocess(x))
    want = (pool, torch.softmax(logits.float(), dim=-1))
    for g, w in zip(got, want):
      assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_scorer_default_runs_tf32_convolutions(dev):
  """The scorer's default forward (TF32 convolutions, products true
  float32) as a graph against the eager network under the same switches,
  within 1e-5 of each output's largest value, and off the true-float32
  forward by more than that: the switch reaches cuDNN."""
  import types
  from wcgan_tpu_torch.evaluation import inception_v3, metrics
  from wcgan_tpu_torch.evaluation import scorer as t_scorer
  seen = []

  class Stop(Exception):
    pass

  real = t_scorer._activations

  def spy(apply_fn, *args, **kw):
    seen.append(apply_fn)
    raise Stop

  t_scorer._activations = spy
  try:
    try:
      t_scorer.make_scorer(None, compute_fid=False, samples_inception=100)(
          types.SimpleNamespace(device=dev, generate=lambda n: None))
    except Stop:
      pass
  finally:
    t_scorer._activations = real
  (apply_fn,) = seen
  net = inception_v3.init_params().to(dev).eval()
  gen = torch.Generator(device=dev).manual_seed(0)
  for _ in range(3):
    x = torch.randint(0, 256, (100, 32, 32, 3), dtype=torch.uint8,
                      device=dev, generator=gen)
    got = apply_fn(x)
    with torch.no_grad(), metrics.true_float32():
      pool32, _ = net(inception_v3.preprocess(x))
      torch.backends.cudnn.allow_tf32 = True
      pool, logits = net(inception_v3.preprocess(x))
    want = (pool, torch.softmax(logits.float(), dim=-1))
    for g, w in zip(got, want):
      assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
    assert float((got[0] - pool32).abs().max()) > 1e-5 * float(
        pool32.abs().max())
  assert torch.backends.cudnn.allow_tf32 is False


def test_one_rank_nccl_captured_chain_matches_eager(dev):
  """make_jit_dataset_step with a one-rank NCCL group (a chain of 2, float32,
  deterministic kernels): a warm-up, a capture and a replay against the
  eager chain, its all-reduces inside the graph and counted on each
  replay as the eager chain counts them."""
  from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
  from wcgan_tpu_torch.models.generator import GeneratorConfig
  from wcgan_tpu_torch.parallel import launch
  from wcgan_tpu_torch.train.step import GANConfig
  gan = GANConfig(training_ratio=2, z_dim=32, random_flip=True)
  g_cfg = GeneratorConfig(z_dim=32, filters=(64, 64, 64))
  d_cfg = DiscriminatorConfig(filters=(64,) * 4)
  (r,) = launch.launch(
      "wcgan_tpu_torch.parallel.dryrun:batch_rank", ["cuda:0"], ([
          ("deterministic_rank", ()),
          ("jit_dp_rank", (g_cfg, d_cfg, gan, 16, 2, 3,
                           {"resolution": 32, "classes": 10, "n": 256,
                            "seed": 0}))],), timeout=300)[0][1:]
  assert r["jit_calls"] == {"warm-up": 1, "capture": 1, "replay": 1,
                            "eager": 0}
  assert r["rel"] <= 1e-4, (r["rel"], r["where"])
  assert r["same_generator"] and r["steps"] == [6, 6]
  for call in r["per_call"]:
    assert call["jit"]["calls"] == call["eager"]["calls"]
    assert call["jit"]["bytes"] == call["eager"]["bytes"]
    assert call["jit"]["k1"] == call["eager"]["k1"] == 2 * 21
    assert call["jit"]["calls"]["grads"] == 2 * 3


def test_gloo_group_on_cuda_is_refused(dev, tmp_path):
  """A gloo group's collectives run on the host: the compiled step refuses
  it on the card, naming gloo."""
  import torch.distributed as dist
  from wcgan_tpu_torch.train.step import make_jit_step
  gan, (st, _), (data, _) = _jit_states(dev)
  dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                          rank=0, world_size=1)
  try:
    step = make_jit_step(gan, dist.group.WORLD)
    with pytest.raises(ValueError, match="gloo's collectives run on the "
                       "host"):
      step(st, data[:32].view(2, 16, 32, 32, 3), None)
  finally:
    dist.destroy_process_group()


# --- K3 (mm_bf16x3) and --whitening_precision high --------------------------

K3_ULPS = 16   # K3 against its plain version: the same exact bf16 products
               # summed in float32 in another order, within a few float32
               # ulps of (|A| |B|)_ij


def _k3_operands(m, k, n, layout, dev):
  gen = torch.Generator(device=dev).manual_seed(m + 7 * k + 13 * n)
  a = torch.randn((m, k) if layout[0] == "n" else (k, m), generator=gen,
                  device=dev)
  b = torch.randn((k, n) if layout[1] == "n" else (n, k), generator=gen,
                  device=dev)
  return (a if layout[0] == "n" else a.T), (b if layout[1] == "n" else b.T)


@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (256, 256, 256),
                                   (512, 512, 512), (16384, 256, 256),
                                   (1000, 130, 17), (1, 256, 256),
                                   (256, 65536, 256)])
@pytest.mark.parametrize("layout", ["nn", "nt", "tn"])
def test_k3_matches_plain(m, k, n, layout, dev):
  """K3 against its plain version at the path's shapes (C x C x C, R x C x
  C, the plain covariance's C x R x C), ragged ones and a vector, in three
  layouts, within K3_ULPS float32 ulps of (|A| |B|)_ij; bitwise repeatable;
  further from float64 than a float32 product."""
  from wcgan_tpu_torch.ops import mm_bf16x3
  a, b = _k3_operands(m, k, n, layout, dev)
  before = mm_bf16x3.MM_BF16X3_LAUNCHES
  got = mm_bf16x3.mm_bf16x3(a, b)
  again = mm_bf16x3.mm_bf16x3_cuda(a, b)
  assert mm_bf16x3.MM_BF16X3_LAUNCHES == before + 2
  want = mm_bf16x3.mm_bf16x3_reference(a, b).double()
  if k >= 65536:
    # There the plain version's own float32 sums drift: the float64 sum of
    # the same pieces instead, as K1 is held at such R.
    (a_hi, a_lo), (b_hi, b_lo) = (
        [p.double() for p in mm_bf16x3.split_bf16(t)] for t in (a, b))
    want = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
  gate = K3_ULPS * 2.0 ** -23 * (a.abs() @ b.abs())
  assert torch.equal(got, again)
  assert bool(((got.double() - want).abs() <= gate).all())
  exact = a.double() @ b.double()
  assert float((got.double() - exact).abs().max()) > float(
      ((a @ b).double() - exact).abs().max())


@pytest.mark.parametrize("offset", [1, 4])
def test_k3_offset_views(offset, dev):
  """Operands whose rows start off a 16-byte boundary (offset 1: K3 copies
  element by element) or on one with a padded leading dimension (offset
  4: 16-byte copies), as given and transposed, against the plain
  version."""
  from wcgan_tpu_torch.ops import mm_bf16x3
  gen = torch.Generator(device=dev).manual_seed(offset)
  base_a = torch.randn((300, 256 + offset), device=dev, generator=gen)
  base_b = torch.randn((256, 200 + offset), device=dev, generator=gen)
  a, b = base_a[:, offset:], base_b[:, offset:]
  for x, y in ((a, b), (a.T[:, :100], b[:100])):
    got = mm_bf16x3.mm_bf16x3_cuda(x, y)
    gate = K3_ULPS * 2.0 ** -23 * (x.abs() @ y.abs())
    assert bool(((got - mm_bf16x3.mm_bf16x3_reference(x, y)).abs()
                 <= gate).all())


def test_k3_gradients_and_non_finite_inputs(dev):
  """The autograd function on the card: dA = dC B^T and dB = A^T dC, each
  K3; a double backward that runs; inf and NaN inputs give non-finite
  outputs where the float32 product does."""
  from wcgan_tpu_torch.ops import mm_bf16x3
  a, b = _k3_operands(300, 256, 200, "nn", dev)
  probe = torch.randn((300, 200), device=dev)
  xa, xb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
  (ga,) = torch.autograd.grad((mm_bf16x3.mm_bf16x3(xa, xb) * probe).sum(),
                              xa, create_graph=True)
  assert torch.equal(ga, mm_bf16x3.mm_bf16x3_cuda(probe, b.T))
  (mm_bf16x3.mm_bf16x3(ga, ga.T) ** 2).sum().backward()
  assert bool(torch.isfinite(xb.grad).all())
  a[3, 5], a[7, 1], b[9, 2] = float("inf"), float("nan"), float("-inf")
  assert torch.equal(torch.isfinite(mm_bf16x3.mm_bf16x3_cuda(a, b)),
                     torch.isfinite(a @ b))
  with pytest.raises(TypeError, match="float32"):
    mm_bf16x3.mm_bf16x3_cuda(a.bfloat16(), b)
  with pytest.raises(ValueError, match="one CUDA device"):
    mm_bf16x3.mm_bf16x3_cuda(a, b.cpu())


def test_high_step_captures_and_replays_through_k3(dev):
  """A captured outer step under 'high': K3 launched in every replay (45
  Newton-Schulz products a WC layer forward, with the G update's
  backward), finite metrics within 1e-3 (relative, at least 1.0) of the
  'highest' step from the same state; changing the precision warms up
  and captures anew."""
  from wcgan_tpu_torch.ops import mm_bf16x3, whiten
  from wcgan_tpu_torch.train.step import make_jit_step
  gan, (st_high, st_ref), (data, _) = _jit_states(dev)
  real = data[:32].view(2, 16, 32, 32, 3)
  metrics = {}
  try:
    for precision, st in (("high", st_high), ("highest", st_ref)):
      whiten.set_precision(precision)
      step = make_jit_step(gan)
      first = step(st, real, None)
      metrics[precision] = {k: float(v) for k, v in first.items()}
      step(st, real, None)
      mm_bf16x3.MM_BF16X3_LAUNCHES = 0
      step(st, real, None)
      torch.cuda.synchronize()
      assert step.last == "replay"
      launched = mm_bf16x3.MM_BF16X3_LAUNCHES
      assert (launched > 3 * 45) == (precision == "high"), launched
    whiten.set_precision("high")
    step(st_ref, real, None)
    assert step.last == "warm-up"
  finally:
    whiten.set_precision("highest")
  for k, v in metrics["highest"].items():
    assert abs(metrics["high"][k] - v) <= 1e-3 * max(1.0, abs(v)), k


# The path's shapes (chip_smoke.py's HIGH_CC and HIGH_RC): C x C x C takes
# the split-K path (a cluster of CTAs over K), R x 256 x 256 from 16,384
# rows the row path (wgmma on a TMA ring).
K3_PATH_SHAPES = [(c, c, c) for c in (64, 128, 256, 512)] + [
    (r, 256, 256) for r in (1024, 16384, 131072)]


@pytest.mark.parametrize("m,k,n", K3_PATH_SHAPES)
@pytest.mark.parametrize("layout", ["nn", "nt", "tn"])
def test_k3_paths(m, k, n, layout, dev):
  """Each path at the path's shapes and in three layouts: the path the
  shape picks, within K3_ULPS of the plain version, two calls bitwise
  equal."""
  from wcgan_tpu_torch.ops import mm_bf16x3
  a, b = _k3_operands(m, k, n, layout, dev)
  path, _, split = mm_bf16x3.plan(a, b)
  assert path == ("rows" if m >= 16384 else "split-k")
  if m == k == n:  # K split over a cluster only where a CTA walks > 8 tiles
    assert split == (2 if m == 512 else 1)
  got = mm_bf16x3.mm_bf16x3_cuda(a, b)
  again = mm_bf16x3.mm_bf16x3_cuda(a, b)
  gate = K3_ULPS * 2.0 ** -23 * (a.abs() @ b.abs())
  assert torch.equal(got, again)
  assert bool(((got - mm_bf16x3.mm_bf16x3_reference(a, b)).abs()
               <= gate).all())


@pytest.mark.parametrize("m,k,n", K3_PATH_SHAPES[:4] + K3_PATH_SHAPES[5:6])
def test_k3_epilogue_is_the_unfused_one_bitwise(m, k, n, dev):
  """alpha op(A) op(B) + beta I on both paths, bitwise equal to K3's
  product followed by the torch epilogue (alpha, beta powers of two or
  sums of them, as Newton-Schulz's -0.5 and 1.5), and the plain
  version's fused form within K3_ULPS."""
  from wcgan_tpu_torch.ops import mm_bf16x3
  a, b = _k3_operands(m, k, n, "nn", dev)
  eye = torch.eye(m, n, device=dev)
  p = mm_bf16x3.mm_bf16x3_cuda(a, b)
  for alpha, beta in ((-0.5, 1.5), (0.25, 0.0), (1.0, -2.0)):
    got = mm_bf16x3.mm_bf16x3_cuda(a, b, alpha, beta)
    assert torch.equal(got, alpha * p + beta * eye)
    gate = K3_ULPS * 2.0 ** -23 * abs(alpha) * (a.abs() @ b.abs())
    plain = mm_bf16x3.mm_bf16x3_reference(a, b, alpha, beta)
    assert bool(((got - plain).abs() <= gate).all())


def test_k3_tall_offset_view_takes_split_k(dev):
  """A tall operand whose rows are off a 16-byte boundary cannot be read
  by TMA: the split-K path takes it, within K3_ULPS of the plain
  version."""
  from wcgan_tpu_torch.ops import mm_bf16x3
  gen = torch.Generator(device=dev).manual_seed(9)
  base = torch.randn((16384, 257), device=dev, generator=gen)
  a, b = base[:, 1:], torch.randn((256, 256), device=dev, generator=gen)
  assert mm_bf16x3.plan(a, b)[0] == "split-k"
  assert mm_bf16x3.plan(a.contiguous(), b)[0] == "rows"
  got = mm_bf16x3.mm_bf16x3_cuda(a, b)
  gate = K3_ULPS * 2.0 ** -23 * (a.abs() @ b.abs())
  assert bool(((got - mm_bf16x3.mm_bf16x3_reference(a, b)).abs()
               <= gate).all())


def _ns_operand(c, kind, dev):
  """The jittered, normalized A of a fresh batch covariance or of one
  conditioned at 1e3."""
  from wcgan_tpu_torch.ops import whiten
  gen = torch.Generator(device=dev).manual_seed(c + (kind == "cond"))
  if kind == "fresh":
    x = torch.randn((4 * c, c), generator=gen, device=dev)
    x = x - x.mean(dim=0)
    cov = x.T @ x / x.shape[0]
  else:
    q, _ = torch.linalg.qr(torch.randn((c, c), generator=gen, device=dev,
                                       dtype=torch.float64))
    cov = ((q * torch.logspace(0, -3, c, device=dev,
                               dtype=torch.float64)) @ q.T).float()
  return whiten._jittered_normalized(cov, 1e-5)[0]


def _ns_chain(a, iters=15, mm=None):
  """Z of the chain of K3 launches ``_ns_iterate`` runs under 'high', or
  with ``mm`` as every product."""
  from wcgan_tpu_torch.ops import whiten
  with whiten.precision("high"), torch.no_grad():
    return whiten._ns_iterate(a, torch.eye(a.shape[0], device=a.device),
                              iters, mm=mm)[1]


# chip_smoke.py's HIGH_NS_PLAIN: the fused Z's largest distance from its
# plain version, max|Z - Z_plain| / max|Z_plain| after 15 iterations
# (measured on an H100: at most 2.4e-5 fresh, 1.9e-4 at 1e3; without the
# a_lo b_hi term at least 1.0e-2 and 0.11).
NS_PLAIN_GAP = {"fresh": 2e-4, "cond": 1e-3}


def _mm_two_terms(a, b):
  """bf16x3 without its a_lo b_hi term (a planted fault)."""
  from wcgan_tpu_torch.ops import mm_bf16x3
  (a_hi, _), (b_hi, b_lo) = ([p.float() for p in mm_bf16x3.split_bf16(t)]
                             for t in (a, b))
  return a_hi @ b_lo + a_hi @ b_hi


@pytest.mark.parametrize("c", [64, 128, 256])
@pytest.mark.parametrize("kind", ["fresh", "cond"])
def test_k3_fused_ns_is_the_chain_bitwise(c, kind, dev):
  """The whole Newton-Schulz iteration in one K3 launch (mm_bf16x3_ns):
  Z bit-equal to the chain of 44 K3 launches, and within NS_PLAIN_GAP of
  its plain version (``_ns_iterate`` with ``mm_bf16x3_reference``), where
  a bf16x3 without one of its terms is not; counted once by each counter;
  two calls bitwise equal."""
  from wcgan_tpu_torch.ops import mm_bf16x3
  a = _ns_operand(c, kind, dev)
  want = _ns_chain(a)
  before = (mm_bf16x3.MM_BF16X3_LAUNCHES, mm_bf16x3.MM_BF16X3_NS_LAUNCHES)
  got = mm_bf16x3.mm_bf16x3_ns_cuda(a, 15)
  assert (mm_bf16x3.MM_BF16X3_LAUNCHES,
          mm_bf16x3.MM_BF16X3_NS_LAUNCHES) == (before[0] + 1, before[1] + 1)
  assert torch.equal(got, want)
  assert torch.equal(mm_bf16x3.mm_bf16x3_ns_cuda(a, 15), got)
  plain = _ns_chain(a, mm=mm_bf16x3.mm_bf16x3_reference).double()

  def gap(z):
    return float((z.double() - plain).abs().max() / plain.abs().max())

  fault = gap(_ns_chain(a, mm=_mm_two_terms))
  assert gap(got) <= NS_PLAIN_GAP[kind] < fault, (gap(got), fault)
  for iters in (1, 2):
    assert torch.equal(mm_bf16x3.mm_bf16x3_ns_cuda(a, iters),
                       _ns_chain(a, iters))


def test_k3_fused_ns_in_a_captured_graph(dev):
  """The fused launch captured in a CUDA graph (a cooperative launch):
  each replay gives the chain's Z of what its input holds then."""
  from wcgan_tpu_torch.ops import mm_bf16x3
  static = _ns_operand(256, "fresh", dev).clone()
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    mm_bf16x3.mm_bf16x3_ns_cuda(static, 15)
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    out = mm_bf16x3.mm_bf16x3_ns_cuda(static, 15)
  for kind in ("fresh", "cond"):
    static.copy_(_ns_operand(256, kind, dev))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, _ns_chain(static)), kind


def test_whitening_takes_one_fused_launch_without_grad(dev):
  """``newton_schulz_inv_sqrt`` under 'high' at C = 256: without a
  gradient one K3 kernel on the device (mm_bf16x3_ns) and one count on
  each counter; with one, the chain (45 launches, no fused one); W
  bitwise equal."""
  from torch.profiler import ProfilerActivity, profile
  from wcgan_tpu_torch.ops import mm_bf16x3, whiten
  gen = torch.Generator(device=dev).manual_seed(5)
  x = torch.randn((1024, 256), generator=gen, device=dev)
  cov = (x.T @ x / 1024).requires_grad_(True)
  with whiten.precision("high"):
    before = (mm_bf16x3.MM_BF16X3_LAUNCHES, mm_bf16x3.MM_BF16X3_NS_LAUNCHES)
    w_chain = whiten.newton_schulz_inv_sqrt(cov)
    assert w_chain.requires_grad
    assert (mm_bf16x3.MM_BF16X3_LAUNCHES - before[0],
            mm_bf16x3.MM_BF16X3_NS_LAUNCHES - before[1]) == (45, 0)
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
      before = (mm_bf16x3.MM_BF16X3_LAUNCHES,
                mm_bf16x3.MM_BF16X3_NS_LAUNCHES)
      w_fused = whiten.newton_schulz_inv_sqrt(cov)
      launched = (mm_bf16x3.MM_BF16X3_LAUNCHES - before[0],
                  mm_bf16x3.MM_BF16X3_NS_LAUNCHES - before[1])
      torch.cuda.synchronize()
  assert launched == (1, 1)
  k3_kernels = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "mm_bf16x3" in e.name]
  assert len(k3_kernels) == 1 and "mm_bf16x3_ns" in k3_kernels[0], k3_kernels
  assert torch.equal(w_fused, w_chain.detach())


def test_high_captured_chain_is_bit_equal_to_eager(dev):
  """make_jit_dataset_step under 'high' (a chain of 3, float32,
  deterministic kernels) against the eager chain from the same state:
  every parameter, buffer, Adam slot, EMA tensor and metric bitwise equal
  after a warm-up, a capture and a replay; K3 launched in each replay, and
  the fakes' whitenings (no gradient) through the fused launch in both
  chains alike."""
  from wcgan_tpu_torch.ops import mm_bf16x3, whiten
  from wcgan_tpu_torch.train.step import (_multi, make_dataset_step,
                                          make_jit_dataset_step)
  gan, (jit_st, ref_st), data = _jit_states(dev)
  torch.use_deterministic_algorithms(True, warn_only=True)
  torch.backends.cudnn.deterministic = True
  try:
    with whiten.precision("high"):
      jit = make_jit_dataset_step(gan, 16, 3)
      eager = _multi(make_dataset_step(gan, 16), 3)
      for call in range(3):
        before = mm_bf16x3.MM_BF16X3_LAUNCHES
        fused = mm_bf16x3.MM_BF16X3_NS_LAUNCHES
        m_j = jit(jit_st, *data)
        launched = mm_bf16x3.MM_BF16X3_LAUNCHES - before
        fused_j = mm_bf16x3.MM_BF16X3_NS_LAUNCHES - fused
        fused = mm_bf16x3.MM_BF16X3_NS_LAUNCHES
        m_e = eager(ref_st, *data)
        fused_e = mm_bf16x3.MM_BF16X3_NS_LAUNCHES - fused
        assert launched > 3 * 45, (call, launched)
        # The fakes' whitenings take the fused launch in both chains.
        assert fused_j == fused_e > 0, (call, fused_j, fused_e)
        for k in m_e:
          assert torch.equal(m_j[k], m_e[k]), (call, k)
  finally:
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
  assert jit.calls == {"warm-up": 1, "capture": 1, "replay": 1, "eager": 0}
  for st_j, st_e in ((jit_st.g, ref_st.g), (jit_st.d, ref_st.d)):
    for (k, v), (_, w) in zip(st_j.state_dict().items(),
                              st_e.state_dict().items()):
      assert torch.equal(v, w), k
  for k, v in ref_st.g_ema.items():
    assert torch.equal(jit_st.g_ema[k], v), k


# --- the program's spans in its graphs (wcgan_tpu_torch/trace.py) ----------


def _no_spans(monkeypatch):
  """Every span and the WC block's backward markers off; the capture
  still keeps its graph's span map."""
  import contextlib
  from wcgan_tpu_torch import trace
  monkeypatch.setattr(trace, "span", lambda name: contextlib.nullcontext())
  monkeypatch.setattr(trace, "backward_span",
                      lambda name, fn, x, *a, **kw: fn(x, *a, **kw))


def test_span_map_lines_up_with_profiled_replays(dev, monkeypatch):
  """A captured chain of 3 under 'high': the benchmark's traced slice of
  two calls holds two whole replays of the span map's nodes, one event a
  node, in order; the spans add no node (the same chain captured with
  every span off has the same nodes); every K1 and K3 kernel lies in a
  ``wc.*`` span; the step's spans hold every node but the chain's means,
  and their device time is within 2 % of the replay's."""
  from wcbench.core import trace as slice_trace
  from wcbench.work import kernels
  from wcgan_tpu_torch import trace
  from wcgan_tpu_torch.ops import whiten
  from wcgan_tpu_torch.train.step import make_jit_dataset_step
  gan, (st, st_plain), data = _jit_states(dev)
  with whiten.precision("high"):
    jit = make_jit_dataset_step(gan, 16, 3)
    for _ in range(2):
      jit(st, *data)
    span_map = trace.maps()["make_jit_dataset_step"]
    s = slice_trace.profile(lambda: jit(st, *data), 2, dev)
    with monkeypatch.context() as m:
      _no_spans(m)
      plain = make_jit_dataset_step(gan, 16, 3)
      for _ in range(2):
        plain(st_plain, *data)
  assert trace.maps()["make_jit_dataset_step"].names == span_map.names
  events = sorted(s.kernels, key=lambda k: (k[1], k[2]))
  blocks = trace.replays(span_map, events)
  assert len(blocks) == 2
  assert 0 <= len(events) - 2 * span_map.nodes <= 2 * 16
  got = [trace.attribute(span_map, b) for b in blocks]
  assert all(g is not None for g in got)
  steps = ("step.draws", "step.fakes", "step.d_pass", "step.d_adam",
           "step.g_pass", "step.g_adam")
  assert {n: len(span_map.spans[n]) for n in steps} == {
      "step.draws": 6, "step.fakes": 6, "step.d_pass": 6,
      "step.d_adam": 6, "step.g_pass": 3, "step.g_adam": 3}
  wc = {i for n in ("wc.forward", "wc.backward")
        for lo, hi in span_map.spans[n] for i in range(lo, hi)}
  named = [i for i, n in enumerate(span_map.names)
           if kernels.is_k1(blocks[0][i][0]) or kernels.is_k3(blocks[0][i][0])]
  assert named and set(named) <= wc
  in_steps = {i for n in steps for lo, hi in span_map.spans[n]
              for i in range(lo, hi)}
  assert span_map.nodes - len(in_steps) <= 3 * 8 + 8
  for g, b in zip(got, blocks):
    busy = slice_trace.Slice(1, 0.0, list(b), [], b[0][1],
                             max(e for _, _, e in b)).busy_s() * 1e6
    spanned = sum(g[n]["busy_us"] for n in steps)
    assert abs(spanned - busy) <= 0.02 * busy, (spanned, busy)


def test_sampling_span_map_lines_up_with_profiled_replays(dev, tmp_path):
  """``Trainer.sample_u8``'s graph: the benchmark's traced slice of three
  batches (each copied to the host) holds three whole replays of its span
  map; the WC layers' forwards are spans of it."""
  from wcbench.core import trace as slice_trace
  from wcgan_tpu_torch import trace
  from wcgan_tpu_torch.data import get_dataset
  from wcgan_tpu_torch.train.trainer import Trainer, TrainerConfig
  gan, (st, _), _ = _jit_states(dev)
  ds = get_dataset("synthetic", batch_size=16, seed=0, z_dim=32,
                   synthetic_size=64)
  tt = Trainer(ds, st, gan, TrainerConfig(
      name="lane", output_dir=str(tmp_path), device_data=False,
      ema_standing_batches=0))
  z = torch.randn((32, 32), device=dev)
  for _ in range(2):
    tt.sample_u8(z)
  span_map = trace.maps()["Trainer.sample_u8"]
  s = slice_trace.profile(lambda: tt.sample_u8(z).cpu(), 3, dev)
  blocks = trace.replays(span_map,
                         sorted(s.kernels, key=lambda k: (k[1], k[2])))
  assert len(blocks) == 3
  got = trace.attribute(span_map, blocks[0])
  assert got["wc.forward"]["nodes"] > 0 and "wc.backward" not in got


# --- K4: D's 2x2 average pool -------------------------------------------

# Every pool of the configurations' D at batch 128 (a D update's real and
# fake images, the G update's fakes): tinyin64_cwcsa's and in64_cwcsa_dp4's
# (the optimized block's 3-channel image, then C = 64 at 64x64 to C = 512
# at 8x8) and cifar10_wcres_high's (C = 3 and 128 at 32x32, 128 at 16x16);
# then channels that are not 16-byte rows and small odd widths.
K4_SHAPES = [(128, 3, 64, 64), (128, 64, 64, 64), (128, 128, 32, 32),
             (128, 256, 16, 16), (128, 512, 8, 8), (128, 3, 32, 32),
             (128, 128, 16, 16), (3, 12, 6, 10), (2, 1, 2, 2),
             (5, 20, 4, 14)]


def _k4_input(shape, dtype, dev, seed):
  """Channels_last values with exact zeros of both signs and ties of the
  output's rounding among them."""
  gen = torch.Generator(device=dev).manual_seed(seed)
  x = torch.randn(shape, generator=gen, device=dev) * 3
  x[0, :, :2, :2] = -0.0
  x[-1, :, :2, :2] = 0.0
  x[:, :, 2:4, :2] = 2.0 ** -7 * torch.randint(
      -512, 512, x[:, :, 2:4, :2].shape, generator=gen, device=dev)
  return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _bits(t):
  return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _bits_equal(k4, aten):
  """K4's channels_last result has ATen's bits, element for element."""
  return k4.is_contiguous(memory_format=torch.channels_last) and torch.equal(
      _bits(k4), _bits(aten))


@pytest.mark.parametrize("shape", K4_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_is_atens_pool_bitwise(shape, dtype, dev):
  """K4's forward and backward, one launch each, bit for bit ATen's
  avg_pool2d and its backward, output channels_last."""
  from wcgan_tpu_torch.ops import pool
  x = _k4_input(shape, dtype, dev, sum(shape)).requires_grad_(True)
  n, c, h, w = shape
  g = _k4_input((n, c, h // 2, w // 2), dtype, dev, 1)
  before = pool.AVG_POOL2X2_LAUNCHES, pool.AVG_POOL2X2_COPIES
  y = pool.avg_pool2x2(x)
  dx, = torch.autograd.grad(y, x, g)
  torch.cuda.synchronize()
  assert pool.AVG_POOL2X2_LAUNCHES == before[0] + 2
  assert pool.AVG_POOL2X2_COPIES == before[1]
  y_a = F.avg_pool2d(x, 2)
  dx_a, = torch.autograd.grad(y_a, x, g)
  assert _bits_equal(y, y_a) and _bits_equal(dx, dx_a)


@pytest.mark.parametrize("shape", [(128, 64, 64, 64), (128, 3, 64, 64),
                                   (8, 512, 8, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_double_backward_is_atens(shape, dtype, dev):
  """The gradient of K4's backward (WGAN-GP's penalty) is K4's forward of
  the incoming gradient: bit for bit ATen's double backward through
  ``torch.autograd.grad(..., create_graph=True)``, one launch each, and a
  gradient that is not channels_last copied once first."""
  from wcgan_tpu_torch.ops import pool
  x = _k4_input(shape, dtype, dev, 2)
  n, c, h, w = shape
  out = []
  for fn in (pool.avg_pool2x2, lambda t: F.avg_pool2d(t, 2)):
    xs = x.clone().requires_grad_(True)
    g = _k4_input((n, c, h // 2, w // 2), dtype, dev, 3).requires_grad_(True)
    dx, = torch.autograd.grad(fn(xs), xs, g, create_graph=True)
    wt = _k4_input(shape, dtype, dev, 4)
    before = pool.AVG_POOL2X2_LAUNCHES, pool.AVG_POOL2X2_COPIES
    gg, = torch.autograd.grad(dx, g, wt, retain_graph=True)
    gg_nchw, = torch.autograd.grad(dx, g, wt.contiguous())
    torch.cuda.synchronize()
    out.append((dx, gg, gg_nchw, pool.AVG_POOL2X2_LAUNCHES - before[0],
                pool.AVG_POOL2X2_COPIES - before[1]))
  (dx, gg, gg_nchw, launched, copied), (dx_a, gg_a, gg_nchw_a, _, _) = out
  assert _bits_equal(dx, dx_a) and _bits_equal(gg, gg_a)
  assert _bits_equal(gg_nchw, gg_nchw_a)
  assert launched == 2 and copied == 1


def test_k4_inside_a_captured_graph(dev):
  """K4's two kernels captured in a CUDA graph: each replay pools what
  the static input holds then, bit for bit ATen's."""
  from wcgan_tpu_torch.ops import pool
  shape, dtype = (128, 128, 32, 32), torch.bfloat16
  x = _k4_input(shape, dtype, dev, 5)
  g = _k4_input((128, 128, 16, 16), dtype, dev, 6)
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    pool.AvgPool2x2Fn.apply(x)
    pool.AvgPool2x2BackwardFn.apply(g)
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  before = pool.AVG_POOL2X2_LAUNCHES
  with torch.cuda.graph(graph):
    y = pool.AvgPool2x2Fn.apply(x)
    dx = pool.AvgPool2x2BackwardFn.apply(g)
  assert pool.AVG_POOL2X2_LAUNCHES == before + 2
  for seed in (7, 8):
    x.copy_(_k4_input(shape, dtype, dev, seed))
    g.copy_(_k4_input((128, 128, 16, 16), dtype, dev, seed + 10))
    graph.replay()
    torch.cuda.synchronize()
    xr = x.clone().requires_grad_(True)
    y_a = F.avg_pool2d(xr, 2)
    dx_a, = torch.autograd.grad(y_a, xr, g)
    assert _bits_equal(y, y_a) and _bits_equal(dx, dx_a), seed


def test_k4_refuses_what_it_does_not_take(dev):
  from wcgan_tpu_torch.ops import pool
  x = torch.randn((2, 8, 8, 8), device=dev)
  with pytest.raises(ValueError, match="channels_last"):
    pool.avg_pool2x2(x)
  cl = x.contiguous(memory_format=torch.channels_last)
  with pytest.raises(TypeError, match="float32 or bfloat16"):
    pool.avg_pool2x2(cl.half())
  with pytest.raises(ValueError, match="even"):
    pool.avg_pool2x2(torch.randn((2, 8, 7, 8), device=dev).contiguous(
        memory_format=torch.channels_last))


def test_k4_on_d_passes_counts_and_never_copies(dev):
  """A compiled chain of 3 outer steps (D 64x4, 32x32, ratio 2): each
  step launches K4 22 times (a D forward pools 4 times; 2 D updates of 4
  forwards and 3 backwards, the real and detached fake images taking no
  gradient; the G update 4 and 4), in the warm-up, the capture and the
  replay alike, and no gradient reaches K4's backward in another layout."""
  from wcgan_tpu_torch.ops import pool
  from wcgan_tpu_torch.train.step import make_jit_dataset_step
  gan, (st, _), data = _jit_states(dev)
  jit = make_jit_dataset_step(gan, 16, 3)
  for _ in range(3):
    before = pool.AVG_POOL2X2_LAUNCHES, pool.AVG_POOL2X2_COPIES
    jit(st, *data)
    torch.cuda.synchronize()
    assert pool.AVG_POOL2X2_LAUNCHES - before[0] == 3 * 22, jit.last
    assert pool.AVG_POOL2X2_COPIES == before[1], jit.last
  assert jit.calls == {"warm-up": 1, "capture": 1, "replay": 1, "eager": 0}
