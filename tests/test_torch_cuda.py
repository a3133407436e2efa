"""K1 and K2 on a CUDA card (marker ``cuda``; skipped without one).

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
fold: no further from it than twice the plain version's distance."""

import numpy as np
import pytest
import torch

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
