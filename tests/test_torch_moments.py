"""K1's wrapper and the port's batch_moments against the JAX package.

The JAX side runs as tests/test_pallas_wc.py runs it on the CPU: the plain
``whiten.batch_moments(use_pallas=False)`` and the Pallas kernel in
interpret mode. On the CPU the port's wrapper runs ``moments_reference``
(the kernel itself runs only on a card; chip_smoke.py holds it against
the same reference there). Tolerance 1e-4: the reference's own on-chip
gate for the kernel against the plain float32 moments.

The kernel's arithmetic is emulated here too (``_emulate_k1``): the
centered values split into tf32 hi and lo, hi.lo + lo.hi + hi.hi per
32-row stage in float32, stages added into float32 totals, R-ranges added
in order, as csrc/moments.cu computes them. That is where the precision
choice (3xTF32, not 1-pass TF32) is checked without a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcgan_tpu.ops import pallas_wc, whiten
from wcgan_tpu_torch.ops import cuda_wc
from wcgan_tpu_torch.ops import whiten as twhiten

ATOL = 1e-4


def _np(t):
  return t.detach().float().numpy()


def _tf32(a):
  """float32 -> tf32 (10 mantissa bits), to nearest, ties away from 0:
  cvt.rna.tf32.f32, by masking the bits of the float32."""
  u = np.asarray(a, np.float32).view(np.uint32)
  return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_ranges(rows, cols, stage=32, target=132, min_rows=128):
  """The kernel's R-ranges (plan_for in csrc/moments.cu)."""
  tiles = -(-cols // 128)
  pairs = tiles * (tiles + 1) // 2
  splits = max(1, min(target // pairs, -(-rows // min_rows)))
  split_rows = -(-(-(-rows // splits)) // stage) * stage
  return [(r, min(rows, r + split_rows)) for r in range(0, rows, split_rows)]


def _emulate_k1(x, passes=3, stage=32):
  """(mean, cov) of x (R, C) with K1's arithmetic: float32 mean, centered
  rows, tf32 products (3 passes: hi.lo + lo.hi + hi.hi; 1 pass: hi.hi) per
  32-row stage, stage sums added in float32, ranges added in order."""
  x = np.asarray(x, np.float32)
  rows, cols = x.shape
  mean = x.mean(axis=0, dtype=np.float32)
  total = np.zeros((cols, cols), np.float32)
  for r0, r1 in _split_ranges(rows, cols, stage):
    part_sum = np.zeros((cols, cols), np.float32)
    for s0 in range(r0, r1, stage):
      v = np.zeros((stage, cols), np.float32)   # rows past the range: 0
      v[:min(r1, s0 + stage) - s0] = x[s0:min(r1, s0 + stage)] - mean
      hi = _tf32(v)
      lo = _tf32(v - hi)
      part = hi.T @ hi
      if passes == 3:
        part = (hi.T @ lo + lo.T @ hi) + part
      part_sum += part
    total += part_sum
  cov = total / np.float32(rows)
  return mean, np.triu(cov) + np.triu(cov, 1).T     # upper mirrored


def _bf16(a):
  return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


@pytest.mark.parametrize("rows,c,block", [(512, 16, 128), (1000, 32, 256),
                                          (64, 8, 128), (130, 16, 64)])
def test_moments_match_jax(rows, c, block, rng):
  x = rng.standard_normal((rows, c)).astype(np.float32) * 2 + 3
  mean_j, cov_j = whiten.batch_moments(jnp.asarray(x), use_pallas=False)
  mean_p, cov_p = pallas_wc.moments(jnp.asarray(x), block, True)
  xt = torch.from_numpy(x)
  for use_kernel in (None, True, False):
    mean_t, cov_t = twhiten.batch_moments(xt, use_kernel=use_kernel)
    assert mean_t.dtype == torch.float32 and cov_t.shape == (c, c)
    for mean_ref, cov_ref in ((mean_j, cov_j), (mean_p, cov_p)):
      np.testing.assert_allclose(_np(mean_t), np.asarray(mean_ref),
                                 atol=ATOL)
      np.testing.assert_allclose(_np(cov_t), np.asarray(cov_ref), atol=ATOL)


@pytest.mark.parametrize("rows,c", [(512, 16), (1000, 32), (64, 8),
                                    (130, 16), (4096, 64)])
def test_k1_arithmetic_matches_jax(rows, c, rng):
  """3xTF32 as the kernel runs it, ragged R included, against the Pallas
  kernel (interpret mode) and the plain JAX moments."""
  x = rng.standard_normal((rows, c)).astype(np.float32) * 2 + 3
  mean_e, cov_e = _emulate_k1(x)
  assert np.array_equal(cov_e, cov_e.T)
  mean_p, cov_p = pallas_wc.moments(jnp.asarray(x), 128, True)
  mean_j, cov_j = whiten.batch_moments(jnp.asarray(x), use_pallas=False)
  for mean_ref, cov_ref in ((mean_p, cov_p), (mean_j, cov_j)):
    np.testing.assert_allclose(mean_e, np.asarray(mean_ref), atol=ATOL)
    np.testing.assert_allclose(cov_e, np.asarray(cov_ref), atol=ATOL)


def test_k1_arithmetic_bf16_and_large_mean(rng):
  """bf16 rows (the same values on both sides), and |mu| >> sigma, where
  the two-pass centering keeps the diagonal >= 0 and near sigma^2."""
  x = _bf16(rng.standard_normal((1000, 16)) * 2 + 3)
  mean_p, cov_p = pallas_wc.moments(jnp.asarray(x).astype(jnp.bfloat16), 128,
                                    True)
  mean_e, cov_e = _emulate_k1(x)
  np.testing.assert_allclose(mean_e, np.asarray(mean_p), atol=ATOL)
  np.testing.assert_allclose(cov_e, np.asarray(cov_p), atol=ATOL)
  x = (rng.standard_normal((512, 16)) * 0.01 + 1000.0).astype(np.float32)
  _, cov_e = _emulate_k1(x)
  diag = np.diag(cov_e)
  assert (diag >= 0).all()
  np.testing.assert_allclose(diag, 1e-4 * np.ones(16), rtol=0.2)
  _, cov_p = pallas_wc.moments(jnp.asarray(x), 128, True)
  np.testing.assert_allclose(cov_e, np.asarray(cov_p), atol=1e-6)


def test_one_pass_tf32_misses_the_gate_and_three_passes_keep_it(rng):
  """bf16-rounded correlated rows with a mean in [-3, 3] and |cov| <= 5:
  1-pass TF32 is off from float64 by more than the 1e-4 gate; 3xTF32 is
  within a tenth of it."""
  rows, c = 16384, 64
  a = rng.standard_normal((c, c)) / np.sqrt(c)
  x = _bf16(rng.standard_normal((rows, c)) @ a.T * 1.5
            + rng.uniform(-3, 3, c))
  x64 = x.astype(np.float64)
  xc = x64 - x64.mean(axis=0)
  cov64 = xc.T @ xc / rows
  assert 1.0 < np.abs(cov64).max() <= 5.0
  err1 = np.abs(_emulate_k1(x, passes=1)[1] - cov64).max()
  err3 = np.abs(_emulate_k1(x, passes=3)[1] - cov64).max()
  assert err1 > ATOL, err1
  assert err3 < ATOL / 10, err3


def test_moments_bf16_input(rng):
  """bf16 rows: the same bf16 values, upcast, on both sides."""
  xt = torch.from_numpy(
      rng.standard_normal((256, 16)).astype(np.float32)).bfloat16()
  x_vals = _np(xt)
  mean_t, cov_t = cuda_wc.moments(xt)
  assert mean_t.dtype == torch.float32 and cov_t.dtype == torch.float32
  mean_p, cov_p = pallas_wc.moments(
      jnp.asarray(x_vals).astype(jnp.bfloat16), 128, True)
  mean_j, cov_j = whiten.batch_moments(jnp.asarray(x_vals), use_pallas=False)
  for mean_ref, cov_ref in ((mean_p, cov_p), (mean_j, cov_j)):
    np.testing.assert_allclose(_np(mean_t), np.asarray(mean_ref), atol=ATOL)
    np.testing.assert_allclose(_np(cov_t), np.asarray(cov_ref), atol=ATOL)


def test_moments_large_mean_regime(rng):
  """Two-pass semantics survive |mu| >> sigma: the diagonal stays >= 0."""
  x = (rng.standard_normal((512, 16)) * 0.01 + 1000.0).astype(np.float32)
  _, cov_t = cuda_wc.moments(torch.from_numpy(x))
  diag = np.diag(_np(cov_t))
  assert (diag >= 0).all()
  np.testing.assert_allclose(diag, 1e-4 * np.ones(16), rtol=0.2)
  _, cov_p = pallas_wc.moments(jnp.asarray(x), 128, True)
  np.testing.assert_allclose(_np(cov_t), np.asarray(cov_p), atol=ATOL)


def test_moments_gradient_matches_jax(rng):
  """MomentsFn.backward == jax.grad through the Pallas custom VJP, and ==
  autograd of the plain path."""
  x = rng.standard_normal((256, 12)).astype(np.float32)
  w = rng.standard_normal((12, 12)).astype(np.float32)

  def loss_pallas(xj):
    mean, cov = pallas_wc.moments(xj, 64, True)
    return jnp.sum(cov * w) + jnp.sum(mean ** 2)

  g_jax = np.asarray(jax.grad(loss_pallas)(jnp.asarray(x)))
  wt = torch.from_numpy(w)
  grads = []
  for fn in (cuda_wc.moments,
             lambda t: twhiten.batch_moments(t, use_kernel=False)):
    xt = torch.from_numpy(x).requires_grad_(True)
    mean, cov = fn(xt)
    (torch.sum(cov * wt) + torch.sum(mean ** 2)).backward()
    grads.append(_np(xt.grad))
  for g in grads:
    np.testing.assert_allclose(g, g_jax, atol=ATOL)


def test_moments_gradient_one_output_only(rng):
  """A cotangent for only one output (the other None) counts as zeros."""
  x = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
  for pick in (0, 1):
    xa = x.clone().requires_grad_(True)
    xb = x.clone().requires_grad_(True)
    cuda_wc.moments(xa)[pick].sum().backward()
    twhiten.batch_moments(xb, use_kernel=False)[pick].sum().backward()
    np.testing.assert_allclose(_np(xa.grad), _np(xb.grad), atol=ATOL)


def test_cpu_calls_never_launch_the_kernel(rng):
  before = cuda_wc.MOMENTS_LAUNCHES
  x = torch.from_numpy(rng.standard_normal((128, 8)).astype(np.float32))
  cuda_wc.moments(x)
  twhiten.batch_moments(x)
  assert cuda_wc.MOMENTS_LAUNCHES == before == 0


def test_wrapper_refuses_what_the_kernel_does_not_take():
  with pytest.raises(ValueError, match="CUDA tensor"):
    cuda_wc.moments_cuda(torch.zeros(8, 4))
  with pytest.raises(ValueError, match="no kernel for device"):
    cuda_wc.moments(torch.zeros(8, 4, device="meta"))


@pytest.mark.parametrize("dtype,cols,ok", [
    (torch.float32, 4, True), (torch.float32, 6, False),
    (torch.float32, 256, True), (torch.bfloat16, 8, True),
    (torch.bfloat16, 12, False), (torch.bfloat16, 256, True),
    (torch.float16, 8, False)])
def test_kernel_row_checks(dtype, cols, ok):
  """Rows of K1 are 16-byte multiples on 16-byte boundaries (TMA), of
  float32 or bfloat16; the JAX package's widths all pass."""
  x = torch.zeros((8, cols), dtype=dtype)
  if ok:
    cuda_wc.check_moments_rows(x)
    return
  with pytest.raises((ValueError, TypeError)):
    cuda_wc.check_moments_rows(x)


def test_kernel_row_checks_refuse_offset_and_strided_views():
  x = torch.zeros((9, 256))
  cuda_wc.check_moments_rows(x[1:])          # offset 1 KB: aligned
  with pytest.raises(ValueError, match="16 bytes"):
    cuda_wc.check_moments_rows(x.view(-1)[1:2049].view(8, 256))
  with pytest.raises(ValueError, match="contiguous"):
    cuda_wc.check_moments_rows(x[:, :128])
