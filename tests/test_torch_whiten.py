"""The port's whitening numerics against wcgan_tpu/ops/whiten.py, float32.

Both sides run float32 matmuls on the CPU (tests/conftest.py pins JAX's
matmul precision to float32). Tolerances: 1e-5 where the two compute the
same sums in another order; the Newton-Schulz results 1e-4, since 15
coupled iterations amplify last-bit differences by the conditioning."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcgan_tpu.ops import whiten
from wcgan_tpu_torch.ops import whiten as twhiten


def _np(t):
  return t.detach().float().numpy()


def _spd(rng, c, cond=50.0):
  q, _ = np.linalg.qr(rng.standard_normal((c, c)))
  eig = np.geomspace(1.0, 1.0 / cond, c)
  return ((q * eig) @ q.T).astype(np.float32)


@pytest.mark.parametrize("scaling", ["trace", "fro"])
def test_newton_schulz_inv_sqrt_matches_jax(scaling, rng):
  cov = _spd(rng, 16)
  w_j = np.asarray(whiten.newton_schulz_inv_sqrt(
      jnp.asarray(cov), num_iters=15, scaling=scaling))
  w_t = _np(twhiten.newton_schulz_inv_sqrt(torch.from_numpy(cov),
                                           num_iters=15, scaling=scaling))
  np.testing.assert_allclose(w_t, w_j, atol=1e-4)
  resid = np.abs(w_t @ cov @ w_t.T - np.eye(16)).max()
  assert resid < 1e-3, resid


def test_newton_schulz_gradient_matches_jax(rng):
  """Autograd through the unrolled loop == jax.grad through the scan."""
  cov = _spd(rng, 8, cond=10.0)
  probe = rng.standard_normal((8, 8)).astype(np.float32)

  def loss_j(c):
    return jnp.sum(whiten.newton_schulz_inv_sqrt(c, num_iters=15) * probe)

  g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(cov)))
  ct = torch.from_numpy(cov).requires_grad_(True)
  torch.sum(twhiten.newton_schulz_inv_sqrt(ct, num_iters=15)
            * torch.from_numpy(probe)).backward()
  np.testing.assert_allclose(_np(ct.grad), g_j, atol=1e-4)


def test_spd_jitter_negative_diagonal(rng):
  """A diagonal that rounds negative gets the 2*neg_diag term, and the
  jittered Newton-Schulz stays finite, as in the reference."""
  c = 8
  cov = _spd(rng, c) * 1e-8
  cov[3, 3] = -2e-7
  jit_j = float(whiten._spd_jitter(jnp.asarray(cov), 1e-5))
  jit_t = float(twhiten._spd_jitter(torch.from_numpy(cov), 1e-5))
  np.testing.assert_allclose(jit_t, jit_j, rtol=1e-6)
  assert jit_t >= 4e-7
  for scaling in ("trace", "fro"):
    a_j, s_j, _ = whiten._jittered_normalized(jnp.asarray(cov), 1e-5,
                                              scaling)
    a_t, s_t, _ = twhiten._jittered_normalized(torch.from_numpy(cov), 1e-5,
                                               scaling)
    np.testing.assert_allclose(_np(a_t), np.asarray(a_j), atol=1e-6)
    np.testing.assert_allclose(float(s_t), float(s_j), rtol=1e-6)
  w_t = _np(twhiten.newton_schulz_inv_sqrt(torch.from_numpy(cov)))
  assert np.isfinite(w_t).all()


def test_cholesky_oracle_matches_jax(rng):
  cov = _spd(rng, 12)
  w_j = np.asarray(whiten.cholesky_inv_sqrt(jnp.asarray(cov)))
  w_t = _np(twhiten.cholesky_inv_sqrt(torch.from_numpy(cov)))
  np.testing.assert_allclose(w_t, w_j, atol=1e-4)
  w_ns = _np(twhiten.newton_schulz_inv_sqrt(torch.from_numpy(cov)))
  # Different square roots, same whitening: W cov W^T = I for both.
  for w in (w_t, w_ns):
    np.testing.assert_allclose(w @ cov @ w.T, np.eye(12), atol=1e-3)


def test_whiten_apply_matches_jax(rng):
  x = rng.standard_normal((200, 16)).astype(np.float32) * 2 + 1
  mean, cov = whiten.batch_moments(jnp.asarray(x), use_pallas=False)
  w = whiten.newton_schulz_inv_sqrt(cov)
  out_j = np.asarray(whiten.whiten_apply(jnp.asarray(x), mean, w))
  out_t = twhiten.whiten_apply(torch.from_numpy(x),
                               torch.from_numpy(np.array(mean)),
                               torch.from_numpy(np.array(w)))
  assert out_t.dtype == torch.float32
  np.testing.assert_allclose(_np(out_t), out_j, atol=1e-5)
  m2, c2 = twhiten.batch_moments(out_t)
  np.testing.assert_allclose(_np(m2), np.zeros(16), atol=1e-4)
  np.testing.assert_allclose(_np(c2), np.eye(16), atol=1e-3)


def test_whiten_apply_bf16_rows(rng):
  """bf16 rows: one bf16 row matmul plus the float32-folded bias, as the
  reference; the result is bf16 and within bf16 rounding of float32."""
  x = rng.standard_normal((200, 16)).astype(np.float32)
  mean = rng.standard_normal(16).astype(np.float32) * 0.1
  w = (np.eye(16) + 0.1 * rng.standard_normal((16, 16))).astype(np.float32)
  xt = torch.from_numpy(x).bfloat16()
  out_t = twhiten.whiten_apply(xt, torch.from_numpy(mean),
                               torch.from_numpy(w))
  assert out_t.dtype == torch.bfloat16
  out_j = whiten.whiten_apply(jnp.asarray(_np(xt)).astype(jnp.bfloat16),
                              jnp.asarray(mean), jnp.asarray(w))
  ref = (_np(xt) - mean) @ w.T
  np.testing.assert_allclose(_np(out_t), ref, atol=5e-2)
  np.testing.assert_allclose(_np(out_t), np.asarray(out_j, np.float32),
                             atol=5e-2)


@pytest.mark.parametrize("use_batch", [True, False])
def test_stats_select_and_ema_matches_jax(use_batch, rng):
  bm, mm = (rng.standard_normal(8).astype(np.float32) for _ in range(2))
  bc, mc = (_spd(rng, 8) for _ in range(2))
  out_j = whiten.stats_select_and_ema(
      jnp.asarray(bm), jnp.asarray(bc), jnp.asarray(mm), jnp.asarray(mc),
      use_batch=use_batch, momentum=0.9)
  out_t = twhiten.stats_select_and_ema(
      *(torch.from_numpy(a) for a in (bm, bc, mm, mc)),
      use_batch=use_batch, momentum=0.9)
  for a, b in zip(out_t, out_j):
    np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6)
