"""K1's wrapper and the port's batch_moments against the JAX package.

The JAX side runs as tests/test_pallas_wc.py runs it on the CPU: the plain
``whiten.batch_moments(use_pallas=False)`` and the Pallas kernel in
interpret mode. On the CPU the port's wrapper runs ``moments_reference``
(the kernel itself runs only on a card; chip_smoke.py holds it against
the same reference there). Tolerance 1e-4: the reference's own on-chip
gate for the kernel against the plain float32 moments."""

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
