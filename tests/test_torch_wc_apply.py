"""K2 ``whiten_color_apply`` of the port against the JAX package, float32.

The JAX side runs the Pallas kernel in interpret mode (as
tests/test_pallas_wc.py does), under conftest's float32 matmul precision;
the port's side is the plain version, which the wrapper runs for a CPU
tensor. The cases follow tests/test_pallas_wc.py: both scalings, the
negative-diagonal jitter, ragged rows, identity Gamma. Tolerance 1e-4:
both run the same 15 float32 Newton-Schulz steps and the same float32 row
pass, with sums taken in another order."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcgan_tpu.models import layers as jlayers
from wcgan_tpu.ops import pallas_wc, whiten
from wcgan_tpu_torch import weights
from wcgan_tpu_torch.models import layers as tlayers
from wcgan_tpu_torch.ops import cuda_wc

ATOL = 1e-4
KEY = jax.random.PRNGKey(0)


def _t(a):
  return torch.from_numpy(np.array(a, np.float32))


def _inputs(rng, rows, c):
  x = (rng.standard_normal((rows, c)) * 2 + 1).astype(np.float32)
  mean, cov = whiten.batch_moments(jnp.asarray(x), use_pallas=False)
  return x, np.asarray(mean), np.asarray(cov)


def _both(x, mean, cov, gamma, beta, **kw):
  out_j = pallas_wc.whiten_color_apply(
      jnp.asarray(x), jnp.asarray(mean), jnp.asarray(cov),
      jnp.asarray(gamma), jnp.asarray(beta), interpret=True, **kw)
  kw.pop("block_rows", None)
  before = cuda_wc.WC_APPLY_LAUNCHES
  out_t = cuda_wc.whiten_color_apply(_t(x), _t(mean), _t(cov), _t(gamma),
                                     _t(beta), **kw)
  assert cuda_wc.WC_APPLY_LAUNCHES == before   # a CPU tensor: plain version
  return np.asarray(out_j), out_t.numpy()


@pytest.mark.parametrize("scaling", ["trace", "fro"])
def test_plain_matches_jax_kernel(scaling, rng):
  c = 16
  x, mean, cov = _inputs(rng, 300, c)
  gamma = (rng.standard_normal((c, c)) * 0.3).astype(np.float32)
  beta = rng.standard_normal(c).astype(np.float32)
  out_j, out_t = _both(x, mean, cov, gamma, beta, ns_iters=15,
                       scaling=scaling)
  np.testing.assert_allclose(out_t, out_j, atol=ATOL)


def test_plain_negative_diagonal_jitter_matches_jax(rng):
  """The 2*neg_diag term of the jitter: a near-constant feature whose
  variance rounded negative whitens finitely on both sides."""
  c = 8
  x, mean, cov = _inputs(rng, 200, c)
  cov = np.array(cov)
  cov[0, :] = cov[:, 0] = 1e-8 * rng.standard_normal(c)
  cov[0, 0] = -3e-8
  out_j, out_t = _both(x, mean, cov, np.eye(c, dtype=np.float32),
                       np.zeros(c, np.float32), ns_iters=15)
  assert np.isfinite(out_t).all()
  np.testing.assert_allclose(out_t, out_j, atol=ATOL)


def test_plain_ragged_rows_identity_gamma_match_jax(rng):
  c = 8
  x, mean, cov = _inputs(rng, 130, c)
  out_j, out_t = _both(x, mean, cov, np.eye(c, dtype=np.float32),
                       np.zeros(c, np.float32), block_rows=64)
  assert out_t.shape == (130, c)
  np.testing.assert_allclose(out_t, out_j, atol=ATOL)
  # Identity coloring whitens: zero mean, identity covariance.
  m2, c2 = whiten.batch_moments(jnp.asarray(out_t), use_pallas=False)
  np.testing.assert_allclose(np.asarray(m2), np.zeros(c), atol=1e-4)
  np.testing.assert_allclose(np.asarray(c2), np.eye(c), atol=2e-3)


def test_fold_reference_is_the_composition(rng):
  """M and bias of the plain setup are Gamma W and beta - mu M^T with the
  port's own Newton-Schulz W."""
  from wcgan_tpu_torch.ops import whiten as twhiten
  c = 16
  _, mean, cov = _inputs(rng, 300, c)
  gamma = _t(rng.standard_normal((c, c)) * 0.3)
  beta = _t(rng.standard_normal(c))
  m, bias = cuda_wc.whiten_color_fold_reference(_t(mean), _t(cov), gamma,
                                                beta, scaling="fro")
  w = twhiten.newton_schulz_inv_sqrt(_t(cov), scaling="fro")
  torch.testing.assert_close(m, gamma @ w, atol=1e-6, rtol=0)
  torch.testing.assert_close(bias, beta - _t(mean) @ m.T, atol=1e-6, rtol=0)


def test_bf16_rows_give_bf16_and_bad_scaling_raises(rng):
  c = 8
  x, mean, cov = _inputs(rng, 64, c)
  args = (_t(mean), _t(cov), torch.eye(c), torch.zeros(c))
  out = cuda_wc.whiten_color_apply(_t(x).to(torch.bfloat16), *args)
  assert out.dtype == torch.bfloat16
  ref = cuda_wc.whiten_color_apply(_t(x).to(torch.bfloat16).float(), *args)
  torch.testing.assert_close(out.float(), ref.to(torch.bfloat16).float(),
                             atol=0, rtol=0)
  with pytest.raises(ValueError, match="'trace' or 'fro'"):
    cuda_wc.whiten_color_apply(_t(x), *args, scaling="spectral")
  with pytest.raises(ValueError, match="'trace' or 'fro'"):
    pallas_wc.whiten_color_apply(jnp.asarray(x), *map(jnp.asarray, (
        mean, cov, np.eye(c), np.zeros(c))), scaling="spectral",
                                 interpret=True)


def _running_stats(rng, c, cond=100.0):
  """Non-trivial running stats: a random mean and a correlated covariance
  of condition number ``cond``, where 14 Newton-Schulz steps converge."""
  q, _ = np.linalg.qr(rng.standard_normal((c, c)))
  cov = (q * np.geomspace(2.0, 2.0 / cond, c)) @ q.T
  mean = 0.7 + rng.standard_normal(c)
  return mean.astype(np.float32), cov.astype(np.float32)


@pytest.mark.parametrize("kernel_eval", [True, False])
@pytest.mark.parametrize("kind", ["decorrelation", "norm_color"])
def test_eval_layers_match_jax(kind, kernel_eval, rng):
  """DecorrelationNorm and NormColor(d, uconv) in eval mode, K2 forced on
  and off, against the flax modules with ``pallas_eval`` the same."""
  c = 16
  x = rng.standard_normal((4, 3, 3, c)).astype(np.float32)
  mean, cov = _running_stats(rng, c)
  if kind == "decorrelation":
    jmod = jlayers.DecorrelationNorm(ns_iters=14, pallas_eval=kernel_eval)
    tmod = tlayers.DecorrelationNorm(c, ns_iters=14, kernel_eval=kernel_eval)
  else:
    jmod = jlayers.NormColor(norm="d", coloring="uconv", ns_iters=14,
                             pallas_eval=kernel_eval)
    tmod = tlayers.NormColor(c, norm="d", coloring="uconv", ns_iters=14,
                             kernel_eval=kernel_eval)
  variables = flax.core.unfreeze(jmod.init(KEY, jnp.asarray(x)))
  if "params" in variables:
    variables["params"] = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
            np.shape(a)).astype(np.float32), variables["params"])
  variables["wc_stats"] = {"mean": mean, "cov": cov}
  out_j = jmod.apply(variables, jnp.asarray(x), train=False)
  tmod.load_state_dict(weights.state_dict_from_jax(
      variables.get("params", {}), {"wc_stats": variables["wc_stats"]}))
  x_t = torch.from_numpy(x).permute(0, 3, 1, 2)
  before = cuda_wc.WC_APPLY_LAUNCHES
  out_t = tmod(x_t, train=False)
  assert cuda_wc.WC_APPLY_LAUNCHES == before
  np.testing.assert_allclose(out_t.permute(0, 2, 3, 1).detach().numpy(),
                             np.asarray(out_j), atol=ATOL)


def test_kernel_eval_routes_through_the_wrapper(rng, monkeypatch):
  """kernel_eval=True reaches cuda_wc.whiten_color_apply once per eval
  forward (the plain version here, on the CPU); the default does not."""
  calls = []
  real = cuda_wc.whiten_color_apply
  monkeypatch.setattr(cuda_wc, "whiten_color_apply",
                      lambda *a, **k: calls.append(1) or real(*a, **k))
  x = torch.from_numpy(rng.standard_normal((2, 2, 2, 8)).astype(
      np.float32)).permute(0, 3, 1, 2)
  for kernel_eval, expected in ((True, 2), (None, 0), (False, 0)):
    calls.clear()
    for mod in (tlayers.NormColor(8, kernel_eval=kernel_eval),
                tlayers.DecorrelationNorm(8, kernel_eval=kernel_eval)):
      mod(x, train=False)
      mod(x, train=True)       # train mode never uses K2
    assert len(calls) == expected, (kernel_eval, calls)


def test_kernel_eval_with_cholesky_raises():
  """Forcing K2 with method='cholesky' raises, as pallas_eval does
  (tests/test_models.py::test_pallas_eval_forced_with_cholesky_raises)."""
  x = torch.zeros((4, 8, 2, 2)).to(memory_format=torch.channels_last)
  for mod in (tlayers.NormColor(8, method="cholesky", kernel_eval=True),
              tlayers.DecorrelationNorm(8, method="cholesky",
                                        kernel_eval=True)):
    with pytest.raises(ValueError, match="newton_schulz"):
      mod(x, train=False)
    mod(x, train=True)         # the gate is read only in eval mode
  jnc = jlayers.NormColor(norm="d", coloring="uconv", method="cholesky",
                          pallas_eval=True)
  xj = jnp.zeros((4, 2, 2, 8))
  with pytest.raises(ValueError, match="newton_schulz"):
    jnc.apply(jnc.init(KEY, xj, train=True), xj, train=False)
