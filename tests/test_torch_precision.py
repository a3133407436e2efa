"""``--whitening_precision high`` in the port: K3's plain version
(``ops/mm_bf16x3.py``), the precision switch of ``ops/whiten.py`` and the
sites that follow it, against numpy and the JAX package, float32, small
shapes.

On the CPU JAX's HIGH is exact float32 (tests/conftest.py pins its matmul
precision to float32), while the port's 'high' runs the bf16x3 emulation
(three float32 products of bf16 pieces). So the port under 'high' is held
to JAX within what the emulation loses: bf16x3 keeps about 16 bits of
each operand (2^-16 ~ 1.5e-5 relative per product), which Newton-Schulz
at conditioning ~1e3 amplifies. Tolerances are stated where used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcgan_tpu.ops import pallas_wc
from wcgan_tpu.ops import whiten as jwhiten
from wcgan_tpu_torch import compiled
from wcgan_tpu_torch.ops import cuda_wc
from wcgan_tpu_torch.ops import mm_bf16x3 as k3
from wcgan_tpu_torch.ops import whiten as twhiten

EPS32 = 2.0 ** -23  # a float32 ulp at 1.0


@pytest.fixture
def high():
  """The switch at 'high' for one test, then back at the default."""
  twhiten.set_precision("high")
  try:
    yield
  finally:
    twhiten.set_precision("highest")


def _np(t):
  return t.detach().float().numpy()


def _bf16_rne(x: np.ndarray) -> np.ndarray:
  """float32 -> the nearest bf16 (ties to even), on the float32 bits."""
  u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
  u = u.astype(np.uint64)
  u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
  return u.astype(np.uint32).view(np.float32)


def _pieces(x: np.ndarray):
  hi = _bf16_rne(x)
  return hi.astype(np.float64), _bf16_rne(x - hi).astype(np.float64)


def _spd(rng, c, cond):
  q, _ = np.linalg.qr(rng.standard_normal((c, c)))
  return ((q * np.geomspace(1.0, 1.0 / cond, c)) @ q.T).astype(np.float32)


def _operands(rng, m, k, n, layout):
  """a (m, k), b (k, n) as float32 torch tensors, each a transposed view
  of a contiguous tensor where ``layout`` says 't'."""
  a = rng.standard_normal((m, k)).astype(np.float32)
  b = rng.standard_normal((k, n)).astype(np.float32)
  ta = (torch.from_numpy(a.T.copy()).T if layout[0] == "t"
        else torch.from_numpy(a))
  tb = (torch.from_numpy(b.T.copy()).T if layout[1] == "t"
        else torch.from_numpy(b))
  return a, b, ta, tb


@pytest.mark.parametrize("m,k,n", [(32, 32, 32), (17, 29, 13), (1, 24, 7)])
@pytest.mark.parametrize("layout", ["nn", "nt", "tn"])
def test_reference_matches_a_numpy_emulation(m, k, n, layout, rng):
  """The plain version against the same pieces cut on the float32 bits
  and summed in float64: within 8 float32 ulps of (|A| |B|)_ij, the
  rounding of three float32 products of at most 32 terms."""
  a, b, ta, tb = _operands(rng, m, k, n, layout)
  a_hi, a_lo = _pieces(a)
  b_hi, b_lo = _pieces(b)
  want = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
  got = _np(k3.mm_bf16x3_reference(ta, tb)).astype(np.float64)
  bound = 8 * EPS32 * (np.abs(a).astype(np.float64) @ np.abs(b))
  assert got.shape == (m, n)
  assert np.all(np.abs(got - want) <= bound)
  # The wrapper on CPU tensors is the plain version, and launches nothing.
  before = k3.MM_BF16X3_LAUNCHES
  assert torch.equal(k3.mm_bf16x3(ta, tb), k3.mm_bf16x3_reference(ta, tb))
  assert k3.MM_BF16X3_LAUNCHES == before


def test_reference_loses_more_than_float32(rng):
  """Against float64 the emulation's error is well above a float32
  product's (so 'high' really runs it) and near 2^-16 relative."""
  a, b, ta, tb = _operands(rng, 32, 32, 32, "nn")
  exact = a.astype(np.float64) @ b
  scale = float((np.abs(a).astype(np.float64) @ np.abs(b)).max())
  err_high = float(np.abs(_np(k3.mm_bf16x3_reference(ta, tb)) - exact).max())
  err_f32 = float(np.abs(_np(ta @ tb) - exact).max())
  assert err_high > 8 * err_f32
  assert err_high < 2.0 ** -14 * scale


def test_autograd_is_the_transposed_products_and_differentiates_again(rng):
  """dA = dC B^T and dB = A^T dC, each through the plain version; a vector
  operand; and a double backward that runs, against float32 autograd of
  the same expression within 1e-4 relative."""
  a, b, _, _ = _operands(rng, 5, 7, 3, "nn")
  probe = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32))
  ta = torch.from_numpy(a).requires_grad_(True)
  tb = torch.from_numpy(b).requires_grad_(True)
  (k3.mm_bf16x3(ta, tb) * probe).sum().backward()
  assert torch.equal(ta.grad, k3.mm_bf16x3_reference(probe, tb.detach().T))
  assert torch.equal(tb.grad, k3.mm_bf16x3_reference(ta.detach().T, probe))

  v = torch.from_numpy(a[0].copy()).requires_grad_(True)
  out = k3.mm_bf16x3(v, torch.from_numpy(b))
  assert out.shape == (3,)
  out.sum().backward()
  assert v.grad.shape == (7,)

  grads = []
  for mm in (k3.mm_bf16x3, torch.matmul):
    xa = torch.from_numpy(a).requires_grad_(True)
    xb = torch.from_numpy(b).requires_grad_(True)
    (ga,) = torch.autograd.grad((mm(xa, xb) * probe).sum(), xa,
                                create_graph=True)
    (mm(ga, ga.T) ** 2).sum().backward()
    grads.append(_np(xb.grad))
  scale = np.abs(grads[1]).max()
  assert np.isfinite(grads[0]).all()
  np.testing.assert_allclose(grads[0], grads[1], atol=1e-4 * scale)


def test_set_precision_switch(rng, high, monkeypatch):
  """The counterpart of tests/test_whiten.py::test_set_precision_switch:
  'high' still whitens (W Sigma W^T near I), through bf16x3, and an
  unknown name raises."""
  calls = []

  def counting(a, b):
    calls.append((tuple(a.shape), tuple(b.shape)))
    return k3.mm_bf16x3(a, b)

  monkeypatch.setattr(twhiten, "mm_bf16x3", counting)
  c = 16
  x = torch.from_numpy(rng.standard_normal((512, c)).astype(np.float32) * 3)
  assert twhiten.get_precision() == "high"
  mean, cov = twhiten.batch_moments(x)
  out = twhiten.whiten_apply(x, mean, twhiten.inv_sqrt(cov))
  # The covariance, 3 products an iteration of 15, the row product.
  assert len(calls) == 1 + 45 + 1
  twhiten.set_precision("highest")
  mean_o, cov_o = twhiten.batch_moments(out)
  np.testing.assert_allclose(_np(mean_o), np.zeros(c), atol=1e-4)
  np.testing.assert_allclose(_np(cov_o), np.eye(c), atol=1e-3)
  with pytest.raises(ValueError, match="'highest' or 'high'"):
    twhiten.set_precision("bf16")
  assert twhiten.get_precision() == "highest"


@pytest.mark.parametrize("c", [16, 32])
def test_newton_schulz_high_matches_jax(c, rng, high):
  """Newton-Schulz under 'high' against JAX's (exact float32 on the CPU)
  at conditioning 1e3: within 1e-3 of max|W| (the emulation's 2^-16 a
  product, amplified by the conditioning over 15 coupled iterations,
  measured near 2e-4), and a whitening residual <= 1e-3."""
  cov = _spd(rng, c, 1e3)
  w_j = np.asarray(jwhiten.newton_schulz_inv_sqrt(jnp.asarray(cov),
                                                  num_iters=15))
  w_t = _np(twhiten.newton_schulz_inv_sqrt(torch.from_numpy(cov),
                                           num_iters=15))
  np.testing.assert_allclose(w_t, w_j, atol=1e-3 * np.abs(w_j).max())
  resid = np.abs(w_t @ cov.astype(np.float64) @ w_t.T - np.eye(c)).max()
  assert resid <= 1e-3, resid
  # The square-root branch (FID's 'ns' route) takes the switch too.
  s_j = np.asarray(jwhiten.newton_schulz_sqrt(jnp.asarray(cov),
                                              num_iters=15))
  s_t = _np(twhiten.newton_schulz_sqrt(torch.from_numpy(cov), num_iters=15))
  np.testing.assert_allclose(s_t, s_j, atol=1e-3 * np.abs(s_j).max())


def test_k1_backward_high_matches_the_pallas_vjp(rng, high, monkeypatch):
  """MomentsFn's backward under 'high' (its row product through bf16x3)
  against jax.grad through the Pallas custom VJP in interpret mode
  (exact float32 on the CPU), within 1e-5 of the gradient's largest
  magnitude; K1's forward (its plain version here) stays true float32."""
  calls = []
  monkeypatch.setattr(twhiten, "mm_bf16x3",
                      lambda a, b: calls.append(a.shape) or k3.mm_bf16x3(a,
                                                                        b))
  x = rng.standard_normal((256, 12)).astype(np.float32)
  w = rng.standard_normal((12, 12)).astype(np.float32)

  def loss_pallas(xj):
    mean, cov = pallas_wc.moments(xj, 64, True)
    return jnp.sum(cov * w) + jnp.sum(mean ** 2)

  g_jax = np.asarray(jax.grad(loss_pallas)(jnp.asarray(x)))
  xt = torch.from_numpy(x).requires_grad_(True)
  mean, cov = cuda_wc.moments(xt)
  assert calls == []
  assert torch.equal(cov, cuda_wc.moments_reference(xt.detach())[1])
  (torch.sum(cov * torch.from_numpy(w)) + torch.sum(mean ** 2)).backward()
  assert calls == [(256, 12)]
  np.testing.assert_allclose(_np(xt.grad), g_jax,
                             atol=1e-5 * np.abs(g_jax).max())


def test_fold_reference_ignores_the_precision(rng):
  """K2's plain version pins true float32, as K2 pins HIGHEST."""
  c = 16
  cov = torch.from_numpy(_spd(rng, c, 1e3))
  mean = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
  gamma = torch.from_numpy(rng.standard_normal((c, c)).astype(np.float32))
  beta = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
  want = cuda_wc.whiten_color_fold_reference(mean, cov, gamma, beta)
  twhiten.set_precision("high")
  try:
    got = cuda_wc.whiten_color_fold_reference(mean, cov, gamma, beta)
  finally:
    twhiten.set_precision("highest")
  assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_backend_key_holds_the_precision(high):
  """A graph captured under one precision is never replayed under the
  other: the key every program is bound to differs."""
  key_high = compiled.backend_key()
  twhiten.set_precision("highest")
  assert key_high != compiled.backend_key()
