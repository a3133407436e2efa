"""K2 ``whiten_color_apply`` of the port against the JAX package, float32.

The JAX side runs the Pallas kernel in interpret mode (as
tests/test_pallas_wc.py does), under conftest's float32 matmul precision;
the port's side is the plain version, which the wrapper runs for a CPU
tensor. The cases follow tests/test_pallas_wc.py: both scalings, the
negative-diagonal jitter, ragged rows, identity Gamma. Tolerance 1e-4:
both run the same 15 float32 Newton-Schulz steps and the same float32 row
pass, with sums taken in another order.

The kernel's bf16 row arithmetic is emulated here too (``_emulate_k2``):
M split into three bf16 pieces (hi, mid, lo), the bf16 x taken as it is,
per 16-wide K step the pieces smallest first into one float32
accumulator, then the float32 bias and one rounding to bf16, as
csrc/wc_apply.cu computes it on the tensor cores. That is where the piece
count is checked without a card."""

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


# --- K2's bf16 row apply, emulated ---------------------------------------------


def _bf16(a):
  return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _pieces(m, count):
  """M as `count` bf16 pieces, each the rounded remainder of the ones before
  (float32 remainders, exact), largest first."""
  out, rest = [], np.asarray(m, np.float32)
  for _ in range(count):
    piece = _bf16(rest)
    out.append(piece)
    rest = (rest - piece).astype(np.float32)
  return out


def _emulate_k2(x, m, bias, count=3):
  """(float32 sum before rounding, bf16 result) of K2's bf16 row apply on
  bf16 values x (R, C): per 16-wide step of K the pieces of M go in
  smallest first, each product exact and added to a float32 accumulator;
  then + bias in float32 and one rounding."""
  x = np.asarray(x, np.float32)
  pieces = _pieces(m, count)
  acc = np.zeros((x.shape[0], m.shape[0]), np.float32)
  for k in range(0, x.shape[1], 16):
    xk = x[:, k:k + 16].astype(np.float64)
    for piece in reversed(pieces):
      acc += (xk @ piece[:, k:k + 16].T.astype(np.float64)).astype(np.float32)
  pre = (acc + np.asarray(bias, np.float32)).astype(np.float32)
  return pre, _bf16(pre)


def _bf16_gate(ref):
  """2 bf16 ulps of the largest |ref| (the on-card gate)."""
  return 2.0 * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _k2_inputs(rng, rows, c, cond=1e3):
  """chip_smoke.py's recipe: running statistics with a correlated
  covariance of condition ``cond``, bf16 rows drawn from them, Gamma near
  1/sqrt(C) scale."""
  q, _ = np.linalg.qr(rng.standard_normal((c, c)))
  eig = np.logspace(0.0, -np.log10(cond), c)
  cov = ((q * eig) @ q.T).astype(np.float32)
  mean = rng.standard_normal(c).astype(np.float32)
  x = _bf16(mean + (rng.standard_normal((rows, c)) * np.sqrt(eig)) @ q.T)
  gamma = (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)
  beta = rng.standard_normal(c).astype(np.float32)
  return x, mean, cov, gamma, beta


def _plain_fold(mean, cov, gamma, beta, scaling="trace"):
  m, bias = cuda_wc.whiten_color_fold_reference(_t(mean), _t(cov), _t(gamma),
                                                _t(beta), scaling=scaling)
  return m.numpy(), bias.numpy()


@pytest.mark.parametrize("rows,c,scaling", [(130, 16, "trace"),
                                            (130, 16, "fro"),
                                            (1000, 64, "fro"),
                                            (200, 8, "trace")])
def test_k2_bf16_arithmetic_matches_jax_and_plain(rows, c, scaling, rng):
  """The emulated bf16 row apply (on the plain setup's M and bias) against
  the Pallas kernel in interpret mode and the port's plain version, on the
  same bf16 rows, ragged R, both scalings: within the on-card gate."""
  x, mean, cov, gamma, beta = _k2_inputs(rng, rows, c)
  m, bias = _plain_fold(mean, cov, gamma, beta, scaling)
  _, got = _emulate_k2(x, m, bias)
  out_j = np.asarray(pallas_wc.whiten_color_apply(
      jnp.asarray(x).astype(jnp.bfloat16), *map(jnp.asarray, (
          mean, cov, gamma, beta)), scaling=scaling, interpret=True),
      np.float32)
  out_t = cuda_wc.whiten_color_apply(
      _t(x).bfloat16(), _t(mean), _t(cov), _t(gamma), _t(beta),
      scaling=scaling).float().numpy()
  for ref in (out_j, out_t):
    assert np.abs(got - ref).max() <= _bf16_gate(ref)


def test_k2_one_piece_misses_the_gate_and_three_keep_it(rng):
  """The main path's width and a live layer's conditioning (C=256,
  cond 1e3): one bf16 piece of M is off the plain version by more than
  2 bf16 ulps; three pieces keep the gate, and before rounding they are
  within 2x of plain float32's distance from float64."""
  x, mean, cov, gamma, beta = _k2_inputs(rng, 16384, 256)
  m, bias = _plain_fold(mean, cov, gamma, beta)
  plain = cuda_wc.whiten_color_apply(
      _t(x).bfloat16(), _t(mean), _t(cov), _t(gamma),
      _t(beta)).float().numpy()
  gate = _bf16_gate(plain)
  exact = x.astype(np.float64) @ m.T.astype(np.float64) + bias
  plain_pre = (_t(x) @ _t(m).T + _t(bias)).numpy()
  _, one = _emulate_k2(x, m, bias, count=1)
  three_pre, three = _emulate_k2(x, m, bias, count=3)
  assert np.abs(one - plain).max() > gate
  assert np.abs(three - plain).max() <= gate
  assert (np.abs(three_pre - exact).max()
          <= 2 * np.abs(plain_pre - exact).max())


@pytest.mark.parametrize("cols,ok", [(8, True), (16, True), (136, True),
                                     (256, True), (512, True), (4, False),
                                     (12, False), (520, False)])
def test_kernel_width_check(cols, ok):
  """K2 takes 8 <= C <= 512 with C % 8 == 0 (TMA rows of bf16); the G
  presets' widths all pass."""
  if ok:
    cuda_wc.check_wc_cols(cols)
    return
  with pytest.raises(ValueError, match="C <= 512"):
    cuda_wc.check_wc_cols(cols)


def test_k2_wrappers_refuse_cpu_tensors():
  c = 8
  stats = (torch.zeros(c), torch.eye(c), torch.eye(c), torch.zeros(c))
  with pytest.raises(ValueError, match="CUDA tensor"):
    cuda_wc.whiten_color_apply_cuda(torch.zeros((4, c)), *stats)
  with pytest.raises(ValueError, match="CUDA tensors"):
    cuda_wc.whiten_color_setup_cuda(*stats)
  with pytest.raises(ValueError, match="CUDA tensor"):
    cuda_wc.whiten_color_rows_cuda(torch.zeros((4, c)), torch.zeros(16))
