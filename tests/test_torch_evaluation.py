"""The port's evaluation math and InceptionV3 against the JAX package's.

The same numpy inputs (from a seed) go through ``wcgan_tpu.evaluation`` on
the CPU (float32 matmuls, as tests/conftest.py pins them) and through
``wcgan_tpu_torch.evaluation`` on the CPU. Tolerances:

- IS, moments, Newton-Schulz square root: 1e-5 relative, the two
  packages' float32 rounding apart; FID against the float64 value of the
  same moments, no further from it than JAX (up to 1e-5); against scipy
  in float64 the reference's own gates (tests/test_evaluation.py).
- ``preprocess``: 1e-6 absolute on [-1, 1] (``jax.image.resize`` and
  ``F.interpolate`` differ by ~2e-7 enlarging 32-64 px to 299, ~6e-7
  shrinking 400 px, antialiased).
- InceptionV3 at 75x75 (the smallest input it takes; flax's parameters
  do not depend on the spatial size), batch 2: pool and logits within
  1e-5 of their largest magnitude, on weights moved by
  ``weights.inception_from_jax`` and on weights loaded from one npz.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from wcgan_tpu.evaluation import inception_v3 as j_iv
from wcgan_tpu.evaluation import metrics as j_metrics
from wcgan_tpu.ops import whiten as j_whiten
from wcgan_tpu_torch import weights
from wcgan_tpu_torch.evaluation import inception_v3 as t_iv
from wcgan_tpu_torch.evaluation import metrics as t_metrics
from wcgan_tpu_torch.ops import whiten as t_whiten

RTOL = 1e-5
NET_RTOL = 1e-5
SIDE = 75


def _t(a):
  return torch.from_numpy(np.asarray(a, np.float32).copy())


def _probs(rng, n, k):
  logits = rng.standard_normal((n, k)).astype(np.float32) * 3.0
  e = np.exp(logits - logits.max(-1, keepdims=True))
  return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _moment_pair(seed, n1, n2, d, scales=None, shift=0.3):
  rng = np.random.default_rng(seed)
  s = np.ones(d) if scales is None else scales
  a = (rng.standard_normal((n1, d)) * s).astype(np.float32)
  b = (rng.standard_normal((n2, d)) * s[::-1] * 1.4 + shift).astype(
      np.float32)
  return a, b


def _scipy_fid(mu1, s1, mu2, s2, offset=0.0):
  s1 = np.asarray(s1, np.float64)
  s2 = np.asarray(s2, np.float64)
  eye = np.eye(s1.shape[0]) * offset
  covmean = scipy.linalg.sqrtm((s1 + eye) @ (s2 + eye))
  return (np.sum((np.asarray(mu1, np.float64) - mu2) ** 2) + np.trace(s1)
          + np.trace(s2) - 2 * np.trace(covmean.real))


@pytest.mark.parametrize("n,splits", [(200, 10), (103, 5)])
def test_inception_score_matches_jax(n, splits):
  probs = _probs(np.random.default_rng(n), n, 12)
  jm, js = j_metrics.inception_score(jnp.asarray(probs), splits=splits)
  tm, ts = t_metrics.inception_score(_t(probs), splits=splits)
  np.testing.assert_allclose(float(tm), float(jm), rtol=RTOL)
  np.testing.assert_allclose(float(ts), float(js), rtol=RTOL, atol=1e-7)
  # The population std (ddof 0), as jnp.std: numpy float64 on the splits.
  per = n // splits
  p = probs[:per * splits].reshape(splits, per, -1).astype(np.float64)
  marg = p.mean(1, keepdims=True)
  scores = np.exp((p * (np.log(p + 1e-16) - np.log(marg + 1e-16))).sum(
      -1).mean(1))
  np.testing.assert_allclose(float(ts), scores.std(ddof=0), rtol=1e-4)


def test_inception_score_edge_cases():
  mean, std = t_metrics.inception_score(torch.full((100, 10), 0.1), 5)
  assert abs(float(mean) - 1.0) < 1e-5 and abs(float(std)) < 1e-5
  onehot = torch.eye(10)[torch.arange(200) % 10]
  mean, _ = t_metrics.inception_score(onehot, splits=4)
  np.testing.assert_allclose(float(mean), 10.0, rtol=1e-4)


def test_moments_match_jax_and_numpy_cov():
  a = np.random.default_rng(3).standard_normal((128, 16)).astype(
      np.float32) * 2.0 + 5.0
  jmu, jsig = j_metrics.moments_from_activations(jnp.asarray(a))
  tmu, tsig = t_metrics.moments_from_activations(_t(a))
  np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=RTOL)
  np.testing.assert_allclose(tsig.numpy(), np.asarray(jsig), rtol=RTOL,
                             atol=1e-6)
  np.testing.assert_allclose(tsig.numpy(), np.cov(a, rowvar=False),
                             atol=1e-4)


# (name, n1, n2, d, scales) of the pairs of activation sets: full rank,
# rank-deficient (n < d) and rank-deficient with ~1e3 spread of scales.
FID_CASES = {
    "full_rank": (600, 500, 48, None),
    "rank_deficient": (40, 48, 64, None),
    "near_singular": (120, 150, 256, np.logspace(-1.5, 1.5, 256)),
}


def _eigh_fid64(mu1, s1, mu2, s2):
  """The eigh FID of the same float32 moments in float64."""
  s1, s2 = np.asarray(s1, np.float64), np.asarray(s2, np.float64)
  w, v = np.linalg.eigh(s1)
  half = (v * np.sqrt(np.clip(w, 0, None))) @ v.T
  inner = half @ s2 @ half
  w = np.linalg.eigvalsh(0.5 * (inner + inner.T))
  return (np.sum((np.asarray(mu1, np.float64) - mu2) ** 2) + np.trace(s1)
          + np.trace(s2) - 2 * np.sum(np.sqrt(np.clip(w, 0, None))))


@pytest.mark.parametrize("case", sorted(FID_CASES))
@pytest.mark.parametrize("method,iters", [("eigh", 20), ("ns", 40)])
def test_frechet_distance_matches_jax(case, method, iters):
  """Against the eigh FID of the same moments in float64: 'eigh' no
  further from it than JAX's, up to RTOL (the port takes the trace by
  singular values, where JAX takes eigenvalues of the inner form and
  squares its condition number: on the rank-deficient case the port is
  the nearer); 'ns', the same route in both, within RTOL
  of JAX or, where float32 itself loses more, within JAX's own distance
  from float64."""
  n1, n2, d, scales = FID_CASES[case]
  a, b = _moment_pair(len(case), n1, n2, d, scales)
  jm = [j_metrics.moments_from_activations(jnp.asarray(x)) for x in (a, b)]
  tm = [t_metrics.moments_from_activations(_t(x)) for x in (a, b)]
  want = j_metrics.fid_from_moments(*jm[0], *jm[1], method=method,
                                    num_iters=iters)
  got = t_metrics.fid_from_moments(*tm[0], *tm[1], method=method,
                                   num_iters=iters)
  ref = _eigh_fid64(*(np.asarray(x) for x in (*tm[0], *tm[1])))
  assert np.isfinite(got) and got > 0
  if method == "eigh":
    assert abs(got - ref) <= abs(want - ref) + RTOL * abs(want), (
        got, want, ref)
  else:
    assert abs(got - want) <= max(RTOL * abs(want), abs(want - ref)), (
        got, want, ref)


def test_frechet_distance_matches_scipy():
  """The reference's gates against float64 scipy: full rank (rtol 2e-3)
  and near-singular with eigh (1e-3) and ns (1e-2)."""
  a, b = _moment_pair(1, 600, 500, 48)
  m1, m2 = (t_metrics.moments_from_activations(_t(x)) for x in (a, b))
  ref = _scipy_fid(m1[0].numpy(), m1[1].numpy(), m2[0].numpy(),
                   m2[1].numpy())
  np.testing.assert_allclose(
      t_metrics.fid_from_moments(*m1, *m2, num_iters=30), ref, rtol=2e-3)
  n1, n2, d, scales = FID_CASES["near_singular"]
  a, b = _moment_pair(7, n1, n2, d, scales, shift=0.5)
  m1, m2 = (t_metrics.moments_from_activations(_t(x)) for x in (a, b))
  ref = _scipy_fid(m1[0].numpy(), m1[1].numpy(), m2[0].numpy(),
                   m2[1].numpy(), offset=1e-10)
  np.testing.assert_allclose(
      t_metrics.fid_from_moments(*m1, *m2, method="eigh"), ref, rtol=1e-3)
  np.testing.assert_allclose(
      t_metrics.fid_from_moments(*m1, *m2, method="ns", num_iters=40), ref,
      rtol=1e-2)


def test_frechet_distance_identical_and_bad_method():
  a = np.random.default_rng(0).standard_normal((400, 32)).astype(np.float32)
  mu, sig = t_metrics.moments_from_activations(_t(a))
  assert abs(t_metrics.fid_from_moments(mu, sig, mu, sig)) < 1e-2
  with pytest.raises(ValueError, match="'eigh' or 'ns'"):
    t_metrics.frechet_distance(mu, sig, mu, sig, method="sqrtm")


def test_metrics_restore_the_callers_tf32_settings():
  before = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = True
  try:
    with t_metrics.true_float32():
      assert not torch.backends.cuda.matmul.allow_tf32
      assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = before


@pytest.mark.parametrize("scaling", ["trace", "fro"])
def test_newton_schulz_sqrt_matches_jax(scaling):
  a = np.random.default_rng(5).standard_normal((64, 24)).astype(np.float32)
  cov = (a.T @ a / 64).astype(np.float32)
  want = np.asarray(j_whiten.newton_schulz_sqrt(
      jnp.asarray(cov), num_iters=20, eps=1e-6, scaling=scaling))
  got = t_whiten.newton_schulz_sqrt(_t(cov), num_iters=20, eps=1e-6,
                                    scaling=scaling).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
  np.testing.assert_allclose(got @ got, cov, atol=1e-4)


@pytest.mark.parametrize("side", [32, 48, 64, 400])
@pytest.mark.parametrize("channels", [1, 3])
def test_preprocess_matches_jax(side, channels):
  imgs = np.random.default_rng(side + channels).integers(
      0, 256, (2, side, side, channels), dtype=np.uint8)
  want = np.asarray(j_iv.preprocess(jnp.asarray(imgs)))
  got = t_iv.preprocess(torch.from_numpy(imgs))
  assert got.shape == (2, 3, 299, 299) and got.dtype == torch.float32
  np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                             atol=1e-6)


# --- the network -----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_net():
  """The flax InceptionV3, one jit of its apply, and variables of its
  structure filled from a numpy seed (BatchNorm statistics and affine
  away from their init, so the fold is exercised)."""
  model = j_iv.InceptionV3()
  shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, SIDE, SIDE, 3)))
  rng = np.random.default_rng(11)

  def fill(path, s):
    leaf = getattr(path[-1], "key", None)
    if leaf == "kernel":
      fan_in = int(np.prod(s.shape[:-1]))
      return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
          np.float32)
    if leaf in ("scale", "var"):
      return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
    return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

  variables = jax.tree_util.tree_map_with_path(fill, shapes)
  variables = {k: dict(v) for k, v in variables.items()}
  return model, variables, jax.jit(model.apply)


def _images(seed, n=2):
  return np.random.default_rng(seed).uniform(
      -1.0, 1.0, (n, SIDE, SIDE, 3)).astype(np.float32)


def _assert_net_close(net, jax_net, variables, x):
  _, _, apply = jax_net
  want = apply(variables, jnp.asarray(x))
  with torch.no_grad():
    got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
  for g, w, name in zip(got, want, ("pool", "logits")):
    w = np.asarray(w)
    assert g.shape == w.shape, name
    err = float(np.max(np.abs(g.numpy() - w)))
    assert err <= NET_RTOL * float(np.max(np.abs(w))), (name, err)


def test_inception_v3_matches_flax(jax_net):
  _, variables, _ = jax_net
  net = t_iv.load_state(t_iv.InceptionV3(),
                        weights.inception_from_jax(variables))
  _assert_net_close(net, jax_net, variables, _images(0))
  # The BatchNorms stay on their running statistics in train mode too.
  net.train()
  _assert_net_close(net, jax_net, variables, _images(1))


def test_inception_state_dict_is_torchvisions():
  sd = t_iv.InceptionV3().state_dict()
  assert len([k for k in sd if k.endswith(".conv.weight")]) == 94
  for key, shape in (("Conv2d_1a_3x3.conv.weight", (32, 3, 3, 3)),
                     ("Mixed_5b.branch1x1.conv.weight", (64, 192, 1, 1)),
                     ("Mixed_6b.branch7x7_2.conv.weight", (128, 128, 1, 7)),
                     ("Mixed_7c.branch_pool.bn.running_var", (192,)),
                     ("fc.weight", (1000, 2048)), ("fc.bias", (1000,))):
    assert tuple(sd[key].shape) == shape, key
  net = t_iv.init_params(3)
  w = net.Mixed_6e.branch7x7dbl_5.conv.weight
  assert torch.equal(w, t_iv.init_params(3).Mixed_6e.branch7x7dbl_5.conv
                     .weight)
  std = 1.0 / np.sqrt(192 * 7)
  assert 0.9 * std < float(w.detach().std()) < 1.1 * std
  assert float(w.detach().abs().max()) <= 2.0 * std / .87962566103423978 + 1e-6
  assert not net.training


def _torchvision_npz(variables, path):
  """A torchvision-layout npz of ``variables``, with the keys a real
  state_dict also has: AuxLogits.* and num_batches_tracked."""
  sd = weights.inception_from_jax(variables)
  sd["AuxLogits.conv0.conv.weight"] = np.zeros((128, 768, 1, 1), np.float32)
  sd["AuxLogits.fc.weight"] = np.zeros((1000, 768), np.float32)
  sd["Conv2d_1a_3x3.bn.num_batches_tracked"] = np.zeros((), np.int64)
  np.savez(path, **sd)
  return sd


def test_load_npz_matches_jax_loader(jax_net, tmp_path, monkeypatch):
  """One npz through both loaders: the same outputs. The JAX loader's
  random-init donor is swapped for the fixture's tree (same structure),
  which spares the test its 299x299 init."""
  model, variables, _ = jax_net
  path = tmp_path / "iv3.npz"
  _torchvision_npz(variables, path)
  monkeypatch.setattr(j_iv, "init_params", lambda rng=None: (model, {
      k: jax.tree_util.tree_map(np.zeros_like, v)
      for k, v in variables.items()}))
  _, j_loaded = j_iv.load_npz_params(str(path))
  net = t_iv.load_npz(str(path))
  assert not net.training
  _assert_net_close(net, jax_net, j_loaded, _images(2))


def test_load_npz_refusals(jax_net, tmp_path):
  _, variables, _ = jax_net
  sd = weights.inception_from_jax(variables)
  cases = {
      "unknown": ({**sd, "Mixed_9z.conv.weight": np.zeros(3, np.float32)},
                  KeyError, "unrecognized weight key Mixed_9z"),
      "shape": ({**sd, "fc.bias": np.zeros(999, np.float32)}, ValueError,
                r"fc.bias: \(999,\) != \(1000,\)"),
      "missing": ({k: v for k, v in sd.items() if k != "fc.weight"},
                  KeyError, "1 parameters and buffers unloaded"),
  }
  for name, (state, exc, match) in cases.items():
    path = tmp_path / f"{name}.npz"
    np.savez(path, **state)
    with pytest.raises(exc, match=match):
      t_iv.load_npz(str(path))
