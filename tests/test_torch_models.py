"""The port's layers, blocks, G and D against the flax modules, float32.

Weights go across with ``wcgan_tpu_torch.weights``; every flax parameter
is first perturbed with noise so that identity/zero inits (Gamma = I,
beta = 0, biases) cannot hide a wrong mapping. Inputs are made with
numpy, NHWC for JAX and the same bytes as channels_last NCHW for torch.
Tolerance 1e-4 on activations and images (float32, sums taken in another
order, then 15 Newton-Schulz iterations); 1e-5 on the running statistics
and SN vectors, which average or normalize those differences away."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wcgan_tpu.models import blocks as jblocks
from wcgan_tpu.models import layers as jlayers
from wcgan_tpu.models.discriminator import Discriminator as JD
from wcgan_tpu.models.discriminator import DiscriminatorConfig as JDCfg
from wcgan_tpu.models.generator import Generator as JG
from wcgan_tpu.models.generator import GeneratorConfig as JGCfg
from wcgan_tpu_torch import weights
from wcgan_tpu_torch.models import blocks as tblocks
from wcgan_tpu_torch.models import generator as tgen
from wcgan_tpu_torch.models import layers as tlayers
from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
from wcgan_tpu_torch.models.generator import GeneratorConfig

ATOL = 1e-4
STATE_ATOL = 1e-5
KEY = jax.random.PRNGKey(3)


def _perturb(tree, rng, scale=0.05):
  return jax.tree_util.tree_map(
      lambda a: np.asarray(a) + scale * rng.standard_normal(
          np.shape(a)).astype(np.float32), tree)


def _nchw(x_nhwc):
  """The NHWC array's bytes as an NCHW channels_last tensor."""
  return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def _nhwc(t):
  return t.detach().permute(0, 2, 3, 1).float().numpy()


def _spd(rng, c):
  a = rng.standard_normal((c, 2 * c)).astype(np.float32)
  return (a @ a.T / (2 * c)).astype(np.float32)


def _assert_tree_close(torch_tree, jax_tree, atol):
  flat_t = dict(weights._flatten(torch_tree))
  flat_j = dict(weights._flatten(jax.tree_util.tree_map(np.asarray,
                                                        jax_tree)))
  assert flat_t.keys() == flat_j.keys()
  for k in flat_j:
    np.testing.assert_allclose(flat_t[k], flat_j[k], atol=atol,
                               err_msg="/".join(k))


@pytest.mark.parametrize("norm", ["d", "dr"])
def test_norm_color_matches_jax(norm, rng):
  c = 16
  x = (rng.standard_normal((4, 8, 8, c)) * 1.5 + 0.5).astype(np.float32)
  jmod = jlayers.NormColor(norm=norm, coloring="uconv")
  variables = jmod.init(KEY, jnp.asarray(x), train=True)
  params = _perturb(variables["params"], rng, 0.1)
  stats = {"wc_stats": {"mean": rng.standard_normal(c).astype(np.float32),
                        "cov": _spd(rng, c)}}
  out_j, mut = jmod.apply({"params": params, **stats}, jnp.asarray(x),
                          train=True, mutable=["wc_stats"])
  tmod = tlayers.NormColor(c, norm=norm)
  tmod.load_state_dict(weights.state_dict_from_jax(params, stats))
  out_t = tmod(_nchw(x), train=True, update_stats=True)
  np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j), atol=ATOL)
  _, state_t = weights.to_jax(tmod)
  _assert_tree_close(state_t, mut, STATE_ATOL)
  # Eval mode whitens from the (now advanced) running statistics.
  out_je = jmod.apply({"params": params, **mut}, jnp.asarray(x), train=False)
  out_te = tmod(_nchw(x), train=False)
  np.testing.assert_allclose(_nhwc(out_te), np.asarray(out_je), atol=ATOL)


def test_norm_color_rejects_unported_codes():
  """Every norm code of the JAX package is ported ('b', BatchNorm, with
  the DCGAN slice), with every coloring; a code the reference does not
  know is refused."""
  for norm, coloring in (("b", "uconv"), ("b", "ucconv"), ("b", "cconv-sa"),
                         ("b", "s")):
    nc = tlayers.NormColor(8, norm=norm, coloring=coloring, num_classes=3)
    assert isinstance(nc.norm.bn, tlayers.BatchNorm)
  for norm in ("x", "bn", "D"):
    with pytest.raises(ValueError, match="unknown norm code"):
      tlayers.NormColor(8, norm=norm, coloring="s")


def test_norm_color_rows_are_a_free_view(rng):
  x = _nchw(rng.standard_normal((2, 4, 4, 8)).astype(np.float32))
  assert tlayers._rows(x).data_ptr() == x.data_ptr()
  with pytest.raises(RuntimeError):
    tlayers._rows(x.contiguous())   # plain NCHW would need a copy


def test_gen_res_block_matches_jax(rng):
  x = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
  jmod = jblocks.GenResBlock(filters=16, upsample=True)
  variables = jmod.init(KEY, jnp.asarray(x), train=True)
  params = _perturb(variables["params"], rng)
  out_j, mut = jmod.apply({"params": params,
                           "wc_stats": variables["wc_stats"]},
                          jnp.asarray(x), train=True, mutable=["wc_stats"])
  tmod = tblocks.GenResBlock(8, 16, torch.Generator().manual_seed(0))
  tmod.load_state_dict(weights.state_dict_from_jax(
      params, {"wc_stats": variables["wc_stats"]}))
  out_t = tmod(_nchw(x), train=True, update_stats=True)
  assert out_t.is_contiguous(memory_format=torch.channels_last)
  np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j), atol=ATOL)
  _assert_tree_close(weights.to_jax(tmod)[1], mut, STATE_ATOL)


@pytest.mark.parametrize("kind,cin,filters,down", [
    ("opt", 3, 8, True), ("res", 8, 16, True), ("res", 16, 16, False)])
def test_disc_blocks_match_jax(kind, cin, filters, down, rng):
  x = rng.standard_normal((3, 8, 8, cin)).astype(np.float32)
  gen = torch.Generator().manual_seed(0)
  if kind == "opt":
    jmod = jblocks.DiscOptimizedBlock(filters=filters)
    tmod = tblocks.DiscOptimizedBlock(cin, filters, gen)
    call = dict()
  else:
    jmod = jblocks.DiscResBlock(filters=filters, downsample=down)
    tmod = tblocks.DiscResBlock(cin, filters, gen, downsample=down)
    call = dict(train=True)
  variables = jmod.init(KEY, jnp.asarray(x), **call)
  params = _perturb(variables["params"], rng)
  out_j, mut = jmod.apply({"params": params,
                           "spectral": variables["spectral"]},
                          jnp.asarray(x), update_sn=True,
                          mutable=["spectral"], **call)
  tmod.load_state_dict(weights.state_dict_from_jax(
      params, {"spectral": variables["spectral"]}))
  out_t = tmod(_nchw(x), update_sn=True)
  np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j), atol=ATOL)
  _assert_tree_close(weights.to_jax(tmod)[1], mut, STATE_ATOL)


def _torch_cfgs(dtype="float32"):
  return (GeneratorConfig(z_dim=16, resolution=32, base_resolution=4,
                          filters=(16, 16, 16), ns_iters=15, dtype=dtype),
          DiscriminatorConfig(resolution=32, filters=(16, 16, 16, 16),
                              downsample=(True, True, False, False),
                              dtype=dtype))


@pytest.fixture(scope="module")
def jax_models():
  """Flax G (16x3) and D (16x4) with perturbed weights, built once."""
  rng = np.random.default_rng(1)
  jg = JG(cfg=JGCfg(z_dim=16, resolution=32, base_resolution=4,
                    filters=(16, 16, 16), ns_iters=15))
  jd = JD(cfg=JDCfg(resolution=32, filters=(16, 16, 16, 16),
                    downsample=(True, True, False, False)))
  z = rng.standard_normal((4, 16)).astype(np.float32)
  x = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
  gv = jg.init(KEY, jnp.asarray(z), train=True)
  dv = jd.init(KEY, jnp.asarray(x), train=True)
  trees = (_perturb(gv["params"], rng), {"wc_stats": gv["wc_stats"]},
           _perturb(dv["params"], rng), {"spectral": dv["spectral"]})
  return jg, jd, trees, z, x


def test_generator_and_discriminator_match_jax(jax_models):
  jg, jd, trees, z, x = jax_models
  g_params, g_state, d_params, d_state = trees
  tg, td = weights.from_jax(*trees, *_torch_cfgs())
  img_j, g_mut = jg.apply({"params": g_params, **g_state}, jnp.asarray(z),
                          train=True, mutable=["wc_stats"])
  img_t = tg(torch.from_numpy(z), train=True, update_stats=True)
  assert img_t.dtype == torch.float32 and img_t.shape == (4, 3, 32, 32)
  np.testing.assert_allclose(_nhwc(img_t), np.asarray(img_j), atol=ATOL)
  _assert_tree_close(weights.to_jax(tg)[1], g_mut, STATE_ATOL)

  (score_j, _), d_mut = jd.apply({"params": d_params, **d_state},
                                 jnp.asarray(x), train=True, update_sn=True,
                                 mutable=["spectral"])
  score_t, logits_t = td(_nchw(x), update_sn=True)
  assert score_t.shape == (4,) and logits_t is None
  np.testing.assert_allclose(score_t.detach().numpy(), np.asarray(score_j),
                             rtol=1e-4, atol=ATOL)
  _assert_tree_close(weights.to_jax(td)[1], d_mut, STATE_ATOL)


def test_weights_round_trip(jax_models):
  g_params, g_state, d_params, d_state = jax_models[2]
  tg, td = weights.from_jax(*jax_models[2], *_torch_cfgs())
  for mod, params, state in ((tg, g_params, g_state),
                             (td, d_params, d_state)):
    params_t, state_t = weights.to_jax(mod)
    _assert_tree_close(params_t, params, 0.0)
    _assert_tree_close(state_t, state, 0.0)


def test_generator_eval_and_frozen_stats(jax_models):
  """update_stats=False leaves the running statistics; eval whitens from
  them, as the flax module without a mutable collection does."""
  jg, _, trees, z, _ = jax_models
  g_params, g_state = trees[:2]
  tg, _ = weights.from_jax(*trees, *_torch_cfgs())
  before = weights.to_jax(tg)[1]
  tg(torch.from_numpy(z), train=True, update_stats=False)
  _assert_tree_close(weights.to_jax(tg)[1], before, 0.0)
  img_j = jg.apply({"params": g_params, **g_state}, jnp.asarray(z),
                   train=False)
  img_t = tg(torch.from_numpy(z), train=False)
  np.testing.assert_allclose(_nhwc(img_t), np.asarray(img_j), atol=ATOL)


def test_bf16_generator_runs_in_bf16(jax_models):
  """bf16 compute: activations bf16, whitening stats float32, images
  float32; close to the float32 model within bf16 rounding."""
  _, _, trees, z, x = jax_models
  g16, d16 = weights.from_jax(*trees, *_torch_cfgs("bfloat16"))
  g32, _ = weights.from_jax(*trees, *_torch_cfgs())
  img16 = g16(torch.from_numpy(z))
  assert img16.dtype == torch.float32
  assert g16.nc_out.cov.dtype == torch.float32
  np.testing.assert_allclose(_nhwc(img16),
                             _nhwc(g32(torch.from_numpy(z))), atol=0.15)
  assert torch.isfinite(d16(_nchw(x))[0]).all()


@pytest.mark.parametrize("norm,coloring", [
    ("n", "n"), ("n", "s"), ("n", "uconv"), ("d", "n"), ("d", "s"),
    ("dr", "n"), ("dr", "s")])
def test_general_norm_color_codes_match_jax(norm, coloring, rng):
  """The general path (NormLayer, then Coloring) in train mode, with the
  running statistics it advances, then in eval mode on them."""
  c = 16
  x = (rng.standard_normal((4, 8, 8, c)) * 1.5 + 0.5).astype(np.float32)
  jmod = jlayers.NormColor(norm=norm, coloring=coloring)
  variables = jmod.init(KEY, jnp.asarray(x), train=True)
  params = _perturb(variables.get("params", {}), rng, 0.1)
  stats = {}
  if norm != "n":
    stats = {"wc_stats": {"norm": {"wc": {
        "mean": rng.standard_normal(c).astype(np.float32),
        "cov": _spd(rng, c)}}}}
  out_j, mut = jmod.apply({"params": params, **stats}, jnp.asarray(x),
                          train=True, mutable=["wc_stats"])
  tmod = tlayers.NormColor(c, norm=norm, coloring=coloring)
  tmod.load_state_dict(weights.state_dict_from_jax(params, stats))
  out_t = tmod(_nchw(x), train=True, update_stats=True)
  np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j), atol=ATOL)
  _, state_t = weights.to_jax(tmod)
  _assert_tree_close(state_t, dict(mut), STATE_ATOL)
  out_je = jmod.apply({"params": params, **mut}, jnp.asarray(x), train=False)
  out_te = tmod(_nchw(x), train=False)
  np.testing.assert_allclose(_nhwc(out_te), np.asarray(out_je), atol=ATOL)


@pytest.mark.parametrize("codes", [
    dict(block_norm="dr", block_coloring="s", last_norm="n",
         last_coloring="uconv"),
    dict(block_norm="d", block_coloring="n", last_norm="dr",
         last_coloring="s", ns_method="cholesky")])
def test_generator_general_codes_match_jax(codes, rng):
  """G with the general-path codes (and the Cholesky oracle), one train
  forward that advances the statistics, then an eval forward."""
  kw = dict(z_dim=16, resolution=16, base_resolution=4, filters=(16, 16),
            **codes)
  jg = JG(cfg=JGCfg(**kw))
  z = rng.standard_normal((4, 16)).astype(np.float32)
  gv = jg.init(KEY, jnp.asarray(z), train=True)
  params = _perturb(gv["params"], rng)
  img_j, mut = jg.apply({"params": params, "wc_stats": gv["wc_stats"]},
                        jnp.asarray(z), train=True, mutable=["wc_stats"])
  tg = weights.place(
      tgen.Generator(GeneratorConfig(**kw), torch.Generator().manual_seed(0)),
      "cpu")
  tg.load_state_dict(weights.state_dict_from_jax(
      params, {"wc_stats": gv["wc_stats"]}))
  img_t = tg(torch.from_numpy(z), train=True, update_stats=True)
  np.testing.assert_allclose(_nhwc(img_t), np.asarray(img_j), atol=ATOL)
  _assert_tree_close(weights.to_jax(tg)[1], mut, STATE_ATOL)
  img_je = jg.apply({"params": params, **mut}, jnp.asarray(z), train=False)
  img_te = tg(torch.from_numpy(z), train=False)
  np.testing.assert_allclose(_nhwc(img_te), np.asarray(img_je), atol=ATOL)


def test_bf16_generator_eval_matches_jax(rng):
  """bf16 G in eval mode on advanced running statistics against the flax
  G in bf16. Conv and dense layers add their bias after the product, in
  bf16, as flax does; with the bias fused into the product the images
  differed by up to 0.037 (ROADMAP queue 3). Now both round at the same
  places, so almost every pixel agrees to 1e-6 (the float32 tanh of the
  two libraries differs in its last bits); where a sum of products
  differs in its last bit, conv_out's bf16 output (|h| < 2) moves by one
  bf16 ulp, 2^-7, which tanh does not enlarge."""
  kw = dict(z_dim=16, resolution=32, base_resolution=4, filters=(16, 16, 16),
            dtype="bfloat16")
  jg = JG(cfg=JGCfg(**kw))
  z = rng.standard_normal((4, 16)).astype(np.float32)
  gv = jg.init(KEY, jnp.asarray(z), train=True)
  params = _perturb(gv["params"], rng)
  mut = {"wc_stats": gv["wc_stats"]}
  for _ in range(3):
    zs = rng.standard_normal((8, 16)).astype(np.float32)
    _, mut = jg.apply({"params": params, **mut}, jnp.asarray(zs),
                      train=True, mutable=["wc_stats"])
  img_j = np.asarray(jg.apply({"params": params, **mut}, jnp.asarray(z),
                              train=False))
  tg = weights.place(
      tgen.Generator(GeneratorConfig(**kw), torch.Generator().manual_seed(0)),
      "cpu")
  tg.load_state_dict(weights.state_dict_from_jax(params, mut))
  img_t = _nhwc(tg(torch.from_numpy(z), train=False))
  np.testing.assert_allclose(img_t, img_j, atol=2.0 ** -7)
  assert np.mean(np.abs(img_t - img_j) <= 1e-6) > 0.99
