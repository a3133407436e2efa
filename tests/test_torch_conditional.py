"""The port's class-conditional path against the JAX package, float32.

Layers, D heads and one outer step each of the conditional objectives,
then the sampling surfaces with labels. Weights move across with
``wcgan_tpu_torch.weights`` after every flax parameter is perturbed, so
that identity and zero inits cannot hide a wrong mapping; labels and
noise are replayed from the JAX key path (as ``test_torch_step.py``
does). Tolerances and why:

- activations, images and gradients: 1e-4 (float32, sums in another
  order, 15 Newton-Schulz iterations per WC layer);
- one outer step: losses and grad norms rtol 1e-4, Adam slots rtol 1e-3
  (atol 1e-5 of the largest slot), running statistics and SN vectors
  atol 1e-5, params as in ``test_torch_step.py``;
- uint8 images: equal, or off by one within 1e-4 of a rounding edge.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wcgan_tpu.cli import run as jrun
from wcgan_tpu.models import layers as jlayers
from wcgan_tpu.models.discriminator import Discriminator as JD
from wcgan_tpu.models.discriminator import DiscriminatorConfig as JDCfg
from wcgan_tpu.models.generator import Generator as JG
from wcgan_tpu.models.generator import GeneratorConfig as JGCfg
from wcgan_tpu.train import schedules as jschedules
from wcgan_tpu.train.state import create_state as jcreate_state
from wcgan_tpu.train.step import GANConfig as JGANConfig
from wcgan_tpu.train.step import make_jit_step
from wcgan_tpu_torch import weights
from wcgan_tpu_torch.cli import run as trun
from wcgan_tpu_torch.models import layers as tlayers
from wcgan_tpu_torch.models.discriminator import (Discriminator,
                                                  DiscriminatorConfig)
from wcgan_tpu_torch.models.generator import Generator, GeneratorConfig
from wcgan_tpu_torch.ops import cuda_wc
from wcgan_tpu_torch.train.state import OptimConfig, state_from_modules
from wcgan_tpu_torch.train.step import GANConfig, make_outer_step

ATOL = 1e-4
STATE_ATOL = 1e-5
LR = 2e-4
NC, K = 5, 3                  # classes, '-sa' basis filters
KEY = jax.random.PRNGKey(3)
COND_CODES = ("ccs", "ucs", "cconv", "ucconv", "cconv-sa", "ucconv-sa")
FUSED_CODES = ("cconv", "ucconv", "cconv-sa", "ucconv-sa")


def _perturb(tree, rng, scale=0.05):
  return jax.tree_util.tree_map(
      lambda a: np.asarray(a) + scale * rng.standard_normal(
          np.shape(a)).astype(np.float32), tree)


def _nchw(x_nhwc):
  """The NHWC array's bytes as an NCHW channels_last tensor."""
  return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def _nhwc(t):
  return t.detach().permute(0, 2, 3, 1).float().numpy()


def _flat(tree):
  return dict(weights._flatten(jax.tree_util.tree_map(np.asarray, tree)))


def _spd(rng, c):
  a = rng.standard_normal((c, 2 * c)).astype(np.float32)
  return (a @ a.T / (2 * c)).astype(np.float32)


def _assert_tree_close(got, want, atol, rtol=0.0):
  got, want = _flat(got), _flat(want)
  assert got.keys() == want.keys()
  for k in want:
    np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol,
                               err_msg="/".join(k))


def _param_grads(module):
  """The parameters' gradients in the flax layout (zeros where autograd
  found none: the JAX gradient of an unused parameter is zero)."""
  return weights.params_to_jax({
      n: p.grad if p.grad is not None else torch.zeros_like(p)
      for n, p in module.named_parameters()})


def _leaf_nhwc(x):
  """(leaf tensor in NHWC, its NCHW channels_last view)."""
  leaf = torch.from_numpy(x.copy()).requires_grad_(True)
  return leaf, leaf.permute(0, 3, 1, 2)


# --- coloring and the conditional WC layer ----------------------------------


@pytest.mark.parametrize("code", COND_CODES)
def test_conditional_coloring_matches_jax(code, rng):
  """Every conditional code of ``Coloring``: output, and the gradient of a
  weighted sum with respect to the parameters and the input."""
  x = rng.standard_normal((4, 3, 3, 8)).astype(np.float32)
  labels = np.array([0, 3, 1, 3], np.int32)
  w = rng.standard_normal(x.shape).astype(np.float32)
  jmod = jlayers.Coloring(code=code, num_classes=NC, filters_emb=K)
  params = _perturb(jmod.init(KEY, jnp.asarray(x), jnp.asarray(labels))[
      "params"], rng, 0.1)

  def f(p, xx):
    return jnp.sum(jmod.apply({"params": p}, xx, jnp.asarray(labels)) * w)

  out_j = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(labels))
  gp_j, gx_j = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
  tmod = tlayers.Coloring(8, code, NC, K)
  tmod.load_state_dict(weights.state_dict_from_jax(params, {}))
  leaf, xt = _leaf_nhwc(x)
  out_t = tmod(xt, torch.from_numpy(labels))
  np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j), atol=ATOL)
  torch.sum(out_t * _nchw(w)).backward()
  np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(gx_j), atol=ATOL)
  _assert_tree_close(_param_grads(tmod), gp_j, ATOL)


def test_conditional_coloring_needs_labels_and_classes():
  x = torch.zeros((2, 8, 2, 2)).to(memory_format=torch.channels_last)
  with pytest.raises(ValueError, match="requires labels"):
    tlayers.Coloring(8, "cconv", NC)(x)
  for code in COND_CODES:
    with pytest.raises(ValueError, match="num_classes"):
      tlayers.Coloring(8, code, 0)


@pytest.mark.parametrize("branch", ["S>=C", "S<C"])
@pytest.mark.parametrize("coloring", FUSED_CODES)
@pytest.mark.parametrize("norm", ["d", "dr"])
def test_fused_wc_cond_matches_jax(norm, coloring, branch, rng):
  """``_fused_wc_cond`` in train mode (output, the running statistics it
  advances, gradients) and then in eval mode on them, in both branches:
  16 rows per image for 8 channels (the per-image fold) and 4 rows for 16
  (two row passes; 16 images, so that the batch covariance is not
  singular)."""
  shape = (4, 4, 4, 8) if branch == "S>=C" else (16, 2, 2, 16)
  c = shape[-1]
  x = (rng.standard_normal(shape) * 1.5 + 0.5).astype(np.float32)
  labels = rng.integers(0, NC, shape[0]).astype(np.int32)
  w = rng.standard_normal(shape).astype(np.float32)
  jl = jnp.asarray(labels)
  jmod = jlayers.NormColor(norm=norm, coloring=coloring, num_classes=NC,
                           filters_emb=K)
  params = _perturb(jmod.init(KEY, jnp.asarray(x), jl, train=True)["params"],
                    rng, 0.1)
  stats = {"wc_stats": {"mean": rng.standard_normal(c).astype(np.float32),
                        "cov": _spd(rng, c)}}

  def f(p, xx):
    out, _ = jmod.apply({"params": p, **stats}, xx, jl, train=True,
                        mutable=["wc_stats"])
    return jnp.sum(out * w)

  out_j, mut = jmod.apply({"params": params, **stats}, jnp.asarray(x), jl,
                          train=True, mutable=["wc_stats"])
  gp_j, gx_j = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(x))
  tmod = tlayers.NormColor(c, norm=norm, coloring=coloring, num_classes=NC,
                           filters_emb=K)
  assert tmod.fused
  tmod.load_state_dict(weights.state_dict_from_jax(params, stats))
  leaf, xt = _leaf_nhwc(x)
  out_t = tmod(xt, torch.from_numpy(labels), train=True, update_stats=True)
  np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j), atol=ATOL)
  _assert_tree_close(weights.to_jax(tmod)[1], mut, STATE_ATOL)
  torch.sum(out_t * _nchw(w)).backward()
  np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(gx_j), atol=ATOL)
  _assert_tree_close(_param_grads(tmod), gp_j, ATOL)
  out_je = jmod.apply({"params": params, **mut}, jnp.asarray(x), jl,
                      train=False)
  out_te = tmod(_nchw(x), torch.from_numpy(labels), train=False)
  np.testing.assert_allclose(_nhwc(out_te), np.asarray(out_je), atol=ATOL)


def test_fused_wc_cond_bf16_rounds_like_jax(rng):
  """bf16 activations through both branches against the flax layer in
  bf16: the row passes round to bf16 at the same places, so the outputs
  agree to a bf16 ulp of their magnitude."""
  for shape in ((4, 4, 4, 8), (16, 2, 2, 16)):
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    labels = rng.integers(0, NC, shape[0]).astype(np.int32)
    jmod = jlayers.NormColor(norm="d", coloring="ucconv-sa", num_classes=NC,
                             filters_emb=K)
    xj = jnp.asarray(x, jnp.bfloat16)
    variables = jmod.init(KEY, xj, jnp.asarray(labels), train=True)
    params = _perturb(variables["params"], rng, 0.1)
    out_j, _ = jmod.apply({"params": params,
                           "wc_stats": variables["wc_stats"]}, xj,
                          jnp.asarray(labels), train=True,
                          mutable=["wc_stats"])
    tmod = tlayers.NormColor(c, norm="d", coloring="ucconv-sa",
                             num_classes=NC, filters_emb=K)
    tmod.load_state_dict(weights.state_dict_from_jax(
        params, {"wc_stats": variables["wc_stats"]}))
    out_t = tmod(_nchw(x).bfloat16(), torch.from_numpy(labels))
    assert out_t.dtype == torch.bfloat16
    got, want = _nhwc(out_t), np.asarray(out_j, np.float32)
    np.testing.assert_allclose(got, want,
                               atol=2.0 ** -7 * np.abs(want).max())


def test_kernel_eval_on_a_conditional_layer_raises_naming_it(monkeypatch):
  """K2 colors every row alike, so forcing it on a conditional WC layer
  raises (naming the layer) instead of taking the split path unseen; the
  layer still trains, and an unconditional layer still reaches K2."""
  calls = []
  real = cuda_wc.whiten_color_apply
  monkeypatch.setattr(cuda_wc, "whiten_color_apply",
                      lambda *a, **k: calls.append(1) or real(*a, **k))
  g = Generator(GeneratorConfig(z_dim=16, resolution=16, base_resolution=4,
                                filters=(16, 16), block_coloring="ucconv",
                                last_coloring="uconv", num_classes=NC,
                                kernel_eval=True),
                torch.Generator().manual_seed(0))
  z = torch.randn((4, 16))
  labels = torch.tensor([0, 1, 2, 3])
  g(z, labels, train=True)
  with pytest.raises(ValueError, match="block0.nc1"):
    g(z, labels, train=False)
  assert not calls
  g.nc_out(g.block1(g.block0(g.fc_in(z).view(4, 4, 4, 16).permute(
      0, 3, 1, 2).contiguous(memory_format=torch.channels_last), labels,
      train=True), labels, train=True), train=False)
  assert len(calls) == 1


# --- the discriminator's heads -----------------------------------------------


D_KW = dict(resolution=16, filters=(16, 16, 16),
            downsample=(True, True, False), num_classes=NC)


@pytest.mark.parametrize("heads", [
    dict(projection=True), dict(ac_gan=True),
    dict(projection=True, ac_gan=True, norm="d", coloring="ucconv"),
    dict(projection=True, coloring="cconv-sa", filters_emb=K)])
def test_discriminator_heads_match_jax(heads, rng):
  """Projection-D (SN embedding inner product), the AC-GAN head, and WC
  layers inside D: scores, class logits, the SN vectors and statistics
  the pass advances, and the parameter gradient of both outputs."""
  x = rng.uniform(-1, 1, (6, 16, 16, 3)).astype(np.float32)
  labels = rng.integers(0, NC, 6).astype(np.int32)
  jd = JD(cfg=JDCfg(**D_KW, **heads))
  variables = jd.init(KEY, jnp.asarray(x), jnp.asarray(labels), train=True)
  params = _perturb(variables["params"], rng)
  state = {k: v for k, v in variables.items() if k != "params"}
  colls = list(state)

  def f(p):
    (s, lg), _ = jd.apply({"params": p, **state}, jnp.asarray(x),
                          jnp.asarray(labels), train=True, update_sn=True,
                          mutable=colls)
    return jnp.sum(s) + (jnp.sum(lg * 0.1) if lg is not None else 0.0)

  (score_j, logits_j), mut = jd.apply(
      {"params": params, **state}, jnp.asarray(x), jnp.asarray(labels),
      train=True, update_sn=True, mutable=colls)
  grads_j = jax.grad(f)(params)
  td = Discriminator(DiscriminatorConfig(**D_KW, **heads),
                     torch.Generator().manual_seed(0))
  td.load_state_dict(weights.state_dict_from_jax(params, state))
  score_t, logits_t = td(_nchw(x), torch.from_numpy(labels), update_sn=True,
                         update_stats=True)
  np.testing.assert_allclose(score_t.detach().numpy(), np.asarray(score_j),
                             rtol=1e-4, atol=ATOL)
  if heads.get("ac_gan"):
    assert logits_t.shape == (6, NC)
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), rtol=1e-4, atol=ATOL)
  else:
    assert logits_t is None and logits_j is None
  _assert_tree_close(weights.to_jax(td)[1], mut, STATE_ATOL)
  loss = torch.sum(score_t) + (torch.sum(logits_t * 0.1)
                               if logits_t is not None else 0.0)
  loss.backward()
  _assert_tree_close(_param_grads(td), grads_j, ATOL, rtol=1e-4)


def test_projection_needs_labels():
  td = Discriminator(DiscriminatorConfig(**D_KW, projection=True),
                     torch.Generator().manual_seed(0))
  x = torch.zeros((2, 3, 16, 16)).to(memory_format=torch.channels_last)
  with pytest.raises(ValueError, match="needs labels"):
    td(x)


# --- one outer step -----------------------------------------------------------


def replay_jax_noise(state_rng, cfg: JGANConfig, b: int, axis_index=None):
  """Every draw of wcgan_tpu's outer_step for one call, as numpy arrays:
  z, labels and the penalty's eps per D update (``draw_fake_inputs``),
  z and labels of the G update, the flips. With ``axis_index``, the draws
  of that replica of the sharded step, which folds it into its key."""
  _, use_rng = jax.random.split(state_rng)
  if axis_index is not None:
    use_rng = jax.random.fold_in(use_rng, axis_index)
  noise = {k: [] for k in ("z_d", "y_d", "gp_eps")}
  for k in range(cfg.training_ratio):
    rz, ry, rgp = jax.random.split(jax.random.fold_in(use_rng, k), 3)
    noise["z_d"].append(jax.random.normal(rz, (b, cfg.z_dim), jnp.float32))
    noise["y_d"].append(jax.random.randint(ry, (b,), 0, cfg.num_classes,
                                           jnp.int32))
    noise["gp_eps"].append(jax.random.uniform(rgp, (b, 1, 1, 1),
                                              jnp.float32)[:, 0, 0, 0])
  noise = {k: np.stack([np.asarray(a) for a in v]) for k, v in noise.items()}
  g_batch = b * cfg.generator_batch_multiple
  rz, ry = jax.random.split(jax.random.fold_in(use_rng, cfg.training_ratio))
  noise["z_g"] = np.asarray(jax.random.normal(rz, (g_batch, cfg.z_dim),
                                              jnp.float32))
  noise["y_g"] = np.asarray(jax.random.randint(ry, (g_batch,), 0,
                                               cfg.num_classes, jnp.int32))
  noise["flip"] = np.asarray(jax.random.bernoulli(
      jax.random.fold_in(use_rng, cfg.training_ratio + 1), 0.5,
      (cfg.training_ratio, b, 1, 1, 1))).reshape(cfg.training_ratio, b)
  if not cfg.conditional:
    del noise["y_d"], noise["y_g"]
  if cfg.gradient_penalty_weight <= 0.0:
    del noise["gp_eps"]
  return noise


def one_step(g_kw, d_kw, gan_kw, ratio=2, b=4, res=16, seed=5):
  """One outer step of each package from the same perturbed weights, real
  images, labels and noise: (JAX state after, JAX metrics, port state
  after, port metrics)."""
  rng = np.random.default_rng(seed)
  num_classes = gan_kw.get("num_classes", 0)
  g_kw = dict(z_dim=16, resolution=res, base_resolution=4, filters=(16, 16),
              ns_iters=15, **g_kw)
  jg, jd = JG(cfg=JGCfg(**g_kw)), JD(cfg=JDCfg(**d_kw))
  gan_kw = dict(training_ratio=ratio, generator_batch_multiple=2, z_dim=16,
                random_flip=True, **gan_kw)
  jcfg = JGANConfig(**gan_kw)
  g_tx, d_tx = jschedules.adam(LR), jschedules.adam(LR)
  state = jcreate_state(jg, jd, g_tx, d_tx, jax.random.PRNGKey(11),
                        batch_size=b, z_dim=16, image_shape=(res, res, 3),
                        num_classes=num_classes)
  state = state.replace(g_params=_perturb(state.g_params, rng),
                        d_params=_perturb(state.d_params, rng))
  real = rng.integers(0, 256, (ratio, b, res, res, 3)).astype(np.uint8)
  labels = rng.integers(0, max(num_classes, 1), (ratio, b)).astype(np.int32)
  noise = replay_jax_noise(state.rng, jcfg, b)
  step_j = make_jit_step(jg, jd, g_tx, d_tx, jcfg, donate=False)
  new_j, metrics_j = step_j(state, jnp.asarray(real), jnp.asarray(labels))

  as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
  tg, td = weights.from_jax(as_np(state.g_params), as_np(state.g_state),
                            as_np(state.d_params), as_np(state.d_state),
                            GeneratorConfig(**g_kw),
                            DiscriminatorConfig(**d_kw))
  tstate = state_from_modules(tg, td, OptimConfig(), ratio,
                              torch.device("cpu"), seed=0)
  metrics_t = make_outer_step(GANConfig(**gan_kw))(tstate, real, labels,
                                                   noise=noise)
  return new_j, metrics_j, tstate, metrics_t


def check_metrics(new_j, metrics_j, tstate, metrics_t):
  assert tstate.step == 1
  assert set(metrics_t) == set(metrics_j)
  for k, v in metrics_j.items():
    assert np.isfinite(float(v)), k
    np.testing.assert_allclose(float(metrics_t[k]), float(v), rtol=1e-4,
                               err_msg=k)


def check_adam_slots(new_j, tstate, model):
  module = getattr(tstate, model)
  opt = getattr(tstate, f"{model}_opt")
  adam_j = getattr(new_j, f"{model}_opt")[0]
  for slot, slot_j in (("exp_avg", adam_j.mu), ("exp_avg_sq", adam_j.nu)):
    got = _flat(weights.params_to_jax(
        {n: opt.state[p][slot] for n, p in module.named_parameters()}))
    want = _flat(slot_j)
    assert got.keys() == want.keys()
    atol = 1e-5 * max(float(np.abs(v).max()) for v in want.values())
    for k in want:
      np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=atol,
                                 err_msg=f"{slot} {'/'.join(k)}")


def check_params(new_j, tstate, model, ratio=2):
  """Adam's first updates are ~lr * sign(g): where a gradient is rounding
  noise (zero in exact arithmetic, e.g. a conv bias in front of a
  whitening layer) its sign may flip. With beta1 = 0 the update t moves a
  parameter by at most lr * sqrt((1 - beta2^t) / (1 - beta2)), so the two
  sides by twice that. Elsewhere, |g| above 1e-5 of the model's largest
  (and 1e-6), params agree to lr * 1e-2."""
  updates = 1 if model == "g" else ratio
  adam_j = getattr(new_j, f"{model}_opt")[0]
  got = _flat(weights.to_jax(getattr(tstate, model))[0])
  want = _flat(getattr(new_j, f"{model}_params"))
  mu, nu = _flat(adam_j.mu), _flat(adam_j.nu)
  assert got.keys() == want.keys()
  floor = max(1e-6, 1e-5 * max(float(np.abs(v).max()) for v in mu.values()))
  bound = 2 * LR * sum(np.sqrt((1 - 0.9 ** t) / 0.1)
                       for t in range(1, updates + 1)) + 1e-7
  for k in want:
    diff = np.abs(got[k] - want[k])
    sure = (np.abs(mu[k]) > floor) & (np.sqrt(nu[k]) > floor)
    assert (diff[sure] <= LR * 1e-2).all(), ("/".join(k), diff[sure].max())
    assert (diff <= bound).all(), ("/".join(k), diff.max())


def check_running_state(new_j, tstate, model):
  got = weights.to_jax(getattr(tstate, model))[1]
  want = getattr(new_j, f"{model}_state")
  assert set(got) == set(want)
  for coll in want:
    _assert_tree_close(got[coll], want[coll], STATE_ATOL)


STEPS = {
    # cWC + projection-D, hinge (preset cifar10_cwc_resnet_proj's codes).
    "cwc_projection": (
        dict(block_coloring="ucconv", last_coloring="ucconv",
             num_classes=NC),
        dict(**D_KW, projection=True),
        dict(loss="hinge", gan_type="projection", num_classes=NC)),
    # cWC-sa (preset tiny_imagenet_cwcsa's codes) with the one-hot concat.
    "cwcsa_projection": (
        dict(block_coloring="ucconv-sa", last_coloring="cconv-sa",
             num_classes=NC, filters_emb=K, concat_cls=True),
        dict(**D_KW, projection=True),
        dict(loss="hinge", gan_type="projection", num_classes=NC)),
    # AC-GAN: aux cross-entropy on real logits (D) and fake logits (G).
    "acgan": (
        dict(block_coloring="cconv", last_coloring="ucs", last_norm="n",
             num_classes=NC),
        dict(**D_KW, ac_gan=True),
        dict(loss="ns", gan_type="acgan", num_classes=NC)),
}


@pytest.fixture(scope="module", params=sorted(STEPS))
def cond_step(request):
  return request.param, one_step(*STEPS[request.param])


def test_cond_step_metrics_match(cond_step):
  check_metrics(*cond_step[1])


@pytest.mark.parametrize("model", ["g", "d"])
def test_cond_step_adam_slots_match(model, cond_step):
  new_j, _, tstate, _ = cond_step[1]
  check_adam_slots(new_j, tstate, model)


@pytest.mark.parametrize("model", ["g", "d"])
def test_cond_step_params_match(model, cond_step):
  new_j, _, tstate, _ = cond_step[1]
  check_params(new_j, tstate, model)


@pytest.mark.parametrize("model", ["g", "d"])
def test_cond_step_running_state_matches(model, cond_step):
  new_j, _, tstate, _ = cond_step[1]
  check_running_state(new_j, tstate, model)


def test_conditional_noise_draws_keep_unconditional_streams():
  """Without injected noise the port draws z and the flips first, then the
  labels: a step that draws labels its modules do not read runs the
  unconditional step exactly (the same z into G, the same metrics)."""
  def run(num_classes):
    state = state_from_modules(
        Generator(GeneratorConfig(z_dim=8, resolution=16, base_resolution=4,
                                  filters=(8, 8)),
                  torch.Generator().manual_seed(0)),
        Discriminator(DiscriminatorConfig(**dict(D_KW, num_classes=0,
                                                 filters=(8, 8, 8))),
                      torch.Generator().manual_seed(0)),
        OptimConfig(), 2, torch.device("cpu"), seed=3)
    zs = []
    state.g.fc_in.register_forward_hook(
        lambda m, inputs, out: zs.append(inputs[0].clone()))
    metrics = make_outer_step(GANConfig(training_ratio=2, z_dim=8,
                                        random_flip=True,
                                        num_classes=num_classes))(
        state, np.full((2, 4, 16, 16, 3), 7, np.uint8),
        np.zeros((2, 4), np.int32))
    return zs, {k: float(v) for k, v in metrics.items()}

  (z_u, m_u), (z_c, m_c) = run(0), run(NC)
  assert len(z_u) == len(z_c) == 3
  assert all(torch.equal(a, b) for a, b in zip(z_u, z_c))
  assert m_u == m_c


# --- sampling with labels -------------------------------------------------------


FLAGS = ["--dataset", "synthetic", "--synthetic_size", "64", "--arch", "res",
         "--generator_filters", "16,16", "--discriminator_filters", "16,16",
         "--batch_size", "8", "--z_dim", "16", "--name", "c",
         "--conditional", "--gan_type", "PROJECTIVE",
         "--generator_block_coloring", "ucconv",
         "--generator_last_coloring", "ucconv-sa", "--filters_emb", "3"]


def _perturb_g(rng, g, params, g_state):
  """Perturbed G params, and running statistics set to the batch
  statistics of one labelled train-mode forward (momentum 0)."""
  params = _perturb(params, rng)
  g0 = g.clone(cfg=dataclasses.replace(g.cfg, wc_momentum=0.0))
  z = rng.standard_normal((64, g.cfg.z_dim)).astype(np.float32)
  y = rng.integers(0, g.cfg.num_classes, 64).astype(np.int32)
  _, g_state = g0.apply({"params": params, **g_state}, jnp.asarray(z),
                        jnp.asarray(y), train=True, mutable=["wc_stats"])
  return params, jax.tree_util.tree_map(np.asarray, dict(g_state))


@pytest.fixture(scope="module")
def cond_trainers(tmp_path_factory):
  """(JAX Trainer, port Trainer) built from the same conditional flags,
  with EMA weights, holding the same G (params, statistics, shadow) and D."""
  root = tmp_path_factory.mktemp("cond")
  ema = ["--generator_ema", "0.5", "--ema_standing_stats", "2"]
  jt = jrun.build_experiment(jrun.build_parser().parse_args(FLAGS + ema + [
      "--output_dir", str(root / "jax"), "--checkpoints_dir",
      str(root / "jax_ckpt")]))
  rng = np.random.default_rng(5)
  g_params, g_state = _perturb_g(rng, jt.g, jt.state.g_params,
                                 jt.state.g_state)
  g_ema = _perturb(g_params, rng)
  jt.state = jt.state.replace(g_params=g_params, g_state=g_state,
                              g_ema=g_ema)
  tt = trun.build_experiment(trun.build_parser().parse_args(FLAGS + ema + [
      "--device", "cpu", "--output_dir", str(root / "torch"),
      "--checkpoints_dir", str(root / "torch_ckpt")]))
  assert tt.gan_cfg.num_classes == jt.gan_cfg.num_classes == 10
  assert tt.cfg.name == "c"
  tt.state.g.load_state_dict(weights.state_dict_from_jax(g_params, g_state))
  tt.state.d.load_state_dict(weights.state_dict_from_jax(
      jt.state.d_params, jt.state.d_state))
  sd = weights.state_dict_from_jax(g_ema, {})
  with torch.no_grad():
    for name, t in tt.state.g_ema.items():
      t.copy_(sd[name])
  tt.state.g_version += 1
  return jt, tt


def _assert_u8_close(got, want, floats):
  got, want = np.asarray(got, np.int16), np.asarray(want, np.int16)
  assert got.shape == want.shape
  diff = np.abs(got - want)
  assert diff.max() <= 1
  v = np.clip(np.asarray(floats, np.float64), -1, 1) * 127.5 + 127.5
  edge = np.abs(v - np.round(v)) <= 1e-4 * 127.5
  assert np.all(edge[diff > 0]), np.argwhere((diff > 0) & ~edge)[:5]


def test_cond_standing_stats_match_jax(cond_trainers):
  """Standing statistics under the EMA params: z, then labels, per batch."""
  jt, tt = cond_trainers
  want = weights.state_dict_from_jax({}, {"wc_stats": jax.tree_util.tree_map(
      np.asarray, jt.standing_g_state(jt.state.g_ema, n_batches=2)[
          "wc_stats"])})
  got = tt.standing_g_state(tt.state.g_ema, n_batches=2)
  assert got.keys() == want.keys()
  for k in want:
    np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4,
                               atol=1e-4, err_msg=k)


def test_cond_sample_matches_jax(cond_trainers):
  jt, tt = cond_trainers
  z, labels = jt.ds.test_batch(8)
  assert labels.max() > 0
  img_j = np.asarray(jt._sample(jt.sampling_state(), jnp.asarray(z),
                                jnp.asarray(labels)))
  img_t = tt.sample(z, labels)
  np.testing.assert_allclose(img_t.numpy(), img_j, atol=ATOL)
  u8_j = np.asarray(jt._sample_u8(jt.sampling_state(), jnp.asarray(z),
                                  jnp.asarray(labels)))
  _assert_u8_close(tt.sample_u8(z, labels).numpy(), u8_j, img_j)
  # The labels matter.
  other = np.asarray(tt.sample(z, (labels + 1) % 10))
  assert np.abs(other - img_t.numpy()).max() > 1e-3
  with pytest.raises(ValueError, match="needs labels"):
    tt.sample(z)


def test_cond_generate_matches_jax(cond_trainers):
  """Full batches, each z then labels from the seeded numpy generator."""
  jt, tt = cond_trainers
  got_j = jt.generate(10, batch=4, rng_seed=7)
  got_t = tt.generate(10, batch=4, rng_seed=7)
  assert got_t.dtype == np.uint8 and got_t.shape == (10, 32, 32, 3)
  rng = np.random.default_rng(7)
  zs, ys = [], []
  for _ in range(3):
    zs.append(rng.standard_normal((4, 16)).astype(np.float32))
    ys.append(rng.integers(0, 10, 4).astype(np.int32))
  floats = tt.sample(np.concatenate(zs), np.concatenate(ys)).numpy()[:10]
  _assert_u8_close(got_t, got_j, floats)


def test_cond_save_sample_grid_matches_jax(cond_trainers):
  jt, tt = cond_trainers
  path_j, path_t = jt.save_sample_grid(3), tt.save_sample_grid(3)
  grid_j = np.asarray(Image.open(path_j))
  grid_t = np.asarray(Image.open(path_t))
  assert grid_t.shape == grid_j.shape == (256, 256, 3)
  z, labels = tt.ds.test_batch(64)
  imgs = tt.sample(z, labels).numpy()
  floats = imgs.reshape(8, 8, 32, 32, 3).transpose(0, 2, 1, 3, 4).reshape(
      256, 256, 3)
  _assert_u8_close(grid_t, grid_j, floats)


def _flat_params(module):
  return dict(weights._flatten(weights.to_jax(module)[0]))


def _assert_same(flat_a, flat_b):
  assert flat_a.keys() == flat_b.keys()
  for k in flat_a:
    np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=str(k))


def test_cond_npz_both_ways(cond_trainers, tmp_path):
  """The conditional leaves (gamma_c, basis, embedding, beta_c, gamma_a,
  beta_a; proj_emb's embedding) in the weights-only npz, each package's
  file loading in the other."""
  jt, tt = cond_trainers
  tt.export_weights(2)
  ckpt = os.path.join(tt.cfg.checkpoints_dir, "c")
  with np.load(os.path.join(ckpt, "epoch_2_generator.npz")) as data:
    keys = set(data)
  for leaf in ("gamma_c", "beta_c", "gamma_a", "beta_a"):
    assert f"['block0']/['nc1']/['{leaf}']" in keys
  for leaf in ("basis", "embedding", "beta_c"):
    assert f"['nc_out']/['{leaf}']" in keys
  for model, module, params in (("generator", tt.state.g, jt.state.g_params),
                                ("discriminator", tt.state.d,
                                 jt.state.d_params)):
    path = os.path.join(ckpt, f"epoch_2_{model}.npz")
    loaded = jrun._load_weights_npz(params, path, model=model)
    _assert_same(_flat(loaded), _flat_params(module))
  jt.export_weights(1)
  fresh = trun.build_experiment(trun.build_parser().parse_args(FLAGS + [
      "--device", "cpu", "--output_dir", str(tmp_path), "--seed", "9"]))
  assert "proj_emb" in dict(fresh.state.d.named_children())
  for model, module, params in (("generator", fresh.state.g,
                                 jt.state.g_params),
                                ("discriminator", fresh.state.d,
                                 jt.state.d_params)):
    trun._load_weights_npz(module, os.path.join(
        jt.ckpt_dir, f"epoch_1_{model}.npz"), model=model)
    _assert_same(_flat_params(module), _flat(params))


def test_cond_cli_phase_test_matches_jax_cli(cond_trainers, tmp_path):
  """``--phase test`` of a conditional run on a JAX-written npz: both
  sample the grid of the test labels with init statistics."""
  jt, _ = cond_trainers
  jt.export_weights(1)
  npz = os.path.join(jt.ckpt_dir, "epoch_1_generator.npz")
  test = ["--phase", "test", "--generator_checkpoint", npz,
          "--start_epoch", "4"]
  assert jrun.main(["--platform", "auto", *FLAGS, *test, "--output_dir",
                    str(tmp_path / "jax"), "--checkpoints_dir",
                    str(tmp_path / "ckpt")]) == 0
  assert trun.main([*FLAGS, *test, "--device", "cpu", "--output_dir",
                    str(tmp_path / "torch")]) == 0
  grid_j = np.asarray(Image.open(tmp_path / "jax" / "c" / "epoch_00004.png"))
  grid_t = np.asarray(Image.open(tmp_path / "torch" / "c" /
                                 "epoch_00004.png"))
  probe = trun.build_experiment(trun.build_parser().parse_args(FLAGS + [
      "--device", "cpu", "--output_dir", str(tmp_path / "probe")]))
  trun._load_weights_npz(probe.state.g, npz, model="generator")
  z, labels = probe.ds.test_batch(64)
  imgs = probe.state.g(torch.from_numpy(z), torch.from_numpy(labels),
                       train=False).permute(0, 2, 3, 1)
  floats = imgs.detach().numpy().reshape(8, 8, 32, 32, 3).transpose(
      0, 2, 1, 3, 4).reshape(256, 256, 3)
  _assert_u8_close(grid_t, grid_j, floats)


# --- the CLI and the live reconfiguration ----------------------------------------


def test_cli_takes_the_conditional_flags():
  """The flags of this slice parse to the JAX CLI's values and defaults,
  and none is refused any more."""
  argv = ["--conditional", "--generator_concat_cls", "--gan_type", "AC_GAN",
          "--loss", "wgan-gp", "--gradient_penalty_weight", "5.0",
          "--filters_emb", "4", "--discriminator_norm", "dr",
          "--discriminator_coloring", "cconv-sa", "--discriminator_spectral",
          "0", "--generator_block_coloring", "ucs",
          "--generator_last_coloring", "ucconv-sa"]
  trun._reject_unsupported(argv)
  got = vars(trun.build_parser().parse_args(argv))
  want = vars(jrun.build_parser().parse_args(argv))
  defaults_t = vars(trun.build_parser().parse_args([]))
  defaults_j = vars(jrun.build_parser().parse_args([]))
  for key in ("conditional", "generator_concat_cls", "gan_type", "loss",
              "gradient_penalty_weight", "filters_emb", "discriminator_norm",
              "discriminator_coloring", "discriminator_spectral",
              "generator_block_coloring", "generator_last_coloring"):
    assert got[key] == want[key], key
    assert defaults_t[key] == defaults_j[key], key


@pytest.mark.parametrize("gan_type,projection,ac_gan", [
    ("GAN", False, False), ("PROJECTIVE", True, False),
    ("AC_GAN", False, True)])
def test_cli_gan_type_builds_the_heads(gan_type, projection, ac_gan,
                                       tmp_path):
  """--gan_type PROJECTIVE / AC_GAN imply a conditional run (labelled
  dataset, G and D with its classes, the ``_cond`` name suffix)."""
  args = trun.build_parser().parse_args(
      FLAGS[:FLAGS.index("--name")] + ["--gan_type", gan_type, "--device",
                                       "cpu", "--output_dir", str(tmp_path)])
  tt = trun.build_experiment(args)
  d_cfg = tt.state.d.cfg
  assert (d_cfg.projection, d_cfg.ac_gan) == (projection, ac_gan)
  conditional = gan_type != "GAN"
  assert tt.gan_cfg.conditional == conditional
  assert tt.state.g.cfg.num_classes == (10 if conditional else 0)
  assert tt.cfg.name.endswith("_cond") == conditional


def test_reconfigure_covers_conditional_layers():
  """Generator.reconfigure demotes 'dr' -> 'd' and changes ns_iters on the
  conditional WC layers too; the result computes as a G built so."""
  kw = dict(z_dim=16, resolution=16, base_resolution=4, filters=(16, 16),
            block_norm="dr", block_coloring="ucconv-sa", last_norm="dr",
            last_coloring="cconv", num_classes=NC, filters_emb=K,
            ns_iters=6)
  g = Generator(GeneratorConfig(**kw), torch.Generator().manual_seed(0))
  g.reconfigure(block_norm="d", last_norm="d", ns_iters=12)
  want = Generator(GeneratorConfig(**dict(kw, block_norm="d", last_norm="d",
                                          ns_iters=12)),
                   torch.Generator().manual_seed(0))
  want.load_state_dict(g.state_dict())
  for m in g.modules():
    if isinstance(m, tlayers.NormColor):
      assert m.fused and m.norm_code == "d" and m.ns_iters == 12
  z, labels = torch.randn((4, 16)), torch.tensor([0, 1, 2, 4])
  torch.testing.assert_close(g(z, labels, update_stats=False),
                             want(z, labels, update_stats=False), rtol=0,
                             atol=0)
