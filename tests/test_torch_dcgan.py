"""The port's DCGAN and BatchNorm against the JAX package, float32.

BatchNorm 'b' (flax's conventions: biased fast variance, ra = m ra +
(1 - m) batch), the transposed conv of the DCGAN G, the DCGAN G and D
forward and backward, the weights bridge for their leaves, one outer step
of preset ``cifar10_wc_dcgan``'s shape, and standing statistics over 'b'
layers. Weights move across with ``wcgan_tpu_torch.weights`` after every
flax parameter is perturbed, so that identity and zero inits cannot hide a
wrong mapping. Tolerances and why:

- single layers: 1e-5 (float32, one reduction or product in another
  order);
- G and D forwards and parameter gradients: 1e-4 (15 Newton-Schulz
  iterations per WC layer, sums in another order);
- running statistics and SN vectors: 1e-5;
- one outer step: as ``tests/test_torch_step.py`` (metrics rtol 1e-4,
  Adam slots rtol 1e-3, params with Adam's sign bound);
- standing statistics: 1e-4, the JAX package's own (it inverts the EMA
  update, which scales float32 rounding by 1 / (1 - m)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from test_torch_conditional import (_assert_tree_close, _flat, _nchw, _nhwc,
                                    _param_grads, _perturb, check_adam_slots,
                                    check_metrics, check_params,
                                    check_running_state, one_step)
from wcgan_tpu.cli import run as jrun
from wcgan_tpu.models import layers as jlayers
from wcgan_tpu.models.discriminator import Discriminator as JD
from wcgan_tpu.models.discriminator import DiscriminatorConfig as JDCfg
from wcgan_tpu.models.discriminator import preset_filters as j_d_presets
from wcgan_tpu.models.generator import Generator as JG
from wcgan_tpu.models.generator import GeneratorConfig as JGCfg
from wcgan_tpu.models.generator import preset_filters as j_g_presets
from wcgan_tpu_torch import weights
from wcgan_tpu_torch.cli import run as trun
from wcgan_tpu_torch.models import layers as tlayers
from wcgan_tpu_torch.models.discriminator import (Discriminator,
                                                  DiscriminatorConfig)
from wcgan_tpu_torch.models.discriminator import preset_filters as d_presets
from wcgan_tpu_torch.models.generator import Generator, GeneratorConfig
from wcgan_tpu_torch.models.generator import preset_filters as g_presets

LAYER_ATOL = 1e-5
ATOL = 1e-4
STATE_ATOL = 1e-5
KEY = jax.random.PRNGKey(3)
G_KW = dict(arch="dcgan", z_dim=16, resolution=16, base_resolution=4,
            filters=(16, 8))
D_KW = dict(arch="dcgan", resolution=16, filters=(8, 16),
            downsample=(True, True))
# The code pairs of tests/test_models.py's DCGAN cases.
CODES = [("d", "uconv"), ("b", "s"), ("b", "uconv")]


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


# --- layers ------------------------------------------------------------------


@pytest.mark.parametrize("size", [4, 5])
def test_conv_transpose_matches_flax(size, rng):
  """flax's nn.ConvTranspose(k=4, s=2, 'SAME') against the port's, the
  kernel moved by the weights bridge (transposed and flipped)."""
  x = rng.standard_normal((2, size, size, 6)).astype(np.float32)
  jmod = fnn.ConvTranspose(5, (4, 4), strides=(2, 2), padding="SAME")
  params = _perturb(jmod.init(KEY, jnp.asarray(x))["params"], rng)
  out_j = jmod.apply({"params": params}, jnp.asarray(x))
  tmod = tlayers.ConvTranspose(6, 5, torch.Generator().manual_seed(0))
  # The bridge knows a transposed conv by its module name, flax's "deconv".
  sd = weights.state_dict_from_jax({"deconv": _np(params)}, {})
  tmod.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
  out_t = tmod(_nchw(x))
  assert out_t.shape == (2, 5, 2 * size, 2 * size)
  np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j),
                             atol=LAYER_ATOL)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_flax(train, rng):
  """NormLayer 'b' in train mode (batch statistics, then the running
  update at m = 0.99) and in eval mode (running statistics), on activations
  with a large mean so that the fast variance's cancellation shows."""
  c = 8
  x = (rng.standard_normal((4, 5, 5, c)) * 0.5 + 3.0).astype(np.float32)
  jmod = jlayers.NormLayer(code="b", momentum=0.99)
  stats = {"batch_stats": {"bn": {
      "mean": rng.standard_normal(c).astype(np.float32),
      "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}}}
  tmod = tlayers.NormLayer(c, "b", momentum=0.99)
  tmod.load_state_dict(weights.state_dict_from_jax({}, stats))
  if train:
    out_j, mut = jmod.apply({**stats}, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
  else:
    out_j, mut = jmod.apply({**stats}, jnp.asarray(x), train=False), stats
  out_t = tmod(_nchw(x), train=train, update_stats=True)
  assert out_t.dtype == torch.float32
  assert out_t.is_contiguous(memory_format=torch.channels_last)
  np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j), atol=1e-4)
  _, state_t = weights.to_jax(tmod)
  _assert_tree_close(state_t, mut, LAYER_ATOL)
  if not train:
    return
  # The running update is flax's: ra = m ra + (1 - m) biased batch var.
  x64 = x.reshape(-1, c).astype(np.float64)
  var = np.maximum((x64 ** 2).mean(0) - x64.mean(0) ** 2, 0.0)
  want = 0.99 * stats["batch_stats"]["bn"]["var"] + 0.01 * var
  np.testing.assert_allclose(tmod.bn.var.numpy(), want, atol=LAYER_ATOL)


def test_batchnorm_advances_only_with_update_stats(rng):
  tmod = tlayers.NormLayer(8, "b")
  x = _nchw(rng.standard_normal((2, 3, 3, 8)).astype(np.float32))
  before = {k: v.clone() for k, v in tmod.state_dict().items()}
  tmod(x, train=True, update_stats=False)
  tmod(x, train=False)
  for k, v in tmod.state_dict().items():
    assert torch.equal(v, before[k]), k
  tmod(x, train=True, update_stats=True)
  assert not torch.equal(tmod.bn.mean, before["bn.mean"])


def test_batchnorm_bf16_output_dtype(rng):
  """bf16 activations normalize in float32 and come back in bf16, as
  flax's BatchNorm with dtype=None returns the input's dtype."""
  tmod = tlayers.NormLayer(8, "b")
  x = _nchw(rng.standard_normal((2, 3, 3, 8)).astype(np.float32))
  out = tmod(x.to(torch.bfloat16), train=True)
  ref = tmod(x, train=True, update_stats=False)
  assert out.dtype == torch.bfloat16
  np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=3e-2)


# --- G and D -----------------------------------------------------------------


@pytest.mark.parametrize("norm,coloring", CODES)
def test_dcgan_generator_matches_jax(norm, coloring, rng):
  """Train-mode forward, the statistics it advances, the eval-mode forward
  on them, and the parameter gradient of a weighted sum of the images."""
  kw = dict(G_KW, block_norm=norm, block_coloring=coloring, last_norm=norm,
            last_coloring=coloring)
  jg = JG(cfg=JGCfg(**kw))
  z = rng.standard_normal((4, 16)).astype(np.float32)
  w = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
  variables = jg.init(KEY, jnp.asarray(z), train=True)
  params = _perturb(variables["params"], rng)
  state = {k: v for k, v in variables.items() if k != "params"}

  def f(p):
    out, mut = jg.apply({"params": p, **state}, jnp.asarray(z), train=True,
                        mutable=list(state))
    return jnp.sum(out * w), (out, mut)

  grads_j, (out_j, mut) = jax.grad(f, has_aux=True)(params)
  tg = Generator(GeneratorConfig(**kw), torch.Generator().manual_seed(0))
  tg.load_state_dict(weights.state_dict_from_jax(_np(params), _np(state)))
  out_t = tg(torch.from_numpy(z), train=True, update_stats=True)
  np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j), atol=ATOL)
  torch.sum(out_t.permute(0, 2, 3, 1) * torch.from_numpy(w)).backward()
  _assert_tree_close(_param_grads(tg), grads_j, ATOL, rtol=1e-4)
  _assert_tree_close(weights.to_jax(tg)[1], mut, STATE_ATOL)
  out_je = jg.apply({"params": params, **mut}, jnp.asarray(z), train=False)
  out_te = tg(torch.from_numpy(z), train=False)
  np.testing.assert_allclose(_nhwc(out_te), np.asarray(out_je), atol=ATOL)


@pytest.mark.parametrize("sn", [dict(spectral=True), dict(spectral=False),
                                dict(conv_singular=True),
                                dict(projection=True, num_classes=5)])
def test_dcgan_discriminator_matches_jax(sn, rng):
  """Scores (the NHWC flatten into ``fc_out``), the SN state one forward
  advances, and the parameter gradient of the scores' sum."""
  kw = dict(D_KW, **sn)
  x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
  labels = np.arange(4, dtype=np.int32) % 5
  y = jnp.asarray(labels) if sn.get("projection") else None
  jd = JD(cfg=JDCfg(**kw))
  variables = jd.init(KEY, jnp.asarray(x), y, train=True)
  params = _perturb(variables["params"], rng)
  state = {k: v for k, v in variables.items() if k != "params"}

  def f(p):
    (score, _), mut = jd.apply({"params": p, **state}, jnp.asarray(x), y,
                               train=True, update_sn=True,
                               mutable=list(state))
    return jnp.sum(score), (score, mut)

  grads_j, (score_j, mut) = jax.grad(f, has_aux=True)(params)
  td = Discriminator(DiscriminatorConfig(**kw),
                     torch.Generator().manual_seed(0))
  td.load_state_dict(weights.state_dict_from_jax(_np(params), _np(state)))
  score_t, logits = td(_nchw(x), None if y is None else
                       torch.from_numpy(labels), update_sn=True)
  assert logits is None
  np.testing.assert_allclose(score_t.detach().numpy(), np.asarray(score_j),
                             rtol=1e-4, atol=ATOL)
  torch.sum(score_t).backward()
  _assert_tree_close(_param_grads(td), grads_j, ATOL, rtol=1e-4)
  _assert_tree_close(weights.to_jax(td)[1], mut, STATE_ATOL)


def test_dcgan_discriminator_refuses_norm_accepts_remat():
  """As tests/test_models.py: the DCGAN D has no norm/coloring layers, so
  asking for them raises; remat is a no-op there and is accepted."""
  for kw in ({"norm": "d"}, {"coloring": "uconv"}, {"norm": "b"}):
    with pytest.raises(ValueError, match="dcgan"):
      DiscriminatorConfig(**D_KW, **kw)
  cfg = DiscriminatorConfig(**D_KW, remat=True)
  td = Discriminator(cfg, torch.Generator().manual_seed(0))
  x = torch.randn((2, 3, 16, 16)).to(memory_format=torch.channels_last)
  score, _ = td(x)
  assert score.shape == (2,)


def test_dcgan_generator_refuses_unknown_arch():
  with pytest.raises(ValueError, match="arch"):
    GeneratorConfig(arch="unet")


@pytest.mark.parametrize("arch", ["res", "dcgan"])
@pytest.mark.parametrize("res", [16, 32, 48, 64])
def test_preset_filters_match_jax(arch, res):
  assert g_presets(arch, res) == tuple(j_g_presets(arch, res))
  f_t, down_t = d_presets(arch, res)
  f_j, down_j = j_d_presets(arch, res)
  assert (tuple(f_t), tuple(down_t)) == (tuple(f_j), tuple(down_j))


# --- the weights bridge ------------------------------------------------------


def test_weights_round_trip_deconv_batch_stats_u_map(rng, tmp_path):
  """A DCGAN G with 'b' layers (deconv kernels, batch_stats) and a DCGAN D
  with conv_singular (u_map): flax -> port -> flax is the identity, and
  the weights-only npz goes both ways in the JAX package's keys."""
  kw = dict(G_KW, block_norm="b", block_coloring="s")
  jg = JG(cfg=JGCfg(**kw))
  jd = JD(cfg=JDCfg(**D_KW, conv_singular=True))
  gv = jg.init(KEY, jnp.zeros((2, 16)), train=True)
  dv = jd.init(KEY, jnp.zeros((2, 16, 16, 3)), train=True)
  gp, dp = _perturb(gv["params"], rng), _perturb(dv["params"], rng)
  gs = _perturb({k: v for k, v in gv.items() if k != "params"}, rng)
  ds = _perturb({k: v for k, v in dv.items() if k != "params"}, rng)
  assert set(gs) == {"batch_stats", "wc_stats"}
  assert "u_map" in str(jax.tree_util.tree_structure(ds))
  tg, td = weights.from_jax(_np(gp), _np(gs), _np(dp), _np(ds),
                            GeneratorConfig(**kw),
                            DiscriminatorConfig(**D_KW, conv_singular=True))
  assert tg.block0.deconv.weight.shape == (16, 16, 4, 4)
  assert td.block0.conv.u_map.shape == (1, 3, 16, 16)
  for module, params, state in ((tg, gp, gs), (td, dp, ds)):
    params_t, state_t = weights.to_jax(module)
    _assert_tree_close(params_t, params, 0.0)
    _assert_tree_close(state_t, state, 0.0)
    npz = weights.export_npz(module)
    want = {"/".join(f"[{k!r}]" for k in path): leaf
            for path, leaf in _flat(params).items()}
    assert npz.keys() == want.keys()
    for k in want:
      np.testing.assert_array_equal(npz[k], want[k], err_msg=k)
    fresh = type(module)(module.cfg, torch.Generator().manual_seed(9))
    weights.load_npz(fresh, want)
    for (n, a), (_, b) in zip(module.named_parameters(),
                              fresh.named_parameters()):
      assert torch.equal(a, b), n


# --- one outer step ----------------------------------------------------------

# Preset cifar10_wc_dcgan's shape at small width: DCGAN G with 'd'/'uconv'
# (or BatchNorm with 's' coloring), SN DCGAN D, ns loss, one D update.
# (one_step sets G's widths: 16, 16 from 4x4.)
STEPS = {
    "cifar10_wc_dcgan": (dict(arch="dcgan"), dict(D_KW), dict(loss="ns")),
    "dcgan_batchnorm": (dict(arch="dcgan", block_norm="b",
                             block_coloring="s", last_norm="b",
                             last_coloring="uconv"),
                        dict(D_KW), dict(loss="ns")),
}


@pytest.fixture(scope="module", params=sorted(STEPS))
def dcgan_step(request):
  return one_step(*STEPS[request.param], ratio=1)


def test_dcgan_step_metrics_match(dcgan_step):
  check_metrics(*dcgan_step)


@pytest.mark.parametrize("model", ["g", "d"])
def test_dcgan_step_adam_slots_match(model, dcgan_step):
  check_adam_slots(dcgan_step[0], dcgan_step[2], model)


@pytest.mark.parametrize("model", ["g", "d"])
def test_dcgan_step_params_match(model, dcgan_step):
  check_params(dcgan_step[0], dcgan_step[2], model, ratio=1)


@pytest.mark.parametrize("model", ["g", "d"])
def test_dcgan_step_running_state_matches(model, dcgan_step):
  check_running_state(dcgan_step[0], dcgan_step[2], model)


# --- standing statistics with 'b' layers -------------------------------------

FLAGS = ["--dataset", "synthetic", "--synthetic_size", "64", "--arch",
         "dcgan", "--generator_filters", "16,16", "--discriminator_filters",
         "16,16", "--batch_size", "8", "--training_ratio", "1", "--z_dim",
         "16", "--generator_block_norm", "b", "--generator_block_coloring",
         "s", "--generator_ema", "0.5", "--ema_standing_stats", "2",
         "--name", "b"]


def test_standing_stats_with_batchnorm_match_jax(tmp_path, rng):
  """The JAX Trainer and the port's, built from the same flags, with the
  same G, EMA shadow and live statistics: the standing statistics of the
  'b' layers (mean, biased variance) and of the WC layer ``nc_out``, and
  the live ones left as they were."""
  jt = jrun.build_experiment(jrun.build_parser().parse_args(FLAGS + [
      "--output_dir", str(tmp_path / "jax"), "--checkpoints_dir",
      str(tmp_path / "jck")]))
  tt = trun.build_experiment(trun.build_parser().parse_args(FLAGS + [
      "--device", "cpu", "--output_dir", str(tmp_path / "torch"),
      "--checkpoints_dir", str(tmp_path / "tck")]))
  g_params = _np(_perturb(jt.state.g_params, rng))
  g_state = _np(_perturb(jt.state.g_state, rng, 0.1))
  g_state["batch_stats"] = jax.tree_util.tree_map(np.abs,
                                                  g_state["batch_stats"])
  g_ema = _np(_perturb(g_params, rng))
  assert set(g_state) == {"batch_stats", "wc_stats"}
  jt.state = jt.state.replace(g_params=g_params, g_state=g_state,
                              g_ema=g_ema)
  tt.state.g.load_state_dict(weights.state_dict_from_jax(g_params, g_state))
  sd = weights.state_dict_from_jax(g_ema, {})
  with torch.no_grad():
    for name, t in tt.state.g_ema.items():
      t.copy_(sd[name])
  tt.state.g_version += 1
  standing_j = jt.standing_g_state(jt.state.g_ema, n_batches=2)
  want = weights.state_dict_from_jax({}, _np({
      k: standing_j[k] for k in ("batch_stats", "wc_stats")}))
  live = {k: v.clone() for k, v in tt.state.g.named_buffers()}
  got = tt.standing_g_state(tt.state.g_ema, n_batches=2)
  assert got.keys() == want.keys() == live.keys()
  assert sum(k.endswith(".var") for k in got) == 2
  for k in want:
    np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4,
                               atol=1e-4, err_msg=k)
    assert not torch.allclose(got[k], live[k]), k
  for k, v in tt.state.g.named_buffers():
    assert torch.equal(v, live[k]), k


def test_checkpoint_restores_batch_stats_and_u_map_bit_exact(tmp_path):
  """A DCGAN run with 'b' layers and conv_singular: the full state (the
  BatchNorms' mean/var, the WC layer's mean/cov, every u_map, the Adams)
  restores into a fresh trainer bit for bit, and one more outer step from
  each is the same bit for bit (the same float32 ops on the CPU)."""
  from test_torch_checkpoint import _assert_bit_equal
  flags = FLAGS + ["--device", "cpu", "--conv_singular", "--batches_per_epoch",
                   "2", "--steps_per_call", "1", "--display_ratio", "0",
                   "--number_of_epochs", "1", "--checkpoint_ratio", "1",
                   "--output_dir", str(tmp_path / "o"), "--checkpoints_dir",
                   str(tmp_path / "c")]
  a = trun.build_experiment(trun.build_parser().parse_args(flags))
  a.train()
  b = trun.build_experiment(trun.build_parser().parse_args(flags))
  b.restore_checkpoint(a.checkpoint_path(0))
  state = a.full_state()
  assert sum(k.endswith((".var", ".u_map")) for k in
             list(state["g"]) + list(state["d"])) == 2 + 2
  _assert_bit_equal(b.full_state(), state)
  for t in (a, b):
    t.step_fn(t.state, *t._device_data)
  _assert_bit_equal(b.full_state(), a.full_state())
