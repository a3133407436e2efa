"""WGAN-GP and WC layers inside D, against the JAX package, float32.

The gradient penalty differentiates D's input gradient with respect to
D's parameters. With ``--discriminator_norm d`` that gradient runs through
the moments' backward (``cuda_wc.MomentsFn``), so the penalty's parameter
gradient is a second derivative through it. Tolerances:

- ``MomentsFn``'s double backward against plain autograd over the same
  two-pass formula: rtol 1e-4 (float32, the same products in another
  order);
- the penalty against the JAX package: rtol 1e-4; its parameter gradient
  (a second derivative through every layer of D) rtol 1e-4 plus an atol
  of 1e-5 of the largest entry of any tensor, as the Adam slots of
  ``test_torch_step.py``: the gradient of a conv bias in front of a
  whitening layer is zero in exact arithmetic and holds only the float32
  rounding of the large entries, on both sides;
- one outer step: as ``test_torch_step.py`` (losses rtol 1e-4, Adam slots
  rtol 1e-3, running state atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_conditional import (D_KW, NC, _flat, _nchw, _param_grads,
                                    _perturb, check_adam_slots,
                                    check_metrics, check_params,
                                    check_running_state, one_step)
from wcgan_tpu.cli import run as jrun
from wcgan_tpu.models.discriminator import Discriminator as JD
from wcgan_tpu.models.discriminator import DiscriminatorConfig as JDCfg
from wcgan_tpu.ops import losses as jlosses
from wcgan_tpu_torch import weights
from wcgan_tpu_torch.cli import run as trun
from wcgan_tpu_torch.models.discriminator import (Discriminator,
                                                  DiscriminatorConfig)
from wcgan_tpu_torch.ops import cuda_wc
from wcgan_tpu_torch.ops import losses as tlosses

KEY = jax.random.PRNGKey(3)


# --- K1's second derivative ----------------------------------------------------


def _grad_norm_grad(moments, x, w):
  """d/dx of ||d f / d x||^2 with f = <cov, W> + |mean|^2, through
  ``moments``: a gradient of a gradient, as the penalty takes it."""
  xg = x.clone().requires_grad_(True)
  mean, cov = moments(xg)
  f = torch.sum(cov * w) + torch.sum(mean ** 2)
  g, = torch.autograd.grad(f, xg, create_graph=True)
  h = torch.sum(g ** 2)
  hx, = torch.autograd.grad(h, xg)
  return g.detach(), h.detach(), hx


@pytest.mark.parametrize("rows,cols,loc", [(64, 8, 0.0), (300, 16, 3.0),
                                           (1000, 32, -2.0)])
def test_moments_double_backward_matches_plain_autograd(rows, cols, loc,
                                                        rng):
  x = torch.from_numpy((rng.standard_normal((rows, cols)) * 1.5 + loc)
                       .astype(np.float32))
  w = torch.from_numpy(rng.standard_normal((cols, cols)).astype(np.float32))
  got = _grad_norm_grad(cuda_wc.moments, x, w)
  want = _grad_norm_grad(cuda_wc.moments_reference, x, w)
  for a, b in zip(got, want):
    scale = float(b.abs().max())
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                               atol=1e-6 * scale)


def test_moments_double_backward_through_a_wc_layer(rng):
  """The same through a whole train-mode WC layer (moments, Newton-Schulz,
  the fused fold) with K1's wrapper and with plain moments."""
  from wcgan_tpu_torch.models import layers as tlayers
  x = rng.standard_normal((8, 4, 4, 8)).astype(np.float32)
  outs = []
  for use_kernel in (True, False):
    layer = tlayers.NormColor(8, use_kernel=use_kernel)
    with torch.no_grad():
      layer.gamma.add_(0.1 * torch.from_numpy(
          np.random.default_rng(1).standard_normal((8, 8)).astype(
              np.float32)))
    leaf = torch.from_numpy(x.copy()).requires_grad_(True)
    out = layer(leaf.permute(0, 3, 1, 2), update_stats=False)
    g, = torch.autograd.grad(torch.sum(torch.sin(out)), leaf,
                             create_graph=True)
    penalty = torch.sum(g ** 2)
    grads = torch.autograd.grad(penalty, [leaf] + list(layer.parameters()))
    outs.append([penalty.detach()] + [t.detach() for t in grads])
  for a, b in zip(*outs):
    scale = float(b.abs().max())
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                               atol=1e-5 * scale)


# --- the penalty -----------------------------------------------------------------


@pytest.mark.parametrize("norm", ["n", "d"])
def test_gradient_penalty_matches_jax(norm, rng):
  """The penalty on interpolates of a D with and without WC layers, and its
  gradient with respect to D's parameters."""
  kw = dict(D_KW, projection=True, norm=norm)
  x = rng.uniform(-1, 1, (6, 16, 16, 3)).astype(np.float32)
  fake = rng.uniform(-1, 1, (6, 16, 16, 3)).astype(np.float32)
  labels = rng.integers(0, NC, 6).astype(np.int32)
  # The eps the JAX penalty draws from KEY.
  eps = np.array(jax.random.uniform(KEY, (6, 1, 1, 1), jnp.float32))[
      :, 0, 0, 0]
  jd = JD(cfg=JDCfg(**kw))
  variables = jd.init(KEY, jnp.asarray(x), jnp.asarray(labels), train=True)
  params = _perturb(variables["params"], rng)
  state = {k: v for k, v in variables.items() if k != "params"}

  def penalty_j(p):
    def d_apply(xi):
      (s, _), _ = jd.apply({"params": p, **state}, xi, jnp.asarray(labels),
                           train=True, mutable=list(state))
      return s
    return jlosses.gradient_penalty(d_apply, jnp.asarray(x),
                                    jnp.asarray(fake), KEY, weight=10.0)

  gp_j = penalty_j(params)
  grads_j = jax.grad(penalty_j)(params)
  td = Discriminator(DiscriminatorConfig(**kw),
                     torch.Generator().manual_seed(0))
  td.load_state_dict(weights.state_dict_from_jax(params, state))
  lt = torch.from_numpy(labels)
  gp_t = tlosses.gradient_penalty(lambda xi: td(xi, lt)[0], _nchw(x),
                                  _nchw(fake), torch.from_numpy(eps),
                                  weight=10.0)
  np.testing.assert_allclose(gp_t.item(), float(gp_j), rtol=1e-4)
  gp_t.backward()
  got, want = _flat(_param_grads(td)), _flat(grads_j)
  assert got.keys() == want.keys()
  atol = 1e-5 * max(float(np.abs(v).max()) for v in want.values())
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=atol,
                               err_msg="/".join(k))


def test_ac_gan_aux_loss_matches_jax(rng):
  logits = rng.standard_normal((7, NC)).astype(np.float32) * 3
  labels = rng.integers(0, NC, 7).astype(np.int32)
  want = jlosses.ac_gan_aux_loss(jnp.asarray(logits), jnp.asarray(labels))
  got = tlosses.ac_gan_aux_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels))
  np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
  assert tlosses.get_losses("wgan-gp") == (tlosses.wgan_d_loss,
                                           tlosses.wgan_g_loss)


# --- one WGAN-GP outer step ----------------------------------------------------


GP_STEPS = {
    # WC in D with the penalty: D scores real, fake and interpolates apart,
    # the penalty differentiates through K1's backward twice. cWC G and
    # projection-D, as the full-width model of chip_smoke.py's gp-dnorm.
    "dnorm_projection": (
        dict(block_coloring="ucconv", last_coloring="ucconv",
             num_classes=NC),
        dict(D_KW, projection=True, norm="d"),
        dict(loss="wgan-gp", gan_type="projection", num_classes=NC,
             gradient_penalty_weight=10.0)),
    # Unconditional, D without WC layers (one concatenated real+fake pass)
    # and without spectral normalization.
    "plain_d": (
        dict(),
        dict(D_KW, num_classes=0, spectral=False),
        dict(loss="wgan-gp", gradient_penalty_weight=10.0)),
}


@pytest.fixture(scope="module", params=sorted(GP_STEPS))
def gp_step(request):
  return request.param, one_step(*GP_STEPS[request.param])


def test_gp_step_metrics_match(gp_step):
  check_metrics(*gp_step[1])


@pytest.mark.parametrize("model", ["g", "d"])
def test_gp_step_adam_slots_match(model, gp_step):
  new_j, _, tstate, _ = gp_step[1]
  check_adam_slots(new_j, tstate, model)


@pytest.mark.parametrize("model", ["g", "d"])
def test_gp_step_params_match(model, gp_step):
  new_j, _, tstate, _ = gp_step[1]
  check_params(new_j, tstate, model)


@pytest.mark.parametrize("model", ["g", "d"])
def test_gp_step_running_state_matches(model, gp_step):
  new_j, _, tstate, _ = gp_step[1]
  check_running_state(new_j, tstate, model)


def test_gp_step_launches_k1_on_every_d_pass(monkeypatch):
  """With WC in D, each D update whitens the real, fake and interpolated
  batches apart (three D passes) and the G update scores its fakes once:
  at this size (G 16x2: 5 WC layers; D 16x3: 4) 2 x (5 + 3 x 4) + 5 + 4
  = 43 moments calls, every one through K1's wrapper; the full-width
  count is chip_smoke.py's 138."""
  calls = []
  real = cuda_wc.moments
  monkeypatch.setattr(cuda_wc, "moments",
                      lambda x: calls.append(x.shape) or real(x))
  g_kw, d_kw, gan_kw = GP_STEPS["dnorm_projection"]
  from wcgan_tpu_torch.models.generator import Generator, GeneratorConfig
  from wcgan_tpu_torch.train.state import OptimConfig, state_from_modules
  from wcgan_tpu_torch.train.step import GANConfig, make_outer_step
  g_cfg = GeneratorConfig(z_dim=16, resolution=16, base_resolution=4,
                          filters=(16, 16), use_kernel=True, **g_kw)
  d_cfg = DiscriminatorConfig(**dict(d_kw, use_kernel=True))
  state = state_from_modules(
      Generator(g_cfg, torch.Generator().manual_seed(0)),
      Discriminator(d_cfg, torch.Generator().manual_seed(1)), OptimConfig(),
      2, torch.device("cpu"), seed=0)
  metrics = make_outer_step(GANConfig(training_ratio=2, z_dim=16,
                                      **gan_kw))(
      state, np.zeros((2, 4, 16, 16, 3), np.uint8),
      np.zeros((2, 4), np.int32))
  g_layers, d_layers = 5, 2 * (len(d_cfg.filters) - 1)
  assert len(calls) == 2 * (g_layers + 3 * d_layers) + g_layers + d_layers
  assert all(np.isfinite(float(v)) for v in metrics.values())


# --- --discriminator_spectral --------------------------------------------------


FLAGS = ["--dataset", "synthetic", "--synthetic_size", "64", "--arch", "res",
         "--generator_filters", "16,16", "--discriminator_filters", "16,16",
         "--batch_size", "8", "--z_dim", "16", "--name", "s"]


@pytest.mark.parametrize("spectral", ["0", "1"])
def test_discriminator_spectral_matches_jax(spectral, tmp_path):
  """``--discriminator_spectral 0`` builds the plain conv/dense D (flax's
  ``Conv``/``Dense`` wrappers, submodules ``conv``/``dense``), 1 (the
  default, which preset stl10_wc_resnet_sn passes) the SN D; both score
  like the JAX CLI's D on the same weights."""
  flags = FLAGS + ["--discriminator_spectral", spectral]
  trun._reject_unsupported(flags)
  jt = jrun.build_experiment(jrun.build_parser().parse_args(flags + [
      "--output_dir", str(tmp_path / "j"), "--checkpoints_dir",
      str(tmp_path / "jc")]))
  tt = trun.build_experiment(trun.build_parser().parse_args(flags + [
      "--device", "cpu", "--output_dir", str(tmp_path / "t")]))
  assert tt.state.d.cfg.spectral == (spectral == "1")
  rng = np.random.default_rng(2)
  d_params = _perturb(jt.state.d_params, rng)
  names = {n for n, _ in tt.state.d.named_parameters()}
  assert ("block0.conv1.conv.weight" in names) == (spectral == "0")
  assert ("fc_out.dense.weight" in names) == (spectral == "0")
  tt.state.d.load_state_dict(weights.state_dict_from_jax(
      d_params, jt.state.d_state))
  x = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
  (score_j, _), _ = jt.d.apply({"params": d_params, **jt.state.d_state},
                               jnp.asarray(x), train=True, update_sn=True,
                               mutable=list(jt.state.d_state))
  score_t, logits_t = tt.state.d(_nchw(x), update_sn=True)
  assert logits_t is None
  np.testing.assert_allclose(score_t.detach().numpy(), np.asarray(score_j),
                             rtol=1e-4, atol=1e-4)
