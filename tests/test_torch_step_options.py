"""The outer step's options and the SN options against the JAX package.

``batched_fake_gen``, ``d_fake_stats='running'``, ``sn_update_on_g_step``,
``remat`` and ``conv_singular``: one outer step each of the port and of
``wcgan_tpu/train/step.py`` from the same perturbed weights, images and
noise (``test_torch_conditional.one_step``), with that module's gates
(metrics rtol 1e-4, Adam slots rtol 1e-3, params with Adam's sign bound,
running statistics and SN state atol 1e-5). ``conv_power_iteration``
against ``wcgan_tpu/ops/sn.py``'s at 1e-5 (sigma rtol 1e-5; float32, the
same products in another order). ``remat`` is also held against the same
step without it in the port, bit for bit (the recomputation repeats the
forward exactly on the CPU), with the running statistics advanced once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_conditional import (check_adam_slots, check_metrics,
                                    check_params, check_running_state,
                                    one_step)
from test_torch_trainer import _plant_ill_conditioned_cov, _port, _log, GUARD
from wcgan_tpu.ops import sn as jsn
from wcgan_tpu.train.step import GANConfig as JGANConfig
from wcgan_tpu.train.step import make_outer_step as jmake_outer_step
from wcgan_tpu_torch.models import layers as tlayers
from wcgan_tpu_torch.ops import sn as tsn
from wcgan_tpu_torch.ops import whiten as whiten_ops
from wcgan_tpu_torch.train.state import create_state, OptimConfig
from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
from wcgan_tpu_torch.models.generator import GeneratorConfig
from wcgan_tpu_torch.train.step import GANConfig, make_outer_step

D_KW = dict(resolution=16, filters=(16, 16, 16),
            downsample=(True, True, False))

# --- conv_singular's power iteration ------------------------------------------


@pytest.mark.parametrize("size,k,stride,cin,cout", [
    (16, 3, 1, 4, 8), (8, 1, 1, 6, 5), (16, 4, 2, 3, 8),
    (7, 4, 2, 3, 5),              # 'SAME' pads (1, 2): asymmetric
    (5, 4, 1, 2, 3)])
@pytest.mark.parametrize("n_iters", [1, 3])
def test_conv_power_iteration_matches_jax(size, k, stride, cin, cout,
                                          n_iters, rng):
  kernel = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
  u_map = rng.standard_normal((1, size, size, cin)).astype(np.float32)
  sigma_j, u_j = jsn.conv_power_iteration(
      jnp.asarray(kernel), jnp.asarray(u_map), strides=(stride, stride),
      n_iters=n_iters)
  weight = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
  sigma_t, u_t = tsn.conv_power_iteration(
      weight, torch.from_numpy(u_map).permute(0, 3, 1, 2), stride, n_iters)
  np.testing.assert_allclose(float(sigma_t), float(sigma_j), rtol=1e-5)
  np.testing.assert_allclose(u_t.permute(0, 2, 3, 1).numpy(),
                             np.asarray(u_j), atol=1e-5)


@pytest.mark.parametrize("fully_diff", [False, True])
def test_conv_power_iteration_gradient_matches_jax(fully_diff, rng):
  """d sigma / d kernel, with u held constant or (``fully_diff``)
  differentiated through the iteration."""
  kernel = rng.standard_normal((4, 4, 3, 6)).astype(np.float32)
  u_map = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
  grad_j = jax.grad(lambda kk: jsn.conv_power_iteration(
      kk, jnp.asarray(u_map), strides=(2, 2), n_iters=2,
      fully_diff=fully_diff)[0])(jnp.asarray(kernel))
  weight = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
  weight.requires_grad_(True)
  sigma, _ = tsn.conv_power_iteration(
      weight, torch.from_numpy(u_map).permute(0, 3, 1, 2), 2, 2,
      fully_diff=fully_diff)
  sigma.backward()
  np.testing.assert_allclose(weight.grad.numpy().transpose(2, 3, 1, 0),
                             np.asarray(grad_j), atol=1e-5)


def test_conv_power_iteration_needs_an_iteration():
  with pytest.raises(ValueError, match="n_iters >= 1"):
    tsn.conv_power_iteration(torch.ones((2, 2, 3, 3)),
                             torch.ones((1, 2, 4, 4)), n_iters=0)


@pytest.mark.parametrize("size,k,stride", [(8, 3, 1), (8, 4, 2), (7, 4, 2),
                                           (5, 4, 1)])
def test_conv_same_transpose_is_the_adjoint(size, k, stride, rng):
  """<conv(x), y> == <x, conv^T(y)> for the 'SAME' conv and its transpose."""
  x = torch.from_numpy(rng.standard_normal((1, 3, size, size)))
  w = torch.from_numpy(rng.standard_normal((5, 3, k, k)))
  y = torch.from_numpy(rng.standard_normal(
      tuple(tsn.conv2d_same(x, w, stride).shape)))
  lhs = torch.sum(tsn.conv2d_same(x, w, stride) * y)
  rhs = torch.sum(x * tsn.conv2d_same_transpose(y, w, stride, (size, size)))
  np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-10)


# --- one outer step of each option -------------------------------------------

STEPS = {
    "batched_fake_gen": (dict(), dict(D_KW),
                         dict(loss="hinge", batched_fake_gen=True)),
    "d_fake_stats_running": (dict(), dict(D_KW),
                             dict(loss="hinge", d_fake_stats="running")),
    "sn_update_on_g_step": (dict(), dict(D_KW),
                            dict(loss="hinge", sn_update_on_g_step=True)),
    "remat": (dict(remat=True), dict(D_KW, remat=True),
              dict(loss="hinge")),
    # ns, not hinge: under the hinge loss with every sample on the active
    # side, the last conv's bias has a gradient of exactly 0, and Adam's
    # first update turns its rounding into +-lr (the sign bound of
    # check_params covers the params, not the next loss).
    "conv_singular": (dict(), dict(D_KW, conv_singular=True),
                      dict(loss="ns")),
}


@pytest.fixture(scope="module", params=sorted(STEPS))
def option_step(request):
  return one_step(*STEPS[request.param])


def test_option_step_metrics_match(option_step):
  check_metrics(*option_step)


@pytest.mark.parametrize("model", ["g", "d"])
def test_option_step_adam_slots_match(model, option_step):
  check_adam_slots(option_step[0], option_step[2], model)


@pytest.mark.parametrize("model", ["g", "d"])
def test_option_step_params_match(model, option_step):
  check_params(option_step[0], option_step[2], model)


@pytest.mark.parametrize("model", ["g", "d"])
def test_option_step_running_state_matches(model, option_step):
  check_running_state(option_step[0], option_step[2], model)


def test_d_fake_stats_is_validated():
  """The reference's error, raised where the config is made (the reference
  raises it when it builds the step)."""
  msg = "d_fake_stats must be 'batch' or 'running', got 'ema'"
  with pytest.raises(ValueError, match=msg):
    GANConfig(d_fake_stats="ema")
  with pytest.raises(ValueError, match=msg):
    jmake_outer_step(None, None, None, None, JGANConfig(d_fake_stats="ema"))


# --- the same step with and without an option, in the port --------------------


def _port_step(monkeypatch, g_kw, d_kw, gan_kw, seed=1):
  """One port outer step from a seeded state on seeded inputs: (metrics,
  state, the number of batch-statistics computations of WC layers)."""
  calls = []
  plain = whiten_ops.batch_moments

  def counted(x2d, use_kernel=None, group=None):
    calls.append(x2d.shape)
    return plain(x2d, use_kernel, group)

  monkeypatch.setattr(whiten_ops, "batch_moments", counted)
  g_cfg = GeneratorConfig(z_dim=16, resolution=16, base_resolution=4,
                          filters=(16, 16), **g_kw)
  state = create_state(g_cfg, DiscriminatorConfig(**D_KW, **d_kw),
                       OptimConfig(), 2, torch.device("cpu"), seed=seed)
  gen = torch.Generator().manual_seed(seed)
  real = torch.randint(0, 256, (2, 4, 16, 16, 3), generator=gen,
                       dtype=torch.uint8)
  noise = {"z_d": torch.randn((2, 4, 16), generator=gen),
           "z_g": torch.randn((8, 16), generator=gen)}
  metrics = make_outer_step(GANConfig(training_ratio=2, z_dim=16,
                                      **gan_kw))(state, real, None, noise)
  monkeypatch.setattr(whiten_ops, "batch_moments", plain)
  return {k: float(v) for k, v in metrics.items()}, state, len(calls)


def test_remat_equals_the_step_without_it(monkeypatch):
  """G and a ResNet D with WC layers ('d'), remat on and off: the same
  metrics, parameters and running statistics bit for bit. The
  recomputation repeats each block's WC layers (G's 2 blocks x 2 layers in
  the G update; D's 2 blocks x 2 layers in each of its 5 passes with a
  gradient: fake and real in 2 D updates, and the G update's), and nothing
  else: 35 batch statistics without remat, 35 + 4 + 5 x 4 = 59 with it."""
  d_kw = dict(norm="d")
  m0, s0, n0 = _port_step(monkeypatch, {}, d_kw, {})
  m1, s1, n1 = _port_step(monkeypatch, dict(remat=True),
                          dict(d_kw, remat=True), {})
  assert m1 == m0
  for model in ("g", "d"):
    sd0, sd1 = getattr(s0, model).state_dict(), getattr(s1,
                                                       model).state_dict()
    assert sd0.keys() == sd1.keys()
    for k in sd0:
      assert torch.equal(sd0[k], sd1[k]), (model, k)
  # 2 D updates x (G 5 + D fake 4 + D real 4) + G update (G 5 + D 4).
  assert n0 == 2 * (5 + 4 + 4) + 5 + 4 == 35
  assert n1 == n0 + 4 + 5 * 4


def test_remat_records_batch_moments_once(monkeypatch):
  """capture_batch_moments sees each layer's forward once under remat: the
  recomputation in the backward records nothing."""
  from wcgan_tpu_torch.models import layers as L
  g_cfg = GeneratorConfig(z_dim=16, resolution=16, base_resolution=4,
                          filters=(16, 16), remat=True)
  state = create_state(g_cfg, DiscriminatorConfig(**D_KW), OptimConfig(), 2,
                       torch.device("cpu"), seed=2)
  z = torch.randn((4, 16), generator=torch.Generator().manual_seed(0))
  seen = []
  with L.capture_batch_moments(state.g) as moments:
    out = state.g(z, train=True, update_stats=True)
    first = {k: v.clone() for k, v in moments.items()}
    for name, m in L._stat_layers(state.g):
      sink = m.moments_sink
      m.moments_sink = (lambda s, n: lambda a, b: (seen.append(n), s(a, b))
                        )(sink, name)
    out.sum().backward()
  assert not seen
  assert moments.keys() == first.keys() and len(first) == 10
  for k in first:
    assert torch.equal(moments[k], first[k]), k


def test_batched_fake_gen_is_exact_for_a_stat_free_generator(monkeypatch):
  """With no statistics in G (norm 'n'), one forward over the K batches
  gives the same fakes as K forwards, so the whole step is the same, as
  the reference's regression test holds."""
  g_kw = dict(block_norm="n", last_norm="n")
  m0, s0, n0 = _port_step(monkeypatch, g_kw, {}, {})
  m1, s1, n1 = _port_step(monkeypatch, g_kw, {},
                          dict(batched_fake_gen=True))
  assert n0 == n1 == 0
  for k in m0:
    np.testing.assert_allclose(m1[k], m0[k], rtol=1e-6, err_msg=k)
  for (n, a), (_, b) in zip(s0.d.named_parameters(),
                            s1.d.named_parameters()):
    np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                               atol=1e-7, err_msg=n)


@pytest.mark.parametrize("gan_kw,calls", [
    ({}, 2 * 5 + 5), (dict(batched_fake_gen=True), 5 + 5),
    (dict(d_fake_stats="running"), 5)])
def test_generator_batch_statistics_per_option(gan_kw, calls, monkeypatch):
  """G's WC layers (5) compute batch statistics once per train-mode
  forward: in each D update's fake forward (2) and the G update; once for
  all D updates with batched_fake_gen; only in the G update with
  d_fake_stats running (the D-phase G runs in eval mode)."""
  _, state, n = _port_step(monkeypatch, {}, {}, gan_kw)
  assert n == calls


def test_sn_update_on_g_step_advances_u_in_the_g_update(monkeypatch):
  """With the option the G update's D pass advances every u once more
  than without it (one power iteration on D's final weights); D's
  parameters are the same."""
  _, s0, _ = _port_step(monkeypatch, {}, {}, {})
  _, s1, _ = _port_step(monkeypatch, {}, {}, dict(sn_update_on_g_step=True))
  for name, conv in s0.d.named_modules():
    if isinstance(conv, tlayers.SNConv):
      want = tsn.spectral_normalize(conv.weight.detach(), conv.u)[1]
      got = s1.d.get_submodule(name).u
      assert not torch.equal(got, conv.u), name
      np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                                 err_msg=name)
  for (n, a), (_, b) in zip(s0.d.named_parameters(),
                            s1.d.named_parameters()):
    assert torch.equal(a, b), n


# --- the fallback ladder's first rung -----------------------------------------


def test_fallback_demotes_d_fake_stats_first(tmp_path):
  """--d_fake_stats running with --wc_residual_action fallback: the first
  breach demotes the D phase to batch statistics (the reference's first
  rung), checkpoints, rebuilds the step and trains on."""
  tt = _port(tmp_path, *GUARD, "--number_of_epochs", "2",
             "--d_fake_stats", "running", "--wc_residual_action",
             "fallback", "--fallback_cooldown", "0")
  assert tt.gan_cfg.d_fake_stats == "running"
  _plant_ill_conditioned_cov(tt)
  step_before = tt.step_fn
  tt.train()
  assert tt.gan_cfg.d_fake_stats == "batch"
  assert tt.step_fn is not step_before
  log = _log(tmp_path)
  assert "demoting d_fake_stats running -> batch" in log
  assert log.count("imgs/sec") == 2
  assert (tmp_path / "c" / "t" / "epoch_0").is_dir()
