"""The port's trainer against wcgan_tpu/train/trainer.py: EMA weights,
standing statistics, the whitening probe and guard, and device-resident
data.

Both packages build the same experiment from the same CLI flags (a G 16x2
on the synthetic dataset, float32, on the CPU), with weights moved across
by ``wcgan_tpu_torch.weights``. Tolerances and why:

- the EMA shadow after one outer step: (1 - d) times the bounds of
  ``test_torch_step.py::test_params_match`` on the parameters it follows,
  plus 1e-7 for the shadow's own rounding;
- standing statistics at momentum 0.99: 1e-4 abs/rel, the reference's own
  bound for its inverted EMA update (tests/test_e2e.py); the port captures
  the batch moments directly, and at momentum 0.999 they equal one plain
  train-mode pass's batch moments within 1e-5;
- EMA images: ``test_torch_sampling._assert_u8_close``;
- diagnostics: rtol 1e-5 (the same float32 numpy code on the same
  covariances and kernels, summed in another order);
- window picks: exact (the same numpy generator and calls).

The guard and ladder cases mirror tests/test_e2e.py by name. The
reference's first rung (``d_fake_stats`` running -> batch) has no
counterpart in the port, whose D phase always uses batch statistics; its
cases walk the ladder from the 'dr' rung.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sampling import _assert_u8_close, _perturb_g
from test_torch_step import replay_jax_noise
from wcgan_tpu.cli import run as jrun
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
from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
from wcgan_tpu_torch.models.generator import Generator, GeneratorConfig
from wcgan_tpu_torch.train import step as step_lib
from wcgan_tpu_torch.train.state import OptimConfig, state_from_modules

LR = 2e-4
FLAGS = ["--dataset", "synthetic", "--synthetic_size", "64", "--arch", "res",
         "--generator_filters", "16,16", "--discriminator_filters", "16,16",
         "--batch_size", "8", "--training_ratio", "2", "--z_dim", "16",
         "--name", "t"]
# The guard cases: one outer step an epoch, no grids or checkpoints unless
# the guard takes one, Newton-Schulz too short for a planted cond-1e6
# covariance.
GUARD = ["--number_of_epochs", "1", "--batches_per_epoch", "1",
         "--checkpoint_ratio", "0", "--display_ratio", "0", "--ns_iters", "4"]


def _port(tmp_path, *extra):
  args = trun.build_parser().parse_args(FLAGS + [
      "--device", "cpu", "--output_dir", str(tmp_path / "o"),
      "--checkpoints_dir", str(tmp_path / "c"), *extra])
  return trun.build_experiment(args)


def _jax(tmp_path, *extra):
  args = jrun.build_parser().parse_args(FLAGS + [
      "--output_dir", str(tmp_path / "jo"), "--checkpoints_dir",
      str(tmp_path / "jc"), *extra])
  return jrun.build_experiment(args)


def _log(tmp_path):
  return (tmp_path / "o" / "t" / "log.txt").read_text()


def _flat(tree):
  return dict(weights._flatten(jax.tree_util.tree_map(np.asarray, tree)))


def _perturb(rng, tree):
  return jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
          np.shape(a)).astype(np.float32), tree)


def _load_ema(tt, g_ema):
  """Copy a flax-layout EMA tree into the port's shadow."""
  sd = weights.state_dict_from_jax(g_ema, {})
  assert sd.keys() == tt.state.g_ema.keys()
  with torch.no_grad():
    for name, t in tt.state.g_ema.items():
      t.copy_(sd[name])
  tt.state.g_version += 1


# --- EMA ---------------------------------------------------------------------


def test_ema_one_step_matches_jax():
  """One outer step with g_ema_decay 0.5 from the same weights, shadow and
  injected noise (the setup of test_torch_step.py)."""
  rng = np.random.default_rng(5)
  decay, ratio, b, zdim, res = 0.5, 2, 4, 16, 16
  jg = JG(cfg=JGCfg(z_dim=zdim, resolution=res, base_resolution=4,
                    filters=(16, 16), ns_iters=15))
  jd = JD(cfg=JDCfg(resolution=res, filters=(16, 16, 16),
                    downsample=(True, True, False)))
  jcfg = JGANConfig(loss="hinge", training_ratio=ratio,
                    generator_batch_multiple=2, z_dim=zdim, random_flip=True,
                    g_ema_decay=decay)
  g_tx, d_tx = jschedules.adam(LR), jschedules.adam(LR)
  state = jcreate_state(jg, jd, g_tx, d_tx, jax.random.PRNGKey(11),
                        batch_size=b, z_dim=zdim, image_shape=(res, res, 3),
                        g_ema=True)
  # The shadow apart from the params, so that both terms of the update
  # count.
  state = state.replace(g_params=_perturb(rng, state.g_params),
                        d_params=_perturb(rng, state.d_params),
                        g_ema=_perturb(rng, state.g_params))
  real = rng.integers(0, 256, (ratio, b, res, res, 3)).astype(np.uint8)
  labels = np.zeros((ratio, b), np.int32)
  noise = replay_jax_noise(state.rng, jcfg, b)
  new_j, _ = make_jit_step(jg, jd, g_tx, d_tx, jcfg, donate=False)(
      state, jnp.asarray(real), jnp.asarray(labels))

  as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
  tg, td = weights.from_jax(
      as_np(state.g_params), as_np(state.g_state), as_np(state.d_params),
      as_np(state.d_state),
      GeneratorConfig(z_dim=zdim, resolution=res, base_resolution=4,
                      filters=(16, 16), ns_iters=15),
      DiscriminatorConfig(resolution=res, filters=(16, 16, 16),
                          downsample=(True, True, False)))
  tstate = state_from_modules(tg, td, OptimConfig(), ratio,
                              torch.device("cpu"), seed=0,
                              g_ema_decay=decay)
  tt = types.SimpleNamespace(state=tstate)
  _load_ema(tt, as_np(state.g_ema))
  version = tstate.g_version
  step_lib.make_outer_step(step_lib.GANConfig(
      loss="hinge", training_ratio=ratio, generator_batch_multiple=2,
      z_dim=zdim, random_flip=True, g_ema_decay=decay))(
          tstate, real, labels, noise=noise)
  assert tstate.g_version == version + 1

  got = _flat(weights.params_to_jax(tstate.g_ema))
  want = _flat(new_j.g_ema)
  before = _flat(state.g_ema)
  adam_j = new_j.g_opt[0]
  mu, nu = _flat(adam_j.mu), _flat(adam_j.nu)
  assert got.keys() == want.keys()
  for k in want:
    diff = np.abs(got[k] - want[k])
    sure = (np.abs(mu[k]) > 1e-6) & (np.sqrt(nu[k]) > 1e-6)
    bound = (1 - decay) * LR * 1e-2 + 1e-7
    assert (diff[sure] <= bound).all(), ("/".join(k), diff[sure].max())
    assert (diff <= (1 - decay) * 2 * LR + 1e-7).all(), ("/".join(k),
                                                          diff.max())
    assert not np.array_equal(got[k], before[k]), k


def test_generator_ema_sampling_and_raw_override(tmp_path):
  """After a short run the shadow has left the params, and generate()
  samples from it; without the shadow it samples the raw weights."""
  tt = _port(tmp_path, "--generator_ema", "0.5", "--number_of_epochs", "2",
             "--batches_per_epoch", "2", "--display_ratio", "0")
  tt.train()
  assert any(not torch.allclose(tt.state.g_ema[n], p)
             for n, p in tt.state.g.named_parameters())
  ema_imgs = tt.generate(8, batch=8)
  tt.state.g_ema = None
  raw_imgs = tt.generate(8, batch=8)
  assert not np.array_equal(ema_imgs, raw_imgs)


@pytest.fixture(scope="module")
def ema_pair(tmp_path_factory):
  """(JAX Trainer, port Trainer) with the same G, D and EMA shadow; G's
  running statistics set from one train-mode pass."""
  root = tmp_path_factory.mktemp("ema")
  jt = _jax(root, "--generator_ema", "0.5")
  rng = np.random.default_rng(5)
  g_params, g_state = _perturb_g(rng, jt.g, jt.state.g_params,
                                 jt.state.g_state)
  g_ema = _perturb(rng, g_params)
  jt.state = jt.state.replace(g_params=g_params, g_state=g_state,
                              g_ema=g_ema)
  tt = _port(root, "--generator_ema", "0.5")
  tt.state.g.load_state_dict(weights.state_dict_from_jax(g_params, g_state))
  tt.state.d.load_state_dict(weights.state_dict_from_jax(
      jax.tree_util.tree_map(np.asarray, jt.state.d_params),
      jax.tree_util.tree_map(np.asarray, jt.state.d_state)))
  _load_ema(tt, g_ema)
  return jt, tt


# --- standing statistics -----------------------------------------------------


def test_standing_stats_match_jax(ema_pair):
  jt, tt = ema_pair
  want = weights.state_dict_from_jax({}, {"wc_stats": jax.tree_util.tree_map(
      np.asarray, jt.standing_g_state(jt.state.g_ema, n_batches=2)[
          "wc_stats"])})
  got = tt.standing_g_state(tt.state.g_ema, n_batches=2)
  assert got.keys() == want.keys()
  live = dict(tt.state.g.named_buffers())
  for k in want:
    np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4,
                               atol=1e-4, err_msg=k)
    assert not torch.allclose(got[k], live[k]), k


def test_standing_moments_exact_at_momentum_0999(tmp_path):
  """The captured moments are one plain train-mode pass's batch moments
  (a momentum-0 G with the EMA params, the same z), whatever the momentum:
  no inversion of the EMA update, whose float32 rounding 1/(1-m) would
  scale up 1000x at m=0.999."""
  tt = _port(tmp_path, "--generator_ema", "0.5", "--wc_momentum", "0.999")
  gen = torch.Generator().manual_seed(0)
  with torch.no_grad():
    for t in tt.state.g_ema.values():
      t.add_(0.05 * torch.randn(t.shape, generator=gen))
    # Live statistics away from their init, so that 'old' is not (0, I).
    for name, buf in tt.state.g.named_buffers():
      buf.add_(0.1 * torch.rand(buf.shape, generator=gen))
  got = tt.standing_g_state(tt.state.g_ema, n_batches=1)
  g0 = Generator(dataclasses.replace(tt.state.g.cfg, wc_momentum=0.0),
                 torch.Generator().manual_seed(0))
  g0.load_state_dict({**tt.state.g.state_dict(), **tt.state.g_ema})
  z = np.random.default_rng(4321).standard_normal((8, 16)).astype(np.float32)
  with torch.no_grad():
    g0(torch.from_numpy(z), train=True, update_stats=True)
  for name, buf in g0.named_buffers():
    np.testing.assert_allclose(got[name].numpy(), buf.numpy(), rtol=0,
                               atol=1e-5, err_msg=name)


def test_ema_standing_stats_exact_swap_and_cache(tmp_path, monkeypatch):
  """sampling_state(): the EMA params with standing statistics, cached
  until an outer step, a restore or a change to G's statistics; n=0 is
  the EMA params on the live statistics, and no shadow the live G."""
  tt = _port(tmp_path, "--generator_ema", "0.5", "--ema_standing_stats",
             "2", "--batches_per_epoch", "1", "--steps_per_call", "1")
  recomputes = []
  real = tt.standing_g_state
  monkeypatch.setattr(tt, "standing_g_state",
                      lambda *a, **k: recomputes.append(1) or real(*a, **k))
  s1 = tt.sampling_state()
  assert tt.sampling_state() is s1 and len(recomputes) == 1
  live = dict(tt.state.g.named_buffers())
  assert all(s1[n] is t for n, t in tt.state.g_ema.items())
  assert any(not torch.equal(s1[n], live[n]) for n in live)
  assert all(torch.equal(live[n], b) for n, b in tt.state.g.named_buffers())

  tt.step_fn(tt.state, *tt._device_data)
  s2 = tt.sampling_state()
  assert s2 is not s1 and len(recomputes) == 2
  tt.save_checkpoint(0)
  assert tt.sampling_state() is s2 and len(recomputes) == 2
  tt.restore_checkpoint(tt.checkpoint_path(0))
  s3 = tt.sampling_state()
  assert s3 is not s2 and len(recomputes) == 3
  with torch.no_grad():
    tt.state.g.nc_out.cov.mul_(1.0)      # in place: a new version
  assert tt.sampling_state() is not s3 and len(recomputes) == 4

  tt.cfg.ema_standing_batches = 0
  assert tt.sampling_state() is tt.state.g_ema and len(recomputes) == 4
  tt.state.g_ema = None
  assert tt.sampling_state() == {}


def test_ema_generate_matches_jax(ema_pair):
  """generate() from the EMA weights with 16 batches of standing
  statistics, both packages."""
  jt, tt = ema_pair
  got_j = jt.generate(8, batch=8)
  got_t = tt.generate(8, batch=8)
  z = np.random.default_rng(1234).standard_normal((8, 16)).astype(np.float32)
  _assert_u8_close(got_t, got_j, tt.sample(z).numpy())
  raw = jt._sample_u8(jt.state.replace(g_ema={}), jnp.asarray(z),
                      jnp.zeros(8, jnp.int32))
  assert not np.array_equal(np.asarray(raw), got_j)


# --- diagnostics and the guard -----------------------------------------------


def _plant_ill_conditioned_cov(tt):
  """A cond-1e6 running covariance in G's first WC layer (the reference
  plants its first in tree order, the same layer)."""
  name, buf = next((n, b) for n, b in tt.state.g.named_buffers()
                   if n.endswith("cov"))
  with torch.no_grad():
    buf.copy_(torch.diag(torch.logspace(0, -6, buf.shape[0])))
  return name


@pytest.mark.parametrize("planted", [False, True])
def test_diagnostics_match_jax(ema_pair, planted):
  jt, tt = ema_pair
  saved = (jt.state, {n: b.clone() for n, b in tt.state.g.named_buffers()})
  try:
    if planted:
      name = _plant_ill_conditioned_cov(tt)
      cov = tt.state.g.get_buffer(name).numpy()
      stats = jax.tree_util.tree_map(np.asarray,
                                     jt.state.g_state["wc_stats"])
      node = stats
      *parents, leaf = name.split(".")
      for k in parents:
        node = node[k]
      node[leaf] = cov
      jt.state = jt.state.replace(g_state={**jt.state.g_state,
                                           "wc_stats": stats})
    diag_j, diag_t = jt.diagnostics(), tt.diagnostics()
    assert set(diag_t) == set(diag_j) == {
        "wc_cov_cond_max", "wc_cov_cond_mean", "wc_whiten_residual_max",
        "d_sigma_max", "d_sigma_mean"}
    for k in diag_j:
      np.testing.assert_allclose(diag_t[k], diag_j[k], rtol=1e-5, err_msg=k)
    assert (diag_t["wc_whiten_residual_max"] > 1e-2) == planted
  finally:
    jt.state = saved[0]
    with torch.no_grad():
      for n, b in tt.state.g.named_buffers():
        b.copy_(saved[1][n])


def test_whitening_residual_warning(tmp_path):
  tt = _port(tmp_path, *GUARD)
  _plant_ill_conditioned_cov(tt)
  assert max(tt._ns_residuals()) > 1e-2
  tt.train()
  assert "whitening under-converged" in _log(tmp_path)


def test_wc_residual_action_abort(tmp_path):
  tt = _port(tmp_path, *GUARD, "--wc_residual_action", "abort")
  _plant_ill_conditioned_cov(tt)
  with pytest.raises(FloatingPointError, match="whitening under-converged"):
    tt.train()
  log = _log(tmp_path)
  assert "abort" in log and "whitening under-converged" in log
  assert os.path.isfile(tmp_path / "c" / "t" / "epoch_0" / "state.pt")


def test_residual_probe_every_fires_intra_epoch(tmp_path):
  tt = _port(tmp_path, *GUARD, "--batches_per_epoch", "3",
             "--steps_per_call", "1", "--wc_residual_action", "abort",
             "--residual_probe_every", "1")
  _plant_ill_conditioned_cov(tt)
  with pytest.raises(FloatingPointError):
    tt.train()
  log = _log(tmp_path)
  assert "step-1 probe" in log
  assert "imgs/sec" not in log


def _wc_layers(g):
  return [g.get_submodule(n) for n in ("block0.nc1", "block0.nc2",
                                       "block1.nc1", "block1.nc2", "nc_out")]


def test_wc_residual_action_fallback_dr_demotes(tmp_path):
  """'dr' -> 'd' on the live G, whose state carries over; the next epoch
  trains it, and its breach takes the ns rung (no abort)."""
  tt = _port(tmp_path, *GUARD, "--number_of_epochs", "2", "--wc_momentum",
             "0.999", "--generator_block_norm", "dr",
             "--generator_last_norm", "dr", "--wc_residual_action",
             "fallback", "--fallback_cooldown", "0")
  _plant_ill_conditioned_cov(tt)
  tt.train()
  g = tt.state.g
  assert g.cfg.block_norm == g.cfg.last_norm == "d"
  assert all(nc.norm_code == "d" for nc in _wc_layers(g))
  log = _log(tmp_path)
  assert "demoting generator 'dr' norm codes -> 'd'" in log
  assert log.count("imgs/sec") == 2


def test_wc_residual_action_fallback_ns_escalates(tmp_path):
  tt = _port(tmp_path, *GUARD, "--wc_residual_action", "fallback")
  _plant_ill_conditioned_cov(tt)
  tt.train()
  assert tt.state.g.cfg.ns_iters == 8
  assert all(nc.ns_iters == 8 for nc in _wc_layers(tt.state.g))
  log = _log(tmp_path)
  assert "escalating ns_iters 4 -> 8" in log
  assert "aborting" not in log


def test_wc_residual_action_fallback_cooldown_suppresses(tmp_path):
  """After a rung, breaches inside the auto window (5000 outer steps at
  momentum 0.999) log and do not escalate."""
  tt = _port(tmp_path, *GUARD, "--number_of_epochs", "3", "--wc_momentum",
             "0.999", "--generator_block_norm", "dr",
             "--generator_last_norm", "dr", "--wc_residual_action",
             "fallback")
  _plant_ill_conditioned_cov(tt)
  tt.train()
  assert tt.state.g.cfg.block_norm == "d" and tt.state.g.cfg.ns_iters == 4
  log = _log(tmp_path)
  assert "demoting generator 'dr' norm codes -> 'd'" in log
  assert "fallback recovery window" in log
  assert "ladder exhausted" not in log
  assert log.count("imgs/sec") == 3


def test_wc_residual_action_fallback_full_ladder(tmp_path):
  """The whole ladder: 'dr' -> 'd', ns_iters x2, then exhausted -> abort,
  with a checkpoint before each."""
  tt = _port(tmp_path, *GUARD, "--number_of_epochs", "3", "--wc_momentum",
             "0.999", "--generator_block_norm", "dr",
             "--generator_last_norm", "dr", "--wc_residual_action",
             "fallback", "--fallback_cooldown", "0")
  _plant_ill_conditioned_cov(tt)
  with pytest.raises(FloatingPointError, match="whitening under-converged"):
    tt.train()
  assert tt.state.g.cfg.block_norm == "d" and tt.state.g.cfg.ns_iters == 8
  log = _log(tmp_path)
  assert "demoting generator 'dr' norm codes -> 'd'" in log
  assert "escalating ns_iters 4 -> 8" in log
  assert "ladder exhausted" in log
  assert log.count("imgs/sec") == 3
  for e in ("epoch_0", "epoch_1", "epoch_2"):
    assert os.path.isdir(tmp_path / "c" / "t" / e)


def test_residual_probe_finite_on_negative_rounded_diagonal(tmp_path):
  tt = _port(tmp_path, *GUARD)
  name, buf = next((n, b) for n, b in tt.state.g.named_buffers()
                   if n.endswith("cov"))
  c = buf.shape[0]
  bad = 1e-8 * np.ones((c, c), np.float32) + np.diag(
      np.full(c, 1e-7, np.float32))
  bad[0, 0] = -1e-7
  with torch.no_grad():
    buf.copy_(torch.from_numpy(bad))
  assert all(np.isfinite(r) for r in tt._ns_residuals())


# --- device-resident data ----------------------------------------------------


def test_epoch_honors_batches_per_epoch(tmp_path):
  """A chain longer than the epoch is clamped to it."""
  tt = _port(tmp_path, "--number_of_epochs", "1", "--batches_per_epoch",
             "3", "--steps_per_call", "8", "--display_ratio", "0")
  assert tt._steps_per_call == 3
  tt.train()
  assert tt.state.step == 3


@pytest.mark.parametrize("device_data,steps", [("1", 4), ("0", 5)])
def test_epoch_length_rounds_to_whole_chains(tmp_path, device_data, steps):
  tt = _port(tmp_path, "--number_of_epochs", "1", "--batches_per_epoch",
             "5", "--steps_per_call", "2", "--display_ratio", "0",
             "--device_data", device_data)
  tt.train()
  assert tt.state.step == steps
  rounded = ("epoch length rounded 5 -> 4 outer steps (steps_per_call=2 "
             "chaining)")
  assert (rounded in _log(tmp_path)) == (device_data == "1")


def test_window_matches_jax(tmp_path):
  """Datasets over --device_data_limit: the same window size (half the
  budget, two windows in flight) and the same numpy picks as the JAX
  trainer, window after window."""
  limit = ["--device_data_limit", str(32 * 32 * 3 * 40)]
  jt, tt = _jax(tmp_path, *limit), _port(tmp_path, *limit)
  try:
    assert tt._window_elems == jt._window_elems == 20
    first_j = jt._window_future.result()
    first_t = tt._take(tt._window_next)
    second_j, second_t = jt._make_window(), tt._take(tt._make_window())
  finally:
    jt._drop_pending_window()
  for (img_t, lab_t), (img_j, lab_j) in ((first_t, first_j),
                                         (second_t, second_j)):
    assert img_t.dtype == torch.uint8 and img_t.shape == (20, 32, 32, 3)
    np.testing.assert_array_equal(img_t.numpy(), np.asarray(img_j))
    np.testing.assert_array_equal(lab_t.numpy(), np.asarray(lab_j))
  assert not np.array_equal(first_t[0].numpy(), second_t[0].numpy())


def test_window_rotation_for_large_datasets(tmp_path):
  tt = _port(tmp_path, "--number_of_epochs", "2", "--batches_per_epoch",
             "2", "--checkpoint_ratio", "0", "--display_ratio", "0",
             "--device_data_limit", str(32 * 32 * 3 * 40))
  assert tt._window_elems == 20 and tt._window_next is not None
  tt.train()
  assert tt._device_data[0].shape[0] == 20
  # The window staged for a third epoch is released with train().
  assert tt._window_next is None
  assert "Epoch 1:" in _log(tmp_path)


def test_dataset_step_draws_from_state_generator(monkeypatch):
  """ratio*B indices uniform with replacement from state.generator, the
  same picks for images and labels."""
  seen = {}
  monkeypatch.setattr(
      step_lib, "make_outer_step",
      lambda cfg, group=None: lambda state, real, labels, noise=None: (
          seen.update(real=real, labels=labels) or {}))
  n, b = 50, 4
  data_x = torch.arange(n, dtype=torch.uint8).view(n, 1, 1, 1).expand(
      n, 2, 2, 3).contiguous()
  data_y = torch.arange(n, dtype=torch.int32) + 100
  fn = step_lib.make_dataset_step(step_lib.GANConfig(training_ratio=2), b)
  state = types.SimpleNamespace(generator=torch.Generator().manual_seed(3))
  fn(state, data_x, data_y)
  idx = torch.randint(0, n, (2 * b,),
                      generator=torch.Generator().manual_seed(3))
  assert seen["real"].shape == (2, b, 2, 2, 3)
  assert torch.equal(seen["real"][:, :, 1, 1, 2].long(), idx.view(2, b))
  assert torch.equal(seen["labels"].long(), idx.view(2, b) + 100)


def test_multi_chains_steps_and_averages():
  calls = []

  def fn(state, x, y):
    calls.append(1)
    return {"loss": torch.tensor(float(len(calls)))}

  out = step_lib._multi(fn, 3)(None, None, None)
  assert len(calls) == 3 and float(out["loss"]) == 2.0
  assert step_lib._multi(fn, 1) is fn
