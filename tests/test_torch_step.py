"""One outer step of the port against wcgan_tpu/train/step.py, float32.

Both sides start from the same weights (moved across by
``wcgan_tpu_torch.weights``) with fresh Adam slots, and see the same real
images and the same random draws: the test replays the JAX step's key path
with ``jax.random`` and hands the arrays to the port as ``noise``.

Tolerances and why:
- losses, grad norms: rtol 1e-4 (float32, sums in another order, through
  15 Newton-Schulz iterations forward and backward);
- Adam mu/nu (mu is the last gradient, beta1 = 0): rtol 1e-3 plus an
  atol of 1e-5 of the model's largest slot value. Some gradients are zero
  in exact arithmetic (a conv bias in front of a whitening layer, whose
  batch mean removes it) and hold only rounding noise on both sides;
- params: Adam's first update is ~lr * g / (|g| + eps) ~ lr * sign(g), so
  where a gradient is near zero its rounding can flip the sign and move a
  parameter by up to 2 lr per update. Where |g| > 1e-6 and sqrt(nu) > 1e-6
  params must agree to lr * 1e-2; elsewhere only to that bound;
- running statistics and SN vectors: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wcgan_tpu.models.discriminator import Discriminator as JD
from wcgan_tpu.models.discriminator import DiscriminatorConfig as JDCfg
from wcgan_tpu.models.generator import Generator as JG
from wcgan_tpu.models.generator import GeneratorConfig as JGCfg
from wcgan_tpu.train import schedules as jschedules
from wcgan_tpu.train.state import create_state as jcreate_state
from wcgan_tpu.train.step import GANConfig as JGANConfig
from wcgan_tpu.train.step import make_jit_step
from wcgan_tpu_torch import weights
from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
from wcgan_tpu_torch.models.generator import GeneratorConfig
from wcgan_tpu_torch.train import schedules
from wcgan_tpu_torch.train.state import OptimConfig, state_from_modules
from wcgan_tpu_torch.train.step import GANConfig, make_outer_step

LR = 2e-4
RATIO, BATCH, GMULT, ZDIM, RES = 2, 4, 2, 16, 16


def replay_jax_noise(state_rng, cfg: JGANConfig, b: int):
  """The draws of wcgan_tpu's outer_step for one call, as numpy arrays."""
  _, use_rng = jax.random.split(state_rng)
  z_d = [jax.random.normal(
      jax.random.split(jax.random.fold_in(use_rng, k), 3)[0],
      (b, cfg.z_dim), jnp.float32) for k in range(cfg.training_ratio)]
  z_g = jax.random.normal(
      jax.random.split(jax.random.fold_in(use_rng, cfg.training_ratio))[0],
      (b * cfg.generator_batch_multiple, cfg.z_dim), jnp.float32)
  flip = jax.random.bernoulli(
      jax.random.fold_in(use_rng, cfg.training_ratio + 1), 0.5,
      (cfg.training_ratio, b, 1, 1, 1))
  return {"z_d": np.stack([np.asarray(z) for z in z_d]),
          "z_g": np.asarray(z_g),
          "flip": np.asarray(flip).reshape(cfg.training_ratio, b)}


def _flat(tree):
  return dict(weights._flatten(jax.tree_util.tree_map(np.asarray, tree)))


@pytest.fixture(scope="module")
def one_step():
  """(JAX state before, after, metrics; port state after, metrics)."""
  rng = np.random.default_rng(5)
  jg = JG(cfg=JGCfg(z_dim=ZDIM, resolution=RES, base_resolution=4,
                    filters=(16, 16), ns_iters=15))
  jd = JD(cfg=JDCfg(resolution=RES, filters=(16, 16, 16),
                    downsample=(True, True, False)))
  jcfg = JGANConfig(loss="hinge", training_ratio=RATIO,
                    generator_batch_multiple=GMULT, z_dim=ZDIM,
                    random_flip=True)
  g_tx, d_tx = jschedules.adam(LR), jschedules.adam(LR)
  state = jcreate_state(jg, jd, g_tx, d_tx, jax.random.PRNGKey(11),
                        batch_size=BATCH, z_dim=ZDIM,
                        image_shape=(RES, RES, 3))
  # Perturb so that identity/zero inits cannot hide a wrong mapping.
  perturb = lambda t: jax.tree_util.tree_map(  # noqa: E731
      lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
      t)
  state = state.replace(g_params=perturb(state.g_params),
                        d_params=perturb(state.d_params))
  real = rng.integers(0, 256, (RATIO, BATCH, RES, RES, 3)).astype(np.uint8)
  labels = np.zeros((RATIO, BATCH), np.int32)
  noise = replay_jax_noise(state.rng, jcfg, BATCH)

  step_j = make_jit_step(jg, jd, g_tx, d_tx, jcfg, donate=False)
  new_j, metrics_j = step_j(state, jnp.asarray(real), jnp.asarray(labels))

  as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
  g_cfg = GeneratorConfig(z_dim=ZDIM, resolution=RES, base_resolution=4,
                          filters=(16, 16), ns_iters=15)
  d_cfg = DiscriminatorConfig(resolution=RES, filters=(16, 16, 16),
                              downsample=(True, True, False))
  tg, td = weights.from_jax(as_np(state.g_params), as_np(state.g_state),
                            as_np(state.d_params), as_np(state.d_state),
                            g_cfg, d_cfg)
  tstate = state_from_modules(tg, td, OptimConfig(), RATIO,
                              torch.device("cpu"), seed=0)
  step_t = make_outer_step(GANConfig(loss="hinge", training_ratio=RATIO,
                                     generator_batch_multiple=GMULT,
                                     z_dim=ZDIM, random_flip=True))
  metrics_t = step_t(tstate, real, labels, noise=noise)
  return new_j, metrics_j, tstate, metrics_t


def test_metrics_match(one_step):
  _, metrics_j, tstate, metrics_t = one_step
  assert tstate.step == 1
  assert set(metrics_t) == set(metrics_j)
  for k, v in metrics_j.items():
    np.testing.assert_allclose(float(metrics_t[k]), float(v), rtol=1e-4,
                               err_msg=k)


@pytest.mark.parametrize("model", ["g", "d"])
def test_adam_slots_match(model, one_step):
  new_j, _, tstate, _ = one_step
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


@pytest.mark.parametrize("model", ["g", "d"])
def test_params_match(model, one_step):
  new_j, _, tstate, _ = one_step
  updates = 1 if model == "g" else RATIO
  adam_j = getattr(new_j, f"{model}_opt")[0]
  got = _flat(weights.to_jax(getattr(tstate, model))[0])
  want = _flat(getattr(new_j, f"{model}_params"))
  mu, nu = _flat(adam_j.mu), _flat(adam_j.nu)
  assert got.keys() == want.keys()
  n_sure = 0
  for k in want:
    diff = np.abs(got[k] - want[k])
    sure = (np.abs(mu[k]) > 1e-6) & (np.sqrt(nu[k]) > 1e-6)
    n_sure += sure.sum()
    assert (diff[sure] <= LR * 1e-2).all(), ("/".join(k), diff[sure].max())
    assert (diff <= 2 * LR * updates + 1e-7).all(), ("/".join(k), diff.max())
  assert n_sure > 0.9 * sum(v.size for v in want.values())


@pytest.mark.parametrize("model,coll", [("g", "wc_stats"), ("d", "spectral")])
def test_running_state_matches(model, coll, one_step):
  new_j, _, tstate, _ = one_step
  got = _flat(weights.to_jax(getattr(tstate, model))[1][coll])
  want = _flat(getattr(new_j, f"{model}_state")[coll])
  assert got.keys() == want.keys()
  for k in want:
    np.testing.assert_allclose(got[k], want[k], atol=1e-5,
                               err_msg="/".join(k))


@pytest.mark.parametrize("name", ["none", "linear", "half-linear",
                                  "linear-end", "tensor:none",
                                  "tensor:linear", "tensor:half-linear",
                                  "tensor:linear-end"])
def test_lr_factors_match_optax(name):
  """The host factor, and ('tensor:') the factor of a device count that
  the captured step's LR follows, which also equals the host factor over
  t = 0 ... total + 2."""
  form, _, name = name.rpartition(":")
  total = 37
  sched_j = jschedules.lr_schedule(name, 1.0, total)
  factor = schedules.lr_factor(name, total)
  if form == "tensor":
    on_count = schedules.lr_factor_tensor(name, total)
    for t in range(total + 3):
      np.testing.assert_allclose(float(on_count(torch.tensor(t))),
                                 factor(t), atol=1e-6,
                                 err_msg=f"{name} t={t}")
    factor = lambda t: float(on_count(torch.tensor(t)))  # noqa: E731
  for t in (0, 1, 17, 18, 19, 32, 33, 34, 36, 37, 50):
    np.testing.assert_allclose(factor(t), float(sched_j(t)), atol=1e-6,
                               err_msg=f"{name} t={t}")


def test_adam_matches_optax_over_steps(rng):
  """Three updates with a decaying LR: torch Adam (eps after the sqrt)
  follows optax.adam with the same schedule."""
  p0 = rng.standard_normal(6).astype(np.float32)
  grads = [rng.standard_normal(6).astype(np.float32) for _ in range(3)]
  tx = jschedules.adam(1e-2, 0.0, 0.9, "linear", 5)
  pj, sj = jnp.asarray(p0), tx.init(jnp.asarray(p0))
  pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
  opt, sched = schedules.adam([pt], 1e-2, 0.0, 0.9, "linear", 5)
  for g in grads:
    upd, sj = tx.update(jnp.asarray(g), sj, pj)
    pj = optax.apply_updates(pj, upd)
    pt.grad = torch.from_numpy(g)
    opt.step()
    sched.step()
  np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), atol=1e-6)
