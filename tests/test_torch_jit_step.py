"""The compiled step of the port (``make_jit_step``,
``make_jit_dataset_step``) on the CPU, where it runs the eager body on its
static buffers; the CUDA graphs themselves are held in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s graph phase.

- ``make_jit_step`` against the JAX package's ``make_jit_step`` over 3
  calls on replayed JAX noise, with ``test_torch_step.py``'s tolerances
  (metrics rtol 1e-4; Adam slots rtol 1e-3 with an atol of 1e-5 of the
  largest slot; params to lr * 1e-2 where the gradient is sure and to
  2 lr a step elsewhere; running statistics and SN vectors 1e-5);
- the jitted callables against the eager ones from the same state and
  generator: bit for bit on the CPU (the same float32 ops);
- the state's tensors advance in place (each statistics and SN buffer
  keeps its address), the tensor LR follows ``lr_factor``
  (``test_torch_step.py::test_lr_factors_match_optax``), the metrics of
  successive calls do not alias, the host counts advance by the chain's
  length, a restore and each rung of the fallback ladder invalidate the
  step, and a gloo group is refused on CUDA.
"""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_step import (BATCH, GMULT, LR, RATIO, RES, ZDIM,
                             _flat, replay_jax_noise)
from wcgan_tpu.models.discriminator import Discriminator as JD
from wcgan_tpu.models.discriminator import DiscriminatorConfig as JDCfg
from wcgan_tpu.models.generator import Generator as JG
from wcgan_tpu.models.generator import GeneratorConfig as JGCfg
from wcgan_tpu.train import schedules as jschedules
from wcgan_tpu.train import step as jstep
from wcgan_tpu.train.state import create_state as jcreate_state
from wcgan_tpu.train.step import GANConfig as JGANConfig
from wcgan_tpu_torch import compiled, weights
from wcgan_tpu_torch.cli import run as trun
from wcgan_tpu_torch.models import layers as L
from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
from wcgan_tpu_torch.models.generator import GeneratorConfig
from wcgan_tpu_torch.train import state as state_lib
from wcgan_tpu_torch.train import step as step_lib
from wcgan_tpu_torch.train.state import (OptimConfig, create_state,
                                         state_from_modules)
from wcgan_tpu_torch.train.step import (GANConfig, JitStep, _multi,
                                        make_dataset_step,
                                        make_jit_dataset_step, make_jit_step,
                                        make_outer_step)

CALLS = 3
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def three_calls():
  """Three calls of the JAX package's make_jit_step and of the port's,
  each on its own real batch and on the JAX key path's draws."""
  rng = np.random.default_rng(8)
  jg = JG(cfg=JGCfg(z_dim=ZDIM, resolution=RES, base_resolution=4,
                    filters=(16, 16), ns_iters=15))
  jd = JD(cfg=JDCfg(resolution=RES, filters=(16, 16, 16),
                    downsample=(True, True, False)))
  jcfg = JGANConfig(loss="hinge", training_ratio=RATIO,
                    generator_batch_multiple=GMULT, z_dim=ZDIM,
                    random_flip=True)
  g_tx, d_tx = jschedules.adam(LR), jschedules.adam(LR)
  state = jcreate_state(jg, jd, g_tx, d_tx, jax.random.PRNGKey(3),
                        batch_size=BATCH, z_dim=ZDIM,
                        image_shape=(RES, RES, 3))
  perturb = lambda t: jax.tree_util.tree_map(  # noqa: E731
      lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
      t)
  state = state.replace(g_params=perturb(state.g_params),
                        d_params=perturb(state.d_params))
  as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
  g_cfg = GeneratorConfig(z_dim=ZDIM, resolution=RES, base_resolution=4,
                          filters=(16, 16), ns_iters=15)
  d_cfg = DiscriminatorConfig(resolution=RES, filters=(16, 16, 16),
                              downsample=(True, True, False))
  tg, td = weights.from_jax(as_np(state.g_params), as_np(state.g_state),
                            as_np(state.d_params), as_np(state.d_state),
                            g_cfg, d_cfg)
  tstate = state_from_modules(tg, td, OptimConfig(), RATIO, CPU, seed=0)

  step_j = jstep.make_jit_step(jg, jd, g_tx, d_tx, jcfg, donate=False)
  step_t = make_jit_step(GANConfig(loss="hinge", training_ratio=RATIO,
                                   generator_batch_multiple=GMULT,
                                   z_dim=ZDIM, random_flip=True))
  labels = np.zeros((RATIO, BATCH), np.int32)
  metrics = []
  for _ in range(CALLS):
    real = rng.integers(0, 256, (RATIO, BATCH, RES, RES, 3)).astype(np.uint8)
    noise = replay_jax_noise(state.rng, jcfg, BATCH)
    state, m_j = step_j(state, jnp.asarray(real), jnp.asarray(labels))
    m_t = step_t(tstate, real, labels, noise=noise)
    metrics.append((m_j, m_t))
  return state, tstate, metrics, step_t


def test_jit_step_metrics_match_jax(three_calls):
  _, tstate, metrics, step_t = three_calls
  assert tstate.step == CALLS
  assert step_t.calls == {"warm-up": 1, "capture": 0, "replay": 0,
                          "eager": CALLS - 1}
  for m_j, m_t in metrics:
    assert set(m_t) == set(m_j)
    for k, v in m_j.items():
      np.testing.assert_allclose(float(m_t[k]), float(v), rtol=1e-4,
                                 err_msg=k)


@pytest.mark.parametrize("model", ["g", "d"])
def test_jit_step_adam_and_params_match_jax(model, three_calls):
  new_j, tstate, _, _ = three_calls
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
  updates = CALLS * (1 if model == "g" else RATIO)
  got = _flat(weights.to_jax(module)[0])
  want = _flat(getattr(new_j, f"{model}_params"))
  mu, nu = _flat(adam_j.mu), _flat(adam_j.nu)
  n_sure = 0
  for k in want:
    diff = np.abs(got[k] - want[k])
    sure = (np.abs(mu[k]) > 1e-6) & (np.sqrt(nu[k]) > 1e-6)
    n_sure += sure.sum()
    assert (diff[sure] <= LR * 1e-2).all(), ("/".join(k), diff[sure].max())
    assert (diff <= 2 * LR * updates + 1e-7).all(), ("/".join(k), diff.max())
  assert n_sure > 0.9 * sum(v.size for v in want.values())


@pytest.mark.parametrize("model,coll", [("g", "wc_stats"), ("d", "spectral")])
def test_jit_step_running_state_matches_jax(model, coll, three_calls):
  """1e-5, as after one step, but for G's running means. A WC layer's
  batch mean holds the conv biases in front of it (up to two: a res
  block's conv and shortcut), whose gradient is exactly zero (the
  whitening removes it): Adam moves them by rounding alone, and the params
  check holds them only to 2 lr an update. Each call's batch mean moves by
  their difference, at most twice the largest bias difference, and the
  running mean takes (1 - m) of each call's: 1e-5 + (1 - m) x CALLS x 2 x
  max |bias difference|. Every other G parameter agrees to ~1e-6 and the
  covariances to 1e-5."""
  new_j, tstate, _, _ = three_calls
  module = getattr(tstate, model)
  got = _flat(weights.to_jax(module)[1][coll])
  want = _flat(getattr(new_j, f"{model}_state")[coll])
  assert got.keys() == want.keys()
  drift = 0.0
  if model == "g":
    p_got = _flat(weights.to_jax(module)[0])
    p_want = _flat(new_j.g_params)
    bias = max(float(np.abs(p_got[k] - p_want[k]).max())
               for k in p_want if k[-1] == "bias")
    drift = (1.0 - module.cfg.wc_momentum) * CALLS * 2 * bias
  for k in want:
    atol = 1e-5 + (drift if k[-1] == "mean" else 0.0)
    np.testing.assert_allclose(got[k], want[k], atol=atol,
                               err_msg="/".join(k))


# --- the jitted callables against the eager ones -------------------------------

GAN = GANConfig(loss="hinge", training_ratio=2, generator_batch_multiple=2,
                z_dim=16, random_flip=True)
G_CFG = GeneratorConfig(z_dim=16, resolution=16, base_resolution=4,
                        filters=(16, 16), ns_iters=8)
D_CFG = DiscriminatorConfig(resolution=16, filters=(16, 16, 16),
                            downsample=(True, True, False))


def _state(g_cfg=G_CFG, d_cfg=D_CFG, ema=0.0, seed=4):
  return create_state(g_cfg, d_cfg, OptimConfig(), GAN.training_ratio, CPU,
                      seed=seed, g_ema_decay=ema)


def _data(n=40, res=16, seed=0):
  rng = np.random.default_rng(seed)
  return (torch.from_numpy(rng.integers(0, 256, (n, res, res, 3),
                                        dtype=np.uint8)),
          torch.zeros((n,), dtype=torch.int32))


def _assert_bit_equal(a, b, where="state"):
  if isinstance(a, dict):
    assert isinstance(b, dict) and a.keys() == b.keys(), where
    for k in a:
      _assert_bit_equal(a[k], b[k], f"{where}/{k}")
  elif isinstance(a, (list, tuple)):
    assert len(a) == len(b), where
    for i, (x, y) in enumerate(zip(a, b)):
      _assert_bit_equal(x, y, f"{where}/{i}")
  elif torch.is_tensor(a):
    assert a.dtype == b.dtype and a.shape == b.shape, where
    assert torch.equal(a, b), where
  else:
    assert a == b, where


def test_jit_dataset_chain_equals_eager_chain():
  """Two calls of a 3-step chain (the warm-up, then the static buffers)
  against two eager chains from the same state and generator: metrics,
  the whole state and the generator bit for bit."""
  gan = dataclasses.replace(GAN, g_ema_decay=0.5)
  data = _data()
  jit, ref = _state(ema=0.5), _state(ema=0.5)
  step_j = make_jit_dataset_step(gan, 4, steps_per_call=3)
  step_e = _multi(make_dataset_step(gan, 4), 3)
  for call in range(2):
    m_j = step_j(jit, *data)
    m_e = step_e(ref, *data)
    _assert_bit_equal(m_j, m_e, f"metrics {call}")
    assert jit.step == ref.step == 3 * (call + 1)
  assert step_j.last == "eager" and step_j.steps == 3
  _assert_bit_equal(state_lib.full_state(jit), state_lib.full_state(ref))
  assert torch.equal(jit.generator.get_state(), ref.generator.get_state())


def test_jit_step_equals_eager_step_with_injected_noise():
  """make_jit_step on numpy inputs and injected noise (copied into its
  static buffers) against make_outer_step, 3 calls, bit for bit."""
  rng = np.random.default_rng(1)
  jit, ref = _state(), _state()
  step_j, step_e = make_jit_step(GAN), make_outer_step(GAN)
  for _ in range(3):
    real = rng.integers(0, 256, (2, 4, 16, 16, 3)).astype(np.uint8)
    noise = {"z_d": rng.standard_normal((2, 4, 16)).astype(np.float32),
             "z_g": rng.standard_normal((8, 16)).astype(np.float32),
             "flip": rng.random((2, 4)) < 0.5}
    _assert_bit_equal(step_j(jit, real, None, noise=noise),
                      step_e(ref, real, None, noise=noise))
  _assert_bit_equal(state_lib.full_state(jit), state_lib.full_state(ref))


# Each kind of statistics or SN buffer, with the models that hold it.
BUFFER_KINDS = {
    "d": (dict(), dict(), ("mean", "cov")),
    "dr": (dict(block_norm="dr", last_norm="dr"), dict(), ("mean", "cov")),
    "b": (dict(block_norm="b", last_norm="b"), dict(), ("mean", "var")),
    "wc_in_d": (dict(), dict(norm="d", coloring="uconv"), ("mean", "cov")),
    "snconv": (dict(), dict(), ("u",)),
    "conv_singular": (dict(), dict(conv_singular=True), ("u_map",)),
    "sndense": (dict(), dict(), ("u",)),
    "snembed": (dict(num_classes=3, block_coloring="ucconv",
                     last_coloring="ucconv"),
                dict(num_classes=3, projection=True), ("u",)),
}
LAYER_TYPES = {"d": L.NormColor, "dr": L.NormColor, "b": L.BatchNorm,
               "wc_in_d": L.NormColor, "snconv": L.SNConv,
               "conv_singular": L.SNConv, "sndense": L.SNDense,
               "snembed": L.SNEmbed}


@pytest.mark.parametrize("kind", sorted(BUFFER_KINDS))
def test_buffers_advance_in_place(kind):
  """A step advances every statistics and SN buffer of the kind, each
  keeping its tensor and its address (a captured graph writes there)."""
  g_kw, d_kw, names = BUFFER_KINDS[kind]
  gan = dataclasses.replace(GAN, num_classes=g_kw.get("num_classes", 0),
                            gan_type="projection" if "num_classes" in g_kw
                            else "gan")
  st = _state(dataclasses.replace(G_CFG, **g_kw),
              dataclasses.replace(D_CFG, **d_kw))
  model = st.d if kind in ("wc_in_d", "snconv", "conv_singular", "sndense",
                           "snembed") else st.g
  layers = [(n, m) for n, m in model.named_modules()
            if type(m) is LAYER_TYPES[kind]]
  if kind == "snconv":
    layers = [(n, m) for n, m in layers if not m.conv_singular]
  assert layers, kind
  bufs = {(n, b): getattr(m, b) for n, m in layers for b in names}
  before = {k: (t, t.data_ptr(), t.clone()) for k, t in bufs.items()}
  rng = np.random.default_rng(2)
  real = rng.integers(0, 256, (2, 4, 16, 16, 3)).astype(np.uint8)
  labels = rng.integers(0, 3, (2, 4)).astype(np.int32)
  make_jit_step(gan)(st, real, labels)
  for (n, b), (t, ptr, old) in before.items():
    m = model.get_submodule(n)
    assert getattr(m, b) is t and t.data_ptr() == ptr, (n, b)
    assert dict(m.named_buffers())[b] is t, (n, b)
    assert not torch.equal(t, old), (n, b)


def test_metrics_of_successive_calls_do_not_alias():
  st = _state()
  data = _data()
  step = make_jit_dataset_step(GAN, 4, steps_per_call=2)
  outs = [step(st, *data) for _ in range(3)]
  first = {k: v.clone() for k, v in outs[0].items()}
  for k in first:
    ptrs = {o[k].data_ptr() for o in outs}
    assert len(ptrs) == 3, k
    assert torch.equal(outs[0][k], first[k]), k


@pytest.mark.parametrize("chain", [1, 3])
def test_host_counts_advance_by_the_chain(chain):
  st = _state()
  data = _data()
  step = make_jit_dataset_step(GAN, 4, steps_per_call=chain)
  for call in range(1, 4):
    step(st, *data)
    assert st.step == chain * call and st.g_version == chain * call
    assert int(st.g_sched.count) == chain * call
    assert int(st.d_sched.count) == chain * call * GAN.training_ratio


def test_new_inputs_warm_up_again():
  """The step is bound to its inputs: new device data, another batch
  shape or noise where there was none means a warm-up, not a replay."""
  st = _state()
  step = make_jit_dataset_step(GAN, 4, steps_per_call=2)
  data = _data()
  step(st, *data)
  step(st, *data)
  assert step.last == "eager"
  step(st, *_data(seed=1))
  assert step.last == "warm-up"
  jit = make_jit_step(GAN)
  real = np.zeros((2, 4, 16, 16, 3), np.uint8)
  jit(st, real, None)
  jit(st, real, None)
  assert jit.last == "eager"
  jit(st, np.zeros((2, 2, 16, 16, 3), np.uint8), None)
  assert jit.last == "warm-up"
  st.d_opt.state.clear()                 # the state's tensors changed
  jit(st, np.zeros((2, 2, 16, 16, 3), np.uint8), None)
  assert jit.last == "warm-up"


def test_the_device_data_is_not_kept():
  """The compiled chain reads the dataset where it lies and keeps no
  reference to it: a rotated-out window is freed, not held beside the
  next two."""
  st = _state()
  step = make_jit_dataset_step(GAN, 4, steps_per_call=2)
  data = _data()
  for _ in range(2):
    step(st, *data)
  gone = weakref.ref(data[0])
  del data
  gc.collect()
  assert gone() is None


def test_group_is_refused(monkeypatch):
  """A group whose collectives run on the host (gloo) is refused for
  capture on CUDA, by its backend's name; NCCL on CUDA, one process, and
  any group on the CPU (the eager body on static buffers) are taken."""
  cuda, group = torch.device("cuda", 0), object()
  monkeypatch.setattr(step_lib.mesh, "backend",
                      lambda g: None if g is None else "gloo")
  for name in ("make_jit_step", "make_jit_dataset_step"):
    with pytest.raises(ValueError, match=f"{name} cannot be captured with a "
                       "gloo group on CUDA: gloo's collectives run on the "
                       "host"):
      step_lib.refuse_host_collectives(name, group, cuda)
    step_lib.refuse_host_collectives(name, group, CPU)
    step_lib.refuse_host_collectives(name, None, cuda)
  monkeypatch.setattr(step_lib.mesh, "backend", lambda g: "nccl")
  step_lib.refuse_host_collectives("make_jit_step", group, cuda)


def test_capture_failure_names_the_call():
  try:
    L._rows(torch.zeros(2, 3, 4, 4))       # not channels_last: raises
  except RuntimeError as err:
    msg = str(compiled.capture_failure("make_jit_step", err))
  assert msg.startswith("CUDA graph capture of make_jit_step failed at ")
  assert "models/layers.py" in msg and "_rows" in msg


FLAGS = ["--device", "cpu", "--dataset", "synthetic", "--synthetic_size",
         "64", "--arch", "res", "--generator_filters", "16,16",
         "--discriminator_filters", "16,16", "--batch_size", "8",
         "--training_ratio", "2", "--z_dim", "16", "--ns_iters", "6",
         "--batches_per_epoch", "2", "--steps_per_call", "2",
         "--display_ratio", "0", "--name", "jit"]


def _trainer(tmp_path, *extra):
  return trun.build_experiment(trun.build_parser().parse_args(
      FLAGS + ["--output_dir", str(tmp_path / "o"), "--checkpoints_dir",
               str(tmp_path / "c"), *extra]))


def test_trainer_runs_the_compiled_steps(tmp_path):
  tt = _trainer(tmp_path)
  assert isinstance(tt.step_fn, JitStep)
  assert tt.step_fn.name == "make_jit_dataset_step" and tt.step_fn.steps == 2
  host = _trainer(tmp_path, "--device_data", "0")
  assert isinstance(host.step_fn, JitStep)
  assert host.step_fn.name == "make_jit_step"


def test_restore_invalidates_the_step(tmp_path):
  tt = _trainer(tmp_path)
  for _ in range(2):
    tt.step_fn(tt.state, *tt._device_data)
  assert tt.step_fn.last == "eager"
  tt.save_checkpoint(0)
  tt.restore_checkpoint(tt.checkpoint_path(0))
  tt.step_fn(tt.state, *tt._device_data)
  assert tt.step_fn.last == "warm-up" and tt.step_fn.calls["warm-up"] == 2


def test_each_ladder_rung_invalidates_the_step(tmp_path):
  """d_fake_stats running -> batch (a new step), 'dr' -> 'd', ns_iters x2:
  after each rung the next call warms up on the new settings."""
  tt = _trainer(tmp_path, "--d_fake_stats", "running",
                "--generator_block_norm", "dr", "--generator_last_norm", "dr",
                "--wc_residual_action", "fallback")
  assert tt.gan_cfg.d_fake_stats == "running"
  for rung in range(3):
    for _ in range(2):
      tt.step_fn(tt.state, *tt._device_data)
    assert tt.step_fn.last == "eager", rung
    assert tt._apply_whitening_fallback(rung)
    tt.step_fn(tt.state, *tt._device_data)
    assert tt.step_fn.last == "warm-up", rung
  assert tt.gan_cfg.d_fake_stats == "batch"
  assert tt.state.g.cfg.block_norm == "d" and tt.state.g.cfg.ns_iters == 12
  assert not tt._apply_whitening_fallback(3)
