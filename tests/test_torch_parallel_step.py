"""One data-parallel outer step of the port against the JAX package's
``make_sharded_step`` on a 2-device mesh, float32, on 2 CPU ranks (gloo).

Both sides start from the same perturbed weights (moved across by
``wcgan_tpu_torch.weights``) and see the same global batch, split into
two blocks of rows; each port rank gets the draws of its JAX replica,
replayed from the key path with ``fold_in(use_rng, axis_index)``
(``test_torch_conditional.replay_jax_noise``). The port's ranks run in
fresh interpreters (``wcgan_tpu_torch.parallel.launch``) that import
neither JAX nor this module: every step of this file is one job.

The reference's gradients are RANKS times the global batch's: under this
JAX, ``shard_map`` differentiates a replicated parameter into the sum of
the replicas' gradients, and ``_pmean`` leaves that replicated sum as it
is (``test_torch_parallel.py::test_reference_sums_replicated_gradients``,
ROADMAP queue 3). The port averages, as the reference's code says and as
one process on the global batch computes. So the JAX side's Adam here is
``optax.chain(optax.scale(1 / RANKS), adam)``: it updates with the mean,
and its slots hold the mean's moments. Its gradient norms, taken before
the optimizer, are divided by RANKS.

Tolerances are ``test_torch_step.py``'s (``test_torch_conditional``'s
checks): losses and grad norms rtol 1e-4, Adam slots rtol 1e-3 plus 1e-5
of the largest slot, running statistics and SN vectors atol 1e-5, params
by Adam's sign bound. The same step of the port on one process, on the
concatenated batch with the concatenated noise, agrees with the ranks
within the same tolerances; and after 2 steps with drawn noise every
tensor of the state is bit-equal on both ranks.

The compiled steps with the group run in a second job: ``make_jit_step``
(on the CPU its eager body on static buffers, this rank's block of the
batch in them) gives the eager sharded step's state and metrics bit for
bit in two cases and over two drawn steps, and so the JAX step's within
the tolerances above; ``make_jit_dataset_step`` (a chain of 2, 2 calls)
gives the eager chain's state, metrics and collectives a call bit for
bit, the state replicated on both ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_conditional import (D_KW, NC, K, LR, _perturb,
                                    check_adam_slots, check_metrics,
                                    check_params, check_running_state,
                                    replay_jax_noise)
from wcgan_tpu.models.discriminator import Discriminator as JD
from wcgan_tpu.models.discriminator import DiscriminatorConfig as JDCfg
from wcgan_tpu.models.generator import Generator as JG
from wcgan_tpu.models.generator import GeneratorConfig as JGCfg
from wcgan_tpu.parallel import DATA_AXIS, make_mesh
from wcgan_tpu.train import schedules as jschedules
from wcgan_tpu.train.state import create_state as jcreate_state
from wcgan_tpu.train.step import GANConfig as JGANConfig
from wcgan_tpu.train.step import make_sharded_step as jmake_sharded_step
from wcgan_tpu_torch import weights
from wcgan_tpu_torch.device import place
from wcgan_tpu_torch.models.discriminator import (Discriminator,
                                                  DiscriminatorConfig)
from wcgan_tpu_torch.models.generator import Generator, GeneratorConfig
from wcgan_tpu_torch.parallel import launch
from wcgan_tpu_torch.parallel.dryrun import replication_errors
from wcgan_tpu_torch.train.state import (OptimConfig, full_state,
                                         state_from_modules)
from wcgan_tpu_torch.train.step import GANConfig, make_outer_step

RANKS, RATIO, B, RES = 2, 2, 4, 16      # B rows per rank
# The compiled steps' cases, and the synthetic dataset of the compiled
# chain (32 rows a rank).
JIT_CASES = ("cwcsa_projection", "dnorm_wgan_gp")
JIT_DATA = {"resolution": RES, "classes": NC, "n": 64, "seed": 0}
DCGAN_D = dict(arch="dcgan", resolution=16, filters=(8, 16),
               downsample=(True, True))

CASES = {
    # The headline codes: unconditional d/uconv G, SN ResNet D. ns, not
    # hinge: under the hinge loss with every sample active, the last conv
    # bias of this D has a gradient of exactly 0, whose rounding (another
    # order of sums on 2 ranks) Adam's first update turns into +-lr
    # (test_torch_step_options.py's conv_singular case).
    "uncond_uconv": (dict(), dict(D_KW), dict(loss="ns")),
    # cWC-sa (preset imagenet64_cwc_dp's codes) + projection-D.
    "cwcsa_projection": (
        dict(block_coloring="ucconv-sa", last_coloring="ucconv-sa",
             num_classes=NC, filters_emb=K),
        dict(D_KW, projection=True),
        dict(loss="hinge", gan_type="projection", num_classes=NC)),
    # BatchNorm 'b' DCGAN G (flax's cross-replica mean and mean of
    # squares), SN DCGAN D, ns, one D update.
    "dcgan_batchnorm": (
        dict(arch="dcgan", block_norm="b", block_coloring="s",
             last_norm="b", last_coloring="uconv"),
        dict(DCGAN_D), dict(loss="ns", training_ratio=1)),
    # WC in D with WGAN-GP: the penalty's input gradient crosses the
    # ranks, and its parameter gradient reduces again.
    "dnorm_wgan_gp": (
        dict(block_coloring="ucconv", last_coloring="ucconv",
             num_classes=NC),
        dict(D_KW, projection=True, norm="d"),
        dict(loss="wgan-gp", gan_type="projection", num_classes=NC,
             gradient_penalty_weight=10.0)),
    # D-phase fakes from eval-mode G: only the G update reduces moments.
    "d_fake_stats_running": (dict(), dict(D_KW),
                             dict(loss="hinge", d_fake_stats="running")),
}


def _cat_noise(noises):
  """The ranks' draws as one process's draws on the concatenated batch."""
  axis = {"z_d": 1, "y_d": 1, "gp_eps": 1, "flip": 1, "z_g": 0, "y_g": 0}
  return {k: np.concatenate([n[k] for n in noises], axis=axis[k])
          for k in noises[0]}


def _mean_adam():
  """The reference's Adam on the mean of the replicas' summed gradient."""
  return optax.chain(optax.scale(1.0 / RANKS), jschedules.adam(LR))


def _as_mean(new_j, metrics_j):
  """The JAX step's results in the layout of an unscaled Adam, its grad
  norms those of the mean gradient."""
  metrics = {k: v / RANKS if k.endswith("grad_norm") else v
             for k, v in metrics_j.items()}
  return new_j.replace(g_opt=new_j.g_opt[1], d_opt=new_j.d_opt[1]), metrics


def _case(g_kw, d_kw, gan_kw, seed=5):
  """(JAX state after, JAX metrics, the port's step_rank arguments, the
  port's models and one-process noise) of one case."""
  rng = np.random.default_rng(seed)
  gan_kw = dict(dict(training_ratio=RATIO, generator_batch_multiple=2,
                     z_dim=16, random_flip=True), **gan_kw)
  ratio = gan_kw["training_ratio"]
  num_classes = gan_kw.get("num_classes", 0)
  g_kw = dict(z_dim=16, resolution=RES, base_resolution=4, filters=(16, 16),
              ns_iters=15, **g_kw)
  jg = JG(cfg=JGCfg(**g_kw, axis_name=DATA_AXIS))
  jd = JD(cfg=JDCfg(**d_kw, axis_name=DATA_AXIS))
  jcfg = JGANConfig(**gan_kw)
  g_tx, d_tx = _mean_adam(), _mean_adam()
  state = jcreate_state(jg, jd, g_tx, d_tx, jax.random.PRNGKey(11),
                        batch_size=RANKS * B, z_dim=16,
                        image_shape=(RES, RES, 3), num_classes=num_classes)
  state = state.replace(g_params=_perturb(state.g_params, rng),
                        d_params=_perturb(state.d_params, rng))
  real = rng.integers(0, 256, (ratio, RANKS * B, RES, RES, 3)).astype(
      np.uint8)
  labels = rng.integers(0, max(num_classes, 1),
                        (ratio, RANKS * B)).astype(np.int32)
  noises = [replay_jax_noise(state.rng, jcfg, B, axis_index=r)
            for r in range(RANKS)]
  step_j = jmake_sharded_step(make_mesh(jax.devices()[:RANKS]), jg, jd, g_tx,
                              d_tx, jcfg, donate=False)
  new_j, metrics_j = _as_mean(*step_j(state, jnp.asarray(real),
                                      jnp.asarray(labels)))

  as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
  g_cfg, d_cfg = GeneratorConfig(**g_kw), DiscriminatorConfig(**d_kw)
  tg, td = weights.from_jax(as_np(state.g_params), as_np(state.g_state),
                            as_np(state.d_params), as_np(state.d_state),
                            g_cfg, d_cfg)
  gan = GANConfig(**gan_kw)
  start = {"g": {k: v.clone() for k, v in tg.state_dict().items()},
           "d": {k: v.clone() for k, v in td.state_dict().items()}}
  args = (g_cfg, d_cfg, gan, start, [real], [labels], [noises])
  return new_j, metrics_j, args, (tg, td), real, labels, _cat_noise(noises)


def _port_state(models, snapshot, ratio):
  """A port state of ``models`` holding ``snapshot`` (``full_state``)."""
  tg, td = models
  st = state_from_modules(tg, td, OptimConfig(), ratio, torch.device("cpu"),
                          seed=0)
  st.g.load_state_dict(snapshot["g"])
  st.d.load_state_dict(snapshot["d"])
  st.g_opt.load_state_dict(snapshot["g_opt"])
  st.d_opt.load_state_dict(snapshot["d_opt"])
  st.step = snapshot["step"]
  return st


@pytest.fixture(scope="module")
def dp_steps():
  """Every case of CASES through JAX and through one job of 2 port ranks,
  with, in the same job, 2 steps with drawn noise for the replication
  check."""
  cases = {name: _case(*spec) for name, spec in CASES.items()}
  calls = [("step_rank", c[2]) for c in cases.values()]
  g_cfg, d_cfg, gan, w, real, labels, _ = cases["cwcsa_projection"][2]
  calls.append(("step_rank", (g_cfg, d_cfg, gan, w, real * 2, labels * 2)))
  ranks = launch.launch("wcgan_tpu_torch.parallel.dryrun:batch_rank",
                        ["cpu"] * RANKS, (calls,), timeout=120, quiet=True)
  out = {}
  for i, (name, (new_j, metrics_j, args, models, real, labels,
                 noise)) in enumerate(cases.items()):
    out[name] = dict(new_j=new_j, metrics_j=metrics_j, args=args,
                     models=models, real=real, labels=labels, noise=noise,
                     ranks=[r[i] for r in ranks])
  out["replication"] = [r[-1] for r in ranks]
  return out


@pytest.fixture(params=sorted(CASES))
def case(request, dp_steps):
  c = dp_steps[request.param]
  ratio = c["args"][2].training_ratio
  st = _port_state(c["models"], c["ranks"][0]["state"], ratio)
  metrics_t = {k: torch.tensor(v) for k, v in
               c["ranks"][0]["metrics"][0].items()}
  return c, st, metrics_t, ratio


def test_dp_step_metrics_match_jax(case):
  c, st, metrics_t, _ = case
  check_metrics(c["new_j"], c["metrics_j"], st, metrics_t)


@pytest.mark.parametrize("model", ["g", "d"])
def test_dp_step_adam_slots_match_jax(case, model):
  c, st, _, _ = case
  check_adam_slots(c["new_j"], st, model)


@pytest.mark.parametrize("model", ["g", "d"])
def test_dp_step_params_match_jax(case, model):
  c, st, _, ratio = case
  check_params(c["new_j"], st, model, ratio=ratio)


@pytest.mark.parametrize("model", ["g", "d"])
def test_dp_step_running_state_matches_jax(case, model):
  c, st, _, _ = case
  check_running_state(c["new_j"], st, model)


def test_dp_step_ranks_agree_and_match_one_process(case):
  """Both ranks hold the same state bit for bit, and the port's own step
  on one process, on the concatenated batch with the concatenated noise,
  gives the ranks' metrics, Adam slots, running state and params within
  the same tolerances."""
  c, st_dp, metrics_dp, ratio = case
  assert replication_errors(c["ranks"][0]["state"],
                            c["ranks"][1]["state"]) == []
  g_cfg, d_cfg, gan = c["args"][:3]
  tg = Generator(g_cfg, torch.Generator().manual_seed(0))
  td = Discriminator(d_cfg, torch.Generator().manual_seed(0))
  tg.load_state_dict(c["args"][3]["g"])
  td.load_state_dict(c["args"][3]["d"])
  st1 = state_from_modules(place(tg, torch.device("cpu")),
                           place(td, torch.device("cpu")), OptimConfig(),
                           ratio, torch.device("cpu"), seed=0)
  metrics_1 = make_outer_step(gan)(st1, c["real"], c["labels"],
                                   noise=c["noise"])
  for k, v in metrics_1.items():
    np.testing.assert_allclose(float(metrics_dp[k]), float(v), rtol=1e-4,
                               err_msg=k)
  one, dp = full_state(st1), c["ranks"][0]["state"]
  for model in ("g", "d"):
    opt_1 = one[f"{model}_opt"]["state"]
    opt_dp = dp[f"{model}_opt"]["state"]
    for slot in ("exp_avg", "exp_avg_sq"):
      peak = max(float(s[slot].abs().max()) for s in opt_1.values())
      for i in opt_1:
        np.testing.assert_allclose(opt_dp[i][slot].numpy(),
                                   opt_1[i][slot].numpy(), rtol=1e-3,
                                   atol=1e-5 * peak,
                                   err_msg=f"{model} {slot} {i}")
    module = st1.g if model == "g" else st1.d
    names = dict(module.named_parameters())
    for k, v in one[model].items():
      got = dp[model][k].numpy()
      if k in names:
        # Adam's first updates are ~lr * sign(g): the sign bound of
        # check_params.
        updates = 1 if model == "g" else ratio
        bound = 2 * LR * sum(np.sqrt((1 - 0.9 ** t) / 0.1)
                             for t in range(1, updates + 1)) + 1e-7
        assert np.abs(got - v.numpy()).max() <= bound, k
      else:
        np.testing.assert_allclose(got, v.numpy(), atol=1e-5, err_msg=k)


def test_dp_state_stays_replicated_over_two_steps(dp_steps):
  """Two steps with the ranks' own draws: every tensor of the state
  (params, statistics, SN vectors, Adam slots and counts, schedules, the
  noise generator) is bit-equal on both ranks."""
  r0, r1 = dp_steps["replication"]
  assert r0["state"]["step"] == 2
  assert replication_errors(r0["state"], r1["state"]) == []
  assert r0["metrics"] == r1["metrics"]
  assert all(np.isfinite(v) for m in r0["metrics"] for v in m.values())


# --- the compiled steps with the group -----------------------------------------


@pytest.fixture(scope="module")
def dp_jit(dp_steps):
  """One job of 2 port ranks: ``make_jit_step(group)`` on JIT_CASES' global
  batches and noise and over 2 steps with drawn noise (the replication
  call's), and ``jit_dp_rank``'s compiled chain of 2 against the eager
  one, 2 calls."""
  calls = [("step_rank", dp_steps[name]["args"] + (0, True))
           for name in JIT_CASES]
  g_cfg, d_cfg, gan, w, real, labels, _ = dp_steps[JIT_CASES[0]]["args"]
  calls.append(("step_rank", (g_cfg, d_cfg, gan, w, real * 2, labels * 2,
                              None, 0, True)))
  calls.append(("jit_dp_rank", (g_cfg, d_cfg, gan, RANKS * B, 2, 2,
                                JIT_DATA)))
  ranks = launch.launch("wcgan_tpu_torch.parallel.dryrun:batch_rank",
                        ["cpu"] * RANKS, (calls,), timeout=240, quiet=True)
  out = {name: [r[i] for r in ranks] for i, name in enumerate(JIT_CASES)}
  out["replication"] = [r[-2] for r in ranks]
  out["chain"] = [r[-1] for r in ranks]
  return out


@pytest.mark.parametrize("name", JIT_CASES)
def test_dp_jit_step_matches_eager_and_jax(name, dp_steps, dp_jit):
  """make_jit_step(group) on the case's global batch and noise: both
  ranks hold the eager sharded step's state bit for bit, with its
  metrics, and so the JAX step's within the tolerances."""
  c = dp_steps[name]
  ratio = c["args"][2].training_ratio
  for eager, jit in zip(c["ranks"], dp_jit[name]):
    assert replication_errors(jit["state"], eager["state"]) == []
    assert jit["metrics"] == eager["metrics"]
  st = _port_state(c["models"], dp_jit[name][1]["state"], ratio)
  metrics_t = {k: torch.tensor(v) for k, v in
               dp_jit[name][1]["metrics"][0].items()}
  check_metrics(c["new_j"], c["metrics_j"], st, metrics_t)
  for model in ("g", "d"):
    check_running_state(c["new_j"], st, model)


def test_dp_jit_step_over_two_steps_equals_the_eager_step(dp_steps, dp_jit):
  """Two compiled steps with the ranks' own draws (a warm-up, then the
  static buffers): the eager step's state bit for bit on each rank, and
  replicated."""
  for eager, jit in zip(dp_steps["replication"], dp_jit["replication"]):
    assert jit["state"]["step"] == 2
    assert replication_errors(jit["state"], eager["state"]) == []
    assert jit["metrics"] == eager["metrics"]
  r0, r1 = dp_jit["replication"]
  assert replication_errors(r0["state"], r1["state"]) == []


def test_dp_jit_dataset_chain_equals_the_eager_chain(dp_jit):
  """make_jit_dataset_step(group), a chain of 2 over 2 calls, against the
  eager chain on the same ranks: metrics, K1 launches and the collectives
  of each call equal, the states bit-equal (and the generators), each
  state replicated on both ranks."""
  ranks = dp_jit["chain"]
  for r in ranks:
    assert r["jit_calls"] == {"warm-up": 1, "capture": 0, "replay": 0,
                              "eager": 1}
    assert r["rel"] == 0.0, r["where"]
    assert r["same_generator"] and r["steps"] == [4, 4]
    for call in r["per_call"]:
      assert call["jit"] == call["eager"]
      assert call["jit"]["calls"]["grads"] == 2 * (RATIO + 1)
      assert call["jit"]["calls"]["moments"] > 0
      assert all(np.isfinite(v) for v in call["jit"]["metrics"].values())
  assert ranks[0]["digests"] == ranks[1]["digests"]
  assert ranks[0]["per_call"] == ranks[1]["per_call"]


def test_dp_chain_collectives_lie_in_mesh_spans(dp_jit):
  """Every all-reduce of the data-parallel chain (eager on the CPU) runs
  inside a span of the port's: one ``mesh.moments`` a statistics
  all-reduce, forward and backward, and one ``mesh.grads`` an update's,
  as ``mesh.STATS`` counts them, on every rank and call of both arms."""
  for r in dp_jit["chain"]:
    for call in r["per_call"]:
      for arm in ("jit", "eager"):
        c = call[arm]
        assert c["spans"] == {"mesh.moments": c["calls"]["moments"],
                              "mesh.grads": c["calls"]["grads"]}, c
