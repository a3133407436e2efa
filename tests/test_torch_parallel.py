"""Data parallelism of the port on CPU ranks over gloo, against the JAX
package under ``shard_map`` on the 8-device CPU mesh (``conftest.py``).

The port's ranks run in fresh interpreters started by
``wcgan_tpu_torch.parallel.launch`` (``file://`` rendezvous in a fresh
directory per job, a join deadline and a collective timeout); the rank
functions live in ``wcgan_tpu_torch.parallel.dryrun``, so a rank imports
neither JAX nor this module, and ``launch`` raises if one did. Jobs: the
moments and the G forward on 2 ranks, the moments on 4, the dry run, a
rank that raises and ranks past their deadline.

Tolerances: moments and their input gradients 1e-5 (float32; the
reference's cross-replica gate), the sharded G forward 2e-5 (the
reference's ``test_sharded_generator_forward_matches_single_device``),
its running statistics 1e-5.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from wcgan_tpu.cli import run as jrun
from wcgan_tpu.models.generator import Generator as JG
from wcgan_tpu.models.generator import GeneratorConfig as JGCfg
from wcgan_tpu.ops import whiten as jwhiten
from wcgan_tpu.parallel import DATA_AXIS, make_mesh
from wcgan_tpu.train import step as jstep
from wcgan_tpu_torch import weights
from wcgan_tpu_torch.cli import run as trun
from wcgan_tpu_torch.device import place
from wcgan_tpu_torch.models.generator import Generator, GeneratorConfig
from wcgan_tpu_torch.ops import cuda_wc
from wcgan_tpu_torch.ops import whiten
from wcgan_tpu_torch.parallel import dryrun, launch, mesh
from wcgan_tpu_torch.train.trainer import check_ema_under_mesh

ROWS, C = 64, 16
ROUTES = {"kernel": True, "plain": False}
G_KW = dict(z_dim=16, resolution=16, base_resolution=4, filters=(16, 16),
            ns_iters=10)
BATCH = 8


def _run(devices, calls, timeout=120):
  return launch.launch("wcgan_tpu_torch.parallel.dryrun:batch_rank",
                       devices, (calls,), timeout=timeout, quiet=True)


@pytest.fixture(scope="module")
def inputs():
  rng = np.random.default_rng(3)
  x = (rng.standard_normal((ROWS, C)) * 3 + 1).astype(np.float32)
  w_mean = rng.standard_normal(C).astype(np.float32)
  w_cov = rng.standard_normal((C, C)).astype(np.float32)
  z = rng.standard_normal((BATCH, G_KW["z_dim"])).astype(np.float32)
  return x, w_mean, w_cov, z


@pytest.fixture(scope="module")
def g_variables(inputs):
  """The flax G's variables, perturbed so that identity inits cannot hide
  a wrong mapping, and the port's state dict of them."""
  rng = np.random.default_rng(4)
  z = inputs[3]
  variables = JG(cfg=JGCfg(**G_KW)).init(jax.random.PRNGKey(2),
                                         jnp.asarray(z), train=True)
  params = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
          np.shape(a)).astype(np.float32), variables["params"])
  state = {k: v for k, v in variables.items() if k != "params"}
  return {"params": params, **state}, weights.state_dict_from_jax(
      params, jax.tree_util.tree_map(np.asarray, state))


# The CLI's experiment on 2 ranks (dryrun.trainer_rank): a conditional
# tiny G/D, 63 synthetic images, a warm-up epoch and a counted one.
TRAINER_ARGV = ["--dataset", "synthetic", "--conditional",
                "--generator_filters", "16,16", "--discriminator_filters",
                "16,16", "--batch_size", "8", "--training_ratio", "2",
                "--z_dim", "16", "--ns_iters", "6", "--batches_per_epoch",
                "2", "--steps_per_call", "2", "--mesh", "2",
                "--display_ratio", "0", "--checkpoint_ratio", "0"]
TRAINER_DATA = {"resolution": 16, "classes": 5, "n": 63, "seed": 0}


@pytest.fixture(scope="module")
def jobs(inputs, g_variables, tmp_path_factory):
  """{world: [per-rank moments results]}, the 2-rank G forwards and the
  2-rank trainer epochs."""
  x, w_mean, w_cov, z = inputs
  out = str(tmp_path_factory.mktemp("trainer"))
  two = _run(["cpu"] * 2, [
      ("moments_rank", (x, w_mean, w_cov)),
      ("forward_rank", (GeneratorConfig(**G_KW), g_variables[1], z)),
      ("trainer_rank", (TRAINER_ARGV + ["--output_dir", out],
                        TRAINER_DATA))])
  four = _run(["cpu"] * 4, [("moments_rank", (x, w_mean, w_cov))])
  return {2: [r[0] for r in two], 4: [r[0] for r in four],
          "forward": [r[1] for r in two], "trainer": [r[2] for r in two]}


def _jax_moments(x, w_mean, w_cov, use_pallas, n):
  """The JAX package's sharded moments on an n-device mesh and the
  gradient of the weighted sum with respect to the global rows."""
  fn = functools.partial(jwhiten.batch_moments, axis_name=DATA_AXIS,
                         use_pallas=use_pallas)
  sharded = jax.shard_map(fn, mesh=make_mesh(jax.devices()[:n]),
                          in_specs=P(DATA_AXIS), out_specs=P())

  def loss(xx):
    mean, cov = sharded(xx)
    return jnp.sum(mean * w_mean) + jnp.sum(cov * w_cov)

  mean, cov = jax.jit(sharded)(jnp.asarray(x))
  grad = jax.jit(jax.grad(loss))(jnp.asarray(x))
  return np.asarray(mean), np.asarray(cov), np.asarray(grad)


def _one_process(x, w_mean, w_cov, use_kernel):
  rows = torch.from_numpy(x.copy()).requires_grad_(True)
  mean, cov = whiten.batch_moments(rows, use_kernel)
  (torch.sum(mean * torch.from_numpy(w_mean))
   + torch.sum(cov * torch.from_numpy(w_cov))).backward()
  return mean.detach().numpy(), cov.detach().numpy(), rows.grad.numpy()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sharded_moments_match_jax_and_one_process(route, world, inputs,
                                                   jobs):
  """Every rank holds the global batch's moments: the kernel route (K1's
  wrapper, its plain version on the CPU, local-mean centred, combined by
  the parallel-variance formula) against the Pallas kernel in interpret
  mode under shard_map, the plain route against the jnp route; both
  against one process on all the rows."""
  x, w_mean, w_cov, _ = inputs
  use_kernel = ROUTES[route]
  mean_j, cov_j, _ = _jax_moments(x, w_mean, w_cov, use_kernel, world)
  mean_1, cov_1, _ = _one_process(x, w_mean, w_cov, use_kernel)
  for r, res in enumerate(jobs[world]):
    got = res[use_kernel]
    for want in ((mean_j, cov_j), (mean_1, cov_1)):
      np.testing.assert_allclose(got["mean"], want[0], atol=1e-5,
                                 err_msg=f"rank {r}")
      np.testing.assert_allclose(got["cov"], want[1], atol=1e-5,
                                 err_msg=f"rank {r}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sharded_moment_gradients_match_one_process(route, world, inputs,
                                                    jobs):
  """The ranks' input gradients, concatenated, equal the gradient of one
  process on all the rows and JAX's through shard_map: the cotangents of
  the mean and covariance cross the ranks before K1's backward turns them
  into dx (without that sum each rank would see only its own share)."""
  x, w_mean, w_cov, _ = inputs
  use_kernel = ROUTES[route]
  _, _, grad_j = _jax_moments(x, w_mean, w_cov, use_kernel, world)
  _, _, grad_1 = _one_process(x, w_mean, w_cov, use_kernel)
  got = np.concatenate([res[use_kernel]["grad"] for res in jobs[world]])
  np.testing.assert_allclose(got, grad_1, atol=1e-5)
  np.testing.assert_allclose(got, grad_j, atol=1e-5)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_batch_moments_without_a_group_is_unchanged(use_kernel, inputs):
  """``group=None`` is the one-process path, bit for bit."""
  x = torch.from_numpy(inputs[0])
  mean, cov = whiten.batch_moments(x, use_kernel, None)
  want = (cuda_wc.moments(x) if use_kernel
          else cuda_wc.moments_reference(x))
  assert torch.equal(mean, want[0]) and torch.equal(cov, want[1])


def test_sharded_generator_forward_matches_jax_and_one_process(
    inputs, g_variables, jobs):
  """A train-mode G forward on 2 ranks of 4 images each: the images,
  concatenated, against the JAX package's sharded forward and against
  one process on the 8 (2e-5), and the running statistics it leaves on
  each rank against JAX's (1e-5)."""
  z = inputs[3]
  variables = g_variables[0]
  jg = JG(cfg=JGCfg(**G_KW, axis_name=DATA_AXIS))

  def fwd(zz):
    return jg.apply(variables, zz, train=True, mutable=["wc_stats"])

  out_j, mut_j = jax.jit(jax.shard_map(
      fwd, mesh=make_mesh(jax.devices()[:2]), in_specs=P(DATA_AXIS),
      out_specs=(P(DATA_AXIS), P())))(jnp.asarray(z))
  g1 = place(Generator(GeneratorConfig(**G_KW),
                       torch.Generator().manual_seed(0)), torch.device("cpu"))
  g1.load_state_dict(g_variables[1])
  out_1 = g1(torch.from_numpy(z), train=True).permute(0, 2, 3, 1).detach()
  got = np.concatenate([res["out"] for res in jobs["forward"]])
  np.testing.assert_allclose(got, np.asarray(out_j), atol=2e-5)
  np.testing.assert_allclose(got, out_1.numpy(), atol=2e-5)
  want = weights.state_dict_from_jax({}, jax.tree_util.tree_map(
      np.asarray, dict(mut_j)))
  for r, res in enumerate(jobs["forward"]):
    for k, v in want.items():
      np.testing.assert_allclose(res["stats"][k].numpy(), v.numpy(),
                                 atol=1e-5, err_msg=f"rank {r} {k}")


def test_trainer_ranks_hold_blocks_of_the_data_and_stay_replicated(jobs):
  """Each rank stages its block of the 62 rows (63 rounded down to whole
  blocks); after 2 epochs of 2 steps the state is bit-equal on both
  ranks; a step all-reduces the moments of its 5 WC layers twice (mean,
  covariance) in each of its 4 passes (2 D-phase forwards, the G
  update's forward and backward) and the gradients once an update."""
  r0, r1 = jobs["trainer"]
  assert r0["rows"] == r1["rows"] == 31
  assert r0["state"]["step"] == 4 and r0["steps"] == 2
  assert dryrun.replication_errors(r0["state"], r1["state"]) == []
  assert r0["calls"] == {"moments": 2 * 40, "grads": 2 * 3}
  assert all(np.isfinite(v) for v in r0["metrics"].values())


def test_dryrun_multichip_on_two_ranks():
  """The port's dryrun_multichip: the three configurations each take one
  bit-replicated data-parallel step and pass the global-batch forward
  gates (float32 within 2e-5)."""
  report = dryrun.dryrun_multichip(2, timeout=120)
  assert len(report) == 3
  for name, res in report.items():
    assert res["max_dev"]["float32"] <= 2e-5, name
    assert all(np.isfinite(v) for v in res["metrics"].values()), name


def test_a_failing_rank_fails_the_job(inputs):
  """63 rows do not split over 2 ranks: the ranks raise, and the job
  fails with a rank's traceback."""
  x, w_mean, w_cov, _ = inputs
  with pytest.raises(launch.RankFailed, match="do not split into 2"):
    _run(["cpu"] * 2, [("moments_rank", (x[:63], w_mean, w_cov))])


def test_ranks_past_their_deadline_are_stopped(inputs):
  x, w_mean, w_cov, _ = inputs
  t0 = time.monotonic()
  with pytest.raises(launch.RankFailed, match="still running after 0.2 s"):
    _run(["cpu"] * 2, [("moments_rank", (x, w_mean, w_cov))], timeout=0.2)
  assert time.monotonic() - t0 < 30


def test_mesh_helpers():
  assert mesh.shard_block(8, 1, 2) == (4, 8)
  with pytest.raises(ValueError, match="do not split"):
    mesh.shard_block(8, 0, 3)
  cpu, c0, c1 = (torch.device(d) for d in ("cpu", "cuda:0", "cuda:1"))
  assert mesh.backend_for([cpu, cpu]) == "gloo"
  assert mesh.backend_for([c0, c0]) == "gloo"       # one card, two ranks
  assert mesh.backend_for([c0, c1]) == "nccl"
  x = torch.ones(3, requires_grad=True)
  assert mesh.pmean(x, None) is x and mesh.world_size(None) == 1


def test_rank_generators_differ_and_keep_the_state_replicated():
  """Two ranks with the same replicated generator draw apart, and the
  replicated generator advances alike on both."""
  a, b = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
  ga, gb = mesh.rank_generator(a, 0), mesh.rank_generator(b, 1)
  assert torch.equal(a.get_state(), b.get_state())
  assert not torch.equal(a.get_state(),
                         torch.Generator().manual_seed(7).get_state())
  assert not torch.equal(torch.rand(4, generator=ga),
                         torch.rand(4, generator=gb))
  again = mesh.rank_generator(torch.Generator().manual_seed(7), 0)
  assert torch.equal(torch.rand(4, generator=again),
                     torch.rand(4, generator=mesh.rank_generator(
                         torch.Generator().manual_seed(7), 0)))


def test_reference_sums_replicated_gradients():
  """A fault of the reference under this JAX (ROADMAP queue 3):
  ``shard_map`` differentiates a replicated parameter into the SUM of the
  replicas' gradients, and the step's ``_pmean`` of that replicated value
  leaves it, so the sharded step's gradients are N times the global
  batch's. The port averages (``mesh.pmean_many``)."""
  x = jnp.arange(4.0)

  def local(w, xx):
    return jstep._pmean(jax.grad(lambda v: jnp.mean(v * xx))(w), DATA_AXIS)

  for n in (2, 4):
    got = jax.jit(jax.shard_map(local, mesh=make_mesh(jax.devices()[:n]),
                                in_specs=(P(), P(DATA_AXIS)),
                                out_specs=P()))(jnp.float32(1.0), x)
    assert float(got) == pytest.approx(n * float(jnp.mean(x)))


def test_reference_ema_standing_statistics_fail_under_mesh(tmp_path):
  """Another fault of the reference (ROADMAP queue 3): with --mesh and
  --generator_ema its standing statistics apply G, whose layers name the
  mesh axis, outside shard_map, and sampling fails. The port refuses the
  combination by name, before it starts a rank."""
  argv = ["--platform", "cpu", "--dataset", "synthetic", "--synthetic_size",
          "16", "--generator_filters", "8,8", "--discriminator_filters",
          "8,8", "--batch_size", "4", "--z_dim", "8", "--mesh", "2",
          "--generator_ema", "0.999", "--output_dir", str(tmp_path / "j"),
          "--checkpoints_dir", str(tmp_path / "jc")]
  trainer = jrun.build_experiment(jrun.build_parser().parse_args(argv))
  with pytest.raises(NameError, match="unbound axis name"):
    trainer.sampling_state()
  targv = [a for a in argv[2:] if "tmp" not in a and "_dir" not in a]
  targv += ["--device", "cpu", "--output_dir", str(tmp_path / "t"),
            "--checkpoints_dir", str(tmp_path / "tc")]
  with pytest.raises(SystemExit, match="--mesh with --generator_ema and "
                     "--ema_standing_stats > 0 is not supported"):
    trun.main(targv)
  assert not (tmp_path / "t").exists() and not (tmp_path / "tc").exists()
  check_ema_under_mesh(True, 0.999, 0)       # raw statistics: allowed
  check_ema_under_mesh(False, 0.999, 16)
