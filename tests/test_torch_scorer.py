"""The port's scorer against the JAX package's, on the CPU.

Both packages' InceptionV3 is replaced by one tiny deterministic net (the
pattern of tests/test_evaluation.py): the logic under test is the
scorer's. Scores agree within 1e-5 relative. Then the real network
through the CLI, as the trainer's epoch hook and under ``--phase test``,
and the scorer on 2 gloo ranks (``--mesh 2``) against one process, within
1e-4 relative (the ranks' rows are one process's, gathered; the scores
differ by float32 reordering at most)."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cli import REPO, RUN_AS_MAIN, TINY
from test_torch_evaluation import _eigh_fid64
from wcgan_tpu.data import get_dataset as j_get_dataset
from wcgan_tpu.evaluation import scorer as j_scorer
from wcgan_tpu_torch.data import get_dataset as t_get_dataset
from wcgan_tpu_torch.evaluation import scorer as t_scorer
from wcgan_tpu_torch.parallel import launch, mesh

RTOL = 1e-5
MESH_RTOL = 1e-4
# IS's split scores lie near 1 with these nets, where float32's spacing is
# 1.19e-7: their std is held to that absolutely.
STD_ATOL = float(np.finfo(np.float32).eps)


@pytest.fixture
def one_thread():
  """One intra-op thread for the test's own work: the suite runs several
  workers at once, and MKL's 2,048-d eigh and SVD under thread
  oversubscription slow down by orders of magnitude."""
  before = torch.get_num_threads()
  torch.set_num_threads(1)
  try:
    yield
  finally:
    torch.set_num_threads(before)


def _run(args):
  """test_torch_cli's fresh-interpreter CLI run, on one thread (as
  ``one_thread``)."""
  env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
  return subprocess.run([sys.executable, "-c", RUN_AS_MAIN, *args],
                        cwd=REPO, env=env, capture_output=True, text=True,
                        timeout=300)


def _assert_scores_close(got, want, rtol, keys=None):
  for k in keys or want:
    np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k,
                               atol=STD_ATOL if "std" in k else 0)


class JaxTinyNet:
  def apply(self, variables, x):
    pool = jnp.mean(x, axis=(1, 2))
    return pool, jnp.concatenate([pool, -pool], -1)


class TinyNet(torch.nn.Module):
  """JaxTinyNet on NCHW images."""

  def forward(self, x):
    pool = x.mean(dim=(2, 3))
    return pool, torch.cat([pool, -pool], -1)


class FakeTrainer:
  """generate() of seeded random images, counted; a logger that keeps its
  lines."""

  device = torch.device("cpu")

  def __init__(self):
    self.calls = 0
    self.lines = []
    self.logger = self
    self.line = self.lines.append

  def generate(self, n, batch=256, rng_seed=0):
    self.calls += 1
    rng = np.random.default_rng(rng_seed)
    return rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


@pytest.fixture
def tiny(monkeypatch):
  monkeypatch.setattr(j_scorer.inception_v3, "init_params",
                      lambda rng=None: (JaxTinyNet(), {}))
  monkeypatch.setattr(t_scorer.inception_v3, "init_params",
                      lambda seed=0: TinyNet())


def _datasets(size=64):
  return (j_get_dataset("synthetic", batch_size=8, synthetic_size=size),
          t_get_dataset("synthetic", batch_size=8, synthetic_size=size))


@pytest.mark.parametrize("which", [(True, True), (True, False),
                                   (False, True)])
def test_scorer_matches_jax(tiny, which):
  compute_is, compute_fid = which
  j_ds, t_ds = _datasets()
  kw = dict(compute_is=compute_is, compute_fid=compute_fid,
            samples_inception=36, samples_fid=20, batch=8)
  want = j_scorer.make_scorer(j_ds, **kw)(FakeTrainer())
  trainer = FakeTrainer()
  got = t_scorer.make_scorer(t_ds, **kw)(trainer)
  assert set(got) == set(want) and got
  assert all(k.startswith("unverified_") for k in got)
  _assert_scores_close(got, want, RTOL)
  # With both metrics on, FID's fakes are the IS pass's first images.
  assert trainer.calls == 1
  assert any("(FID pool piggybacked)" in l
             for l in trainer.lines) == (compute_is and compute_fid)


def test_scorer_piggyback_equals_separate_runs_and_caches_real(tiny):
  _, ds = _datasets()
  both = t_scorer.make_scorer(ds, samples_inception=32, samples_fid=16,
                              batch=8)
  out = both(FakeTrainer())
  sep = {**t_scorer.make_scorer(ds, compute_fid=False, samples_inception=32,
                                batch=8)(FakeTrainer()),
         **t_scorer.make_scorer(ds, compute_is=False, samples_fid=16,
                                batch=8)(FakeTrainer())}
  assert set(out) == set(sep)
  _assert_scores_close(out, sep, RTOL)
  real_sample = ds.real_sample
  ds.real_sample = None            # a second call must not read it again
  try:
    again = both(FakeTrainer())
  finally:
    ds.real_sample = real_sample
  assert again == out


def test_scorer_warns_on_a_small_dataset_and_prefixes(tiny, monkeypatch):
  j_ds, t_ds = _datasets(size=12)
  trainer = FakeTrainer()
  kw = dict(compute_is=False, samples_fid=20, batch=8)
  got = t_scorer.make_scorer(t_ds, **kw)(trainer)
  want = j_scorer.make_scorer(j_ds, **kw)(FakeTrainer())
  np.testing.assert_allclose(got["unverified_fid"], want["unverified_fid"],
                             rtol=RTOL)
  assert any("WARNING dataset has only 12 real images (< samples_fid 20)"
             in l for l in trainer.lines), trainer.lines
  # With a weights file the keys carry no prefix.
  monkeypatch.setattr(t_scorer.inception_v3, "load_npz",
                      lambda path: TinyNet())
  verified = t_scorer.make_scorer(t_ds, inception_weights="iv3.npz",
                                  **kw)(FakeTrainer())
  assert verified == {"fid": got["unverified_fid"]}


def _apply(x):
  """Pool rows numbered within their batch."""
  n = x.shape[0]
  pool = torch.arange(n, dtype=torch.float32)[:, None].expand(n, 4)
  return pool, torch.full((n, 3), 1 / 3)


def test_activations_selective_fetch_cap_and_tail():
  seen = []

  def apply_fn(x):
    seen.append(x.shape[0])
    return _apply(x)

  imgs = np.zeros((10, 2, 2, 3), np.uint8)
  cpu = torch.device("cpu")
  pools, probs = t_scorer._activations(apply_fn, imgs, 8, cpu)
  assert pools.shape == (10, 4) and probs.shape == (10, 3)
  assert seen == [8, 2]            # the tail is not padded
  pools, probs = t_scorer._activations(apply_fn, imgs, 3, cpu,
                                       want_pool=False)
  assert pools is None and probs.shape == (10, 3)
  pools, probs = t_scorer._activations(apply_fn, imgs, 3, cpu,
                                       want_probs=False)
  assert probs is None and pools.shape == (10, 4)
  pools, probs = t_scorer._activations(apply_fn, imgs, 4, cpu, pool_rows=6)
  assert probs.shape == (10, 3) and pools.shape == (6, 4)
  assert pools[:, 0].tolist() == [0, 1, 2, 3, 0, 1]
  with pytest.raises(ValueError, match="pool_rows=11 exceeds available "
                     "rows 10"):
    t_scorer._activations(apply_fn, imgs, 4, cpu, pool_rows=11)


@pytest.mark.parametrize("n,world", [(10, 2), (10, 3), (7, 4), (4, 4)])
def test_split_block_covers_the_rows_in_order(n, world):
  blocks = [mesh.split_block(n, r, world) for r in range(world)]
  assert blocks[0][0] == 0 and blocks[-1][1] == n
  assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
  sizes = [hi - lo for lo, hi in blocks]
  assert max(sizes) - min(sizes) <= 1
  if n % world == 0:
    assert blocks == [mesh.shard_block(n, r, world) for r in range(world)]


SCORING = ["--compute_inception_score", "1", "--compute_fid", "1",
           "--samples_inception", "20", "--samples_fid", "10"]
KEYS = ("unverified_inception_score", "unverified_is_std", "unverified_fid")


def test_cli_scores_every_epoch_and_in_phase_test(tmp_path):
  """The real InceptionV3 (random weights) through the CLI, in fresh
  interpreters that never import JAX: scores after each epoch in log.txt
  and metrics.jsonl, then after --phase test's grid."""
  base = ["--device", "cpu", "--output_dir", str(tmp_path), *TINY,
          *SCORING, "--score_every", "1"]
  proc = _run(base + ["--checkpoints_dir", str(tmp_path / "ck"),
                      "--checkpoint_ratio", "2"])
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert "NO_JAX_IMPORTED" in proc.stdout
  lines = (tmp_path / "tiny" / "log.txt").read_text().splitlines()
  scored = [l for l in lines if l.startswith("Epoch ")
            and "unverified_fid = " in l]
  assert [l.split(":")[0] for l in scored] == ["Epoch 0", "Epoch 1"]
  assert all(k + " = " in l for l in scored for k in KEYS)
  assert sum("scorer: IS over 20 samples" in l for l in lines) == 2
  assert sum("real moments" in l for l in lines) == 2
  records = [json.loads(l) for l in
             (tmp_path / "tiny" / "metrics.jsonl").read_text().splitlines()]
  scores = [r for r in records if KEYS[0] in r]
  assert [r["epoch"] for r in scores] == [0, 1]
  assert all(np.isfinite(r[k]) for r in scores for k in KEYS)
  npz = tmp_path / "ck" / "tiny" / "epoch_1_generator.npz"
  proc = _run(["--device", "cpu", "--output_dir", str(tmp_path / "test"),
               *TINY, *SCORING, "--phase", "test", "--generator_checkpoint",
               str(npz)])
  assert proc.returncode == 0, proc.stdout + proc.stderr
  lines = (tmp_path / "test" / "tiny" / "log.txt").read_text().splitlines()
  grid = [i for i, l in enumerate(lines) if "wrote sample grid" in l]
  assert len(grid) == 1 and grid[0] < len(lines) - 1
  assert all(k + " = " in lines[-1] for k in KEYS), lines[-3:]


def test_smoke_turns_scoring_off():
  from wcgan_tpu_torch.cli import run as trun
  args = trun.build_parser().parse_args(SCORING + ["--smoke"])
  trun._apply_smoke(args)
  assert args.compute_inception_score == 0 and args.compute_fid == 0


def test_scorer_on_two_ranks_equals_one_process(tmp_path, one_thread):
  """--mesh 2's scorer (the CLI's, on the trainer of the CLI's
  experiment) on 2 gloo ranks: each rank runs InceptionV3 on 10 of the 20
  images, rank 1's pool block is empty (FID's 10 are rank 0's), and the
  rows are gathered; every rank returns one process's scores: IS within
  MESH_RTOL; FID within MESH_RTOL or, where float32 loses more (10 rows
  of random-weight features in 2,048 dimensions), within one process's
  own distance from the float64 FID of its rows."""
  from wcgan_tpu_torch.evaluation import inception_v3
  from wcgan_tpu_torch.parallel import dryrun
  argv = ["--device", "cpu", "--output_dir", str(tmp_path), *TINY,
          *SCORING, "--mesh", "2"]
  synthetic = {"resolution": 32, "classes": 10, "n": 64, "seed": 0}
  ranks = launch.launch("wcgan_tpu_torch.parallel.dryrun:scorer_rank",
                        ["cpu", "cpu"], (argv, synthetic), timeout=600)
  cpu = launch.RankContext(None, 0, 1, torch.device("cpu"))
  one = dryrun.scorer_rank(cpu, argv, synthetic)
  assert set(one["scores"]) == set(KEYS) and one["calls"] == {}
  trainer = dryrun._experiment(cpu, argv, synthetic)
  net = inception_v3.init_params()

  def apply_fn(x):
    with torch.no_grad():
      return net(inception_v3.preprocess(x))

  cut = dict(want_probs=False, batch=100, device=cpu.device)
  fake, _ = t_scorer._activations(apply_fn, trainer.generate(10), **cut)
  real, _ = t_scorer._activations(apply_fn, trainer.ds.real_sample(10),
                                  **cut)
  x, y = (np.asarray(a, np.float64) for a in (real, fake))
  fid64 = _eigh_fid64(x.mean(0), np.cov(x, rowvar=False), y.mean(0),
                      np.cov(y, rowvar=False))
  want = one["scores"]["unverified_fid"]
  gate = max(MESH_RTOL * want, abs(want - fid64))
  for r in ranks:
    assert r["scores"].keys() == one["scores"].keys()
    _assert_scores_close(r["scores"], one["scores"], MESH_RTOL,
                         keys=KEYS[:2])
    assert abs(r["scores"]["unverified_fid"] - want) <= gate, (r, want,
                                                               gate)
    # IS pass: pool and probability rows; real pass: pool rows.
    assert r["calls"] == {"rows": 3}
  assert any("FID pool piggybacked" in l for l in ranks[0]["log"])


def test_trainer_scores_every_n_epochs_and_returns_them(tmp_path):
  """TrainerConfig.score_every: the scorer runs after epochs N, 2N, ...,
  its scores go to log.txt and metrics.jsonl with the epoch and into the
  dict train() returns; with score_every 0 it never runs."""
  from wcgan_tpu_torch.cli import run as trun
  calls = []

  def scorer(trainer):
    calls.append(trainer.state.step)
    return {"unverified_fid": 0.5 + len(calls)}

  for every, want in ((2, [4]), (0, [])):
    args = trun.build_parser().parse_args(
        ["--device", "cpu", "--output_dir", str(tmp_path / str(every)),
         *TINY])
    trainer = trun.build_experiment(args)
    trainer.scorer, trainer.cfg.score_every = scorer, every
    del calls[:]
    out = trainer.train()
    assert calls == want
    lines = (tmp_path / str(every) / "tiny" / "log.txt").read_text()
    records = [json.loads(l) for l in (tmp_path / str(every) / "tiny"
                                       / "metrics.jsonl").read_text()
               .splitlines()]
    scored = [r for r in records if "unverified_fid" in r]
    if want:
      assert "Epoch 1: unverified_fid = 1.5000" in lines
      assert scored == [{"epoch": 1, "unverified_fid": 1.5,
                         "ts": scored[0]["ts"]}]
      assert out["unverified_fid"] == 1.5 and "d_loss" in out
    else:
      assert not scored and "unverified_fid" not in out
