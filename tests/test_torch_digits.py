"""The port's digits data, the digits judges and their tools against the
JAX package, the reference scripts and sklearn, on the CPU in float32.

- Data: ``wcgan_tpu_torch/data/digits.npz`` holds sklearn's
  ``load_digits()`` arrays exactly, and the port's ``_load_digits`` returns
  exactly the reference's arrays without importing sklearn.
- The feature judge (``tools/eval_digits_fid.py``) against the reference's
  flax ``Judge`` on weights carried by ``weights.judge_from_flax``:
  features, probabilities and one Adam step within 1e-5 (float32, sums in
  another order). FID of the same features: the port's no further from
  float64 than the reference script's, up to 1e-5 relative (the gate of
  ``test_torch_evaluation.py``); the IS helper within 1e-5 relative.
- The fidelity judge (``tools/eval_conditional_fidelity.py``) against
  sklearn's ``LogisticRegression(max_iter=2000)``: sklearn stops at its
  tolerance (objective 17.88 against the optimum's 17.03 here, 169
  iterations), the port's L-BFGS at the optimum, so the two classifiers
  differ a little: predictions agree on >= 99.5 % of the real digits and
  >= 98 % of 640 noisy ones, accuracies within 0.005.
- The digits-shape G: the JAX cWC ``ucconv`` G (128, 128) at 16x16, one
  channel, 10 classes, on weights carried by ``weights``, samples within
  1e-4 of the port's (``test_torch_conditional.py``'s gate).
- Both tools end to end on a tiny digits run of the port's CLI, and
  ``tools/digits_quality.py``, which trains both conditional runs and
  judges them.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from wcgan_tpu.data import datasets as j_datasets
from wcgan_tpu.evaluation import metrics as j_metrics
from wcgan_tpu.models.generator import Generator as JG
from wcgan_tpu.models.generator import GeneratorConfig as JGCfg
from wcgan_tpu_torch import weights
from wcgan_tpu_torch.cli import run as t_run
from wcgan_tpu_torch.data import datasets as t_datasets
from wcgan_tpu_torch.models.generator import Generator, GeneratorConfig
from wcgan_tpu_torch.tools import digits_quality
from wcgan_tpu_torch.tools import eval_conditional_fidelity as t_fidelity
from wcgan_tpu_torch.tools import eval_digits_fid as t_fid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5        # the judges, float32
RTOL = 1e-5        # FID / IS, relative
G_ATOL = 1e-4      # the G's samples (test_torch_conditional.py)


def _reference_fid_script():
  spec = importlib.util.spec_from_file_location(
      "reference_eval_digits_fid",
      os.path.join(REPO, "scripts", "eval_digits_fid.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """One intra-op thread for the module: the suite runs several workers at
  once, and under thread oversubscription the judge's 600 training steps
  took 519 s in place of ~10 s."""
  before = torch.get_num_threads()
  torch.set_num_threads(1)
  try:
    yield
  finally:
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def digits():
  """(16x16 uint8 NHWC images, int32 labels) as the port loads them."""
  return t_datasets._load_digits()


# --- data ----------------------------------------------------------------------


def test_digits_npz_equals_sklearn():
  from sklearn.datasets import load_digits
  d = load_digits()
  images, labels = t_datasets.digits_arrays()
  assert images.dtype == labels.dtype == np.uint8
  assert images.shape == (1797, 8, 8) and labels.shape == (1797,)
  np.testing.assert_array_equal(images.astype(np.float64), d.images)
  np.testing.assert_array_equal(labels.astype(np.int64), d.target)


def test_load_digits_equals_the_reference(digits):
  x, y = digits
  xr, yr = j_datasets._load_digits()
  assert x.dtype == xr.dtype == np.uint8 and y.dtype == yr.dtype == np.int32
  assert x.shape == (1797, 16, 16, 1)
  np.testing.assert_array_equal(x, xr)
  np.testing.assert_array_equal(y, yr)


def test_get_dataset_digits_needs_no_sklearn():
  code = ("import sys\nsys.modules['sklearn'] = None\n"
          "from wcgan_tpu_torch.data import get_dataset\n"
          "ds = get_dataset('digits', batch_size=64, conditional=True)\n"
          "print(ds.images.shape, ds.num_classes, len(ds.labels),\n"
          "      ds.number_of_batches_per_epoch)\n")
  proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                        env=dict(os.environ, PYTHONPATH=REPO),
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.split() == ["(1797,", "16,", "16,", "1)", "10", "1797",
                                 "28"]


# --- the feature judge ---------------------------------------------------------


class FlaxJudge(nn.Module):
  """``scripts/eval_digits_fid.py``'s Judge (a closure there)."""

  @nn.compact
  def __call__(self, x):
    x = nn.relu(nn.Conv(32, (3, 3))(x))
    x = nn.avg_pool(x, (2, 2), (2, 2))
    x = nn.relu(nn.Conv(64, (3, 3))(x))
    x = jnp.mean(x, axis=(1, 2))
    feats = nn.relu(nn.Dense(64)(x))
    logits = nn.Dense(10)(feats)
    return feats, logits


@pytest.fixture(scope="module")
def judges(digits):
  """(flax Judge, its params (biases perturbed off 0), the port's Judge on
  the same weights, a seeded batch (uint8, labels))."""
  x, y = digits
  rng = np.random.default_rng(3)
  idx = rng.integers(0, len(x), 32)
  jmod = FlaxJudge()
  params = jmod.init(jax.random.PRNGKey(0),
                     jnp.asarray(x[:2], jnp.float32) / 127.5 - 1.0)
  params = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
          np.shape(a)).astype(np.float32), params)
  tmod = t_fid.Judge()
  tmod.load_state_dict(weights.judge_from_flax(params))
  return jmod, params, tmod, (x[idx], y[idx])


def test_judge_matches_flax(judges):
  jmod, params, tmod, (u8, _) = judges
  feats_j, logits_j = jmod.apply(params, jnp.asarray(u8, jnp.float32)
                                 / 127.5 - 1.0)
  with torch.no_grad():
    feats_t, logits_t = tmod(t_fid.judge_inputs(u8, "cpu"))
  assert feats_t.shape == (32, 64) and logits_t.shape == (32, 10)
  assert np.abs(np.asarray(feats_j)).max() > 0.1
  np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j),
                             atol=ATOL)
  np.testing.assert_allclose(
      torch.softmax(logits_t, -1).numpy(),
      np.asarray(jax.nn.softmax(logits_j, -1)), atol=ATOL)


def test_judge_adam_step_matches_optax(judges):
  jmod, params, _, (u8, y) = judges
  x = jnp.asarray(u8, jnp.float32) / 127.5 - 1.0
  tx = optax.adam(1e-3)

  def loss_fn(p):
    _, logits = jmod.apply(p, x)
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(y)).mean()

  loss_j, grads = jax.value_and_grad(loss_fn)(params)
  updates, _ = tx.update(grads, tx.init(params))
  want = weights.judge_from_flax(jax.tree_util.tree_map(
      np.asarray, optax.apply_updates(params, updates)))
  tmod = t_fid.Judge()
  tmod.load_state_dict(weights.judge_from_flax(params))
  opt = torch.optim.Adam(tmod.parameters(), lr=1e-3)
  loss_t = t_fid.train_step(tmod, opt, t_fid.judge_inputs(u8, "cpu"),
                            torch.as_tensor(y, dtype=torch.int64))
  np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=RTOL)
  got = tmod.state_dict()
  assert got.keys() == want.keys()
  for k in want:
    np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=ATOL,
                               err_msg=k)


def test_fid_and_is_helpers_match_the_reference_script():
  ref = _reference_fid_script()
  rng = np.random.default_rng(11)
  a = np.maximum(rng.standard_normal((900, 64)), 0).astype(np.float32)
  b = np.maximum(rng.standard_normal((897, 64)) * 1.3 + 0.2, 0).astype(
      np.float32)
  want = float(ref.fid_between(a, b))
  got = t_fid.fid_between(a, b)
  a64, b64 = a.astype(np.float64), b.astype(np.float64)
  import scipy.linalg
  s1, s2 = np.cov(a64, rowvar=False), np.cov(b64, rowvar=False)
  exact = (np.sum((a64.mean(0) - b64.mean(0)) ** 2) + np.trace(s1)
           + np.trace(s2) - 2 * np.trace(scipy.linalg.sqrtm(s1 @ s2).real))
  assert got > 0.1
  assert abs(got - exact) <= abs(want - exact) + RTOL * abs(want), (
      got, want, exact)
  logits = rng.standard_normal((500, 10)) * 2.0
  probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
      np.float32)
  jm, js = j_metrics.inception_score(jnp.asarray(probs))
  tm, ts = t_fid.is_of(probs)
  np.testing.assert_allclose(tm, float(jm), rtol=RTOL)
  np.testing.assert_allclose(ts, float(js), rtol=RTOL, atol=1e-7)


def test_build_feature_net_learns_the_digits(digits):
  """The reference's 600 steps on the CPU reach the reference's ~0.94
  training accuracy (gate 0.90); the contract: uint8 NHWC in, (N, 64)
  float32 features and (N, 10) float32 probabilities out."""
  x, y = digits
  judge_fn, acc = t_fid.build_feature_net(x, y, device="cpu")
  assert acc >= 0.90, acc
  feats, probs = judge_fn(x[:50])
  assert feats.shape == (50, 64) and probs.shape == (50, 10)
  assert feats.dtype == probs.dtype == np.float32
  np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)


# --- the fidelity judge --------------------------------------------------------


@pytest.fixture(scope="module")
def regressions():
  from sklearn.datasets import load_digits
  from sklearn.linear_model import LogisticRegression
  from threadpoolctl import threadpool_limits
  d = load_digits()
  x = d.images.reshape(len(d.images), -1)
  with threadpool_limits(1):      # numpy's BLAS, as one_thread does torch's
    sk = LogisticRegression(max_iter=2000).fit(x, d.target)
  images, labels = t_datasets.digits_arrays()
  w, b = t_fidelity.fit_softmax_regression(
      images.reshape(len(images), -1).astype(np.float64), labels)
  return sk, (w, b), x, d.target


def _agreement(regressions, x, y):
  sk, (w, b), _, _ = regressions
  p_sk, p_t = sk.predict(x), t_fidelity.predict(w, b, x)
  return (p_sk == p_t).mean(), (p_sk == y).mean(), (p_t == y).mean()


def test_softmax_regression_matches_sklearn_on_real_digits(regressions):
  _, _, x, y = regressions
  agree, acc_sk, acc_t = _agreement(regressions, x, y)
  assert agree >= 0.995, agree
  assert abs(acc_sk - acc_t) <= 0.005, (acc_sk, acc_t)


def test_softmax_regression_matches_sklearn_on_noisy_digits(regressions,
                                                            digits):
  """640 real digits at 16x16 plus Gaussian noise of std 0.5 on [-1, 1]
  (a quarter of the range), shrunk by the tool's ``downsample``: both
  judges near 0.94 accuracy, the regime of a GAN's samples."""
  x16, y16 = digits
  rng = np.random.default_rng(0)
  idx = rng.integers(0, len(x16), 640)
  imgs = (x16[idx].astype(np.float32) / 127.5 - 1.0
          + rng.normal(0, 0.5, (640, 16, 16, 1)).astype(np.float32))
  agree, acc_sk, acc_t = _agreement(regressions, t_fidelity.downsample(imgs),
                                    y16[idx])
  assert agree >= 0.98, agree
  assert abs(acc_sk - acc_t) <= 0.005, (acc_sk, acc_t)


def test_downsample_is_the_reference_expression():
  rng = np.random.default_rng(4)
  imgs = rng.uniform(-1.2, 1.2, (30, 16, 16, 1)).astype(np.float32)
  n = len(imgs)
  u8 = (np.clip(imgs, -1, 1) * 127.5 + 127.5)[..., 0]
  small = u8.reshape(n, 8, 2, 8, 2).mean((2, 4)) / 255.0 * 16.0
  got = t_fidelity.downsample(imgs)
  assert got.dtype == small.dtype
  np.testing.assert_array_equal(got, small.reshape(n, -1))


# --- the digits-shape G ----------------------------------------------------------


def test_digits_generator_matches_jax():
  """The cWC ``ucconv`` G of the digits run (128, 128 from 4x4 to 16x16, one
  channel, 10 classes): perturbed flax params and statistics from one
  labelled train-mode forward, carried by ``weights``; eval-mode samples
  of the same z and labels."""
  kw = dict(z_dim=128, resolution=16, base_resolution=4, filters=(128, 128),
            output_channels=1, block_coloring="ucconv",
            last_coloring="ucconv", num_classes=10)
  jg = JG(cfg=JGCfg(**kw))
  rng = np.random.default_rng(8)
  z = rng.standard_normal((16, 128)).astype(np.float32)
  y = rng.integers(0, 10, 16).astype(np.int32)
  variables = jg.init(jax.random.PRNGKey(1), jnp.asarray(z), jnp.asarray(y),
                      train=True)
  params = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
          np.shape(a)).astype(np.float32), variables["params"])
  j0 = jg.clone(cfg=dataclasses.replace(jg.cfg, wc_momentum=0.0))
  _, stats = j0.apply({"params": params, "wc_stats": variables["wc_stats"]},
                      jnp.asarray(z), jnp.asarray(y), train=True,
                      mutable=["wc_stats"])
  stats = jax.tree_util.tree_map(np.asarray, dict(stats))
  want = np.asarray(jg.apply({"params": params, **stats}, jnp.asarray(z),
                             jnp.asarray(y), train=False))
  tg = Generator(GeneratorConfig(**kw), torch.Generator().manual_seed(0))
  tg.load_state_dict(weights.state_dict_from_jax(params, stats))
  with torch.no_grad():
    got = tg(torch.from_numpy(z), torch.from_numpy(y), train=False)
  got = got.permute(0, 2, 3, 1).numpy()
  assert got.shape == want.shape == (16, 16, 16, 1)
  assert np.abs(want).max() > 0.1
  np.testing.assert_allclose(got, want, atol=G_ATOL)


# --- the tools end to end ------------------------------------------------------


NARROW = ["--generator_filters", "16,16", "--discriminator_filters", "16,16",
          "--ns_iters", "6"]


@pytest.fixture(scope="module")
def digits_run(tmp_path_factory):
  """A tiny digits run of the port's CLI on the CPU: the README's flags,
  narrowed, 2 epochs of 1 outer step, a checkpoint each epoch."""
  root = tmp_path_factory.mktemp("digits")
  argv = ["--device", "cpu", "--dataset", "digits", "--gan_type",
          "PROJECTIVE", "--arch", "res", "--batch_size", "64",
          "--generator_block_coloring", "ucconv", "--generator_last_coloring",
          "ucconv", "--bf16", "--number_of_epochs", "2",
          "--batches_per_epoch", "1", "--checkpoint_ratio", "1",
          "--display_ratio", "0", "--output_dir", str(root / "out"),
          "--checkpoints_dir", str(root / "ckpt"), "--name", "digits",
          *NARROW]
  assert t_run.main(argv) == 0
  assert (root / "ckpt" / "digits" / "epoch_1").is_dir()
  return root


def _narrowed(monkeypatch, tool):
  monkeypatch.setattr(tool, "run_argv", lambda args, f=tool.run_argv: (
      f(args) + NARROW))


def test_eval_digits_fid_main_on_a_port_run(digits_run, monkeypatch, capsys):
  _narrowed(monkeypatch, t_fid)
  monkeypatch.setattr(t_fid, "build_feature_net", functools.partial(
      t_fid.build_feature_net, steps=30))
  rc = t_fid.main(["--checkpoints_dir", str(digits_run / "ckpt"),
                   "--output_dir", str(digits_run / "fid"), "--name",
                   "digits", "--samples", "64", "--device", "cpu"])
  out = capsys.readouterr().out.splitlines()
  assert rc == 0, out
  assert out[0].startswith("judge feature net trained: accuracy ")
  assert out[1].startswith("calibration: FID real-split floor ")
  assert out[2:4] == ["| epoch | feature-FID (fake vs real) | IS-analog |",
                      "|---|---|---|"]
  assert [l.split(" | ")[0] for l in out[4:6]] == ["| 0", "| 1"]
  assert out[6].startswith("FID trajectory: ")
  assert out[7].startswith("IS trajectory: ")


def test_eval_conditional_fidelity_main_on_a_port_run(digits_run,
                                                      monkeypatch, capsys):
  _narrowed(monkeypatch, t_fidelity)
  rc = t_fidelity.main(["--checkpoints_dir", str(digits_run / "ckpt"),
                        "--output_dir", str(digits_run / "fidelity"),
                        "--name", "digits", "--samples", "25", "--device",
                        "cpu"])
  out = capsys.readouterr().out.splitlines()
  assert rc == 0, out
  assert out[0] == f"checkpoint: {digits_run / 'ckpt' / 'digits' / 'epoch_1'}"
  assert out[1].startswith("conditional fidelity: ")
  assert out[1].endswith(" over 20 samples (chance = 0.100)")


def test_digits_quality_trains_and_judges_both_runs(tmp_path, monkeypatch,
                                                   capsys):
  """One epoch (5 outer steps) of each conditional run, narrowed: the
  projection-D run gets the FID tool and the fidelity, the AC-GAN run the
  fidelity; no K1 launch on the CPU (the plain moments run there)."""
  for tool in (t_fid, t_fidelity):
    _narrowed(monkeypatch, tool)
  monkeypatch.setattr(digits_quality, "train_argv",
                      lambda *a, f=digits_quality.train_argv: f(*a) + NARROW)
  monkeypatch.setattr(digits_quality, "EPOCHS", 1)
  monkeypatch.setattr(digits_quality, "CHECKPOINT_RATIO", 1)
  monkeypatch.setattr(t_fid, "build_feature_net", functools.partial(
      t_fid.build_feature_net, steps=30))
  assert digits_quality.main([
      "--output_dir", str(tmp_path), "--device", "cpu"]) == 0
  out = capsys.readouterr().out.splitlines()
  runs = json.loads(out[-1])
  assert [r["gan_type"] for r in runs] == ["PROJECTIVE", "AC_GAN"]
  for r in runs:
    assert r["outer_steps"] == 5 and r["k1_launches"] == 0
    assert len(r["epoch_seconds"]) == 1
    assert 0.0 <= r["fidelity"]["fidelity"] <= 1.0
  assert [row[0] for row in runs[0]["fid"]["trajectory"]] == [0]
  assert "fid" not in runs[1]
  assert any(l.startswith("run digits_ac_gan: 1 epochs, 5 outer steps")
             for l in out)


@pytest.mark.parametrize("tool", [t_fid, t_fidelity])
def test_tools_default_to_cuda(tool, tmp_path):
  if torch.cuda.is_available():
    pytest.skip("checks the refusal on a machine without a GPU")
  with pytest.raises(RuntimeError, match="no CUDA GPU"):
    tool.main(["--checkpoints_dir", str(tmp_path), "--output_dir",
               str(tmp_path / "out"), "--name", "none"])
