"""The port's sampling slice against the JAX package's Trainer and CLI.

Both packages build the same experiment from the same flags (a G 16x2 on
the synthetic dataset); the JAX G gets perturbed weights and non-trivial
running statistics, which move to the port through
``wcgan_tpu_torch.weights``. Tolerances and why:

- float images 1e-4 (float32, sums in another order, 15 Newton-Schulz
  iterations per WC layer);
- uint8 images: equal, except where the float image lies within 1e-4 of
  a rounding edge of ``clip(x) * 127.5 + 127.5``; there they may differ
  by 1;
- npz weights: exact (both are the same float32 values).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from wcgan_tpu.cli import run as jrun
from wcgan_tpu.models import layers as jlayers
from wcgan_tpu.tools.h5_convert import npz_to_h5
from wcgan_tpu_torch import weights
from wcgan_tpu_torch.cli import run as trun
from wcgan_tpu_torch.models.generator import Generator
from wcgan_tpu_torch.ops import cuda_wc

ATOL = 1e-4
FLAGS = ["--dataset", "synthetic", "--synthetic_size", "64", "--arch", "res",
         "--generator_filters", "16,16", "--discriminator_filters", "16,16",
         "--batch_size", "8", "--z_dim", "16", "--name", "s"]


def _perturb_g(rng, g, params, g_state):
  """Perturbed G params, and running statistics set to the batch
  statistics of one train-mode forward (momentum 0), as after training."""
  params = jax.tree_util.tree_map(
      lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
          np.shape(a)).astype(np.float32), params)
  g0 = g.clone(cfg=dataclasses.replace(g.cfg, wc_momentum=0.0))
  z = rng.standard_normal((64, g.cfg.z_dim)).astype(np.float32)
  _, g_state = g0.apply({"params": params, **g_state}, jnp.asarray(z),
                        train=True, mutable=["wc_stats"])
  return params, jax.tree_util.tree_map(np.asarray, dict(g_state))


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
  """(JAX Trainer, port Trainer) holding the same G and D."""
  root = tmp_path_factory.mktemp("sampling")
  jt = jrun.build_experiment(jrun.build_parser().parse_args(FLAGS + [
      "--output_dir", str(root / "jax"), "--checkpoints_dir",
      str(root / "jax_ckpt")]))
  g_params, g_state = _perturb_g(np.random.default_rng(5), jt.g,
                                 jt.state.g_params, jt.state.g_state)
  jt.state = jt.state.replace(g_params=g_params, g_state=g_state)
  tt = trun.build_experiment(trun.build_parser().parse_args(FLAGS + [
      "--device", "cpu", "--output_dir", str(root / "torch")]))
  tt.cfg.checkpoints_dir = str(root / "torch_ckpt")
  tt.state.g.load_state_dict(weights.state_dict_from_jax(g_params, g_state))
  tt.state.d.load_state_dict(weights.state_dict_from_jax(
      jt.state.d_params, jt.state.d_state))
  return jt, tt


def _assert_u8_close(got, want, floats):
  """uint8 images equal, or off by one where ``floats`` (the float image)
  lies within 1e-4 of a rounding edge."""
  got, want = np.asarray(got, np.int16), np.asarray(want, np.int16)
  assert got.shape == want.shape
  diff = np.abs(got - want)
  assert diff.max() <= 1
  v = np.clip(np.asarray(floats, np.float64), -1, 1) * 127.5 + 127.5
  edge = np.abs(v - np.round(v)) <= 1e-4 * 127.5
  assert np.all(edge[diff > 0]), np.argwhere((diff > 0) & ~edge)[:5]


def test_sample_matches_jax(trainers):
  jt, tt = trainers
  z, labels = jt.ds.test_batch(8)
  img_j = np.asarray(jt._sample(jt.sampling_state(), jnp.asarray(z),
                                jnp.asarray(labels)))
  img_t = tt.sample(z)
  assert img_t.shape == img_j.shape == (8, 32, 32, 3)
  np.testing.assert_allclose(img_t.numpy(), img_j, atol=ATOL)
  u8_j = np.asarray(jt._sample_u8(jt.sampling_state(), jnp.asarray(z),
                                  jnp.asarray(labels)))
  u8_t = tt.sample_u8(z)
  assert u8_t.dtype == torch.uint8
  _assert_u8_close(u8_t.numpy(), u8_j, img_j)


def test_generate_matches_jax(trainers):
  """Full batches from the seeded numpy generator, the tail sliced off."""
  jt, tt = trainers
  got_j = jt.generate(10, batch=4, rng_seed=7)
  got_t = tt.generate(10, batch=4, rng_seed=7)
  assert got_t.dtype == np.uint8 and got_t.shape == (10, 32, 32, 3)
  rng = np.random.default_rng(7)
  z = np.concatenate([rng.standard_normal((4, 16)).astype(np.float32)
                      for _ in range(3)])[:10]
  _assert_u8_close(got_t, got_j, tt.sample(z).numpy())


def test_save_sample_grid_matches_jax(trainers):
  jt, tt = trainers
  path_j, path_t = jt.save_sample_grid(3), tt.save_sample_grid(3)
  assert os.path.basename(path_t) == "epoch_00003.png"
  grid_j = np.asarray(Image.open(path_j))
  grid_t = np.asarray(Image.open(path_t))
  assert grid_t.shape == grid_j.shape == (256, 256, 3)
  imgs = tt.sample(tt.ds.test_batch(64)[0]).numpy()
  floats = imgs.reshape(8, 8, 32, 32, 3).transpose(0, 2, 1, 3, 4).reshape(
      256, 256, 3)
  _assert_u8_close(grid_t, grid_j, floats)


def test_kernel_eval_sampling_matches_jax(trainers, monkeypatch):
  """G with K2 forced on every WC layer (the plain version on the CPU)
  against the flax G with the Pallas kernel forced on (interpret mode),
  the way bench_ablate.py forces it: one call per WC layer, 5 here."""
  jt, tt = trainers
  monkeypatch.setattr(jlayers, "_pallas_eval_ok",
                      lambda pallas_eval, method: method == "newton_schulz")
  z, _ = jt.ds.test_batch(4)
  variables = {"params": jt.state.g_params, **jt.state.g_state}
  img_j = np.asarray(jax.jit(lambda v, zz: jt.g.apply(v, zz, train=False))(
      variables, jnp.asarray(z)))
  g = Generator(dataclasses.replace(tt.state.g.cfg, kernel_eval=True),
                torch.Generator().manual_seed(0))
  g.load_state_dict(tt.state.g.state_dict())
  calls = []
  real = cuda_wc.whiten_color_apply
  monkeypatch.setattr(cuda_wc, "whiten_color_apply",
                      lambda *a, **k: calls.append(1) or real(*a, **k))
  img_t = g(torch.from_numpy(z), train=False).permute(0, 2, 3, 1)
  assert len(calls) == 5
  np.testing.assert_allclose(img_t.detach().numpy(), img_j, atol=ATOL)


def _flat_params(module):
  return dict(weights._flatten(weights.to_jax(module)[0]))


def _flat_tree(tree):
  return dict(weights._flatten(jax.tree_util.tree_map(np.asarray, tree)))


def _assert_same(flat_a, flat_b):
  assert flat_a.keys() == flat_b.keys()
  for k in flat_a:
    np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=str(k))


def test_port_export_loads_in_jax(trainers):
  jt, tt = trainers
  tt.export_weights(2)
  ckpt = os.path.join(tt.cfg.checkpoints_dir, "s")
  for model, module, params in (("generator", tt.state.g, jt.state.g_params),
                                ("discriminator", tt.state.d,
                                 jt.state.d_params)):
    path = os.path.join(ckpt, f"epoch_2_{model}.npz")
    with np.load(path) as data:
      keys = set(data)
    assert "['block0']/['nc1']/['gamma']" in keys or model != "generator"
    loaded = jrun._load_weights_npz(params, path, model=model)
    _assert_same(_flat_tree(loaded), _flat_params(module))


def _fresh_port(tmp_path, seed=9):
  return trun.build_experiment(trun.build_parser().parse_args(FLAGS + [
      "--device", "cpu", "--output_dir", str(tmp_path), "--seed", str(seed)]))


def test_jax_export_loads_in_port(trainers, tmp_path):
  jt, _ = trainers
  jt.export_weights(1)
  fresh = _fresh_port(tmp_path)
  stats_before = {k: v.clone() for k, v in fresh.state.g.named_buffers()}
  for model, module, params in (("generator", fresh.state.g,
                                 jt.state.g_params),
                                ("discriminator", fresh.state.d,
                                 jt.state.d_params)):
    trun._load_weights_npz(module, os.path.join(
        jt.ckpt_dir, f"epoch_1_{model}.npz"), model=model)
    _assert_same(_flat_params(module), _flat_tree(params))
  # Weights only: the running statistics stay as they were.
  for k, v in fresh.state.g.named_buffers():
    assert torch.equal(v, stats_before[k]), k


def test_key_map_and_missing_init(trainers, tmp_path):
  jt, _ = trainers
  jt.export_weights(1)
  with np.load(os.path.join(jt.ckpt_dir, "epoch_1_generator.npz")) as data:
    flat = dict(data)
  renamed = {"keras/" + k: v for k, v in flat.items()}
  dropped = sorted(renamed)[0]
  del renamed[dropped]
  npz = tmp_path / "renamed.npz"
  np.savez(npz, **renamed)
  kmap = tmp_path / "map.json"
  kmap.write_text(json.dumps({"generator": {"re:^keras/": ""},
                              "discriminator": {}}))
  fresh = _fresh_port(tmp_path)
  g = fresh.state.g
  with pytest.raises(KeyError, match="checkpoint_missing"):
    trun._load_weights_npz(g, str(npz), str(kmap), model="generator")
  before = _flat_params(g)
  lines = []
  trun._load_weights_npz(g, str(npz), str(kmap), model="generator",
                         missing="init", log=lines.append)
  kept = dropped[len("keras/"):]
  assert any("kept at init" in l and kept in l for l in lines)
  got, want = _flat_params(g), _flat_tree(jt.state.g_params)
  for path in got:
    key = "/".join(f"[{k!r}]" for k in path)
    np.testing.assert_array_equal(
        got[path], before[path] if key == kept else want[path])
  bad = tmp_path / "bad.json"
  bad.write_text(json.dumps({"generater": {}}))
  with pytest.raises(ValueError, match="unknown section"):
    trun._load_weights_npz(g, str(npz), str(bad), model="generator")


def test_h5_checkpoint_loads(trainers, tmp_path, monkeypatch):
  pytest.importorskip("h5py")
  jt, _ = trainers
  jt.export_weights(1)
  h5 = str(tmp_path / "g.h5")
  npz_to_h5(os.path.join(jt.ckpt_dir, "epoch_1_generator.npz"), h5)
  g = _fresh_port(tmp_path).state.g
  trun._load_weights_npz(g, h5, model="generator")
  _assert_same(_flat_params(g), _flat_tree(jt.state.g_params))

  def no_h5py(path):
    raise ModuleNotFoundError("No module named 'h5py'")

  monkeypatch.setattr(trun, "h5_flat", no_h5py)
  with pytest.raises(ModuleNotFoundError, match="needs h5py"):
    trun._load_weights_npz(g, h5, model="generator")


def test_cli_phase_test_matches_jax_cli(trainers, tmp_path):
  """``--phase test --generator_checkpoint`` on a JAX-written npz: both
  CLIs replace only G's params, so both sample with the running
  statistics at their initialization (mean 0, cov I), the JAX package's
  behaviour that the port copies (ROADMAP queue 3)."""
  jt, _ = trainers
  jt.export_weights(1)
  npz = os.path.join(jt.ckpt_dir, "epoch_1_generator.npz")
  test = ["--phase", "test", "--generator_checkpoint", npz,
          "--start_epoch", "4"]
  assert jrun.main(["--platform", "auto", *FLAGS, *test, "--output_dir",
                    str(tmp_path / "jax"), "--checkpoints_dir",
                    str(tmp_path / "ckpt")]) == 0
  assert trun.main([*FLAGS, *test, "--device", "cpu", "--output_dir",
                    str(tmp_path / "torch")]) == 0
  grid_j = np.asarray(Image.open(tmp_path / "jax" / "s" / "epoch_00004.png"))
  grid_t = np.asarray(Image.open(tmp_path / "torch" / "s" /
                                 "epoch_00004.png"))
  log = (tmp_path / "torch" / "s" / "log.txt").read_text()
  assert "wrote sample grid" in log
  # The float grid the port sampled: the loaded params, init statistics.
  probe = _fresh_port(tmp_path / "probe", seed=0)    # the CLI's seed
  g = probe.state.g
  trun._load_weights_npz(g, npz, model="generator")
  for name, buf in g.named_buffers():
    want = torch.eye(buf.shape[0]) if name.endswith("cov") else 0 * buf
    assert torch.equal(buf, want), name
  z = probe.ds.test_batch(64)[0]
  imgs = g(torch.from_numpy(z), train=False).permute(0, 2, 3, 1)
  floats = imgs.detach().numpy().reshape(8, 8, 32, 32, 3).transpose(
      0, 2, 1, 3, 4).reshape(256, 256, 3)
  _assert_u8_close(grid_t, grid_j, floats)
  # It is not the grid of the trained statistics.
  z_j = jnp.asarray(z)
  trained = np.asarray(jt._sample(jt.state.replace(
      g_params=jt.state.g_params), z_j, jnp.zeros(64, jnp.int32)))
  assert np.abs(trained - imgs.detach().numpy()).max() > 0.05
