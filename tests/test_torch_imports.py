"""The port imports nothing of the JAX package, and its copies of the JAX
package's numpy modules behave exactly as the originals.

The port (``wcgan_tpu_torch/`` and ``chip_smoke.py``) runs where there is
no JAX. It keeps its own copies of ``wcgan_tpu.data``, ``wcgan_tpu.utils``,
``wcgan_tpu.cli.presets`` and ``wcgan_tpu.tools.h5_convert``; these tests import both sides and
compare them (the tests may import JAX's package, the port may not)."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from wcgan_tpu import data as j_data
from wcgan_tpu.cli import presets as j_presets
from wcgan_tpu.tools import h5_convert as j_h5
from wcgan_tpu.utils import images as j_images
from wcgan_tpu.utils import logging as j_logging
from wcgan_tpu_torch import data as t_data
from wcgan_tpu_torch.cli import presets as t_presets
from wcgan_tpu_torch.tools import h5_convert as t_h5
from wcgan_tpu_torch.utils import images as t_images
from wcgan_tpu_torch.utils import logging as t_logging

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("wcgan_tpu", "jax", "jaxlib", "flax", "optax", "orbax")
PORT_FILES = sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "wcgan_tpu_torch").rglob("*.py"),
              ROOT / "chip_smoke.py"])


def _imported_roots(tree: ast.AST):
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield node.lineno, alias.name
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_no_jax_package(path):
  tree = ast.parse((ROOT / path).read_text(), filename=path)
  bad = [(line, name) for line, name in _imported_roots(tree)
         if name.split(".")[0] in FORBIDDEN]
  assert not bad, f"{path} imports {bad}"


def test_the_walk_sees_every_import_form():
  """The checker itself: each form of import of the JAX package is found,
  and the port's own package is not mistaken for it."""
  src = ("import jax\nimport wcgan_tpu.data as d\nfrom wcgan_tpu import x\n"
         "from flax.linen import y\ndef f():\n  import optax\n"
         "from wcgan_tpu_torch import z\nfrom . import w\n")
  roots = [n.split(".")[0] for _, n in _imported_roots(ast.parse(src))]
  assert [r for r in roots if r in FORBIDDEN] == [
      "jax", "wcgan_tpu", "wcgan_tpu", "flax", "optax"]


def test_entry_points_load_no_jax_package_module():
  code = ("import sys\n"
          "import wcgan_tpu_torch.cli.run, wcgan_tpu_torch.train.trainer\n"
          "import wcgan_tpu_torch.cli.presets\n"
          "import wcgan_tpu_torch.data, wcgan_tpu_torch.utils\n"
          "import wcgan_tpu_torch.tools.h5_convert\n"
          "import wcgan_tpu_torch.parallel.launch\n"
          "import wcgan_tpu_torch.parallel.dryrun\n"
          "import wcgan_tpu_torch.evaluation.scorer\n"
          "import wcgan_tpu_torch.tools.eval_digits_fid\n"
          "import wcgan_tpu_torch.tools.eval_conditional_fidelity\n"
          "import wcgan_tpu_torch.tools.digits_quality\n"
          "print(sorted(m for m in sys.modules if m.split('.')[0] in "
          f"{FORBIDDEN!r}))\n")
  env = dict(os.environ, PYTHONPATH=str(ROOT))
  proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


@pytest.mark.parametrize("seed,size,batch", [(0, 64, 8), (3, 100, 16),
                                             (7, 256, 64)])
def test_synthetic_dataset_copy_matches(seed, size, batch):
  kw = dict(batch_size=batch, seed=seed, z_dim=12, synthetic_size=size)
  a = j_data.get_dataset("synthetic", **kw)
  b = t_data.get_dataset("synthetic", **kw)
  np.testing.assert_array_equal(a.images, b.images)
  assert (a.resolution, a.channels, a.number_of_batches_per_epoch) == (
      b.resolution, b.channels, b.number_of_batches_per_epoch)
  for k in (1, 3, 5):          # crosses an epoch boundary at the small sizes
    for x, y in zip(a.next_batches(k), b.next_batches(k)):
      np.testing.assert_array_equal(x, y)
  for x, y in zip(a.test_batch(10), b.test_batch(10)):
    np.testing.assert_array_equal(x, y)
  np.testing.assert_array_equal(a.real_sample(9), b.real_sample(9))


def test_conditional_dataset_and_registry_copy_match():
  assert t_data.DATASETS == j_data.DATASETS
  kw = dict(batch_size=4, seed=1, conditional=True, synthetic_size=32,
            synthetic_resolution=16)
  a = j_data.get_dataset("synthetic", **kw)
  b = t_data.get_dataset("synthetic", **kw)
  np.testing.assert_array_equal(a.labels, b.labels)
  for x, y in zip(a.test_batch(8), b.test_batch(8)):
    np.testing.assert_array_equal(x, y)
  for mod in (j_data, t_data):
    with pytest.raises(ValueError, match="unknown dataset"):
      mod.get_dataset("nope", batch_size=4)
    with pytest.raises(ValueError, match="uint8"):
      mod.ArrayDataset(np.zeros((2, 4, 4, 1), np.float32), None, 1)


def test_grid_and_png_copy_match(tmp_path, rng):
  imgs = rng.uniform(-1.2, 1.2, (10, 5, 6, 3)).astype(np.float32)
  for cols, pad in ((None, 0), (4, 2)):
    np.testing.assert_array_equal(j_images.make_grid(imgs, cols, pad),
                                  t_images.make_grid(imgs, cols, pad))
  np.testing.assert_array_equal(j_images.to_uint8(imgs),
                                t_images.to_uint8(imgs))
  for grey in (False, True):
    grid = j_images.make_grid(imgs[..., :1] if grey else imgs)
    pa, pb = tmp_path / "a" / f"{grey}.png", tmp_path / "b" / f"{grey}.png"
    j_images.save_png(str(pa), grid)
    t_images.save_png(str(pb), grid)
    assert pa.read_bytes() == pb.read_bytes()


def test_metrics_logger_copy_writes_the_same_lines(tmp_path, capsys):
  dirs = []
  for mod, sub in ((j_logging, "a"), (t_logging, "b")):
    log = mod.MetricsLogger(str(tmp_path / sub))
    log.epoch_line(3, {"d_loss": 0.125, "g_loss": np.float32(-1.5)},
                   extra="imgs/sec = 12.5")
    log.epoch_line(4, {"d_loss": 1})
    log.line("wrote sample grid x.png")
    log.jsonl({"epoch": 3, "imgs_per_sec": 12.5})
    dirs.append(tmp_path / sub)
  out = capsys.readouterr().out.splitlines()
  assert out[:3] == out[3:]
  a, b = dirs
  assert (a / "log.txt").read_text() == (b / "log.txt").read_text()
  ja, jb = (json.loads((d / "metrics.jsonl").read_text()) for d in dirs)
  assert ja.keys() == jb.keys() and ja.pop("ts") <= jb.pop("ts") and ja == jb


KEY_MAPS = [
    None,
    {},
    {"gen/conv/kernel": "g/c/k"},
    {"re:^gen/": "generator/", "re:kernel$": "w", "gen/bias": "b"},
    {"gen/conv/kernel": "gen/bias"},          # collision
]


@pytest.mark.parametrize("key_map", KEY_MAPS)
def test_apply_key_map_copy_matches(key_map, rng):
  flat = {"gen/conv/kernel": rng.standard_normal((2, 3)),
          "gen/bias": rng.standard_normal(3), "disc/dense/kernel": np.ones(2)}
  results = []
  for mod in (j_h5, t_h5):
    try:
      results.append(mod.apply_key_map(flat, key_map))
    except ValueError as e:
      results.append(str(e))
  a, b = results
  if isinstance(a, str):
    assert a == b and "duplicate destination" in a
    return
  assert list(a) == list(b)
  for k in a:
    np.testing.assert_array_equal(a[k], b[k])


def test_h5_flat_copy_matches(tmp_path, rng):
  h5py = pytest.importorskip("h5py")
  path = tmp_path / "w.h5"
  with h5py.File(path, "w") as f:
    f.create_dataset("gen/conv/kernel", data=rng.standard_normal((3, 3)))
    f.create_dataset("gen/bias", data=rng.standard_normal(3))
    f.create_dataset("disc/w", data=np.arange(4))
  key_map = {"re:^gen/": "g/", "disc/w": "d/w"}
  for km in (None, key_map):
    a, b = j_h5.h5_flat(str(path), km), t_h5.h5_flat(str(path), km)
    assert sorted(a) == sorted(b)
    for k in a:
      np.testing.assert_array_equal(a[k], b[k])


def _write_h5(path, tree):
  import h5py
  with h5py.File(path, "w") as f:
    for k, v in tree.items():
      f.create_dataset(k, data=v)


def _read_h5(path):
  import h5py
  out = {}
  with h5py.File(path, "r") as f:
    f.visititems(lambda name, obj: out.__setitem__(name, np.asarray(obj))
                 if isinstance(obj, h5py.Dataset) else None)
  return out


def _assert_same_arrays(a, b):
  assert sorted(a) == sorted(b)
  for k in a:
    assert a[k].dtype == b[k].dtype, k
    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _weights(rng):
  return {"gen/conv/kernel": rng.standard_normal((3, 3)).astype(np.float32),
          "gen/bias": rng.standard_normal(3), "disc/w": np.arange(4),
          "['block0']/['nc1']/['gamma']": rng.standard_normal(5)}


@pytest.mark.parametrize("key_map", [None, {"re:^gen/": "g/", "disc/w": "d/w"}])
def test_h5_to_npz_copy_matches(tmp_path, rng, key_map):
  pytest.importorskip("h5py")
  src = tmp_path / "w.h5"
  _write_h5(src, _weights(rng))
  out = []
  for mod, sub in ((j_h5, "a"), (t_h5, "b")):
    manifest = mod.h5_to_npz(str(src), str(tmp_path / f"{sub}.npz"), key_map)
    with np.load(tmp_path / f"{sub}.npz") as data:
      out.append((manifest, dict(data)))
  (ma, a), (mb, b) = out
  assert ma == mb
  _assert_same_arrays(a, b)


def test_npz_to_h5_copy_matches(tmp_path, rng):
  pytest.importorskip("h5py")
  np.savez(tmp_path / "w.npz", **_weights(rng))
  for mod, sub in ((j_h5, "a"), (t_h5, "b")):
    mod.npz_to_h5(str(tmp_path / "w.npz"), str(tmp_path / f"{sub}.h5"))
  _assert_same_arrays(_read_h5(tmp_path / "a.h5"), _read_h5(tmp_path / "b.h5"))


H5_COMMANDS = {
    "to_npz": ["to_npz", "w.h5", "out.npz"],
    "to_npz_with_map": ["to_npz", "w.h5", "out.npz", "map.json"],
    "to_h5": ["to_h5", "w.npz", "out.h5"],
    "unknown": ["to_zip", "w.h5", "out.zip"],
    "too_few": ["to_npz", "w.h5"],
}


@pytest.mark.parametrize("cmd", sorted(H5_COMMANDS))
def test_h5_convert_main_copy_matches(cmd, tmp_path, rng, capsys):
  """Each module's ``main`` in a directory of its own with the same
  inputs: the same return code and output files, the same printed lines
  (the usage text apart: each names its own module)."""
  pytest.importorskip("h5py")
  tree = _weights(rng)
  results = []
  for mod, sub in ((j_h5, "a"), (t_h5, "b")):
    d = tmp_path / sub
    d.mkdir()
    _write_h5(d / "w.h5", tree)
    np.savez(d / "w.npz", **tree)
    (d / "map.json").write_text(json.dumps({"re:^gen/": "g/"}))
    argv = [str(d / a) if i else a for i, a in enumerate(H5_COMMANDS[cmd])]
    rc = mod.main(argv)
    results.append((rc, capsys.readouterr().out.replace(str(d), "<dir>")))
  (rc_a, out_a), (rc_b, out_b) = results
  assert rc_a == rc_b
  if cmd == "too_few":
    assert rc_b == 2 and "Usage:" in out_a and "Usage:" in out_b
    assert "python -m wcgan_tpu_torch.tools.h5_convert to_npz" in out_b
    return
  assert out_a == out_b
  if cmd.startswith("to_npz"):
    with np.load(tmp_path / "a" / "out.npz") as a, \
        np.load(tmp_path / "b" / "out.npz") as b:
      _assert_same_arrays(dict(a), dict(b))
  elif cmd == "to_h5":
    _assert_same_arrays(_read_h5(tmp_path / "a" / "out.h5"),
                        _read_h5(tmp_path / "b" / "out.h5"))
  else:
    assert rc_b == 2 and "unknown command 'to_zip'" in out_b


def test_h5_convert_runs_as_a_module(tmp_path, rng):
  """``python -m wcgan_tpu_torch.tools.h5_convert`` against ``python -m
  wcgan_tpu.tools.h5_convert``: to_npz, then to_h5 on its output."""
  pytest.importorskip("h5py")
  _write_h5(tmp_path / "w.h5", _weights(rng))
  outs = {}
  for pkg in ("wcgan_tpu", "wcgan_tpu_torch"):
    npz, h5 = tmp_path / f"{pkg}.npz", tmp_path / f"{pkg}.h5"
    printed = []
    for argv in (["to_npz", str(tmp_path / "w.h5"), str(npz)],
                 ["to_h5", str(npz), str(h5)]):
      proc = subprocess.run(
          [sys.executable, "-m", f"{pkg}.tools.h5_convert", *argv], cwd=ROOT,
          env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
          text=True, timeout=120)
      assert proc.returncode == 0, proc.stderr
      printed.append(proc.stdout)
    with np.load(npz) as data:
      outs[pkg] = (printed, dict(data), _read_h5(h5))
  a, b = outs["wcgan_tpu"], outs["wcgan_tpu_torch"]
  assert a[0] == b[0] and "gen/bias (3,)" in b[0][0]
  _assert_same_arrays(a[1], b[1])
  _assert_same_arrays(a[2], b[2])


def test_presets_copy_matches():
  """The BASELINE presets: the same names and argv, and preset_argv
  appends the extra flags and refuses an unknown name alike."""
  assert t_presets.PRESETS == j_presets.PRESETS
  assert list(t_presets.PRESETS) == list(j_presets.PRESETS)
  extra = ["--smoke", "--batch_size", "8"]
  for name in j_presets.PRESETS:
    assert t_presets.preset_argv(name, extra) == j_presets.preset_argv(
        name, extra)
  for mod in (j_presets, t_presets):
    with pytest.raises(KeyError, match="unknown preset 'nope'"):
      mod.preset_argv("nope")
