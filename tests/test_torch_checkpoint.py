"""Full-state checkpoints and ``--resume`` of the port, against the JAX
package's behaviour (tests/test_checkpoint.py, tests/test_e2e.py).

The full state is everything an outer step reads or writes: G and D with
their statistics and SN vectors, both Adams and LR schedules, the EMA
shadow, the noise generator and the outer-step counts. A restore must give
it back bit for bit, and on the CPU two outer steps from the restored state
must equal two from the live one bit for bit (the same float32 ops on the
same inputs)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from wcgan_tpu.cli import run as jrun
from wcgan_tpu_torch.cli import run as trun
from wcgan_tpu_torch.train.trainer import CKPT_FILE

FLAGS = ["--dataset", "synthetic", "--synthetic_size", "64", "--arch", "res",
         "--generator_filters", "16,16", "--discriminator_filters", "16,16",
         "--batch_size", "8", "--training_ratio", "2", "--z_dim", "16",
         "--ns_iters", "6", "--batches_per_epoch", "2", "--steps_per_call",
         "1", "--display_ratio", "0", "--name", "ck"]


def _port(out, ckpt, *extra):
  return trun.build_experiment(trun.build_parser().parse_args(
      FLAGS + ["--device", "cpu", "--output_dir", str(out),
               "--checkpoints_dir", str(ckpt), *extra]))


def _assert_bit_equal(a, b, where="state"):
  """Nested dicts/lists of tensors and numbers, equal bit for bit."""
  if isinstance(a, dict):
    assert isinstance(b, dict) and a.keys() == b.keys(), where
    for k in a:
      _assert_bit_equal(a[k], b[k], f"{where}/{k}")
  elif isinstance(a, (list, tuple)):
    assert len(a) == len(b), where
    for i, (x, y) in enumerate(zip(a, b)):
      _assert_bit_equal(x, y, f"{where}/{i}")
  elif torch.is_tensor(a):
    assert torch.is_tensor(b) and a.dtype == b.dtype, where
    assert a.shape == b.shape and a.device == b.device, where
    assert torch.equal(a, b), where
  else:
    assert a == b, where


@pytest.fixture
def trained(tmp_path):
  """A port trainer after one epoch of 2 outer steps with EMA, and its
  epoch-0 checkpoint."""
  tt = _port(tmp_path / "o", tmp_path / "c", "--generator_ema", "0.5",
             "--number_of_epochs", "1", "--checkpoint_ratio", "1")
  tt.train()
  return tt


def test_full_state_roundtrip_bit_exact(trained, tmp_path):
  tt = trained
  path = tt.checkpoint_path(0)
  assert os.path.isfile(os.path.join(path, CKPT_FILE))
  saved = torch.load(os.path.join(path, CKPT_FILE), weights_only=True)
  assert saved["step"] == 2 and saved["outer_steps_done"] == 2
  fresh = _port(tmp_path / "o2", tmp_path / "c", "--generator_ema", "0.5")
  version = fresh.state.g_version
  fresh.restore_checkpoint(path)
  _assert_bit_equal(fresh.full_state(), saved)
  _assert_bit_equal(fresh.full_state(), tt.full_state())
  assert fresh.state.g_version > version
  # Restored in place: the 4-D weights and the shadow keep their layout.
  for name, p in fresh.state.g.named_parameters():
    if p.dim() == 4:
      assert p.is_contiguous(memory_format=torch.channels_last), name
      assert fresh.state.g_ema[name].is_contiguous(
          memory_format=torch.channels_last), name


def test_resume_continues_bit_exact(trained, tmp_path):
  """Two outer steps from the live state and from the restored one."""
  tt = trained
  fresh = _port(tmp_path / "o2", tmp_path / "c", "--generator_ema", "0.5")
  fresh.restore_checkpoint(tt.checkpoint_path(0))
  for trainer in (tt, fresh):
    for _ in range(2):
      trainer.step_fn(trainer.state, *trainer._device_data)
  _assert_bit_equal(fresh.full_state(), tt.full_state())
  assert tt.state.step == 4


def test_restore_refuses_other_ema_setting(trained, tmp_path):
  fresh = _port(tmp_path / "o2", tmp_path / "c")
  with pytest.raises(ValueError, match="--generator_ema must match"):
    fresh.restore_checkpoint(trained.checkpoint_path(0))


def test_latest_checkpoint_skips_npz(trained, tmp_path):
  tt = trained
  tt.save_checkpoint(7)
  names = set(os.listdir(tt.ckpt_dir))
  assert {"epoch_0", "epoch_7", "epoch_7_generator.npz",
          "epoch_7_discriminator.npz"} <= names
  assert tt.latest_checkpoint() == tt.checkpoint_path(7)
  empty = _port(tmp_path / "o3", tmp_path / "none")
  assert empty.latest_checkpoint() is None


def test_resume_auto_infers_start_epoch(tmp_path):
  """--resume auto continues the epoch schedule from the checkpoint, and
  the epochs before it do not run again."""
  base = FLAGS + ["--device", "cpu", "--output_dir", str(tmp_path / "o"),
                  "--checkpoints_dir", str(tmp_path / "c"),
                  "--checkpoint_ratio", "1"]
  assert trun.main(base + ["--number_of_epochs", "2"]) == 0
  assert trun.main(base + ["--number_of_epochs", "4", "--resume",
                           "auto"]) == 0
  log = (tmp_path / "o" / "ck" / "log.txt").read_text()
  assert "(start_epoch 2)" in log
  assert "Epoch 2:" in log and "Epoch 3:" in log
  assert log.count("Epoch 0:") == 1 and log.count("Epoch 1:") == 1


def test_phase_test_after_resume_samples_restored_state(trained, tmp_path):
  """--phase test --resume auto: the grid of the restored G, its running
  statistics and EMA shadow included (with standing statistics)."""
  tt = trained
  argv = FLAGS + ["--device", "cpu", "--output_dir", str(tmp_path / "t"),
                  "--checkpoints_dir", str(tmp_path / "c"),
                  "--generator_ema", "0.5", "--resume", "auto",
                  "--phase", "test", "--start_epoch", "5"]
  assert trun.main(argv) == 0
  grid = np.asarray(Image.open(tmp_path / "t" / "ck" / "epoch_00005.png"))
  want = np.asarray(Image.open(tt.save_sample_grid(5)))
  np.testing.assert_array_equal(grid, want)


def test_checkpoint_before_nonfinite_abort(tmp_path):
  tt = _port(tmp_path / "o", tmp_path / "c", "--number_of_epochs", "1",
             "--checkpoint_ratio", "0")
  with torch.no_grad():
    tt.state.d.fc_out.weight.fill_(float("nan"))
  with pytest.raises(FloatingPointError, match="non-finite"):
    tt.train()
  log = (tmp_path / "o" / "ck" / "log.txt").read_text()
  assert "NON-FINITE metrics" in log and "checkpointed and aborting" in log
  assert os.path.isfile(tmp_path / "c" / "ck" / "epoch_0" / CKPT_FILE)


def test_cli_artifacts_match_jax(tmp_path):
  """The same flags through both CLIs: the same artifact names under
  checkpoints_dir/name (full-state directories and weights-only npz) and
  under output_dir/name."""
  flags = FLAGS + ["--number_of_epochs", "2", "--checkpoint_ratio", "1",
                   "--display_ratio", "1", "--generator_ema", "0.5"]
  assert jrun.main(flags + ["--output_dir", str(tmp_path / "jo"),
                            "--checkpoints_dir", str(tmp_path / "jc")]) == 0
  assert trun.main(flags + ["--device", "cpu", "--output_dir",
                            str(tmp_path / "to"), "--checkpoints_dir",
                            str(tmp_path / "tc")]) == 0
  ck_j = sorted(os.listdir(tmp_path / "jc" / "ck"))
  assert sorted(os.listdir(tmp_path / "tc" / "ck")) == ck_j
  assert ck_j == ["epoch_0", "epoch_0_discriminator.npz",
                  "epoch_0_generator.npz", "epoch_1",
                  "epoch_1_discriminator.npz", "epoch_1_generator.npz"]
  assert (sorted(os.listdir(tmp_path / "to" / "ck"))
          == sorted(os.listdir(tmp_path / "jo" / "ck")))
  for name in ("epoch_1_generator.npz", "epoch_1_discriminator.npz"):
    with np.load(tmp_path / "jc" / "ck" / name) as j, \
        np.load(tmp_path / "tc" / "ck" / name) as t:
      assert set(j.files) == set(t.files)
      assert all(j[k].shape == t[k].shape for k in j.files)
