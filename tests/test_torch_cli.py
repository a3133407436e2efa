"""``python -m wcgan_tpu_torch`` end to end on the CPU, in subprocesses.

The training run happens in a fresh interpreter that runs the package as
``-m`` does and then checks it never imported JAX, flax, optax or orbax:
the port must run where none of them is installed."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = ["--dataset", "synthetic", "--synthetic_size", "64", "--arch", "res",
        "--generator_filters", "16,16", "--discriminator_filters", "16,16",
        "--batch_size", "8", "--training_ratio", "2", "--z_dim", "16",
        "--ns_iters", "6", "--number_of_epochs", "2",
        "--batches_per_epoch", "2", "--name", "tiny"]

RUN_AS_MAIN = """
import runpy, sys
sys.argv = ["wcgan_tpu_torch"] + sys.argv[1:]
try:
  runpy.run_module("wcgan_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
  if e.code:
    raise
loaded = sorted(m for m in ("jax", "flax", "optax", "orbax")
                if m in sys.modules)
assert not loaded, f"the port imported {loaded}"
print("NO_JAX_IMPORTED")
"""


def _run(args):
  return subprocess.run([sys.executable, "-c", RUN_AS_MAIN, *args], cwd=REPO,
                        capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
  """(the finished process, its --output_dir) of one tiny CPU run."""
  out = tmp_path_factory.mktemp("cpu_run")
  return _run(["--device", "cpu", "--output_dir", str(out), *TINY]), out


def test_cli_trains_on_cpu_without_jax(cpu_run):
  proc, tmp_path = cpu_run
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert "NO_JAX_IMPORTED" in proc.stdout
  assert "allow_tf32=False" in proc.stdout
  lines = (tmp_path / "tiny" / "log.txt").read_text().splitlines()
  epochs = [l for l in lines if l.startswith("Epoch ")]
  assert len(epochs) == 2
  assert "d_loss = " in epochs[0] and "imgs/sec = " in epochs[0]
  # The device is written once, in log.txt, not in the epoch records.
  assert sum(l.startswith("wcgan_tpu_torch on cpu") for l in lines) == 1
  records = [json.loads(l) for l in
             (tmp_path / "tiny" / "metrics.jsonl").read_text().splitlines()]
  assert [r["epoch"] for r in records] == [0, 1]
  assert all(r["imgs_per_sec"] > 0 and "device" not in r for r in records)
  # --display_ratio defaults to 1: a sample grid after every epoch.
  assert sorted(p.name for p in (tmp_path / "tiny").glob("*.png")) == [
      "epoch_00000.png", "epoch_00001.png"]


def test_soak_report_reads_the_port_metrics_as_finite(cpu_run):
  """The reference's scripts/soak_report.py, unchanged, on the port's
  metrics.jsonl: every value of an epoch record is a finite number."""
  proc, out = cpu_run
  assert proc.returncode == 0, proc.stdout + proc.stderr
  report = subprocess.run(
      [sys.executable, os.path.join(REPO, "scripts", "soak_report.py"),
       str(out / "tiny" / "metrics.jsonl"), "--steps_per_epoch", "2"],
      capture_output=True, text=True, timeout=60)
  assert report.returncode == 0, report.stderr
  assert "epochs logged: **2**" in report.stdout, report.stdout
  assert "all metrics finite across the whole run: **True**" in (
      report.stdout), report.stdout


def test_cli_cuda_without_gpu_fails(tmp_path):
  if torch.cuda.is_available():
    pytest.skip("checks the refusal on a machine without a GPU")
  proc = _run(["--device", "cuda", "--output_dir", str(tmp_path), *TINY])
  assert proc.returncode != 0
  assert "no CUDA GPU" in proc.stderr
  assert not (tmp_path / "tiny").exists()


def test_cli_rejects_unported_flags(tmp_path):
  proc = _run(["--device", "cpu", "--output_dir", str(tmp_path),
               "--platform", "cpu", *TINY])
  assert proc.returncode != 0
  assert "--platform not supported by the PyTorch port" in proc.stderr
  assert not (tmp_path / "tiny").exists()


def test_cli_trains_with_mesh_2_and_resumes(tmp_path):
  """--mesh 2 --device cpu: two gloo ranks, in fresh interpreters that
  never import JAX. Rank 0 alone writes: one log with one line per epoch,
  one grid and one checkpoint per epoch; --resume auto restores the same
  file on both ranks and runs the third epoch."""
  base = ["--device", "cpu", "--output_dir", str(tmp_path), *TINY,
          "--mesh", "2", "--checkpoints_dir", str(tmp_path / "ck"),
          "--checkpoint_ratio", "1"]
  proc = _run(base)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert "NO_JAX_IMPORTED" in proc.stdout
  log = (tmp_path / "tiny" / "log.txt").read_text()
  assert log.count("rank 0 of 2") == 1
  assert [l.split(":")[0] for l in log.splitlines()
          if l.startswith("Epoch ")] == ["Epoch 0", "Epoch 1"]
  assert sorted(p.name for p in (tmp_path / "tiny").glob("*.png")) == [
      "epoch_00000.png", "epoch_00001.png"]
  ck = tmp_path / "ck" / "tiny"
  assert sorted(p.name for p in ck.iterdir()) == [
      "epoch_0", "epoch_0_discriminator.npz", "epoch_0_generator.npz",
      "epoch_1", "epoch_1_discriminator.npz", "epoch_1_generator.npz"]
  state = torch.load(ck / "epoch_1" / "state.pt", weights_only=True)
  assert state["step"] == 4
  proc = _run(base + ["--resume", "auto", "--number_of_epochs", "3"])
  assert proc.returncode == 0, proc.stdout + proc.stderr
  log = (tmp_path / "tiny" / "log.txt").read_text()
  assert f"resumed from {ck / 'epoch_1'} (start_epoch 2)" in log
  assert log.count("Epoch 2:") == 1
  assert torch.load(ck / "epoch_2" / "state.pt",
                    weights_only=True)["step"] == 6


def test_cli_mesh_needs_a_divisible_batch(tmp_path):
  """--mesh 3 with --batch_size 8: every rank refuses to build its step,
  and the run fails with the reference's message."""
  from wcgan_tpu_torch.cli import run as trun
  from wcgan_tpu_torch.parallel import launch
  with pytest.raises(launch.RankFailed, match="batch_size 8 must be "
                     "divisible by the mesh size 3"):
    trun.main(["--device", "cpu", "--output_dir", str(tmp_path), *TINY,
               "--mesh", "3"])


def test_cli_mesh_beyond_the_gpus_raises(tmp_path):
  """--mesh N --device cuda starts one rank per GPU and never shares a
  card or moves to the CPU: more ranks than GPUs is refused."""
  from wcgan_tpu_torch.cli import run as trun
  n = torch.cuda.device_count() + 1
  with pytest.raises(SystemExit, match=f"--mesh {n} --device cuda needs {n} "
                     f"CUDA GPUs, one per rank, but torch sees {n - 1}"):
    trun.main(["--device", "cuda", "--output_dir", str(tmp_path), *TINY,
               "--mesh", str(n)])
  assert not (tmp_path / "tiny").exists()


def test_cli_phase_test_writes_a_grid_without_jax(tmp_path):
  """--phase test on the port's own export, in a fresh interpreter that
  never imports JAX."""
  import numpy as np
  from wcgan_tpu_torch import weights
  from wcgan_tpu_torch.models.generator import Generator, GeneratorConfig
  g = Generator(GeneratorConfig(z_dim=16, filters=(16, 16),
                                base_resolution=8),
                torch.Generator().manual_seed(1))
  npz = tmp_path / "g.npz"
  np.savez(npz, **weights.export_npz(g))
  proc = _run(["--device", "cpu", "--output_dir", str(tmp_path), *TINY,
               "--phase", "test", "--generator_checkpoint", str(npz),
               "--start_epoch", "5"])
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert "NO_JAX_IMPORTED" in proc.stdout
  assert (tmp_path / "tiny" / "epoch_00005.png").exists()
  log = (tmp_path / "tiny" / "log.txt").read_text()
  assert "wrote sample grid" in log and "Epoch " not in log


PORTED = {"--checkpoints_dir": "ck", "--checkpoint_ratio": "3",
          "--resume": "auto", "--generator_ema": "0.999",
          "--ema_standing_stats": "4", "--wc_residual_action": "fallback",
          "--fallback_cooldown": "0", "--residual_probe_every": "2",
          "--device_data": "0", "--steps_per_call": "4",
          "--device_data_limit": "1000000",
          "--compute_inception_score": "1", "--compute_fid": "1",
          "--score_every": "2", "--samples_inception": "1000",
          "--samples_fid": "500", "--inception_weights": "iv3.npz"}


def test_cli_takes_the_ported_flags():
  from wcgan_tpu.cli.run import build_parser as jax_parser
  from wcgan_tpu_torch.cli import run as trun
  argv = [a for kv in PORTED.items() for a in kv]
  trun._reject_unsupported(argv)
  got = vars(trun.build_parser().parse_args(argv))
  want = vars(jax_parser().parse_args(argv))
  defaults_t = vars(trun.build_parser().parse_args([]))
  defaults_j = vars(jax_parser().parse_args([]))
  for flag in PORTED:
    key = flag[2:]
    assert got[key] == want[key], flag
    assert defaults_t[key] == defaults_j[key], flag


@pytest.mark.parametrize("flag", ["--platform", "--compilation_cache_dir"])
def test_cli_still_refuses_by_name(flag):
  from wcgan_tpu_torch.cli import run as trun
  with pytest.raises(SystemExit, match=f"{flag} not supported"):
    trun._reject_unsupported([flag, "2"])


def test_cli_flag_surface_matches_the_jax_parser():
  """Every flag of the JAX CLI's parser is in the port's with the same
  action, type, default and choices, or is refused by name
  (UNSUPPORTED_FLAGS, with its reason). One value differs:
  --whitening_precision defaults to 'highest', since on the CPU JAX's
  'high' is exact float32 while the port's runs the bf16x3 emulation, so
  the port's parity tests hold 'highest' against JAX ('high' itself:
  test_torch_presets.py::test_whitening_precision_high_builds_and_steps).
  The port adds --device."""
  from wcgan_tpu.cli.run import build_parser as jax_parser
  from wcgan_tpu_torch.cli import run as trun

  def flags(parser):
    return {o: a for a in parser._actions for o in a.option_strings
            if o not in ("-h", "--help")}

  want, got = flags(jax_parser()), flags(trun.build_parser())
  assert set(trun.UNSUPPORTED_FLAGS) == {"--platform",
                                         "--compilation_cache_dir"}
  assert set(got) - set(want) == {"--device"}
  for flag, a in want.items():
    if flag in trun.UNSUPPORTED_FLAGS:
      assert flag not in got and trun.UNSUPPORTED_FLAGS[flag], flag
      continue
    b = got[flag]
    assert type(a) is type(b), flag
    for attr in ("dest", "type", "choices", "nargs", "const"):
      assert getattr(a, attr) == getattr(b, attr), (flag, attr)
    if flag == "--whitening_precision":
      assert (a.default, b.default) == ("high", "highest")
    else:
      assert a.default == b.default, flag


def test_cli_ema_checkpoints_and_resume_without_jax(tmp_path):
  """--generator_ema with a checkpoint every epoch, then --resume auto, in
  fresh interpreters that never import JAX."""
  base = ["--device", "cpu", "--output_dir", str(tmp_path), *TINY,
          "--checkpoints_dir", str(tmp_path / "ck"), "--generator_ema",
          "0.9", "--checkpoint_ratio", "1"]
  proc = _run(base)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  proc = _run(base + ["--resume", "auto", "--number_of_epochs", "3"])
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert "NO_JAX_IMPORTED" in proc.stdout
  log = (tmp_path / "tiny" / "log.txt").read_text()
  assert "(start_epoch 2)" in log
  assert [log.count(f"Epoch {i}:") for i in range(3)] == [1, 1, 1]
  assert sorted(p.name for p in (tmp_path / "ck" / "tiny").iterdir()) == [
      f"epoch_{i}{s}" for i in range(3)
      for s in ("", "_discriminator.npz", "_generator.npz")]
  records = [json.loads(l) for l in
             (tmp_path / "tiny" / "metrics.jsonl").read_text().splitlines()]
  assert [r["epoch"] for r in records] == [0, 1, 2]
  assert all(np.isfinite(r[k]) for r in records
             for k in ("wc_cov_cond_max", "wc_whiten_residual_max",
                       "d_sigma_max"))
