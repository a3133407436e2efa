"""The BASELINE presets through the port's CLI, and the CLI flags that came
with them, against the JAX CLI.

Every preset builds the same configuration as the JAX CLI builds from the
same argv (synthetic data at the preset's resolution, width 16), runs end
to end under ``--smoke --device cpu`` as ``tests/test_presets.py`` runs it
in JAX; ``imagenet64_cwc_dp`` (data parallelism, ``--mesh 8``) smoke-runs
on two CPU ranks (``--mesh 2``). Configurations are compared field by
field; nothing here compares numbers."""

import dataclasses
import json
import math

import pytest
import torch

from wcgan_tpu.cli import run as jrun
from wcgan_tpu.cli.presets import PRESETS
from wcgan_tpu_torch.cli import run as trun
from wcgan_tpu_torch.data import DATASETS

DP_PRESET = "imagenet64_cwc_dp"
ONE_DEVICE = sorted(p for p in PRESETS if p != DP_PRESET)


def _overrides(name):
  dataset = PRESETS[name][PRESETS[name].index("--dataset") + 1]
  return ["--dataset", "synthetic", "--synthetic_size", "64",
          "--synthetic_resolution", str(DATASETS[dataset][0]),
          "--batch_size", "8", "--generator_filters", "16,16,16",
          "--discriminator_filters", "16,16", "--ns_iters", "6"]


def _common_fields(a, b):
  fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
  return {k: fa[k] for k in fa if k in fb}, {k: fb[k] for k in fa if k in fb}


@pytest.mark.parametrize("name", ONE_DEVICE)
def test_preset_builds_as_in_jax(name, tmp_path):
  argv = trun.expand_preset(["--preset", name, *_overrides(name)])
  assert argv == PRESETS[name] + _overrides(name)
  jt = jrun.build_experiment(jrun.build_parser().parse_args(argv + [
      "--output_dir", str(tmp_path / "j")]))
  tt = trun.build_experiment(trun.build_parser().parse_args(argv + [
      "--device", "cpu", "--output_dir", str(tmp_path / "t")]))
  assert tt.state.step == 0 and tt.cfg.name == jt.cfg.name
  for ours, theirs in ((tt.state.g.cfg, jt.g.cfg), (tt.state.d.cfg, jt.d.cfg),
                       (tt.gan_cfg, jt.gan_cfg)):
    got, want = _common_fields(ours, theirs)
    assert got == want, type(ours).__name__
  if "--conditional" in PRESETS[name]:
    assert tt.gan_cfg.num_classes > 0


@pytest.mark.parametrize("name", ONE_DEVICE)
def test_preset_smoke_runs_end_to_end(name, tmp_path):
  out = tmp_path / "out"
  rc = trun.main(["--preset", name, "--smoke", "--device", "cpu",
                  "--output_dir", str(out), "--checkpoints_dir",
                  str(tmp_path / "ck"), "--name", name])
  assert rc == 0
  text = (out / name / "log.txt").read_text()
  assert "Epoch 1:" in text and "nan" not in text.lower()
  records = [json.loads(l) for l in
             (out / name / "metrics.jsonl").read_text().splitlines()]
  assert [r["epoch"] for r in records] == [0, 1]
  assert all(math.isfinite(r["d_loss"]) for r in records)
  assert sorted(p.name for p in (out / name).glob("*.png")) == [
      "epoch_00000.png", "epoch_00001.png"]
  assert (tmp_path / "ck" / name / "epoch_1_generator.npz").is_file()


def test_dp_preset_builds_as_in_jax(tmp_path):
  """imagenet64_cwc_dp (its --mesh 8 given as 2 here) builds the JAX
  CLI's configuration: cWC-sa G, projection-D, bf16, batch 512."""
  argv = trun.expand_preset(["--preset", DP_PRESET, *_overrides(DP_PRESET),
                             "--batch_size", "512", "--mesh", "2"])
  jt = jrun.build_experiment(jrun.build_parser().parse_args(argv + [
      "--output_dir", str(tmp_path / "j")]))
  tt = trun.build_experiment(trun.build_parser().parse_args(argv + [
      "--device", "cpu", "--output_dir", str(tmp_path / "t")]))
  assert tt.cfg.name == jt.cfg.name and tt.ds.batch_size == 512
  assert jt.mesh is not None and tt.state.g.cfg.dtype == "bfloat16"
  for ours, theirs in ((tt.state.g.cfg, jt.g.cfg), (tt.state.d.cfg, jt.d.cfg),
                       (tt.gan_cfg, jt.gan_cfg)):
    got, want = _common_fields(ours, theirs)
    assert got == want, type(ours).__name__


def test_dp_preset_smoke_runs_on_two_ranks(tmp_path):
  """imagenet64_cwc_dp --smoke --mesh 2 on the CPU: two gloo ranks (a
  global batch of 8, 4 a rank), 2 epochs, rank 0's log, grids and
  checkpoint."""
  out = tmp_path / "out"
  rc = trun.main(["--preset", DP_PRESET, "--smoke", "--device", "cpu",
                  "--mesh", "2", "--output_dir", str(out),
                  "--checkpoints_dir", str(tmp_path / "ck"), "--name",
                  DP_PRESET])
  assert rc == 0
  text = (out / DP_PRESET / "log.txt").read_text()
  assert "Epoch 1:" in text and "nan" not in text.lower()
  assert "rank 0 of 2" in text
  records = [json.loads(l) for l in
             (out / DP_PRESET / "metrics.jsonl").read_text().splitlines()]
  assert [r["epoch"] for r in records] == [0, 1]
  assert sorted(p.name for p in (out / DP_PRESET).glob("*.png")) == [
      "epoch_00000.png", "epoch_00001.png"]
  assert (tmp_path / "ck" / DP_PRESET / "epoch_1_generator.npz").is_file()


def test_dp_preset_on_one_gpu_asks_for_eight(tmp_path):
  """Without --smoke the preset's --mesh 8 needs 8 GPUs."""
  if torch.cuda.device_count() >= 8:
    pytest.skip("checks the refusal where there are fewer than 8 GPUs")
  with pytest.raises(SystemExit, match="--mesh 8 --device cuda needs 8 "
                     "CUDA GPUs, one per rank"):
    trun.main(["--preset", DP_PRESET, "--output_dir", str(tmp_path)])
  assert not any(tmp_path.iterdir())


def test_smoke_keeps_the_configuration_and_shrinks_the_run():
  """--smoke as the JAX CLI applies it on one device: the same fields
  change, to the same values."""
  argv = PRESETS["stl10_wc_resnet_sn"] + ["--smoke"]
  jargs = jrun.build_parser().parse_args(argv)
  targs = trun.build_parser().parse_args(argv)
  jrun._apply_smoke(jargs)
  trun._apply_smoke(targs)
  for key in ("dataset", "synthetic_resolution", "synthetic_size",
              "batch_size", "generator_filters", "discriminator_filters",
              "ns_iters", "number_of_epochs", "batches_per_epoch",
              "checkpoint_ratio", "display_ratio", "steps_per_call", "arch",
              "loss", "generator_block_coloring"):
    assert getattr(targs, key) == getattr(jargs, key), key
  assert targs.synthetic_resolution == 48


NEW_FLAGS = {"--arch": "dcgan", "--generator_block_norm": "b",
             "--generator_last_norm": "b", "--discriminator_norm": "b",
             "--batched_fake_gen": "1", "--d_fake_stats": "running",
             "--spectral_iterations": "3", "--synthetic_resolution": "16",
             "--profile_dir": "prof"}
NEW_SWITCHES = ("--remat", "--sn_update_on_g_step", "--fully_diff_spectral",
                "--conv_singular", "--smoke", "--debug_nans")


def test_cli_takes_the_new_flags_like_jax():
  argv = [a for kv in NEW_FLAGS.items() for a in kv] + list(NEW_SWITCHES)
  trun._reject_unsupported(argv)
  got = vars(trun.build_parser().parse_args(argv))
  want = vars(jrun.build_parser().parse_args(argv))
  defaults_t = vars(trun.build_parser().parse_args([]))
  defaults_j = vars(jrun.build_parser().parse_args([]))
  for flag in list(NEW_FLAGS) + list(NEW_SWITCHES):
    key = flag[2:]
    assert got[key] == want[key], flag
    assert defaults_t[key] == defaults_j[key], flag


@pytest.mark.parametrize("flag", ["--platform", "--compilation_cache_dir"])
def test_cli_refuses_what_it_does_not_take_with_the_reason(flag):
  with pytest.raises(SystemExit, match=f"{flag} not supported by the "
                     "PyTorch port: .*(--device|build/kernels)"):
    trun._reject_unsupported([flag, "1"])


def test_whitening_precision_high_builds_and_steps(tmp_path, monkeypatch):
  """build_experiment takes 'high' and sets the whitening switch (the
  whitening products then go through bf16x3); one tiny step from the
  same seed gives finite metrics within 1e-3 (relative, at least 1.0) of
  the 'highest' step's: the emulation keeps ~16 bits a product."""
  from wcgan_tpu_torch.ops import mm_bf16x3, whiten
  base = ["--device", "cpu", "--dataset", "synthetic", "--synthetic_size",
          "16", "--generator_filters", "8,8", "--discriminator_filters",
          "8,8", "--batch_size", "4", "--output_dir", str(tmp_path)]
  calls = []
  monkeypatch.setattr(whiten, "mm_bf16x3", lambda a, b: calls.append(1)
                      or mm_bf16x3.mm_bf16x3(a, b))
  metrics = {}
  try:
    for precision in ("high", "highest"):
      tt = trun.build_experiment(trun.build_parser().parse_args(
          base + ["--whitening_precision", precision]))
      assert whiten.get_precision() == precision
      assert tt._device_data is not None
      before = len(calls)
      metrics[precision] = {k: float(v) for k, v in tt.step_fn(
          tt.state, *tt._device_data).items()}
      assert (len(calls) > before) == (precision == "high")
  finally:
    whiten.set_precision("highest")
  assert set(metrics["high"]) == set(metrics["highest"])
  for k, v in metrics["highest"].items():
    assert math.isfinite(metrics["high"][k]), k
    assert abs(metrics["high"][k] - v) <= 1e-3 * max(1.0, abs(v)), k


def test_profile_dir_writes_a_chrome_trace(tmp_path):
  rc = trun.main(["--preset", "cifar10_wc_dcgan", "--smoke", "--device",
                  "cpu", "--output_dir", str(tmp_path / "o"),
                  "--checkpoints_dir", str(tmp_path / "c"), "--name", "p",
                  "--profile_dir", str(tmp_path / "prof")])
  assert rc == 0
  trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
  names = {e.get("name", "") for e in trace["traceEvents"]}
  assert any("conv" in n for n in names)
  log = (tmp_path / "o" / "p" / "log.txt").read_text()
  # 2 epochs of 2 step calls: the first warms up, the other 3 are traced.
  assert "wrote profiler trace" in log and "(3 step calls)" in log


def test_debug_nans_raises_at_the_first_non_finite_step(tmp_path):
  args = trun.build_parser().parse_args(PRESETS["cifar10_wc_dcgan"] + [
      "--smoke", "--device", "cpu", "--output_dir", str(tmp_path),
      "--debug_nans"])
  tt = trun.build_experiment(args)
  assert tt.cfg.debug_nans
  calls = []

  def step(state, *batches):
    calls.append(1)
    return {"d_loss": torch.tensor(float("nan") if len(calls) == 2 else 1.0)}

  tt.step_fn = step
  with pytest.raises(FloatingPointError, match="step call 2 .*d_loss"):
    tt.train()
  assert len(calls) == 2


def test_debug_nans_turns_on_anomaly_detection(tmp_path):
  try:
    rc = trun.main(PRESETS["cifar10_wc_dcgan"] + [
        "--smoke", "--device", "cpu", "--output_dir", str(tmp_path),
        "--checkpoints_dir", str(tmp_path / "c"), "--debug_nans"])
    assert rc == 0 and torch.is_anomaly_enabled()
  finally:
    torch.autograd.set_detect_anomaly(False)
