"""Feature-FID and IS-analog trajectories of a digits GAN run.

The port's counterpart of ``scripts/eval_digits_fid.py``:

1. Trains a small, independent convolutional feature network (the
   judge) to classify the bundled digits, the Inception-analog. Features
   = its 64-d penultimate layer; class probabilities = its softmax head.
2. Walks every full-state checkpoint of a digits GAN run
   (``checkpoints_dir/<name>/epoch_*``), generates samples from each, and
   computes (a) the Frechet distance between generated and real feature
   moments and (b) the Inception-Score analog exp(E KL(p(y|x) || p(y)))
   on the judge's softmax, both with the port's own
   ``evaluation.metrics`` (the production FID/IS math).
3. Prints both trajectories plus calibration rows: real-vs-real split FID
   / real-digits IS (the targets) and uniform-noise FID / IS (the
   degenerate ends).

Usage: first train the digits run,

  python -m wcgan_tpu_torch --dataset digits --gan_type PROJECTIVE \\
      --arch res --batch_size 64 --generator_block_coloring ucconv \\
      --generator_last_coloring ucconv --bf16 --number_of_epochs 300 \\
      --checkpoint_ratio 25 --display_ratio 50 \\
      --output_dir out --checkpoints_dir ckpt --name digits

then

  python -m wcgan_tpu_torch.tools.eval_digits_fid --checkpoints_dir ckpt \\
      --output_dir out --name digits [--samples 1797] [--device cuda]
"""

from __future__ import annotations

import argparse
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wcgan_tpu_torch.cli import run as cli_run
from wcgan_tpu_torch.evaluation import metrics

# flax's default kernel init, lecun_normal: a normal of variance
# 1 / fan_in truncated at 2 standard deviations, its scale corrected for
# the truncation (jax.nn.initializers.variance_scaling).
_TRUNC_STD = 0.87962566103423978


class Judge(nn.Module):
  """The reference's judge CNN (``scripts/eval_digits_fid.py``): conv 32
  3x3 'SAME' + ReLU, 2x2 average pool, conv 64 3x3 'SAME' + ReLU, a
  spatial mean, dense 64 + ReLU (the features), dense 10 (the logits).
  Submodules carry flax's names, so ``weights.judge_from_flax`` maps a
  flax tree onto it. Takes NHWC floats in [-1, 1]."""

  def __init__(self, generator: Optional[torch.Generator] = None):
    super().__init__()
    self.Conv_0 = nn.Conv2d(1, 32, 3, padding=1)
    self.Conv_1 = nn.Conv2d(32, 64, 3, padding=1)
    self.Dense_0 = nn.Linear(64, 64)
    self.Dense_1 = nn.Linear(64, 10)
    with torch.no_grad():
      for m in (self.Conv_0, self.Conv_1, self.Dense_0, self.Dense_1):
        fan_in = m.weight[0].numel()
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        m.bias.zero_()

  def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x.permute(0, 3, 1, 2)
    x = F.relu(self.Conv_0(x))
    x = F.avg_pool2d(x, 2, 2)
    x = F.relu(self.Conv_1(x))
    x = x.mean(dim=(2, 3))
    feats = F.relu(self.Dense_0(x))
    return feats, self.Dense_1(feats)


def judge_inputs(images_u8, device) -> torch.Tensor:
  """uint8 NHWC -> float32 in [-1, 1] on ``device``, the judge's input."""
  x = torch.as_tensor(np.asarray(images_u8)).to(device)
  return x.float() / 127.5 - 1.0


def train_step(model: Judge, opt: torch.optim.Optimizer, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
  """One Adam step on the mean softmax cross entropy; returns the loss."""
  opt.zero_grad(set_to_none=True)
  _, logits = model(x)
  loss = F.cross_entropy(logits, y)
  loss.backward()
  opt.step()
  return loss.detach()


def build_feature_net(images_u8, labels, rng_seed=0, steps=600, batch=256,
                      lr=1e-3, device="cuda"
                      ) -> Tuple[Callable[[np.ndarray],
                                          Tuple[np.ndarray, np.ndarray]],
                                 float]:
  """Train the judge CNN; returns (judge_fn, train_accuracy).

  judge_fn: uint8 NHWC -> (features, probs), (N, 64) float32 penultimate
  features and (N, 10) float32 softmax class probabilities, in one
  forward. The weights are drawn from ``torch.Generator`` seeded with
  ``rng_seed`` (flax's init distribution), the batches from
  ``np.random.default_rng(rng_seed)`` as in the reference."""
  device = torch.device(device)
  model = Judge(torch.Generator().manual_seed(rng_seed)).to(device)
  x_all = judge_inputs(images_u8, device)
  y_all = torch.as_tensor(np.asarray(labels, np.int64)).to(device)
  opt = torch.optim.Adam(model.parameters(), lr=lr)
  rng = np.random.default_rng(rng_seed)
  n = len(images_u8)
  for _ in range(steps):
    idx = torch.from_numpy(rng.integers(0, n, size=min(batch, n))).to(device)
    train_step(model, opt, x_all[idx], y_all[idx])

  @torch.no_grad()
  def judge_fn(u8):
    """One forward -> (features, probs) as float32 numpy."""
    feats, logits = model(judge_inputs(u8, device))
    return (feats.float().cpu().numpy(),
            torch.softmax(logits.float(), dim=-1).cpu().numpy())

  with torch.no_grad():
    _, logits = model(x_all)
    acc = float((logits.argmax(-1) == y_all).float().mean())
  return judge_fn, acc


def fid_between(feats_a, feats_b) -> float:
  """The FID of two feature sets: the port's moments and distance."""
  mu_a, sig_a = metrics.moments_from_activations(torch.as_tensor(feats_a))
  mu_b, sig_b = metrics.moments_from_activations(torch.as_tensor(feats_b))
  return metrics.fid_from_moments(mu_a, sig_a, mu_b, sig_b)


def is_of(probs) -> Tuple[float, float]:
  """(mean, std) of the port's Inception Score on softmax ``probs``."""
  mean, std = metrics.inception_score(torch.as_tensor(probs))
  return float(mean), float(std)


def build_parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(
      prog="python -m wcgan_tpu_torch.tools.eval_digits_fid",
      description="Feature-FID and IS-analog of every checkpoint of a "
                  "digits GAN run.")
  ap.add_argument("--checkpoints_dir", required=True)
  ap.add_argument("--output_dir", default="digits_fid_out")
  ap.add_argument("--name", required=True)
  ap.add_argument("--samples", type=int, default=1797,
                  help="generated samples per checkpoint (default = the "
                       "size of the real digits set, for a balanced FID)")
  ap.add_argument("--block_coloring", default="ucconv")
  ap.add_argument("--generator_ema", type=float, default=0.0)
  ap.add_argument("--sample_from", choices=("auto", "raw", "running"),
                  default="auto",
                  help="'auto' = the trainer's sampling rule (EMA weights "
                       "+ standing stats when the run trained with "
                       "--generator_ema, raw otherwise); 'raw' = the raw "
                       "parameters even on an EMA checkpoint; 'running' = "
                       "EMA weights against the raw trajectory's running "
                       "stats")
  ap.add_argument("--bf16", type=int, default=1,
                  help="must match the training run")
  ap.add_argument("--device", default="cuda",
                  help="'cuda' (default; raises without a GPU) or 'cpu'")
  return ap


def run_argv(args) -> List[str]:
  """The training CLI's flags of the run under evaluation."""
  argv = ["--dataset", "digits", "--gan_type", "PROJECTIVE",
          "--arch", "res", "--batch_size", "64",
          "--generator_block_coloring", args.block_coloring,
          "--generator_last_coloring", args.block_coloring,
          "--output_dir", args.output_dir,
          "--checkpoints_dir", args.checkpoints_dir,
          "--name", args.name,
          "--generator_ema", str(args.generator_ema),
          "--device", args.device]
  if args.bf16:
    argv.append("--bf16")
  return argv


def evaluate(args, emit: Callable[[str], None] = print) -> Optional[Dict]:
  """Train the judge, score every checkpoint and ``emit`` the reference's
  lines; returns the numbers (None when there is no checkpoint)."""
  cli_run.set_precision()
  trainer = cli_run.build_experiment(
      cli_run.build_parser().parse_args(run_argv(args)))
  if args.sample_from == "running":
    trainer.cfg.ema_standing_batches = 0
  epochs = trainer.checkpoint_epochs()
  if not epochs:
    emit(f"no full-state checkpoints under {trainer.ckpt_dir}")
    return None

  real_u8 = trainer.ds.images  # (1797, 16, 16, 1) uint8
  real_y = trainer.ds.labels
  judge_fn, judge_acc = build_feature_net(real_u8, real_y,
                                          device=trainer.device)
  emit(f"judge feature net trained: accuracy {judge_acc:.3f} on "
       f"{len(real_u8)} real digits (features = 64-d penultimate)")

  feats_real, probs_real = judge_fn(real_u8)
  # Calibration: the floor (real vs real split) and a ceiling (noise) for
  # FID; the real-digits and uniform-noise IS-analogs bracket the
  # meaningful IS range the same way (10 balanced classes => max 10).
  half = len(real_u8) // 2
  floor = fid_between(feats_real[:half], feats_real[half:2 * half])
  rng = np.random.default_rng(0)
  noise_u8 = rng.integers(0, 256, real_u8.shape, dtype=np.uint8)
  feats_noise, probs_noise = judge_fn(noise_u8)
  ceil = fid_between(feats_real, feats_noise)
  is_real, is_real_std = is_of(probs_real)
  is_noise, _ = is_of(probs_noise)
  emit(f"calibration: FID real-split floor {floor:.3f} | "
       f"FID uniform-noise ceiling {ceil:.3f} | "
       f"IS real digits {is_real:.3f}±{is_real_std:.3f} | "
       f"IS uniform noise {is_noise:.3f}")

  emit("| epoch | feature-FID (fake vs real) | IS-analog |")
  emit("|---|---|---|")
  traj = []
  for ep in epochs:
    trainer.restore_checkpoint(trainer.checkpoint_path(ep))
    ema = trainer.state.g_ema
    if args.sample_from == "raw" and ema:
      # Without the shadow, the sampling rule falls through to the raw
      # parameters; the next restore needs it back.
      trainer.state.g_ema = None
    try:
      fake_u8 = trainer.generate(args.samples)
    finally:
      trainer.state.g_ema = ema
    feats_fake, probs_fake = judge_fn(fake_u8)
    fid = fid_between(feats_fake, feats_real)
    is_m, is_s = is_of(probs_fake)
    traj.append((ep, fid, is_m, is_s))
    emit(f"| {ep} | {fid:.3f} | {is_m:.3f}±{is_s:.3f} |")

  first, last = traj[0][1], traj[-1][1]
  emit(f"FID trajectory: {first:.3f} (epoch {traj[0][0]}) -> {last:.3f} "
       f"(epoch {traj[-1][0]}); decreasing={last < first}")
  emit(f"IS trajectory: {traj[0][2]:.3f} -> {traj[-1][2]:.3f} "
       f"(real-digits target {is_real:.3f}); "
       f"increasing={traj[-1][2] > traj[0][2]}")
  return {"judge_accuracy": judge_acc, "floor": floor, "ceiling": ceil,
          "is_real": is_real, "is_real_std": is_real_std,
          "is_noise": is_noise, "trajectory": traj}


def main(argv=None) -> int:
  args = build_parser().parse_args(argv)
  return 0 if evaluate(args, lambda s: print(s, flush=True)) else 1


if __name__ == "__main__":
  raise SystemExit(main())
