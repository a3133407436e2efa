"""Conditional-generation fidelity of a digits GAN run.

The port's counterpart of ``scripts/eval_conditional_fidelity.py``:
classify generated samples with an independent judge trained on the real
digits and report its accuracy against the requested labels (chance =
1/num_classes).

The judge is the reference's ``LogisticRegression(max_iter=2000)`` of
sklearn, written as a softmax regression in torch: it minimises the same
objective, the multinomial cross entropy summed over the 1,797 real
digits plus 1/2 ||W||^2 (C = 1; the intercept is not penalised), on the
64 raw pixel values (0..16), with ``torch.optim.LBFGS`` on the full batch
in float64 on the CPU. The objective is strictly convex, so its optimum
is sklearn's. Samples are shrunk 2x2 to 8x8 and scaled to 0..16 as the
reference does.

Usage:
  python -m wcgan_tpu_torch.tools.eval_conditional_fidelity \\
      --checkpoints_dir ckpt --name digits [--gan_type PROJECTIVE] \\
      [--samples 640] [--device cuda]
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wcgan_tpu_torch.cli import run as cli_run
from wcgan_tpu_torch.data.datasets import digits_arrays


def fit_softmax_regression(x, y, classes: int = 10, max_iter: int = 2000
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(weight (classes, d), bias (classes,)), float64, minimising
  sum_i CE(x_i W^T + b, y_i) + 1/2 ||W||^2 by full-batch L-BFGS."""
  x = torch.as_tensor(np.asarray(x), dtype=torch.float64)
  y = torch.as_tensor(np.asarray(y), dtype=torch.int64)
  weight = torch.zeros(classes, x.shape[1], dtype=torch.float64,
                       requires_grad=True)
  bias = torch.zeros(classes, dtype=torch.float64, requires_grad=True)
  opt = torch.optim.LBFGS([weight, bias], lr=1.0, max_iter=max_iter,
                          max_eval=2 * max_iter, tolerance_grad=1e-9,
                          tolerance_change=1e-15, history_size=20,
                          line_search_fn="strong_wolfe")

  def closure():
    opt.zero_grad()
    loss = (F.cross_entropy(x @ weight.T + bias, y, reduction="sum")
            + 0.5 * torch.sum(weight * weight))
    loss.backward()
    return loss

  opt.step(closure)
  return weight.detach(), bias.detach()


def predict(weight: torch.Tensor, bias: torch.Tensor, x) -> np.ndarray:
  """The most likely class of each row of ``x``."""
  x = torch.as_tensor(np.asarray(x), dtype=torch.float64)
  return (x @ weight.T + bias).argmax(-1).numpy()


def downsample(imgs: np.ndarray) -> np.ndarray:
  """Generated (N, 16, 16, 1) images in [-1, 1] -> (N, 64) in the judge's
  0..16 scale: 2x2 means of the pixel values, as the reference takes
  them."""
  n = len(imgs)
  u8 = (np.clip(imgs, -1, 1) * 127.5 + 127.5)[..., 0]
  small = u8.reshape(n, 8, 2, 8, 2).mean((2, 4)) / 255.0 * 16.0
  return small.reshape(n, -1)


def build_parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(
      prog="python -m wcgan_tpu_torch.tools.eval_conditional_fidelity",
      description="Accuracy of an independent judge on conditional "
                  "samples of the latest checkpoint of a digits run.")
  ap.add_argument("--checkpoints_dir", required=True)
  ap.add_argument("--output_dir", default="fidelity_out")
  ap.add_argument("--name", required=True)
  ap.add_argument("--samples", type=int, default=640)
  ap.add_argument("--block_coloring", default="ucconv")
  ap.add_argument("--gan_type", default="PROJECTIVE",
                  choices=["PROJECTIVE", "AC_GAN"],
                  help="must match the training run (the D head differs, "
                       "so the restore template must too)")
  ap.add_argument("--generator_ema", type=float, default=0.0,
                  help="must match the training run")
  ap.add_argument("--sample_from", choices=("auto", "raw", "running"),
                  default="auto",
                  help="auto = the sampler's own rule (EMA params + "
                       "standing stats when the run trained with "
                       "--generator_ema); raw = the raw parameters; "
                       "running = EMA params against the raw trajectory's "
                       "running stats")
  ap.add_argument("--device", default="cuda",
                  help="'cuda' (default; raises without a GPU) or 'cpu'")
  return ap


def run_argv(args) -> List[str]:
  """The training CLI's flags of the run under evaluation."""
  return ["--dataset", "digits", "--gan_type", args.gan_type,
          "--arch", "res", "--batch_size", "64", "--bf16",
          "--generator_block_coloring", args.block_coloring,
          "--generator_last_coloring", args.block_coloring,
          "--output_dir", args.output_dir,
          "--checkpoints_dir", args.checkpoints_dir,
          "--name", args.name,
          "--generator_ema", str(args.generator_ema),
          "--device", args.device]


def evaluate(args, emit: Callable[[str], None] = print) -> Optional[Dict]:
  """Fit the judge, sample the latest checkpoint and ``emit`` the
  reference's lines; returns the numbers (None without a checkpoint)."""
  cli_run.set_precision()
  trainer = cli_run.build_experiment(
      cli_run.build_parser().parse_args(run_argv(args)))
  latest = trainer.latest_checkpoint()
  if latest is None:
    emit(f"no checkpoint under {args.checkpoints_dir}/{args.name}")
    return None
  images, target = digits_arrays()
  weight, bias = fit_softmax_regression(
      images.reshape(len(images), -1).astype(np.float64), target)
  trainer.restore_checkpoint(latest)
  if args.sample_from == "raw" and trainer.state.g_ema:
    # Without the shadow, the sampling rule falls through to the raw
    # parameters.
    trainer.state.g_ema = None
  if args.sample_from == "running":
    trainer.cfg.ema_standing_batches = 0

  n = args.samples - args.samples % 10
  rng = np.random.default_rng(0)
  req = np.tile(np.arange(10, dtype=np.int32), n // 10)
  z = rng.standard_normal((n, trainer.gan_cfg.z_dim)).astype(np.float32)
  imgs = trainer.sample(z, req).float().cpu().numpy()
  pred = predict(weight, bias, downsample(imgs))
  acc = float((pred == req).mean())
  emit(f"checkpoint: {latest}")
  emit(f"conditional fidelity: {acc:.3f} over {n} samples "
       f"(chance = 0.100)")
  return {"checkpoint": latest, "fidelity": acc, "samples": n}


def main(argv=None) -> int:
  args = build_parser().parse_args(argv)
  return 0 if evaluate(args, lambda s: print(s, flush=True)) else 1


if __name__ == "__main__":
  raise SystemExit(main())
