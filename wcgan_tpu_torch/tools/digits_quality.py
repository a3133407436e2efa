"""Does the port train? The conditional digits runs, judged.

Trains the README's conditional digits run through the port's CLI (in this
process, so that K1's launches can be counted): G (128, 128) cWC
``ucconv`` from 4x4 to 16x16, projection-D or AC-GAN, hinge, bf16, batch
64, 300 epochs with a checkpoint every 25; then scores it with
``eval_digits_fid`` (feature-FID and IS-analog of every checkpoint, the
projection-D run) and ``eval_conditional_fidelity`` (the latest
checkpoint, every run). Prints each run's wall time, its outer steps and
K1 launches, the tools' own lines, and one JSON line of the numbers.

  python -m wcgan_tpu_torch.tools.digits_quality --output_dir build/digits \\
      [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List

import torch

from wcgan_tpu_torch.cli import run as cli_run
from wcgan_tpu_torch.ops import cuda_wc
from wcgan_tpu_torch.tools import eval_conditional_fidelity as fidelity
from wcgan_tpu_torch.tools import eval_digits_fid as digits_fid

# Outer steps an epoch: 1,797 digits // batch 64 // training ratio 5.
STEPS_PER_EPOCH = 1797 // 64 // 5
# The README's run: its epochs and its checkpoint interval in epochs.
EPOCHS = 300
CHECKPOINT_RATIO = 25


def train_argv(gan_type: str, epochs: int, out: str,
               device: str) -> List[str]:
  """The README's digits run through the port's CLI."""
  return ["--device", device, "--dataset", "digits", "--gan_type", gan_type,
          "--arch", "res", "--batch_size", "64",
          "--generator_block_coloring", "ucconv",
          "--generator_last_coloring", "ucconv", "--bf16",
          "--number_of_epochs", str(epochs),
          "--checkpoint_ratio", str(CHECKPOINT_RATIO), "--display_ratio", "50",
          "--output_dir", os.path.join(out, "out"),
          "--checkpoints_dir", os.path.join(out, "ckpt"),
          "--name", f"digits_{gan_type.lower()}"]


def train_and_judge(gan_type: str, epochs: int, out: str, device: str,
                    emit: Callable[[str], None] = print) -> Dict:
  """One digits run and its judges; returns the numbers: the run's wall
  time (host clock, the process's warm-up included), outer steps and K1
  launches, the FID tool's result (projection-D runs: the tool restores
  that D) and the fidelity."""
  argv = train_argv(gan_type, epochs, out, device)
  name = argv[argv.index("--name") + 1]
  if torch.device(device).type == "cuda":
    torch.cuda.synchronize()
  cuda_wc.MOMENTS_LAUNCHES = 0
  t0 = time.perf_counter()
  if cli_run.main(argv) != 0:
    raise RuntimeError(f"digits run failed: {argv}")
  if torch.device(device).type == "cuda":
    torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = cuda_wc.MOMENTS_LAUNCHES
  with open(os.path.join(out, "out", name, "metrics.jsonl")) as f:
    records = [json.loads(l) for l in f if l.strip()]
  records = [r for r in records if "d_loss" in r]
  steps = epochs * STEPS_PER_EPOCH
  emit(f"run {name}: {len(records)} epochs, {steps} outer steps in "
       f"{wall:.1f} s; K1 launches {launches} "
       f"({launches / steps:.2f} a step); last epoch d_loss "
       f"{records[-1]['d_loss']:.4f} g_loss {records[-1]['g_loss']:.4f}")
  result = {"gan_type": gan_type, "epochs": epochs, "outer_steps": steps,
            "wall_s": wall, "k1_launches": launches,
            "epoch_seconds": [r["seconds"] for r in records]}
  tool = ["--checkpoints_dir", os.path.join(out, "ckpt"), "--output_dir",
          os.path.join(out, "eval"), "--name", name, "--device", device]
  if gan_type == "PROJECTIVE":
    t0 = time.perf_counter()
    result["fid"] = digits_fid.evaluate(
        digits_fid.build_parser().parse_args(tool), emit)
    result["fid_wall_s"] = time.perf_counter() - t0
  t0 = time.perf_counter()
  result["fidelity"] = fidelity.evaluate(fidelity.build_parser().parse_args(
      tool + ["--gan_type", gan_type]), emit)
  result["fidelity_wall_s"] = time.perf_counter() - t0
  return result


def card() -> str:
  """The card's name and power limit as nvidia-smi gives them."""
  out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(
      prog="python -m wcgan_tpu_torch.tools.digits_quality",
      description="Train the conditional digits runs and judge them.")
  ap.add_argument("--output_dir", required=True)
  ap.add_argument("--device", default="cuda",
                  help="'cuda' (default; raises without a GPU) or 'cpu'")
  args = ap.parse_args(argv)
  emit = lambda s: print(s, flush=True)  # noqa: E731
  if torch.device(args.device).type == "cuda":
    emit(f"card: {card()}")
  results = [train_and_judge(g, EPOCHS, args.output_dir, args.device, emit)
             for g in ("PROJECTIVE", "AC_GAN")]
  print(json.dumps(results), flush=True)
  return 0


if __name__ == "__main__":
  raise SystemExit(main(sys.argv[1:]))
