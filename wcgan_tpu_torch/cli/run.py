"""Experiment entry point of the port: ``python -m wcgan_tpu_torch``.

Counterpart of ``wcgan_tpu/cli/run.py`` for the slices ported so far: the
ResNet WC-GAN (G with norm codes n/d/dr and every coloring code, the
conditional ones with ``--conditional``; ResNet D with or without spectral
normalization, optional WC layers, projection-D or the AC-GAN head by
``--gan_type``), hinge/ns/wgan/wgan-gp losses, Adam with the reference's
LR schedules, the reference's default run (device-resident data in
chains of ``--steps_per_call``, the whitening probe and guard, full-state
checkpoints every ``--checkpoint_ratio`` epochs, ``--resume``), EMA
weights with standing statistics (``--generator_ema``), sample grids, and
``--phase test``, which writes one grid from the restored state or from
weights-only ``.npz`` (or ``.h5``) files. Flag names and defaults are the
JAX CLI's. A flag of the JAX CLI that the port does not support yet is
rejected with an error, never ignored.

Usage:
  python -m wcgan_tpu_torch --device cuda --dataset synthetic --arch res \\
      --bf16 --number_of_epochs 2 --batches_per_epoch 3
  python -m wcgan_tpu_torch --device cuda --dataset synthetic --bf16 \\
      --number_of_epochs 4 --resume auto
  python -m wcgan_tpu_torch --device cuda --dataset synthetic --bf16 \\
      --conditional --gan_type PROJECTIVE --generator_block_coloring ucconv \\
      --generator_last_coloring ucconv
  python -m wcgan_tpu_torch --device cpu --phase test \\
      --generator_checkpoint epoch_9_generator.npz
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from wcgan_tpu_torch.data import DATASETS, get_dataset
from wcgan_tpu_torch.tools.h5_convert import apply_key_map, h5_flat
from wcgan_tpu_torch import weights
from wcgan_tpu_torch.device import resolve_device
from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
from wcgan_tpu_torch.models.discriminator import preset_filters as d_presets
from wcgan_tpu_torch.models.generator import GeneratorConfig
from wcgan_tpu_torch.models.generator import preset_filters as g_presets
from wcgan_tpu_torch.models.layers import COLORING_CODES
from wcgan_tpu_torch.train.state import OptimConfig, create_state
from wcgan_tpu_torch.train.step import GANConfig
from wcgan_tpu_torch.train.trainer import Trainer, TrainerConfig

# The norm codes the port takes ('b', BatchNorm, is not ported yet).
NORM_CODES = ("n", "d", "dr")

# Flags of the JAX CLI (wcgan_tpu/cli/run.py) that this port does not take
# yet; each is refused by name instead of being silently dropped.
UNSUPPORTED_FLAGS = (
    "--spectral_iterations", "--fully_diff_spectral", "--conv_singular",
    "--sn_update_on_g_step", "--whitening_precision",
    "--compute_inception_score", "--compute_fid", "--score_every",
    "--samples_inception", "--samples_fid", "--inception_weights",
    "--platform", "--mesh", "--remat", "--profile_dir", "--debug_nans",
    "--synthetic_resolution", "--smoke", "--batched_fake_gen",
    "--d_fake_stats", "--compilation_cache_dir", "--preset")


def build_parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(
      prog="python -m wcgan_tpu_torch",
      description="wcgan_tpu_torch — WC-GAN training in PyTorch/CUDA")
  p.add_argument("--device", default="cuda",
                 help="'cuda' (default; an error if there is no GPU) or "
                      "'cpu'")
  p.add_argument("--name", default=None,
                 help="experiment name (default: derived from config)")
  p.add_argument("--output_dir", default="output")
  p.add_argument("--checkpoints_dir", default="checkpoints")
  p.add_argument("--checkpoint_ratio", type=int, default=10,
                 help="full-state checkpoint and weights-only npz every N "
                      "epochs (0 = never)")
  p.add_argument("--resume", default=None,
                 help="'auto' = latest full-state checkpoint, or a path")
  p.add_argument("--display_ratio", type=int, default=1,
                 help="write a sample grid every N epochs (0 = never)")
  p.add_argument("--start_epoch", type=int, default=0,
                 help="first epoch's number; --phase test names its grid "
                      "after it")
  p.add_argument("--generator_checkpoint", default=None,
                 help="weights-only generator .npz (or .h5) to load")
  p.add_argument("--discriminator_checkpoint", default=None,
                 help="weights-only discriminator .npz (or .h5) to load")
  p.add_argument("--checkpoint_key_map", default=None,
                 help="JSON rename table for the checkpoints' keys: one "
                      "flat {src: dst} map, or 'generator'/'discriminator' "
                      "sections; 're:<pattern>' sources are regex rules")
  p.add_argument("--checkpoint_missing", default="error",
                 choices=["error", "init"],
                 help="params absent from a checkpoint: 'error' (default) "
                      "or 'init' (keep their initialization, listed)")
  p.add_argument("--phase", default="train", choices=["train", "test"],
                 help="'test' loads the checkpoints and writes one sample "
                      "grid")
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--dataset", default="cifar10", choices=sorted(DATASETS))
  p.add_argument("--data_dir", default="data")
  p.add_argument("--synthetic_size", type=int, default=4096)
  p.add_argument("--arch", default="res", choices=["res"])
  p.add_argument("--loss", default="hinge",
                 choices=["hinge", "ns", "wgan", "wgan-gp"])
  p.add_argument("--gan_type", default="GAN",
                 choices=["GAN", "PROJECTIVE", "AC_GAN"])
  p.add_argument("--gradient_penalty_weight", type=float, default=10.0,
                 help="WGAN-GP penalty weight (only with --loss wgan-gp)")
  p.add_argument("--conditional", action="store_true",
                 help="class-conditional training (labels flow to G/D); "
                      "implied by --gan_type PROJECTIVE or AC_GAN")
  p.add_argument("--generator_block_norm", default="d",
                 choices=list(NORM_CODES))
  p.add_argument("--generator_block_coloring", default="uconv",
                 choices=list(COLORING_CODES))
  p.add_argument("--generator_last_norm", default="d",
                 choices=list(NORM_CODES))
  p.add_argument("--generator_last_coloring", default="uconv",
                 choices=list(COLORING_CODES))
  p.add_argument("--generator_filters", default=None,
                 help="comma-separated per-block widths (default preset)")
  p.add_argument("--generator_concat_cls", action="store_true",
                 help="concatenate the one-hot label to z")
  p.add_argument("--filters_emb", type=int, default=10,
                 help="basis filters of the '-sa' conditional colorings")
  p.add_argument("--discriminator_norm", default="n",
                 choices=list(NORM_CODES))
  p.add_argument("--discriminator_coloring", default="n",
                 choices=list(COLORING_CODES))
  p.add_argument("--discriminator_filters", default=None,
                 help="comma-separated per-block widths (default preset)")
  p.add_argument("--discriminator_spectral", type=int, default=1,
                 help="1 = spectral-normalize D kernels (default)")
  p.add_argument("--batch_size", type=int, default=64)
  p.add_argument("--training_ratio", type=int, default=5)
  p.add_argument("--generator_batch_multiple", type=int, default=2)
  p.add_argument("--generator_lr", type=float, default=2e-4)
  p.add_argument("--discriminator_lr", type=float, default=2e-4)
  p.add_argument("--beta1", type=float, default=0.0)
  p.add_argument("--beta2", type=float, default=0.9)
  p.add_argument("--lr_decay_schedule", default="none",
                 choices=["none", "linear", "half-linear", "linear-end"])
  p.add_argument("--number_of_epochs", type=int, default=100)
  p.add_argument("--batches_per_epoch", type=int, default=None)
  p.add_argument("--z_dim", type=int, default=128)
  p.add_argument("--ns_iters", type=int, default=15,
                 help="Newton-Schulz iterations for whitening (keep >= 15)")
  p.add_argument("--whitening_method", default="newton_schulz",
                 choices=["newton_schulz", "cholesky"])
  p.add_argument("--ns_scaling", default="trace", choices=["trace", "fro"])
  p.add_argument("--wc_momentum", type=float, default=0.99)
  p.add_argument("--bf16", action="store_true",
                 help="bfloat16 compute in G/D (whitening stays float32)")
  p.add_argument("--random_flip", type=int, default=None,
                 help="1/0 horizontal flip of real images (default: on for "
                      "natural-image datasets)")
  p.add_argument("--generator_ema", type=float, default=0.0,
                 help="EMA decay for generator weights used at sampling "
                      "(0 = off; e.g. 0.999)")
  p.add_argument("--ema_standing_stats", type=int, default=16,
                 help="train-mode batches that re-estimate G's "
                      "normalization statistics under the EMA params before "
                      "EMA sampling (only with --generator_ema); 0 = the "
                      "raw trajectory's running statistics")
  p.add_argument("--wc_residual_action", default="warn",
                 choices=["warn", "abort", "fallback"],
                 help="when the whitening residual probe passes 1e-2 (or is "
                      "not finite): 'warn' = log and continue, 'abort' = "
                      "checkpoint and stop, 'fallback' = checkpoint, demote "
                      "'dr' norms to 'd', then double ns_iters once, and "
                      "abort once nothing is left")
  p.add_argument("--fallback_cooldown", type=int, default=-1,
                 help="outer steps after a fallback rung in which breaches "
                      "do not escalate; -1 = ceil(5/(1-wc_momentum))")
  p.add_argument("--residual_probe_every", type=int, default=0,
                 help="also probe whitening health every N outer steps "
                      "inside the epoch (0 = per epoch only)")
  p.add_argument("--device_data", type=int, default=1,
                 help="1 = the dataset lives on the device and batches are "
                      "drawn there, i.i.d. with replacement; 0 = host-fed "
                      "shuffled batches")
  p.add_argument("--steps_per_call", type=int, default=8,
                 help="outer steps chained per call (device_data only); "
                      "the epoch rounds down to whole chains")
  p.add_argument("--device_data_limit", type=int, default=2_000_000_000,
                 help="device byte budget for the dataset; larger datasets "
                      "train on a rotating random window per epoch (two "
                      "half-budget windows in flight)")
  return p


def _reject_unsupported(argv: List[str]) -> None:
  given = sorted({a.split("=", 1)[0] for a in argv
                  if a.split("=", 1)[0] in UNSUPPORTED_FLAGS})
  if given:
    raise SystemExit(
        f"wcgan_tpu_torch: {', '.join(given)} not supported by the PyTorch "
        "port yet (the JAX CLI, python run.py, has them)")


def _parse_filters(spec: Optional[str]):
  if spec is None:
    return None
  return tuple(int(x) for x in spec.split(",") if x)


def set_precision() -> str:
  """Pin float32 matmuls and convolutions to true float32 (no TF32) and
  report both switches: Newton-Schulz does not converge under TF32-class
  passes (measured on the reference, wcgan_tpu/ops/whiten.py)."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return (f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")


def build_experiment(args) -> Trainer:
  """args -> a Trainer with its state on ``args.device``."""
  device = resolve_device(args.device)
  conditional = args.conditional or args.gan_type in ("PROJECTIVE",
                                                      "AC_GAN")
  ds = get_dataset(args.dataset, batch_size=args.batch_size,
                   data_dir=args.data_dir, conditional=conditional,
                   seed=args.seed, z_dim=args.z_dim,
                   synthetic_size=args.synthetic_size)
  res = ds.resolution
  num_classes = ds.num_classes
  dtype = "bfloat16" if args.bf16 else "float32"
  g_filters = _parse_filters(args.generator_filters) or g_presets(res)
  g_cfg = GeneratorConfig(
      z_dim=args.z_dim, resolution=res, output_channels=ds.channels,
      filters=g_filters, base_resolution=res // (2 ** len(g_filters)),
      block_norm=args.generator_block_norm,
      block_coloring=args.generator_block_coloring,
      last_norm=args.generator_last_norm,
      last_coloring=args.generator_last_coloring, num_classes=num_classes,
      filters_emb=args.filters_emb, concat_cls=args.generator_concat_cls,
      ns_iters=args.ns_iters, ns_method=args.whitening_method,
      ns_scaling=args.ns_scaling, wc_momentum=args.wc_momentum, dtype=dtype)
  d_filters = _parse_filters(args.discriminator_filters)
  if d_filters is None:
    d_filters, d_down = d_presets(res)
  else:
    # All blocks but the last downsample; block 0 (the optimized block)
    # always does.
    d_down = (True,) + (True,) * (len(d_filters) - 2) + (False,) * (
        len(d_filters) > 1)
  d_cfg = DiscriminatorConfig(
      resolution=res, input_channels=ds.channels, filters=d_filters,
      downsample=d_down, spectral=bool(args.discriminator_spectral),
      norm=args.discriminator_norm, coloring=args.discriminator_coloring,
      num_classes=num_classes, filters_emb=args.filters_emb,
      projection=args.gan_type == "PROJECTIVE",
      ac_gan=args.gan_type == "AC_GAN", ns_iters=args.ns_iters,
      ns_method=args.whitening_method, wc_momentum=args.wc_momentum,
      ns_scaling=args.ns_scaling, dtype=dtype)
  gan_cfg = GANConfig(
      loss=args.loss,
      gan_type={"GAN": "gan", "PROJECTIVE": "projection",
                "AC_GAN": "acgan"}[args.gan_type],
      training_ratio=args.training_ratio,
      generator_batch_multiple=args.generator_batch_multiple,
      gradient_penalty_weight=(args.gradient_penalty_weight
                               if args.loss == "wgan-gp" else 0.0),
      num_classes=num_classes, z_dim=args.z_dim,
      g_ema_decay=args.generator_ema,
      random_flip=(bool(args.random_flip) if args.random_flip is not None
                   else args.dataset not in ("mnist", "fashion-mnist",
                                             "digits")))
  steps_per_epoch = args.batches_per_epoch or max(
      ds.number_of_batches_per_epoch // args.training_ratio, 1)
  opt_cfg = OptimConfig(
      generator_lr=args.generator_lr, discriminator_lr=args.discriminator_lr,
      beta1=args.beta1, beta2=args.beta2,
      lr_decay_schedule=args.lr_decay_schedule,
      total_outer_steps=steps_per_epoch * args.number_of_epochs)
  state = create_state(g_cfg, d_cfg, opt_cfg, args.training_ratio, device,
                       seed=args.seed, g_ema_decay=args.generator_ema)
  name = args.name or (f"{args.dataset}_{args.arch}_{args.loss}"
                       f"_{args.generator_block_norm}-"
                       f"{args.generator_block_coloring}"
                       + ("_cond" if conditional else ""))
  tcfg = TrainerConfig(
      name=name, output_dir=os.path.join(args.output_dir, name),
      checkpoints_dir=args.checkpoints_dir,
      number_of_epochs=args.number_of_epochs, start_epoch=args.start_epoch,
      checkpoint_ratio=args.checkpoint_ratio,
      display_ratio=args.display_ratio,
      batches_per_epoch=args.batches_per_epoch, seed=args.seed,
      device_data=bool(args.device_data),
      device_data_limit=args.device_data_limit,
      steps_per_call=args.steps_per_call,
      wc_residual_action=args.wc_residual_action,
      fallback_cooldown=args.fallback_cooldown,
      residual_probe_every=args.residual_probe_every,
      ema_standing_batches=args.ema_standing_stats)
  return Trainer(ds, state, gan_cfg, tcfg)


def _load_weights_npz(module, path: str, key_map_path: Optional[str] = None,
                      model: Optional[str] = None, missing: str = "error",
                      log=None) -> None:
  """Load a weights-only ``.npz`` (the JAX package's export format) or a
  Keras-style ``.h5`` into ``module``'s parameters, as the JAX CLI's
  ``_load_weights_npz`` does: the optional ``--checkpoint_key_map`` JSON
  (one flat table, or 'generator'/'discriminator' sections selected by
  ``model``) renames keys through ``wcgan_tpu_torch.tools.h5_convert``, and
  ``missing`` is ``--checkpoint_missing``."""
  emit = log or print
  key_map = None
  if key_map_path:
    with open(key_map_path) as f:
      key_map = json.load(f)
    if key_map and all(isinstance(v, dict) for v in key_map.values()):
      valid = {"generator", "discriminator"}
      unknown = sorted(set(key_map) - valid)
      if unknown:
        raise ValueError(
            f"--checkpoint_key_map {key_map_path}: unknown section(s) "
            f"{unknown}; sectioned maps use keys {sorted(valid)}")
      if model not in key_map:
        emit(f"checkpoint_key_map: sectioned map {key_map_path} has no "
             f"'{model}' section — no renames applied to this model")
      key_map = key_map.get(model, {})
  if path.endswith((".h5", ".hdf5")):
    try:
      loaded = h5_flat(path)
    except ModuleNotFoundError as e:
      raise ModuleNotFoundError(
          f"loading {path} needs h5py, which is not installed ({e}); "
          "convert it to .npz where h5py is installed") from e
  else:
    with np.load(path) as data:
      loaded = dict(data)
  weights.load_npz(module, apply_key_map(loaded, key_map), missing=missing,
                   source=path, model=model, log=emit)


def main(argv=None) -> int:
  argv = list(sys.argv[1:]) if argv is None else list(argv)
  _reject_unsupported(argv)
  args = build_parser().parse_args(argv)
  print(set_precision(), flush=True)
  trainer = build_experiment(args)
  device = trainer.state.generator.device
  trainer.logger.line(f"wcgan_tpu_torch on {device}"
                      + (f" ({torch.cuda.get_device_name(device)})"
                         if device.type == "cuda" else ""))
  if args.resume == "auto":
    latest = trainer.latest_checkpoint()
    if latest:
      trainer.restore_checkpoint(latest)
      # Continue the epoch schedule unless --start_epoch pins it.
      if args.start_epoch == 0:
        base = os.path.basename(latest.rstrip(os.sep))
        try:
          trainer.cfg.start_epoch = int(base.split("_")[1]) + 1
        except (IndexError, ValueError):
          pass
      trainer.logger.line(f"resumed from {latest} "
                          f"(start_epoch {trainer.cfg.start_epoch})")
  elif args.resume:
    trainer.restore_checkpoint(args.resume)
  for model, module, path in (
      ("generator", trainer.state.g, args.generator_checkpoint),
      ("discriminator", trainer.state.d, args.discriminator_checkpoint)):
    if path:
      _load_weights_npz(module, path, args.checkpoint_key_map, model=model,
                        missing=args.checkpoint_missing,
                        log=trainer.logger.line)
  if args.phase == "test":
    # As in the JAX CLI, a weights-only file replaces only the parameters:
    # without --resume G's running statistics stay at their initialization
    # (mean 0, cov I).
    path = trainer.save_sample_grid(args.start_epoch)
    trainer.logger.line(f"wrote sample grid {path}")
    return 0
  trainer.train()
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
