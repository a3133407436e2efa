"""Experiment entry point of the port: ``python -m wcgan_tpu_torch``.

Counterpart of ``wcgan_tpu/cli/run.py`` on one device: the ResNet and
DCGAN WC-GANs (G with norm codes n/b/d/dr and every coloring code, the
conditional ones with ``--conditional``; D with or without spectral
normalization, by the kernel matrix or by the conv operator
(``--conv_singular``), optional WC layers in the ResNet D, projection-D or
the AC-GAN head by ``--gan_type``), hinge/ns/wgan/wgan-gp losses, Adam
with the reference's LR schedules, the step's options
(``--batched_fake_gen``, ``--d_fake_stats``, ``--sn_update_on_g_step``,
``--remat``), the reference's default run (device-resident data in chains
of ``--steps_per_call``, the whitening probe and guard, full-state
checkpoints every ``--checkpoint_ratio`` epochs, ``--resume``), EMA
weights with standing statistics (``--generator_ema``), sample grids, and
``--phase test``, which writes one grid from the restored state or from
weights-only ``.npz`` (or ``.h5``) files, and data parallelism: ``--mesh
N`` trains on N ranks with the statistics of the global batch, one
process and one GPU per rank over NCCL (``--device cpu``: N CPU ranks
over gloo); ``--mesh 0`` is one process. ``--preset <name>`` expands to a
BASELINE configuration's flags (``cli/presets.py``), and ``--smoke``
shrinks any run to a few seconds on synthetic data of the dataset's
resolution, keeping its architecture and codes.
``--compute_inception_score`` and ``--compute_fid`` score every
``--score_every`` epochs and after ``--phase test``'s grid
(``evaluation/``; on every rank under ``--mesh``). Flag names and defaults
are the JAX CLI's. A flag of the JAX CLI that the port does not take is
refused by name with the reason, never ignored.

Usage:
  python -m wcgan_tpu_torch --preset cifar10_wc_dcgan --dataset synthetic \\
      --synthetic_resolution 32 --number_of_epochs 2
  python -m wcgan_tpu_torch --preset stl10_wc_resnet_sn --smoke --device cpu
  python -m wcgan_tpu_torch --device cuda --dataset synthetic --arch res \\
      --bf16 --number_of_epochs 2 --batches_per_epoch 3
  python -m wcgan_tpu_torch --device cuda --dataset synthetic --bf16 \\
      --number_of_epochs 4 --resume auto
  python -m wcgan_tpu_torch --device cuda --dataset synthetic --bf16 \\
      --conditional --gan_type PROJECTIVE --generator_block_coloring ucconv \\
      --generator_last_coloring ucconv
  python -m wcgan_tpu_torch --device cpu --phase test \\
      --generator_checkpoint epoch_9_generator.npz
  python -m wcgan_tpu_torch --preset imagenet64_cwc_dp --smoke --device cpu \\
      --mesh 2
  python -m wcgan_tpu_torch --device cuda --dataset synthetic --bf16 \\
      --compute_inception_score 1 --compute_fid 1 --score_every 5
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from wcgan_tpu_torch.cli.presets import preset_argv
from wcgan_tpu_torch.data import DATASETS, get_dataset
from wcgan_tpu_torch.data.base import ArrayDataset
from wcgan_tpu_torch.tools.h5_convert import apply_key_map, h5_flat
from wcgan_tpu_torch import weights
from wcgan_tpu_torch.device import resolve_device
from wcgan_tpu_torch.evaluation.scorer import make_scorer
from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
from wcgan_tpu_torch.models.discriminator import preset_filters as d_presets
from wcgan_tpu_torch.models.generator import GeneratorConfig
from wcgan_tpu_torch.models.generator import preset_filters as g_presets
from wcgan_tpu_torch.models.layers import COLORING_CODES
from wcgan_tpu_torch.ops import whiten
from wcgan_tpu_torch.parallel import launch, mesh
from wcgan_tpu_torch.train.state import OptimConfig, create_state
from wcgan_tpu_torch.train.step import GANConfig
from wcgan_tpu_torch.train.trainer import (Trainer, TrainerConfig,
                                           check_ema_under_mesh)

NORM_CODES = ("n", "b", "d", "dr")

# Flags of the JAX CLI (wcgan_tpu/cli/run.py) that this port does not take,
# and why; each is refused by name instead of being silently dropped.
UNSUPPORTED_FLAGS = {
    "--platform": "it picks a JAX/XLA platform; the port takes --device",
    "--compilation_cache_dir": "it is XLA's compile cache; the port "
                               "compiles its kernels into build/kernels/",
}


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
  p.add_argument("--synthetic_resolution", type=int, default=None,
                 help="override the synthetic dataset's resolution")
  p.add_argument("--smoke", action="store_true",
                 help="smoke mode: synthetic data at the dataset's "
                      "resolution, widths 16, 2 epochs of 2 outer steps; "
                      "architecture, loss and codes kept")
  p.add_argument("--arch", default="res", choices=["res", "dcgan"])
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
  p.add_argument("--spectral_iterations", type=int, default=1,
                 help="power-iteration steps per SN forward")
  p.add_argument("--fully_diff_spectral", action="store_true",
                 help="backpropagate through the power iteration")
  p.add_argument("--conv_singular", action="store_true",
                 help="SN convs by the operator norm of the convolution "
                      "(power iteration through conv and its transpose)")
  p.add_argument("--sn_update_on_g_step", action="store_true",
                 help="the G update's D forward advances the SN vectors")
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
  p.add_argument("--whitening_precision", default="highest",
                 choices=["highest", "high"],
                 help="'highest' = true float32 whitening matmuls (TF32 "
                      "off), the port's default; 'high' = the JAX CLI's "
                      "default, XLA's 3-pass bf16 HIGH: on the card every "
                      "whitening-path product runs as three bf16 "
                      "tensor-core products (kernel K3, mm_bf16x3), on "
                      "the CPU as its plain version")
  p.add_argument("--mesh", type=int, default=0,
                 help="data-parallel over N ranks, one process each: N GPUs "
                      "over NCCL with --device cuda, N CPU ranks over gloo "
                      "with --device cpu (0 = one process)")
  p.add_argument("--bf16", action="store_true",
                 help="bfloat16 compute in G/D (whitening stays float32)")
  p.add_argument("--remat", action="store_true",
                 help="recompute G's blocks (and a ResNet D's) in the "
                      "backward: memory for time")
  p.add_argument("--batched_fake_gen", type=int, default=0,
                 help="1 = one G forward for all training_ratio fake "
                      "batches of an outer step (whitening statistics "
                      "over ratio x batch rows)")
  p.add_argument("--d_fake_stats", type=str, default="batch",
                 choices=["batch", "running"],
                 help="statistics of the D-phase fake forwards: 'batch' "
                      "(the reference's) or 'running' (G in eval mode)")
  p.add_argument("--profile_dir", default=None,
                 help="write a torch.profiler Chrome trace of a few step "
                      "calls here")
  p.add_argument("--debug_nans", action="store_true",
                 help="torch.autograd anomaly detection, and raise at the "
                      "first step call with a non-finite metric")
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
  p.add_argument("--compute_inception_score", type=int, default=0,
                 help="1 = Inception Score every --score_every epochs and "
                      "after --phase test")
  p.add_argument("--compute_fid", type=int, default=0,
                 help="1 = FID against --samples_fid real images, likewise")
  p.add_argument("--score_every", type=int, default=10,
                 help="epochs between IS/FID evaluations")
  p.add_argument("--samples_inception", type=int, default=50000)
  p.add_argument("--samples_fid", type=int, default=10000)
  p.add_argument("--inception_weights", default=None,
                 help="InceptionV3 weights, an npz of torchvision's "
                      "state_dict; without it the scores are random "
                      "weights' and named unverified_*")
  return p


def _reject_unsupported(argv: List[str]) -> None:
  given = sorted({a.split("=", 1)[0] for a in argv
                  if a.split("=", 1)[0] in UNSUPPORTED_FLAGS})
  if given:
    raise SystemExit("wcgan_tpu_torch: " + "; ".join(
        f"{flag} not supported by the PyTorch port: {UNSUPPORTED_FLAGS[flag]}"
        for flag in given) + " (the JAX CLI, python run.py, has them)")


def expand_preset(argv: List[str]) -> List[str]:
  """``--preset <name>`` replaced by the preset's flags; flags given after
  it override them (argparse keeps the last), as in the JAX CLI."""
  if "--preset" not in argv:
    return argv
  i = argv.index("--preset")
  if i + 1 >= len(argv):
    raise SystemExit("wcgan_tpu_torch: --preset needs a name")
  return preset_argv(argv[i + 1], argv[:i] + argv[i + 2:])


def _apply_smoke(args) -> None:
  """Shrink a run to smoke size in place, keeping its semantics (arch,
  loss, norm/coloring codes, conditionality, resolution): the JAX CLI's
  ``_apply_smoke`` on one device."""
  res, _, _ = DATASETS[args.dataset]
  args.synthetic_resolution = args.synthetic_resolution or res
  args.dataset = "synthetic"
  args.synthetic_size = min(args.synthetic_size, 64)
  args.batch_size = max(8, 2 * (args.mesh or 1))  # the JAX CLI's rule
  args.generator_filters = args.generator_filters or "16,16"
  args.discriminator_filters = args.discriminator_filters or "16,16"
  args.ns_iters = min(args.ns_iters, 6)
  args.number_of_epochs = 2
  args.batches_per_epoch = 2
  args.checkpoint_ratio = 2
  args.display_ratio = 1
  args.steps_per_call = 1
  args.compute_inception_score = 0
  args.compute_fid = 0


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


def build_experiment(args, group: mesh.Group = None,
                     dataset: Optional[ArrayDataset] = None) -> Trainer:
  """args -> a Trainer with its state on ``args.device``, as one rank of
  ``group`` when one is given, on ``dataset`` when one is given (else the
  one ``--dataset`` names)."""
  if args.smoke:
    _apply_smoke(args)
  # Before any step is built, as the JAX CLI sets it; every --mesh rank
  # builds its experiment here.
  whiten.set_precision(args.whitening_precision)
  device = resolve_device(args.device)
  conditional = args.conditional or args.gan_type in ("PROJECTIVE",
                                                      "AC_GAN")
  ds = dataset or get_dataset(
      args.dataset, batch_size=args.batch_size, data_dir=args.data_dir,
      conditional=conditional, seed=args.seed, z_dim=args.z_dim,
      synthetic_size=args.synthetic_size,
      synthetic_resolution=args.synthetic_resolution)
  res = ds.resolution
  num_classes = ds.num_classes
  dtype = "bfloat16" if args.bf16 else "float32"
  g_filters = (_parse_filters(args.generator_filters)
               or g_presets(args.arch, res))
  g_cfg = GeneratorConfig(
      arch=args.arch, z_dim=args.z_dim, resolution=res,
      output_channels=ds.channels,
      filters=g_filters, base_resolution=res // (2 ** len(g_filters)),
      block_norm=args.generator_block_norm,
      block_coloring=args.generator_block_coloring,
      last_norm=args.generator_last_norm,
      last_coloring=args.generator_last_coloring, num_classes=num_classes,
      filters_emb=args.filters_emb, concat_cls=args.generator_concat_cls,
      ns_iters=args.ns_iters, ns_method=args.whitening_method,
      ns_scaling=args.ns_scaling, wc_momentum=args.wc_momentum, dtype=dtype,
      remat=args.remat)
  d_filters = _parse_filters(args.discriminator_filters)
  if d_filters is None:
    d_filters, d_down = d_presets(args.arch, res)
  else:
    # All blocks but the last downsample; block 0 of the res D (the
    # optimized block) always does. The DCGAN D's blocks all stride 2.
    d_down = (True,) * (len(d_filters) - 1) + (False,)
    if args.arch == "res":
      d_down = (True,) + d_down[1:]
  d_cfg = DiscriminatorConfig(
      arch=args.arch, resolution=res, input_channels=ds.channels,
      filters=d_filters, downsample=d_down,
      spectral=bool(args.discriminator_spectral),
      sn_iters=args.spectral_iterations, fully_diff=args.fully_diff_spectral,
      conv_singular=args.conv_singular, remat=args.remat,
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
      sn_update_on_g_step=args.sn_update_on_g_step,
      batched_fake_gen=bool(args.batched_fake_gen),
      d_fake_stats=args.d_fake_stats, g_ema_decay=args.generator_ema,
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
                       seed=args.seed, g_ema_decay=args.generator_ema,
                       group=group)
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
      ema_standing_batches=args.ema_standing_stats,
      profile_dir=args.profile_dir, debug_nans=args.debug_nans,
      score_every=args.score_every)
  scorer = None
  if args.compute_inception_score or args.compute_fid:
    scorer = make_scorer(
        ds, compute_is=bool(args.compute_inception_score),
        compute_fid=bool(args.compute_fid),
        samples_inception=args.samples_inception,
        samples_fid=args.samples_fid,
        inception_weights=args.inception_weights, group=group)
  return Trainer(ds, state, gan_cfg, tcfg, group=group, scorer=scorer)


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


def mesh_devices(args) -> List[str]:
  """The devices of the ``--mesh`` ranks: one GPU each, cuda:0..N-1, or N
  CPU ranks; raise where there are fewer GPUs than ranks."""
  n = args.mesh
  if n < 0:
    raise SystemExit(f"wcgan_tpu_torch: --mesh {n}: the ranks must be >= 0")
  if args.device == "cpu":
    return ["cpu"] * n
  if args.device != "cuda":
    raise SystemExit(f"wcgan_tpu_torch: --mesh takes --device cuda or cpu "
                     f"(each rank gets its own GPU), got {args.device!r}")
  have = torch.cuda.device_count() if torch.cuda.is_available() else 0
  if have < n:
    raise SystemExit(f"wcgan_tpu_torch: --mesh {n} --device cuda needs {n} "
                     f"CUDA GPUs, one per rank, but torch sees {have}")
  return [f"cuda:{i}" for i in range(n)]


def rank_main(ctx: launch.RankContext, argv: List[str]) -> int:
  """One rank of a ``--mesh`` run: the experiment of ``argv`` on this
  rank's device, in its group."""
  args = build_parser().parse_args(argv)
  args.device = str(ctx.device)
  return _run(args, ctx.group)


def main(argv=None) -> int:
  argv = list(sys.argv[1:]) if argv is None else list(argv)
  argv = expand_preset(argv)
  _reject_unsupported(argv)
  args = build_parser().parse_args(argv)
  # --phase test samples in eval mode, which reduces nothing: one process.
  if args.mesh and args.phase == "train":
    devices = mesh_devices(args)
    try:
      check_ema_under_mesh(True, args.generator_ema, args.ema_standing_stats)
    except ValueError as e:
      raise SystemExit(f"wcgan_tpu_torch: {e}") from None
    launch.launch("wcgan_tpu_torch.cli.run:rank_main", devices, (argv,),
                  timeout=None)
    return 0
  return _run(args)


def _run(args, group: mesh.Group = None) -> int:
  precision = set_precision()
  if mesh.rank(group) == 0:
    print(f"{precision} whitening_precision={args.whitening_precision}",
          flush=True)
  if args.debug_nans:
    torch.autograd.set_detect_anomaly(True)
  trainer = build_experiment(args, group)
  device = trainer.state.generator.device
  trainer.logger.line(f"wcgan_tpu_torch on {device}"
                      + (f" ({torch.cuda.get_device_name(device)})"
                         if device.type == "cuda" else "")
                      + (f", rank 0 of {mesh.world_size(group)} "
                         f"({torch.distributed.get_backend(group)})"
                         if group is not None else ""))
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
    if trainer.scorer is not None:
      scores = trainer.scorer(trainer)
      trainer.logger.line("; ".join(f"{k} = {v:.4f}"
                                    for k, v in scores.items()))
    return 0
  trainer.train()
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
