"""The benchmark shapes of the port, one row per measured program.

Counterpart of ``wcgan_tpu/tools/bench_shapes.py``. ``CONFIGS`` is a copy
of the reference's seven rows: the headline bench shape (G 256x3 + SN-D
128x4, hinge, D:G 5:1), the per-chip shapes of BASELINE configs 1-5, and
AC-GAN at the config-2 shape (``tests/test_torch_bench.py`` holds the copy
to the original). ``build_models`` gives each row's generator and
discriminator configurations at the paper widths of ``preset_filters``,
field for field as the reference builds its modules; ``build_bench`` gives
everything one measured program needs. ``python -m wcgan_tpu_torch.bench``
drives them.

Not ported: the reference's ``unroll_d_scan`` and ``donate``. Both are
XLA's: an eager step has no scan to unroll and no buffers to donate.
"""

from __future__ import annotations

from typing import Dict

import torch

from wcgan_tpu_torch.device import resolve_device
from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
from wcgan_tpu_torch.models.discriminator import preset_filters as d_presets
from wcgan_tpu_torch.models.generator import GeneratorConfig
from wcgan_tpu_torch.models.generator import preset_filters as g_presets
from wcgan_tpu_torch.train.state import OptimConfig, create_state
from wcgan_tpu_torch.train.step import GANConfig, make_jit_step

# One row per BASELINE config's per-chip shape. "headline" is the shape
# of the record (the reference's bench.py). cfg5 is the per-chip slice of
# the data-parallel config 5 (64px, 1000 classes, cWC through -sa: plain
# ucconv at 1000 classes does not fit one chip, cli/presets.py).
CONFIGS: Dict[str, dict] = {
    "headline": dict(res=32, ncls=0, coloring="uconv", arch="res",
                     ratio=5, loss="hinge"),
    "cfg1": dict(res=32, ncls=0, coloring="uconv", arch="dcgan",
                 ratio=1, loss="ns"),
    "cfg2": dict(res=32, ncls=10, coloring="ucconv", arch="res",
                 ratio=5, loss="hinge"),
    "cfg3": dict(res=48, ncls=0, coloring="uconv", arch="res",
                 ratio=5, loss="hinge"),
    "cfg4": dict(res=64, ncls=200, coloring="ucconv-sa", arch="res",
                 ratio=5, loss="hinge"),
    "cfg5": dict(res=64, ncls=1000, coloring="ucconv-sa", arch="res",
                 ratio=5, loss="hinge"),
    # AC-GAN at the cfg2 shape: the auxiliary classifier head on an SN-D
    # without projection, its cross-entropy in both losses.
    "acgan": dict(res=32, ncls=10, coloring="ucconv", arch="res",
                  ratio=5, loss="hinge", acgan=True),
}


def build_models(config: str, dtype: str = "bfloat16", ns_iters: int = 15,
                 ns_scaling: str = "trace", zdim: int = 128,
                 block_norm: str = "d"):
  """(GeneratorConfig, DiscriminatorConfig, spec) at ``config``'s paper
  widths."""
  if config not in CONFIGS:
    raise KeyError(f"unknown config {config!r}; choose from "
                   f"{sorted(CONFIGS)}")
  spec = dict(CONFIGS[config])
  gf = g_presets(spec["arch"], spec["res"])
  df, down = d_presets(spec["arch"], spec["res"])
  acgan = bool(spec.get("acgan"))
  g_cfg = GeneratorConfig(
      arch=spec["arch"], z_dim=zdim, resolution=spec["res"],
      base_resolution=spec["res"] // (2 ** len(gf)),
      filters=gf, num_classes=spec["ncls"], block_norm=block_norm,
      last_norm=block_norm, block_coloring=spec["coloring"],
      last_coloring=spec["coloring"], ns_iters=ns_iters,
      ns_scaling=ns_scaling, dtype=dtype)
  d_cfg = DiscriminatorConfig(
      arch=spec["arch"], resolution=spec["res"], filters=df,
      downsample=down, num_classes=spec["ncls"],
      projection=spec["ncls"] > 0 and not acgan, ac_gan=acgan,
      ns_iters=ns_iters, ns_scaling=ns_scaling, dtype=dtype)
  return g_cfg, d_cfg, spec


def bench_from(g_cfg: GeneratorConfig, d_cfg: DiscriminatorConfig,
               spec: dict, gan: GANConfig, batch: int = 64,
               device: str = "cuda", seed: int = 0):
  """``(step_fn, state, (real, labels), spec)`` of one program: a fresh
  state from ``seed`` (Adam 2e-4, betas 0 / 0.9) on ``device``, the
  compiled outer step of ``gan`` (``make_jit_step``, as the reference's
  bench jits it; ``step_fn.eager`` is the eager step), and one uint8 real
  batch (ratio, batch, res, res, 3)
  with int32 labels (ratio, batch), drawn on the device from a
  ``torch.Generator`` seeded with ``seed + 1``."""
  dev = resolve_device(device)
  res, ratio = spec["res"], spec["ratio"]
  state = create_state(g_cfg, d_cfg, OptimConfig(), ratio, dev, seed)
  gen = torch.Generator(device=dev).manual_seed(seed + 1)
  real = torch.randint(0, 256, (ratio, batch, res, res, 3), generator=gen,
                       device=dev, dtype=torch.uint8)
  labels = torch.randint(0, max(spec["ncls"], 1), (ratio, batch),
                         generator=gen, device=dev, dtype=torch.int32)
  return make_jit_step(gan), state, (real, labels), spec


def build_bench(config: str, batch: int = 64, dtype: str = "bfloat16",
                ns_iters: int = 15, ns_scaling: str = "trace",
                d_fake_stats: str = "batch", zdim: int = 128,
                block_norm: str = "d", device: str = "cuda", seed: int = 0):
  """Everything a perf tool needs for one measured program.

  Returns ``(step_fn, state, (real, labels), spec)`` with spec carrying
  res/ratio/ncls so callers compute imgs/sec = steps*ratio*batch/dt.
  """
  g_cfg, d_cfg, spec = build_models(config, dtype=dtype, ns_iters=ns_iters,
                                    ns_scaling=ns_scaling, zdim=zdim,
                                    block_norm=block_norm)
  gan = GANConfig(loss=spec["loss"], training_ratio=spec["ratio"],
                  generator_batch_multiple=2, z_dim=zdim, random_flip=True,
                  num_classes=spec["ncls"],
                  gan_type="acgan" if spec.get("acgan") else "gan",
                  d_fake_stats=d_fake_stats)
  return bench_from(g_cfg, d_cfg, spec, gan, batch, device, seed)
