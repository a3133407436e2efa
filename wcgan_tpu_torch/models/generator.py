"""The WC generator, ResNet or DCGAN.

Counterpart of ``wcgan_tpu/models/generator.py``: z -> Dense -> base x
base x C -> up-blocks (``arch='res'``: residual blocks; ``'dcgan'``:
norm/color, ReLU, 4x4 stride-2 transposed conv) -> final WC layer -> ReLU
-> 3x3 conv -> tanh, with norm codes {n, b, d, dr} and every coloring
code. A conditional G (``num_classes`` > 0) takes one label per image,
used by its conditional colorings and, with ``concat_cls``, as a one-hot
concatenated to z. ``remat`` recomputes each block's activations in the
backward (``layers.remat_call``). ``group`` (a constructor argument, the
reference's ``cfg.axis_name``) makes every WC layer and BatchNorm whiten
with the statistics of the global batch under data parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from wcgan_tpu_torch.models import blocks as B
from wcgan_tpu_torch.models import layers as L
from wcgan_tpu_torch.parallel import mesh

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
  """Static generator hyperparameters (the JAX package's; its
  ``axis_name`` is the module's ``group``)."""

  arch: str = "res"                    # 'res' | 'dcgan'
  z_dim: int = 128
  resolution: int = 32
  output_channels: int = 3
  filters: Tuple[int, ...] = (256, 256, 256)
  base_resolution: int = 4
  block_norm: str = "d"
  block_coloring: str = "uconv"
  last_norm: str = "d"
  last_coloring: str = "uconv"
  num_classes: int = 0                 # 0 => unconditional
  filters_emb: int = 10                # K basis filters of the '-sa' codes
  concat_cls: bool = False             # one-hot labels concatenated to z
  ns_iters: int = 15
  ns_method: str = "newton_schulz"     # or 'cholesky' (the oracle)
  ns_scaling: str = "trace"
  wc_momentum: float = 0.99
  dtype: str = "float32"               # compute dtype: 'float32'|'bfloat16'
  use_kernel: Optional[bool] = None    # K1 for the moments: None = on CUDA
  kernel_eval: Optional[bool] = None   # K2 for every eval-mode 'uconv'
                                       # WC layer (a conditional one
                                       # raises): None/False = the split
                                       # path (the default, as in the JAX
                                       # package)
  remat: bool = False                  # recompute blocks in the backward

  def __post_init__(self):
    if self.arch not in ("res", "dcgan"):
      raise ValueError(f"generator arch must be 'res' or 'dcgan', got "
                       f"{self.arch!r}")
    if self.dtype not in DTYPES:
      raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                       f"{self.dtype!r}")
    expected = self.base_resolution * 2 ** len(self.filters)
    if expected != self.resolution:
      raise ValueError(
          f"base_resolution {self.base_resolution} x 2^{len(self.filters)} "
          f"blocks = {expected}, but resolution is {self.resolution}")


class Generator(nn.Module):
  """Images (N, C, H, W), channels_last, float32 in [-1, 1] from z (N, z)
  and, when conditional, labels (N,).

  ``train`` whitens with batch statistics; ``update_stats`` advances the
  running statistics (only meaningful in train mode)."""

  def __init__(self, cfg: GeneratorConfig, generator: torch.Generator,
               group: mesh.Group = None):
    super().__init__()
    self.cfg = cfg
    f0 = cfg.filters[0]
    br = cfg.base_resolution
    z_in = cfg.z_dim + (cfg.num_classes if cfg.concat_cls else 0)
    self.fc_in = L.Dense(z_in, br * br * f0, generator)
    wc = dict(ns_iters=cfg.ns_iters, momentum=cfg.wc_momentum,
              ns_scaling=cfg.ns_scaling, use_kernel=cfg.use_kernel,
              kernel_eval=cfg.kernel_eval, num_classes=cfg.num_classes,
              filters_emb=cfg.filters_emb, group=group)
    in_ch = f0
    for i, f in enumerate(cfg.filters):
      if cfg.arch == "res":
        block = B.GenResBlock(in_ch, f, generator, upsample=True,
                              norm=cfg.block_norm,
                              coloring=cfg.block_coloring,
                              ns_method=cfg.ns_method, **wc)
      else:
        block = B.DCGANGenBlock(in_ch, f, generator, norm=cfg.block_norm,
                                coloring=cfg.block_coloring,
                                ns_method=cfg.ns_method, **wc)
      self.add_module(f"block{i}", block)
      in_ch = f
    self.nc_out = L.NormColor(in_ch, norm=cfg.last_norm,
                              coloring=cfg.last_coloring,
                              method=cfg.ns_method, generator=generator, **wc)
    self.conv_out = L.Conv(in_ch, cfg.output_channels, 3, generator)
    for name, m in self.named_modules():
      if isinstance(m, L.NormColor):
        m.layer_name = name

  def reconfigure(self, **changes) -> None:
    """Change ``ns_iters`` or demote norm codes 'dr' -> 'd' (``block_norm``,
    ``last_norm``) on the live module, as the whitening fallback ladder
    does. 'dr' and 'd' hold the same parameters and statistics and differ
    only in which statistics the train-mode transform reads, so both carry
    over unchanged. Every WC layer is reached: the res blocks' ``nc1`` and
    ``nc2``, the DCGAN blocks' ``nc``, and ``nc_out``."""
    cfg = dataclasses.replace(self.cfg, **changes)
    for old, new in ((self.cfg.block_norm, cfg.block_norm),
                     (self.cfg.last_norm, cfg.last_norm)):
      if old != new and {old, new} != {"d", "dr"}:
        raise ValueError(f"cannot change norm code {old!r} -> {new!r} in "
                         "place; only 'd' and 'dr' share their state")
    self.cfg = cfg
    layers = [(cfg.last_norm if name == "nc_out" else cfg.block_norm, m)
              for name, m in self.named_modules()
              if isinstance(m, L.NormColor)]
    for code, nc in layers:
      nc.ns_iters = cfg.ns_iters
      if nc.fused:
        nc.norm_code = code
      elif code in ("d", "dr"):
        nc.norm.code = nc.norm.wc.mode = code
        nc.norm.wc.ns_iters = cfg.ns_iters

  def forward(self, z: torch.Tensor, labels: Optional[torch.Tensor] = None,
              train: bool = True, update_stats: bool = True) -> torch.Tensor:
    cfg = self.cfg
    dtype = DTYPES[cfg.dtype]
    if cfg.num_classes > 0 and labels is None:
      raise ValueError("conditional generator needs labels")
    h = z.to(dtype)
    if cfg.num_classes > 0 and cfg.concat_cls:
      onehot = F.one_hot(labels.long(), cfg.num_classes).to(dtype)
      h = torch.cat([h, onehot], dim=-1)
    h = self.fc_in(h)
    br = cfg.base_resolution
    # The reference lays fc_in's output out as (N, br, br, C); keep that
    # order, then view it as NCHW, which is channels_last in memory.
    h = h.view(h.shape[0], br, br, cfg.filters[0]).permute(0, 3, 1, 2)
    for i in range(len(cfg.filters)):
      block = getattr(self, f"block{i}")
      if cfg.remat:
        h = L.remat_call(block, (h, labels),
                         dict(train=train, update_stats=update_stats),
                         dict(update_stats=False))
      else:
        h = block(h, labels, train, update_stats)
    h = F.relu(self.nc_out(h, labels, train, update_stats))
    h = self.conv_out(h)
    return torch.tanh(h.float())


def preset_filters(arch: str, resolution: int) -> Tuple[int, ...]:
  """Per-dataset default G widths (paper section 5)."""
  if arch == "dcgan":
    return {16: (128, 64), 32: (256, 128, 64), 48: (256, 128, 64),
            64: (512, 256, 128, 64)}[resolution]
  return {16: (128, 128), 32: (256, 256, 256), 48: (512, 256, 128),
          64: (512, 256, 128, 64)}[resolution]
