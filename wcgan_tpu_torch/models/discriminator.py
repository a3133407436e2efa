"""The SN-GAN ResNet discriminator.

Counterpart of ``wcgan_tpu/models/discriminator.py`` for ``arch='res'``:
spectral-normalized down-blocks -> ReLU -> global sum pool -> SN dense ->
scalar score. Projection-D, the AC-GAN head, norm layers in D and the
DCGAN arch are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from wcgan_tpu_torch.models import blocks as B
from wcgan_tpu_torch.models import layers as L
from wcgan_tpu_torch.models.generator import DTYPES


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
  """Static discriminator hyperparameters (the subset the port supports)."""

  arch: str = "res"
  resolution: int = 32
  input_channels: int = 3
  filters: Tuple[int, ...] = (128, 128, 128, 128)
  downsample: Tuple[bool, ...] = (True, True, False, False)
  sn_iters: int = 1
  fully_diff: bool = False
  dtype: str = "float32"

  def __post_init__(self):
    if self.arch != "res":
      raise NotImplementedError(f"discriminator arch {self.arch!r}: only "
                                "'res' is ported")
    if self.dtype not in DTYPES:
      raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                       f"{self.dtype!r}")
    if len(self.downsample) != len(self.filters):
      raise ValueError("downsample and filters must align per block")
    if not self.downsample[0]:
      raise ValueError("downsample[0] must be True: the first res block "
                       "(optimized block) always downsamples")


class Discriminator(nn.Module):
  """Scores (N,) float32 of images (N, C, H, W), channels_last.

  ``update_sn`` advances every SN layer's ``u`` once in this forward."""

  def __init__(self, cfg: DiscriminatorConfig, generator: torch.Generator):
    super().__init__()
    self.cfg = cfg
    sn = dict(sn_iters=cfg.sn_iters, fully_diff=cfg.fully_diff)
    self.block0 = B.DiscOptimizedBlock(cfg.input_channels, cfg.filters[0],
                                       generator, **sn)
    for i in range(1, len(cfg.filters)):
      self.add_module(f"block{i}", B.DiscResBlock(
          cfg.filters[i - 1], cfg.filters[i], generator,
          downsample=cfg.downsample[i], **sn))
    self.fc_out = L.SNDense(cfg.filters[-1], 1, generator, **sn)

  def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
    h = x.to(DTYPES[self.cfg.dtype])
    for i in range(len(self.cfg.filters)):
      h = getattr(self, f"block{i}")(h, update_sn)
    feat = L.global_sum_pool(F.relu(h)).float()
    return self.fc_out(feat, update_sn)[:, 0]


def preset_filters(resolution: int
                   ) -> Tuple[Tuple[int, ...], Tuple[bool, ...]]:
  """Per-dataset default D widths and per-block downsampling (ResNet)."""
  if resolution == 16:
    return (64, 128, 128), (True, True, False)
  if resolution == 32:
    return (128, 128, 128, 128), (True, True, False, False)
  return (64, 128, 256, 512, 1024), (True, True, True, True, False)
