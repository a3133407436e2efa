"""ResNet and DCGAN building blocks of the generator and the
discriminator.

Counterpart of ``wcgan_tpu/models/blocks.py``: the generator's res
up-block with WC layers (class labels passed through to its conditional
colorings) and its DCGAN up-block (norm/color, ReLU, 4x4 stride-2
transposed conv); the discriminator's res down-blocks with
spectral-normalized or plain convs and optional WC layers, and its DCGAN
block (4x4 stride-2 conv, LeakyReLU 0.1). Submodule names follow the flax
ones (``nc1``, ``conv1``, ``conv_sc``, ``nc``, ``deconv``, ...) so weights
map across by path (``wcgan_tpu_torch/weights.py``).

A discriminator block takes the spatial size of its input, ``size``: a
conv with ``conv_singular`` keeps an input-shaped power-iteration map.
Blocks with WC layers pass ``group`` (the reference's ``axis_name``) to
them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from wcgan_tpu_torch.models import layers as L
from wcgan_tpu_torch.parallel import mesh


def _disc_conv(in_channels: int, features: int, kernel_size: int,
               generator: torch.Generator, spectral: bool, sn_iters: int,
               fully_diff: bool, conv_singular: bool = False,
               size: Optional[int] = None, stride: int = 1) -> nn.Module:
  """The spectral/plain conv switch of the discriminator blocks, for an
  input of ``size`` x ``size``."""
  if spectral:
    return L.SNConv(in_channels, features, kernel_size, generator,
                    sn_iters=sn_iters, fully_diff=fully_diff, stride=stride,
                    conv_singular=conv_singular,
                    input_size=None if size is None else (size, size))
  return L.PlainConv(in_channels, features, kernel_size, generator, stride)


class GenResBlock(nn.Module):
  """norm->color->ReLU->(up)->conv x2, plus a shortcut that is upsampled
  and passed through a learned 1x1 conv whenever the block upsamples or
  changes channels (so every upsampling block has ``conv_sc``)."""

  def __init__(self, in_channels: int, filters: int,
               generator: torch.Generator, upsample: bool = True,
               norm: str = "d", coloring: str = "uconv", num_classes: int = 0,
               filters_emb: int = 10, ns_iters: int = 15,
               ns_method: str = "newton_schulz", momentum: float = 0.99,
               ns_scaling: str = "trace", use_kernel: Optional[bool] = None,
               kernel_eval: Optional[bool] = None, group: mesh.Group = None):
    super().__init__()
    self.upsample = upsample

    def norm_color(channels):
      return L.NormColor(channels, norm=norm, coloring=coloring,
                         momentum=momentum, ns_iters=ns_iters,
                         method=ns_method, ns_scaling=ns_scaling,
                         use_kernel=use_kernel, kernel_eval=kernel_eval,
                         num_classes=num_classes, filters_emb=filters_emb,
                         generator=generator, group=group)

    self.nc1 = norm_color(in_channels)
    self.conv1 = L.Conv(in_channels, filters, 3, generator)
    self.nc2 = norm_color(filters)
    self.conv2 = L.Conv(filters, filters, 3, generator)
    self.conv_sc = (L.Conv(in_channels, filters, 1, generator)
                    if upsample or in_channels != filters else None)

  def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
              train: bool = True, update_stats: bool = True) -> torch.Tensor:
    h = F.relu(self.nc1(x, labels, train, update_stats))
    if self.upsample:
      h = L.upsample_nearest(h)
    h = self.conv1(h)
    h = F.relu(self.nc2(h, labels, train, update_stats))
    h = self.conv2(h)
    sc = L.upsample_nearest(x) if self.upsample else x
    if self.conv_sc is not None:
      sc = self.conv_sc(sc)
    return h + sc


class DCGANGenBlock(nn.Module):
  """norm->color (``nc``)->ReLU->4x4 stride-2 transposed conv (``deconv``),
  the JAX package's ``DCGANGenBlock``: C x H x W -> filters x 2H x 2W."""

  def __init__(self, in_channels: int, filters: int,
               generator: torch.Generator, norm: str = "d",
               coloring: str = "uconv", num_classes: int = 0,
               filters_emb: int = 10, ns_iters: int = 15,
               ns_method: str = "newton_schulz", momentum: float = 0.99,
               ns_scaling: str = "trace", use_kernel: Optional[bool] = None,
               kernel_eval: Optional[bool] = None, group: mesh.Group = None):
    super().__init__()
    self.nc = L.NormColor(in_channels, norm=norm, coloring=coloring,
                          momentum=momentum, ns_iters=ns_iters,
                          method=ns_method, ns_scaling=ns_scaling,
                          use_kernel=use_kernel, kernel_eval=kernel_eval,
                          num_classes=num_classes, filters_emb=filters_emb,
                          generator=generator, group=group)
    self.deconv = L.ConvTranspose(in_channels, filters, generator)

  def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
              train: bool = True, update_stats: bool = True) -> torch.Tensor:
    return self.deconv(F.relu(self.nc(x, labels, train, update_stats)))


class DCGANDiscBlock(nn.Module):
  """4x4 stride-2 'SAME' conv (spectral-normalized unless ``spectral`` is
  off) -> LeakyReLU(0.1), the JAX package's ``DCGANDiscBlock``."""

  def __init__(self, in_channels: int, filters: int,
               generator: torch.Generator, size: Optional[int] = None,
               spectral: bool = True, sn_iters: int = 1,
               fully_diff: bool = False, conv_singular: bool = False):
    super().__init__()
    self.conv = _disc_conv(in_channels, filters, 4, generator, spectral,
                           sn_iters, fully_diff, conv_singular, size,
                           stride=2)

  def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
    return F.leaky_relu(self.conv(x, update_sn), negative_slope=0.1)


class DiscResBlock(nn.Module):
  """(WC)->ReLU->conv->(WC)->ReLU->conv->(down), plus a shortcut through a
  1x1 conv (then down) when the block downsamples or changes channels.
  The convs are spectral-normalized unless ``spectral`` is off; the WC
  layers ``nc1``/``nc2`` exist when a norm or coloring code is given
  (``--discriminator_norm`` / ``--discriminator_coloring``)."""

  def __init__(self, in_channels: int, filters: int,
               generator: torch.Generator, downsample: bool = True,
               spectral: bool = True, sn_iters: int = 1,
               fully_diff: bool = False, norm: str = "n", coloring: str = "n",
               num_classes: int = 0, filters_emb: int = 10,
               ns_iters: int = 15, ns_method: str = "newton_schulz",
               momentum: float = 0.99, ns_scaling: str = "trace",
               use_kernel: Optional[bool] = None,
               conv_singular: bool = False, size: Optional[int] = None,
               group: mesh.Group = None):
    super().__init__()
    self.downsample = downsample
    conv = dict(generator=generator, spectral=spectral, sn_iters=sn_iters,
                fully_diff=fully_diff, conv_singular=conv_singular,
                size=size)
    self.has_norm = norm != "n" or coloring != "n"

    def norm_color(channels):
      return L.NormColor(channels, norm=norm, coloring=coloring,
                         momentum=momentum, ns_iters=ns_iters,
                         method=ns_method, ns_scaling=ns_scaling,
                         use_kernel=use_kernel, num_classes=num_classes,
                         filters_emb=filters_emb, generator=generator,
                         group=group)

    if self.has_norm:
      self.nc1 = norm_color(in_channels)
    self.conv1 = _disc_conv(in_channels, filters, 3, **conv)
    if self.has_norm:
      self.nc2 = norm_color(filters)
    self.conv2 = _disc_conv(filters, filters, 3, **conv)
    self.conv_sc = (_disc_conv(in_channels, filters, 1, **conv)
                    if downsample or in_channels != filters else None)

  def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
              update_sn: bool = False,
              update_stats: bool = False) -> torch.Tensor:
    # D's WC layers always whiten with the batch statistics (train mode),
    # as the reference applies D.
    h = x
    if self.has_norm:
      h = self.nc1(h, labels, True, update_stats)
    h = self.conv1(F.relu(h), update_sn)
    if self.has_norm:
      h = self.nc2(h, labels, True, update_stats)
    h = self.conv2(F.relu(h), update_sn)
    if self.downsample:
      h = L.downsample_avg(h)
    sc = x
    if self.conv_sc is not None:
      sc = self.conv_sc(sc, update_sn)
      if self.downsample:
        sc = L.downsample_avg(sc)
    return h + sc


class DiscOptimizedBlock(nn.Module):
  """First D block on raw pixels: conv->ReLU->conv->down, shortcut
  down->1x1 conv (SN-GAN's optimized block, no pre-activation)."""

  def __init__(self, in_channels: int, filters: int,
               generator: torch.Generator, spectral: bool = True,
               sn_iters: int = 1, fully_diff: bool = False,
               conv_singular: bool = False, size: Optional[int] = None):
    super().__init__()
    conv = dict(generator=generator, spectral=spectral, sn_iters=sn_iters,
                fully_diff=fully_diff, conv_singular=conv_singular)
    self.conv1 = _disc_conv(in_channels, filters, 3, size=size, **conv)
    self.conv2 = _disc_conv(filters, filters, 3, size=size, **conv)
    # The shortcut's conv sees the downsampled image.
    self.conv_sc = _disc_conv(in_channels, filters, 1,
                              size=None if size is None else size // 2,
                              **conv)

  def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
    h = F.relu(self.conv1(x, update_sn))
    h = L.downsample_avg(self.conv2(h, update_sn))
    sc = self.conv_sc(L.downsample_avg(x), update_sn)
    return h + sc
