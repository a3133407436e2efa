"""The discriminator, ResNet or DCGAN: SN-GAN D, projection-D and the
AC-GAN head.

Counterpart of ``wcgan_tpu/models/discriminator.py``. ``arch='res'``:
down-blocks (spectral-normalized convs unless ``spectral`` is off, with
optional WC layers: ``norm``/``coloring``) -> ReLU -> global sum pool;
``'dcgan'``: 4x4 stride-2 convs with LeakyReLU -> the features flattened
in NHWC order. Then dense -> scalar score; with ``projection`` the score
gains the inner product of the features with a spectral-normalized class
embedding, and with ``ac_gan`` a dense head gives class logits.
``conv_singular`` normalizes each conv by the operator norm of the
convolution (``layers.SNConv``); ``remat`` recomputes the res blocks in
the backward and is a no-op for the DCGAN D, as in the reference.
``group`` (the reference's ``cfg.axis_name``) reaches D's WC layers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from wcgan_tpu_torch.models import blocks as B
from wcgan_tpu_torch.models import layers as L
from wcgan_tpu_torch.models.generator import DTYPES
from wcgan_tpu_torch.parallel import mesh


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
  """Static discriminator hyperparameters (the JAX package's; its
  ``axis_name`` is the module's ``group``)."""

  arch: str = "res"                    # 'res' | 'dcgan'
  resolution: int = 32
  input_channels: int = 3
  filters: Tuple[int, ...] = (128, 128, 128, 128)
  downsample: Tuple[bool, ...] = (True, True, False, False)
  spectral: bool = True                # --discriminator_spectral
  sn_iters: int = 1
  fully_diff: bool = False
  conv_singular: bool = False          # --conv_singular
  norm: str = "n"                      # --discriminator_norm
  coloring: str = "n"                  # --discriminator_coloring
  num_classes: int = 0
  filters_emb: int = 10
  projection: bool = False             # projection-D (gan_type PROJECTIVE)
  ac_gan: bool = False                 # AC-GAN auxiliary classifier head
  ns_iters: int = 15
  ns_method: str = "newton_schulz"
  wc_momentum: float = 0.99
  ns_scaling: str = "trace"
  dtype: str = "float32"
  use_kernel: Optional[bool] = None    # K1 for the WC layers' moments:
                                       # None = on CUDA
  remat: bool = False                  # recompute res blocks in backward

  def __post_init__(self):
    if self.arch not in ("res", "dcgan"):
      raise ValueError(f"discriminator arch must be 'res' or 'dcgan', got "
                       f"{self.arch!r}")
    if self.dtype not in DTYPES:
      raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                       f"{self.dtype!r}")
    if len(self.downsample) != len(self.filters):
      raise ValueError("downsample and filters must align per block")
    if self.arch == "res" and self.downsample and not self.downsample[0]:
      raise ValueError("downsample[0] must be True: the first res block "
                       "(optimized block) always downsamples")
    if self.arch == "dcgan" and (self.norm != "n" or self.coloring != "n"):
      # The DCGAN D has no place for norm or coloring layers; dropping
      # them unseen would run another experiment. remat is accepted: the
      # CLI shares one --remat with G, and the DCGAN D has nothing to
      # recompute.
      raise ValueError("discriminator norm/coloring are not supported "
                       "for the dcgan arch")


class Discriminator(nn.Module):
  """(scores (N,) float32, class logits (N, num_classes) float32 or None)
  of images (N, C, H, W), channels_last, and labels (N,) for projection-D
  or conditional colorings.

  ``update_sn`` advances every SN layer's ``u`` once in this forward,
  ``update_stats`` the running statistics of its WC layers."""

  def __init__(self, cfg: DiscriminatorConfig, generator: torch.Generator,
               group: mesh.Group = None):
    super().__init__()
    self.cfg = cfg
    conv = dict(spectral=cfg.spectral, sn_iters=cfg.sn_iters,
                fully_diff=cfg.fully_diff, conv_singular=cfg.conv_singular)
    size = cfg.resolution
    if cfg.arch == "dcgan":
      in_ch = cfg.input_channels
      for i, f in enumerate(cfg.filters):
        self.add_module(f"block{i}", B.DCGANDiscBlock(
            in_ch, f, generator, size=size, **conv))
        in_ch, size = f, -(-size // 2)     # 'SAME' stride 2: ceil
      feat = size * size * in_ch
    else:
      self.block0 = B.DiscOptimizedBlock(cfg.input_channels, cfg.filters[0],
                                         generator, size=size, **conv)
      size //= 2
      for i in range(1, len(cfg.filters)):
        self.add_module(f"block{i}", B.DiscResBlock(
            cfg.filters[i - 1], cfg.filters[i], generator,
            downsample=cfg.downsample[i], norm=cfg.norm,
            coloring=cfg.coloring, num_classes=cfg.num_classes,
            filters_emb=cfg.filters_emb, ns_iters=cfg.ns_iters,
            ns_method=cfg.ns_method, momentum=cfg.wc_momentum,
            ns_scaling=cfg.ns_scaling, use_kernel=cfg.use_kernel,
            size=size, group=group, **conv))
        size //= 2 if cfg.downsample[i] else 1
      feat = cfg.filters[-1]
    sn = dict(sn_iters=cfg.sn_iters, fully_diff=cfg.fully_diff)

    def dense(features):
      if cfg.spectral:
        return L.SNDense(feat, features, generator, **sn)
      return L.PlainDense(feat, features, generator)

    self.fc_out = dense(1)
    if cfg.projection:
      self.proj_emb = L.SNEmbed(cfg.num_classes, feat, generator, **sn)
    if cfg.ac_gan:
      self.fc_cls = dense(cfg.num_classes)
    for name, m in self.named_modules():
      if isinstance(m, L.NormColor):
        m.layer_name = name

  def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
              update_sn: bool = False, update_stats: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    cfg = self.cfg
    h = x.to(DTYPES[cfg.dtype])
    if cfg.arch == "dcgan":
      for i in range(len(cfg.filters)):
        h = getattr(self, f"block{i}")(h, update_sn)
      # The reference flattens NHWC activations; these are NCHW views of
      # NHWC memory, so the NHWC order is a permute away (and a free view).
      feat = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1).float()
    else:
      h = self.block0(h, update_sn)
      for i in range(1, len(cfg.filters)):
        block = getattr(self, f"block{i}")
        if cfg.remat:
          h = L.remat_call(block, (h, labels),
                           dict(update_sn=update_sn,
                                update_stats=update_stats),
                           dict(update_sn=False, update_stats=False))
        else:
          h = block(h, labels, update_sn, update_stats)
      feat = L.global_sum_pool(F.relu(h)).float()
    score = self.fc_out(feat, update_sn)[:, 0]
    if cfg.projection:
      if labels is None:
        raise ValueError("projection discriminator needs labels")
      emb = self.proj_emb(labels, update_sn)
      score = score + torch.sum(emb.float() * feat, dim=-1)
    class_logits = self.fc_cls(feat, update_sn) if cfg.ac_gan else None
    return score, class_logits


def preset_filters(arch: str, resolution: int
                   ) -> Tuple[Tuple[int, ...], Tuple[bool, ...]]:
  """Per-dataset default D widths and per-block downsampling."""
  if arch == "dcgan":
    f = {16: (64, 128), 32: (64, 128, 256), 48: (64, 128, 256),
         64: (64, 128, 256, 512)}[resolution]
    return f, tuple(True for _ in f)
  if resolution == 16:
    return (64, 128, 128), (True, True, False)
  if resolution == 32:
    return (128, 128, 128, 128), (True, True, False, False)
  return (64, 128, 256, 512, 1024), (True, True, True, True, False)
