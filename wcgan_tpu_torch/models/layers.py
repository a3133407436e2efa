"""PyTorch layers: the fused WC layer, SN conv/dense, plain conv/dense.

Counterpart of ``wcgan_tpu/models/layers.py``. Activations are NCHW tensors
in channels_last memory format, which is NHWC in memory: a WC layer's
(N*H*W, C) row matrix is then a free view (``_rows`` checks it), as
``x.reshape(-1, c)`` is on the reference's NHWC arrays.

State the reference keeps in flax collections is kept in buffers here:
``wc_stats`` mean/cov in ``NormColor``, ``spectral`` ``u`` in the SN
wrappers. Parameters stay float32; each layer casts them to the activation
dtype where it uses them, as flax's ``dtype=`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from wcgan_tpu_torch.ops import sn as sn_ops
from wcgan_tpu_torch.ops import whiten as whiten_ops


def _rows(x: torch.Tensor) -> torch.Tensor:
  """(N, C, H, W) channels_last -> its (N*H*W, C) rows, without a copy
  (``view`` raises if the layout would need one)."""
  return x.permute(0, 2, 3, 1).view(-1, x.shape[1])


def _unrows(x2d: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
  """Inverse of ``_rows``: rows back to (N, C, H, W) channels_last."""
  n, c, h, w = like.shape
  return x2d.view(n, h, w, c).permute(0, 3, 1, 2)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
  """flax's default kernel init: truncated normal (+-2 std), variance
  1/fan_in after truncation."""
  std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
  return nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                               generator=generator)


def glorot_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator) -> torch.Tensor:
  """flax's glorot_uniform (the SN wrappers' kernel init)."""
  limit = math.sqrt(6.0 / (fan_in + fan_out))
  return nn.init.uniform_(t, -limit, limit, generator=generator)


class NormColor(nn.Module):
  """The WC layer for norm 'd'/'dr' with unconditional 1x1 coloring
  ('uconv'), the reference's ``NormColor._fused_wc_uconv``.

  Whitening W and coloring Gamma fold into one C x C matrix M = Gamma W
  (float32), with bias beta - mu M^T, so the rows see a single matmul in
  the activation dtype: out = x M^T + bias. Gamma starts at the identity.
  'd' whitens with the batch statistics, 'dr' with the running ones; the
  running statistics (buffers ``mean``, ``cov``) advance from the batch in
  train mode when ``update_stats`` is set."""

  def __init__(self, channels: int, norm: str = "d", coloring: str = "uconv",
               momentum: float = 0.99, eps: float = 1e-5, ns_iters: int = 15,
               ns_scaling: str = "trace", use_kernel: Optional[bool] = None):
    super().__init__()
    if norm not in ("d", "dr") or coloring != "uconv":
      raise NotImplementedError(
          f"NormColor(norm={norm!r}, coloring={coloring!r}): only norm "
          "'d'/'dr' with coloring 'uconv' is ported")
    self.norm = norm
    self.momentum = momentum
    self.eps = eps
    self.ns_iters = ns_iters
    self.ns_scaling = ns_scaling
    self.use_kernel = use_kernel
    self.gamma = nn.Parameter(torch.eye(channels))
    self.beta = nn.Parameter(torch.zeros(channels))
    self.register_buffer("mean", torch.zeros(channels))
    self.register_buffer("cov", torch.eye(channels))

  def _wc_stats(self, x2d: torch.Tensor, train: bool, update_stats: bool):
    """(mean, stat_src) per the 'd'/'dr' contract, after advancing the
    running statistics when ``update_stats``."""
    if not train:
      return self.mean, self.cov
    batch_mean, batch_cov = whiten_ops.batch_moments(x2d, self.use_kernel)
    mean, stat_src, new_mean, new_cov = whiten_ops.stats_select_and_ema(
        batch_mean, batch_cov, self.mean, self.cov,
        use_batch=self.norm == "d", momentum=self.momentum)
    if update_stats:
      # Rebinding (not copy_) leaves the old tensors, which 'dr' feeds into
      # the graph, unmodified for backward.
      self.mean = new_mean.detach()
      self.cov = new_cov.detach()
    return mean, stat_src

  def forward(self, x: torch.Tensor, train: bool = True,
              update_stats: bool = True) -> torch.Tensor:
    x2d = _rows(x)
    mean, stat_src = self._wc_stats(x2d, train, update_stats)
    w = whiten_ops.newton_schulz_inv_sqrt(
        stat_src, num_iters=self.ns_iters, eps=self.eps,
        scaling=self.ns_scaling)
    m = self.gamma @ w                                  # (C, C) fold, f32
    bias = self.beta - mean @ m.T
    out = x2d @ m.T.to(x.dtype) + bias.to(x.dtype)
    return _unrows(out, x)


class Conv(nn.Conv2d):
  """'SAME'-padded conv (odd kernels) computing in the input's dtype, with
  flax's default init (lecun_normal kernel, zero bias)."""

  def __init__(self, in_channels: int, features: int, kernel_size: int,
               generator: torch.Generator):
    super().__init__(in_channels, features, kernel_size,
                     padding=kernel_size // 2)
    lecun_normal_(self.weight.data, in_channels * kernel_size ** 2,
                  generator)
    nn.init.zeros_(self.bias)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self._conv_forward(x, self.weight.to(x.dtype),
                              self.bias.to(x.dtype))


class Dense(nn.Linear):
  """Dense layer computing in the input's dtype, flax default init."""

  def __init__(self, in_features: int, features: int,
               generator: torch.Generator):
    super().__init__(in_features, features)
    lecun_normal_(self.weight.data, in_features, generator)
    nn.init.zeros_(self.bias)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class SNConv(nn.Module):
  """'SAME'-padded 2-D conv with a spectral-normalized kernel; ``u``
  advances only when ``update_sn`` is set (the reference's ``SNConv``
  without ``conv_singular``)."""

  def __init__(self, in_channels: int, features: int, kernel_size: int,
               generator: torch.Generator, sn_iters: int = 1,
               fully_diff: bool = False):
    super().__init__()
    self.padding = kernel_size // 2
    self.sn_iters = sn_iters
    self.fully_diff = fully_diff
    self.weight = nn.Parameter(glorot_uniform_(
        torch.empty(features, in_channels, kernel_size, kernel_size),
        in_channels * kernel_size ** 2, features * kernel_size ** 2,
        generator))
    self.bias = nn.Parameter(torch.zeros(features))
    self.register_buffer("u", torch.randn(features, generator=generator))

  def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
    w_bar, u_new = sn_ops.spectral_normalize(
        self.weight, self.u, n_iters=self.sn_iters,
        fully_diff=self.fully_diff)
    if update_sn:
      self.u = u_new.detach()
    return F.conv2d(x, w_bar.to(x.dtype), self.bias.to(x.dtype),
                    padding=self.padding)


class SNDense(nn.Module):
  """Dense layer with a spectral-normalized (out, in) weight."""

  def __init__(self, in_features: int, features: int,
               generator: torch.Generator, sn_iters: int = 1,
               fully_diff: bool = False):
    super().__init__()
    self.sn_iters = sn_iters
    self.fully_diff = fully_diff
    self.weight = nn.Parameter(glorot_uniform_(
        torch.empty(features, in_features), in_features, features,
        generator))
    self.bias = nn.Parameter(torch.zeros(features))
    self.register_buffer("u", torch.randn(features, generator=generator))

  def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
    w_bar, u_new = sn_ops.spectral_normalize(
        self.weight, self.u, n_iters=self.sn_iters,
        fully_diff=self.fully_diff)
    if update_sn:
      self.u = u_new.detach()
    return F.linear(x, w_bar.to(x.dtype), self.bias.to(x.dtype))


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
  """Nearest-neighbour upsample of (N, C, H, W), layout kept."""
  return F.interpolate(x, scale_factor=factor, mode="nearest")


def downsample_avg(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
  """``factor`` x ``factor`` average pool (the reference's down-resample)."""
  return F.avg_pool2d(x, factor)


def global_sum_pool(x: torch.Tensor) -> torch.Tensor:
  """Sum over H, W: (N, C, H, W) -> (N, C)."""
  return torch.sum(x, dim=(2, 3))
