"""PyTorch layers: the WC layers, SN conv/dense, plain conv/dense.

Counterpart of ``wcgan_tpu/models/layers.py``. Activations are NCHW tensors
in channels_last memory format, which is NHWC in memory: a WC layer's
(N*H*W, C) row matrix is then a free view (``_rows`` checks it), as
``x.reshape(-1, c)`` is on the reference's NHWC arrays.

State the reference keeps in flax collections is kept in buffers here:
``wc_stats`` mean/cov in ``NormColor`` or ``DecorrelationNorm``,
``spectral`` ``u`` in the SN wrappers. Parameters stay float32; each layer
casts them to the activation dtype where it uses them, as flax's ``dtype=``
does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

from wcgan_tpu_torch.ops import coloring as coloring_ops
from wcgan_tpu_torch.ops import cuda_wc
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


# Conditional coloring codes of the JAX package; not ported yet.
_COND_CODES = ("cconv", "ucconv", "ccs", "ucs", "cconv-sa", "ucconv-sa")


def _kernel_eval_ok(kernel_eval: Optional[bool], method: str) -> bool:
  """Gate of K2 (``cuda_wc.whiten_color_apply``) on the stats-given eval
  paths; the JAX package's ``_pallas_eval_ok``. None or False picks the
  split path (W first, then one row pass), the default as in the JAX
  package; True forces K2. Forced with ``method='cholesky'`` it raises:
  K2 has no Cholesky solve, and a silent split path would be measured as
  the kernel."""
  if kernel_eval:
    if method != "newton_schulz":
      raise ValueError(
          f"kernel_eval=True requires method='newton_schulz' (got "
          f"{method!r}); the whiten_color_apply kernel has no Cholesky "
          "phase")
    return True
  return False


# Receives a train-mode whitening layer's batch (mean, cov), float32.
MomentsSink = Callable[[torch.Tensor, torch.Tensor], None]


class DecorrelationNorm(nn.Module):
  """Full-covariance whitening, the W half of the WC transform; the JAX
  package's ``DecorrelationNorm``. Mode 'd' whitens with the batch
  statistics, 'dr' with the running ones (buffers ``mean``, ``cov``),
  which advance from the batch in train mode when ``update_stats`` is set.
  Eval mode whitens with the running statistics: through K2 with
  Gamma = I, beta = 0 when ``kernel_eval`` forces it, else the split
  path."""

  def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5,
               ns_iters: int = 15, mode: str = "d",
               method: str = "newton_schulz", ns_scaling: str = "trace",
               use_kernel: Optional[bool] = None,
               kernel_eval: Optional[bool] = None):
    super().__init__()
    if mode not in ("d", "dr"):
      raise ValueError(f"unknown whitening mode {mode!r}")
    self.momentum = momentum
    self.eps = eps
    self.ns_iters = ns_iters
    self.mode = mode
    self.method = method
    self.ns_scaling = ns_scaling
    self.use_kernel = use_kernel
    self.kernel_eval = kernel_eval
    self.moments_sink: Optional[MomentsSink] = None
    self.register_buffer("mean", torch.zeros(channels))
    self.register_buffer("cov", torch.eye(channels))

  def forward(self, x: torch.Tensor, train: bool = True,
              update_stats: bool = True) -> torch.Tensor:
    x2d = _rows(x)
    wc = dict(eps=self.eps, num_iters=self.ns_iters, method=self.method,
              scaling=self.ns_scaling)
    if not train:
      if _kernel_eval_ok(self.kernel_eval, self.method):
        c = x2d.shape[1]
        out = cuda_wc.whiten_color_apply(
            x2d, self.mean, self.cov,
            torch.eye(c, dtype=torch.float32, device=x.device),
            torch.zeros(c, dtype=torch.float32, device=x.device),
            ns_iters=self.ns_iters, eps=self.eps, scaling=self.ns_scaling)
      else:
        out = whiten_ops.whiten_eval(x2d, self.mean, self.cov, **wc)
      return _unrows(out, x)
    batch_mean, batch_cov = whiten_ops.batch_moments(x2d, self.use_kernel)
    if self.moments_sink is not None:
      self.moments_sink(batch_mean, batch_cov)
    mean, stat_src, new_mean, new_cov = whiten_ops.stats_select_and_ema(
        batch_mean, batch_cov, self.mean, self.cov,
        use_batch=self.mode == "d", momentum=self.momentum)
    out = whiten_ops.whiten_apply(x2d, mean, whiten_ops.inv_sqrt(stat_src,
                                                                 **wc))
    if update_stats:
      self.mean = new_mean.detach()
      self.cov = new_cov.detach()
    return _unrows(out, x)


class NormLayer(nn.Module):
  """Dispatch on the norm code: 'n' (identity) or 'd'/'dr' (whitening, in
  submodule ``wc``). BatchNorm 'b' is not ported: flax's momentum and
  variance conventions differ from torch's, so it waits for the DCGAN
  slice."""

  def __init__(self, channels: int, code: str = "d", **wc):
    super().__init__()
    if code == "b":
      raise NotImplementedError(
          "norm code 'b' (BatchNorm) is not ported yet")
    if code not in ("n", "d", "dr"):
      raise ValueError(f"unknown norm code {code!r}")
    self.code = code
    if code != "n":
      self.wc = DecorrelationNorm(channels, mode=code, **wc)

  def forward(self, x: torch.Tensor, train: bool = True,
              update_stats: bool = True) -> torch.Tensor:
    if self.code == "n":
      return x
    return self.wc(x, train, update_stats)


class Coloring(nn.Module):
  """Unconditional coloring behind its code: 'n' (identity), 's'
  (diagonal scale-shift ``gamma``, ``beta``) or 'uconv' (1x1 conv
  ``gamma_a`` (C, C) from the identity, ``beta_a``). The conditional codes
  are not ported yet."""

  def __init__(self, channels: int, code: str = "uconv"):
    super().__init__()
    if code in _COND_CODES:
      raise NotImplementedError(
          f"conditional coloring {code!r} is not ported yet")
    self.code = code
    if code == "s":
      self.gamma = nn.Parameter(torch.ones(channels))
      self.beta = nn.Parameter(torch.zeros(channels))
    elif code == "uconv":
      self.gamma_a = nn.Parameter(torch.eye(channels))
      self.beta_a = nn.Parameter(torch.zeros(channels))
    elif code != "n":
      raise ValueError(f"unknown coloring code {code!r}")

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.code == "n":
      return x
    x2d = _rows(x)
    if self.code == "s":
      out = coloring_ops.center_scale(x2d, self.gamma, self.beta)
    else:
      out = coloring_ops.color_uncond(x2d, self.gamma_a, self.beta_a)
    return _unrows(out, x)


class NormColor(nn.Module):
  """The WC block: a norm code {'n', 'd', 'dr'} and a coloring code
  {'n', 's', 'uconv'}, the JAX package's ``NormColor``.

  Whitening with 'uconv' coloring is fused (``_fused_wc_uconv``): W and
  Gamma fold into one C x C matrix M = Gamma W (float32) with bias
  beta - mu M^T, so the rows see a single matmul in the activation dtype:
  out = x M^T + bias. Gamma starts at the identity. 'd' whitens with the
  batch statistics, 'dr' with the running ones (buffers ``mean``,
  ``cov``), which advance from the batch in train mode when
  ``update_stats`` is set. In eval mode ``kernel_eval=True`` runs the
  whole layer through K2. Every other pair of codes runs the general path:
  ``NormLayer`` (submodule ``norm``), then ``Coloring`` (``color``)."""

  def __init__(self, channels: int, norm: str = "d", coloring: str = "uconv",
               momentum: float = 0.99, eps: float = 1e-5, ns_iters: int = 15,
               method: str = "newton_schulz", ns_scaling: str = "trace",
               use_kernel: Optional[bool] = None,
               kernel_eval: Optional[bool] = None):
    super().__init__()
    if norm in ("d", "dr") and coloring in _COND_CODES:
      raise NotImplementedError(
          f"NormColor(norm={norm!r}, coloring={coloring!r}): conditional "
          "coloring is not ported yet")
    self.fused = norm in ("d", "dr") and coloring == "uconv"
    self.norm_code = norm
    self.momentum = momentum
    self.eps = eps
    self.ns_iters = ns_iters
    self.method = method
    self.ns_scaling = ns_scaling
    self.use_kernel = use_kernel
    self.kernel_eval = kernel_eval
    self.moments_sink: Optional[MomentsSink] = None
    if self.fused:
      self.gamma = nn.Parameter(torch.eye(channels))
      self.beta = nn.Parameter(torch.zeros(channels))
      self.register_buffer("mean", torch.zeros(channels))
      self.register_buffer("cov", torch.eye(channels))
    else:
      self.norm = NormLayer(channels, norm, momentum=momentum, eps=eps,
                            ns_iters=ns_iters, method=method,
                            ns_scaling=ns_scaling, use_kernel=use_kernel,
                            kernel_eval=kernel_eval)
      self.color = Coloring(channels, coloring)

  def _wc_stats(self, x2d: torch.Tensor, train: bool, update_stats: bool):
    """(mean, stat_src) per the 'd'/'dr' contract, after advancing the
    running statistics when ``update_stats``."""
    if not train:
      return self.mean, self.cov
    batch_mean, batch_cov = whiten_ops.batch_moments(x2d, self.use_kernel)
    if self.moments_sink is not None:
      self.moments_sink(batch_mean, batch_cov)
    mean, stat_src, new_mean, new_cov = whiten_ops.stats_select_and_ema(
        batch_mean, batch_cov, self.mean, self.cov,
        use_batch=self.norm_code == "d", momentum=self.momentum)
    if update_stats:
      # Rebinding (not copy_) leaves the old tensors, which 'dr' feeds into
      # the graph, unmodified for backward.
      self.mean = new_mean.detach()
      self.cov = new_cov.detach()
    return mean, stat_src

  def forward(self, x: torch.Tensor, train: bool = True,
              update_stats: bool = True) -> torch.Tensor:
    if not self.fused:
      return self.color(self.norm(x, train, update_stats))
    return self._fused_wc_uconv(x, train, update_stats)

  def _fused_wc_uconv(self, x: torch.Tensor, train: bool,
                      update_stats: bool) -> torch.Tensor:
    x2d = _rows(x)
    mean, stat_src = self._wc_stats(x2d, train, update_stats)
    if not train and _kernel_eval_ok(self.kernel_eval, self.method):
      out = cuda_wc.whiten_color_apply(
          x2d, mean, stat_src, self.gamma, self.beta, ns_iters=self.ns_iters,
          eps=self.eps, scaling=self.ns_scaling)
      return _unrows(out, x)
    w = whiten_ops.inv_sqrt(stat_src, num_iters=self.ns_iters, eps=self.eps,
                            method=self.method, scaling=self.ns_scaling)
    m = self.gamma @ w                                  # (C, C) fold, f32
    bias = self.beta - mean @ m.T
    out = x2d @ m.T.to(x.dtype) + bias.to(x.dtype)
    return _unrows(out, x)


@contextlib.contextmanager
def capture_batch_moments(model: nn.Module
                          ) -> Iterator[Dict[str, torch.Tensor]]:
  """Inside the block, each train-mode forward of a whitening layer of
  ``model`` records its batch moments into the yielded dict, keyed like the
  layer's running-statistics buffers (``<layer>.mean``, ``<layer>.cov``);
  a later forward overwrites an earlier one. The moments come straight
  from the batch, not from the running statistics' update, so they are
  exact whatever the momentum, and they are seen even where the buffers
  are not rebound (``update_stats=False``, ``torch.func.functional_call``).
  """
  out: Dict[str, torch.Tensor] = {}
  layers = [(name, m) for name, m in model.named_modules()
            if isinstance(m, (DecorrelationNorm, NormColor))
            and "mean" in m._buffers]

  def sink(prefix: str) -> MomentsSink:
    def record(mean: torch.Tensor, cov: torch.Tensor) -> None:
      out[f"{prefix}.mean"] = mean.detach()
      out[f"{prefix}.cov"] = cov.detach()
    return record

  for name, m in layers:
    m.moments_sink = sink(name)
  try:
    yield out
  finally:
    for _, m in layers:
      m.moments_sink = None


def _add_bias(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
  """y + bias over the channel dim (dim 1), after the product has been
  rounded to y's dtype: flax adds the bias as a second step, so in
  bfloat16 a bias fused into the conv or matmul rounds elsewhere (up to a
  bf16 ulp of the product; ROADMAP queue 3)."""
  shape = (1, -1) + (1,) * (y.dim() - 2)
  return y + bias.to(y.dtype).view(shape)


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
    return _add_bias(self._conv_forward(x, self.weight.to(x.dtype), None),
                     self.bias)


class Dense(nn.Linear):
  """Dense layer computing in the input's dtype, flax default init."""

  def __init__(self, in_features: int, features: int,
               generator: torch.Generator):
    super().__init__(in_features, features)
    lecun_normal_(self.weight.data, in_features, generator)
    nn.init.zeros_(self.bias)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return _add_bias(F.linear(x, self.weight.to(x.dtype)), self.bias)


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
    return _add_bias(F.conv2d(x, w_bar.to(x.dtype), padding=self.padding),
                     self.bias)


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
    return _add_bias(F.linear(x, w_bar.to(x.dtype)), self.bias)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
  """Nearest-neighbour upsample of (N, C, H, W), layout kept."""
  return F.interpolate(x, scale_factor=factor, mode="nearest")


def downsample_avg(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
  """``factor`` x ``factor`` average pool (the reference's down-resample)."""
  return F.avg_pool2d(x, factor)


def global_sum_pool(x: torch.Tensor) -> torch.Tensor:
  """Sum over H, W: (N, C, H, W) -> (N, C)."""
  return torch.sum(x, dim=(2, 3))
