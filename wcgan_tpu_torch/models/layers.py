"""PyTorch layers: the WC layers, BatchNorm, SN conv/dense, plain
conv/dense/transposed conv.

Counterpart of ``wcgan_tpu/models/layers.py``. Activations are NCHW tensors
in channels_last memory format, which is NHWC in memory: a WC layer's
(N*H*W, C) row matrix is then a free view (``_rows`` checks it), as
``x.reshape(-1, c)`` is on the reference's NHWC arrays.

State the reference keeps in flax collections is kept in buffers here:
``wc_stats`` mean/cov in ``NormColor`` or ``DecorrelationNorm``,
``batch_stats`` mean/var in ``BatchNorm``, ``spectral`` ``u`` (``u_map``
with ``conv_singular``) in the SN wrappers. Parameters stay float32; each layer
casts them to the activation dtype where it uses them, as flax's ``dtype=``
does.

Every statistics and SN buffer advances in place (``_advance``): a buffer
keeps its identity and address for the life of the module, which a step
captured as a CUDA graph (``train/step.py::make_jit_step``) needs, since a
replay reads and writes the addresses it was captured on. Where autograd
would save a buffer that a later pass of the same update advances before
the backward runs (the running statistics 'dr' whitens with, ``u`` under
``fully_diff``, the buffers a ``remat`` recomputation reads), the pass
reads a copy, so the backward sees the values its forward saw.

The layers with batch statistics (``DecorrelationNorm``, ``BatchNorm``,
``NormLayer``, ``NormColor``) take ``group``, the reference's
``axis_name``: a process group over which their train-mode statistics are
those of the global batch, or None for one process. Nothing reduces at
construction.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from wcgan_tpu_torch import trace
from wcgan_tpu_torch.ops import coloring as coloring_ops
from wcgan_tpu_torch.ops import cuda_wc
from wcgan_tpu_torch.ops import sn as sn_ops
from wcgan_tpu_torch.ops import whiten as whiten_ops
from wcgan_tpu_torch.parallel import mesh


def _rows(x: torch.Tensor) -> torch.Tensor:
  """(N, C, H, W) channels_last -> its (N*H*W, C) rows, without a copy
  (``view`` raises if the layout would need one)."""
  return x.permute(0, 2, 3, 1).view(-1, x.shape[1])


def _advance(buffer: torch.Tensor, new: torch.Tensor) -> None:
  """Write ``new`` into ``buffer`` in place, outside autograd. The write
  bumps the buffer's version, so a backward that saved the old values
  raises rather than reading the new ones."""
  with torch.no_grad():
    buffer.copy_(new)


def _saved(t: torch.Tensor) -> torch.Tensor:
  """``t`` as a pass that autograd may save reads it: a copy while grad
  is on (a later pass may advance ``t`` before the backward), else ``t``."""
  return t.clone() if torch.is_grad_enabled() else t


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


COLORING_CODES = ("n", "s", "ccs", "ucs", "uconv", "cconv", "ucconv",
                  "cconv-sa", "ucconv-sa")
# The conditional 1x1-conv codes that NormColor fuses with whitening.
_FUSED_COND_CODES = ("cconv", "ucconv", "cconv-sa", "ucconv-sa")


def _as_nsc(x2d: torch.Tensor, n: int) -> torch.Tensor:
  """(N*S, C) rows -> (N, S, C): the per-image row blocks of the
  conditional colorings (a view)."""
  return x2d.view(n, -1, x2d.shape[-1])


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


# Receives a train-mode normalization layer's batch statistics, float32:
# (mean, cov) of a whitening layer, (mean, var) of a BatchNorm.
MomentsSink = Callable[[torch.Tensor, torch.Tensor], None]


class DecorrelationNorm(nn.Module):
  """Full-covariance whitening, the W half of the WC transform; the JAX
  package's ``DecorrelationNorm``. Mode 'd' whitens with the batch
  statistics, 'dr' with the running ones (buffers ``mean``, ``cov``),
  which advance from the batch in train mode when ``update_stats`` is set.
  Eval mode whitens with the running statistics: through K2 with
  Gamma = I, beta = 0 when ``kernel_eval`` forces it, else the split
  path."""

  STAT_NAMES = ("mean", "cov")

  def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5,
               ns_iters: int = 15, mode: str = "d",
               method: str = "newton_schulz", ns_scaling: str = "trace",
               use_kernel: Optional[bool] = None,
               kernel_eval: Optional[bool] = None, group: mesh.Group = None):
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
    self.group = group
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
    batch_mean, batch_cov = whiten_ops.batch_moments(x2d, self.use_kernel,
                                                     self.group)
    if self.moments_sink is not None:
      self.moments_sink(batch_mean, batch_cov)
    running = (self.mean, self.cov)
    if self.mode == "dr":            # whitens with them: backward reads them
      running = tuple(_saved(t) for t in running)
    mean, stat_src, new_mean, new_cov = whiten_ops.stats_select_and_ema(
        batch_mean, batch_cov, *running, use_batch=self.mode == "d",
        momentum=self.momentum)
    out = whiten_ops.whiten_apply(x2d, mean, whiten_ops.inv_sqrt(stat_src,
                                                                 **wc))
    if update_stats:
      _advance(self.mean, new_mean)
      _advance(self.cov, new_cov)
    return _unrows(out, x)


class BatchNorm(nn.Module):
  """Affine-less BatchNorm, flax's ``nn.BatchNorm(use_scale=False,
  use_bias=False)`` as the JAX package's ``NormLayer`` 'b' builds it, with
  flax's conventions rather than ``nn.BatchNorm2d``'s:

  - the batch variance is the biased one, E[x^2] - E[x]^2 clipped at 0
    (flax's ``use_fast_variance``), in float32; it normalizes the batch
    and is what the buffer ``var`` averages. With a ``group``, E[x] and
    E[x^2] are means over the ranks (one all-reduce of both, as flax
    reduces them over ``axis_name``);
  - the running statistics advance as ra = m ra + (1 - m) batch, m the
    momentum (torch's ``momentum`` is 1 - m), and only in train mode with
    ``update_stats`` set.

  Train mode normalizes with the batch statistics, eval mode with the
  running ones (buffers ``mean``, ``var``); the output has the input's
  dtype."""

  STAT_NAMES = ("mean", "var")

  def __init__(self, channels: int, momentum: float = 0.99,
               eps: float = 1e-5, group: mesh.Group = None):
    super().__init__()
    self.momentum = momentum
    self.eps = eps
    self.group = group
    self.moments_sink: Optional[MomentsSink] = None
    self.register_buffer("mean", torch.zeros(channels))
    self.register_buffer("var", torch.ones(channels))

  def forward(self, x: torch.Tensor, train: bool = True,
              update_stats: bool = True) -> torch.Tensor:
    x2d = _rows(x).float()
    if train:
      mean = x2d.mean(dim=0)
      mean2 = (x2d * x2d).mean(dim=0)
      if self.group is not None:
        mean, mean2 = mesh.pmean(torch.cat([mean, mean2]),
                                 self.group).chunk(2)
      var = torch.clamp(mean2 - mean * mean, min=0.0)
      if self.moments_sink is not None:
        self.moments_sink(mean, var)
      if update_stats:
        m = self.momentum
        _advance(self.mean, m * self.mean + (1 - m) * mean)
        _advance(self.var, m * self.var + (1 - m) * var)
    else:
      mean, var = self.mean, self.var
    out = (x2d - mean) * torch.rsqrt(var + self.eps)
    return _unrows(out.to(x.dtype), x)


class NormLayer(nn.Module):
  """Dispatch on the norm code: 'n' (identity), 'b' (affine-less
  BatchNorm, submodule ``bn``) or 'd'/'dr' (whitening, submodule ``wc``),
  the JAX package's ``NormLayer``."""

  def __init__(self, channels: int, code: str = "d", momentum: float = 0.99,
               eps: float = 1e-5, group: mesh.Group = None, **wc):
    super().__init__()
    if code not in ("n", "b", "d", "dr"):
      raise ValueError(f"unknown norm code {code!r}")
    self.code = code
    if code == "b":
      self.bn = BatchNorm(channels, momentum=momentum, eps=eps, group=group)
    elif code != "n":
      self.wc = DecorrelationNorm(channels, mode=code, momentum=momentum,
                                  eps=eps, group=group, **wc)

  def forward(self, x: torch.Tensor, train: bool = True,
              update_stats: bool = True) -> torch.Tensor:
    if self.code == "n":
      return x
    if self.code == "b":
      return self.bn(x, train, update_stats)
    return self.wc(x, train, update_stats)


def _normal_(shape, std: float, generator: torch.Generator) -> torch.Tensor:
  return torch.randn(shape, generator=generator) * std


def _conditional_params(module: nn.Module, code: str, channels: int,
                        num_classes: int, filters_emb: int,
                        generator: Optional[torch.Generator]) -> None:
  """The parameters of a conditional 1x1-conv code on ``module``, with the
  JAX package's names and inits: the class-agnostic ``gamma_a`` (identity)
  and ``beta_a`` for 'ucconv'/'ucconv-sa'; per-class filters ``gamma_c``
  (normal, std 0.02) or, for '-sa', K = ``filters_emb`` basis filters
  ``basis`` (normal, std 0.02) with the class weights ``embedding`` (ones);
  the per-class bias ``beta_c`` (zeros)."""
  if num_classes <= 0:
    raise ValueError(f"conditional coloring {code!r} requires num_classes "
                     "> 0")
  gen = generator if generator is not None else torch.Generator()
  if code in ("ucconv", "ucconv-sa"):
    module.gamma_a = nn.Parameter(torch.eye(channels))
    module.beta_a = nn.Parameter(torch.zeros(channels))
  if code in ("cconv", "ucconv"):
    module.gamma_c = nn.Parameter(
        _normal_((num_classes, channels, channels), 0.02, gen))
  else:
    module.basis = nn.Parameter(
        _normal_((filters_emb, channels, channels), 0.02, gen))
    module.embedding = nn.Parameter(torch.ones(num_classes, filters_emb))
  module.beta_c = nn.Parameter(torch.zeros(num_classes, channels))


def _need_labels(code: str, labels: Optional[torch.Tensor]) -> torch.Tensor:
  if labels is None:
    raise ValueError(f"coloring code {code!r} requires labels")
  return labels.long()


class Coloring(nn.Module):
  """Coloring behind its code, the JAX package's ``Coloring``: 'n'
  (identity); 's' (diagonal ``gamma``, ``beta``); 'ccs' / 'ucs' (per-class
  diagonal ``gamma_c``, ``beta_c``; 'ucs' sums the unconditional 's' onto
  a zero-init class scale); 'uconv' (1x1 conv ``gamma_a`` (C, C) from the
  identity, ``beta_a``); 'cconv' / 'ucconv' (per-class 1x1 conv; 'cconv'
  adds an identity skip, 'ucconv' the 'uconv' branch); '-sa' (the class
  filter from K shared basis filters). The conditional codes take one
  label per image."""

  def __init__(self, channels: int, code: str = "uconv", num_classes: int = 0,
               filters_emb: int = 10,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    if code not in COLORING_CODES:
      raise ValueError(f"unknown coloring code {code!r}")
    self.code = code
    if code in ("s", "ucs"):
      self.gamma = nn.Parameter(torch.ones(channels))
      self.beta = nn.Parameter(torch.zeros(channels))
    if code in ("ccs", "ucs"):
      if num_classes <= 0:
        raise ValueError(f"conditional coloring {code!r} requires "
                         "num_classes > 0")
      # 'ucs' sums both branches, so its class scale starts at 0 and the
      # block is the identity at step 0; 'ccs' is the whole transform.
      init = torch.zeros if code == "ucs" else torch.ones
      self.gamma_c = nn.Parameter(init(num_classes, channels))
      self.beta_c = nn.Parameter(torch.zeros(num_classes, channels))
    elif code == "uconv":
      self.gamma_a = nn.Parameter(torch.eye(channels))
      self.beta_a = nn.Parameter(torch.zeros(channels))
    elif code in _FUSED_COND_CODES:
      _conditional_params(self, code, channels, num_classes, filters_emb,
                          generator)

  def forward(self, x: torch.Tensor,
              labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    code = self.code
    if code == "n":
      return x
    x2d = _rows(x)
    if code == "s":
      return _unrows(coloring_ops.center_scale(x2d, self.gamma, self.beta), x)
    if code == "uconv":
      return _unrows(
          coloring_ops.color_uncond(x2d, self.gamma_a, self.beta_a), x)
    labels = _need_labels(code, labels)
    x3d = _as_nsc(x2d, x.shape[0])
    if code in ("ccs", "ucs"):
      out = coloring_ops.conditional_center_scale(x3d, labels, self.gamma_c,
                                                  self.beta_c)
      if code == "ucs":
        out = out + coloring_ops.center_scale(x3d, self.gamma, self.beta)
    elif code in ("cconv", "ucconv"):
      cond = coloring_ops.color_cond(x3d, labels, self.gamma_c, self.beta_c)
      out = (cond + x3d if code == "cconv" else
             coloring_ops.color_uncond(x3d, self.gamma_a, self.beta_a) + cond)
    else:
      cond = coloring_ops.color_cond_sa(x3d, labels, self.basis,
                                        self.embedding, self.beta_c)
      out = (cond + x3d if code == "cconv-sa" else
             coloring_ops.color_uncond(x3d, self.gamma_a, self.beta_a) + cond)
    return _unrows(out.reshape(-1, x2d.shape[1]), x)


class NormColor(nn.Module):
  """The WC block: a norm code {'n', 'b', 'd', 'dr'} and a coloring code
  (any of ``COLORING_CODES``), the JAX package's ``NormColor``.

  Whitening with 'uconv' coloring is fused (``_fused_wc_uconv``): W and
  Gamma fold into one C x C matrix M = Gamma W (float32) with bias
  beta - mu M^T, so the rows see a single matmul in the activation dtype:
  out = x M^T + bias. Gamma starts at the identity. Whitening with a
  conditional 1x1-conv coloring is fused per image (``_fused_wc_cond``).
  'd' whitens with the batch statistics, 'dr' with the running ones
  (buffers ``mean``, ``cov``), which advance from the batch in train mode
  when ``update_stats`` is set. In eval mode ``kernel_eval=True`` runs the
  'uconv' layer through K2; on a conditional layer it raises, naming the
  layer (``layer_name``, set by the model that holds it): K2 has one
  coloring for all rows. Every other pair of codes runs the general path:
  ``NormLayer`` (submodule ``norm``), then ``Coloring`` (``color``).
  Its forward is the span ``wc.forward`` and its backward ``wc.backward``
  (``trace``)."""

  STAT_NAMES = ("mean", "cov")

  def __init__(self, channels: int, norm: str = "d", coloring: str = "uconv",
               momentum: float = 0.99, eps: float = 1e-5, ns_iters: int = 15,
               method: str = "newton_schulz", ns_scaling: str = "trace",
               use_kernel: Optional[bool] = None,
               kernel_eval: Optional[bool] = None, num_classes: int = 0,
               filters_emb: int = 10,
               generator: Optional[torch.Generator] = None,
               group: mesh.Group = None):
    super().__init__()
    self.fused = norm in ("d", "dr") and coloring in (
        ("uconv",) + _FUSED_COND_CODES)
    self.coloring = coloring
    self.layer_name = "NormColor"
    self.norm_code = norm
    self.momentum = momentum
    self.eps = eps
    self.ns_iters = ns_iters
    self.method = method
    self.ns_scaling = ns_scaling
    self.use_kernel = use_kernel
    self.kernel_eval = kernel_eval
    self.group = group
    self.moments_sink: Optional[MomentsSink] = None
    if self.fused:
      if coloring == "uconv":
        self.gamma = nn.Parameter(torch.eye(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
      else:
        _conditional_params(self, coloring, channels, num_classes,
                            filters_emb, generator)
      self.register_buffer("mean", torch.zeros(channels))
      self.register_buffer("cov", torch.eye(channels))
    else:
      self.norm = NormLayer(channels, norm, momentum=momentum, eps=eps,
                            ns_iters=ns_iters, method=method,
                            ns_scaling=ns_scaling, use_kernel=use_kernel,
                            kernel_eval=kernel_eval, group=group)
      self.color = Coloring(channels, coloring, num_classes, filters_emb,
                            generator)

  def _wc_stats(self, x2d: torch.Tensor, train: bool, update_stats: bool):
    """(mean, stat_src) per the 'd'/'dr' contract, after advancing the
    running statistics when ``update_stats``."""
    if not train:
      return self.mean, self.cov
    batch_mean, batch_cov = whiten_ops.batch_moments(x2d, self.use_kernel,
                                                     self.group)
    if self.moments_sink is not None:
      self.moments_sink(batch_mean, batch_cov)
    running = (self.mean, self.cov)
    if self.norm_code == "dr":       # whitens with them: backward reads them
      running = tuple(_saved(t) for t in running)
    mean, stat_src, new_mean, new_cov = whiten_ops.stats_select_and_ema(
        batch_mean, batch_cov, *running, use_batch=self.norm_code == "d",
        momentum=self.momentum)
    if update_stats:
      _advance(self.mean, new_mean)
      _advance(self.cov, new_cov)
    return mean, stat_src

  def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
              train: bool = True, update_stats: bool = True) -> torch.Tensor:
    with trace.span("wc.forward"):
      return trace.backward_span("wc.backward", self._forward, x, labels,
                                 train, update_stats)

  def _forward(self, x: torch.Tensor, labels: Optional[torch.Tensor],
               train: bool, update_stats: bool) -> torch.Tensor:
    if not self.fused:
      return self.color(self.norm(x, train, update_stats), labels)
    if self.coloring == "uconv":
      return self._fused_wc_uconv(x, train, update_stats)
    return self._fused_wc_cond(x, labels, train, update_stats)

  def _w(self, stat_src: torch.Tensor) -> torch.Tensor:
    return whiten_ops.inv_sqrt(stat_src, num_iters=self.ns_iters,
                               eps=self.eps, method=self.method,
                               scaling=self.ns_scaling)

  def _fused_wc_uconv(self, x: torch.Tensor, train: bool,
                      update_stats: bool) -> torch.Tensor:
    x2d = _rows(x)
    mean, stat_src = self._wc_stats(x2d, train, update_stats)
    if not train and _kernel_eval_ok(self.kernel_eval, self.method):
      out = cuda_wc.whiten_color_apply(
          x2d, mean, stat_src, self.gamma, self.beta, ns_iters=self.ns_iters,
          eps=self.eps, scaling=self.ns_scaling)
      return _unrows(out, x)
    m = self.gamma @ self._w(stat_src)                  # (C, C) fold, f32
    bias = self.beta - mean @ m.T
    out = x2d @ m.T.to(x.dtype) + bias.to(x.dtype)
    return _unrows(out, x)

  def _fused_wc_cond(self, x: torch.Tensor, labels: Optional[torch.Tensor],
                     train: bool, update_stats: bool) -> torch.Tensor:
    """Whitening and a conditional 1x1-conv coloring, with the coloring
    folded per image, the JAX package's ``_fused_wc_cond``.

    G_i is image i's coloring matrix: its class filter ('-sa': the basis
    mix) plus the agnostic ``gamma_a`` ('ucconv*') or the identity skip
    ('cconv*'), b_i its bias. With S = H*W rows per image:
    - S >= C: the fold M_i = G_i W and the bias b_i - mu M_i^T in float32,
      then one row pass x M_i^T in the activation dtype;
    - S < C (the fold would cost more than it saves): two row passes in
      the activation dtype, W first with bias -mu W^T, then G_i."""
    if not train and self.kernel_eval:
      raise ValueError(
          f"kernel_eval=True on the conditional WC layer {self.layer_name} "
          f"(coloring {self.coloring!r}): the whiten_color_apply kernel "
          "applies one coloring to every row, and this layer colors each "
          "image with its class's filter; use kernel_eval=None")
    labels = _need_labels(self.coloring, labels)
    c = x.shape[1]
    n = x.shape[0]
    agnostic = self.coloring in ("ucconv", "ucconv-sa")
    if self.coloring in ("cconv", "ucconv"):
      g_img = self.gamma_c[labels]                         # (N, C, C)
    else:
      g_img = torch.einsum("nk,koc->noc", self.embedding[labels], self.basis)
    g_img = g_img + (self.gamma_a if agnostic else
                     torch.eye(c, device=g_img.device))
    b_img = self.beta_c[labels]
    if agnostic:
      b_img = b_img + self.beta_a
    x2d = _rows(x)
    mean, stat_src = self._wc_stats(x2d, train, update_stats)
    w = self._w(stat_src)
    x3d = _as_nsc(x2d, n)
    if x3d.shape[1] >= c:
      m_img = torch.matmul(g_img, w)                      # per-image fold
      bias = b_img - torch.einsum("c,noc->no", mean, m_img)
      out = torch.bmm(x3d, m_img.transpose(1, 2).to(x.dtype))
    else:
      bias_w = -(mean @ w.T)
      xh = x3d @ w.T.to(x.dtype) + bias_w.to(x.dtype)
      out = torch.bmm(xh, g_img.transpose(1, 2).to(x.dtype))
      bias = b_img
    out = out + bias.to(x.dtype)[:, None, :]
    return _unrows(out.view(-1, c), x)


def _stat_layers(model: nn.Module):
  """(name, layer) of every layer of ``model`` that keeps running
  statistics: BatchNorms and whitening layers."""
  return [(name, m) for name, m in model.named_modules()
          if isinstance(m, (BatchNorm, DecorrelationNorm, NormColor))
          and "mean" in m._buffers]


@contextlib.contextmanager
def capture_batch_moments(model: nn.Module
                          ) -> Iterator[Dict[str, torch.Tensor]]:
  """Inside the block, each train-mode forward of a normalization layer of
  ``model`` records its batch statistics into the yielded dict, keyed like
  the layer's running-statistics buffers (``<layer>.mean`` and
  ``<layer>.cov`` of a whitening layer, ``<layer>.mean`` and
  ``<layer>.var`` of a BatchNorm, the biased variance); a later forward
  overwrites an earlier one. The statistics come straight from the batch,
  not from the running statistics' update, so they are exact whatever the
  momentum, and they are seen even where the buffers are not rebound
  (``update_stats=False``, ``torch.func.functional_call``)."""
  out: Dict[str, torch.Tensor] = {}
  layers = _stat_layers(model)

  def sink(prefix: str, names: Tuple[str, str]) -> MomentsSink:
    def record(mean: torch.Tensor, second: torch.Tensor) -> None:
      out[f"{prefix}.{names[0]}"] = mean.detach()
      out[f"{prefix}.{names[1]}"] = second.detach()
    return record

  for name, m in layers:
    m.moments_sink = sink(name, m.STAT_NAMES)
  try:
    yield out
  finally:
    for _, m in layers:
      m.moments_sink = None


def remat_call(module: nn.Module, args: Tuple, kwargs: Dict[str, Any],
               quiet: Dict[str, Any]) -> torch.Tensor:
  """``module(*args, **kwargs)`` under ``torch.utils.checkpoint``: its
  activations are recomputed in the backward instead of kept, the
  reference's ``nn.remat``. Where grad is off it is a plain call.

  The recomputation must repeat the forward, not advance it a second time:
  it runs on copies of the buffers the first call read (running
  statistics, SN vectors: the first call advances them in place),
  with ``quiet`` merged into ``kwargs`` (the flags that advance them off),
  and records no batch statistics (``capture_batch_moments``). Its K1
  launches are real launches and are counted as such."""
  if not torch.is_grad_enabled():
    return module(*args, **kwargs)
  read = {name: b.clone() for name, b in module.named_buffers()}
  calls = [0]

  def run(*inputs):
    calls[0] += 1
    if calls[0] == 1:
      return module(*inputs, **kwargs)
    layers = _stat_layers(module)
    sinks = [m.moments_sink for _, m in layers]
    for _, m in layers:
      m.moments_sink = None
    try:
      return functional_call(module, read, inputs, {**kwargs, **quiet})
    finally:
      for (_, m), sink in zip(layers, sinks):
        m.moments_sink = sink

  return checkpoint(run, *args, use_reentrant=False,
                    preserve_rng_state=False)


def _add_bias(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
  """y + bias over the channel dim (dim 1), after the product has been
  rounded to y's dtype: flax adds the bias as a second step, so in
  bfloat16 a bias fused into the conv or matmul rounds elsewhere (up to a
  bf16 ulp of the product; ROADMAP queue 3)."""
  shape = (1, -1) + (1,) * (y.dim() - 2)
  return y + bias.to(y.dtype).view(shape)


class Conv(nn.Conv2d):
  """'SAME'-padded conv computing in the input's dtype, with flax's default
  init (lecun_normal kernel, zero bias)."""

  def __init__(self, in_channels: int, features: int, kernel_size: int,
               generator: torch.Generator, stride: int = 1):
    super().__init__(in_channels, features, kernel_size, stride=stride)
    lecun_normal_(self.weight.data, in_channels * kernel_size ** 2,
                  generator)
    nn.init.zeros_(self.bias)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return _add_bias(sn_ops.conv2d_same(x, self.weight.to(x.dtype),
                                        self.stride[0]), self.bias)


class ConvTranspose(nn.Module):
  """flax's ``nn.ConvTranspose(features, (4, 4), strides=(2, 2),
  padding="SAME")``, the DCGAN generator's up-conv: twice the input in
  each spatial dim ('SAME' is a padding of 1 on each side), computing in
  the input's dtype, flax's init (lecun_normal over 16 * in, zero bias).

  ``weight`` is (in, out, 4, 4), as ``F.conv_transpose2d`` takes it, and
  holds flax's HWIO kernel with both spatial dims flipped: flax applies
  the kernel as it stands to the dilated input, torch's transposed conv
  applies the adjoint of a conv, which is the flipped kernel
  (``weights.py`` maps the two)."""

  def __init__(self, in_channels: int, features: int,
               generator: torch.Generator):
    super().__init__()
    self.weight = nn.Parameter(lecun_normal_(
        torch.empty(in_channels, features, 4, 4), in_channels * 16,
        generator))
    self.bias = nn.Parameter(torch.zeros(features))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return _add_bias(F.conv_transpose2d(x, self.weight.to(x.dtype), stride=2,
                                        padding=1), self.bias)


class Dense(nn.Linear):
  """Dense layer computing in the input's dtype, flax default init."""

  def __init__(self, in_features: int, features: int,
               generator: torch.Generator):
    super().__init__(in_features, features)
    lecun_normal_(self.weight.data, in_features, generator)
    nn.init.zeros_(self.bias)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return _add_bias(F.linear(x, self.weight.to(x.dtype)), self.bias)


def _sn_vector(u: torch.Tensor, fully_diff: bool) -> torch.Tensor:
  """The power iteration's start ``u`` as a pass reads it. Without
  ``fully_diff`` the iteration runs without grad and autograd saves only
  its result; with it autograd saves ``u`` itself, so the pass reads a
  copy."""
  return _saved(u) if fully_diff else u


class SNConv(nn.Module):
  """'SAME'-padded 2-D conv with a spectral-normalized kernel, the
  reference's ``SNConv``; the power-iteration state advances only when
  ``update_sn`` is set.

  sigma is that of the kernel reshaped to (out, rest), with the vector
  ``u`` (out,); with ``conv_singular`` it is that of the convolution
  operator at the layer's input size, with the input-shaped map ``u_map``
  (1, in, H, W). flax creates ``u_map`` from the first input; here
  ``input_size`` (H, W) fixes it at construction, so that the state's
  shapes do not depend on a first call."""

  def __init__(self, in_channels: int, features: int, kernel_size: int,
               generator: torch.Generator, sn_iters: int = 1,
               fully_diff: bool = False, stride: int = 1,
               conv_singular: bool = False,
               input_size: Optional[Tuple[int, int]] = None):
    super().__init__()
    self.stride = stride
    self.sn_iters = sn_iters
    self.fully_diff = fully_diff
    self.conv_singular = conv_singular
    self.weight = nn.Parameter(glorot_uniform_(
        torch.empty(features, in_channels, kernel_size, kernel_size),
        in_channels * kernel_size ** 2, features * kernel_size ** 2,
        generator))
    self.bias = nn.Parameter(torch.zeros(features))
    if conv_singular:
      if input_size is None:
        raise ValueError("SNConv with conv_singular needs input_size (H, W)")
      self.register_buffer("u_map", torch.randn(
          (1, in_channels) + tuple(input_size), generator=generator))
    else:
      self.register_buffer("u", torch.randn(features, generator=generator))

  def _normalized(self, x: torch.Tensor, update_sn: bool) -> torch.Tensor:
    if not self.conv_singular:
      w_bar, u_new = sn_ops.spectral_normalize(
          self.weight, _sn_vector(self.u, self.fully_diff),
          n_iters=self.sn_iters, fully_diff=self.fully_diff)
      if update_sn:
        _advance(self.u, u_new)
      return w_bar
    if tuple(x.shape[2:]) != tuple(self.u_map.shape[2:]):
      raise ValueError(f"SNConv(conv_singular) was built for inputs of "
                       f"{tuple(self.u_map.shape[2:])}, got "
                       f"{tuple(x.shape[2:])}")
    sigma, u_new = sn_ops.conv_power_iteration(
        self.weight, _sn_vector(self.u_map, self.fully_diff),
        stride=self.stride, n_iters=self.sn_iters,
        fully_diff=self.fully_diff)
    if update_sn:
      _advance(self.u_map, u_new)
    return self.weight / sigma.to(self.weight.dtype)

  def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
    w_bar = self._normalized(x, update_sn)
    return _add_bias(sn_ops.conv2d_same(x, w_bar.to(x.dtype), self.stride),
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
        self.weight, _sn_vector(self.u, self.fully_diff),
        n_iters=self.sn_iters, fully_diff=self.fully_diff)
    if update_sn:
      _advance(self.u, u_new)
    return _add_bias(F.linear(x, w_bar.to(x.dtype)), self.bias)


class SNEmbed(nn.Module):
  """Spectral-normalized class embedding psi(y), projection-D's: the table
  ``embedding`` (num_classes, features) divided by its sigma, with ``u``
  over the features, as the JAX package takes sigma of the table's
  (features, num_classes) transpose."""

  def __init__(self, num_classes: int, features: int,
               generator: torch.Generator, sn_iters: int = 1,
               fully_diff: bool = False):
    super().__init__()
    self.sn_iters = sn_iters
    self.fully_diff = fully_diff
    self.embedding = nn.Parameter(glorot_uniform_(
        torch.empty(num_classes, features), num_classes, features, generator))
    self.register_buffer("u", torch.randn(features, generator=generator))

  def forward(self, labels: torch.Tensor,
              update_sn: bool = False) -> torch.Tensor:
    w_bar_t, u_new = sn_ops.spectral_normalize(
        self.embedding.T, _sn_vector(self.u, self.fully_diff),
        n_iters=self.sn_iters, fully_diff=self.fully_diff)
    if update_sn:
      _advance(self.u, u_new)
    return w_bar_t.T[labels.long()]


class PlainConv(nn.Module):
  """A conv without spectral normalization behind SNConv's call, the JAX
  package's ``Conv`` wrapper (its flax conv sits in submodule ``conv``);
  ``update_sn`` is ignored."""

  def __init__(self, in_channels: int, features: int, kernel_size: int,
               generator: torch.Generator, stride: int = 1):
    super().__init__()
    self.conv = Conv(in_channels, features, kernel_size, generator, stride)
    glorot_uniform_(self.conv.weight.data, in_channels * kernel_size ** 2,
                    features * kernel_size ** 2, generator)

  def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
    del update_sn
    return self.conv(x)


class PlainDense(nn.Module):
  """A dense layer without spectral normalization behind SNDense's call
  (submodule ``dense``, as the JAX package's ``Dense`` wrapper)."""

  def __init__(self, in_features: int, features: int,
               generator: torch.Generator):
    super().__init__()
    self.dense = Dense(in_features, features, generator)
    glorot_uniform_(self.dense.weight.data, in_features, features, generator)

  def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
    del update_sn
    return self.dense(x)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
  """Nearest-neighbour upsample of (N, C, H, W), layout kept."""
  return F.interpolate(x, scale_factor=factor, mode="nearest")


def downsample_avg(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
  """``factor`` x ``factor`` average pool (the reference's down-resample)."""
  return F.avg_pool2d(x, factor)


def global_sum_pool(x: torch.Tensor) -> torch.Tensor:
  """Sum over H, W: (N, C, H, W) -> (N, C)."""
  return torch.sum(x, dim=(2, 3))
