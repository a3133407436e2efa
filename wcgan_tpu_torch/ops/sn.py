"""Spectral normalization (Miyato et al. 2018) on PyTorch tensors.

Counterpart of ``wcgan_tpu/ops/sn.py``: ``(W, u) -> (W / sigma, u')`` with
the persistent power-iteration vector ``u`` kept by the caller (a module
buffer in the port), and the operator-norm variant (``--conv_singular``):
sigma of the convolution itself, by power iteration through the conv and
its transpose on a persistent input-shaped map. Also here: flax's 'SAME'
conv padding, which both the conv layers and that iteration use.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
  return v * torch.rsqrt(torch.sum(v * v) + eps)


def power_iteration(w2d: torch.Tensor, u: torch.Tensor, n_iters: int = 1,
                    fully_diff: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Power iteration on a (rows, cols) matrix; returns (sigma, u', v).

  u and v carry no gradient unless ``fully_diff``; sigma = u'^T W v always
  has its gradient with respect to W."""
  if n_iters < 1:
    raise ValueError("power_iteration needs n_iters >= 1 (v starts at "
                     "zeros; 0 iterations would give sigma = 0)")
  w = w2d.float()
  u = u.float()
  with torch.set_grad_enabled(fully_diff and torch.is_grad_enabled()):
    for _ in range(n_iters):
      v = _l2_normalize(u @ w)
      u = _l2_normalize(w @ v)
  if not fully_diff:
    u, v = u.detach(), v.detach()
  sigma = u @ w @ v
  return sigma, u, v


def spectral_normalize(weight: torch.Tensor, u: torch.Tensor,
                       n_iters: int = 1, fully_diff: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
  """``weight`` / sigma with sigma of its (out, rest) matrix; returns
  (normalized weight, u').

  ``weight`` is laid out with the output features first (OIHW conv,
  (out, in) dense). The reference takes sigma of HWIO's
  ``kernel.reshape(-1, out).T``, whose columns are ordered (kh, kw, in);
  this matrix orders them (in, kh, kw). Permuting columns changes neither
  sigma nor u, only the order of v's entries."""
  w2d = weight.reshape(weight.shape[0], -1)
  sigma, u_new, _ = power_iteration(w2d, u, n_iters=n_iters,
                                    fully_diff=fully_diff)
  return weight / sigma.to(weight.dtype), u_new.to(u.dtype)


def same_pads(size: int, kernel: int, stride: int = 1) -> Tuple[int, int]:
  """XLA's 'SAME' padding of one spatial dim, (before, after): the output
  has ceil(size / stride) positions, and the padding they need is split
  with the odd one after."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor,
                stride: int = 1) -> torch.Tensor:
  """2-D conv of NCHW ``x`` with an OIHW ``weight``, 'SAME'-padded as flax
  pads it (a symmetric padding goes to ``F.conv2d`` itself)."""
  (ht, hb), (wl, wr) = (same_pads(x.shape[2], weight.shape[2], stride),
                        same_pads(x.shape[3], weight.shape[3], stride))
  if ht == hb and wl == wr:
    return F.conv2d(x, weight, stride=stride, padding=(ht, wl))
  return F.conv2d(F.pad(x, (wl, wr, ht, hb)), weight, stride=stride)


def conv2d_same_transpose(y: torch.Tensor, weight: torch.Tensor, stride: int,
                          size: Tuple[int, int]) -> torch.Tensor:
  """The transpose of ``conv2d_same`` at an input of spatial ``size``: its
  gradient with respect to the input for the output gradient ``y``. The
  transposed conv covers the padded input up to the last window; rows past
  it get nothing, and the padding is cropped off."""
  h, w = size
  (ht, hb), (wl, wr) = (same_pads(h, weight.shape[2], stride),
                        same_pads(w, weight.shape[3], stride))
  full = F.conv_transpose2d(y, weight, stride=stride)
  full = F.pad(full, (0, w + wl + wr - full.shape[3],
                      0, h + ht + hb - full.shape[2]))
  return full[:, :, ht:ht + h, wl:wl + w]


def conv_power_iteration(weight: torch.Tensor, u_map: torch.Tensor,
                         stride: int = 1, n_iters: int = 1,
                         fully_diff: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
  """sigma of the convolution operator of ``weight`` (OIHW, 'SAME', one
  ``stride`` for both dims) and the next ``u_map``; the reference's
  ``conv_power_iteration`` (``--conv_singular``).

  The power iteration alternates the conv and its transpose on the
  persistent input-shaped map ``u_map`` (1, C_in, H, W), in float32 (true
  float32 on the card, where the entry points turn TF32 off: the
  reference's ``HIGHEST``): v = conv(u)/|.|, u = conv^T(v)/|.|, then
  sigma = |conv(u)|. u carries no gradient unless ``fully_diff``; sigma
  always has its gradient with respect to ``weight``."""
  if n_iters < 1:
    raise ValueError("conv_power_iteration needs n_iters >= 1")
  k = weight.float()
  size = (u_map.shape[2], u_map.shape[3])
  u = u_map.float()
  with torch.set_grad_enabled(fully_diff and torch.is_grad_enabled()):
    for _ in range(n_iters):
      v = _l2_normalize(conv2d_same(u, k, stride))
      u = _l2_normalize(conv2d_same_transpose(v, k, stride, size))
  if not fully_diff:
    u = u.detach()
  out = conv2d_same(u, k, stride)
  sigma = torch.sqrt(torch.sum(out * out) + 1e-12)
  return sigma, u.to(u_map.dtype)
