"""Spectral normalization (Miyato et al. 2018) on PyTorch tensors.

Counterpart of ``wcgan_tpu/ops/sn.py``: ``(W, u) -> (W / sigma, u')`` with
the persistent power-iteration vector ``u`` kept by the caller (a module
buffer in the port). The operator-norm variant (``--conv_singular``) is not
ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch


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
