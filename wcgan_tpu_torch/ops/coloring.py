"""Unconditional colorings, the learned half of the WC transform.

Counterpart of the unconditional functions of ``wcgan_tpu/ops/coloring.py``
over (..., C) rows: the 1x1-conv coloring ('uconv') and the diagonal
scale-shift ('s'). The conditional colorings are not ported yet.
"""

from __future__ import annotations

import torch


def color_uncond(x_hat: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor) -> torch.Tensor:
  """``x_hat @ gamma^T + beta`` over the last dim, in x_hat's dtype; gamma
  is (C_out, C_in), beta (C_out,)."""
  out = x_hat @ gamma.T.to(x_hat.dtype)
  return out + beta.to(out.dtype)


def center_scale(x: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor) -> torch.Tensor:
  """Diagonal scale-shift ``x * gamma + beta`` over the last dim (code
  's')."""
  return x * gamma.to(x.dtype) + beta.to(x.dtype)
