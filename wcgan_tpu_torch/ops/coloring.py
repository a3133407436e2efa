"""Colorings, the learned half of the WC transform.

Counterpart of ``wcgan_tpu/ops/coloring.py``. The unconditional functions
work over (..., C) rows: the 1x1-conv coloring ('uconv') and the diagonal
scale-shift ('s'). The conditional ones work per image on (N, S, C), with
one label per image: all S rows of an image share its class, so the class
filter is gathered once per image, (N, C_out, C_in), and applied as a
batched matmul. Gathering it per row would take (N*S, C_out, C_in).

- ``color_cond`` (cWC): class filter + optional class-agnostic branch;
- ``color_cond_sa`` (cWC-sa): the class filter is sum_k A[y, k] Gamma_k
  over K shared basis filters, made per image first;
- ``conditional_center_scale``: per-class diagonal scale-shift.
"""

from __future__ import annotations

from typing import Optional

import torch


def color_uncond(x_hat: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor) -> torch.Tensor:
  """``x_hat @ gamma^T + beta`` over the last dim, in x_hat's dtype; gamma
  is (C_out, C_in), beta (C_out,)."""
  out = x_hat @ gamma.T.to(x_hat.dtype)
  return out + beta.to(out.dtype)


def _cond_apply(x_nsc: torch.Tensor, g_img: torch.Tensor,
                b_img: torch.Tensor) -> torch.Tensor:
  """(N, S, C_in) x per-image (N, C_out, C_in) + (N, C_out)."""
  out = torch.bmm(x_nsc, g_img.transpose(1, 2).to(x_nsc.dtype))
  return out + b_img.to(out.dtype)[:, None, :]


def _add_agnostic(out: torch.Tensor, x_nsc: torch.Tensor,
                  gamma_a: Optional[torch.Tensor],
                  beta_a: Optional[torch.Tensor]) -> torch.Tensor:
  """The optional class-agnostic branch summed onto a conditional coloring
  (the tail of 'ucconv' / 'ucconv-sa')."""
  if gamma_a is None:
    return out
  if beta_a is None:
    beta_a = torch.zeros(gamma_a.shape[0], device=gamma_a.device)
  return out + color_uncond(x_nsc, gamma_a, beta_a)


def color_cond(x_nsc: torch.Tensor, labels: torch.Tensor,
               gamma_c: torch.Tensor, beta_c: torch.Tensor,
               gamma_a: Optional[torch.Tensor] = None,
               beta_a: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Class-conditional coloring (cWC): x_nsc (N, S, C_in), labels (N,),
  gamma_c (num_classes, C_out, C_in), beta_c (num_classes, C_out), and an
  optional class-agnostic branch gamma_a/beta_a summed on."""
  out = _cond_apply(x_nsc, gamma_c[labels], beta_c[labels])
  return _add_agnostic(out, x_nsc, gamma_a, beta_a)


def color_cond_sa(x_nsc: torch.Tensor, labels: torch.Tensor,
                  basis: torch.Tensor, embedding: torch.Tensor,
                  beta_emb: torch.Tensor,
                  gamma_a: Optional[torch.Tensor] = None,
                  beta_a: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Soft-assignment conditional coloring (cWC-sa): the filter of image i
  is sum_k embedding[y_i, k] basis[k], made per image, then applied as in
  ``color_cond``. basis (K, C_out, C_in), embedding (num_classes, K),
  beta_emb (num_classes, C_out)."""
  g_img = torch.einsum("nk,koc->noc", embedding[labels], basis)
  out = _cond_apply(x_nsc, g_img, beta_emb[labels])
  return _add_agnostic(out, x_nsc, gamma_a, beta_a)


def center_scale(x: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor) -> torch.Tensor:
  """Diagonal scale-shift ``x * gamma + beta`` over the last dim (code
  's')."""
  return x * gamma.to(x.dtype) + beta.to(x.dtype)


def conditional_center_scale(x_nsc: torch.Tensor, labels: torch.Tensor,
                             gamma: torch.Tensor,
                             beta: torch.Tensor) -> torch.Tensor:
  """Per-class diagonal scale-shift: x_nsc (N, S, C), gamma/beta
  (num_classes, C), labels (N,)."""
  g = gamma[labels].to(x_nsc.dtype)[:, None, :]
  b = beta[labels].to(x_nsc.dtype)[:, None, :]
  return x_nsc * g + b
