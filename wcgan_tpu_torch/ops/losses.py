"""GAN objectives on raw (pre-sigmoid) discriminator scores.

Counterpart of ``wcgan_tpu/ops/losses.py``: hinge, non-saturating and
WGAN losses as batch means. The gradient penalty and the AC-GAN auxiliary
loss are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F


def hinge_d_loss(real_scores: torch.Tensor,
                 fake_scores: torch.Tensor) -> torch.Tensor:
  """E[relu(1 - D(x))] + E[relu(1 + D(G(z)))]."""
  return (torch.mean(F.relu(1.0 - real_scores))
          + torch.mean(F.relu(1.0 + fake_scores)))


def ns_d_loss(real_scores: torch.Tensor,
              fake_scores: torch.Tensor) -> torch.Tensor:
  """Non-saturating (standard) GAN D loss with logits."""
  return (torch.mean(F.softplus(-real_scores))
          + torch.mean(F.softplus(fake_scores)))


def wgan_d_loss(real_scores: torch.Tensor,
                fake_scores: torch.Tensor) -> torch.Tensor:
  """Wasserstein critic loss: E[D(G(z))] - E[D(x)]."""
  return torch.mean(fake_scores) - torch.mean(real_scores)


def hinge_g_loss(fake_scores: torch.Tensor) -> torch.Tensor:
  """-E[D(G(z))] — the hinge G loss (same as WGAN's)."""
  return -torch.mean(fake_scores)


def ns_g_loss(fake_scores: torch.Tensor) -> torch.Tensor:
  """Non-saturating G loss: -E[log sigmoid(D(G(z)))]."""
  return torch.mean(F.softplus(-fake_scores))


wgan_g_loss = hinge_g_loss

D_LOSSES = {"hinge": hinge_d_loss, "ns": ns_d_loss, "wgan": wgan_d_loss}
G_LOSSES = {"hinge": hinge_g_loss, "ns": ns_g_loss, "wgan": wgan_g_loss}


def get_losses(name: str) -> Tuple[Callable, Callable]:
  """(d_loss_fn, g_loss_fn) for a ``--loss`` name."""
  if name not in D_LOSSES:
    raise ValueError(f"unknown loss {name!r}; choose from {sorted(D_LOSSES)}")
  return D_LOSSES[name], G_LOSSES[name]
