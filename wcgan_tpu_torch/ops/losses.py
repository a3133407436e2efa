"""GAN objectives on raw (pre-sigmoid) discriminator scores.

Counterpart of ``wcgan_tpu/ops/losses.py``: hinge, non-saturating and
WGAN losses as batch means, the WGAN-GP gradient penalty and the AC-GAN
auxiliary classifier loss.
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

D_LOSSES = {"hinge": hinge_d_loss, "ns": ns_d_loss, "wgan": wgan_d_loss,
            "wgan-gp": wgan_d_loss}
G_LOSSES = {"hinge": hinge_g_loss, "ns": ns_g_loss, "wgan": wgan_g_loss,
            "wgan-gp": wgan_g_loss}


def get_losses(name: str) -> Tuple[Callable, Callable]:
  """(d_loss_fn, g_loss_fn) for a ``--loss`` name."""
  if name not in D_LOSSES:
    raise ValueError(f"unknown loss {name!r}; choose from {sorted(D_LOSSES)}")
  return D_LOSSES[name], G_LOSSES[name]


def gradient_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor,
                     eps: torch.Tensor, weight: float = 10.0
                     ) -> torch.Tensor:
  """lambda * E[(||grad_x_hat D(x_hat)||_2 - 1)^2] on the interpolates
  x_hat = eps * x + (1 - eps) * G(z), with eps (N,) in [0, 1) drawn by the
  caller, one per sample. ``d_apply`` maps images to per-sample scores.
  The input gradient keeps its graph (``create_graph``), so the penalty
  differentiates with respect to D's parameters: a second derivative
  through every layer of D, whitening included."""
  eps = eps.to(real.dtype).view((-1,) + (1,) * (real.dim() - 1))
  x_hat = (eps * real + (1.0 - eps) * fake).requires_grad_(True)
  grads, = torch.autograd.grad(torch.sum(d_apply(x_hat)), x_hat,
                               create_graph=True)
  norms = torch.sqrt(torch.sum(torch.square(grads.float()),
                               dim=tuple(range(1, grads.dim()))) + 1e-12)
  return weight * torch.mean(torch.square(norms - 1.0))


def ac_gan_aux_loss(class_logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
  """Cross-entropy of D's auxiliary classifier head; added to the D loss
  on real images and to the G loss on generated ones."""
  logp = F.log_softmax(class_logits.float(), dim=-1)
  return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))
