"""Learning-rate decay schedules and the GAN Adam.

Counterpart of ``wcgan_tpu/train/schedules.py``. The reference's optax
schedules become ``LambdaLR`` factors of the base LR, evaluated at the
optimizer's update count t (0 for the first update), total T:

  none        1
  linear      1 - t/T                      (decay to 0 over the run)
  half-linear 1 for t < T//2;   then linear from 1 to 0 over the rest
  linear-end  1 for t < 0.9 T;  then linear from 1 to 0 over the rest
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch


def _linear_after(knee: int, total: int) -> Callable[[int], float]:
  span = total - knee

  def factor(t: int) -> float:
    if t < knee:
      return 1.0
    return 1.0 - min(t - knee, span) / span

  return factor


def lr_factor(name: str, total_steps: int) -> Callable[[int], float]:
  """The schedule as a factor of the base LR at update count t."""
  total = max(int(total_steps), 1)
  if name in (None, "none", ""):
    return lambda t: 1.0
  if name == "linear":
    return _linear_after(0, total)
  if name == "half-linear":
    return _linear_after(total // 2, total)
  if name == "linear-end":
    return _linear_after(int(total * 0.9), total)
  raise ValueError(f"unknown lr schedule {name!r}")


def adam(params: Iterable[torch.nn.Parameter], base_lr: float,
         beta1: float = 0.0, beta2: float = 0.9, schedule: str = "none",
         total_steps: int = 1
         ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
  """Adam with the reference's GAN defaults (lr 2e-4, betas (0, 0.9)) and
  its LR schedule; step the scheduler once per optimizer step.

  eps=1e-8 is added after the square root of the bias-corrected second
  moment, as optax's adam does."""
  opt = torch.optim.Adam(params, lr=base_lr, betas=(beta1, beta2), eps=1e-8)
  return opt, torch.optim.lr_scheduler.LambdaLR(
      opt, lr_factor(schedule, total_steps))
