"""Train state: everything one GAN experiment mutates, in one object.

Counterpart of ``wcgan_tpu/train/state.py``. The reference threads an
immutable pytree through a jitted step; here the step updates this object
in place: G and D (parameters plus their ``wc_stats``/``u`` buffers, each
tensor advanced in place, never rebound), the two Adams with their LR
schedules (the LR a tensor on the device), the outer-step count, the
``torch.Generator`` that draws z, the flips and the device-data picks, and
the EMA shadow of G's parameters (``g_ema``, the reference's
``GANTrainState.g_ema``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from wcgan_tpu_torch.device import place
from wcgan_tpu_torch.models.discriminator import (Discriminator,
                                                  DiscriminatorConfig)
from wcgan_tpu_torch.models.generator import Generator, GeneratorConfig
from wcgan_tpu_torch.parallel import mesh
from wcgan_tpu_torch.train import schedules


@dataclasses.dataclass
class OptimConfig:
  """Adam and LR-schedule settings for G and D (the CLI's flags)."""

  generator_lr: float = 2e-4
  discriminator_lr: float = 2e-4
  beta1: float = 0.0
  beta2: float = 0.9
  lr_decay_schedule: str = "none"
  total_outer_steps: int = 1      # G updates over the run; D has ratio x


@dataclasses.dataclass
class GANTrainState:
  """All mutable training state for one GAN experiment."""

  g: Generator
  d: Discriminator
  g_opt: torch.optim.Adam
  d_opt: torch.optim.Adam
  g_sched: schedules.LRSchedule
  d_sched: schedules.LRSchedule
  generator: torch.Generator
  step: int = 0                   # counts OUTER steps
  # EMA of G's parameters, name -> tensor over ``g.named_parameters()``
  # (None when disabled); updated in place after each G update.
  g_ema: Optional[Dict[str, torch.Tensor]] = None
  # Bumped by every G update and every restore: the shadow is updated in
  # place, so its identity cannot say that it changed.
  g_version: int = 0


def full_state(st: GANTrainState) -> Dict:
  """Everything the state holds, as tensors, dicts, lists and numbers
  (what ``torch.load(weights_only=True)`` takes): G and D with their
  statistics and SN vectors, both Adams and LR schedules, the EMA shadow,
  the noise generator and the outer-step count. The tensors are the live
  ones, not copies."""
  return {"g": st.g.state_dict(), "d": st.d.state_dict(),
          "g_opt": st.g_opt.state_dict(), "d_opt": st.d_opt.state_dict(),
          "g_sched": st.g_sched.state_dict(),
          "d_sched": st.d_sched.state_dict(),
          "g_ema": st.g_ema, "generator": st.generator.get_state(),
          "step": st.step}


def ema_copy(g: Generator) -> Dict[str, torch.Tensor]:
  """A copy of G's parameters, the EMA shadow at init; 4-D weights keep
  their channels_last layout."""
  return {name: p.detach().clone(memory_format=torch.preserve_format)
          for name, p in g.named_parameters()}


def state_from_modules(g: Generator, d: Discriminator, opt_cfg: OptimConfig,
                       training_ratio: int, device: torch.device,
                       seed: int, g_ema_decay: float = 0.0) -> GANTrainState:
  """Optimizers, the noise generator and (``g_ema_decay`` > 0) the EMA
  shadow around modules already on ``device``."""
  g_opt, g_sched = schedules.adam(
      g.parameters(), opt_cfg.generator_lr, opt_cfg.beta1, opt_cfg.beta2,
      opt_cfg.lr_decay_schedule, opt_cfg.total_outer_steps)
  d_opt, d_sched = schedules.adam(
      d.parameters(), opt_cfg.discriminator_lr, opt_cfg.beta1, opt_cfg.beta2,
      opt_cfg.lr_decay_schedule, opt_cfg.total_outer_steps * training_ratio)
  noise = torch.Generator(device=device).manual_seed(seed)
  return GANTrainState(g=g, d=d, g_opt=g_opt, d_opt=d_opt, g_sched=g_sched,
                       d_sched=d_sched, generator=noise,
                       g_ema=ema_copy(g) if g_ema_decay > 0.0 else None)


def create_state(g_cfg: GeneratorConfig, d_cfg: DiscriminatorConfig,
                 opt_cfg: OptimConfig, training_ratio: int,
                 device: torch.device, seed: int = 0,
                 g_ema_decay: float = 0.0,
                 group: mesh.Group = None) -> GANTrainState:
  """Random G and D from ``seed`` (initialized on the CPU, so the same seed
  gives the same weights on any device, and every rank of ``group`` the
  same state), placed on ``device``; their layers reduce over ``group``."""
  init = torch.Generator().manual_seed(seed)
  g = place(Generator(g_cfg, init, group), device)
  d = place(Discriminator(d_cfg, init, group), device)
  return state_from_modules(g, d, opt_cfg, training_ratio, device, seed + 1,
                            g_ema_decay)
