"""Learning-rate decay schedules and the GAN Adam.

Counterpart of ``wcgan_tpu/train/schedules.py``. The reference's optax
schedules become factors of the base LR, evaluated at the optimizer's
update count t (0 for the first update), total T:

  none        1
  linear      1 - t/T                      (decay to 0 over the run)
  half-linear 1 for t < T//2;   then linear from 1 to 0 over the rest
  linear-end  1 for t < 0.9 T;  then linear from 1 to 0 over the rest

``lr_factor`` is the factor on the host; ``lr_factor_tensor`` is the same
factor of a count that lives on the device. The optimizer's LR is a 0-d
tensor on the parameters' device that ``LRSchedule.step`` rewrites in
place from its device count, so a step captured as a CUDA graph advances
the LR on every replay (a host-side scheduler would freeze it at the
captured value).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch


def _knee(name: str, total: int) -> int:
  """The update count where the linear decay starts, for ``name``."""
  if name == "linear":
    return 0
  if name == "half-linear":
    return total // 2
  if name == "linear-end":
    return int(total * 0.9)
  raise ValueError(f"unknown lr schedule {name!r}")


def _constant(name) -> bool:
  return name in (None, "none", "")


def lr_factor(name: str, total_steps: int) -> Callable[[int], float]:
  """The schedule as a factor of the base LR at update count t."""
  total = max(int(total_steps), 1)
  if _constant(name):
    return lambda t: 1.0
  knee = _knee(name, total)
  span = total - knee

  def factor(t: int) -> float:
    if t < knee:
      return 1.0
    return 1.0 - min(t - knee, span) / span

  return factor


def lr_factor_tensor(name: str, total_steps: int
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
  """``lr_factor`` of a 0-d integer count tensor, as a float32 tensor on
  its device, without reading the count on the host."""
  total = max(int(total_steps), 1)
  if _constant(name):
    return lambda t: torch.ones((), dtype=torch.float32, device=t.device)
  knee = _knee(name, total)
  span = total - knee

  def factor(t: torch.Tensor) -> torch.Tensor:
    done = torch.clamp(t - knee, min=0, max=span).to(torch.float32)
    return 1.0 - done / span

  return factor


class LRSchedule:
  """The LR of one optimizer, ``base_lr`` x ``lr_factor_tensor`` of its
  update count, held in the optimizer's LR tensor (``lr``). ``step()``
  after each optimizer step advances the count and rewrites the LR, all
  on the device. ``last_epoch`` and the state dict's key are
  ``LambdaLR``'s, so a checkpoint of either loads into the other's
  count."""

  def __init__(self, opt: torch.optim.Optimizer, name: str,
               total_steps: int, base_lr: float):
    self.lr = opt.param_groups[0]["lr"]
    if not torch.is_tensor(self.lr):
      raise TypeError("LRSchedule needs an optimizer whose LR is a tensor")
    self.base_lr = float(base_lr)
    self.factor = lr_factor_tensor(name, total_steps)
    self.count = torch.zeros((), dtype=torch.int64, device=self.lr.device)
    self._write()

  def _write(self) -> None:
    with torch.no_grad():
      self.lr.copy_(self.base_lr * self.factor(self.count))

  def step(self) -> None:
    with torch.no_grad():
      self.count.add_(1)
    self._write()

  @property
  def last_epoch(self) -> int:
    """The update count (reads the device)."""
    return int(self.count)

  def state_dict(self) -> Dict[str, int]:
    return {"last_epoch": self.last_epoch}

  def load_state_dict(self, state: Dict) -> None:
    with torch.no_grad():
      self.count.fill_(int(state["last_epoch"]))
    self._write()


# Settings of a live Adam's groups that a loaded state dict must not
# replace: its LR tensor (the schedule writes into it) and how it runs.
_LIVE_GROUP_KEYS = ("lr", "capturable", "foreach", "fused", "differentiable")


def load_adam(opt: torch.optim.Adam, state: Dict) -> None:
  """Load an Adam state dict into ``opt``, from either kind of Adam: the
  slots and counts come from ``state``, and ``opt`` keeps its LR tensor and
  its ``capturable`` setting, with each ``step`` count where that setting
  wants it (on the parameter's device when capturable, else on the CPU).
  The slots are ``state``'s moved to the parameters' device, the same
  tensors where they are there already: pass a copy of a live optimizer's
  state dict to keep the two apart."""
  live = [{k: g[k] for k in _LIVE_GROUP_KEYS if k in g}
          for g in opt.param_groups]
  opt.load_state_dict(state)
  for group, keep in zip(opt.param_groups, live):
    group.update(keep)
    for p in group["params"]:
      slots = opt.state.get(p)
      if slots and "step" in slots:
        dev = p.device if group.get("capturable") else torch.device("cpu")
        slots["step"] = slots["step"].to(dtype=torch.float32, device=dev)


def adam(params: Iterable[torch.nn.Parameter], base_lr: float,
         beta1: float = 0.0, beta2: float = 0.9, schedule: str = "none",
         total_steps: int = 1) -> Tuple[torch.optim.Adam, LRSchedule]:
  """Adam with the reference's GAN defaults (lr 2e-4, betas (0, 0.9)) and
  its LR schedule; step the schedule once per optimizer step.

  eps=1e-8 is added after the square root of the bias-corrected second
  moment, as optax's adam does. The LR is a tensor on the parameters'
  device. On CUDA the Adam is ``capturable`` (its step counts live on the
  card and nothing reads them on the host), so that a CUDA graph can
  capture its step; on the CPU it runs the single-tensor loop, the one
  that takes a tensor LR there."""
  params = list(params)
  dev = params[0].device
  lr = torch.tensor(float(base_lr), dtype=torch.float32, device=dev)
  on_cuda = dev.type == "cuda"
  opt = torch.optim.Adam(params, lr=lr, betas=(beta1, beta2), eps=1e-8,
                         capturable=on_cuda, foreach=on_cuda)
  return opt, LRSchedule(opt, schedule, total_steps, base_lr)
