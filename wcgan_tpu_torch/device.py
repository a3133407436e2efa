"""Device selection for the port: what was asked for, or an error."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
  """``"cuda"`` (or ``"cuda:N"``) or ``"cpu"`` as a ``torch.device``.

  Asking for CUDA where PyTorch sees no GPU raises: a run never moves to
  the CPU behind its caller's back."""
  dev = torch.device(name)
  if dev.type == "cuda":
    if not torch.cuda.is_available():
      raise RuntimeError(f"device {name!r} requested but torch sees no CUDA "
                         "GPU (torch.cuda.is_available() is False)")
    if dev.index is not None and dev.index >= torch.cuda.device_count():
      raise RuntimeError(f"device {name!r} requested but only "
                         f"{torch.cuda.device_count()} CUDA device(s) exist")
  elif dev.type != "cpu":
    raise ValueError(f"unsupported device {name!r}; use 'cuda' or 'cpu'")
  return dev


def place(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
  """Move ``module`` to ``device`` with its 4-D weights in channels_last,
  the layout of the port's activations."""
  return module.to(device=device, memory_format=torch.channels_last)
