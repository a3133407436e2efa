"""Weights between the JAX package's flax trees and the port's modules.

flax keeps a model as nested dicts: ``params`` plus the mutable collections
(``wc_stats`` mean/cov of the WC layers, ``spectral`` u of the SN layers).
The port's modules use the same submodule names, so a leaf's path maps to
a ``state_dict`` key; only layouts differ:

- conv kernels: flax HWIO  <-> torch OIHW (``weight``);
- dense kernels: flax (in, out) <-> torch (out, in) (``weight``);
- everything else (NormColor gamma/beta, biases, wc_stats, u) as it is.

Both directions take and give numpy arrays, so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from wcgan_tpu_torch.device import place
from wcgan_tpu_torch.models.discriminator import (Discriminator,
                                                  DiscriminatorConfig)
from wcgan_tpu_torch.models.generator import Generator, GeneratorConfig

# flax collection <-> the buffer name it becomes in the port.
_COLLECTIONS = {"wc_stats": ("mean", "cov"), "spectral": ("u",)}


def _flatten(tree: Mapping[str, Any], prefix=()) -> Iterator[Tuple[tuple, Any]]:
  for k, v in tree.items():
    if isinstance(v, Mapping):
      yield from _flatten(v, prefix + (k,))
    else:
      yield prefix + (k,), v


def _kernel_to_torch(kernel: np.ndarray) -> np.ndarray:
  if kernel.ndim == 4:
    return kernel.transpose(3, 2, 0, 1)        # HWIO -> OIHW
  if kernel.ndim == 2:
    return kernel.T                            # (in, out) -> (out, in)
  raise ValueError(f"unexpected kernel rank {kernel.ndim}")


def _weight_to_jax(weight: np.ndarray) -> np.ndarray:
  if weight.ndim == 4:
    return weight.transpose(2, 3, 1, 0)        # OIHW -> HWIO
  if weight.ndim == 2:
    return weight.T
  raise ValueError(f"unexpected weight rank {weight.ndim}")


def state_dict_from_jax(params: Mapping[str, Any],
                        state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """A torch ``state_dict`` from one model's flax params and collections."""
  out = {}
  for path, leaf in _flatten(params):
    leaf = np.asarray(leaf, np.float32)
    if path[-1] == "kernel":
      path, leaf = path[:-1] + ("weight",), _kernel_to_torch(leaf)
    out[".".join(path)] = torch.from_numpy(np.array(leaf, copy=True))
  for coll, tree in state.items():
    if coll not in _COLLECTIONS:
      raise ValueError(f"flax collection {coll!r} has no counterpart in "
                       "the port")
    for path, leaf in _flatten(tree):
      out[".".join(path)] = torch.from_numpy(
          np.array(leaf, np.float32, copy=True))
  return out


def _nest(flat: Mapping[tuple, np.ndarray]) -> Dict[str, Any]:
  tree: Dict[str, Any] = {}
  for path, leaf in flat.items():
    node = tree
    for k in path[:-1]:
      node = node.setdefault(k, {})
    node[path[-1]] = leaf
  return tree


def params_to_jax(named: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
  """Parameter-shaped tensors (params, or an optimizer slot per param)
  keyed by parameter name -> a flax-layout params tree of numpy arrays."""
  flat = {}
  for name, t in named.items():
    path = tuple(name.split("."))
    arr = t.detach().float().cpu().numpy()
    if path[-1] == "weight":
      path, arr = path[:-1] + ("kernel",), _weight_to_jax(arr)
    flat[path] = np.ascontiguousarray(arr)
  return _nest(flat)


def to_jax(module: nn.Module) -> Tuple[Dict[str, Any], Dict[str, Any]]:
  """(params, collections) of a port module in the flax layout."""
  params = params_to_jax(dict(module.named_parameters()))
  colls: Dict[str, Dict[tuple, np.ndarray]] = {}
  for name, buf in module.named_buffers():
    path = tuple(name.split("."))
    coll = next(c for c, leaves in _COLLECTIONS.items() if path[-1] in leaves)
    colls.setdefault(coll, {})[path] = buf.detach().float().cpu().numpy()
  return params, {c: _nest(flat) for c, flat in colls.items()}


def from_jax(g_params, g_state, d_params, d_state, g_cfg: GeneratorConfig,
             d_cfg: DiscriminatorConfig, device="cpu"
             ) -> Tuple[Generator, Discriminator]:
  """(Generator, Discriminator) on ``device`` holding the flax weights.

  Every parameter and buffer must be covered (strict load)."""
  init = torch.Generator().manual_seed(0)   # overwritten below
  g = Generator(g_cfg, init)
  d = Discriminator(d_cfg, init)
  g.load_state_dict(state_dict_from_jax(g_params, g_state), strict=True)
  d.load_state_dict(state_dict_from_jax(d_params, d_state), strict=True)
  return place(g, device), place(d, device)
