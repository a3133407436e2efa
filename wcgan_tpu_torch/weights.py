"""Weights between the JAX package's flax trees and the port's modules.

flax keeps a model as nested dicts: ``params`` plus the mutable collections
(``wc_stats`` mean/cov of the WC layers, ``batch_stats`` mean/var of the
BatchNorms, ``spectral`` u or u_map of the SN layers). The port's modules
use the same submodule names, so a leaf's path maps to a ``state_dict``
key; only layouts differ:

- conv kernels: flax HWIO  <-> torch OIHW (``weight``);
- transposed-conv kernels (the DCGAN G's ``deconv``): flax HWIO <-> torch
  (I, O, H, W) with both spatial dims flipped, as
  ``layers.ConvTranspose`` applies them;
- dense kernels: flax (in, out) <-> torch (out, in) (``weight``);
- ``conv_singular``'s ``u_map``: flax NHWC (1, H, W, C) <-> NCHW;
- everything else as it is: NormColor's gamma/beta and its conditional
  leaves (gamma_a, beta_a, gamma_c, beta_c, basis, embedding), biases,
  projection-D's ``proj_emb/embedding`` (num_classes, features) and its
  ``u``, wc_stats and batch_stats (a BatchNorm sits in ``.../norm/bn``).
  A plain D's convs and dense layers sit one level down
  (``conv1/conv/kernel``, ``fc_out/dense/kernel``), as flax nests them.

Both directions take and give numpy arrays, so this module needs no JAX.
``inception_from_jax`` moves the JAX package's InceptionV3 variables into
torchvision's ``state_dict`` layout (``evaluation/inception_v3.py``), and
``judge_from_flax`` the digits judge's (``tools/eval_digits_fid.py``).

``export_npz`` and ``load_npz`` read and write the JAX package's
weights-only npz (``Trainer.export_weights``, ``--generator_checkpoint``):
params only, in the flax layout, keyed by the string that
``"/".join(map(str, keypath))`` makes of a ``jax.tree_util`` key path,
e.g. ``['block0']/['nc1']/['gamma']``. A file written by either package
loads in the other.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from wcgan_tpu_torch.device import place
from wcgan_tpu_torch.models.discriminator import (Discriminator,
                                                  DiscriminatorConfig)
from wcgan_tpu_torch.models.generator import Generator, GeneratorConfig

# flax collection <-> the buffer names it becomes in the port.
_COLLECTIONS = {"wc_stats": ("mean", "cov"), "batch_stats": ("mean", "var"),
                "spectral": ("u", "u_map")}
# The module name of a transposed conv (flax's name in DCGANGenBlock).
_DECONV = "deconv"


def _flatten(tree: Mapping[str, Any], prefix=()) -> Iterator[Tuple[tuple, Any]]:
  for k, v in tree.items():
    if isinstance(v, Mapping):
      yield from _flatten(v, prefix + (k,))
    else:
      yield prefix + (k,), v


def _kernel_to_torch(kernel: np.ndarray, path: tuple = ()) -> np.ndarray:
  if kernel.ndim == 4 and _DECONV in path[-2:-1]:
    # HWIO -> (I, O, H, W), flipped in H and W
    return kernel.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
  if kernel.ndim == 4:
    return kernel.transpose(3, 2, 0, 1)        # HWIO -> OIHW
  if kernel.ndim == 2:
    return kernel.T                            # (in, out) -> (out, in)
  raise ValueError(f"unexpected kernel rank {kernel.ndim}")


def _weight_to_jax(weight: np.ndarray, path: tuple = ()) -> np.ndarray:
  if weight.ndim == 4 and _DECONV in path[-2:-1]:
    return weight[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
  if weight.ndim == 4:
    return weight.transpose(2, 3, 1, 0)        # OIHW -> HWIO
  if weight.ndim == 2:
    return weight.T
  raise ValueError(f"unexpected weight rank {weight.ndim}")


def _collection(path: tuple) -> str:
  """The flax collection of a port buffer: a BatchNorm's (module ``bn``)
  statistics are ``batch_stats``, the rest goes by the buffer's name."""
  if path[-2:-1] == ("bn",):
    return "batch_stats"
  return next(c for c, leaves in _COLLECTIONS.items() if path[-1] in leaves)


def state_dict_from_jax(params: Mapping[str, Any],
                        state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """A torch ``state_dict`` from one model's flax params and collections."""
  out = {}
  for path, leaf in _flatten(params):
    leaf = np.asarray(leaf, np.float32)
    if path[-1] == "kernel":
      path, leaf = path[:-1] + ("weight",), _kernel_to_torch(leaf, path)
    out[".".join(path)] = torch.from_numpy(np.array(leaf, copy=True))
  for coll, tree in state.items():
    if coll not in _COLLECTIONS:
      raise ValueError(f"flax collection {coll!r} has no counterpart in "
                       "the port")
    for path, leaf in _flatten(tree):
      leaf = np.asarray(leaf, np.float32)
      if path[-1] == "u_map":
        leaf = leaf.transpose(0, 3, 1, 2)      # NHWC -> NCHW
      out[".".join(path)] = torch.from_numpy(np.array(leaf, copy=True))
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
      path, arr = path[:-1] + ("kernel",), _weight_to_jax(arr, path)
    flat[path] = np.ascontiguousarray(arr)
  return _nest(flat)


def to_jax(module: nn.Module) -> Tuple[Dict[str, Any], Dict[str, Any]]:
  """(params, collections) of a port module in the flax layout."""
  params = params_to_jax(dict(module.named_parameters()))
  colls: Dict[str, Dict[tuple, np.ndarray]] = {}
  for name, buf in module.named_buffers():
    path = tuple(name.split("."))
    arr = buf.detach().float().cpu().numpy()
    if path[-1] == "u_map":
      arr = np.ascontiguousarray(arr.transpose(0, 2, 3, 1))   # NCHW -> NHWC
    colls.setdefault(_collection(path), {})[path] = arr
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


def _npz_key(path: tuple) -> str:
  """A flax params path as the JAX package's npz key (``str`` of each
  ``jax.tree_util.DictKey``, joined by '/')."""
  return "/".join(f"[{k!r}]" for k in path)


def export_npz(module: nn.Module) -> Dict[str, np.ndarray]:
  """A port module's parameters as the JAX package's weights-only npz
  entries: {key: float32 array in the flax layout}."""
  return {_npz_key(path): leaf for path, leaf in
          _flatten(params_to_jax(dict(module.named_parameters())))}


def load_npz(module: nn.Module, loaded: Mapping[str, np.ndarray],
             missing: str = "error", source: str = "<npz>",
             model: Optional[str] = None,
             log: Optional[Callable[[str], None]] = None) -> None:
  """Copy npz entries (JAX package keys and layouts) into ``module``'s
  parameters, as the JAX CLI's ``_load_weights_npz`` substitutes them.

  A parameter absent from ``loaded`` raises a KeyError, or with
  ``missing='init'`` keeps its value and is listed (with the entries left
  unused) through ``log``. A shape that differs raises a ValueError.
  Nothing is copied unless every parameter checks out. Buffers
  (``wc_stats``, ``batch_stats``, SN ``u``/``u_map``) are not in the
  format and stay as they are."""
  if missing not in ("error", "init"):
    raise ValueError(f"missing must be 'error' or 'init', got {missing!r}")
  named = dict(module.named_parameters())
  updates, used, kept = {}, set(), []
  for path, leaf in _flatten(params_to_jax(named)):
    key = _npz_key(path)
    if key not in loaded:
      if missing == "init":
        kept.append(key)
        continue
      raise KeyError(
          f"checkpoint {source} missing {key} (pass --checkpoint_missing "
          f"init to keep absent params at their initialization)")
    used.add(key)
    arr = np.asarray(loaded[key])
    if arr.shape != leaf.shape:
      raise ValueError(f"{key}: shape {arr.shape} != {leaf.shape}")
    if path[-1] == "kernel":
      path, arr = path[:-1] + ("weight",), _kernel_to_torch(arr, path)
    updates[".".join(path)] = torch.from_numpy(np.array(arr, np.float32))
  with torch.no_grad():
    for name, value in updates.items():
      named[name].copy_(value)
  if kept:
    emit = log or print
    emit(f"checkpoint_missing=init: {len(kept)} {model or 'model'} "
         f"param(s) not in {source}, kept at init: {sorted(kept)}")
    unused = sorted(set(loaded) - used)
    if unused:
      emit(f"  ({len(unused)} checkpoint key(s) unused: {unused})")


# flax BatchNorm leaf -> torchvision's name for it.
_BN_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}


def inception_from_jax(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
  """The JAX package's InceptionV3 variables (``params`` and
  ``batch_stats``, numpy) as a torchvision ``inception_v3`` state_dict of
  numpy arrays, the input of ``evaluation.inception_v3.load_state``: conv
  kernels HWIO -> OIHW, BatchNorm scale/bias/mean/var -> weight, bias,
  running_mean, running_var, the ``fc`` kernel transposed."""
  out = {}
  for coll in ("params", "batch_stats"):
    for path, leaf in _flatten(variables[coll]):
      leaf = np.asarray(leaf, np.float32)
      if path[-1] == "kernel":
        path, leaf = path[:-1] + ("weight",), _kernel_to_torch(leaf, path)
      elif path[-2:-1] == ("bn",):
        path = path[:-1] + (_BN_NAMES[path[-1]],)
      out[".".join(path)] = np.ascontiguousarray(leaf)
  return out


def judge_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
  """The digits judge's flax params (``Conv_0``, ``Conv_1``, ``Dense_0``,
  ``Dense_1``, each a kernel and a bias; numpy; with or without the
  ``params`` level) as the ``state_dict`` of
  ``tools.eval_digits_fid.Judge``, whose submodules carry flax's names:
  conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in)."""
  params = params.get("params", params)
  out = {}
  for path, leaf in _flatten(params):
    leaf = np.asarray(leaf, np.float32)
    if path[-1] == "kernel":
      path, leaf = path[:-1] + ("weight",), _kernel_to_torch(leaf, path)
    out[".".join(path)] = torch.tensor(leaf)
  return out
