"""The layers of a configuration, from its file alone.

A configuration file (``wcbench/configs/<name>.json``) states the
generator and discriminator of a WC-GAN (Siarohin et al., ICLR 2019) by
their published widths. This module lays them out as lists of layers with
the shapes one forward at batch ``n`` sees. The work counts
(``counts.py``) and the plain reference (``reference/wcgan.py``) both
read these lists, so the two agree on what the model is.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class Conv:
  """A 'SAME' stride-1 convolution at ``size`` x ``size``."""

  name: str
  cin: int
  cout: int
  k: int
  size: int
  spectral: bool = False
  image_input: bool = False     # reads the images (no input gradient)


@dataclasses.dataclass(frozen=True)
class WC:
  """A whitening-and-coloring layer over ``c`` channels at ``size`` x
  ``size`` (rows per image S = size**2)."""

  name: str
  c: int
  size: int
  coloring: str                 # 'uconv' | 'ucconv-sa'


def g_layers(cfg: dict) -> List[object]:
  """The generator's convolutions and WC layers in forward order, with
  ``fc_in`` first as a 1 x 1 'Conv' over the z vector (size 1)."""
  g = cfg["generator"]
  filters = list(g["filters"])
  size = g["base_resolution"]
  out: List[object] = [Conv("fc_in", cfg["z_dim"], size * size * filters[0],
                            1, 1)]
  cin = filters[0]
  for i, f in enumerate(filters):
    out.append(WC(f"block{i}.nc1", cin, size, g["block_coloring"]))
    size *= 2
    out.append(Conv(f"block{i}.conv1", cin, f, 3, size))
    out.append(WC(f"block{i}.nc2", f, size, g["block_coloring"]))
    out.append(Conv(f"block{i}.conv2", f, f, 3, size))
    out.append(Conv(f"block{i}.conv_sc", cin, f, 1, size))
    cin = f
  out.append(WC("nc_out", cin, size, g["last_coloring"]))
  out.append(Conv("conv_out", cin, 3, 3, size))
  return out


def d_layers(cfg: dict) -> List[Conv]:
  """The discriminator's spectral-normalized convolutions in forward
  order (a res D with no WC layers), then ``fc_out`` as a 1 x 1 'Conv'
  over the pooled features (size 1)."""
  d = cfg["discriminator"]
  filters, down = list(d["filters"]), list(d["downsample"])
  size = cfg["resolution"]
  out = [Conv("block0.conv1", 3, filters[0], 3, size, True, True),
         Conv("block0.conv2", filters[0], filters[0], 3, size, True),
         Conv("block0.conv_sc", 3, filters[0], 1, size // 2, True, True)]
  size //= 2
  for i in range(1, len(filters)):
    cin, f = filters[i - 1], filters[i]
    out.append(Conv(f"block{i}.conv1", cin, f, 3, size, True))
    out.append(Conv(f"block{i}.conv2", f, f, 3, size, True))
    if down[i] or cin != f:
      # The shortcut's conv runs before the pool.
      out.append(Conv(f"block{i}.conv_sc", cin, f, 1, size, True))
    if down[i]:
      size //= 2
  out.append(Conv("fc_out", filters[-1], 1, 1, 1, True))
  return out


def d_features(cfg: dict) -> int:
  return cfg["discriminator"]["filters"][-1]


def num_classes(cfg: dict) -> int:
  return cfg["gan"].get("num_classes", 0)


def projection(cfg: dict) -> bool:
  return bool(cfg["discriminator"].get("projection"))


def wc_layers(cfg: dict) -> List[WC]:
  return [l for l in g_layers(cfg) if isinstance(l, WC)]
