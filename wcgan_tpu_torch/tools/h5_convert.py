"""Checkpoint key renames and Keras .h5 flattening for the weight loader.

The port's own copy of the two functions of ``wcgan_tpu/tools/h5_convert.py``
that ``python -m wcgan_tpu_torch`` calls (numpy only; h5py is imported
when a ``.h5`` is read). They behave exactly as the originals;
tests/test_torch_imports.py compares them.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np


def apply_key_map(flat: Dict[str, np.ndarray],
                  key_map: Optional[Dict[str, str]]
                  ) -> Dict[str, np.ndarray]:
  """Rename flat checkpoint keys per a --checkpoint_key_map-style table.

  Exact entries ({src: dst}) win; entries whose source starts with ``re:``
  are ``re.sub`` rules applied in table order to every key without an
  exact entry. Destination collisions raise: last-write-wins would be a
  silent wrong-weights load."""
  if not key_map:
    return dict(flat)
  exact = {k: v for k, v in key_map.items() if not k.startswith("re:")}
  regex = [(re.compile(k[3:]), v) for k, v in key_map.items()
           if k.startswith("re:")]
  renamed = {}
  for k, v in flat.items():
    dst = exact.get(k)
    if dst is None:
      dst = k
      for pat, repl in regex:
        dst = pat.sub(repl, dst)
    if dst in renamed:
      raise ValueError(f"duplicate destination key {dst!r} (from source "
                       f"{k!r}) — fix the key_map collision")
    renamed[dst] = v
  return renamed


def h5_flat(h5_path: str,
            key_map: Optional[Dict[str, str]] = None
            ) -> Dict[str, np.ndarray]:
  """Flatten an .h5 weight file to a {key: array} dict in memory
  (``<layer>/<weight_name>`` keys), renamed by :func:`apply_key_map`."""
  import h5py
  out = {}

  def visit(name, obj):
    if isinstance(obj, h5py.Dataset):
      out[name] = np.asarray(obj)

  with h5py.File(h5_path, "r") as f:
    f.visititems(visit)
  return apply_key_map(out, key_map)
