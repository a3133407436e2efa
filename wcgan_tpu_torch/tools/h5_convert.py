"""Checkpoint key renames and Keras .h5 <-> npz conversion.

The port's own copy of ``wcgan_tpu/tools/h5_convert.py`` (numpy only;
h5py is imported when a ``.h5`` is read or written). It behaves exactly as
the original; tests/test_torch_imports.py compares them.

- ``h5_to_npz``: flatten any Keras-weights .h5 into a flat npz
  (``<layer>/<weight_name>`` keys), optionally renamed by a key-map table
  (:func:`apply_key_map`);
- ``npz_to_h5``: write a weights-only npz into a Keras-style .h5 tree.

Usage:
  python -m wcgan_tpu_torch.tools.h5_convert to_npz  in.h5  out.npz [map.json]
  python -m wcgan_tpu_torch.tools.h5_convert to_h5   in.npz out.h5
"""

from __future__ import annotations

import json
import re
import sys
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


def h5_to_npz(h5_path: str, npz_path: str,
              key_map: Optional[Dict[str, str]] = None) -> Dict[str, tuple]:
  """Flatten an .h5 weight file to npz; returns {key: shape} manifest."""
  out = h5_flat(h5_path, key_map)
  np.savez(npz_path, **out)
  return {k: v.shape for k, v in out.items()}


def npz_to_h5(npz_path: str, h5_path: str) -> None:
  import h5py
  data = dict(np.load(npz_path))
  with h5py.File(h5_path, "w") as f:
    for key, val in data.items():
      f.create_dataset(key, data=val)


def main(argv) -> int:
  if len(argv) < 3:
    print(__doc__)
    return 2
  cmd, src, dst = argv[0], argv[1], argv[2]
  if cmd == "to_npz":
    key_map = None
    if len(argv) > 3:
      with open(argv[3]) as f:
        key_map = json.load(f)
    manifest = h5_to_npz(src, dst, key_map)
    for k, shape in sorted(manifest.items()):
      print(k, shape)
  elif cmd == "to_h5":
    npz_to_h5(src, dst)
  else:
    print(f"unknown command {cmd!r}")
    return 2
  return 0


if __name__ == "__main__":
  raise SystemExit(main(sys.argv[1:]))
