"""Image grid assembly + PNG writing.

The port's own copy of ``wcgan_tpu/utils/images.py`` (numpy and PIL only;
the same bytes as the original, tests/test_torch_imports.py compares
them): tile a batch of generated images row-major into one uint8 image
per epoch for eyeball validation."""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np


def to_uint8(images: np.ndarray) -> np.ndarray:
  """[-1, 1] float images -> uint8 (the reference's de-normalization [U])."""
  images = np.asarray(images)
  if images.dtype == np.uint8:
    return images
  return (np.clip(images, -1.0, 1.0) * 127.5 + 127.5).astype(np.uint8)


def make_grid(images: np.ndarray, cols: Optional[int] = None,
              pad: int = 0) -> np.ndarray:
  """Tile (N, H, W, C) into a row-major grid (uint8 in, uint8 out)."""
  images = to_uint8(images)
  n, h, w, c = images.shape
  cols = cols or int(math.ceil(math.sqrt(n)))
  rows = int(math.ceil(n / cols))
  grid = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad, c),
                  np.uint8)
  for i in range(n):
    r, col = divmod(i, cols)
    grid[r * (h + pad):r * (h + pad) + h,
         col * (w + pad):col * (w + pad) + w] = images[i]
  return grid


def save_png(path: str, image: np.ndarray) -> None:
  from PIL import Image
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  if image.shape[-1] == 1:
    image = image[..., 0]
  Image.fromarray(image).save(path)
