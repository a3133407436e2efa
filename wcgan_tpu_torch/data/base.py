"""Dataset base: epoch iteration, z/test-batch conventions.

The port's own copy of ``wcgan_tpu/data/base.py`` (numpy only; it behaves
exactly as the original, tests/test_torch_imports.py compares them):
shuffled batch iteration, ``number_of_batches_per_epoch``, and a
**fixed-seed test batch** so sample grids are comparable across epochs.

- Batches are served as **uint8** host arrays, ``training_ratio`` batches
  at a time: one host-to-device transfer per outer step, 4x smaller than
  float32. Normalization to [-1, 1] and the random horizontal flip run on
  the device inside the outer step.
- z is NOT sampled here; the train step draws z on the device. Only the
  fixed z for test grids lives here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class ArrayDataset:
  """In-memory uint8 image dataset with shuffled epoch iteration."""

  def __init__(self, images: np.ndarray, labels: Optional[np.ndarray],
               batch_size: int, num_classes: int = 0, seed: int = 0,
               z_dim: int = 128):
    if images.dtype != np.uint8:
      raise ValueError(f"images must be uint8, got {images.dtype}")
    if images.ndim != 4:
      raise ValueError(f"images must be NHWC, got shape {images.shape}")
    if labels is not None and len(labels) != len(images):
      # Fail at construction, not epochs later with an opaque IndexError
      # (or, for labels LONGER than images, silent misalignment).
      raise ValueError(f"labels length {len(labels)} != images length "
                       f"{len(images)}")
    self.images = images
    self.labels = (labels.astype(np.int32)
                   if labels is not None else None)
    self.batch_size = batch_size
    self.num_classes = num_classes
    self.z_dim = z_dim
    self._rng = np.random.default_rng(seed)
    self._test_rng_seed = seed + 1
    self._order = self._rng.permutation(len(images))
    self._pos = 0

  @property
  def resolution(self) -> int:
    return self.images.shape[1]

  @property
  def channels(self) -> int:
    return self.images.shape[-1]

  @property
  def image_shape(self) -> Tuple[int, int, int]:
    return tuple(self.images.shape[1:])

  @property
  def number_of_batches_per_epoch(self) -> int:
    return len(self.images) // self.batch_size

  def _next_indices(self, n: int) -> np.ndarray:
    out = []
    while n > 0:
      take = min(n, len(self._order) - self._pos)
      out.append(self._order[self._pos:self._pos + take])
      self._pos += take
      n -= take
      if self._pos >= len(self._order):
        self._order = self._rng.permutation(len(self.images))
        self._pos = 0
    return np.concatenate(out)

  def next_batches(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(k, B, H, W, C) uint8 images + (k, B) int32 labels (zeros if
    unlabeled) — one fused outer step's worth of real data."""
    idx = self._next_indices(k * self.batch_size)
    imgs = self.images[idx].reshape((k, self.batch_size) + self.image_shape)
    if self.labels is not None:
      labels = self.labels[idx].reshape(k, self.batch_size)
    else:
      labels = np.zeros((k, self.batch_size), np.int32)
    return imgs, labels

  def test_batch(self, n: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-seed (z, labels) for stable sample grids across epochs —
    the reference's ``next_generator_sample_test`` semantics [U]."""
    rng = np.random.default_rng(self._test_rng_seed)
    z = rng.standard_normal((n, self.z_dim)).astype(np.float32)
    if self.num_classes > 0:
      labels = np.arange(n, dtype=np.int32) % self.num_classes
    else:
      labels = np.zeros((n,), np.int32)
    return z, labels

  def real_sample(self, n: int) -> np.ndarray:
    """A deterministic slice of real images (FID reference set etc.)."""
    rng = np.random.default_rng(self._test_rng_seed + 1)
    idx = rng.choice(len(self.images), size=min(n, len(self.images)),
                     replace=False)
    return self.images[idx]
