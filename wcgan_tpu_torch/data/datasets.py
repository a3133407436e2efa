"""Concrete dataset loaders (local archives only).

The port's own copy of ``wcgan_tpu/data/datasets.py`` (numpy only; it
gives the same arrays as the original, tests/test_torch_imports.py
compares them): cifar10 / cifar100 / stl10 / tiny-imagenet / imagenet64 /
mnist / fashion-mnist, plus ``synthetic`` for smoke tests. The loaders
read the canonical archive layouts from ``data_dir``:

  cifar10        data_dir/cifar-10-batches-py/data_batch_{1..5}
  cifar100       data_dir/cifar-100-python/train
  stl10          data_dir/stl10_binary/{unlabeled_X.bin,train_X.bin,train_y.bin}
  tiny-imagenet  data_dir/tiny-imagenet-200/train/<wnid>/images/*.JPEG
  imagenet64     data_dir/imagenet64/train_data_batch_{1..10}.npz
                 (the "Downsampled ImageNet" npz format: data (N,12288) + labels)
  mnist          data_dir/mnist/{train-images-idx3-ubyte(.gz),train-labels-idx1-ubyte(.gz)}
  fashion-mnist  data_dir/fashion-mnist/... (same idx layout)

All loaders return uint8 NHWC arrays; expensive decodes (STL resize,
Tiny-ImageNet JPEG) cache an ``.npz`` next to the archive.
"""

from __future__ import annotations

import glob
import gzip
import os
import pickle
from typing import Optional, Tuple

import numpy as np

from wcgan_tpu_torch.data.base import ArrayDataset


def _unpickle(path):
  with open(path, "rb") as f:
    return pickle.load(f, encoding="bytes")


def _load_cifar10(data_dir: str) -> Tuple[np.ndarray, np.ndarray]:
  root = os.path.join(data_dir, "cifar-10-batches-py")
  imgs, labels = [], []
  for i in range(1, 6):
    d = _unpickle(os.path.join(root, f"data_batch_{i}"))
    imgs.append(d[b"data"])
    labels.extend(d[b"labels"])
  x = np.concatenate(imgs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
  return np.ascontiguousarray(x), np.asarray(labels, np.int32)


def _load_cifar100(data_dir: str) -> Tuple[np.ndarray, np.ndarray]:
  d = _unpickle(os.path.join(data_dir, "cifar-100-python", "train"))
  x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
  return np.ascontiguousarray(x), np.asarray(d[b"fine_labels"], np.int32)


def _open_maybe_gz(path):
  if os.path.exists(path):
    return open(path, "rb")
  if os.path.exists(path + ".gz"):
    return gzip.open(path + ".gz", "rb")
  raise FileNotFoundError(path)


def _load_idx_images(path) -> np.ndarray:
  with _open_maybe_gz(path) as f:
    data = f.read()
  n = int.from_bytes(data[4:8], "big")
  h = int.from_bytes(data[8:12], "big")
  w = int.from_bytes(data[12:16], "big")
  return np.frombuffer(data, np.uint8, offset=16).reshape(n, h, w, 1)


def _load_idx_labels(path) -> np.ndarray:
  with _open_maybe_gz(path) as f:
    data = f.read()
  return np.frombuffer(data, np.uint8, offset=8).astype(np.int32)


def _load_mnist_like(data_dir: str, sub: str):
  root = os.path.join(data_dir, sub)
  x = _load_idx_images(os.path.join(root, "train-images-idx3-ubyte"))
  y = _load_idx_labels(os.path.join(root, "train-labels-idx1-ubyte"))
  # Pad 28->32 so the standard base4 x 2^3 generator applies (the
  # reference trains MNIST through the same DCGAN path [U]).
  x = np.pad(x, ((0, 0), (2, 2), (2, 2), (0, 0)))
  return x, y


def _resize_batch_u8(x: np.ndarray, size: int) -> np.ndarray:
  """PIL-based batched resize (host-side, cached by callers)."""
  from PIL import Image
  out = np.empty((x.shape[0], size, size, x.shape[-1]), np.uint8)
  for i in range(x.shape[0]):
    out[i] = np.asarray(
        Image.fromarray(x[i]).resize((size, size), Image.BILINEAR))
  return out


def _load_stl10(data_dir: str, conditional: bool):
  root = os.path.join(data_dir, "stl10_binary")
  # Split-specific caches: the conditional (labeled train) and
  # unconditional (100k unlabeled) runs read DIFFERENT archives; a shared
  # cache file would serve whichever split was decoded first to both.
  split = "train" if conditional else "unlabeled"
  cache = os.path.join(root, f"stl48_{split}_cache.npz")
  if os.path.exists(cache):
    d = np.load(cache)
    if conditional and "y" not in d:
      raise ValueError(f"{cache} has no labels but a conditional STL-10 "
                       "run needs the labeled train split; delete the "
                       "stale cache")
    return d["x"], (d["y"] if "y" in d else None)
  if conditional:
    x = np.fromfile(os.path.join(root, "train_X.bin"), np.uint8)
    y = np.fromfile(os.path.join(root, "train_y.bin"), np.uint8
                    ).astype(np.int32) - 1
  else:
    # The unconditional runs use the 100k unlabeled split (paper §5 [U]).
    x = np.fromfile(os.path.join(root, "unlabeled_X.bin"), np.uint8)
    y = None
  x = x.reshape(-1, 3, 96, 96).transpose(0, 3, 2, 1)  # column-major per STL
  x = _resize_batch_u8(np.ascontiguousarray(x), 48)
  np.savez(cache, x=x, **({"y": y} if y is not None else {}))
  return x, y


def _load_tiny_imagenet(data_dir: str):
  root = os.path.join(data_dir, "tiny-imagenet-200")
  cache = os.path.join(root, "tiny64_cache.npz")
  if os.path.exists(cache):
    d = np.load(cache)
    return d["x"], d["y"]
  from PIL import Image
  wnids = sorted(os.listdir(os.path.join(root, "train")))
  imgs, labels = [], []
  for cls, wnid in enumerate(wnids):
    for p in sorted(glob.glob(
        os.path.join(root, "train", wnid, "images", "*.JPEG"))):
      im = Image.open(p).convert("RGB")
      imgs.append(np.asarray(im, np.uint8))
      labels.append(cls)
  x = np.stack(imgs)
  y = np.asarray(labels, np.int32)
  np.savez(cache, x=x, y=y)
  return x, y


def _load_imagenet64(data_dir: str):
  root = os.path.join(data_dir, "imagenet64")
  paths = sorted(glob.glob(os.path.join(root, "train_data_batch_*")))
  if not paths:
    raise FileNotFoundError(
        f"no imagenet64 batches under {root} (expected the Downsampled "
        "ImageNet train_data_batch_* files, npz or pickle)")
  xs, ys = [], []
  for p in paths:
    if p.endswith(".npz"):
      d = np.load(p)
      data, labels = d["data"], d["labels"]
    else:
      d = _unpickle(p)
      data, labels = d[b"data"], d[b"labels"]
    xs.append(np.asarray(data, np.uint8))
    ys.append(np.asarray(labels, np.int32) - 1)  # 1-indexed in the archive
  x = np.concatenate(xs).reshape(-1, 3, 64, 64).transpose(0, 2, 3, 1)
  return np.ascontiguousarray(x), np.concatenate(ys)


def _synthetic(resolution: int, num_classes: int, n: int = 4096,
               channels: int = 3, seed: int = 0):
  """Class-structured random images on a continuous manifold.

  Each sample is a sum of sinusoidal plane waves with per-sample random
  orientation/phase/amplitude (class sets the base frequency band), plus
  per-channel gain — a smooth, non-degenerate distribution. A finite set
  of fixed patterns (the obvious alternative) is trivially memorizable by
  D and makes every GAN look broken. No files needed; backs smoke tests
  and benches."""
  rng = np.random.default_rng(seed)
  k = max(num_classes, 1)
  y = rng.integers(0, k, size=n).astype(np.int32)
  yy, xx = np.mgrid[0:resolution, 0:resolution] / resolution
  waves = 3
  freq = 1.0 + y[:, None] + rng.uniform(0, 1, (n, waves))  # class band
  theta = rng.uniform(0, np.pi, (n, waves))
  phase = rng.uniform(0, 2 * np.pi, (n, waves))
  amp = rng.uniform(0.2, 0.6, (n, waves))
  img = np.zeros((n, resolution, resolution), np.float32)
  for w in range(waves):
    kx = freq[:, w] * np.cos(theta[:, w])
    ky = freq[:, w] * np.sin(theta[:, w])
    img += amp[:, w, None, None] * np.sin(
        2 * np.pi * (kx[:, None, None] * xx + ky[:, None, None] * yy)
        + phase[:, w, None, None])
  gain = rng.uniform(0.6, 1.0, (n, 1, 1, channels))
  img = img[..., None] * gain
  img += rng.normal(0, 0.05, img.shape)
  return ((np.clip(img, -1, 1) * 0.5 + 0.5) * 255).astype(np.uint8), \
      y


DIGITS_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "digits.npz")


def digits_arrays() -> Tuple[np.ndarray, np.ndarray]:
  """sklearn's bundled digits as it ships them, read from ``digits.npz``
  beside this file: ``images`` (1797, 8, 8) uint8 in 0..16 and ``labels``
  (1797,) uint8 (``load_digits()``'s ``images`` and ``target``, saved
  once), so no sklearn is needed."""
  with np.load(DIGITS_NPZ) as d:
    return d["images"], d["labels"]


def _load_digits(resolution: int = 16):
  """sklearn's bundled 1,797 real 8x8 handwritten digits — the only real
  image data available on a zero-egress box without archives. Upscaled
  2x (nearest) to 16x16 so the standard 2-up-block generator applies.
  Not in the reference; kept as a no-files real-data validation set.
  The arrays are the reference's, from ``digits_arrays``."""
  images, labels = digits_arrays()
  x = (images / 16.0 * 255.0).astype(np.uint8)[..., None]
  f = resolution // 8
  x = np.repeat(np.repeat(x, f, axis=1), f, axis=2)
  return x, labels.astype(np.int32)


# name -> (resolution, channels, num_classes or 0)
DATASETS = {
    "cifar10": (32, 3, 10),
    "cifar100": (32, 3, 100),
    "stl10": (48, 3, 10),
    "tiny-imagenet": (64, 3, 200),
    "imagenet64": (64, 3, 1000),
    "mnist": (32, 1, 10),
    "fashion-mnist": (32, 1, 10),
    "synthetic": (32, 3, 10),
    "digits": (16, 1, 10),
}


def get_dataset(name: str, batch_size: int, data_dir: str = "data",
                conditional: bool = False, seed: int = 0,
                z_dim: int = 128,
                synthetic_size: int = 4096,
                synthetic_resolution: Optional[int] = None) -> ArrayDataset:
  """Build a dataset by name — the reference's ``get_dataset`` surface [U].

  ``conditional=False`` strips labels (the dataset still knows
  num_classes=0 so the models build unconditionally)."""
  if name not in DATASETS:
    raise ValueError(f"unknown dataset {name!r}; choose from "
                     f"{sorted(DATASETS)}")
  res, _, classes = DATASETS[name]

  if name == "cifar10":
    x, y = _load_cifar10(data_dir)
  elif name == "cifar100":
    x, y = _load_cifar100(data_dir)
  elif name == "stl10":
    x, y = _load_stl10(data_dir, conditional)
  elif name == "tiny-imagenet":
    x, y = _load_tiny_imagenet(data_dir)
  elif name == "imagenet64":
    x, y = _load_imagenet64(data_dir)
  elif name == "mnist":
    x, y = _load_mnist_like(data_dir, "mnist")
  elif name == "fashion-mnist":
    x, y = _load_mnist_like(data_dir, "fashion-mnist")
  elif name == "digits":
    x, y = _load_digits()
  else:
    res = synthetic_resolution or res
    x, y = _synthetic(res, classes if conditional else 0,
                      n=synthetic_size, seed=seed)

  if not conditional:
    y, classes = None, 0
  return ArrayDataset(x, y, batch_size=batch_size, num_classes=classes,
                      seed=seed, z_dim=z_dim)
