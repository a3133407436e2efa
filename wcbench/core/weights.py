"""The benchmark's inputs, made from the seed on the device: the weights
(by the reference's parameter list, in one draw), the dataset (uint8
images and labels) and the seeds of each stream.

The system under test and the reference are both given these: the
program by writing them over its freshly built state, the reference by
name.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from wcbench.reference import wcgan

STREAMS = ("weights", "data", "noise", "traffic", "sample")


def stream_seed(seed: int, stream: str) -> int:
  """A 63-bit seed for one of ``STREAMS``, from the run's ``--seed`` (any
  non-negative whole number)."""
  words = np.random.SeedSequence([int(seed), STREAMS.index(stream)])
  return int(words.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_weights(cfg: dict, seed: int, device
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
  """Every parameter and buffer of G ('g') and D ('d'), by name: one
  normal draw on the device for all the random ones, scaled leaf by leaf;
  the rest zeros, ones or the identity."""
  specs = ([("g", *s) for s in wcgan.g_specs(cfg)]
           + [("d", *s) for s in wcgan.d_specs(cfg)])
  gen = torch.Generator(device=device).manual_seed(
      stream_seed(seed, "weights"))
  total = sum(int(np.prod(shape)) for _, _, shape, init in specs
              if init[0] == "normal")
  flat = torch.randn(total, generator=gen, device=device)
  out: Dict[str, Dict[str, torch.Tensor]] = {"g": {}, "d": {}}
  at = 0
  for model, name, shape, init in specs:
    if init[0] == "normal":
      size = int(np.prod(shape))
      t = flat[at:at + size].view(shape) * init[1]
      at += size
    elif init[0] == "zeros":
      t = torch.zeros(shape, device=device)
    elif init[0] == "ones":
      t = torch.ones(shape, device=device)
    else:
      t = torch.eye(shape[0], device=device)
    out[model][name] = t
  return out


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]
              ) -> None:
  """Write ``weights`` over ``module``'s parameters and buffers of the
  same names; every one of them must be there, with its shape."""
  own = dict(module.named_parameters())
  own.update(module.named_buffers())
  for name, t in own.items():
    if name not in weights or tuple(weights[name].shape) != tuple(t.shape):
      raise KeyError(f"the benchmark has no weight {name} "
                     f"{tuple(t.shape)} for {type(module).__name__}")
    with torch.no_grad():
      t.copy_(weights[name])


def make_dataset(cfg: dict, seed: int, device, chunk: int = 4096):
  """(images (N, H, W, 3) uint8, labels (N,) int64), N and the classes as
  the configuration states, labels uniform. The images are noise at every
  scale from 4 x 4 up to the full resolution, each scale upsampled
  bilinearly and weighted by its size (a 1/f spectrum, as natural images
  have), made in blocks of ``chunk`` images."""
  gen = torch.Generator(device=device).manual_seed(stream_seed(seed, "data"))
  ds = cfg["dataset"]
  n, res = ds["images"], cfg["resolution"]
  labels = torch.randint(0, max(ds["classes"], 1), (n,), generator=gen,
                         device=device)
  images = torch.empty((n, res, res, 3), dtype=torch.uint8, device=device)
  for lo in range(0, n, chunk):
    m = min(chunk, n - lo)
    x = torch.zeros((m, 3, res, res), device=device)
    size = 4
    while size <= res:
      noise = torch.rand((m, 3, size, size), generator=gen, device=device)
      x += (size / res) ** -1 * torch.nn.functional.interpolate(
          noise - 0.5, size=(res, res), mode="bilinear",
          align_corners=False)
      size *= 2
    x = x / x.flatten(1).abs().amax(1).clamp(min=1e-6)[:, None, None, None]
    images[lo:lo + m] = ((x + 1) * 127.5).round().clamp(0, 255).to(
        torch.uint8).permute(0, 2, 3, 1)
  return images, labels
