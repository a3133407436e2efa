"""The epoch loop around the outer step, and the sampling surfaces.

Counterpart of ``wcgan_tpu/train/trainer.py``:

- the epoch loop: host-fed uint8 batches, one outer step per
  ``next_batches(training_ratio)``, one ``log.txt`` line per epoch in the
  reference's format, a ``metrics.jsonl`` record with ``imgs_per_sec``, a
  sample grid every ``display_ratio`` epochs; a non-finite metric aborts;
- sampling from G in eval mode on its running statistics: ``sample``,
  ``sample_u8`` (uint8 made on the device), ``save_sample_grid`` and
  ``generate`` (the scorer's input);
- ``export_weights``: the weights-only ``epoch_{i}_{generator,
  discriminator}.npz`` in the JAX package's format.

Full-state checkpoints and resume, EMA weights and standing statistics,
the whitening-residual probe, the fallback ladder and device-resident data
are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict

import numpy as np
import torch

from wcgan_tpu_torch.data.base import ArrayDataset
from wcgan_tpu_torch.utils.images import make_grid, save_png
from wcgan_tpu_torch.utils.logging import MetricsLogger
from wcgan_tpu_torch import weights
from wcgan_tpu_torch.train import step as step_lib
from wcgan_tpu_torch.train.state import GANTrainState

GRID_SAMPLES = 64                 # images in a sample grid (8 x 8)


@dataclasses.dataclass
class TrainerConfig:
  """Loop and bookkeeping settings."""

  name: str = "run"
  output_dir: str = "output"
  checkpoints_dir: str = "checkpoints"  # export_weights writes under
                                        # checkpoints_dir/name
  number_of_epochs: int = 100
  start_epoch: int = 0
  display_ratio: int = 1          # sample grid every N epochs; 0 = never
  batches_per_epoch: int = 0      # outer steps per epoch; 0 = dataset size


class Trainer:
  """Drives training of one GAN experiment on ``state``'s device."""

  def __init__(self, dataset: ArrayDataset, state: GANTrainState,
               gan_cfg: step_lib.GANConfig, cfg: TrainerConfig):
    self.ds = dataset
    self.state = state
    self.gan_cfg = gan_cfg
    self.cfg = cfg
    self.logger = MetricsLogger(cfg.output_dir)
    self.step_fn = step_lib.make_outer_step(gan_cfg)

  def epoch_batches(self) -> int:
    """Outer steps per epoch: the configured count, else the dataset's
    batches over the D updates one outer step consumes."""
    return self.cfg.batches_per_epoch or max(
        self.ds.number_of_batches_per_epoch // self.gan_cfg.training_ratio,
        1)

  def train(self) -> Dict[str, float]:
    ratio = self.gan_cfg.training_ratio
    batches = self.epoch_batches()
    device = self.state.generator.device
    means: Dict[str, float] = {}
    for epoch in range(self.cfg.start_epoch, self.cfg.number_of_epochs):
      t0 = time.perf_counter()
      accum = []
      for _ in range(batches):
        real, labels = self.ds.next_batches(ratio)
        accum.append(self.step_fn(self.state, real, labels))
      # The metrics come back to the host once per epoch; the synchronise
      # then counts the epoch's last optimizer update in its time.
      stacked = {k: torch.stack([m[k] for m in accum]).mean().item()
                 for k in accum[0]}
      if device.type == "cuda":
        torch.cuda.synchronize(device)
      dt = time.perf_counter() - t0
      means = stacked
      imgs_per_sec = batches * ratio * self.ds.batch_size / dt
      self.logger.epoch_line(epoch, means,
                             extra=f"imgs/sec = {imgs_per_sec:.1f}")
      self.logger.jsonl(dict(epoch=epoch, **means, device=str(device),
                             imgs_per_sec=imgs_per_sec, seconds=dt))
      if not all(math.isfinite(v) for v in means.values()):
        self.logger.line(f"Epoch {epoch}: NON-FINITE metrics {means}; "
                         "aborting")
        raise FloatingPointError(f"non-finite training metrics: {means}")
      if self.cfg.display_ratio and (epoch + 1) % self.cfg.display_ratio == 0:
        self.save_sample_grid(epoch)
    return means

  # -- sampling ---------------------------------------------------------------

  @torch.no_grad()
  def sample(self, z) -> torch.Tensor:
    """Images (N, H, W, C), float32 in [-1, 1], on the device, from z
    (N, z_dim): G in eval mode on its running statistics."""
    g = self.state.g
    z = step_lib.as_tensor(z, self.state.generator.device)
    return g(z, train=False).permute(0, 2, 3, 1)

  def sample_u8(self, z) -> torch.Tensor:
    """``sample`` clipped and converted to uint8 on the device, so that
    only a quarter of the bytes cross to the host."""
    imgs = self.sample(z)
    return (torch.clamp(imgs.float(), -1.0, 1.0) * 127.5 + 127.5).to(
        torch.uint8)

  def save_sample_grid(self, epoch: int) -> str:
    """The grid of ``GRID_SAMPLES`` images from the dataset's fixed test
    z, written to ``output_dir/epoch_{epoch:05d}.png``."""
    z, _ = self.ds.test_batch(GRID_SAMPLES)
    imgs = self.sample(z).cpu().numpy()
    path = os.path.join(self.cfg.output_dir, f"epoch_{epoch:05d}.png")
    save_png(path, make_grid(imgs))
    return path

  def generate(self, n: int, batch: int = 256,
               rng_seed: int = 1234) -> np.ndarray:
    """n generated images as uint8 (N, H, W, C) (for IS/FID scoring).
    Every batch is a full one, from a numpy generator seeded with
    ``rng_seed``; the tail is sliced off."""
    rng = np.random.default_rng(rng_seed)
    out = []
    for i in range(0, n, batch):
      b = min(batch, n - i)
      z = rng.standard_normal((batch, self.gan_cfg.z_dim)).astype(np.float32)
      out.append(self.sample_u8(z)[:b].cpu().numpy())
    return np.concatenate(out)

  def export_weights(self, epoch: int) -> None:
    """Weights-only ``epoch_{epoch}_{generator,discriminator}.npz`` under
    ``checkpoints_dir/name``, in the JAX package's format (params only)."""
    ckpt_dir = os.path.join(self.cfg.checkpoints_dir, self.cfg.name)
    os.makedirs(ckpt_dir, exist_ok=True)
    for model, module in (("generator", self.state.g),
                          ("discriminator", self.state.d)):
      np.savez(os.path.join(ckpt_dir, f"epoch_{epoch}_{model}.npz"),
               **weights.export_npz(module))
