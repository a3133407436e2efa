"""A minimal epoch loop around the outer step.

Counterpart of the epoch loop of ``wcgan_tpu/train/trainer.py``
(``Trainer._train_epochs``): host-fed uint8 batches, one outer step per
``next_batches(training_ratio)``, one ``log.txt`` line per epoch in the
reference's format, and a ``metrics.jsonl`` record with ``imgs_per_sec``.
A non-finite metric aborts the run. Checkpoints, sample grids, the
whitening-residual probe, the fallback ladder and device-resident data are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict

import torch

from wcgan_tpu.data.base import ArrayDataset
from wcgan_tpu.utils.logging import MetricsLogger
from wcgan_tpu_torch.train import step as step_lib
from wcgan_tpu_torch.train.state import GANTrainState


@dataclasses.dataclass
class TrainerConfig:
  """Loop and bookkeeping settings."""

  output_dir: str = "output"
  number_of_epochs: int = 100
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
    for epoch in range(self.cfg.number_of_epochs):
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
    return means
