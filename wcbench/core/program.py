"""The system under test, built from a configuration file.

Everything the benchmark takes from ``wcgan_tpu_torch`` goes through here:
its model and step configurations, its train state, its compiled step and
its trainer's sampling program. The weights are the benchmark's own
(``weights.py``), written over the state's after it is built.
"""

from __future__ import annotations

from typing import Tuple

import torch

from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
from wcgan_tpu_torch.models.generator import GeneratorConfig
from wcgan_tpu_torch.ops import whiten
from wcgan_tpu_torch.train.state import OptimConfig, create_state
from wcgan_tpu_torch.train.step import GANConfig


def model_configs(cfg: dict, dtype: str = None
                  ) -> Tuple[GeneratorConfig, DiscriminatorConfig,
                             GANConfig, OptimConfig]:
  """The port's configurations for ``cfg`` (a configuration file's
  contents); ``dtype`` overrides the file's activation dtype."""
  g, d, gan, opt = (cfg["generator"], cfg["discriminator"], cfg["gan"],
                    cfg["optim"])
  dtype = dtype or cfg["dtype"]
  ncls = gan.get("num_classes", 0)
  g_cfg = GeneratorConfig(
      arch="res", z_dim=cfg["z_dim"], resolution=cfg["resolution"],
      filters=tuple(g["filters"]), base_resolution=g["base_resolution"],
      block_norm=g["block_norm"], block_coloring=g["block_coloring"],
      last_norm=g["last_norm"], last_coloring=g["last_coloring"],
      num_classes=ncls, filters_emb=g.get("filters_emb", 10),
      ns_iters=g["ns_iters"], ns_scaling=g["ns_scaling"],
      wc_momentum=g["wc_momentum"], dtype=dtype)
  d_cfg = DiscriminatorConfig(
      arch="res", resolution=cfg["resolution"], filters=tuple(d["filters"]),
      downsample=tuple(d["downsample"]), spectral=True,
      sn_iters=d["sn_iters"], num_classes=ncls,
      projection=bool(d.get("projection")), dtype=dtype)
  gan_cfg = GANConfig(
      loss=gan["loss"], gan_type="projection" if d.get("projection")
      else "gan", training_ratio=gan["training_ratio"],
      generator_batch_multiple=gan["generator_batch_multiple"],
      num_classes=ncls, z_dim=cfg["z_dim"], random_flip=gan["random_flip"])
  opt_cfg = OptimConfig(
      generator_lr=opt["generator_lr"], discriminator_lr=opt["discriminator_lr"],
      beta1=opt["beta1"], beta2=opt["beta2"],
      lr_decay_schedule=opt["lr_decay_schedule"],
      total_outer_steps=opt["total_outer_steps"])
  return g_cfg, d_cfg, gan_cfg, opt_cfg


def set_switches(cfg: dict) -> None:
  """The CLI's switches: float32 products and convolutions in true
  float32 (TF32 off, ``cli/run.py::set_precision``), and the whitening
  precision the configuration states."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  whiten.set_precision(cfg["whitening_precision"])


def build_state(cfg: dict, device: torch.device, group=None, dtype=None):
  """The port's train state for ``cfg`` on ``device`` (its own weights,
  which the caller overwrites), with ``group`` for data parallelism."""
  g_cfg, d_cfg, gan_cfg, opt_cfg = model_configs(cfg, dtype)
  state = create_state(g_cfg, d_cfg, opt_cfg, gan_cfg.training_ratio,
                       device, seed=0, group=group)
  return state, gan_cfg
