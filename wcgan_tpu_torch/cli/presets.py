"""The five BASELINE configurations (and the paper's CIFAR-100 row) as
argv fragments for ``python -m wcgan_tpu_torch --preset <name>``.

The port's own copy of ``wcgan_tpu/cli/presets.py`` (the port imports
nothing of the JAX package; ``tests/test_torch_imports.py`` holds the two
equal):

1. uncond WC DCGAN CIFAR-10 32x32
2. cond cWC ResNet CIFAR-10 (class-conditional coloring + projection D)
3. uncond WC ResNet STL-10 48x48 with spectral-norm D
4. cond cWC-sa Tiny-ImageNet 64x64 (shared-basis soft assignment)
5. large-batch cond cWC ImageNet-64, data-parallel with cross-replica
   whitening stats (``--mesh``: one process a replica, a card each on
   CUDA, ``wcgan_tpu_torch.parallel``)

Flags given after ``--preset <name>`` override the preset's (argparse
keeps the last).
"""

from __future__ import annotations

from typing import Dict, List

PRESETS: Dict[str, List[str]] = {
    # 1 — unconditional WC DCGAN on CIFAR-10 32x32.
    "cifar10_wc_dcgan": [
        "--dataset", "cifar10", "--arch", "dcgan", "--loss", "ns",
        "--training_ratio", "1", "--generator_block_norm", "d",
        "--generator_block_coloring", "uconv",
        "--generator_last_norm", "d", "--generator_last_coloring", "uconv",
        "--number_of_epochs", "50",
    ],
    # 2 — conditional cWC ResNet on CIFAR-10 with projection-D.
    "cifar10_cwc_resnet_proj": [
        "--dataset", "cifar10", "--arch", "res", "--loss", "hinge",
        "--gan_type", "PROJECTIVE", "--conditional",
        "--training_ratio", "5", "--generator_block_norm", "d",
        "--generator_block_coloring", "ucconv",
        "--generator_last_norm", "d",
        "--generator_last_coloring", "ucconv",
        "--lr_decay_schedule", "linear", "--number_of_epochs", "100",
    ],
    # 3 — unconditional WC ResNet on STL-10 48x48 with an SN D.
    "stl10_wc_resnet_sn": [
        "--dataset", "stl10", "--arch", "res", "--loss", "hinge",
        "--training_ratio", "5", "--discriminator_spectral", "1",
        "--generator_block_norm", "d",
        "--generator_block_coloring", "uconv",
        "--generator_last_norm", "d", "--generator_last_coloring",
        "uconv", "--lr_decay_schedule", "linear",
        "--number_of_epochs", "100",
    ],
    # 4 — conditional cWC-sa on Tiny ImageNet 64x64.
    "tiny_imagenet_cwcsa": [
        "--dataset", "tiny-imagenet", "--arch", "res", "--loss", "hinge",
        "--gan_type", "PROJECTIVE", "--conditional",
        "--training_ratio", "5", "--generator_block_norm", "d",
        "--generator_block_coloring", "ucconv-sa",
        "--generator_last_norm", "d",
        "--generator_last_coloring", "ucconv-sa",
        "--filters_emb", "10", "--lr_decay_schedule", "linear",
        "--number_of_epochs", "100",
    ],
    # (extra) — the paper's conditional CIFAR-100 row (cWC-sa with
    # projection-D).
    "cifar100_cwcsa": [
        "--dataset", "cifar100", "--arch", "res", "--loss", "hinge",
        "--gan_type", "PROJECTIVE", "--conditional",
        "--training_ratio", "5", "--generator_block_norm", "d",
        "--generator_block_coloring", "ucconv-sa",
        "--generator_last_norm", "d",
        "--generator_last_coloring", "ucconv-sa",
        "--filters_emb", "10", "--lr_decay_schedule", "linear",
        "--number_of_epochs", "100",
    ],
    # 5 — large-batch conditional cWC ImageNet 64x64, data-parallel
    # (--mesh) with cross-replica whitening statistics; cWC in its -sa
    # form, whose shared basis keeps 1,000 classes affordable.
    "imagenet64_cwc_dp": [
        "--dataset", "imagenet64", "--arch", "res", "--loss", "hinge",
        "--gan_type", "PROJECTIVE", "--conditional",
        "--batch_size", "512", "--mesh", "8",
        "--training_ratio", "5", "--generator_block_norm", "d",
        "--generator_block_coloring", "ucconv-sa",
        "--generator_last_norm", "d",
        "--generator_last_coloring", "ucconv-sa", "--bf16",
        "--lr_decay_schedule", "linear", "--number_of_epochs", "50",
    ],
}


def preset_argv(name: str, extra: List[str] = ()) -> List[str]:
  if name not in PRESETS:
    raise KeyError(f"unknown preset {name!r}; choose from "
                   f"{sorted(PRESETS)}")
  return list(PRESETS[name]) + list(extra)
