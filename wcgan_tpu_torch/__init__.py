"""wcgan_tpu_torch — the WC-GAN trainer ported to PyTorch and CUDA (Hopper).

A second package beside ``wcgan_tpu`` (JAX on a TPU), which stays the
reference: same weights and same injected noise give the same outputs
within stated tolerances (``tests/test_torch_*.py``). The layout mirrors
``wcgan_tpu`` module for module:

- ``wcgan_tpu_torch.ops``    — whitening numerics, spectral normalization,
  GAN losses, and K1 (``cuda_wc``), the moment pass as a CUDA kernel.
- ``wcgan_tpu_torch.models`` — WC layers, SN conv/dense, the ResNet
  generator and discriminator.
- ``wcgan_tpu_torch.train``  — train state, the K-D-updates + 1-G-update
  outer step, LR schedules and a minimal epoch loop.
- ``wcgan_tpu_torch.weights`` — moves flax weights to the port and back.
- ``wcgan_tpu_torch.cli``    — ``python -m wcgan_tpu_torch``.

The port imports ``torch`` and never ``jax``; from the JAX package it
reuses only the numpy modules ``wcgan_tpu.data`` and ``wcgan_tpu.utils``.
"""

__version__ = "0.1.0"
