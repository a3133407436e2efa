"""wcgan_tpu_torch — the WC-GAN trainer ported to PyTorch and CUDA (Hopper).

A second package beside ``wcgan_tpu`` (JAX on a TPU), which stays the
reference: same weights and same injected noise give the same outputs
within stated tolerances (``tests/test_torch_*.py``). The layout mirrors
``wcgan_tpu`` module for module:

- ``wcgan_tpu_torch.ops``    — whitening numerics, unconditional coloring,
  spectral normalization, GAN losses, and (``cuda_wc``) the two CUDA
  kernels: K1, the moment pass, and K2, the whole stats-given WC layer.
- ``wcgan_tpu_torch.models`` — WC layers, SN conv/dense, the ResNet
  generator and discriminator.
- ``wcgan_tpu_torch.train``  — train state (with the EMA shadow), the
  K-D-updates + 1-G-update outer step and its device-data form, LR
  schedules, the epoch loop (full-state checkpoints, resume, the
  whitening probe and guard) and the sampling surfaces (EMA weights with
  standing statistics).
- ``wcgan_tpu_torch.trace`` — the port's spans: host time of each
  compiled program's call and of the set-up, ``torch.profiler`` ranges
  while it records, and where each span lies in a captured CUDA graph.
- ``wcgan_tpu_torch.weights`` — moves flax weights to the port and back,
  and reads and writes the JAX package's weights-only npz.
- ``wcgan_tpu_torch.cli``    — ``python -m wcgan_tpu_torch``.
- ``wcgan_tpu_torch.data``, ``.utils``, ``.tools`` — the port's own copies
  of the JAX package's numpy modules (datasets, image grids, logs,
  checkpoint key maps).

The port imports ``torch`` and never ``jax``, and nothing of the JAX
package (tests/test_torch_imports.py enforces it).
"""

__version__ = "0.1.0"
