"""Evaluation: Inception Score and FID on the device.

The port's counterpart of ``wcgan_tpu/evaluation``: InceptionV3 in
torchvision's layout (``inception_v3``; weights from a local npz, random
ones without it), the IS and FID math in float32 (``metrics``; FID's
square roots by ``torch.linalg.eigh``, or Newton-Schulz with
``method='ns'``), and the Trainer's scorer callback (``scorer``).
"""

from wcgan_tpu_torch.evaluation.metrics import (  # noqa: F401
    fid_from_moments, frechet_distance, inception_score,
    moments_from_activations)
