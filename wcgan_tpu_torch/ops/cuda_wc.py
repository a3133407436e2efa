"""K1, the WC transform's moment pass, as a hand-written Hopper kernel.

Counterpart of ``wcgan_tpu/ops/pallas_wc.py::moments`` (the Pallas TPU
kernel ``_moments_kernel`` with its custom VJP). ``moments(x2d)`` returns
the float32 mean (C,) and divide-by-R covariance (C, C) of the rows of an
(R, C) float32 or bfloat16 matrix, two-pass centered:

- a CUDA tensor goes to the kernel in ``csrc/moments.cu``, or the wrapper
  raises (wrong dtype, layout or build failure): nothing falls back;
- a CPU tensor goes to ``moments_reference``, the plain PyTorch version,
  which the CPU tests use and ``chip_smoke.py`` holds the kernel against.

The gradient is the one the JAX package computes outside Pallas,
dx = ((dSigma + dSigma^T)(x - mu) + dmu) / R, one float32 row matmul.
"""

from __future__ import annotations

from typing import Tuple

import torch

from wcgan_tpu_torch.ops import _build

# Number of times the wrapper has launched K1 (one per call, on CUDA only).
MOMENTS_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def moments_reference(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """The plain version: float32 mean, then (x - mu)^T (x - mu) / R."""
  x = x2d.float()
  mean = x.mean(dim=0)
  xc = x - mean
  return mean, xc.T @ xc / x.shape[0]


def moments_cuda(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """Launch K1 on ``x2d``'s device, on the current stream, without
  synchronising. Raises on anything the kernel does not take."""
  global MOMENTS_LAUNCHES
  if not x2d.is_cuda:
    raise ValueError(f"moments_cuda needs a CUDA tensor, got {x2d.device}")
  if x2d.dtype not in _DTYPE_CODES:
    raise TypeError(f"moments kernel takes float32 or bfloat16, got "
                    f"{x2d.dtype}")
  if x2d.dim() != 2 or not x2d.is_contiguous():
    raise ValueError(f"moments kernel needs contiguous (R, C) rows, got "
                     f"shape {tuple(x2d.shape)} strides {x2d.stride()}")
  rows, cols = x2d.shape
  if rows < 1 or cols < 1:
    raise ValueError(f"moments of an empty matrix {tuple(x2d.shape)}")
  lib = _build.load_moments()
  dev = x2d.device
  # The workspace is released on return, before the kernel has run; the
  # caching allocator hands its memory only to later work on this stream,
  # which the stream orders after the kernel.
  mean = torch.empty((cols,), dtype=torch.float32, device=dev)
  cov = torch.empty((cols, cols), dtype=torch.float32, device=dev)
  workspace = torch.empty(
      (lib.wcgan_moments_workspace_floats(rows, cols),), dtype=torch.float32,
      device=dev)
  stream = torch.cuda.current_stream(dev).cuda_stream
  err = lib.wcgan_moments(x2d.data_ptr(), _DTYPE_CODES[x2d.dtype], rows, cols,
                          mean.data_ptr(), cov.data_ptr(),
                          workspace.data_ptr(), stream)
  if err != 0:
    raise RuntimeError(f"moments kernel launch failed at {tuple(x2d.shape)} "
                       f"{x2d.dtype}: cudaError_t {err}")
  MOMENTS_LAUNCHES += 1
  return mean, cov


def _moments_forward(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  if x2d.is_cuda:
    return moments_cuda(x2d)
  if x2d.device.type == "cpu":
    return moments_reference(x2d)
  raise ValueError(f"moments: no kernel for device {x2d.device}")


class MomentsFn(torch.autograd.Function):
  """K1 with the analytic gradient of ``pallas_wc._moments_bwd``."""

  @staticmethod
  def forward(ctx, x2d):
    mean, cov = _moments_forward(x2d)
    ctx.save_for_backward(x2d, mean)
    return mean, cov

  @staticmethod
  def backward(ctx, dmu, dsig):
    x2d, mean = ctx.saved_tensors
    rows, cols = x2d.shape
    if dmu is None:
      dmu = torch.zeros((cols,), dtype=torch.float32, device=x2d.device)
    if dsig is None:
      dsig = torch.zeros((cols, cols), dtype=torch.float32, device=x2d.device)
    # float32 with TF32 off (the entry points pin allow_tf32 = False): the
    # mu-dependence inside Sigma contributes sum_r (x_r - mu) = 0.
    dx = ((x2d.float() - mean) @ (dsig + dsig.T) + dmu) / rows
    return dx.to(x2d.dtype)


def moments(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """(mean, covariance) of the rows of x2d through K1, differentiable."""
  return MomentsFn.apply(x2d)
