"""K4: D's 2x2 average pool (stride 2), forward and backward, on
channels_last tensors.

``avg_pool2x2(x)`` is ``F.avg_pool2d(x, 2)`` for (N, C, H, W) ``x`` with H
and W even: what ``models.layers.downsample_avg`` runs in every ResNet D's
down-sampling blocks. It replaces no TPU kernel: the JAX package's
``downsample_avg`` is a reshape and a mean that XLA fuses. On the card it
replaces ATen's NHWC pooling kernels, which are bound by their index
arithmetic; K4 (``csrc/avg_pool2x2.cu``) is bound by HBM bytes and gives
ATen's bits: the forward sums a window in float32 in ATen's order and
rounds once, the backward writes g / 4 rounded once to each input of the
window.

- A CUDA tensor goes to the kernel, or the wrapper raises
  (``check_pool_input``: float32 or bfloat16, channels_last, H and W even;
  or a build failure): nothing falls back.
- A CPU tensor goes to the plain version, ``avg_pool2x2_reference``,
  ``F.avg_pool2d(x, 2)``; the CPU tests use it and ``chip_smoke.py`` and
  the CUDA tests hold the kernel to it bit for bit.

The gradient is the backward kernel, itself an autograd function whose
gradient is the forward kernel, so WGAN-GP's double backward through D
runs through K4 too. A gradient that is not channels_last-contiguous is
made so first (``AVG_POOL2X2_COPIES`` counts it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wcgan_tpu_torch.ops import _build

# Number of times the wrapper has launched K4, forward or backward (one per
# launch, on CUDA only).
AVG_POOL2X2_LAUNCHES = 0
# Of the backward kernel's inputs (a gradient, or in a double backward the
# gradient of one), those that were copied to channels_last first.
AVG_POOL2X2_COPIES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_pool_input(x: torch.Tensor) -> None:
  """Raise unless K4 pools ``x``: float32 or bfloat16, (N, C, H, W)
  channels_last-contiguous with H and W even (the JAX package's reshape
  needs them even too), and two input rows under 2^31 elements."""
  if x.dtype not in _DTYPE_CODES:
    raise TypeError(f"avg_pool2x2 takes float32 or bfloat16, got {x.dtype}")
  if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
    raise ValueError(f"avg_pool2x2 takes (N, C, H, W) channels_last-"
                     f"contiguous, got shape {tuple(x.shape)} strides "
                     f"{x.stride()}")
  n, c, h, w = x.shape
  if h % 2 or w % 2 or min(n, c, h, w) < 1:
    raise ValueError(f"avg_pool2x2 takes N, C >= 1 and even H, W >= 2, got "
                     f"{tuple(x.shape)}")
  if 2 * w * c >= 2 ** 31 or n * h // 2 >= 2 ** 31:
    raise ValueError(f"avg_pool2x2 takes 2 W C < 2^31 and N H / 2 < 2^31, "
                     f"got {tuple(x.shape)}")


def avg_pool2x2_reference(x: torch.Tensor) -> torch.Tensor:
  """The plain version: ``F.avg_pool2d(x, 2)``."""
  return F.avg_pool2d(x, 2)


def _launch(backward: bool, src: torch.Tensor) -> torch.Tensor:
  """One K4 launch on ``src``'s device, on the current stream, without
  synchronising. Forward: ``src`` is the input, checked, and the result
  its pool. Backward: ``src`` is the gradient of a pool's output,
  channels_last-contiguous, and the result the gradient of its input."""
  global AVG_POOL2X2_LAUNCHES
  n, c, h, w = src.shape
  if backward:
    h, w = 2 * h, 2 * w
  else:
    check_pool_input(src)
  out = torch.empty((n, c) + ((h, w) if backward else (h // 2, w // 2)),
                    dtype=src.dtype, device=src.device,
                    memory_format=torch.channels_last)
  lib = _build.load_avg_pool2x2()
  with torch.cuda.device(src.device):
    err = lib.wcgan_avg_pool2x2(
        int(backward), src.data_ptr(), _DTYPE_CODES[src.dtype], n * h // 2,
        w // 2, c, out.data_ptr(),
        torch.cuda.current_stream(src.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"avg_pool2x2 {'backward' if backward else 'forward'}"
                       f" kernel launch failed at {tuple(src.shape)} "
                       f"{src.dtype}: cudaError_t {err}")
  AVG_POOL2X2_LAUNCHES += 1
  return out


def _channels_last(g: torch.Tensor) -> torch.Tensor:
  global AVG_POOL2X2_COPIES
  if g.is_contiguous(memory_format=torch.channels_last):
    return g
  AVG_POOL2X2_COPIES += 1
  return g.contiguous(memory_format=torch.channels_last)


class AvgPool2x2Fn(torch.autograd.Function):
  """K4's forward; its gradient is ``AvgPool2x2BackwardFn``."""

  @staticmethod
  def forward(ctx, x):
    return _launch(False, x)

  @staticmethod
  def backward(ctx, g):
    return AvgPool2x2BackwardFn.apply(g)


class AvgPool2x2BackwardFn(torch.autograd.Function):
  """K4's backward, g -> dx; linear in g, so its gradient is K4's
  forward of the incoming gradient."""

  @staticmethod
  def forward(ctx, g):
    return _launch(True, _channels_last(g))

  @staticmethod
  def backward(ctx, gg):
    return AvgPool2x2Fn.apply(_channels_last(gg))


def avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
  """``F.avg_pool2d(x, 2)`` of (N, C, H, W) ``x``, differentiable: K4 for
  CUDA tensors, the plain version for CPU tensors."""
  if x.is_cuda:
    return AvgPool2x2Fn.apply(x)
  if x.device.type == "cpu":
    return avg_pool2x2_reference(x)
  raise ValueError(f"avg_pool2x2: no kernel for device {x.device}")
