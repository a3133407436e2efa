"""K3: a float32 product as three bf16 tensor-core products (bf16x3).

``mm_bf16x3(a, b)`` computes ``a @ b`` for float32 ``a`` (M, K) or (K,)
and ``b`` (K, N) as

  a b ~= a_lo b_hi + a_hi b_lo + a_hi b_hi,
  a_hi = bf16(a), a_lo = bf16(a - a_hi)  (round to nearest even),

with float32 accumulation: what XLA's ``Precision.HIGH`` runs on the TPU,
and what the JAX package's default whitening precision
(``wcgan_tpu/ops/whiten.py``, ``--whitening_precision high``) gives every
whitening-path product. It replaces no Pallas kernel: PyTorch has no such
mode on CUDA (its 'high' float32 precision is TF32). ``ops.whiten`` routes
the products of JAX's ``_PRECISION`` sites here when its precision is
'high'.

- A CUDA tensor goes to the kernel (``csrc/mm_bf16x3.cu``), or the wrapper
  raises (wrong dtype, shape or device, a build failure): nothing falls
  back. Each operand is read in place as given or transposed, from its
  strides (a transposed view launches no copy); any other layout is made
  contiguous first.
- A CPU tensor goes to the plain version, ``mm_bf16x3_reference``: the
  same pieces by ``.to(torch.bfloat16)``, summed as three float32 products
  in the kernel's order. The CPU tests use it and ``chip_smoke.py`` holds
  the kernel against it.

The gradient is JAX's transpose rule for a product at HIGH, which keeps
the precision: dA = dC B^T and dB = A^T dC, each itself ``mm_bf16x3``, so
the backward is differentiable again (WGAN-GP with WC layers in D takes a
double backward through Newton-Schulz).
"""

from __future__ import annotations

from typing import Tuple

import torch

from wcgan_tpu_torch.ops import _build

# Number of times the wrapper has launched K3 (one per call, on CUDA only).
MM_BF16X3_LAUNCHES = 0


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """(hi, lo) bf16 pieces of float32 ``x``: hi = bf16(x), lo = bf16(x - hi)."""
  hi = x.to(torch.bfloat16)
  return hi, (x - hi.float()).to(torch.bfloat16)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
  if a.dtype != torch.float32 or b.dtype != torch.float32:
    raise TypeError(f"mm_bf16x3 takes float32 operands, got {a.dtype} and "
                    f"{b.dtype}")
  if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
    raise ValueError(f"mm_bf16x3 takes (M, K) and (K, N), got "
                     f"{tuple(a.shape)} and {tuple(b.shape)}")


def mm_bf16x3_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """The plain version: the bf16 pieces of ``a`` and ``b``, then
  (a_lo b_hi + a_hi b_lo) + a_hi b_hi as float32 products."""
  _check(a, b)
  a_hi, a_lo = (p.float() for p in split_bf16(a))
  b_hi, b_lo = (p.float() for p in split_bf16(b))
  return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _operand(t: torch.Tensor) -> Tuple[torch.Tensor, bool, int]:
  """(tensor, transposed, leading dimension) with which K3 reads ``t``
  (rows, cols): element (i, j) at i * ld + j as given, or at j * ld + i
  transposed; another layout is copied to a contiguous one."""
  rows, cols = t.shape
  s0, s1 = t.stride()
  if s1 == 1 or cols == 1:
    return t, False, s0
  if s0 == 1 or rows == 1:
    return t, True, s1
  return t.contiguous(), False, cols


def mm_bf16x3_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Launch K3 on ``a``'s device, on the current stream, without
  synchronising. Raises on anything the kernel does not take."""
  global MM_BF16X3_LAUNCHES
  if not (a.is_cuda and b.device == a.device):
    raise ValueError(f"mm_bf16x3_cuda needs both operands on one CUDA "
                     f"device, got {a.device} and {b.device}")
  _check(a, b)
  (m, k), n = a.shape, b.shape[1]
  if max(m, n, k) >= 2 ** 31 or -(-n // 32) > 65535:
    raise ValueError(f"mm_bf16x3 kernel takes M, K < 2^31 and N <= "
                     f"2,097,120, got ({m}, {k}) x ({k}, {n})")
  out = torch.empty((m, n), dtype=torch.float32, device=a.device)
  if m == 0 or n == 0:
    return out
  # A copy made here is released on return, before the kernel has run; the
  # caching allocator hands its memory only to later work on this stream.
  a, ta, lda = _operand(a)
  b, tb, ldb = _operand(b)
  lib = _build.load_mm_bf16x3()
  err = lib.wcgan_mm_bf16x3(a.data_ptr(), int(ta), lda, b.data_ptr(),
                            int(tb), ldb, out.data_ptr(), m, n, k,
                            torch.cuda.current_stream(a.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"mm_bf16x3 kernel launch failed at ({m}, {k}) x "
                       f"({k}, {n}): cudaError_t {err}")
  MM_BF16X3_LAUNCHES += 1
  return out


def _forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  if a.is_cuda:
    return mm_bf16x3_cuda(a, b)
  if a.device.type == "cpu":
    return mm_bf16x3_reference(a, b)
  raise ValueError(f"mm_bf16x3: no kernel for device {a.device}")


class MmBf16x3Fn(torch.autograd.Function):
  """K3 (or its plain version) with the product's gradient in the same
  precision: dA = dC B^T, dB = A^T dC, through this function again."""

  @staticmethod
  def forward(ctx, a, b):
    ctx.save_for_backward(a, b)
    return _forward(a, b)

  @staticmethod
  def backward(ctx, grad):
    a, b = ctx.saved_tensors
    da = db = None
    if ctx.needs_input_grad[0]:
      da = MmBf16x3Fn.apply(grad, b.T)
    if ctx.needs_input_grad[1]:
      db = MmBf16x3Fn.apply(a.T, grad)
    return da, db


def mm_bf16x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """``a @ b`` in bf16x3, differentiable; ``a`` (M, K) or (K,), ``b``
  (K, N). K3 for CUDA tensors, the plain version for CPU tensors."""
  if a.dim() == 1:
    return MmBf16x3Fn.apply(a.unsqueeze(0), b).squeeze(0)
  return MmBf16x3Fn.apply(a, b)
