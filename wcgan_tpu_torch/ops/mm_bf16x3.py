"""K3: a float32 product as three bf16 tensor-core products (bf16x3).

``mm_bf16x3(a, b, alpha, beta)`` computes ``alpha * (a @ b) + beta * I``
for float32 ``a`` (M, K) or (K,) and ``b`` (K, N), the product as

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
  in the kernel's order, then ``alpha * p + beta * I``. The CPU tests use
  it and ``chip_smoke.py`` holds the kernel against it.

``alpha`` and ``beta`` are the kernel's epilogue, ``fmaf(alpha, p,
beta)`` on the diagonal: Newton-Schulz's ``T = 1.5 I - 0.5 Z Y`` is one
call (``alpha = -0.5, beta = 1.5``, ``ops.whiten._ns_iterate``) with the
bits of the product followed by ``1.5 * I - 0.5 * p``, since a power of
two scales exactly.

``mm_bf16x3_ns_cuda(a, num_iters)`` runs a whole coupled Newton-Schulz
iteration's products (Z of ``ops.whiten._ns_iterate`` from Y = A, Z = I)
in one K3 launch, with each product's arithmetic, so Z has the chain's
bits; it has no gradient, and ``ops.whiten.ns_path`` takes it only where
none is taken. Its plain version is ``_ns_iterate`` with
``mm_bf16x3_reference`` as the product.

The gradient is JAX's transpose rule for a product at HIGH, which keeps
the precision: dA = alpha dC B^T and dB = alpha A^T dC, each itself
``mm_bf16x3`` with alpha in its epilogue, so the backward is
differentiable again (WGAN-GP with WC layers in D takes a double backward
through Newton-Schulz).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from wcgan_tpu_torch.ops import _build

# Number of times the wrapper has launched K3 (one per call, on CUDA only).
MM_BF16X3_LAUNCHES = 0
# Of those, the whitenings that ran as one fused Newton-Schulz launch
# (``mm_bf16x3_ns_cuda``).
MM_BF16X3_NS_LAUNCHES = 0
# The widths the fused launch takes: those the configurations whiten at
# (C <= 256, where K3's C x C products are 32 x 32 tiles that walk all of
# K, the split-K path without a split, whose arithmetic it repeats element
# by element).
NS_WIDTHS = (64, 128, 256)


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


def _epilogue(p: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
  """alpha * p + beta * I (I of p's shape), as K3's epilogue rounds it."""
  if alpha != 1.0:
    p = alpha * p
  if beta != 0.0:
    p = p + beta * torch.eye(*p.shape, dtype=p.dtype, device=p.device)
  return p


def mm_bf16x3_reference(a: torch.Tensor, b: torch.Tensor, alpha: float = 1.0,
                        beta: float = 0.0) -> torch.Tensor:
  """The plain version: the bf16 pieces of ``a`` and ``b``, then
  (a_lo b_hi + a_hi b_lo) + a_hi b_hi as float32 products, then
  alpha * p + beta * I."""
  _check(a, b)
  a_hi, a_lo = (p.float() for p in split_bf16(a))
  b_hi, b_lo = (p.float() for p in split_bf16(b))
  return _epilogue((a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi, alpha, beta)


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


def plan(a: torch.Tensor, b: torch.Tensor) -> Tuple[str, int, int]:
  """The path K3 takes for ``a @ b`` on ``a``'s device: ('rows', column
  slice, 1) for the wgmma row path, ('split-k', tile edge, CTAs a
  cluster) for the split-K path."""
  _check(a, b)
  (m, k), n = a.shape, b.shape[1]
  a, _, lda = _operand(a)
  out = (ctypes.c_int * 3)()
  with torch.cuda.device(a.device):
    err = _build.load_mm_bf16x3().wcgan_mm_bf16x3_plan(
        a.data_ptr(), lda, m, n, k, out)
  if err != 0:
    raise RuntimeError(f"mm_bf16x3 plan failed: cudaError_t {err}")
  return ("rows" if out[0] else "split-k", out[1], out[2])


def mm_bf16x3_cuda(a: torch.Tensor, b: torch.Tensor, alpha: float = 1.0,
                   beta: float = 0.0) -> torch.Tensor:
  """Launch K3 on ``a``'s device, on the current stream, without
  synchronising: ``alpha * (a @ b) + beta * I``. Raises on anything the
  kernel does not take."""
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
  with torch.cuda.device(a.device):
    err = lib.wcgan_mm_bf16x3(a.data_ptr(), int(ta), lda, b.data_ptr(),
                              int(tb), ldb, out.data_ptr(), m, n, k,
                              float(alpha), float(beta),
                              torch.cuda.current_stream(a.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"mm_bf16x3 kernel launch failed at ({m}, {k}) x "
                       f"({k}, {n}): cudaError_t {err}")
  MM_BF16X3_LAUNCHES += 1
  return out


def _forward(a: torch.Tensor, b: torch.Tensor, alpha: float = 1.0,
             beta: float = 0.0) -> torch.Tensor:
  if a.is_cuda:
    return mm_bf16x3_cuda(a, b, alpha, beta)
  if a.device.type == "cpu":
    return mm_bf16x3_reference(a, b, alpha, beta)
  raise ValueError(f"mm_bf16x3: no kernel for device {a.device}")


class MmBf16x3Fn(torch.autograd.Function):
  """K3 (or its plain version) with the product's gradient in the same
  precision: dA = alpha dC B^T, dB = alpha A^T dC (beta I is constant),
  through this function again."""

  @staticmethod
  def forward(ctx, a, b, alpha, beta):
    ctx.save_for_backward(a, b)
    ctx.alpha = alpha
    return _forward(a, b, alpha, beta)

  @staticmethod
  def backward(ctx, grad):
    a, b = ctx.saved_tensors
    da = db = None
    if ctx.needs_input_grad[0]:
      da = MmBf16x3Fn.apply(grad, b.T, ctx.alpha, 0.0)
    if ctx.needs_input_grad[1]:
      db = MmBf16x3Fn.apply(a.T, grad, ctx.alpha, 0.0)
    return da, db, None, None


def ns_takes(c: int) -> bool:
  """Whether the fused Newton-Schulz launch takes width ``c``."""
  return c in NS_WIDTHS


def mm_bf16x3_ns_cuda(a: torch.Tensor, num_iters: int) -> torch.Tensor:
  """The whole Newton-Schulz inverse square root's Z in one K3 launch on
  ``a``'s device (``csrc/mm_bf16x3.cu``'s ``mm_bf16x3_ns``), bit-equal to
  the chain of ``mm_bf16x3_cuda`` products; on the current stream, without
  synchronising. No gradient: autograd does not see it."""
  global MM_BF16X3_LAUNCHES, MM_BF16X3_NS_LAUNCHES
  if not a.is_cuda:
    raise ValueError(f"mm_bf16x3_ns_cuda needs a CUDA tensor, got "
                     f"{a.device}")
  if a.dtype != torch.float32 or a.dim() != 2 or a.shape[0] != a.shape[1] \
      or not ns_takes(a.shape[1]):
    raise ValueError(f"mm_bf16x3_ns takes a float32 C x C matrix with C in "
                     f"{NS_WIDTHS}, got {a.dtype} {tuple(a.shape)}")
  c = a.shape[1]
  if num_iters < 1:
    return torch.eye(c, dtype=torch.float32, device=a.device)
  a = a.contiguous()
  lib = _build.load_mm_bf16x3()
  ws = torch.empty(lib.wcgan_mm_bf16x3_ns_workspace_bytes(c) // 2,
                   dtype=torch.bfloat16, device=a.device)
  z = torch.empty((c, c), dtype=torch.float32, device=a.device)
  with torch.cuda.device(a.device):
    err = lib.wcgan_mm_bf16x3_ns(
        a.data_ptr(), c, int(num_iters), ws.data_ptr(), z.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"mm_bf16x3_ns kernel launch failed at C = {c}: "
                       f"cudaError_t {err}")
  MM_BF16X3_LAUNCHES += 1
  MM_BF16X3_NS_LAUNCHES += 1
  return z


def mm_bf16x3(a: torch.Tensor, b: torch.Tensor, alpha: float = 1.0,
              beta: float = 0.0) -> torch.Tensor:
  """``alpha * (a @ b) + beta * I`` in bf16x3, differentiable; ``a``
  (M, K) or (K,), ``b`` (K, N). K3 for CUDA tensors, the plain version for
  CPU tensors."""
  if a.dim() == 1:
    return MmBf16x3Fn.apply(a.unsqueeze(0), b, alpha, beta).squeeze(0)
  return MmBf16x3Fn.apply(a, b, alpha, beta)
