"""The WC transform's TPU kernels as hand-written Hopper kernels.

K1 ``moments`` is the counterpart of ``wcgan_tpu/ops/pallas_wc.py::moments``
(the Pallas TPU kernel ``_moments_kernel`` with its custom VJP).
``moments(x2d)`` returns the float32 mean (C,) and divide-by-R covariance
(C, C) of the rows of an (R, C) float32 or bfloat16 matrix, two-pass
centered. Its gradient is the one the JAX package computes outside Pallas,
dx = ((dSigma + dSigma^T)(x - mu) + dmu) / R, one float32 row matmul.

K2 ``whiten_color_apply`` is the counterpart of
``pallas_wc.py::whiten_color_apply`` (``_wc_apply_kernel``): the whole
stats-given WC layer, out = x M^T + beta - mu M^T with M = Gamma W and
W = cov^{-1/2} by coupled Newton-Schulz, forward only. One call is two
launches: a cooperative setup (Newton-Schulz, fold, bias; it raises if its
grid cannot be co-resident) and the row apply (bf16 rows on the tensor
cores with M in three bf16 pieces, float32 rows in FFMA).

For each kernel:

- a CUDA tensor goes to the kernel (``csrc/moments.cu``,
  ``csrc/wc_apply.cu``), or the wrapper raises (wrong dtype, layout, width
  or a build failure): nothing falls back;
- a CPU tensor goes to the plain PyTorch version (``moments_reference``,
  ``whiten_color_apply_reference``), which the CPU tests use and
  ``chip_smoke.py`` holds the kernel against.
"""

from __future__ import annotations

from typing import Tuple

import torch

from wcgan_tpu_torch.ops import _build
from wcgan_tpu_torch.ops import whiten

# Number of times each wrapper has launched its kernel (one per call, on
# CUDA only).
MOMENTS_LAUNCHES = 0
WC_APPLY_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def moments_reference(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """The plain version: float32 mean, then (x - mu)^T (x - mu) / R."""
  x = x2d.float()
  mean = x.mean(dim=0)
  xc = x - mean
  return mean, xc.T @ xc / x.shape[0]


def check_moments_rows(x2d: torch.Tensor) -> None:
  """Raise unless K1 takes ``x2d`` as its rows: float32 or bfloat16,
  contiguous (R, C), 1 <= R < 2^31, and each row a multiple of 16 bytes
  starting 16-byte aligned (the TMA tensor map's stride rule), i.e.
  C % 4 == 0 in float32 and C % 8 == 0 in bfloat16. Every WC width of the
  JAX package's configurations, C in {64, 128, 256, 512, 1024}, passes in
  both types."""
  if x2d.dtype not in _DTYPE_CODES:
    raise TypeError(f"moments kernel takes float32 or bfloat16, got "
                    f"{x2d.dtype}")
  if x2d.dim() != 2 or not x2d.is_contiguous():
    raise ValueError(f"moments kernel needs contiguous (R, C) rows, got "
                     f"shape {tuple(x2d.shape)} strides {x2d.stride()}")
  rows, cols = x2d.shape
  if not (1 <= rows < 2 ** 31 and cols >= 1):
    raise ValueError(f"moments kernel takes 1 <= R < 2^31 rows of C >= 1, "
                     f"got {tuple(x2d.shape)}")
  if (cols * x2d.element_size()) % 16 or x2d.data_ptr() % 16:
    raise ValueError(
        f"moments kernel needs rows of a multiple of 16 bytes on a 16-byte "
        f"boundary (TMA), got C={cols} x {x2d.element_size()} bytes at "
        f"address {x2d.data_ptr():#x}: C % {16 // x2d.element_size()} must "
        f"be 0 (an offset view needs .clone())")


def moments_cuda(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """Launch K1 on ``x2d``'s device, on the current stream, without
  synchronising. Raises on anything the kernel does not take
  (``check_moments_rows``)."""
  global MOMENTS_LAUNCHES
  if not x2d.is_cuda:
    raise ValueError(f"moments_cuda needs a CUDA tensor, got {x2d.device}")
  check_moments_rows(x2d)
  rows, cols = x2d.shape
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


# --- K2: the stats-given WC layer ------------------------------------------

_SCALING_CODES = {"trace": 0, "fro": 1}


def _check_scaling(scaling: str) -> int:
  if scaling not in _SCALING_CODES:
    raise ValueError(f"ns scaling must be 'trace' or 'fro', got {scaling!r}")
  return _SCALING_CODES[scaling]


def whiten_color_fold_reference(mean, cov, gamma, beta, ns_iters: int = 15,
                                eps: float = 1e-5, scaling: str = "trace"
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
  """K2's setup, plainly: (M, bias) with M = Gamma cov^{-1/2} by coupled
  Newton-Schulz and bias = beta - mean M^T, all float32."""
  a, scale, ident = whiten._jittered_normalized(cov, eps, scaling)
  _, z = whiten._ns_iterate(a, ident, ns_iters)
  m = gamma.float() @ (z / torch.sqrt(scale))
  return m, beta.float() - mean.float() @ m.T


def whiten_color_apply_reference(x2d: torch.Tensor, mean, cov, gamma, beta,
                                 ns_iters: int = 15, eps: float = 1e-5,
                                 scaling: str = "trace") -> torch.Tensor:
  """The plain version of K2: the fold, then x promoted to float32,
  x M^T + bias in float32, cast back to x's dtype."""
  m, bias = whiten_color_fold_reference(mean, cov, gamma, beta, ns_iters,
                                        eps, scaling)
  return (x2d.float() @ m.T + bias).to(x2d.dtype)


def _stats_f32(cols: int, dev: torch.device, mean, cov, gamma, beta):
  """The four statistics/coloring operands as contiguous float32 on
  ``dev`` with K2's shapes, or raise."""
  out = []
  for name, t, shape in (("mean", mean, (cols,)), ("cov", cov, (cols, cols)),
                         ("gamma", gamma, (cols, cols)),
                         ("beta", beta, (cols,))):
    if tuple(t.shape) != shape or t.device != dev:
      raise ValueError(f"whiten_color_apply: {name} must be {shape} on "
                       f"{dev}, got {tuple(t.shape)} on {t.device}")
    out.append(t.float().contiguous())
  return out


# K2 takes 8 <= C <= 512 with C % 8 == 0 (kMinCols, kMaxCols in
# csrc/wc_apply.cu, which refuses the rest too): a bf16 row must be a
# multiple of 16 bytes for the TMA unit.
K2_MAX_COLS = 512


def check_wc_cols(cols: int) -> None:
  """Raise unless K2 takes width ``cols``. Every WC width of the G presets
  (64 to 512, multiples of 64) passes."""
  if not (8 <= cols <= K2_MAX_COLS and cols % 8 == 0):
    raise ValueError(
        f"whiten_color_apply kernel takes 8 <= C <= {K2_MAX_COLS} with "
        f"C % 8 == 0 (bf16 rows of a multiple of 16 bytes for TMA), got "
        f"C={cols}")


def _check_rows(x2d: torch.Tensor) -> None:
  if not x2d.is_cuda:
    raise ValueError(f"whiten_color_apply_cuda needs a CUDA tensor, got "
                     f"{x2d.device}")
  if x2d.dtype not in _DTYPE_CODES:
    raise TypeError(f"whiten_color_apply kernel takes float32 or bfloat16 "
                    f"rows, got {x2d.dtype}")
  if x2d.dim() != 2 or not x2d.is_contiguous() or x2d.data_ptr() % 16:
    raise ValueError(f"whiten_color_apply kernel needs contiguous (R, C) "
                     f"rows on a 16-byte boundary, got shape "
                     f"{tuple(x2d.shape)} strides {x2d.stride()} at "
                     f"{x2d.data_ptr():#x}")
  if not 1 <= x2d.shape[0] < 2 ** 31:
    raise ValueError(f"whiten_color_apply kernel takes 1 <= R < 2^31 rows, "
                     f"got {tuple(x2d.shape)}")
  check_wc_cols(x2d.shape[1])


def _workspace(lib, cols: int, dev: torch.device) -> torch.Tensor:
  """K2's scratch for one call: the setup's Y, Z, T, M^T, bias and the bf16
  pieces of M. Released on return, before the kernels have run: the
  caching allocator hands its memory only to later work on this stream."""
  return torch.empty((lib.wcgan_wc_apply_workspace_floats(cols),),
                     dtype=torch.float32, device=dev)


def whiten_color_apply_cuda(x2d: torch.Tensor, mean, cov, gamma, beta,
                            ns_iters: int = 15, eps: float = 1e-5,
                            scaling: str = "trace") -> torch.Tensor:
  """Launch K2 on ``x2d``'s device, on the current stream, without
  synchronising: the setup (one cooperative launch) and the row apply.
  Raises on anything the kernel does not take, and when the setup's grid
  cannot be co-resident."""
  global WC_APPLY_LAUNCHES
  scaling_code = _check_scaling(scaling)
  _check_rows(x2d)
  rows, cols = x2d.shape
  if ns_iters < 0:
    raise ValueError(f"whiten_color_apply with ns_iters={ns_iters}")
  lib = _build.load_wc_apply()
  dev = x2d.device
  mean, cov, gamma, beta = _stats_f32(cols, dev, mean, cov, gamma, beta)
  out = torch.empty_like(x2d)
  workspace = _workspace(lib, cols, dev)
  stream = torch.cuda.current_stream(dev).cuda_stream
  err = lib.wcgan_whiten_color_apply(
      x2d.data_ptr(), _DTYPE_CODES[x2d.dtype], rows, cols, mean.data_ptr(),
      cov.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ns_iters, eps,
      scaling_code, out.data_ptr(), workspace.data_ptr(), stream)
  if err != 0:
    raise RuntimeError(f"whiten_color_apply kernel launch failed at "
                       f"{tuple(x2d.shape)} {x2d.dtype}: cudaError_t {err}")
  WC_APPLY_LAUNCHES += 1
  return out


def whiten_color_setup_cuda(mean, cov, gamma, beta, ns_iters: int = 15,
                            eps: float = 1e-5, scaling: str = "trace"
                            ) -> torch.Tensor:
  """K2's setup launch alone; returns the workspace it fills (M^T, the
  bias and the bf16 pieces of M), which ``whiten_color_rows_cuda`` takes.
  For timing and testing the two launches apart: not counted in
  ``WC_APPLY_LAUNCHES``, and no model path calls it."""
  scaling_code = _check_scaling(scaling)
  if not cov.is_cuda:
    raise ValueError(f"whiten_color_setup_cuda needs CUDA tensors, got "
                     f"{cov.device}")
  cols = cov.shape[-1]
  check_wc_cols(cols)
  if ns_iters < 0:
    raise ValueError(f"whiten_color_apply with ns_iters={ns_iters}")
  lib = _build.load_wc_apply()
  dev = cov.device
  mean, cov, gamma, beta = _stats_f32(cols, dev, mean, cov, gamma, beta)
  workspace = _workspace(lib, cols, dev)
  err = lib.wcgan_wc_setup(
      mean.data_ptr(), cov.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
      cols, ns_iters, eps, scaling_code, workspace.data_ptr(),
      torch.cuda.current_stream(dev).cuda_stream)
  if err != 0:
    raise RuntimeError(f"whiten_color_apply setup launch failed at C={cols}: "
                       f"cudaError_t {err}")
  return workspace


def whiten_color_fold_cuda(mean, cov, gamma, beta, ns_iters: int = 15,
                           eps: float = 1e-5, scaling: str = "trace"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
  """K2's setup alone: (M, bias) in float32 as
  ``whiten_color_fold_reference`` gives them (views of its workspace)."""
  workspace = whiten_color_setup_cuda(mean, cov, gamma, beta, ns_iters, eps,
                                      scaling)
  cols = cov.shape[-1]
  lib = _build.load_wc_apply()
  mt_at, bias_at = lib.wcgan_wc_mt_offset(cols), lib.wcgan_wc_bias_offset(cols)
  mt = workspace[mt_at:mt_at + cols * cols].view(cols, cols)
  return mt.T, workspace[bias_at:bias_at + cols]


def whiten_color_rows_cuda(x2d: torch.Tensor,
                           workspace: torch.Tensor) -> torch.Tensor:
  """K2's row-apply launch alone, out = x M^T + bias, on a workspace that
  ``whiten_color_setup_cuda`` filled for x's width. For timing; not
  counted in ``WC_APPLY_LAUNCHES``."""
  _check_rows(x2d)
  rows, cols = x2d.shape
  lib = _build.load_wc_apply()
  if (workspace.dtype != torch.float32 or workspace.device != x2d.device
      or workspace.numel() != lib.wcgan_wc_apply_workspace_floats(cols)):
    raise ValueError("whiten_color_rows_cuda needs the workspace of "
                     "whiten_color_setup_cuda at x's width and device")
  out = torch.empty_like(x2d)
  err = lib.wcgan_wc_rows(x2d.data_ptr(), _DTYPE_CODES[x2d.dtype], rows, cols,
                          workspace.data_ptr(), out.data_ptr(),
                          torch.cuda.current_stream(x2d.device).cuda_stream)
  if err != 0:
    raise RuntimeError(f"whiten_color_apply row launch failed at "
                       f"{tuple(x2d.shape)} {x2d.dtype}: cudaError_t {err}")
  return out


def whiten_color_apply(x2d: torch.Tensor, mean, cov, gamma, beta,
                       ns_iters: int = 15, eps: float = 1e-5,
                       scaling: str = "trace") -> torch.Tensor:
  """The WC transform given (mean, cov): out = (x - mean) (Gamma W)^T + beta
  with W = cov^{-1/2}, in x's dtype. K2 for a CUDA tensor, the plain
  version for a CPU tensor."""
  if x2d.is_cuda:
    return whiten_color_apply_cuda(x2d, mean, cov, gamma, beta, ns_iters,
                                   eps, scaling)
  if x2d.device.type == "cpu":
    return whiten_color_apply_reference(x2d, mean, cov, gamma, beta,
                                        ns_iters, eps, scaling)
  raise ValueError(f"whiten_color_apply: no kernel for device {x2d.device}")
