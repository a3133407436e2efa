"""Batch whitening numerics — the core of the WC transform, in PyTorch.

Counterpart of ``wcgan_tpu/ops/whiten.py``: per-batch channel mean and full
covariance, the coupled Newton–Schulz inverse square root (Cholesky kept as
the oracle), and the application ``x_hat = (x - mu) W^T``.

The whitening products take the reference's precision switch
(``set_precision``, ``--whitening_precision``): 'highest' (the port's
default) runs them as true float32 matmuls, which on a GPU means
``torch.backends.cuda.matmul.allow_tf32 = False`` (the port's entry points
set and print it); 'high' runs them as bf16x3 (``ops.mm_bf16x3``: K3 on
the card, its plain version on the CPU), the 3-pass bf16 emulation that
XLA's ``Precision.HIGH`` is on the TPU and the JAX package's default.
Nothing coarser: under single-pass reduced precision (bf16, TF32-class)
Newton–Schulz plateaus near 2e-2 instead of converging (measured on the
reference, ``wcgan_tpu/ops/whiten.py``). The port keeps 'highest' as its
default because on the CPU JAX's HIGH is exact float32 while the port's
'high' runs the emulation, so its CPU parity tests hold 'highest' against
JAX. Under data parallelism the moments are those of the global batch:
``batch_moments`` takes the reference's ``axis_name`` as a process group
(``wcgan_tpu_torch.parallel.mesh``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch

from wcgan_tpu_torch.ops import cuda_wc
from wcgan_tpu_torch.ops.mm_bf16x3 import mm_bf16x3
from wcgan_tpu_torch.parallel import mesh

# The precision of every whitening-path product, JAX's ``_PRECISION``:
# 'highest' (true float32) or 'high' (bf16x3). Set once at start-up, before
# a step is built or captured; every compiled program's key holds it
# (``compiled.backend_key``, the step's key), so a captured graph is never
# replayed under the other.
_PRECISIONS = ("highest", "high")
_PRECISION = "highest"


def set_precision(name: str) -> None:
  """Set the precision of the whitening-path products: 'highest' (the
  default, true float32) or 'high' (bf16x3, XLA's HIGH)."""
  global _PRECISION
  if name not in _PRECISIONS:
    raise ValueError(f"whitening precision must be 'highest' or 'high', "
                     f"got {name!r}")
  _PRECISION = name


def get_precision() -> str:
  return _PRECISION


@contextlib.contextmanager
def precision(name: str):
  """The whitening precision ``name`` inside the block, the one set before
  it after."""
  saved = _PRECISION
  set_precision(name)
  try:
    yield
  finally:
    set_precision(saved)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """A whitening-path product at the set precision: ``a @ b`` under
  'highest', ``mm_bf16x3(a, b)`` under 'high'."""
  if _PRECISION == "high":
    return mm_bf16x3(a, b)
  return a @ b


def batch_moments(x2d: torch.Tensor, use_kernel: Optional[bool] = None,
                  group: mesh.Group = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Mean (C,) and covariance (C, C) of the rows of ``x2d`` (R, C), float32.

  ``use_kernel`` mirrors the reference's ``use_pallas``: None picks K1
  (``cuda_wc.moments``) for a CUDA tensor and the plain path otherwise;
  True routes through K1's wrapper (which on a CPU tensor runs its plain
  version, with K1's analytic gradient); False is the plain autograd path.
  Both are two-pass centered: the one-pass E[xx^T] - mu mu^T cancels
  catastrophically when |mu| >> sigma.

  With a ``group`` (every rank holding as many rows) the moments are those
  of the rows of all ranks, by the reference's two routes: K1 centres on
  the local mean, and the parallel-variance formula combines the ranks,
  Sigma = pmean(Sigma_r + (mu_r - mu)(mu_r - mu)^T), mu = pmean(mu_r); the
  plain route reduces the mean first, centres on it, and averages the
  covariances. ``mesh.pmean`` carries the gradient across the ranks."""
  if use_kernel is None:
    use_kernel = x2d.is_cuda
  if use_kernel:
    mean, cov = cuda_wc.moments(x2d)
    if group is not None:
      gmean = mesh.pmean(mean, group)
      d = mean - gmean
      cov = mesh.pmean(cov + torch.outer(d, d), group)
      mean = gmean
    return mean, cov
  if group is None:
    return cuda_wc.moments_reference(x2d, _mm)
  x = x2d.float()
  mean = mesh.pmean(x.mean(dim=0), group)
  xc = x - mean
  return mean, mesh.pmean(_mm(xc.T, xc) / x.shape[0], group)


def _spd_jitter(cov: torch.Tensor, eps: float) -> torch.Tensor:
  """The SPD-safety jitter shared by the Newton–Schulz and Cholesky paths:
  eps * mean diagonal (scale-relative conditioning), plus twice any
  negative diagonal (rounding junk of near-constant features), plus 1e-12
  so an all-zero covariance stays SPD."""
  c = cov.shape[-1]
  diag = torch.diagonal(cov)
  mean_diag = torch.clamp(diag.sum() / c, min=0.0)
  neg_diag = torch.clamp(-diag.min(), min=0.0)
  return eps * mean_diag + 2.0 * neg_diag + 1e-12


class _Trace(torch.autograd.Function):
  """``torch.trace`` with a backward that stays on the device. Trace's own
  backward writes its gradient on the diagonal with ``index_fill_`` of a
  tensor value, which reads it on the host, and a captured step (a CUDA
  graph) cannot do that. This one writes it with ``index_copy``: the same
  values, and, differentiated again (WGAN-GP's double backward), the same
  gather and sum of the diagonal, so the same rounding."""

  @staticmethod
  def forward(ctx, a):
    ctx.n = a.shape[-1]
    return torch.trace(a)

  @staticmethod
  def backward(ctx, grad):
    n = ctx.n
    diagonal = torch.arange(0, n * n, n + 1, device=grad.device)
    return torch.zeros(n * n, dtype=grad.dtype, device=grad.device
                       ).index_copy(0, diagonal, grad.expand(n)).view(n, n)


def _jittered_normalized(cov: torch.Tensor, eps: float,
                         scaling: str = "trace"):
  """((cov + jitter I) / s, s, I) with s the trace or the Frobenius norm;
  either puts the spectrum in (0, 1] so Newton–Schulz converges."""
  cov = cov.float()
  c = cov.shape[-1]
  ident = torch.eye(c, dtype=torch.float32, device=cov.device)
  a = cov + _spd_jitter(cov, eps) * ident
  if scaling == "trace":
    scale = _Trace.apply(a)
  elif scaling == "fro":
    scale = torch.sqrt(torch.sum(a * a))
  else:
    raise ValueError(f"ns scaling must be 'trace' or 'fro', got {scaling!r}")
  return a / scale, scale, ident


def _ns_iterate(a: torch.Tensor, ident: torch.Tensor, num_iters: int,
                mm: Optional[Callable] = None):
  """The coupled Newton–Schulz iteration, unrolled; returns (Y, Z).

  Y_0 = A, Z_0 = I; T = (3I - Z Y)/2; Y <- Y T; Z <- T Z. Autograd runs
  through the loop, as the reference differentiates through its scan.
  The products are ``mm``'s, by default the set precision's (``_mm``)."""
  mm = mm or _mm
  y, z = a, ident
  for _ in range(num_iters):
    t = 1.5 * ident - 0.5 * mm(z, y)
    y = mm(y, t)
    z = mm(t, z)
  return y, z


def newton_schulz_inv_sqrt(cov: torch.Tensor, num_iters: int = 15,
                           eps: float = 1e-5,
                           scaling: str = "trace") -> torch.Tensor:
  """W with W cov W^T ~= I: Z_k -> A^{-1/2}, so cov^{-1/2} = Z / sqrt(s).

  Keep ``num_iters`` at 15 or more at WC-GAN shapes: fewer under-converge
  once the conditioning passes ~1e3 and feed back into it (measured on the
  reference)."""
  a, scale, ident = _jittered_normalized(cov, eps, scaling)
  _, z = _ns_iterate(a, ident, num_iters)
  return z / torch.sqrt(scale)


def newton_schulz_sqrt(cov: torch.Tensor, num_iters: int = 15,
                       eps: float = 1e-5,
                       scaling: str = "trace") -> torch.Tensor:
  """The principal square root of ``cov`` + jitter: the Y branch of the
  same coupled iteration, Y_k -> A^{1/2}, so the root is Y sqrt(s). The
  FID's matmul-only method (``evaluation.metrics``) runs on it."""
  a, scale, ident = _jittered_normalized(cov, eps, scaling)
  y, _ = _ns_iterate(a, ident, num_iters)
  return y * torch.sqrt(scale)


def cholesky_inv_sqrt(cov: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
  """The oracle: lower-triangular L^{-1} with L L^T = cov + jitter I, so
  W cov W^T = I. A matrix that is not positive definite gives NaN, as
  ``jnp.linalg.cholesky`` does, decided on the device (a captured step
  cannot read the factorization's status on the host)."""
  cov = cov.float()
  ident = torch.eye(cov.shape[-1], dtype=torch.float32, device=cov.device)
  chol, info = torch.linalg.cholesky_ex(cov + _spd_jitter(cov, eps) * ident)
  chol = torch.where(info == 0, chol, torch.full_like(chol, float("nan")))
  return torch.linalg.solve_triangular(chol, ident, upper=False)


def inv_sqrt(cov: torch.Tensor, num_iters: int = 15, eps: float = 1e-5,
             method: str = "newton_schulz",
             scaling: str = "trace") -> torch.Tensor:
  """Dispatch: 'newton_schulz' (the hot path) or 'cholesky' (the oracle)."""
  if method == "newton_schulz":
    return newton_schulz_inv_sqrt(cov, num_iters=num_iters, eps=eps,
                                  scaling=scaling)
  if method == "cholesky":
    return cholesky_inv_sqrt(cov, eps=eps)
  raise ValueError(f"unknown inv-sqrt method: {method!r}")


def whiten_apply(x2d: torch.Tensor, mean: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
  """``(x - mean) W^T`` in x's dtype. bfloat16 rows run one bfloat16
  matmul with the mean folded into a bias computed at the set precision;
  float32 rows stay float32 throughout, their product at the set
  precision."""
  if x2d.dtype == torch.bfloat16:
    bias = -_mm(mean, w.T)
    return x2d @ w.T.to(torch.bfloat16) + bias.to(torch.bfloat16)
  return _mm(x2d.float() - mean, w.T).to(x2d.dtype)


def stats_select_and_ema(batch_mean, batch_cov, moving_mean, moving_cov, *,
                         use_batch: bool, momentum: float):
  """The 'd'/'dr' stats contract: the transform's source moments are the
  batch statistics ('d', ``use_batch=True``) or the pre-update running
  statistics ('dr'); the running statistics EMA-update from the batch
  either way. Returns (mean, stat_src, new_moving_mean, new_moving_cov)."""
  new_mean = momentum * moving_mean.float() + (1.0 - momentum) * batch_mean
  new_cov = momentum * moving_cov.float() + (1.0 - momentum) * batch_cov
  if use_batch:
    return batch_mean, batch_cov, new_mean, new_cov
  return moving_mean.float(), moving_cov.float(), new_mean, new_cov


def whiten_eval(x2d: torch.Tensor, moving_mean: torch.Tensor,
                moving_cov: torch.Tensor, *, eps: float = 1e-5,
                num_iters: int = 15, method: str = "newton_schulz",
                scaling: str = "trace") -> torch.Tensor:
  """Inference-mode whitening from given (running) statistics: the split
  path, W computed first, then one row pass."""
  w = inv_sqrt(moving_cov.float(), num_iters=num_iters, eps=eps,
               method=method, scaling=scaling)
  return whiten_apply(x2d, moving_mean.float(), w)
