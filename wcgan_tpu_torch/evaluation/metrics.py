"""IS and FID math on the device, float32.

Counterpart of ``wcgan_tpu/evaluation/metrics.py``:

- Inception Score: exp(E_x KL(p(y|x) || p(y))) over ``splits`` contiguous
  splits, its mean and its population standard deviation (``jnp.std``'s
  ddof 0, hence ``correction=0``);
- FID: ||mu1 - mu2||^2 + Tr(S1 + S2 - 2 (S1 S2)^{1/2}), with
  Tr (S1 S2)^{1/2} = Tr (S1^{1/2} S2 S1^{1/2})^{1/2} (similar matrices; the
  inner form is SPD). ``method='eigh'`` (the default) takes both square
  roots by ``eigh``, the eigenvalues clamped at 0, and the trace as the
  sum of the singular values of S2^{1/2} S1^{1/2}, whose Gram matrix is
  the inner form. The reference takes the eigenvalues of the inner form
  itself, which squares its condition number: on near-singular
  covariances, such as a randomly initialized InceptionV3's, that loses
  digits float32 does not have (ROADMAP.md, queue 3, has the numbers).
  ``method='ns'`` is the reference's Newton-Schulz route. The
  covariance divides by n - 1 (``np.cov``'s convention), so K1, which
  divides by R, is not used for it; neither is it in the reference.

Every product here must run in true float32, as the reference's
``Precision.HIGHEST`` does: under TF32 (10-bit mantissas) the trace of
the geometric-mean term of a near-singular 2048-d covariance loses the
digits a FID is read to. PyTorch's default is true float32 matmuls, but a
caller may have turned TF32 on, so each function pins it off for its own
work (``true_float32``) and puts the caller's setting back.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import torch

from wcgan_tpu_torch.ops import whiten


@contextlib.contextmanager
def true_float32() -> Iterator[None]:
  """TF32 off for CUDA matmuls and cuDNN convolutions inside the block;
  the caller's settings are restored on the way out."""
  matmul = torch.backends.cuda.matmul.allow_tf32
  conv = torch.backends.cudnn.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = conv


def inception_score(probs: torch.Tensor, splits: int = 10
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(mean, std) of exp(E KL(p(y|x) || p(y))) over ``splits`` splits of
  ``probs`` (N, classes), softmax outputs; the tail that does not fill a
  split is dropped, as in the reference."""
  probs = probs.float()
  per = probs.shape[0] // splits
  probs = probs[:per * splits].reshape(splits, per, -1)
  marginal = probs.mean(dim=1, keepdim=True)
  kl = torch.sum(probs * (torch.log(probs + 1e-16)
                          - torch.log(marginal + 1e-16)), dim=-1)
  scores = torch.exp(kl.mean(dim=1))
  return scores.mean(), scores.std(correction=0)


def moments_from_activations(acts: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(mu, covariance) of activation rows, the covariance unbiased (n - 1)
  like ``np.cov``: the FID convention."""
  acts = acts.float()
  mu = acts.mean(dim=0)
  xc = acts - mu
  with true_float32():
    sigma = xc.T @ xc / (acts.shape[0] - 1)
  return mu, sigma


def _pow2_scale(a: torch.Tensor) -> torch.Tensor:
  """The power of two nearest max|a| (1 for a zero matrix): dividing by
  it is exact."""
  top = a.abs().max()
  return torch.where(top > 0, torch.exp2(torch.round(torch.log2(top))),
                     torch.ones_like(top))


def _sqrtm_eigh(s: torch.Tensor) -> torch.Tensor:
  """The SPD square root by eigendecomposition, the eigenvalues clamped at
  0 (Inception covariances from fewer samples than dimensions are
  rank-deficient). The eigendecomposition runs at unit scale: on entries
  ~1e-14 (products of a random InceptionV3's covariances) float32
  ``eigh`` fails or returns NaN, on the CPU and on the card."""
  scale = _pow2_scale(s)
  w, v = torch.linalg.eigh(s / scale)
  with true_float32():
    return (v * torch.sqrt(torch.clamp(w * scale, min=0.0))) @ v.T


def _nuclear_norm(a: torch.Tensor) -> torch.Tensor:
  """The sum of the singular values of ``a``, computed at unit scale."""
  scale = _pow2_scale(a)
  return torch.linalg.svdvals(a / scale).sum() * scale


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6,
                     num_iters: int = 20,
                     method: str = "eigh") -> torch.Tensor:
  """||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrtm(S1 S2)), at least 0.

  method='eigh' (default): square roots by eigendecomposition and the
  trace by singular values (the module's docstring); the 2048-d
  covariances of 10k samples are near-singular, where Newton-Schulz
  converges slowly. method='ns': the reference's matmul-only route,
  Newton-Schulz square roots (``num_iters`` iterations, jitter ``eps``) of
  S1 and of the symmetrized inner form. Another method raises."""
  if method not in ("eigh", "ns"):
    raise ValueError(f"frechet_distance method must be 'eigh' or 'ns', got "
                     f"{method!r}")
  mu1, mu2 = mu1.float(), mu2.float()
  s1, s2 = sigma1.float(), sigma2.float()
  with true_float32():
    diff = torch.sum(torch.square(mu1 - mu2))
    if method == "eigh":
      tr_geo = _nuclear_norm(_sqrtm_eigh(s2) @ _sqrtm_eigh(s1))
    else:
      s1_half = whiten.newton_schulz_sqrt(s1, num_iters=num_iters, eps=eps)
      inner = s1_half @ s2 @ s1_half
      # Symmetrized against rounding before the second square root.
      inner = 0.5 * (inner + inner.T)
      tr_geo = torch.trace(whiten.newton_schulz_sqrt(
          inner, num_iters=num_iters, eps=eps))
    fid = diff + torch.trace(s1) + torch.trace(s2) - 2.0 * tr_geo
  # A true Frechet distance is >= 0; a small negative is the square
  # roots' rounding.
  return torch.clamp(fid, min=0.0)


def fid_from_moments(mu1, sigma1, mu2, sigma2, **kw) -> float:
  return float(frechet_distance(mu1, sigma1, mu2, sigma2, **kw))
