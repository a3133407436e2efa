"""Operations and bytes of the configuration's work, from its shapes.

Model FLOPs count every product of the algorithm at 2MNK and every
convolution at 2 x batch x out pixels x C_out x C_in x k^2, forward and
backward, as ``torch.utils.flop_counter.FlopCounterMode`` counts the
program's eager step on its plain paths (the moments as one product
(x - mu)^T (x - mu), the whitening products in true float32):
elementwise work is not counted, nor a matrix-vector product (the spectral
norm's W v). ``wcbench/tests/test_wcbench_counts.py`` holds the two equal.
The backward counts each operand's gradient only where autograd needs it:
nothing for the images, nothing for the D weights in the G update,
nothing for the last Newton-Schulz Y.

Per-kernel lists (K1 ``moments``, K3 ``mm_bf16x3``) give each call's
shapes, for the roofline shares: the least time of a call is the larger
of its operations over the peak of the units that run them and its bytes
over the memory bandwidth, each input byte read once and each output
byte written once.
"""

from __future__ import annotations

import dataclasses
from typing import List

from wcbench.work import shapes as S

# Published peaks of one H100 SXM (NVIDIA's data sheet; dense, 700 W).
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
HBM_BYTES_PER_S = 3.35e12


def _ns_products(iters: int, backward: bool) -> int:
  """C x C products of one coupled Newton-Schulz inverse square root:
  3 an iteration forward; backward, 2 a product, but none for the first
  iteration's Z = I operand and none for the last Y, which nothing reads:
  6 n - 4."""
  return 6 * iters - 4 if backward else 3 * iters


def _conv_flops(l: S.Conv, n: int) -> int:
  return 2 * n * l.size * l.size * l.cout * l.cin * l.k * l.k


def _wc_flops(l: S.WC, n: int, iters: int, num_emb: int,
              train: bool, backward: bool) -> int:
  """A fused WC layer at batch n: moments (train), Newton-Schulz, the fold
  and the row products; with ``backward`` the gradients of the same."""
  c, rows, s = l.c, n * l.size * l.size, l.size * l.size
  mul = 2 if backward else 1
  ns = _ns_products(iters, backward) * 2 * c ** 3
  moments = 2 * rows * c * c * (2 if backward else 1) if train else 0
  if l.coloring == "uconv":
    # M = Gamma W, bias = beta - mu M^T, rows x M^T.
    fold = (2 * c ** 3 + 2 * c * c + 2 * rows * c * c) * mul
  elif l.coloring == "ucconv-sa":
    mix = 2 * n * num_emb * c * c * mul          # sum_k A[y, k] basis_k
    if s >= c:                                   # per-image fold
      fold = (2 * n * c ** 3 + 2 * n * c * c + 2 * rows * c * c) * mul
    else:                                        # two row passes
      fold = (2 * c * c + 4 * rows * c * c) * mul
    fold += mix
  else:
    raise ValueError(f"no work count for coloring {l.coloring!r}")
  return moments + ns + fold


def g_forward_flops(cfg: dict, n: int, train: bool) -> int:
  g = cfg["generator"]
  total = 0
  for l in S.g_layers(cfg):
    if isinstance(l, S.WC):
      total += _wc_flops(l, n, g["ns_iters"], g.get("filters_emb", 0),
                         train, False)
    else:
      total += _conv_flops(l, n)
  return total


def g_backward_flops(cfg: dict, n: int) -> int:
  """Every G product's operand gradients (the G update), but z's."""
  g = cfg["generator"]
  total = 0
  for l in S.g_layers(cfg):
    if isinstance(l, S.WC):
      total += _wc_flops(l, n, g["ns_iters"], g.get("filters_emb", 0),
                         True, True)
    else:
      total += _conv_flops(l, n) * (1 if l.name == "fc_in" else 2)
  return total


def _sn_flops(cfg: dict) -> int:
  """The spectral norms of one D forward: u W and sigma's u' W, each
  2 x rows x cols (W v is a matrix-vector product, not counted)."""
  total = sum(2 * 2 * l.cout * l.cin * l.k * l.k for l in S.d_layers(cfg))
  if S.projection(cfg):
    total += 2 * 2 * S.d_features(cfg) * S.num_classes(cfg)
  return total


def d_forward_flops(cfg: dict, n: int) -> int:
  return sum(_conv_flops(l, n) for l in S.d_layers(cfg)) + _sn_flops(cfg)


def d_backward_flops(cfg: dict, n: int, weights: bool) -> int:
  """D's backward at batch n: input gradients wherever an input needs one
  (all but the images' in the D update: ``weights``), weight gradients and
  sigma's (u' W) in the D update only."""
  total = 0
  for l in S.d_layers(cfg):
    f = _conv_flops(l, n)
    needs_input = not (weights and l.image_input)
    total += f * (int(needs_input) + int(weights))
    if weights:
      total += 2 * l.cout * l.cin * l.k * l.k
  if weights and S.projection(cfg):
    total += 2 * S.d_features(cfg) * S.num_classes(cfg)
  return total


def outer_step_flops(cfg: dict, batch: int) -> int:
  """Model FLOPs of one outer step at global batch ``batch``: K D updates
  (a train-mode G forward at B without gradients, D on the 2B real and
  fake images, its backward), then the G update (G and D at gB, G's
  backward through D)."""
  gan = cfg["gan"]
  k, gb = gan["training_ratio"], batch * gan["generator_batch_multiple"]
  d_update = (g_forward_flops(cfg, batch, True)
              + d_forward_flops(cfg, 2 * batch)
              + d_backward_flops(cfg, 2 * batch, True))
  g_update = (g_forward_flops(cfg, gb, True) + d_forward_flops(cfg, gb)
              + d_backward_flops(cfg, gb, False) + g_backward_flops(cfg, gb))
  return k * d_update + g_update


def eval_forward_flops(cfg: dict, batch: int) -> int:
  """Model FLOPs of one eval-mode G forward (running statistics, no
  moments) at ``batch``."""
  return g_forward_flops(cfg, batch, False)


@dataclasses.dataclass(frozen=True)
class Call:
  """One kernel call: its operations, the peak of the units they need,
  and its bytes."""

  flops: float
  peak: float
  bytes: float

  @property
  def least_s(self) -> float:
    return max(self.flops / self.peak, self.bytes / HBM_BYTES_PER_S)


def k1_calls_per_step(cfg: dict, batch: int, act_bytes: int) -> List[Call]:
  """K1 ``moments``: one call per WC layer of every train-mode G forward
  of an outer step (K at B, one at gB), on (R, C) rows of ``act_bytes``
  bytes an element. Its Gram is float32 to rounding, as three TF32
  tensor-core products (the kernel's algorithm): 3 x 2RC^2 at the TF32
  peak; bytes: the rows read once, the float32 mean and covariance
  written."""
  gan = cfg["gan"]
  k, gb = gan["training_ratio"], batch * gan["generator_batch_multiple"]
  out = []
  for n in [batch] * k + [gb]:
    for l in S.wc_layers(cfg):
      r, c = n * l.size * l.size, l.c
      out.append(Call(3 * 2 * r * c * c, PEAK_TF32,
                      r * c * act_bytes + 4 * (c + c * c)))
  return out


def _bf16x3(m: int, n: int, k: int) -> Call:
  """One K3 product (M, K) x (K, N) in float32 operands: three bf16
  tensor-core products (hi hi, hi lo, lo hi) at the bf16 peak; bytes: A,
  B read, C written, float32."""
  return Call(3 * 2 * m * n * k, PEAK_BF16, 4 * (m * k + k * n + m * n))


def k3_calls_per_step(cfg: dict, batch: int) -> List[Call]:
  """K3 ``mm_bf16x3`` under 'high' in one outer step: every Newton-Schulz
  product of every train-mode G forward (3 an iteration), their gradients
  in the G update (6 n - 4 a layer), and K1's backward row product
  (x - mu)(dS + dS^T), (R, C) x (C, C), one a layer in the G update."""
  gan = cfg["gan"]
  k, gb = gan["training_ratio"], batch * gan["generator_batch_multiple"]
  iters = cfg["generator"]["ns_iters"]
  out = []
  for l in S.wc_layers(cfg):
    c = l.c
    fwd = _ns_products(iters, False) * (k + 1)
    bwd = _ns_products(iters, True)
    out += [_bf16x3(c, c, c)] * (fwd + bwd)
    out.append(_bf16x3(gb * l.size * l.size, c, c))
  return out


def k3_calls_per_eval_forward(cfg: dict) -> List[Call]:
  """K3 under 'high' in one eval-mode G forward: the Newton-Schulz
  products of every WC layer on its running covariance."""
  iters = cfg["generator"]["ns_iters"]
  out = []
  for l in S.wc_layers(cfg):
    out += [_bf16x3(l.c, l.c, l.c)] * _ns_products(iters, False)
  return out
