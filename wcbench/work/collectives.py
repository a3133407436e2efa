"""The bytes of the configuration's collectives, from its shapes: what one
outer step of data-parallel training all-reduces, by what it carries, as
``wcgan_tpu_torch.parallel.mesh.STATS`` names the kinds (every tensor
float32):

- 'moments': each train-mode WC layer's batch mean (C) and covariance
  (C x C), one all-reduce each, in every train-mode G forward of the step
  (the K D updates' fakes and the G update's forward), and the same two
  again in the G update's backward (their gradients);
- 'grads': each update's loss and gradients, one all-reduce of their
  concatenation: K of D's parameters, one of G's.

``wcbench/tests/test_wcbench_collectives.py`` holds these bytes equal to
the program's counter over one outer step on two ranks.

The least time of an all-reduce of b bytes over n ranks is b x 2(n - 1)/n
over one card's NVLink bandwidth in one direction: a ring all-reduce sends
(and receives) each of its 2(n - 1) steps' chunks of b / n once; latency
counts nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from wcbench.reference import wcgan
from wcbench.work import shapes as S

# One H100 SXM card's NVLink bandwidth in one direction: 18 NVLink 4 links
# of 26.562 GB/s each (``nvidia-smi nvlink -s`` on the four-card host reads
# 26.562 GB/s on each of the 18 links of each of the 4 cards; its
# ``nvidia-smi topo -m`` reads nothing there).
NVLINK_BYTES_PER_S = 18 * 26.562e9
FLOAT32 = 4


@dataclasses.dataclass(frozen=True)
class AllReduce:
  """One all-reduce of ``bytes`` of the kind ``kind``."""

  kind: str
  bytes: int

  def least_s(self, ranks: int) -> float:
    return self.bytes * 2 * (ranks - 1) / ranks / NVLINK_BYTES_PER_S


def _params(specs) -> int:
  return sum(int(np.prod(shape)) for name, shape, _ in specs
             if not wcgan.is_buffer(name))


def allreduces_per_step(cfg: dict) -> List[AllReduce]:
  """Every all-reduce of one outer step, in no particular order."""
  k = cfg["gan"]["training_ratio"]
  stats = []
  for l in S.wc_layers(cfg):
    stats += [AllReduce("moments", FLOAT32 * l.c),
              AllReduce("moments", FLOAT32 * l.c * l.c)]
  # K fakes' forwards, the G update's forward and its backward.
  out = stats * (k + 2)
  out += [AllReduce("grads", FLOAT32 * (1 + _params(wcgan.d_specs(cfg))))] * k
  out.append(AllReduce("grads", FLOAT32 * (1 + _params(wcgan.g_specs(cfg)))))
  return out


def per_step(cfg: dict) -> Dict[str, Dict[str, int]]:
  """{"calls": {kind: n}, "bytes": {kind: b}} of one outer step, as
  ``mesh.STATS`` holds them."""
  out: Dict[str, Dict[str, int]] = {"calls": {}, "bytes": {}}
  for a in allreduces_per_step(cfg):
    out["calls"][a.kind] = out["calls"].get(a.kind, 0) + 1
    out["bytes"][a.kind] = out["bytes"].get(a.kind, 0) + a.bytes
  return out


def least_s_per_step(cfg: dict, ranks: int) -> float:
  """The least time of one outer step's all-reduces over ``ranks``."""
  return sum(a.least_s(ranks) for a in allreduces_per_step(cfg))
