"""The comparison that decides ``correct``: the numbers read from what the
timed path produced, against the plain reference, each beside its limit.

Training (``train_numbers``), read from the window's own chain: set-up
makes its first calls through the window's call (a warm-up, a capture,
then replays), and the numbers are read from the last of them, a replay
of ``steps_per_call`` outer steps, at the program's own state:

- ``g_grad_gap``: the gradient of the call's last G update as G's Adam
  holds it (beta1 = 0, so its first moment is the gradient), leaf by
  leaf: |‖program‖ - ‖reference‖| over the larger of the reference's norm
  of that leaf and the median leaf's; the worst leaf. The reference
  evaluates the update at G as it was before it (worked back from G
  after it and Adam's moments), at D as the program left it, on the
  update's draws;
- ``d_grad_gap``: the same of the call's last D update, at D as it was
  before it (worked back the same way, its SN vectors from those the
  update left) and G before the G update, on the update's draws;
- ``change_gap``: each leaf's change over the call (parameters, running
  statistics and SN vectors) against the reference's, which follows the
  call's outer steps from the program's state before it (weights,
  buffers, Adam's moments and counts); the median leaf's of each model,
  the larger of the two.

Each is read at the program's own state because a bf16 run and the
float32 reference part within a few outer steps when each follows its
own course: Adam's first steps move a weight by about the learning rate
whatever its gradient, so rounding's sign on a near-zero gradient decides
a step, and a saturating hinge turns on which rows sit at its margin.
One update evaluated, or one chain followed, from the same state reads
rounding alone. The gradients catch a wrong loss, batch or draw (and a
lower precision); the change catches a wrong step size or a state that
does not move, which the gradients cannot see.

All leave out the parameters whose reference gradient is under a
thousandth of the median leaf's: the biases ahead of a whitening layer,
whose gradient is nought to rounding (the whitening takes the mean out),
so that the program's is rounding noise and Adam moves them by it alone.

Sampling (``sample_numbers``): ``image_gap``, the largest mean |program -
reference| in uint8 levels of one image, over the checked batches.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch

Tensors = Dict[str, torch.Tensor]
# Leaves with a reference gradient under this share of the median leaf's
# are left out of the change.
NOUGHT = 1e-3


def _norm(t: torch.Tensor) -> float:
  return float(torch.linalg.vector_norm(t.double()))


def _median(values: Iterable[float]) -> float:
  v = sorted(values)
  if not v:
    return 0.0
  mid = len(v) // 2
  return v[mid] if len(v) % 2 else 0.5 * (v[mid - 1] + v[mid])


def leaf_gaps(program: Tensors, reference: Tensors, names: List[str]
              ) -> Dict[str, float]:
  """Each leaf's |‖p‖ - ‖r‖| / max(‖r‖, median ‖r‖) over ``names`` (a
  leaf the program lacks has the norm 0)."""
  ref = {n: _norm(reference[n]) for n in names}
  floor = max(_median(ref.values()), 1e-30)
  out = {}
  for n in names:
    p = _norm(program[n]) if n in program else 0.0
    gap = abs(p - ref[n]) / max(ref[n], floor)
    out[n] = gap if math.isfinite(gap) else math.inf
  return out


def _worst(gaps: Dict[str, float]) -> Tuple[float, str]:
  if not gaps:
    return 0.0, ""
  name = max(gaps, key=gaps.get)
  return gaps[name], name


def _moved(grads: Tensors) -> List[str]:
  """The leaves whose gradient is not nought to rounding (``NOUGHT``)."""
  norms = {n: _norm(g) for n, g in grads.items()}
  floor = _median(norms.values())
  return sorted(n for n in norms if norms[n] >= NOUGHT * floor)


def train_numbers(before: Dict[str, dict], after: Dict[str, dict],
                  at_grads: Dict[str, Tensors],
                  followed: Dict[str, Tensors],
                  buffers: Dict[str, List[str]], side: dict = None
                  ) -> Dict[str, dict]:
  """The three training numbers (see the module's docstring), each with
  where it was read. ``before`` and ``after``: the program's state around
  the checked call, by model ('g', 'd'): its ``tensors``, Adam's moments
  ``m`` and ``v`` and count ``t``; ``at_grads``: the reference's gradient
  of each model's last update of the call at the program's state;
  ``followed``: every tensor of the reference after following the call
  from ``before``. ``side`` holds readings given beside the numbers."""
  out: Dict[str, dict] = {}
  medians, worst = {}, {}
  for m in ("g", "d"):
    moved = _moved(at_grads[m])
    gap, at = _worst(leaf_gaps(after[m]["m"], at_grads[m], moved))
    out[f"{m}_grad_gap"] = {"value": gap, "at": at}
    names = moved + buffers[m]
    start = before[m]["tensors"]
    delta_p = {n: after[m]["tensors"][n] - start[n] for n in names}
    delta_r = {n: followed[m][n] - start[n] for n in names}
    gaps = leaf_gaps(delta_p, delta_r, names)
    medians[m] = _median(gaps.values())
    worst[m] = list(_worst(gaps))
  out["change_gap"] = {"value": max(medians.values()), "by_model": medians,
                       "worst_leaf": worst}
  out["change_gap"].update(side or {})
  return out


def sample_numbers(program_u8: List[torch.Tensor],
                   reference_u8: List[torch.Tensor]) -> Dict[str, dict]:
  """``image_gap``: the largest per-image mean absolute difference in
  uint8 levels, over the checked batches (N, H, W, C)."""
  worst = 0.0
  for p, r in zip(program_u8, reference_u8):
    per_image = (p.float() - r.float()).abs().flatten(1).mean(1)
    worst = max(worst, float(per_image.max()))
  return {"image_gap": {"value": worst}}


def judge(numbers: Dict[str, dict], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
  """(every number finite and within its limit, the numbers with their
  limits)."""
  out, ok = {}, True
  for name, limit in limits.items():
    value = numbers[name]["value"]
    out[name] = {"value": value, "limit": limit}
    ok = ok and math.isfinite(value) and value <= limit
  return ok, out
