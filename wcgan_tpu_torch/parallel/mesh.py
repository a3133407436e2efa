"""Data parallelism over ``torch.distributed``: one process per replica.

Counterpart of ``wcgan_tpu/parallel/mesh.py``. The JAX package shards the
batch over a 1-D ``data`` mesh inside ``shard_map`` and reaches the other
replicas through ``lax.pmean`` on the axis name. Here each replica is a
process with its own device, and the axis name becomes a process group
that the caller passes to every layer and step that reduces over it
(``None`` = one process, the single-device path unchanged):

- ``init_group`` / ``destroy_group``: the group of this process, from an
  explicit rank, world size, rendezvous and timeout;
- ``backend_for``: NCCL when every rank has a GPU of its own, gloo for CPU
  ranks and for several ranks on one card (NCCL refuses two ranks on one
  GPU);
- ``pmean``: the differentiable mean over the ranks (``lax.pmean``), whose
  backward sums the cotangents over the ranks, as the transpose of
  ``pmean`` does under ``shard_map``; it differentiates again;
- ``pmean_many``: the means of a list of tensors from one coalesced
  all-reduce (gradients and losses), outside autograd;
- ``shard_block``: the contiguous block of rows of one rank, as
  ``NamedSharding(mesh, P('data'))`` lays the leading dim out;
  ``split_block`` the same for a count the ranks need not divide;
- ``all_gather_rows``: every rank's rows, concatenated in rank order on
  every rank (the scorer's activations; ``NamedSharding``'s gather on
  fetch);
- ``rank_generator``: a rank's own ``torch.Generator``, derived from the
  replicated one and the rank (the reference's
  ``fold_in(rng, axis_index)``).

``STATS`` counts the collectives issued in this process, with their
bytes, by what they carry.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


@dataclasses.dataclass
class CollectiveStats:
  """Collective calls and bytes by kind: all-reduces of 'moments'
  (whitening moments and BatchNorm statistics, forward and backward) and
  'grads' (gradients and losses of an update), and the all-gathers of
  'rows' (``all_gather_rows``, this rank's rows padded)."""

  calls: Dict[str, int] = dataclasses.field(default_factory=dict)
  bytes: Dict[str, int] = dataclasses.field(default_factory=dict)

  def add(self, kind: str, t: torch.Tensor) -> None:
    self.calls[kind] = self.calls.get(kind, 0) + 1
    self.bytes[kind] = self.bytes.get(kind, 0) + t.numel() * t.element_size()

  def reset(self) -> None:
    self.calls.clear()
    self.bytes.clear()


STATS = CollectiveStats()


def backend_for(devices: Sequence[torch.device]) -> str:
  """'nccl' when every rank has a CUDA device of its own, else 'gloo'."""
  cuda = [d for d in devices if d.type == "cuda"]
  if len(cuda) == len(devices) and len({d.index for d in cuda}) == len(cuda):
    return "nccl"
  return "gloo"


def init_group(rank: int, world_size: int, init_method: str, backend: str,
               timeout_s: float) -> dist.ProcessGroup:
  """Join the ``world_size`` ranks at ``init_method`` (``file://`` or
  ``tcp://``) and return the group that spans them. A collective that
  waits longer than ``timeout_s`` for another rank raises."""
  dist.init_process_group(backend, init_method=init_method, rank=rank,
                          world_size=world_size,
                          timeout=datetime.timedelta(seconds=timeout_s))
  return dist.group.WORLD


def destroy_group() -> None:
  if dist.is_initialized():
    dist.destroy_process_group()


def world_size(group: Group) -> int:
  return 1 if group is None else dist.get_world_size(group)


def rank(group: Group) -> int:
  return 0 if group is None else dist.get_rank(group)


def _all_reduce_sum(t: torch.Tensor, group: dist.ProcessGroup,
                    kind: str) -> None:
  STATS.add(kind, t)
  dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)


class _SumOverRanks(torch.autograd.Function):
  """all_reduce(SUM) in autograd: its backward is the same sum over the
  cotangents of every rank, itself through this function, so a second
  derivative reduces again."""

  @staticmethod
  def forward(ctx, x, group):
    ctx.group = group
    out = x.clone(memory_format=torch.contiguous_format)
    _all_reduce_sum(out, group, "moments")
    return out

  @staticmethod
  def backward(ctx, grad):
    return _SumOverRanks.apply(grad, ctx.group), None


def pmean(x: torch.Tensor, group: Group) -> torch.Tensor:
  """The mean of ``x`` over the ranks of ``group`` (``x`` itself when
  ``group`` is None), differentiable; counted as 'moments'."""
  if group is None:
    return x
  return _SumOverRanks.apply(x, group) / world_size(group)


def pmean_many(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup
               ) -> List[torch.Tensor]:
  """Each tensor's mean over the ranks, float32, outside autograd, from
  one all-reduce of their concatenation; counted as 'grads'."""
  flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
  _all_reduce_sum(flat, group, "grads")
  flat /= world_size(group)
  return [part.view(t.shape) for part, t in
          zip(flat.split([t.numel() for t in tensors]), tensors)]


def shard_block(n: int, rank_: int, world: int) -> Tuple[int, int]:
  """[start, stop) of rank ``rank_``'s rows of ``n`` split into ``world``
  equal contiguous blocks; ``n`` must divide."""
  if n % world:
    raise ValueError(f"{n} rows do not split into {world} equal blocks")
  per = n // world
  return rank_ * per, (rank_ + 1) * per


def split_block(n: int, rank_: int, world: int) -> Tuple[int, int]:
  """[start, stop) of rank ``rank_``'s rows of ``n`` split into ``world``
  contiguous blocks as equal as they can be: the first ``n % world``
  blocks hold one row more. ``shard_block`` where ``world`` divides
  ``n``."""
  per, extra = divmod(n, world)
  start = rank_ * per + min(rank_, extra)
  return start, start + per + int(rank_ < extra)


def all_gather_rows(t: torch.Tensor, group: Group) -> torch.Tensor:
  """The rows of ``t`` (k, ...) of every rank of ``group``, concatenated in
  rank order, on every rank (``t`` itself when ``group`` is None). The
  ranks may hold different k; the trailing shape and the dtype must
  agree. Each rank's block is padded to the longest, since gloo and NCCL
  gather equal blocks; counted as 'rows'."""
  if group is None:
    return t
  world = world_size(group)
  rows = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
  counts = [torch.empty_like(rows) for _ in range(world)]
  dist.all_gather(counts, rows, group=group)
  counts = [int(c) for c in counts]
  padded = t.new_zeros((max(counts),) + tuple(t.shape[1:]))
  padded[:t.shape[0]] = t
  blocks = [torch.empty_like(padded) for _ in range(world)]
  STATS.add("rows", padded)
  dist.all_gather(blocks, padded, group=group)
  return torch.cat([b[:c] for b, c in zip(blocks, counts)])


def rank_generator(gen: torch.Generator, rank_: int) -> torch.Generator:
  """A new generator on ``gen``'s device, seeded from ``gen``'s state and
  ``rank_``; then ``gen`` advances by one draw, the same on every rank.
  A replicated ``gen`` stays replicated and each rank draws apart, as the
  reference folds the replica index into the step's key. Reading the
  state does not wait for the device."""
  digest = hashlib.blake2b(gen.get_state().numpy().tobytes()
                           + rank_.to_bytes(8, "little"),
                           digest_size=8).digest()
  seed = int.from_bytes(digest, "little") & ((1 << 63) - 1)
  torch.randint(0, 2, (1,), generator=gen, device=gen.device)
  return torch.Generator(device=gen.device).manual_seed(seed)
