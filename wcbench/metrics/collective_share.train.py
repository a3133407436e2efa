"""collective_share.train: the share of the traced slice's busy time (the
union of every kernel's intervals) in which an NCCL kernel ran
(``work/kernels.py::is_nccl``), in %. An NCCL kernel runs from its launch
until its peers have sent their part, so the share holds this rank's wait
for the others too. Nothing to read on one card."""

from wcbench.work import kernels


def read(ctx):
  s = ctx.slice
  if s is None or ctx.run.world < 2:
    return None
  busy, nccl = s.busy_s(), s.kernel_time_s(kernels.is_nccl)
  if busy <= 0 or nccl <= 0:
    return None
  return 100.0 * nccl / busy
