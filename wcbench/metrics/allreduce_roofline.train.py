"""allreduce_roofline.train: the least time of the traced slice's
all-reduces (``work/collectives.py``: each one's bytes, from the
configuration's shapes, x 2(n - 1)/n over one card's NVLink bandwidth in
one direction, nothing for latency) over the time of the NCCL kernels in
the slice (``work/kernels.py::is_nccl``); in %. Nothing to read on one
card."""

from wcbench.work import collectives, kernels


def read(ctx):
  s = ctx.slice
  if s is None or not ctx.result.slice_steps or ctx.run.world < 2:
    return None
  spent = s.kernel_time_s(kernels.is_nccl)
  if spent <= 0:
    return None
  least = (collectives.least_s_per_step(ctx.cfg, ctx.run.world)
           * ctx.result.slice_steps)
  return 100.0 * least / spent
