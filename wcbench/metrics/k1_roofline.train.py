"""k1_roofline.train: the least time of the traced slice's K1 ``moments``
calls (``work/counts.py::k1_calls_per_step``: 3 x 2RC^2 at the TF32 peak
against the rows read once and the moments written, the larger) over the
time of K1's kernels in the slice; in %."""

from wcbench.work import counts, kernels

ACT_BYTES = {"bfloat16": 2, "float32": 4}


def read(ctx):
  s = ctx.slice
  if s is None or not ctx.result.slice_steps:
    return None
  spent = s.kernel_time_s(kernels.is_k1)
  if spent <= 0:
    return None
  calls = counts.k1_calls_per_step(ctx.cfg, ctx.cfg["batch_size"],
                                   ACT_BYTES[ctx.cfg["dtype"]])
  least = sum(c.least_s for c in calls) * ctx.result.slice_steps
  return 100.0 * least / spent
