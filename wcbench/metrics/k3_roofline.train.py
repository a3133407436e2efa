"""k3_roofline.train: the least time of the traced slice's K3
``mm_bf16x3`` products under 'high' (``work/counts.py::k3_calls_per_step``:
every Newton-Schulz product forward and backward and K1's backward row
product, each 3 x 2MNK at the bf16 peak against A and B read and C
written, the larger) over the time of K3's kernels in the slice; in %.
Nothing to read where the whitening runs in true float32."""

from wcbench.work import counts, kernels


def read(ctx):
  s = ctx.slice
  if s is None or not ctx.result.slice_steps:
    return None
  spent = s.kernel_time_s(kernels.is_k3)
  if spent <= 0:
    return None
  calls = counts.k3_calls_per_step(ctx.cfg, ctx.cfg["batch_size"])
  least = sum(c.least_s for c in calls) * ctx.result.slice_steps
  return 100.0 * least / spent
