"""k3_roofline.sample: the least time of the traced slice's K3 products
(``work/counts.py::k3_calls_per_eval_forward``: the Newton-Schulz products
of every WC layer of an eval forward, each 3 x 2C^3 at the bf16 peak
against its bytes, the larger) over the time of K3's kernels; in %."""

from wcbench.work import counts, kernels


def read(ctx):
  s = ctx.slice
  if s is None or not s.calls:
    return None
  spent = s.kernel_time_s(kernels.is_k3)
  if spent <= 0:
    return None
  least = sum(c.least_s for c in counts.k3_calls_per_eval_forward(ctx.cfg))
  return 100.0 * least * s.calls / spent
