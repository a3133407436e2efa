"""kernels_per_batch.sample: device kernels in the traced slice over the
batches it sampled."""


def read(ctx):
  s = ctx.slice
  if s is None or not s.calls:
    return None
  return s.kernel_count() / s.calls
