"""kernels_per_step.train: device kernels in the traced slice over the
outer steps it ran."""


def read(ctx):
  s = ctx.slice
  if s is None or not ctx.result.slice_steps:
    return None
  return s.kernel_count() / ctx.result.slice_steps
