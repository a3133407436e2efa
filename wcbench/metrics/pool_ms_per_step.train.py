"""pool_ms_per_step.train: milliseconds of device time a step in D's 2x2
average pools, forward and backward: the union of the intervals of the
traced slice's kernels whose name starts with ``avg_pool2`` (ATen's
``avg_pool2d_*`` NHWC kernels, or the program's own ``avg_pool2x2_*``,
K4), over the outer steps the slice ran. No other kernel of a training
step has such a name: the Inception scorer's pool runs in no cell."""

PREFIX = "avg_pool2"


def is_pool(name: str) -> bool:
  return name.startswith(PREFIX)


def read(ctx):
  s = ctx.slice
  if s is None or not ctx.result.slice_steps:
    return None
  spent = s.kernel_time_s(is_pool)
  if spent <= 0:
    return None
  return 1e3 * spent / ctx.result.slice_steps
