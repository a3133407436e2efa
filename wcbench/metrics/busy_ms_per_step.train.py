"""busy_ms_per_step.train: milliseconds of the traced slice in which a
kernel ran (the union of their intervals), over the outer steps it ran:
the device's share of a step, steadier from process to process than the
window's rate, which also holds the idle between kernels."""


def read(ctx):
  s = ctx.slice
  if s is None or not ctx.result.slice_steps:
    return None
  return 1e3 * s.busy_s() / ctx.result.slice_steps
