"""device_idle.train: the share of the traced slice's wall time in which
no kernel ran on the device (one minus the union of the kernels'
intervals over the slice); in %."""


def read(ctx):
  s = ctx.slice
  if s is None or s.wall_s <= 0:
    return None
  return 100.0 * (1.0 - s.busy_s() / s.wall_s)
