"""busy_ms_per_batch.sample: milliseconds of the traced slice in which a
kernel or a copy ran (the union of their intervals), over the batches it
sampled."""


def read(ctx):
  s = ctx.slice
  if s is None or not s.calls:
    return None
  return 1e3 * s.busy_s() / s.calls
