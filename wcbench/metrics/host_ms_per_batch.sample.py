"""host_ms_per_batch.sample: milliseconds of host work a batch in the
sampling caller and its program outside the graph's launch (the program's
spans ``Trainer.sample_u8.inputs``, ``.state``, ``.key``, ``.fill``,
``.counts`` and ``.clone``), over every batch of the process from the
program's span table (the profiler off for all but the traced slice's)."""

from wcbench.work import spans

PARTS = ("inputs", "state", "key", "fill", "counts", "clone")


def read(ctx):
  p = spans.SAMPLE_PROGRAM
  s = spans.host_s(f"{p}.{part}" for part in PARTS)
  n = spans.calls(f"{p}.inputs")
  if s is None or not n:
    return None
  return 1e3 * s / n
