"""wc_ms_per_batch.sample: milliseconds of device time a batch in the WC
layers of the eval-mode G (the program's span ``wc.forward``), from the
traced slice's replays of the sampling program's graph through its span
map (``work/spans.py``)."""

from wcbench.work import spans


def read(ctx):
  ms = spans.device_ms(ctx, spans.SAMPLE_PROGRAM, ["wc.forward"])
  if ms is None:
    return None
  return ms / ctx.slice.calls
