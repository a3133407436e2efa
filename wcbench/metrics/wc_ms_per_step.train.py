"""wc_ms_per_step.train: milliseconds of device time a step in the WC
layers (the program's spans ``wc.forward`` and ``wc.backward``: K1, the
Newton-Schulz products, the fold and the row product, and their
backward), from the traced slice's replays of the chain's graph through
its span map (``work/spans.py``)."""

from wcbench.work import spans


def read(ctx):
  ms = spans.device_ms(ctx, spans.TRAIN_PROGRAM,
                       ["wc.forward", "wc.backward"])
  if ms is None or not ctx.result.slice_steps:
    return None
  return ms / ctx.result.slice_steps
