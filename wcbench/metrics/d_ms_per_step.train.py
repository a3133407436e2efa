"""d_ms_per_step.train: milliseconds of device time a step in D's passes
(the program's span ``step.d_pass``: D's forwards and loss, their
gradient and its reduce), from the traced slice's replays of the chain's
graph through its span map (``work/spans.py``)."""

from wcbench.work import spans


def read(ctx):
  ms = spans.device_ms(ctx, spans.TRAIN_PROGRAM, ["step.d_pass"])
  if ms is None or not ctx.result.slice_steps:
    return None
  return ms / ctx.result.slice_steps
