"""g_ms_per_step.train: milliseconds of device time a step in G's passes
(the program's spans ``step.fakes``, the D phase's fakes, and
``step.g_pass``, the G update's forwards, loss, gradient and reduce),
from the traced slice's replays of the chain's graph through its span map
(``work/spans.py``)."""

from wcbench.work import spans


def read(ctx):
  ms = spans.device_ms(ctx, spans.TRAIN_PROGRAM,
                       ["step.fakes", "step.g_pass"])
  if ms is None or not ctx.result.slice_steps:
    return None
  return ms / ctx.result.slice_steps
