"""adam_ms_per_step.train: milliseconds of device time a step in the
optimizers (the program's spans ``step.d_adam`` and ``step.g_adam``: the
gradients' norm, Adam and its schedule, the EMA), from the traced slice's
replays of the chain's graph through its span map (``work/spans.py``)."""

from wcbench.work import spans


def read(ctx):
  ms = spans.device_ms(ctx, spans.TRAIN_PROGRAM,
                       ["step.d_adam", "step.g_adam"])
  if ms is None or not ctx.result.slice_steps:
    return None
  return ms / ctx.result.slice_steps
