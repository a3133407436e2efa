"""collective_ms_per_step.train: milliseconds of device time a step in the
cross-rank all-reduces (the program's spans ``mesh.moments``, the
whitening statistics forward and backward, and ``mesh.grads``, each
update's gradients and loss), from the traced slice's replays of the
chain's graph through its span map (``work/spans.py``). Nothing to read
on one card, or in a program without these spans."""

from wcbench.work import spans


def read(ctx):
  ms = spans.device_ms(ctx, spans.TRAIN_PROGRAM,
                       ["mesh.moments", "mesh.grads"])
  if ms is None or not ctx.result.slice_steps:
    return None
  return ms / ctx.result.slice_steps
