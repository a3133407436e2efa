"""setup_state_s.train: seconds of the set-up in ``create_state`` (the
program's span ``state.create``: G and D built on the host, moved to the
device, their optimizers), from the program's span table."""

from wcbench.work import spans


def read(ctx):
  return spans.host_s(["state.create"])
