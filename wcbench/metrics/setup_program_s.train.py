"""setup_program_s.train: seconds of the set-up in the chain's eager
warm-up and its capture (the program's spans
``make_jit_dataset_step.warm_up`` and ``.capture``), less the kernels'
builds inside them (``kernels.build``, where ``nvcc`` ran), from the
program's span table."""

from wcbench.work import spans


def read(ctx):
  return spans.setup_s(spans.TRAIN_PROGRAM)
