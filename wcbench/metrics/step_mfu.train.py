"""step_mfu.train: model FLOPs of the outer steps the untraced window
completed (``work/counts.py``, from the configuration's shapes), over the
window's wall time, over the chips' bf16 dense peak; in %."""

from wcbench.work import counts


def read(ctx):
  w = ctx.window
  if not w.get("steps"):
    return None
  flops = counts.outer_step_flops(ctx.cfg,
                                  ctx.cfg["batch_size"] * ctx.run.world)
  return (100.0 * flops * w["steps"] / w["wall_s"]
          / (counts.PEAK_BF16 * ctx.chips))
