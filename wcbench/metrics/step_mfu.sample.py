"""step_mfu.sample: model FLOPs of the eval-mode G forwards the untraced
window sampled (``work/counts.py``), over the window's wall time, over the
bf16 dense peak; in %."""

from wcbench.work import counts


def read(ctx):
  w = ctx.window
  if not w.get("calls"):
    return None
  flops = counts.eval_forward_flops(ctx.cfg, ctx.traffic["batch"])
  return (100.0 * flops * w["calls"] / w["wall_s"]
          / (counts.PEAK_BF16 * ctx.chips))
