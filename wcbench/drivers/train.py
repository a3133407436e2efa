"""Training traffic: a closed loop of the compiled chain the trainer runs
on a device-resident dataset (``make_jit_dataset_step``, ``steps_per_call``
outer steps a call, each call one CUDA-graph replay). As the trainer's
epoch loop, the host makes the next call without waiting for the last:
it waits only for the call before that, so one chain is always queued
behind the running one and the host is never more than a chain ahead.

Set-up builds one train state, writes the benchmark's weights over it,
puts the dataset on the device and makes the chain's first
``checked_calls`` calls through the same object and call the window then
drives: the first warms up (eagerly), the second captures, the rest
replay. The state before the last of them and after it (every weight and
buffer, each Adam's moments and count) and that call's mean losses are
what the reference is held against (``check.py``), once the window has
closed and the program's state is freed.

Traffic parameters (``wcbench/traffic/<name>.json``): ``steps_per_call``,
``checked_calls``, ``trace_calls``.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import torch

from wcbench.core import check, harness, program, trace, weights
from wcbench.reference import wcgan

Tensors = Dict[str, torch.Tensor]
# A run's state, by model ('g', 'd'): its ``tensors`` (parameters and
# buffers), Adam's first and second moments ``m`` and ``v`` by name, and
# its update count ``t`` (``wcgan.Trainer.snapshot``'s form).
Snapshot = Dict[str, dict]


def _host(tensors: Tensors) -> Tensors:
  return {n: t.detach().to("cpu", copy=True) for n, t in tensors.items()}


def snapshot(state) -> Snapshot:
  """The program's train state on the host, as ``Snapshot``."""
  out = {}
  for m, module, opt in (("g", state.g, state.g_opt),
                         ("d", state.d, state.d_opt)):
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    slots = {n: opt.state.get(p, {}) for n, p in module.named_parameters()}
    steps = [s["step"] for s in slots.values() if "step" in s]
    out[m] = {"tensors": _host(tensors),
              "m": _host({n: s["exp_avg"] for n, s in slots.items()
                          if "exp_avg" in s}),
              "v": _host({n: s["exp_avg_sq"] for n, s in slots.items()
                          if "exp_avg_sq" in s}),
              "t": int(float(steps[0])) if steps else 0}
  return out


def step_draws(cfg: dict, seed: int, steps: int, device, world: int = 1
               ) -> List[Dict[str, torch.Tensor]]:
  """The draws of the run's first ``steps`` outer steps, as the program
  takes them from its generator (global batch of ``world`` ranks)."""
  gen = torch.Generator(device=device).manual_seed(
      weights.stream_seed(seed, "noise"))
  return [wcgan.draw_step(cfg, gen, cfg["dataset"]["images"],
                          cfg["batch_size"] * world, device, world)
          for _ in range(steps)]


def reference_calls(cfg: dict, seed: int, chain: int, calls: int, device,
                    act: wcgan.Act, world: int = 1
                    ) -> Tuple[Snapshot, Snapshot, Tuple[float, float]]:
  """The reference's own run over the cell's first ``calls`` calls from
  ``seed``: its state before the last call and after it, and that call's
  mean (D loss, G loss). The control puts this, in float8, in the
  program's place."""
  data_x, data_y = weights.make_dataset(cfg, seed, device)
  ref = wcgan.Trainer(cfg, weights.make_weights(cfg, seed, device), act)
  draws = step_draws(cfg, seed, chain * calls, device, world)
  before, losses = None, []
  for i, d in enumerate(draws):
    if i == chain * (calls - 1):
      before = ref.snapshot()
    step = ref.outer_step(d, data_x, data_y)
    if before is not None:
      losses.append(step)
  return before, ref.snapshot(), _mean_losses(losses)


def _mean_losses(losses) -> Tuple[float, float]:
  return tuple(float(torch.stack(v).mean()) for v in zip(*losses))


def _params_before_last(opt: wcgan.Adam, P: Tensors) -> Tensors:
  if opt.t == 0:
    return {n: p.detach().clone() for n, p in P.items()}
  return opt.undo({n: p.detach() for n, p in P.items()})


def update_gradients(cfg: dict, after: Snapshot, draws: Dict, data,
                     device, act: wcgan.Act) -> Dict[str, Tensors]:
  """The reference's gradient of a call's last D update and last G
  update (the outer step of ``draws``), evaluated at the state ``after``
  the call left: each model as it was before its last update, worked
  back from ``after`` and its Adam's moments (``Adam.undo``), D's SN
  vectors from those it left (``wcgan.d_sn_read``). By model and name,
  on the host."""
  ref = wcgan.Trainer.load(cfg, after, act, device)
  pg = _params_before_last(ref.opt_g, ref.PG)
  pd = _params_before_last(ref.opt_d, ref.PD)
  k = draws["idx"].shape[0]
  real, y_real, z, y_fake = wcgan.d_update_inputs(cfg, draws, k - 1, *data)
  pd = {n: t.requires_grad_(True) for n, t in pd.items()}
  read = wcgan.d_sn_read(cfg, pd, ref.BD) if ref.opt_d.t else ref.BD
  _, d_grads = wcgan.d_update_gradient(cfg, pg, ref.BG, pd, read, real,
                                       y_real, z, y_fake, act)
  pg = {n: t.requires_grad_(True) for n, t in pg.items()}
  d_after = {n: p.detach() for n, p in ref.PD.items()}
  _, g_grads = wcgan.g_update_gradient(cfg, pg, ref.BG, d_after, ref.BD,
                                       draws["z_g"], draws.get("y_g"), act)
  return {"g": _host(dict(zip(pg, g_grads))),
          "d": _host(dict(zip(pd, d_grads)))}


def follow(cfg: dict, before: Snapshot, draws: List[Dict], data, device,
           act: wcgan.Act) -> Tuple[Dict[str, Tensors], Tuple[float, float]]:
  """The reference's run of the outer steps of ``draws`` from the state
  ``before``: every tensor after them (on the host) and their mean
  losses."""
  ref = wcgan.Trainer.load(cfg, before, act, device)
  losses = [ref.outer_step(d, *data) for d in draws]
  return ({m: _host(t) for m, t in ref.tensors().items()},
          _mean_losses(losses))


def buffer_names(cfg: dict) -> Dict[str, List[str]]:
  return {"g": [n for n, _, _ in wcgan.g_specs(cfg) if wcgan.is_buffer(n)],
          "d": [n for n, _, _ in wcgan.d_specs(cfg) if wcgan.is_buffer(n)]}


def numbers(cfg: dict, seed: int, device, world: int, chain: int,
            calls: int, before: Snapshot, after: Snapshot,
            losses: Tuple[float, float]) -> dict:
  """The check's numbers of a run whose ``calls``-th call of ``chain``
  outer steps went from ``before`` to ``after`` with the mean ``losses``,
  against the float32 reference."""
  act = wcgan.Act()
  data = weights.make_dataset(cfg, seed, device)
  draws = step_draws(cfg, seed, chain * calls, device, world)[-chain:]
  at = update_gradients(cfg, after, draws[-1], data, device, act)
  followed, ref_losses = follow(cfg, before, draws, data, device, act)
  side = {"loss_gap": max(abs(p - r) for p, r in zip(losses, ref_losses)),
          "losses": [list(losses), list(ref_losses)]}
  return check.train_numbers(before, after, at, followed, buffer_names(cfg),
                             side)


class Program:
  """The system under test for one cell: the train state, the dataset on
  the device and the compiled chain."""

  def __init__(self, run: harness.Run):
    cfg, dev = run.cfg, run.device
    program.set_switches(cfg)
    self.run = run
    self.stages = harness.Stages()
    harness.device_init(dev)
    self.stages.mark("device_init")
    self.state, self.gan = program.build_state(cfg, dev, group=run.group)
    self.stages.mark("state")
    w = weights.make_weights(cfg, run.seed, dev)
    weights.load_into(self.state.g, w["g"])
    weights.load_into(self.state.d, w["d"])
    del w
    self.state.generator.manual_seed(weights.stream_seed(run.seed, "noise"))
    data_x, data_y = weights.make_dataset(cfg, run.seed, dev)
    if run.world > 1:           # this rank's shard, as the trainer holds it
      per = data_x.shape[0] // run.world
      lo = run.rank * per
      data_x, data_y = (data_x[lo:lo + per].clone(),
                        data_y[lo:lo + per].clone())
    self.data_x, self.data_y = data_x, data_y
    del data_x, data_y
    harness.sync(dev)
    self.stages.mark("weights_data")
    self.chain = run.traffic["steps_per_call"]
    self.batch = cfg["batch_size"] * run.world
    from wcgan_tpu_torch.train.step import make_jit_dataset_step
    self.step = make_jit_dataset_step(self.gan, self.batch, self.chain,
                                      run.group)
    self.images_per_call = (self.chain * self.gan.training_ratio
                            * self.batch)

  def call(self) -> Dict[str, torch.Tensor]:
    return self.step(self.state, self.data_x, self.data_y)

  def checked_calls(self, calls: int
                    ) -> Tuple[Snapshot, Snapshot, Tuple[float, float]]:
    """The first ``calls`` calls: the state before the last and after it,
    and the last one's mean (D loss, G loss)."""
    before = out = None
    for c in range(calls):
      if c == calls - 1:
        before = snapshot(self.state)
      out = self.call()
      harness.sync(self.run.device)
      self.stages.mark(f"call{c + 1}")
    return (before, snapshot(self.state),
            (float(out["d_loss"]), float(out["g_loss"])))

  def free(self) -> None:
    del self.step, self.state, self.data_x, self.data_y
    gc.collect()
    if self.run.device.type == "cuda":
      torch.cuda.empty_cache()


def _launches() -> Dict[str, int]:
  """The program's launch counters of its hand-written kernels."""
  from wcgan_tpu_torch.ops import cuda_wc, mm_bf16x3
  return {"k1": cuda_wc.MOMENTS_LAUNCHES,
          "k3": mm_bf16x3.MM_BF16X3_LAUNCHES}


def _fence(device: torch.device):
  """An event at the end of the device's queue (None on the CPU)."""
  if device.type != "cuda":
    return None
  event = torch.cuda.Event()
  event.record(torch.cuda.current_stream(device))
  return event


def window(run: harness.Run, prog: Program) -> dict:
  """Calls until ``run.seconds`` have passed, each made once the call
  before the last is done; the window closes once the last call is. The
  rate is every image the D updates consumed over the whole window.
  Beside it, the program's counts of K1 and K3 launches a step."""
  dev = run.device
  harness.sync(dev)
  outs = []
  before = _launches()
  pending = None
  t0 = time.perf_counter()
  while True:
    outs.append(prog.call())
    fence = _fence(dev)
    if pending is not None:
      pending.synchronize()
    pending = fence
    if harness.agreed_stop(run, time.perf_counter() - t0 >= run.seconds):
      break
  harness.sync(dev)
  wall = time.perf_counter() - t0
  losses = torch.stack([torch.stack([o["d_loss"], o["g_loss"]])
                        for o in outs]).cpu()
  bad = int((~torch.isfinite(losses).all(dim=1)).sum())
  steps = len(outs) * prog.chain
  launches = {k: (v - before[k]) / steps for k, v in _launches().items()}
  return {"calls": len(outs), "wall_s": wall, "steps": steps,
          "launches_per_step": launches,
          "attempted": steps, "failed": bad * prog.chain,
          "images": len(outs) * prog.images_per_call}


def run(run: harness.Run) -> harness.Result:
  cfg, seed = run.cfg, run.seed
  calls = run.traffic["checked_calls"]
  prog = Program(run)
  before, after, losses = prog.checked_calls(calls)
  harness.sync(run.device)
  setup_s = harness.process_age_s()
  with harness.DeviceRecord(run) as record:
    win = window(run, prog)
  result = harness.Result(setup_s=setup_s, attempted=win["attempted"],
                          failed=win["failed"], window=win,
                          memory_peak_bytes=harness.memory_peak(run.device),
                          device_record=record.summary(),
                          stages=prog.stages.marks)
  result.e2e["train_imgs_per_s"] = win["images"] / win["wall_s"]
  if run.trace:
    result.slice = trace.profile(prog.call, run.traffic["trace_calls"],
                                 run.device)
    result.slice_steps = result.slice.calls * prog.chain
  chain = prog.chain
  prog.free()
  del prog
  if run.rank == 0:
    result.numbers = numbers(cfg, seed, run.device, run.world, chain, calls,
                             before, after, losses)
  return result
