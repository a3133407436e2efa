"""Sampling traffic: one client in a closed loop of ``Trainer.sample_u8``
batches (the compiled eval-mode G forward and the uint8 conversion, one
CUDA-graph replay a batch), each batch's images copied to the host before
the next call, as ``Trainer.generate`` and the scorer take them.

Set-up builds G with the benchmark's weights and gives it running
statistics from one train-mode forward (the trainer's G before its first
update), then warms up, captures and replays the program once. In the
window each batch's z is drawn on the device from the traffic's seed; a
sample of the batches, drawn from the seed, keeps its z and its images,
and the reference remakes them once the window has closed.

Traffic parameters (``wcbench/traffic/<name>.json``): ``batch``,
``checked_batches`` (how many of the first ``check_range`` batches are
kept), ``trace_calls``.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from wcbench.core import check, harness, program, trace, weights
from wcbench.reference import wcgan
from wcbench.work import shapes


def _labels(cfg: dict, n: int, gen: torch.Generator, device
            ) -> Optional[torch.Tensor]:
  ncls = shapes.num_classes(cfg)
  if not ncls:
    return None
  return torch.randint(0, ncls, (n,), generator=gen, device=device)


def stats_inputs(cfg: dict, seed: int, batch: int, device):
  """z (and labels) of the set-up's train-mode forward."""
  gen = torch.Generator(device=device).manual_seed(
      weights.stream_seed(seed, "sample"))
  z = torch.randn((batch, cfg["z_dim"]), generator=gen, device=device)
  return z, _labels(cfg, batch, gen, device)


class Program:
  """The trainer's sampling program on G with the benchmark's weights."""

  def __init__(self, run: harness.Run):
    from wcgan_tpu_torch.data.base import ArrayDataset
    from wcgan_tpu_torch.train.trainer import Trainer, TrainerConfig
    cfg, dev = run.cfg, run.device
    program.set_switches(cfg)
    self.run = run
    self.stages = harness.Stages()
    harness.device_init(dev)
    self.stages.mark("device_init")
    self.batch = run.traffic["batch"]
    state, gan = program.build_state(cfg, dev)
    self.stages.mark("state")
    w = weights.make_weights(cfg, run.seed, dev)
    weights.load_into(state.g, w["g"])
    weights.load_into(state.d, w["d"])
    del w
    z, y = stats_inputs(cfg, run.seed, self.batch, dev)
    with torch.no_grad():
      state.g(z, y, train=True, update_stats=True)
    res = cfg["resolution"]
    ds = ArrayDataset(np.zeros((self.batch, res, res, 3), np.uint8), None,
                      self.batch, z_dim=cfg["z_dim"])
    self.out_dir = tempfile.mkdtemp(prefix="wcbench-")
    self.trainer = Trainer(ds, state, gan, TrainerConfig(
        name="wcbench", output_dir=self.out_dir, device_data=False))
    self.gen = torch.Generator(device=dev).manual_seed(
        weights.stream_seed(run.seed, "traffic"))
    harness.sync(dev)
    self.stages.mark("weights_stats")

  def draw(self):
    z = torch.randn((self.batch, self.run.cfg["z_dim"]), generator=self.gen,
                    device=self.run.device)
    return z, _labels(self.run.cfg, self.batch, self.gen, self.run.device)

  def call(self, z, y) -> torch.Tensor:
    """One batch: the program's call, its images on the host."""
    return self.trainer.sample_u8(z, y).cpu()

  def free(self) -> None:
    shutil.rmtree(self.out_dir, ignore_errors=True)
    del self.trainer
    gc.collect()
    if self.run.device.type == "cuda":
      torch.cuda.empty_cache()


def chosen_batches(run: harness.Run) -> set:
  rng = np.random.default_rng(weights.stream_seed(run.seed, "sample"))
  t = run.traffic
  return set(int(i) for i in rng.choice(t["check_range"],
                                        t["checked_batches"], replace=False))


def run(run: harness.Run) -> harness.Result:
  prog = Program(run)
  for c in range(3):                       # warm-up, capture, a replay
    prog.call(*prog.draw())
    prog.stages.mark(f"call{c + 1}")
  setup_s = harness.process_age_s()
  chosen = chosen_batches(run)
  kept: List[tuple] = []
  latencies = []
  with harness.DeviceRecord(run) as record:
    t0 = time.perf_counter()
    while True:
      z, y = prog.draw()
      t_call = time.perf_counter()
      images = prog.call(z, y)
      latencies.append(time.perf_counter() - t_call)
      if len(latencies) - 1 in chosen:
        kept.append((z.clone(), None if y is None else y.clone(), images))
      if time.perf_counter() - t0 >= run.seconds:
        break
    wall = time.perf_counter() - t0
  n = len(latencies)
  result = harness.Result(
      setup_s=setup_s, attempted=n, failed=0,
      window={"calls": n, "wall_s": wall, "images": n * prog.batch},
      memory_peak_bytes=harness.memory_peak(run.device),
      device_record=record.summary(), stages=prog.stages.marks)
  result.e2e["sample_imgs_per_s"] = n * prog.batch / wall
  result.e2e["sample_batch_ms_p95"] = float(
      np.percentile(np.array(latencies) * 1e3, 95))
  if run.trace:
    result.slice = trace.profile(lambda: prog.call(*prog.draw()),
                                 run.traffic["trace_calls"], run.device)
  prog.free()
  del prog
  result.numbers = check.sample_numbers(
      [k[2] for k in kept], reference_images(run.cfg, run.seed, kept,
                                             run.traffic["batch"],
                                             run.device, wcgan.Act()))
  result.numbers["image_gap"]["checked"] = len(kept)
  return result


def reference_images(cfg: dict, seed: int, kept: List[tuple], batch: int,
                     device, act: wcgan.Act) -> List[torch.Tensor]:
  """The reference's uint8 images (on the host) of each kept batch's z:
  the benchmark's weights, running statistics from the same train-mode
  forward, then eval-mode forwards."""
  w = weights.make_weights(cfg, seed, device)
  buffers = {n: t for n, t in w["g"].items() if wcgan.is_buffer(n)}
  params = {n: t for n, t in w["g"].items() if not wcgan.is_buffer(n)}
  z0, y0 = stats_inputs(cfg, seed, batch, device)
  with torch.no_grad():
    new_b = {}
    wcgan.generator(cfg, params, buffers, z0, y0, True, act, new_b)
    buffers.update(new_b)
    return [wcgan.to_u8(wcgan.generator(cfg, params, buffers, z, y, False,
                                        act)).cpu() for z, y, _ in kept]
