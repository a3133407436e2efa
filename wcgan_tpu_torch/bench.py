"""The port's benchmark: training, sampling and scoring speed on the card.

  python -m wcgan_tpu_torch.bench                 # the record (last line)
  python -m wcgan_tpu_torch.bench --shapes [--only=cfg2] [--dfake-running]
  python -m wcgan_tpu_torch.bench --acgan | --dfake | --modes | --nsscale
  python -m wcgan_tpu_torch.bench --gap | --swing | --variants [--quick]
  python -m wcgan_tpu_torch.bench --sampling
  python -m wcgan_tpu_torch.bench --scoring [--inception-tf32]

Every mode runs on ``--device cuda`` (the default; it raises without a
GPU) or, as the tests run it, ``--device cpu``. Counterpart of the JAX
package's ``bench.py`` (``_measure``, ``main``), ``bench_ablate.py``
(``bench_variant``, ``bench_sampling``, ``bench_shape`` and its modes) and
``scripts/mfu.py``, on the shapes of ``tools/bench_shapes.py``.

The record (no mode flag) prints the reference's line, ``metric``,
``value`` (imgs/s of the compiled step at batch 64, bf16 unless ``--f32``),
``unit`` and ``vs_baseline``, with ``value_eager`` (the eager step, in
turns with ``value`` on the same state), ``value_b128`` (batch twice
``--batch``) and ``value_dfake_running`` (``d_fake_stats="running"``)
unless ``--no-b128`` / ``--no-dfake``; beside them each value's
``spread`` (min, max), ``k1_launches_per_step``, ``flops_per_outer_step``
and ``mfu`` with its ``peak``, the capture's seconds, the device, the
precision switches and the versions.

The step measured is the reference bench's: the compiled outer step
(``train/step.py::make_jit_step``, as ``bench.py`` measures ``jax.jit`` of
the step), on CUDA one CUDA-graph replay a step. How a value is measured
(``measure``): a fresh state, 2 warm-up outer steps (the first runs
eagerly, builds K1 with nvcc and lets cuDNN pick its algorithms; the
second captures the graph), then ``--repeats`` windows of ``--steps``
outer steps on the host clock, each fenced by
``torch.cuda.synchronize()``; imgs/s is ratio x batch x steps over a
window's seconds; the value is the median of the windows. K1's launches
are counted over the windows (a replay adds the launches its capture
counted). ``measure_turns`` measures the compiled and the eager step on
one state, their windows in turns. Precision is the CLI's
(``cli/run.py::set_precision``: TF32 off for matmuls and cuDNN).

FLOPs (``count_flops``) are those of one eager outer step (the counter
cannot see inside a graph) as
``torch.utils.flop_counter.FlopCounterMode`` counts them (products and
convolutions, forward and backward; elementwise work is not counted),
with the moments on the plain path and the whitening precision held at
'highest': K1 and K3 are calls into a library the counter cannot see,
and on the CPU 'high' runs three float32 products where the model does
one, so a step counts the same FLOPs under either precision. No counted
row runs ``remat``, whose recomputation the counter would count as well.
``mfu`` divides by the median seconds of an outer step and by the card's
peak for the row's dtype
(``PEAKS``): bf16 rows against the bf16 tensor-core peak, float32 rows
against the float32 peak outside the tensor cores, as TF32 is off.

Whitening precision (``ops/whiten.py::set_precision``):
``--whitening-precision {highest,high}`` sets it for the record,
``--shapes``, ``--sampling`` and ``--scoring`` ('highest',
true float32, by default; 'high' runs every whitening-path product as
bf16x3 through K3, ``ops/mm_bf16x3.py``). The ablation modes run as the
reference's ``bench_ablate.py`` runs them: 'high' for every row but
``--swing``'s ``ns15_highest_b64``. Every printed line names its
precision (``whitening_precision``). The one row of the JAX package's
ablation that is not here is ``unroll_dscan_b64`` (an XLA scan knob).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import platform
import re
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from wcgan_tpu_torch import compiled
from wcgan_tpu_torch.cli import run as cli_run
from wcgan_tpu_torch.data import get_dataset
from wcgan_tpu_torch.device import card, place, resolve_device
from wcgan_tpu_torch.evaluation import inception_v3, metrics
from wcgan_tpu_torch.evaluation import scorer as scorer_lib
from wcgan_tpu_torch.models.generator import Generator
from wcgan_tpu_torch.ops import cuda_wc, whiten
from wcgan_tpu_torch.tools.bench_shapes import (bench_from, build_bench,
                                                build_models)
from wcgan_tpu_torch.train.state import OptimConfig, create_state
from wcgan_tpu_torch.train.step import GANConfig
from wcgan_tpu_torch.train.trainer import Trainer, TrainerConfig

# vs_baseline's denominator, the JAX package's (bench.py:35-37): a
# measured same-math TF proxy on a CPU (10.52 imgs/s) scaled by the CPU ->
# V100 peak-FLOPs ratio (117).
TF_PROXY_CPU_IMGS_PER_SEC = 10.52
CPU_TO_V100_PEAK_FLOPS = 117.0
BASELINE_IMGS_PER_SEC = TF_PROXY_CPU_IMGS_PER_SEC * CPU_TO_V100_PEAK_FLOPS

# Dense peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet).
PEAKS = {
    "bfloat16": (989e12, "989 TFLOP/s bf16 dense tensor core, H100 SXM "
                         "data sheet, 700 W"),
    "float32": (67e12, "67 TFLOP/s float32 without tensor cores (TF32 "
                       "off), H100 SXM data sheet, 700 W"),
}
WARMUP_STEPS = 2
# The ablation modes, which run at the reference's whitening precision
# (bench_ablate.py:27-35: every row at HIGH but ns15_highest_b64), and the
# others, which take --whitening-precision.
ABLATION_PRECISION = "high"
ABLATION_MODES = ("acgan", "dfake", "modes", "nsscale", "gap", "swing",
                  "variants")
MODES = ABLATION_MODES + ("shapes", "sampling", "scoring")
# --shapes: one row per CONFIGS key but acgan (--acgan's), named as the
# JAX package's rows, the headline first.
SHAPES = (("cifar10_wc_resnet_headline", "headline"),
          ("cifar10_wc_dcgan_cfg1", "cfg1"),
          ("cifar10_cwc_proj_cfg2", "cfg2"),
          ("stl10_uncond_48_cfg3", "cfg3"),
          ("tiny_imagenet_cwcsa_64_cfg4", "cfg4"),
          ("imagenet64_cwcsa_perchip_cfg5", "cfg5"))
Bench = Tuple  # (step_fn, state, (real, labels), spec), see bench_from


def emit(record: dict) -> None:
  """One printed line, naming the whitening precision it ran at."""
  print(json.dumps({**record, "whitening_precision": whiten.get_precision()}),
        flush=True)


def fence(dev: torch.device) -> None:
  """Wait for the device's queue (the host clock's fence)."""
  if dev.type == "cuda":
    torch.cuda.synchronize(dev)


def device_info(dev: torch.device) -> dict:
  """Where the numbers were taken: the card's name and power limit
  (nvidia-smi) and the GPU count, or the CPU."""
  if dev.type != "cuda":
    return {"platform": "cpu", "name": platform.processor() or "cpu",
            "count": 1}
  name, _, limit = card().partition(", ")
  return {"platform": "gpu", "name": name, "power_limit": limit,
          "count": torch.cuda.device_count()}


def switches() -> dict:
  return {"tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "tf32_cudnn": torch.backends.cudnn.allow_tf32,
          "cudnn_benchmark": torch.backends.cudnn.benchmark}


def _spread(values: List[float]) -> dict:
  return {"median": statistics.median(values), "min": min(values),
          "max": max(values), "n": len(values)}


def _reset_memory(dev: torch.device) -> None:
  if dev.type == "cuda":
    torch.cuda.reset_peak_memory_stats(dev)


def _memory_mib(dev: torch.device) -> Optional[float]:
  if dev.type != "cuda":
    return None
  return torch.cuda.max_memory_allocated(dev) / 2**20


def _imgs_per_step(bench: Bench) -> int:
  _, _, (real, _), spec = bench
  return spec["ratio"] * real.shape[1]


def measure(bench: Bench, steps: int = 30, repeats: int = 3) -> dict:
  """imgs/s of ``bench``'s outer step: the median, min and max of
  ``repeats`` windows of ``steps`` steps after the warm-up, with K1's
  launches a step and the peak memory."""
  step_fn, state, (real, labels), _ = bench
  dev = real.device
  _reset_memory(dev)
  for _ in range(WARMUP_STEPS):
    step_fn(state, real, labels)
  fence(dev)
  cuda_wc.MOMENTS_LAUNCHES = 0
  rates = []
  for _ in range(repeats):
    t0 = time.perf_counter()
    for _ in range(steps):
      out = step_fn(state, real, labels)
    fence(dev)
    rates.append(steps * _imgs_per_step(bench) / (time.perf_counter() - t0))
  if not np.all(np.isfinite([float(v) for v in out.values()])):
    raise RuntimeError(f"non-finite step metrics {out}")
  out = _spread(rates)
  out["k1_launches_per_step"] = cuda_wc.MOMENTS_LAUNCHES / (steps * repeats)
  out["max_memory_mib"] = _memory_mib(dev)
  return out


def _eager(step_fn):
  """The eager step a compiled one wraps (itself when it is eager)."""
  return getattr(step_fn, "eager", step_fn)


def measure_turns(bench: Bench, steps: int = 30, repeats: int = 3
                  ) -> Dict[str, dict]:
  """``measure`` of the compiled step (``captured``) and of the eager
  step it wraps (``eager``) on one state, ``repeats`` windows each in
  turns (captured first in even rounds, eager first in odd ones). Each
  arm: imgs/s median, min and max, K1's launches a step, peak memory (the
  eager arm's over its windows; the captured arm's over its capture, the
  most its graph's pool holds at once, beside the state). Also the
  capture's seconds on the host clock, synchronised."""
  step_fn, state, (real, labels), _ = bench
  arms = {"captured": step_fn, "eager": _eager(step_fn)}
  dev = real.device
  for _ in range(WARMUP_STEPS):
    arms["eager"](state, real, labels)
  step_fn(state, real, labels)                 # the compiled step's warm-up
  fence(dev)
  _reset_memory(dev)
  t0 = time.perf_counter()
  step_fn(state, real, labels)                 # its capture, then a replay
  fence(dev)
  capture_s = time.perf_counter() - t0
  memory = {"captured": _memory_mib(dev), "eager": None}
  rates = {k: [] for k in arms}
  launches = dict.fromkeys(arms, 0)
  for r in range(repeats):
    for name in (list(arms) if r % 2 == 0 else list(arms)[::-1]):
      if name == "eager":
        _reset_memory(dev)
      before = cuda_wc.MOMENTS_LAUNCHES
      t0 = time.perf_counter()
      for _ in range(steps):
        out = arms[name](state, real, labels)
      fence(dev)
      rates[name].append(steps * _imgs_per_step(bench)
                         / (time.perf_counter() - t0))
      launches[name] += cuda_wc.MOMENTS_LAUNCHES - before
      if name == "eager" and dev.type == "cuda":
        memory["eager"] = max(memory["eager"] or 0.0, _memory_mib(dev))
      if not np.all(np.isfinite([float(v) for v in out.values()])):
        raise RuntimeError(f"non-finite step metrics {out} ({name})")
  result = {name: {**_spread(rates[name]),
                   "k1_launches_per_step": launches[name] / (steps * repeats),
                   "max_memory_mib": memory[name]} for name in arms}
  result["captured"]["capture_s"] = capture_s
  return result


@contextlib.contextmanager
def plain_moments(*models: torch.nn.Module):
  """Every WC layer of ``models`` on the plain moments (``use_kernel``
  False) inside the block."""
  layers = [m for model in models for m in model.modules()
            if hasattr(m, "use_kernel")]
  saved = [m.use_kernel for m in layers]
  for m in layers:
    m.use_kernel = False
  try:
    yield
  finally:
    for m, v in zip(layers, saved):
      m.use_kernel = v


def count_flops(bench: Bench) -> int:
  """FLOPs of one eager outer step of ``bench`` (it advances the state),
  on the plain moments and at whitening precision 'highest' (model FLOPs:
  one product is 2MNK whatever its emulation), as FlopCounterMode counts
  them."""
  from torch.utils.flop_counter import FlopCounterMode
  step_fn, state, (real, labels), _ = bench
  counter = FlopCounterMode(display=False)
  with plain_moments(state.g, state.d), whiten.precision("highest"), counter:
    _eager(step_fn)(state, real, labels)
  return counter.get_total_flops()


def mfu(flops: int, imgs_per_sec: float, imgs_per_step: int, dtype: str,
        dev: torch.device) -> dict:
  """Model FLOP/s over the card's peak for ``dtype``; None off the card."""
  peak, name = PEAKS[dtype]
  rate = flops * imgs_per_sec / imgs_per_step
  if dev.type != "cuda":
    return {"flops_per_outer_step": flops, "mfu": None, "peak": None}
  return {"flops_per_outer_step": flops, "model_tflops_per_sec": rate / 1e12,
          "mfu": rate / peak, "peak": name}


def variant_bench(norm: str = "d", dtype: str = "bfloat16",
                  ns_iters: int = 15, batch: int = 64,
                  d_fake_stats: str = "batch", ns_scaling: str = "trace",
                  remat: bool = False, random_flip: bool = True,
                  batched_fake_gen: bool = False, opt: str = "adam",
                  device: str = "cuda", seed: int = 0) -> Bench:
  """The headline program with one knob changed, the JAX package's
  ``bench_ablate.py::bench_variant``: G's norm code, dtype,
  Newton-Schulz iterations and scaling, ``remat``, the flips,
  ``batched_fake_gen``, ``d_fake_stats``, and SGD in place of the two
  Adams (``opt='sgd'``)."""
  g_cfg, d_cfg, spec = build_models("headline", dtype=dtype,
                                    ns_iters=ns_iters,
                                    ns_scaling=ns_scaling, block_norm=norm)
  g_cfg = dataclasses.replace(g_cfg, remat=remat)
  gan = GANConfig(loss=spec["loss"], training_ratio=spec["ratio"],
                  generator_batch_multiple=2, random_flip=random_flip,
                  batched_fake_gen=batched_fake_gen,
                  d_fake_stats=d_fake_stats)
  bench = bench_from(g_cfg, d_cfg, spec, gan, batch, device, seed)
  if opt == "sgd":
    state = bench[1]
    for side in ("g", "d"):
      sgd = torch.optim.SGD(getattr(state, side).parameters(), lr=2e-4)
      setattr(state, f"{side}_opt", sgd)
      setattr(state, f"{side}_sched",
              torch.optim.lr_scheduler.LambdaLR(sgd, lambda t: 1.0))
  elif opt != "adam":
    raise ValueError(f"opt must be 'adam' or 'sgd', got {opt!r}")
  return bench


def bench_sampling(dtype: str, batch: int = 256, forwards: int = 30,
                   repeats: int = 3, device: str = "cuda", seed: int = 0
                   ) -> dict:
  """The sampling path, the JAX package's ``bench_sampling``: the
  headline G in eval mode on its running statistics (one train-mode
  forward from init, as the reference's init does), ``forwards``
  forwards at ``batch`` a window, on four arms in turns: ``k2_kernel``
  (``kernel_eval=True``: K2 on every WC layer, 7 launches a forward) and
  ``split`` (the split path: Newton-Schulz, fold and row matmul in torch;
  no K2), each the compiled forward (``compiled.Program``: on CUDA one
  CUDA-graph replay a forward, as the reference jits it), and beside
  each its eager forward on the same G (``k2_kernel_eager``,
  ``split_eager``). Each arm: imgs/s over ``repeats`` windows, K2
  launches a forward."""
  dev = resolve_device(device)
  g_cfg, _, _ = build_models("headline", dtype=dtype)
  split = place(Generator(g_cfg, torch.Generator().manual_seed(seed)), dev)
  kernel = place(Generator(dataclasses.replace(g_cfg, kernel_eval=True),
                           torch.Generator().manual_seed(seed)), dev)
  z = torch.randn((batch, g_cfg.z_dim), device=dev,
                  generator=torch.Generator(device=dev).manual_seed(seed + 1))

  def compiled_forward(g: Generator, name: str):
    program = compiled.Program(f"bench_sampling {name}")
    signature = compiled.spec(z)
    return lambda x: program(
        lambda static: g(static[0], train=False),
        lambda: (compiled.module_key(g), compiled.backend_key(), signature),
        [x], dev)

  arms = {"k2_kernel": compiled_forward(kernel, "k2_kernel"),
          "k2_kernel_eager": lambda x: kernel(x, train=False),
          "split": compiled_forward(split, "split"),
          "split_eager": lambda x: split(x, train=False)}
  rates: Dict[str, List[float]] = {k: [] for k in arms}
  launches = dict.fromkeys(arms, 0)
  _reset_memory(dev)
  with torch.no_grad():
    split(z, train=True, update_stats=True)
    kernel.load_state_dict(split.state_dict())
    for forward in arms.values():      # K2's build, a warm-up and a capture
      for _ in range(2):
        forward(z)
    fence(dev)
    for r in range(repeats):
      for name in (list(arms) if r % 2 == 0 else list(arms)[::-1]):
        cuda_wc.WC_APPLY_LAUNCHES = 0
        t0 = time.perf_counter()
        for _ in range(forwards):
          out = arms[name](z)
        fence(dev)
        rates[name].append(forwards * batch / (time.perf_counter() - t0))
        launches[name] += cuda_wc.WC_APPLY_LAUNCHES
        if not torch.isfinite(out).all():
          raise RuntimeError(f"non-finite images on the {name} arm")
  result = {"mode": "sampling", "dtype": dtype, "batch": batch,
            "forwards": forwards, "max_memory_mib": _memory_mib(dev)}
  for name in arms:
    result[name] = {**_spread(rates[name]), "k2_launches_per_forward":
                    launches[name] / (forwards * repeats)}
  return result


def _scoring_trainer(dev: torch.device, seed: int, samples_fid: int,
                     out_dir: str) -> Trainer:
  """The headline G (bf16, EMA 0.999, ``kernel_eval=True``) in a Trainer
  over synthetic CIFAR-10-shaped data of ``samples_fid`` images."""
  g_cfg, d_cfg, spec = build_models("headline", dtype="bfloat16")
  g_cfg = dataclasses.replace(g_cfg, kernel_eval=True)
  gan = GANConfig(loss=spec["loss"], training_ratio=spec["ratio"],
                  random_flip=True, g_ema_decay=0.999)
  state = create_state(g_cfg, d_cfg, OptimConfig(), spec["ratio"], dev,
                       seed, g_ema_decay=0.999)
  ds = get_dataset("synthetic", batch_size=64, seed=seed, z_dim=g_cfg.z_dim,
                   synthetic_size=samples_fid)
  return Trainer(ds, state, gan, TrainerConfig(
      name="bench", output_dir=out_dir, device_data=False, seed=seed))


def _score_once(trainer: Trainer, samples_is: int, samples_fid: int,
                batch: int, conv_tf32: bool) -> dict:
  """One cold scorer call (a new scorer, the standing cache cleared):
  its seconds, by the parts the scorer logs, and K1 and K2 launches."""
  lines: List[str] = []
  trainer.logger.line = lines.append
  trainer._standing_cache = None
  scorer = scorer_lib.make_scorer(trainer.ds, samples_inception=samples_is,
                                  samples_fid=samples_fid, batch=batch,
                                  conv_tf32=conv_tf32)
  dev = trainer.device
  fence(dev)
  cuda_wc.MOMENTS_LAUNCHES = cuda_wc.WC_APPLY_LAUNCHES = 0
  t0 = time.perf_counter()
  scores = scorer(trainer)
  seconds = time.perf_counter() - t0
  parts = [float(v) for v in re.findall(r"([\d.]+)s\b", " ".join(lines))]
  if len(parts) != 4 or not all(np.isfinite(v) for v in scores.values()):
    raise RuntimeError(f"scorer: {scores}; log {lines}")
  return {"seconds": seconds, "generate_s": parts[0],
          "inception_is_s": parts[1], "real_moments_s": parts[2],
          "fake_moments_distance_s": parts[3], "scores": scores,
          "k1_launches": cuda_wc.MOMENTS_LAUNCHES,
          "k2_launches": cuda_wc.WC_APPLY_LAUNCHES}


def _is64(probs: np.ndarray, splits: int = 10) -> float:
  """The Inception Score's mean in numpy float64."""
  p = probs.astype(np.float64)
  per = p.shape[0] // splits
  p = p[:per * splits].reshape(splits, per, -1)
  marg = p.mean(1, keepdims=True)
  kl = (p * (np.log(p + 1e-16) - np.log(marg + 1e-16))).sum(-1)
  return float(np.exp(kl.mean(1)).mean())


def _fid64(m1, m2) -> float:
  """FID of float32 moments in float64 (``scipy.linalg.sqrtm``)."""
  import scipy.linalg
  (mu1, s1), (mu2, s2) = [[np.asarray(t.cpu(), np.float64) for t in m]
                          for m in (m1, m2)]
  covmean = scipy.linalg.sqrtm(s1 @ s2)
  return float(np.sum((mu1 - mu2) ** 2) + np.trace(s1) + np.trace(s2)
               - 2 * np.trace(covmean.real))


def inception_tf32_error(trainer: Trainer, samples_is: int,
                         samples_fid: int, batch: int) -> dict:
  """InceptionV3 (random weights, seed 0) with cuDNN TF32 convolutions
  against the float32 path on the scorer's images: the pool's and the
  logits' largest error relative to their largest magnitude, and each
  arm's IS and FID (float32 math, the port's) against numpy / scipy
  float64 on the float32 path's rows."""
  dev = trainer.device
  net = inception_v3.init_params(0).to(dev).eval()
  fakes = trainer.generate(samples_is)
  real = trainer.ds.real_sample(samples_fid)

  @torch.no_grad()
  def rows(images: np.ndarray, conv_tf32: bool):
    outs = []
    for i in range(0, len(images), batch):
      x = torch.from_numpy(images[i:i + batch]).to(dev)
      with metrics.true_float32():
        torch.backends.cudnn.allow_tf32 = conv_tf32
        outs.append(net(inception_v3.preprocess(x)))
    return [torch.cat(o).float() for o in zip(*outs)]

  arms = {}
  for conv_tf32 in (False, True):
    pool, logits = rows(fakes, conv_tf32)
    pool_r, _ = rows(real, conv_tf32)
    probs = torch.softmax(logits, dim=-1)
    arms[conv_tf32] = dict(
        pool=pool, logits=logits, probs=probs,
        m_fake=metrics.moments_from_activations(pool[:samples_fid]),
        m_real=metrics.moments_from_activations(pool_r))
  for arm in arms.values():
    # Random weights give near-uniform probabilities (IS ~1), so IS is
    # also taken on the logits centred and brought to a spread of 3.
    lg = arm["logits"]
    arm["sharp"] = torch.softmax(3.0 * (lg - lg.mean(0)) / lg.std(), dim=-1)
  ref, tf32 = arms[False], arms[True]

  def rel(key):
    a, b = tf32[key], ref[key]
    return float((a - b).abs().max() / b.abs().max())

  is64 = _is64(ref["probs"].cpu().numpy())
  sharp64 = _is64(ref["sharp"].cpu().numpy())
  fid64 = _fid64(ref["m_real"], ref["m_fake"])
  out = {"pool_rel_err": rel("pool"), "logits_rel_err": rel("logits"),
         "is_float64": is64, "is_sharp_float64": sharp64,
         "fid_float64": fid64}
  for name, arm in (("float32", ref), ("tf32", tf32)):
    is_ = float(metrics.inception_score(arm["probs"])[0])
    sharp = float(metrics.inception_score(arm["sharp"])[0])
    fid = metrics.fid_from_moments(*arm["m_real"], *arm["m_fake"])
    out[name] = {"is": is_, "is_rel_delta": (is_ - is64) / is64,
                 "is_sharp": sharp,
                 "is_sharp_rel_delta": (sharp - sharp64) / sharp64,
                 "fid": fid, "fid_rel_delta": (fid - fid64) / abs(fid64)}
  return out


def bench_scoring(device: str = "cuda", seed: int = 0,
                  samples_is: int = 50000, samples_fid: int = 10000,
                  batch: int = 100, inception_tf32: bool = False,
                  out_dir: str = os.path.join("build", "bench")) -> dict:
  """One scorer call (``make_scorer``) at the reference's defaults on the
  headline G, by part, with the scorer's default TF32 convolutions. With
  ``inception_tf32`` the call is made in turns with and without them
  (float32, TF32, TF32, float32), and ``inception_tf32_error`` holds
  TF32's rows and scores against the float32 path's."""
  dev = resolve_device(device)
  trainer = _scoring_trainer(dev, seed, samples_fid, out_dir)
  row = {"mode": "scoring", "samples_is": samples_is,
         "samples_fid": samples_fid, "batch": batch}
  if not inception_tf32:
    row.update(_score_once(trainer, samples_is, samples_fid, batch, True))
    return row
  calls = {False: [], True: []}
  for conv_tf32 in (False, True, True, False):
    calls[conv_tf32].append(_score_once(trainer, samples_is, samples_fid,
                                        batch, conv_tf32))
  for conv_tf32, name in ((False, "float32"), (True, "tf32")):
    row[name] = {k: _spread([c[k] for c in calls[conv_tf32]])
                 for k in ("seconds", "generate_s", "inception_is_s",
                           "real_moments_s", "fake_moments_distance_s")}
    for k in ("scores", "k1_launches", "k2_launches"):
      row[name][k] = calls[conv_tf32][0][k]
  row["accuracy"] = inception_tf32_error(trainer, samples_is, samples_fid,
                                         batch)
  return row


def _row(bench: Bench, steps: int, repeats: int) -> dict:
  """One measured row: imgs/s median and spread, K1 a step, memory."""
  m = measure(bench, steps, repeats)
  return {"imgs_per_sec": m["median"], "spread": [m["min"], m["max"]],
          "k1_launches_per_step": m["k1_launches_per_step"],
          "max_memory_mib": m["max_memory_mib"]}


def _shape_row(config: str, a, dtype: str, flops_cache: dict,
               d_fake_stats: str = "batch", **kw) -> dict:
  """A row at one CONFIGS shape, with its FLOPs (counted once per
  config, batch, dtype and d_fake_stats)."""
  bench = build_bench(config, batch=a.batch, dtype=dtype,
                      d_fake_stats=d_fake_stats, device=a.device,
                      seed=a.seed, **kw)
  row = _row(bench, a.steps, a.repeats)
  key = (config, a.batch, dtype, d_fake_stats, tuple(sorted(kw.items())))
  if key not in flops_cache:
    flops_cache[key] = count_flops(bench)
  row.update(mfu(flops_cache[key], row["imgs_per_sec"],
                 _imgs_per_step(bench), dtype, bench[2][0].device))
  return row


def _variant_row(a, **kw) -> dict:
  kw.setdefault("batch", a.batch)
  bench = variant_bench(device=a.device, seed=a.seed, **kw)
  return _row(bench, a.steps, a.repeats)


def record(a, dtype: str) -> dict:
  """The JAX package's bench.py line, with the port's fields beside it."""
  dev = resolve_device(a.device)
  bench = build_bench("headline", batch=a.batch, dtype=dtype,
                      device=a.device, seed=a.seed)
  turns = measure_turns(bench, a.steps, a.repeats)
  b, e = turns["captured"], turns["eager"]
  rec = {
      "metric": "imgs/sec/chip, G+D outer step, CIFAR-10 WC-ResNet "
                f"(batch {a.batch}, D:G 5:1, {dtype})",
      "value": b["median"],
      "unit": "imgs/sec/chip",
      "vs_baseline": b["median"] / BASELINE_IMGS_PER_SEC,
      "value_eager": e["median"],
  }
  spread = {"value": [b["min"], b["max"]],
            "value_eager": [e["min"], e["max"]]}
  memory = {"value": b["max_memory_mib"],
            "value_eager": e["max_memory_mib"]}
  if not a.no_b128:
    m = measure(build_bench("headline", batch=2 * a.batch, dtype=dtype,
                            device=a.device, seed=a.seed),
                a.steps, a.repeats)
    rec["value_b128"] = m["median"]
    spread["value_b128"] = [m["min"], m["max"]]
    memory["value_b128"] = m["max_memory_mib"]
  if not a.no_dfake:
    m = measure(build_bench("headline", batch=a.batch, dtype=dtype,
                            d_fake_stats="running", device=a.device,
                            seed=a.seed), a.steps, a.repeats)
    rec["value_dfake_running"] = m["median"]
    spread["value_dfake_running"] = [m["min"], m["max"]]
    memory["value_dfake_running"] = m["max_memory_mib"]
  flops = count_flops(bench)
  per_step = _imgs_per_step(bench)
  rec.update(
      spread=spread, windows=a.repeats, steps_per_window=a.steps,
      k1_launches_per_step=b["k1_launches_per_step"],
      k1_launches_per_step_eager=e["k1_launches_per_step"],
      capture_s=b["capture_s"],
      **mfu(flops, b["median"], per_step, dtype, dev),
      max_memory_mib=memory,
      device=device_info(dev), **switches(), torch=torch.__version__,
      cuda=torch.version.cuda, dtype=dtype, batch=a.batch)
  return rec


def parse_args(argv=None) -> argparse.Namespace:
  p = argparse.ArgumentParser(prog="python -m wcgan_tpu_torch.bench",
                              description=__doc__.splitlines()[0])
  p.add_argument("--device", default="cuda",
                 help="'cuda' (default; raises without a GPU) or 'cpu'")
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--steps", type=int, default=None,
                 help="outer steps (sampling: forwards) a timed window; "
                      "30, the ablation modes 20")
  p.add_argument("--repeats", type=int, default=3,
                 help="timed windows a row, in one process")
  p.add_argument("--batch", type=int, default=None,
                 help="64 (sampling 256)")
  p.add_argument("--f32", action="store_true",
                 help="float32 in place of bf16 (record, shapes)")
  p.add_argument("--no-b128", action="store_true")
  p.add_argument("--no-dfake", action="store_true")
  mode = p.add_mutually_exclusive_group()
  for flag in MODES:
    mode.add_argument(f"--{flag}", action="store_true")
  p.add_argument("--only", action="append", default=[],
                 help="--shapes: rows whose name contains this")
  p.add_argument("--dfake-running", action="store_true",
                 help="--shapes with d_fake_stats='running'")
  p.add_argument("--quick", action="store_true",
                 help="--variants: the first two only")
  p.add_argument("--inception-tf32", action="store_true",
                 help="--scoring: with and without TF32 convolutions "
                      "in InceptionV3 (the scorer's default), in turns, "
                      "and their error")
  p.add_argument("--samples-is", type=int, default=50000)
  p.add_argument("--samples-fid", type=int, default=10000)
  p.add_argument("--whitening-precision", choices=("highest", "high"),
                 default=None,
                 help="the record, --shapes, --sampling, --scoring: "
                      "'highest' (default, true float32) or "
                      "'high' (bf16x3 through K3); the ablation modes run "
                      "the reference's own")
  a = p.parse_args(argv)
  if a.quick and not any(getattr(a, m) for m in MODES):
    a.variants = True
  ablation = any(getattr(a, m) for m in ABLATION_MODES)
  if ablation:
    if a.whitening_precision is not None:
      p.error("--whitening-precision does not apply to the ablation modes: "
              f"they run '{ABLATION_PRECISION}' as the reference's do, "
              "--swing's ns15_highest_b64 'highest'")
    a.whitening_precision = ABLATION_PRECISION
  elif a.whitening_precision is None:
    a.whitening_precision = "highest"
  if a.steps is None:
    a.steps = 20 if ablation or a.shapes else 30
  if a.batch is None:
    a.batch = 256 if a.sampling else 64
  return a


def _rounds(a, rows, fn) -> None:
  """Two interleaved rounds of ``rows`` [(name, kwargs)], one line each
  (the JAX package's protocol: compare only within one process)."""
  for rnd in range(2):
    for name, kw in rows:
      emit({"swing": f"{name}_r{rnd}", **fn(**kw)})


def main(argv=None) -> int:
  a = parse_args(argv)
  dev = resolve_device(a.device)
  cli_run.set_precision()
  whiten.set_precision(a.whitening_precision)
  dtype = "float32" if a.f32 else "bfloat16"
  print(f"bench on {device_info(dev)}, torch {torch.__version__} cuda "
        f"{torch.version.cuda}, {switches()}, whitening_precision "
        f"{a.whitening_precision}", file=sys.stderr, flush=True)
  flops_cache: dict = {}
  variant = lambda **kw: _variant_row(a, **kw)          # noqa: E731
  shape = lambda config, **kw: _shape_row(              # noqa: E731
      config, a, dtype, flops_cache, **kw)
  if a.swing:
    for name, kw in (("baseline_ns15_b64", {}),
                     ("ns15_highest_b64", {}),
                     ("ns12_b64", {"ns_iters": 12}),
                     ("baseline_ns15_b128", {"batch": 2 * a.batch}),
                     ("ns12_b128", {"ns_iters": 12, "batch": 2 * a.batch})):
      with whiten.precision("highest" if "highest" in name
                            else ABLATION_PRECISION):
        emit({"swing": name, **variant(**kw)})
  elif a.dfake:
    _rounds(a, [(f"dfake_{m}", {"d_fake_stats": m})
                for m in ("batch", "running")], variant)
  elif a.nsscale:
    _rounds(a, [(f"nsscale_{s}_headline", {"ns_scaling": s})
                for s in ("trace", "fro")], variant)
    _rounds(a, [(f"nsscale_{s}_cfg2run", {"ns_scaling": s})
                for s in ("trace", "fro")],
            lambda **kw: shape("cfg2", d_fake_stats="running", **kw))
  elif a.modes:
    _rounds(a, [(f"mode_{n}_headline", {"norm": n})
                for n in ("d", "dr", "b")], variant)
    _rounds(a, [(f"mode_{n}_cfg2", {"block_norm": n}) for n in ("d", "dr")],
            lambda **kw: shape("cfg2", **kw))
  elif a.acgan:
    _rounds(a, [(k, {"config": k}) for k in ("cfg2", "acgan")], shape)
  elif a.gap:
    _rounds(a, [("gap_baseline", {}), ("gap_remat_g", {"remat": True}),
                ("gap_noflip", {"random_flip": False}),
                ("gap_sgd_opt", {"opt": "sgd"}),
                ("gap_run", {"d_fake_stats": "running"}),
                ("gap_bfg_run", {"d_fake_stats": "running",
                                 "batched_fake_gen": True})], variant)
  elif a.shapes:
    dfake = "running" if a.dfake_running else "batch"
    for name, key in SHAPES:
      if a.only and not any(o in name for o in a.only):
        continue
      row = {"config": name, **shape(key, d_fake_stats=dfake)}
      if dfake != "batch":
        row["d_fake_stats"] = dfake
      emit(row)
  elif a.sampling:
    for dt in ("bfloat16", "float32"):
      emit(bench_sampling(dt, a.batch, a.steps, a.repeats, a.device, a.seed))
  elif a.scoring:
    emit(bench_scoring(a.device, a.seed, a.samples_is, a.samples_fid,
                       inception_tf32=a.inception_tf32))
  elif a.variants:
    rows = [("d", "float32", 15), ("d", "bfloat16", 15),
            ("b", "float32", 15), ("n", "float32", 15),
            ("d", "bfloat16", 8), ("b", "bfloat16", 15),
            ("n", "bfloat16", 15)]
    for norm, dt, ns in rows[:2] if a.quick else rows:
      emit({"norm": norm, "dtype": dt, "ns_iters": ns,
            **variant(norm=norm, dtype=dt, ns_iters=ns)})
  else:
    emit(record(a, dtype))
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
