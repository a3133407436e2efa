"""On-card smoke test of the PyTorch port (wcgan_tpu_torch) on one GPU.

  python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU, nvcc
and PyTorch built for CUDA. It builds K1 (wcgan_tpu_torch/csrc/moments.cu),
K2 (csrc/wc_apply.cu) and K3 (csrc/mm_bf16x3.cu) side by side and prints
ptxas's registers and spills (K1's Gram kernel, K2's row apply, whose
wgmma accumulators live in registers, and K3 must not spill), holds each against its plain PyTorch
version, holds K1 against a float64 run, times both against their plain
version, one PyTorch call for the same function (``torch.cov`` for K1,
``torch.addmm`` for K2's row apply) and their bounds on this card (K2 per
R also as its two launches apart: the cooperative setup and the bf16
tensor-core row apply), checks one outer step with and without K1 at
small width in float32, then drives the two ported paths at full width:

- training (slice 1): G 256x3 + D 128x4, bf16, 10 outer steps of 5 D
  updates at batch 64 + 1 G update at batch 128; K1 runs 42 times a step;
- sampling (slice 2): ``Trainer.generate(1024, batch=256)`` from that G
  in eval mode on its running statistics, with K2 forced on every WC layer
  (7 launches a forward) and then on the split path; the images of the
  two must agree;

the CLI: a training run that writes sample grids, then ``--phase test``
on the npz that ``Trainer.export_weights`` wrote; and the CLI's default
run (slice 5): the same G and D with device-resident data in chains of 8
outer steps, EMA weights (0.999) and a full-state checkpoint each epoch,
2 epochs of 8 outer steps, then ``--resume auto`` for a third. That phase
checks the log, the checkpoints and the diagnostics in ``metrics.jsonl``,
restores the state into fresh trainers bit for bit, holds one outer step
from a saved and from its restored state together, counts K1 in one
standing-statistics recompute (7 x 16) and K2 in EMA sampling
(``generate(1024, batch=256)`` with K2 forced, 7 a forward), and times
the checkpoint, ``diagnostics()``, the recompute and EMA sampling. One
K2 generate forward is profiled (``torch.profiler``) for K2's kernels,
launches per call and the device's busy share. Then slice 11's ``bench``
phase: the port's benchmark (``wcgan_tpu_torch.bench``) cut short, the
headline's measured windows (K1 42 a step), its FLOP count and MFU, the
sampling arms (K2 7 a forward and 0) and the cfg1 row, its record
printed on one line. Then slice 12's ``graph`` phase, the compiled
step (``make_jit_step``, ``make_jit_dataset_step``: CUDA graphs): the
headline with EMA from one seed, a captured chain of 8 dataset steps
against the eager chain from the same state and generator (float32 within
GRAPH_RTOL of each tensor's largest value, the eager-vs-eager floor
printed beside it; then bf16), the generators' states after it, K1 42 a
step across replays; the CLI's float32 trainer checkpointed after a
captured chain and resumed in a fresh trainer (which warms up and
captures anew) against the uninterrupted run; the headline's imgs/s and
device span a step, captured and eager in turns; one captured
``d_fake_stats='running'`` + ``kernel_eval`` step (K2's cooperative setup
inside the graph: 35 K2, 7 K1 a replay). Then slice 13's ``sample-graph``
phase, the compiled sampling programs (``Trainer.sample``, ``sample_u8``,
``generate`` and the standing pass as CUDA graphs): the headline G (EMA
0.999, 16 batches of standing statistics) with ``kernel_eval=True`` and on
the split path, in float32 and bf16, every surface captured against the
eager forward on the same tensors bit for bit (deterministic kernels),
fresh, after a trainer epoch of replayed G updates, after a restore and
after a ladder rung; the captured standing pass against the eager one,
K1 7 and K2 7 a replay; captured and eager imgs/s in turns. Every other
sampling path of the script runs these graphs too. Then slice 14's
``high`` phase, ``--whitening_precision high`` (every whitening-path
product as bf16x3 through K3, the JAX package's default precision): K3
against its plain version at C x C x C (C = 64 to 512) and R x 256 x 256
(R = 1,024 to 131,072) in three layouts, each on the path its shape picks
(split-K, or wgmma from R = 16,384), at the plain covariance's
256 x 131,072 x 256 against float64 and on offset views and M = 1,
against float64 beside a float32 product, on inf and NaN; K3's epilogue
(Newton-Schulz's T = 1.5 I - 0.5 Z Y in one launch) bitwise against the
unfused expression, its derivatives too (slice 15); K3 timed against its
plain version and torch.matmul in float32 (TF32 off and on), at every
C x C x C shape against torch.matmul, and one Newton-Schulz iteration
fused, unfused and under 'highest'; one float32 headline step under
each precision from one state (within STEP_RTOL); the whitening residual
under each on the headline's covariances, fresh and after 7 steps, and
at conditioning 1e3; the captured bf16 headline step under 'high' (K3
2,499 and K1 42 a replay), a captured chain of 8 against the eager one
bit for bit, the step timed in turns against 'highest', each step
profiled for its kernel time and kernel count. ``python3
chip_smoke.py --phase high`` runs that phase alone. Then the conditional
slice (slice 6):

- k1-widths: K1 at C = 64, 128 and 512, f32 and bf16 rows, at every R of
  the conditional models and of the digits G and a ragged R, within TOL
  and bitwise
  repeatable, timed in turns with its bound and torch.cov;
- cond-slice: cWC + projection-D (preset cifar10_cwc_resnet_proj: G
  256x3 ucconv, 10 classes) and cWC-sa (preset tiny_imagenet_cwcsa's
  shape: G (512, 256, 128, 64) ucconv-sa at 64x64, 200 classes) at full
  width, bf16 outer steps with 42 and 54 K1 launches a step, one float32
  outer step of each with K1 and with plain moments (deterministic
  kernels; plain on the same batches reordered gives float32 rounding's
  own spread, which bounds the gate where it passes STEP_RTOL), one cWC
  step profiled;
- gp-dnorm: WC layers in D with WGAN-GP: one D update's loss and its D
  gradient (K1's backward differentiated twice) against the plain
  version's, then one float32 outer step with K1 (138 launches) and with
  plain moments;
- cond-sampling: conditional ``generate(1024, batch=256)`` (no K2 launch:
  K2 has one coloring for all rows, and forcing it raises), and the CLI
  with ``--conditional --gan_type PROJECTIVE``: labelled grids, then
  ``--phase test`` on the exported npz.

Then slice 7, the DCGAN and the options of the step:

- dcgan: BASELINE config 1 at full width (``python -m wcgan_tpu_torch
  --preset cifar10_wc_dcgan --dataset synthetic --synthetic_resolution
  32``: DCGAN G (256, 128, 64) from 4x4, SN DCGAN D (64, 128, 256), ns,
  one D update, float32): 2 epochs of 8 outer steps with a checkpoint
  each, ``--resume auto`` for a third, ``--phase test`` on its npz; K1
  at the G's (C, R) within TOL and timed; 6 outer steps with 8 K1
  launches each; one float32 step with K1 against plain moments;
- dcgan-bn: the same G with 'b' norms: no K1 launch, finite losses;
- dcgan-sampling: K2 against its plain version at C = 128 and 64, timed
  per width against torch.addmm; the DCGAN G's ``generate(1024,
  batch=256)`` with K2 forced (4 launches a forward) against K2's plain
  version and the split path;
- step-options: on the headline model, 2 bf16 outer steps and one float32
  step (K1 against plain) each of ``batched_fake_gen`` (14 K1 launches a
  step), ``d_fake_stats=running`` (7; 35 K2 launches with
  kernel_eval=True), ``remat`` (48: the G update's 6 block WC layers run
  again in the backward), ``sn_update_on_g_step`` and a D with
  ``conv_singular`` (42 each); K1 at batched_fake_gen's 327,680 rows;
- presets: every preset through ``--preset <name> --smoke`` on the card,
  ``imagenet64_cwc_dp`` (``--mesh 8``) stopped on the GPU count, and
  ``stl10_wc_resnet_sn`` at full width (48x48) for 2 outer steps (84 K1
  launches).

Then slice 8, data parallelism (``dp``): BASELINE config 5 (preset
``imagenet64_cwc_dp``: cWC-sa G (512, 256, 128, 64) at 64x64, 1,000
classes, projection-D, hinge, bf16, ratio 5) on synthetic data of
imagenet64's shape, as 2 ranks sharing the one card over gloo with 64
images a rank (a global batch of 128 in place of 512): 3 outer steps
through the trainer's dataset chain after a warm-up epoch (K1 54 a rank a
step, as one process; all-reduce calls and bytes a step; wall time; the
state bit-equal on both ranks); float32 at full width against one process
on the global batch (the G forward within 2e-5, one outer step within
STEP_RTOL, K1 route and plain route, each or twice the process's own
spread on a reordered batch); ``dryrun_multichip`` on the two ranks; and
``--mesh 1 --device cuda`` through the CLI, a one-rank NCCL group running
the compiled chain, with a checkpoint and ``--resume auto``; and the
CLI's scorer under ``--mesh 2`` (2,048 IS / 1,024 FID samples) on the two
ranks against one process. Then slice 13's ``nccl`` phase: config 5's
compiled chain with an NCCL group (one CUDA graph a call on each rank,
its all-reduces inside) against the eager chain, float32, one rank, and
with two or more cards two ranks (on one card it says in one line that it
did not run). ``python3 chip_smoke.py --phase nccl`` runs that phase alone
on every card of the machine, the last size also in bf16, timed captured
against eager.

Before it, slice 9, evaluation (``eval``), at the reference's scorer
defaults (50,000 IS / 10,000 FID samples, batch 100) with random
InceptionV3 weights (the repository has none): the network and
``preprocess`` on the card against the CPU (float32, TF32 off); IS against
numpy float64 on the same probabilities; FID (``eigh``) of 10,000 x 2,048
pool moments against ``scipy.linalg.sqrtm`` in float64, ``ns`` against
``eigh``; one ``make_scorer`` call on the headline G (256x3, bf16, EMA
0.999, ``kernel_eval=True``) from a cold standing cache: one ``generate``,
K1 112, K2 1,372 (196 forwards), finite ``unverified_*`` scores, its wall
clocks, and the same scorer on the split path within a stated tolerance;
the scorer's default TF32 convolutions held to the same IS and FID gates
against float64 (slice 15);
then the CLI with ``--score_every 1`` for 2 epochs and ``--phase test``
with scoring.

Last, slice 10, real data (``digits``): the bundled digits load with
sklearn blocked; the README's conditional digits run (G (128, 128) cWC
``ucconv`` at 16x16, projection-D, bf16, batch 64) through the CLI at full
width, cut from 300 to 100 epochs (500 outer steps, K1 30 a step), with
checkpoints at epochs 24, 49, 74 and 99; then the port's feature-FID /
IS-analog tool (its judge trained to >= 0.90, FID at epoch 99 below epoch
24's and below half the noise ceiling) and its conditional-fidelity tool
(>= 0.30, three times chance) on them.

Every phase that fails stops the script with a non-zero exit. The last line is
{"ok": true, "device": {...}}; the line before it lists each kernel with
its launches on its path, error and times. Without a GPU it exits
non-zero and prints no result. It imports no JAX and nothing of the JAX
package, as the port does.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
from torch.func import functional_call

from wcgan_tpu_torch import bench
from wcgan_tpu_torch.cli import run as cli_run
from wcgan_tpu_torch.cli.presets import PRESETS
from wcgan_tpu_torch.data import get_dataset
from wcgan_tpu_torch.device import card as nvidia_smi, place
from wcgan_tpu_torch.evaluation import inception_v3, metrics
from wcgan_tpu_torch.evaluation import scorer as scorer_lib
from wcgan_tpu_torch.models.discriminator import (Discriminator,
                                                  DiscriminatorConfig)
from wcgan_tpu_torch.models import layers as L
from wcgan_tpu_torch.models.generator import Generator, GeneratorConfig
from wcgan_tpu_torch.ops import _build, cuda_wc, losses, mm_bf16x3, whiten
from wcgan_tpu_torch.parallel import dryrun, launch, mesh
from wcgan_tpu_torch.tools import digits_quality
from wcgan_tpu_torch.train import schedules
from wcgan_tpu_torch.train import step as step_lib
from wcgan_tpu_torch.train.state import OptimConfig, create_state
from wcgan_tpu_torch.train.step import GANConfig, make_outer_step
from wcgan_tpu_torch.train.trainer import CKPT_FILE, Trainer, TrainerConfig

C = 256
# R = N*H*W of the 7 WC layers of G 256x3 (4x4 -> 32x32) at the D-phase
# batch 64 (5 forwards per outer step) and the G-update batch 128 (1).
D_PHASE_R = (1024, 4096, 4096, 16384, 16384, 65536, 65536)
G_UPDATE_R = (2048, 8192, 8192, 32768, 32768, 131072, 131072)
CHECK_R = (1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072, 1000, 130)
TOL = 1e-4          # K1 against the plain float32 moments (reference gate)
STEP_RTOL = 1e-3    # one outer step, K1 against plain moments, float32
STATS_ATOL = 1e-4
# R of the 7 WC layers of G 256x3 in eval mode: a batch-64 sample grid and
# a batch-256 generate() forward.
GRID_R = (1024, 4096, 4096, 16384, 16384, 65536, 65536)
GENERATE_R = (4096, 16384, 16384, 65536, 65536, 262144, 262144)
K2_F32_TOL = 5e-4   # K2 against its plain version, float32 rows: the JAX
                    # package's gate between its fused kernel and the
                    # composition (tests/test_pallas_wc.py)
K2_CASES_C = (256, 512, 64, 16)
K2_CASES_R = (1024, 65536, 262144, 130, 1000)
# The two sampling paths round at other places (K2 applies the rows in
# float32 and rounds once; the split path rounds M to bf16 first), and
# the differences pass through 7 layers: uint8 images of the same z must
# agree to within these levels (of 255; one level is about one bf16 ulp
# at 1.0): mean, 99.9th percentile and largest |diff|.
SAMPLE_MEAN_TOL = 1.0
SAMPLE_P999_TOL = 4.0
SAMPLE_MAX_TOL = 16
# Peak rates of an H100 SXM at 700 W (NVIDIA's data sheet) for the floors:
# float32 on the FFMA pipes, TF32 and bf16 on the tensor cores (dense),
# HBM3. A product's operations floor takes the peak for its inputs' type:
# bf16 rows at the bf16 rate, float32 rows at the TF32 rate (the card's
# fastest for float32 inputs).
FFMA_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12
# The names of K1's and K2's launches, for the profiler's kernel table.
K1_KERNELS = ("col_partial_sums", "finalize_mean", "centered_gram_tf32x3",
              "reduce_gram")
K2_KERNELS = ("ns_setup", "rows_apply_bf16", "rows_apply_f32")


def check(ok: bool, what) -> None:
  """Fail the phase (an assert would vanish under python -O)."""
  if not ok:
    raise RuntimeError(f"chip_smoke check failed: {what}")


def log(phase: str, msg: str) -> None:
  print(f"[{phase}] {msg}", flush=True)


def max_err(a, b) -> float:
  return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


def phase_device() -> torch.device:
  if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                     "this script needs a CUDA GPU")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  log("device", f"{nvidia_smi()} | torch {torch.__version__} cuda "
      f"{torch.version.cuda} | count {torch.cuda.device_count()}")
  log("device", f"torch.backends.cuda.matmul.allow_tf32="
      f"{torch.backends.cuda.matmul.allow_tf32} torch.backends.cudnn."
      f"allow_tf32={torch.backends.cudnn.allow_tf32}")
  return torch.device("cuda", 0)


def _ptxas_report(out: str):
  """[(mangled kernel name, registers, spill bytes)] from nvcc -Xptxas -v
  output."""
  report, name = [], None
  for line in out.splitlines():
    if "Compiling entry function" in line:
      name = line.split("'")[1]
    elif "spill" in line and name:
      spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
    elif "Used" in line and "registers" in line and name:
      regs = int(re.search(r"Used (\d+) registers", line).group(1))
      report.append((name, regs, spill))
      name = None
  return report


def phase_build() -> None:
  """The three kernels at once, one nvcc each; ptxas's registers and
  spills of every kernel function. K1's Gram kernel, K2's bf16 row apply
  (wgmma accumulators in registers) and K3 must not spill."""
  t0 = time.perf_counter()
  names = ("moments", "wc_apply", "mm_bf16x3")
  with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
    builds = dict(zip(names, pool.map(_build.compile_library, names)))
  _build.load_moments()
  _build.load_wc_apply()
  _build.load_mm_bf16x3()
  for name, (path, out, compile_s) in builds.items():
    report = _ptxas_report(out)
    log("build", f"{name}: {path.name} built in {compile_s:.2f} s; ptxas -v: "
        + "; ".join(f"{k} {r} registers, {sp} bytes spilled"
                    for k, r, sp in report))
    warnings = [l.strip() for l in out.splitlines()
                if "arning" in l or "(C7" in l]
    if warnings:
      log("build", f"{name}: " + " | ".join(warnings))
    if name == "moments":
      gram = [sp for k, _, sp in report if "centered_gram" in k]
      check(len(gram) == 2 and not any(gram), ("K1 Gram spills", report))
    elif name == "wc_apply":
      rows = [sp for k, _, sp in report if "rows_apply_bf16" in k]
      check(len(rows) == 2 and not any(rows), ("K2 row apply spills",
                                               report))
    else:
      # Split-K: 2 tile shapes x 4 layouts; rows: 2 slices x A as given or
      # transposed.
      k3 = [sp for k, _, sp in report if "mm_bf16x3_" in k]
      check(len(k3) == 12 and not any(k3), ("K3 spills", report))
  log("build", f"all three loaded in {time.perf_counter() - t0:.2f} s")


def phase_parity(dev: torch.device) -> float:
  gen = torch.Generator(device=dev).manual_seed(0)
  worst = 0.0
  for dtype in (torch.float32, torch.bfloat16):
    errs = []
    for r in CHECK_R:
      x = (torch.randn((r, C), generator=gen, device=dev) * 2 + 3).to(dtype)
      got = cuda_wc.moments_cuda(x)
      again = cuda_wc.moments_cuda(x)
      torch.cuda.synchronize()
      check(all(torch.equal(a, b) for a, b in zip(got, again))
            and torch.equal(got[1], got[1].T), ("not repeatable", dtype, r))
      err = max_err(got, cuda_wc.moments_reference(x))
      errs.append(f"{r}:{err:.2e}")
      check(err <= TOL, (dtype, r, err))
      worst = max(worst, err)
    log("parity", f"K1 vs plain, C={C}, {dtype}: max|d| per R " +
        " ".join(errs) + "; two calls bitwise equal, cov == cov^T")
  # |mu| = 1000, sigma = 0.01: float32 resolves the mean only to ~1e-4
  # (ulp 6e-5), so it is held to 1e-6 relative, and the covariance (1e-4
  # on the diagonal) to 1e-6 absolute, 1% of the variance.
  x = torch.randn((4096, C), generator=gen, device=dev) * 0.01 + 1000.0
  (mean_k, cov_k), (mean_p, cov_p) = (cuda_wc.moments_cuda(x),
                                      cuda_wc.moments_reference(x))
  mean_rel = float(((mean_k - mean_p) / mean_p).abs().max())
  cov_err = float((cov_k - cov_p).abs().max())
  diag = torch.diagonal(cov_k)
  check(float(diag.min()) >= 0 and mean_rel <= 1e-6 and cov_err <= 1e-6
        and float(((diag - 1e-4) / 1e-4).abs().max()) <= 0.2,
        (float(diag.min()), mean_rel, cov_err))
  log("parity", f"large mean (|mu|=1000, sigma=0.01): mean rel|d| "
      f"{mean_rel:.2e}, cov max|d| {cov_err:.2e}, diag in "
      f"[{float(diag.min()):.3e}, {float(diag.max()):.3e}] (>= 0, ~1e-4)")
  x = torch.randn((16384, C), generator=gen, device=dev) * 2 + 3
  w = torch.randn((C, C), generator=gen, device=dev)
  grads = []
  for fn in (cuda_wc.moments, cuda_wc.moments_reference):
    xg = x.clone().requires_grad_(True)
    mean, cov = fn(xg)
    (torch.sum(cov * w) + torch.sum(mean ** 2)).backward()
    grads.append(xg.grad)
  err = max_err(grads[:1], grads[1:])
  scale = float(grads[1].abs().max())
  check(err <= TOL, err)
  worst = max(worst, err)
  log("parity", f"MomentsFn grad vs autograd of plain, R=16384: max|d| "
      f"{err:.2e} (max|grad| {scale:.2e})")
  return worst


def _time_ms(fn, *args, iters: int = 20) -> float:
  """Device ms per call: the queue is held by a sleep kernel (~25 ms)
  while the host enqueues the calls, so the events time the card, not the
  host, as long as the enqueue ends inside the hold. A call that enqueues
  many small launches (K2's plain version) outlasts it and is timed as
  host-bound."""
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  torch.cuda._sleep(50_000_000)
  start.record()
  for _ in range(iters):
    fn(*args)
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def _in_turns(*calls):
  """Mean device ms of each call (fn, args), warmed up, timed in turns
  a b c c b a."""
  for fn, args in calls:
    for _ in range(3):
      fn(*args)
  order = list(range(len(calls)))
  times = [_time_ms(calls[i][0], *calls[i][1]) for i in order + order[::-1]]
  return [(times[i] + times[-1 - i]) / 2 for i in order]


def ops_rate(dtype: torch.dtype) -> float:
  """Peak flop/s of a product of ``dtype`` inputs on the tensor cores."""
  return BF16_FLOPS if dtype == torch.bfloat16 else TF32_FLOPS


def k1_floors(rows: int, cols: int):
  """ms floors of one K1 call on bf16 rows on this card: (bytes, bf16
  operations, FFMA, 3xTF32). Bytes: x read once, mean and cov written
  once. Operations: the symmetric Gram's R*C*(C+1) flop at the bf16
  tensor-core rate, the peak for the input's type. Their larger is the
  bound. Beside it, the same flop on the FFMA pipes, and the floor of the
  3xTF32 emulation K1 runs (three passes at the TF32 rate)."""
  flop = rows * cols * (cols + 1)
  hbm = (rows * cols * 2 + 4 * (cols + cols * cols)) / HBM_BYTES
  return (hbm * 1e3, flop / BF16_FLOPS * 1e3, flop / FFMA_FLOPS * 1e3,
          3 * flop / TF32_FLOPS * 1e3)


def _torch_cov(xf):
  return torch.cov(xf.T, correction=0)


def phase_timing(dev: torch.device):
  """K1, its plain version and torch.cov (on a float32 copy made outside
  the timed window, TF32 off) per R of the main path, bf16 rows, C=256, in
  turns, with each R's floors and the share of the bound K1 reaches; then
  the sums over the 42 calls of one outer step. Returns those sums, (K1,
  plain, torch.cov, bound) ms, and what sets the bound."""
  gen = torch.Generator(device=dev).manual_seed(1)
  per_r, floors = {}, {}
  for r in sorted(set(D_PHASE_R + G_UPDATE_R)):
    x = torch.randn((r, C), generator=gen, device=dev).to(torch.bfloat16)
    xf = x.float()
    k, p, lib = _in_turns((cuda_wc.moments_cuda, (x,)),
                          (cuda_wc.moments_reference, (x,)),
                          (_torch_cov, (xf,)))
    floors[r] = hbm, ops, ffma, tf32x3 = k1_floors(r, C)
    bound, by = max(hbm, ops), "bytes" if hbm >= ops else "operations"
    per_r[r] = (k, p, lib, bound)
    log("timing", f"R={r}: K1 {k:.4f} ms, plain {p:.4f}, torch.cov {lib:.4f}"
        f"; bound {bound:.4f} ({by}: HBM {hbm:.4f}, bf16 operations "
        f"{ops:.4f}); floors FFMA {ffma:.4f}, 3xTF32 {tf32x3:.4f}; K1 at "
        f"{bound / k:.1%} of its bound, {tf32x3 / k:.1%} of the 3xTF32 floor")

  def step_sum(values):
    return 5 * sum(values[r] for r in D_PHASE_R) + sum(
        values[r] for r in G_UPDATE_R)

  sums = [step_sum({r: v[i] for r, v in per_r.items()}) for i in range(4)]
  hbm, ops, ffma, tf32x3 = (step_sum({r: f[i] for r, f in floors.items()})
                            for i in range(4))
  bound_by = "bytes" if hbm >= ops else "operations"
  log("timing", f"the 42 calls of one outer step (device ms, bf16 rows, "
      f"C=256, on {nvidia_smi()}): K1 {sums[0]:.4f}, plain {sums[1]:.4f}, "
      f"torch.cov {sums[2]:.4f}; bound {sums[3]:.4f} ({bound_by}: HBM "
      f"{hbm:.4f}, bf16 operations {ops:.4f}); floors FFMA {ffma:.4f}, "
      f"3xTF32 {tf32x3:.4f}; K1 at {sums[3] / sums[0]:.1%} of its bound, "
      f"{tf32x3 / sums[0]:.1%} of the 3xTF32 floor")
  return tuple(sums) + (bound_by,)


def phase_f64(dev: torch.device) -> None:
  """K1 and the plain float32 version against a float64 run of the same
  bf16 rows (correlated, mean in [-3, 3], |cov| up to ~5), R=131,072."""
  gen = torch.Generator(device=dev).manual_seed(8)
  for cols in (C, 512):
    a = torch.randn((cols, cols), generator=gen, device=dev) / cols ** 0.5
    x = (torch.randn((131072, cols), generator=gen, device=dev) @ a.T * 1.5
         + torch.rand((cols,), generator=gen, device=dev) * 6 - 3
         ).to(torch.bfloat16)
    x64 = x.double()
    mean64 = x64.mean(dim=0)
    cov64 = (x64 - mean64).T @ (x64 - mean64) / x64.shape[0]
    errs = {}
    for name, fn in (("K1", cuda_wc.moments_cuda),
                     ("plain", cuda_wc.moments_reference)):
      mean, cov = fn(x)
      errs[name] = (float((mean.double() - mean64).abs().max()),
                    float((cov.double() - cov64).abs().max()))
    check(errs["K1"][1] <= TOL, errs)
    log("f64", f"R=131072, C={cols}, bf16 rows, max|cov| "
        f"{float(cov64.abs().max()):.3f}: max|d| from float64, mean/cov: K1 "
        f"{errs['K1'][0]:.2e}/{errs['K1'][1]:.2e}, plain float32 "
        f"{errs['plain'][0]:.2e}/{errs['plain'][1]:.2e}")


def _k2_inputs(rows, cols, gen, dev, cond=1e3):
  """Running statistics with a correlated covariance of condition
  ``cond`` (live WC layers reach ~1e3), rows drawn from them (so that the
  whitened rows are O(1), as in G), Gamma near 1/sqrt(C) scale."""
  q, _ = torch.linalg.qr(torch.randn((cols, cols), generator=gen, device=dev))
  eig = torch.logspace(0.0, -float(np.log10(cond)), cols, device=dev)
  cov = (q * eig) @ q.T
  mean = torch.randn((cols,), generator=gen, device=dev)
  x = mean + (torch.randn((rows, cols), generator=gen, device=dev)
              * eig.sqrt()) @ q.T
  gamma = torch.randn((cols, cols), generator=gen, device=dev) / cols ** 0.5
  beta = torch.randn((cols,), generator=gen, device=dev)
  return x, mean, cov, gamma, beta


def _bf16_gate(ref: torch.Tensor) -> float:
  """2 bf16 ulps of the output's largest magnitude."""
  return 2.0 * 2.0 ** (np.floor(np.log2(float(ref.float().abs().max()))) - 7)


def phase_k2_parity(dev: torch.device) -> float:
  """K2 against its plain version: every C x R, f32 and bf16 rows, both
  scalings, Gamma random or (Gamma = I, beta = 0); then the negative
  diagonal of tests/test_pallas_wc.py. Returns the worst float32 |diff|."""
  gen = torch.Generator(device=dev).manual_seed(5)
  worst_f32 = 0.0
  case = 0
  for cols in K2_CASES_C:
    errs = []
    for i, rows in enumerate(K2_CASES_R):
      x, mean, cov, gamma, beta = _k2_inputs(rows, cols, gen, dev)
      for j, dtype in enumerate((torch.float32, torch.bfloat16)):
        scaling = ("trace", "fro")[(i + j) % 2]
        if case % 3 == 2:         # DecorrelationNorm's call
          gamma_c, beta_c = torch.eye(cols, device=dev), 0 * beta
        else:
          gamma_c, beta_c = gamma, beta
        case += 1
        xd = x.to(dtype)
        got = cuda_wc.whiten_color_apply_cuda(xd, mean, cov, gamma_c, beta_c,
                                              scaling=scaling)
        torch.cuda.synchronize()
        ref = cuda_wc.whiten_color_apply_reference(xd, mean, cov, gamma_c,
                                                   beta_c, scaling=scaling)
        check(got.dtype == dtype and got.shape == xd.shape, (got.dtype,
                                                            got.shape))
        err = float((got.float() - ref.float()).abs().max())
        gate = K2_F32_TOL if dtype == torch.float32 else _bf16_gate(ref)
        check(err <= gate, (cols, rows, dtype, scaling, err, gate))
        if dtype == torch.float32:
          worst_f32 = max(worst_f32, err)
        errs.append(f"{rows}/{'f32' if dtype == torch.float32 else 'bf16'}"
                    f"/{scaling}{'/I' if gamma_c is not gamma else ''}:"
                    f"{err:.2e}(<={gate:.1e})")
    log("k2-parity", f"C={cols} (cond 1e3 stats), R/dtype/scaling: "
        + " ".join(errs))
  for cols in (16, 256):
    x, mean, cov, _, _ = _k2_inputs(1000, cols, gen, dev, cond=10.0)
    # Feature 0 near-constant: its variance rounded negative, junk
    # covariances of the same magnitude.
    cov[0, :] = cov[:, 0] = 1e-8 * torch.randn((cols,), generator=gen,
                                               device=dev)
    cov[0, 0] = -3e-8
    x[:, 0] = mean[0] + 1e-4 * torch.randn((1000,), generator=gen,
                                           device=dev)
    args = (mean, cov, torch.eye(cols, device=dev),
            torch.zeros(cols, device=dev))
    got = cuda_wc.whiten_color_apply_cuda(x, *args)
    ref = cuda_wc.whiten_color_apply_reference(x, *args)
    err = float((got - ref).abs().max())
    check(bool(torch.isfinite(got).all()) and err <= K2_F32_TOL, (cols, err))
    worst_f32 = max(worst_f32, err)
    log("k2-parity", f"negative diagonal, C={cols}, R=1000, f32: max|d| "
        f"{err:.2e}")
  return worst_f32


def k2_bounds(rows: int, cols: int, ns_iters: int = 15):
  """ms of one K2 call on bf16 rows on this card: (bytes, bf16 operations,
  FFMA). Bytes: x read and out written once in bf16, mean, cov, Gamma and
  beta read once in float32. Operations: the row apply's 2RC^2 and the
  setup's 3 ns_iters 2C^3 flop at the bf16 tensor-core rate, the peak for
  the input's type. The bound is the larger of the two. Beside it, the
  same flop on the FFMA pipes: a floor of an all-float32 kernel, not the
  bound."""
  flop = 2 * rows * cols ** 2 + 3 * ns_iters * 2 * cols ** 3
  nbytes = 2 * rows * cols * 2 + 4 * (2 * cols * cols + 2 * cols)
  return (nbytes / HBM_BYTES * 1e3, flop / BF16_FLOPS * 1e3,
          flop / FFMA_FLOPS * 1e3)


def k2_setup_stages(ns_iters: int = 15) -> int:
  """Dependent stages of K2's setup with trace scaling: Y0/T0, Y1, T and
  Y/Z per further Newton-Schulz step, the fold, the bias (a grid-wide
  barrier between two; Frobenius scaling adds one)."""
  return 1 + (ns_iters >= 2) + 2 * max(ns_iters - 1, 0) + 2


def phase_k2_timing(dev: torch.device):
  """Device ms per call, bf16 rows, C=256, at each R of the sampling
  forwards, in turns: K2, its plain version, its setup launch alone, its
  row-apply launch alone and torch.addmm (the row apply in float32, on a
  float32 copy made outside the timed window), with the bound; then the
  sums over the 7 calls of one forward, and the setup without
  Newton-Schulz steps (its cost per dependent stage). Returns (K2, plain,
  bound, torch.addmm) ms of one batch-256 generate forward and what sets
  the bound."""
  gen = torch.Generator(device=dev).manual_seed(6)
  names = ("K2", "plain", "setup", "rows", "addmm")
  per_r = {}
  for r in sorted(set(GRID_R + GENERATE_R)):
    x, mean, cov, gamma, beta = _k2_inputs(r, C, gen, dev)
    stats = (mean, cov, gamma, beta)
    xb = x.to(torch.bfloat16)
    workspace = cuda_wc.whiten_color_setup_cuda(*stats)
    m, bias = cuda_wc.whiten_color_fold_reference(*stats)
    xf, mt = xb.float(), m.T.contiguous()
    times = _in_turns((cuda_wc.whiten_color_apply_cuda, (xb,) + stats),
                      (cuda_wc.whiten_color_apply_reference, (xb,) + stats),
                      (cuda_wc.whiten_color_setup_cuda, stats),
                      (cuda_wc.whiten_color_rows_cuda, (xb, workspace)),
                      (torch.addmm, (bias, xf, mt)))
    hbm, ops, ffma = k2_bounds(r, C)
    per_r[r] = dict(zip(names, times), bound=max(hbm, ops), hbm=hbm, ops=ops,
                    ffma=ffma)
    t = per_r[r]
    log("k2-timing", f"R={r}: K2 {t['K2']:.4f} ms = setup {t['setup']:.4f} "
        f"+ row apply {t['rows']:.4f}; plain {t['plain']:.4f}; torch.addmm "
        f"{t['addmm']:.4f}; bound {t['bound']:.4f} (bytes {hbm:.4f}, bf16 "
        f"operations {ops:.4f}); K2 at {t['bound'] / t['K2']:.1%} of it, "
        f"row apply at {hbm / t['rows']:.1%} of its bytes")
  sums = {}
  for fwd, rs in (("grid b64", GRID_R), ("generate b256", GENERATE_R)):
    sums[fwd] = {k: sum(per_r[r][k] for r in rs) for k in per_r[rs[0]]}
    t = sums[fwd]
    by = "bytes" if t["hbm"] >= t["ops"] else "operations"
    log("k2-timing", f"the 7 calls of one {fwd} forward (device ms, bf16 "
        f"rows, C=256, on {nvidia_smi()}): K2 {t['K2']:.4f} = setup "
        f"{t['setup']:.4f} + row apply {t['rows']:.4f}; plain "
        f"{t['plain']:.4f}; torch.addmm {t['addmm']:.4f}; bound "
        f"{t['bound']:.4f} ({by}: bytes {t['hbm']:.4f}, bf16 operations "
        f"{t['ops']:.4f}); K2 at {t['bound'] / t['K2']:.1%} of its bound")
  faster = all(per_r[r]["rows"] < per_r[r]["addmm"] for r in GENERATE_R)
  gen_sums = sums["generate b256"]
  log("k2-timing", f"floors beside the bound, not the bound: all flop on the "
      f"FFMA pipes {gen_sums['ffma']:.4f} ms; the setup's "
      f"{k2_setup_stages()} dependent stages a call. Row apply faster than "
      f"torch.addmm at every R of GENERATE_R: {faster}")
  _, mean, cov, gamma, beta = _k2_inputs(8, C, gen, dev)
  stats = (mean, cov, gamma, beta)
  t0, t15 = _in_turns((cuda_wc.whiten_color_setup_cuda, stats + (0,)),
                      (cuda_wc.whiten_color_setup_cuda, stats))
  per_stage = (t15 - t0) / (k2_setup_stages() - k2_setup_stages(0)) * 1e3
  log("k2-timing", f"setup alone, C=256: ns_iters 15 {t15:.4f} ms, 0 "
      f"(jitter, scale, fold, bias) {t0:.4f} ms: {per_stage:.2f} us per "
      f"Newton-Schulz stage")
  by = "bytes" if gen_sums["hbm"] >= gen_sums["ops"] else "operations"
  return (gen_sums["K2"], gen_sums["plain"], gen_sums["bound"],
          gen_sums["addmm"], by)


def phase_step_parity(dev: torch.device) -> None:
  """One float32 outer step, K1 against plain moments, small width."""
  gan = GANConfig(training_ratio=2, generator_batch_multiple=2, z_dim=32,
                  random_flip=True)
  d_cfg = DiscriminatorConfig(filters=(64, 64, 64, 64))
  gen = torch.Generator().manual_seed(2)
  b = 16
  real = torch.randint(0, 256, (2, b, 32, 32, 3), generator=gen,
                       dtype=torch.uint8)
  noise = {"z_d": torch.randn((2, b, 32), generator=gen),
           "z_g": torch.randn((2 * b, 32), generator=gen),
           "flip": torch.rand((2, b), generator=gen) < 0.5}
  results = []
  for use_kernel in (True, False):
    g_cfg = GeneratorConfig(z_dim=32, filters=(64, 64, 64),
                            use_kernel=use_kernel)
    state = create_state(g_cfg, d_cfg, OptimConfig(), 2, dev, seed=3)
    before = cuda_wc.MOMENTS_LAUNCHES
    metrics = make_outer_step(gan)(state, real, None, noise=noise)
    launched = cuda_wc.MOMENTS_LAUNCHES - before
    stats = {n: buf.detach().clone()
             for n, buf in state.g.named_buffers()}
    results.append(({k: float(v) for k, v in metrics.items()}, stats,
                    launched))
  (m_k, s_k, n_k), (m_p, s_p, n_p) = results
  check(n_k == 3 * 7 and n_p == 0, (n_k, n_p))
  for k in m_p:
    check(abs(m_k[k] - m_p[k]) <= STEP_RTOL * max(1.0, abs(m_p[k])), (
        k, m_k[k], m_p[k]))
  stats_err = max(float((s_k[n] - s_p[n]).abs().max()) for n in s_p)
  check(stats_err <= STATS_ATOL, stats_err)
  log("step-parity", "f32 G 64x3 + D 64x4, b16, 1 outer step, K1 vs plain: "
      + ", ".join(f"{k} {m_k[k]:.6f}/{m_p[k]:.6f}" for k in m_p)
      + f"; wc_stats max|d| {stats_err:.2e}; K1 launches {n_k}/{n_p}")


def phase_slice(dev: torch.device):
  """The training slice at full width, bf16, as a user runs it."""
  gan = GANConfig(loss="hinge", training_ratio=5, generator_batch_multiple=2,
                  z_dim=128, random_flip=True)
  g_cfg = GeneratorConfig(filters=(256, 256, 256), dtype="bfloat16")
  d_cfg = DiscriminatorConfig(filters=(128, 128, 128, 128), dtype="bfloat16")
  state = create_state(g_cfg, d_cfg, OptimConfig(), 5, dev, seed=0)
  step = make_outer_step(gan)
  real = torch.randint(0, 256, (5, 64, 32, 32, 3), dtype=torch.uint8,
                       generator=torch.Generator(device=dev).manual_seed(4),
                       device=dev)
  labels = torch.zeros((5, 64), dtype=torch.int32, device=dev)
  for _ in range(2):                                   # warm-up
    step(state, real, labels)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  cuda_wc.MOMENTS_LAUNCHES = 0
  t0 = time.perf_counter()
  metrics = [step(state, real, labels) for _ in range(10)]
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  launches = cuda_wc.MOMENTS_LAUNCHES
  values = {k: [float(m[k]) for m in metrics] for k in metrics[0]}
  finite = all(torch.isfinite(torch.tensor(v)).all() for v in values.values())
  check(finite, values)
  check(launches == 42 * 10, launches)
  imgs = 10 * 5 * 64 / dt
  log("slice", f"G 256x3 + D 128x4 bf16, b64 x5 D + b128 G, 10 outer steps "
      f"in {dt:.3f} s = {imgs:.1f} imgs/s on {nvidia_smi()}; K1 launches "
      f"{launches} (42/step); peak memory "
      f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; last "
      + ", ".join(f"{k} {v[-1]:.4f}" for k, v in values.items()))
  return launches, state, gan


def _traced_kernels(fn):
  """``fn()`` under torch.profiler: (its kernels, its wall ms). The tracer
  may miss the first launches of a session (a few kernels, more in later
  sessions of a process): throwaway launches take them, and only the
  kernels that start inside ``fn``'s range count."""
  from torch.profiler import ProfilerActivity, profile, record_function
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    warm = torch.zeros((1,), device="cuda")
    for _ in range(64):
      warm.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with record_function("chip_smoke_traced"):
      fn()
      torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
  (start,) = [e.time_range.start for e in prof.events()
              if e.name == "chip_smoke_traced"
              and e.device_type == torch.autograd.DeviceType.CPU]
  return [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)
          and not e.name.startswith("Optimizer.")
          and e.time_range.start >= start], wall


# The bench phase (slice 11): wcgan_tpu_torch.bench at reduced sizes.
BENCH_STEPS, BENCH_REPEATS = 10, 2
BENCH_FORWARDS = 10
BENCH_CFG1_STEPS = 5


def _positive(*values) -> bool:
  return all(np.isfinite(v) and v > 0 for v in values)


def phase_bench(dev: torch.device):
  """The bench's own functions on the card, cut short: the headline
  ``measure`` (bf16, batch 64, BENCH_REPEATS windows of BENCH_STEPS outer
  steps: K1 42 a step), ``--sampling``'s two arms in bf16 (BENCH_FORWARDS
  forwards a window at batch 256: K2 7 a forward with ``kernel_eval``, 0
  on the split path), the cfg1 shape row (BENCH_CFG1_STEPS steps a window:
  K1 8 a step), then the headline's FLOP count (on the plain moments: no
  K1). Every value finite and positive, ``mfu`` in (0, 1].
  Prints the record on one line; returns the K1 and K2 launches by path,
  each counted from 0 just before its run (``measure`` and
  ``bench_sampling`` reset the counts before their windows)."""
  t_phase = time.perf_counter()
  head = bench.build_bench("headline", device="cuda", seed=0)
  m = bench.measure(head, BENCH_STEPS, BENCH_REPEATS)
  head_k1 = cuda_wc.MOMENTS_LAUNCHES
  samp = bench.bench_sampling("bfloat16", forwards=BENCH_FORWARDS,
                              repeats=BENCH_REPEATS, device="cuda")
  cfg1 = bench.build_bench("cfg1", device="cuda", seed=0)
  c1 = bench.measure(cfg1, BENCH_CFG1_STEPS, BENCH_REPEATS)
  cfg1_k1 = cuda_wc.MOMENTS_LAUNCHES
  del cfg1
  cuda_wc.MOMENTS_LAUNCHES = 0
  flops = bench.count_flops(head)
  check(cuda_wc.MOMENTS_LAUNCHES == 0, ("FLOP count launched K1",
                                        cuda_wc.MOMENTS_LAUNCHES))
  del head
  eff = bench.mfu(flops, m["median"], 5 * 64, "bfloat16", dev)
  record = {"bench": {"headline": m, **eff, "sampling": samp,
                      "cfg1": c1}}
  print(json.dumps(record), flush=True)
  arms = (samp["k2_kernel"], samp["split"], samp["k2_kernel_eager"],
          samp["split_eager"])
  check(_positive(m["median"], m["min"], m["max"], c1["median"], c1["min"],
                  flops,
                  *(a[k] for a in arms for k in ("median", "min", "max"))),
        record)
  check(m["k1_launches_per_step"] == 42 and c1["k1_launches_per_step"] == 8,
        (m["k1_launches_per_step"], c1["k1_launches_per_step"]))
  check(arms[0]["k2_launches_per_forward"] == 7
        and arms[1]["k2_launches_per_forward"] == 0
        and arms[2]["k2_launches_per_forward"] == 7
        and arms[3]["k2_launches_per_forward"] == 0, arms)
  check(0 < eff["mfu"] <= 1, eff["mfu"])
  windows = BENCH_FORWARDS * BENCH_REPEATS
  log("bench", f"on {nvidia_smi()}: headline {m['median']:.1f} imgs/s "
      f"({m['min']:.1f}-{m['max']:.1f}, {BENCH_REPEATS} windows of "
      f"{BENCH_STEPS} steps; K1 {m['k1_launches_per_step']:g} a step); "
      f"{flops / 1e12:.4f} TFLOP a step, MFU {eff['mfu']:.4%} of "
      f"{eff['peak']}; sampling bf16 captured K2 {arms[0]['median']:.1f} imgs/s, split "
      f"{arms[1]['median']:.1f}, eager K2 {arms[2]['median']:.1f}, split "
      f"{arms[3]['median']:.1f}; cfg1 {c1['median']:.1f} imgs/s; phase "
      f"{time.perf_counter() - t_phase:.1f} s")
  k1 = {f"bench: headline measure, {BENCH_STEPS * BENCH_REPEATS} outer "
        f"steps": head_k1,
        f"bench: cfg1 measure, {BENCH_CFG1_STEPS * BENCH_REPEATS} outer "
        f"steps": cfg1_k1}
  k2 = {f"bench: sampling, captured K2 arm, {windows} forwards":
            int(arms[0]["k2_launches_per_forward"] * windows),
        f"bench: sampling, eager K2 arm, {windows} forwards":
            int(arms[2]["k2_launches_per_forward"] * windows)}
  return k1, k2


# --- slice 12: the compiled step -------------------------------------------

GRAPH_CHAIN = 8                # the CLI's default --steps_per_call
GRAPH_RTOL = 1e-4              # captured chain against eager, float32,
                               # relative to each tensor's largest value
GRAPH_TIME_STEPS, GRAPH_TIME_ROUNDS = 5, 3
GRAPH_CKPT_ARGS = ["--device", "cuda", "--dataset", "synthetic", "--arch",
                   "res", "--batches_per_epoch", "8", "--generator_ema",
                   "0.999", "--display_ratio", "0", "--name", "graph"]


def _graph_tensors(st) -> dict:
  """Every tensor of a train state by name: G's and D's parameters and
  buffers, both Adams' slots and counts, the EMA shadow."""
  out = {}
  for m in ("g", "d"):
    module, opt = getattr(st, m), getattr(st, f"{m}_opt")
    out.update({f"{m}.{n}": t for n, t in module.state_dict().items()})
    for n, p in module.named_parameters():
      for k, v in opt.state.get(p, {}).items():
        out[f"{m}_opt.{n}.{k}"] = v
  out.update({f"g_ema.{n}": t for n, t in (st.g_ema or {}).items()})
  return out


def _graph_copy_state(dst, src) -> None:
  """``src``'s values into ``dst``'s tensors, Adam's slots as copies (a
  live state dict holds the live slots, which ``load_adam`` would
  share)."""
  dst.g.load_state_dict(src.g.state_dict())
  dst.d.load_state_dict(src.d.state_dict())
  for opt, sched in (("g_opt", "g_sched"), ("d_opt", "d_sched")):
    schedules.load_adam(getattr(dst, opt),
                        copy.deepcopy(getattr(src, opt).state_dict()))
    getattr(dst, sched).load_state_dict(getattr(src, sched).state_dict())
  with torch.no_grad():
    for n, t in dst.g_ema.items():
      t.copy_(src.g_ema[n])
  dst.generator.set_state(src.generator.get_state())
  dst.step, dst.g_version = src.step, src.g_version


def _graph_parity(dev, dtype: str):
  """The headline from one seed: (A) a chain of GRAPH_CHAIN dataset steps
  captured (after its warm-up chain and its first replay, A's state is
  copied into B and C), (B) the eager chain from the same state and
  generator, (C) a second eager chain, B's noise floor. Returns the worst
  relative differences A-B and C-B over every tensor and metric, the
  generators' agreement and the K1 launches of two more replays."""
  g_cfg, d_cfg, spec = bench.build_models("headline", dtype=dtype)
  gan = GANConfig(loss=spec["loss"], training_ratio=spec["ratio"],
                  generator_batch_multiple=2, random_flip=True,
                  g_ema_decay=0.999)
  data_x = torch.randint(0, 256, (1024, 32, 32, 3), dtype=torch.uint8,
                         generator=torch.Generator(device=dev).manual_seed(5),
                         device=dev)
  data_y = torch.zeros((1024,), dtype=torch.int32, device=dev)
  arms = [create_state(g_cfg, d_cfg, OptimConfig(), spec["ratio"], dev,
                       seed=0, g_ema_decay=0.999) for _ in range(3)]
  jit = step_lib.make_jit_dataset_step(gan, 64, GRAPH_CHAIN)
  eager = step_lib._multi(step_lib.make_dataset_step(gan, 64), GRAPH_CHAIN)
  with _deterministic():
    jit(arms[0], data_x, data_y)                      # warm-up chain
    jit(arms[0], data_x, data_y)                      # capture, replay
    check(jit.calls["capture"] == 1, jit.calls)
    for other in arms[1:]:
      _graph_copy_state(other, arms[0])
    metrics = [jit(arms[0], data_x, data_y)] + [
        eager(st, data_x, data_y) for st in arms[1:]]
    torch.cuda.synchronize()
  check(jit.last == "replay" and arms[0].step == 3 * GRAPH_CHAIN,
        (jit.last, arms[0].step))
  tensors = [{**_graph_tensors(st), **{f"metric.{k}": v
                                        for k, v in m.items()}}
             for st, m in zip(arms, metrics)]
  ab, ab_at = dryrun.worst_rel(tensors[0], tensors[1])
  cb, cb_at = dryrun.worst_rel(tensors[2], tensors[1])
  gens = [st.generator.get_state() for st in arms]
  same_gen = torch.equal(gens[0], gens[1]) and torch.equal(gens[2], gens[1])
  cuda_wc.MOMENTS_LAUNCHES = 0
  for _ in range(2):
    jit(arms[0], data_x, data_y)
  torch.cuda.synchronize()
  k1 = cuda_wc.MOMENTS_LAUNCHES
  values = {k: float(v) for k, v in metrics[0].items()}
  check(all(np.isfinite(v) for v in values.values()), values)
  return ab, ab_at, cb, cb_at, same_gen, k1, len(tensors[1]), values


def _graph_trainer(out_dir: str, *extra):
  args = cli_run.build_parser().parse_args(
      GRAPH_CKPT_ARGS + ["--output_dir", out_dir, "--checkpoints_dir",
                         os.path.join(out_dir, "ckpt"), *extra])
  return cli_run.build_experiment(args)


def _graph_checkpoint(dev):
  """The CLI's trainer (full width, float32, chains of GRAPH_CHAIN, EMA):
  T1 runs 4 chains (a warm-up, a capture, 2 replays) and saves after the
  second; T2 restores it into a fresh trainer and runs 2 (a warm-up and a
  capture). T2 against T1 after chain 3 and after chain 4."""
  out_dir = os.path.join("build", "chip_smoke_graph")
  shutil.rmtree(out_dir, ignore_errors=True)
  t1 = _graph_trainer(out_dir)
  check(isinstance(t1.step_fn, step_lib.JitStep), type(t1.step_fn))
  errs = []
  with _deterministic():
    for _ in range(2):
      t1.step_fn(t1.state, *t1._device_data)
    t1.save_checkpoint(1)
    t2 = _graph_trainer(out_dir)
    t2.restore_checkpoint(t1.checkpoint_path(1))
    for _ in range(2):
      m1 = t1.step_fn(t1.state, *t1._device_data)
      m2 = t2.step_fn(t2.state, *t2._device_data)
      torch.cuda.synchronize()
      errs.append(dryrun.worst_rel(
          {**_graph_tensors(t2.state), **{f"metric.{k}": v
                                          for k, v in m2.items()}},
          {**_graph_tensors(t1.state), **{f"metric.{k}": v
                                          for k, v in m1.items()}}))
  check(t1.step_fn.calls == {"warm-up": 1, "capture": 1, "replay": 2,
                             "eager": 0}
        and t2.step_fn.calls == {"warm-up": 1, "capture": 1, "replay": 0,
                                 "eager": 0},
        (t1.step_fn.calls, t2.step_fn.calls))
  check(torch.equal(t1.state.generator.get_state(),
                    t2.state.generator.get_state()) and
        t1.state.step == t2.state.step == 4 * GRAPH_CHAIN,
        (t1.state.step, t2.state.step))
  return errs


def _graph_timing(dev):
  """The headline (bf16, batch 64) compiled and eager on one state,
  GRAPH_TIME_ROUNDS windows of GRAPH_TIME_STEPS steps each in turns:
  imgs/s on the host clock and the device's span a step between CUDA
  events (for the eager arm that span holds the card's idle gaps)."""
  head = bench.build_bench("headline", device="cuda", seed=0)
  step_fn, state, (real, labels), _ = head
  arms = {"captured": step_fn, "eager": step_fn.eager}
  for fn in (step_fn, step_fn, step_fn.eager):
    fn(state, real, labels)
  rates = {k: [] for k in arms}
  spans = {k: [] for k in arms}
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  for r in range(GRAPH_TIME_ROUNDS):
    for name in (list(arms) if r % 2 == 0 else list(arms)[::-1]):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      start.record()
      for _ in range(GRAPH_TIME_STEPS):
        arms[name](state, real, labels)
      end.record()
      torch.cuda.synchronize()
      rates[name].append(GRAPH_TIME_STEPS * 5 * 64
                         / (time.perf_counter() - t0))
      spans[name].append(start.elapsed_time(end) / GRAPH_TIME_STEPS)
  return {k: (float(np.median(rates[k])), min(rates[k]), max(rates[k]),
              float(np.median(spans[k]))) for k in arms}


def _graph_k2(dev):
  """One captured headline step (bf16) with d_fake_stats 'running' and
  kernel_eval: K2 on G's 7 WC layers in each of the 5 D-phase forwards
  (35) and K1 in the G update (7), counted over one replay; or the error
  of the capture, which must name K2."""
  g_cfg, d_cfg, spec = bench.build_models("headline")
  g_cfg = dataclasses.replace(g_cfg, kernel_eval=True)
  gan = GANConfig(loss=spec["loss"], training_ratio=spec["ratio"],
                  generator_batch_multiple=2, random_flip=True,
                  d_fake_stats="running")
  state = create_state(g_cfg, d_cfg, OptimConfig(), spec["ratio"], dev,
                       seed=0)
  real = torch.randint(0, 256, (5, 64, 32, 32, 3), dtype=torch.uint8,
                       generator=torch.Generator(device=dev).manual_seed(6),
                       device=dev)
  step = step_lib.make_jit_step(gan)
  try:
    for _ in range(2):
      step(state, real, None)
  except RuntimeError as err:
    check("whiten_color_apply" in str(err), f"K2 capture error: {err}")
    return None, str(err)
  cuda_wc.MOMENTS_LAUNCHES = cuda_wc.WC_APPLY_LAUNCHES = 0
  metrics = step(state, real, None)
  torch.cuda.synchronize()
  counts = (cuda_wc.MOMENTS_LAUNCHES, cuda_wc.WC_APPLY_LAUNCHES)
  check(step.last == "replay" and counts == (7, 35), (step.last, counts))
  check(all(np.isfinite(float(v)) for v in metrics.values()), metrics)
  return counts, None


def phase_graph(dev: torch.device):
  """Slice 12, the compiled step (``make_jit_step``,
  ``make_jit_dataset_step``: CUDA graphs): the captured chain against the
  eager one in float32 (gated at GRAPH_RTOL, the eager-vs-eager floor
  beside it) and in bf16, the generators' states after it, K1 42 a step
  across replays; a checkpoint taken after a captured chain and restored
  into a fresh trainer against the uninterrupted run; the headline's
  imgs/s and device span a step, captured and eager in turns; K2 in a
  captured step. Returns the K1 and K2 launches by path."""
  t_phase = time.perf_counter()
  paths_k1, paths_k2 = {}, {}
  for dtype in ("float32", "bfloat16"):
    ab, ab_at, cb, cb_at, same_gen, k1, n, values = _graph_parity(dev, dtype)
    torch.cuda.empty_cache()
    check(same_gen, f"generator states differ after the chain ({dtype})")
    check(k1 == 42 * 2 * GRAPH_CHAIN, (dtype, k1))
    if dtype == "float32":
      check(ab <= GRAPH_RTOL, (ab, ab_at, cb, cb_at))
    paths_k1[f"graph: {dtype} headline, 2 replays of a chain of "
             f"{GRAPH_CHAIN}"] = k1
    log("graph", f"{dtype} headline, a chain of {GRAPH_CHAIN} dataset steps "
        f"(EMA 0.999, deterministic kernels) from one state and generator: "
        f"captured vs eager max rel diff {ab:.3e} ({ab_at}), eager vs eager "
        f"{cb:.3e} ({cb_at}) over {n} tensors and the metrics; generator "
        f"states equal after the chain: {same_gen}; K1 {k1} in 2 replays "
        f"({k1 // (2 * GRAPH_CHAIN)} a step); last "
        + ", ".join(f"{k} {v:.4f}" for k, v in values.items()))
  errs = _graph_checkpoint(dev)
  torch.cuda.empty_cache()
  for chain, (err, at) in zip((3, 4), errs):
    check(err <= GRAPH_RTOL, (chain, err, at))
  log("graph", f"checkpoint after 2 chains (warm-up, capture) of the CLI's "
      f"float32 trainer, restored into a fresh trainer: after chain 3 "
      f"(restored: warm-up; live: replay) max rel diff {errs[0][0]:.3e} "
      f"({errs[0][1]}), after chain 4 (restored: capture; live: replay) "
      f"{errs[1][0]:.3e} ({errs[1][1]}); generators and steps equal")
  times = _graph_timing(dev)
  torch.cuda.empty_cache()
  check(_positive(*(v for t in times.values() for v in t)), times)
  cap, eag = times["captured"], times["eager"]
  log("graph", f"headline bf16 b64 on {nvidia_smi()}, {GRAPH_TIME_ROUNDS} "
      f"windows of {GRAPH_TIME_STEPS} steps each in turns: captured "
      f"{cap[0]:.1f} imgs/s ({cap[1]:.1f}-{cap[2]:.1f}), device span "
      f"{cap[3]:.3f} ms a step; eager {eag[0]:.1f} imgs/s ({eag[1]:.1f}-"
      f"{eag[2]:.1f}), device span {eag[3]:.3f} ms a step (its idle gaps "
      f"included); {cap[0] / eag[0]:.2f}x")
  counts, err = _graph_k2(dev)
  torch.cuda.empty_cache()
  if counts is None:
    log("graph", f"K2 under capture: refused, by name: {err}")
  else:
    paths_k1["graph: one captured d_fake_stats running step"] = counts[0]
    paths_k2["graph: one captured d_fake_stats running + kernel_eval step"] \
        = counts[1]
    log("graph", f"K2 captured: one replay of a d_fake_stats='running' + "
        f"kernel_eval step launched K1 {counts[0]}, K2 {counts[1]} (the "
        f"cooperative setup inside the graph)")
  log("graph", f"phase {time.perf_counter() - t_phase:.1f} s")
  return paths_k1, paths_k2


# --- slice 13: the compiled sampling programs and the NCCL step ---------------

SG_OUT = os.path.join("build", "chip_smoke_sample_graph")
SG_N = 1024                     # generate(SG_N, batch=256)
SG_FORWARDS, SG_ROUNDS = 20, 3  # timed batch-256 forwards a window, windows


def _sg_trainer(dev, dtype: str, kernel_eval: bool) -> Trainer:
  """The headline (G 256x3, D 128x4) with EMA 0.999 and 16 batches of
  standing statistics, in a trainer on synthetic CIFAR-10-shaped data on
  the card: epochs of 3 chains of 2 steps (a warm-up, a capture, a
  replay)."""
  g_cfg, d_cfg, spec = bench.build_models("headline", dtype=dtype)
  g_cfg = dataclasses.replace(g_cfg, kernel_eval=kernel_eval)
  gan = GANConfig(loss=spec["loss"], training_ratio=spec["ratio"],
                  generator_batch_multiple=2, random_flip=True,
                  g_ema_decay=0.999)
  state = create_state(g_cfg, d_cfg, OptimConfig(), spec["ratio"], dev,
                       seed=0, g_ema_decay=0.999)
  ds = get_dataset("synthetic", batch_size=64, seed=0, z_dim=g_cfg.z_dim,
                   synthetic_size=1024)
  out_dir = os.path.join(SG_OUT, f"{dtype}_{'k2' if kernel_eval else 'split'}")
  shutil.rmtree(out_dir, ignore_errors=True)
  return Trainer(ds, state, gan, TrainerConfig(
      name="sg", output_dir=out_dir,
      checkpoints_dir=os.path.join(out_dir, "ckpt"), number_of_epochs=1,
      batches_per_epoch=6, steps_per_call=2, display_ratio=0,
      checkpoint_ratio=0))


def _sg_eager_generate(trainer: Trainer, n: int, batch: int = 256,
                       rng_seed: int = 1234) -> np.ndarray:
  """``Trainer.generate`` through the eager forward: the same draws."""
  rng = np.random.default_rng(rng_seed)
  out = []
  for i in range(0, n, batch):
    b = min(batch, n - i)
    out.append(trainer.sample_eager(*trainer._draw(rng, batch), u8=True)
               [:b].cpu().numpy())
  return np.concatenate(out)


def _sg_eager_standing(trainer: Trainer, n: int, rng_seed: int = 4321):
  """The standing statistics from eager train-mode forwards: the draws,
  sums and scaling of ``Trainer.standing_g_state``."""
  g = trainer.state.g
  rng = np.random.default_rng(rng_seed)
  acc = {}
  with torch.no_grad(), L.capture_batch_moments(g) as moments:
    for _ in range(n):
      functional_call(g, trainer.state.g_ema,
                      trainer._draw(rng, trainer.ds.batch_size),
                      {"train": True, "update_stats": False})
      acc = {k: acc[k] + v if k in acc else v for k, v in moments.items()}
  return {k: v * (1.0 / n) for k, v in acc.items()}


def _sg_programs(trainer: Trainer, kind: str) -> dict:
  """The calls of ``kind``'s programs by kind of call, summed."""
  out = dict.fromkeys(("warm-up", "capture", "replay", "eager"), 0)
  for (k, _), p in trainer._programs.items():
    if k == kind:
      for c, v in p.calls.items():
        out[c] += v
  return out


def _sg_compare(trainer: Trainer, z64, z256):
  """Every sampling surface captured against its eager forward on the
  same tensors: ``sample`` on 64 z, ``sample_u8`` on 256 (three calls
  each: after a binding change a warm-up, a capture, a replay) and
  ``generate(SG_N, batch=256)``. Returns (all bit-equal, the largest
  difference of the float images)."""
  equal, worst = True, 0.0
  for _ in range(3):
    a, b = trainer.sample(z64), trainer.sample_eager(z64)
    equal &= torch.equal(a, b)
    worst = max(worst, float((a.float() - b.float()).abs().max()))
    equal &= torch.equal(trainer.sample_u8(z256),
                         trainer.sample_eager(z256, u8=True))
  equal &= np.array_equal(trainer.generate(SG_N, batch=256),
                          _sg_eager_generate(trainer, SG_N))
  return equal, worst


def _sg_events(trainer: Trainer, z64, z256) -> dict:
  """``_sg_compare`` on a fresh trainer, after a trainer epoch (3 chains:
  replayed G updates; the sampling graphs replay on, their standing
  statistics recomputed into place), after a restore (a chain between
  the save and the restore) and after a ladder rung (ns_iters x2): each
  event's (bit-equal, largest float difference, the sampling programs'
  warm-ups so far)."""
  out = {}

  def record(event):
    torch.cuda.synchronize()
    out[event] = _sg_compare(trainer, z64, z256) + (
        _sg_programs(trainer, "sample_u8")["warm-up"],)

  record("fresh")
  trainer.train()
  check(trainer.step_fn.calls["replay"] == 1, trainer.step_fn.calls)
  record("epoch")
  trainer.save_checkpoint(0)
  trainer.step_fn(trainer.state, *trainer._device_data)
  trainer.restore_checkpoint(trainer.checkpoint_path(0))
  record("restore")
  check(trainer._apply_whitening_fallback(1), "no ladder rung left")
  record("rung")
  check(out["epoch"][2] == out["fresh"][2]
        and out["restore"][2] == out["epoch"][2] + 1
        and out["rung"][2] == out["restore"][2] + 1,
        ("sampling warm-ups by event", out))
  return out


def _sg_rates(trainer: Trainer, z256) -> dict:
  """Batch-256 ``sample_u8`` forwards, captured and eager on the same G,
  SG_ROUNDS windows of SG_FORWARDS each in turns: imgs/s (host clock,
  fenced) median, min, max, and the device span a forward between CUDA
  events (for the eager arm it holds the card's idle gaps)."""
  arms = {"captured": lambda: trainer.sample_u8(z256),
          "eager": lambda: trainer.sample_eager(z256, u8=True)}
  for _ in range(3):        # a warm-up and a capture under these settings
    for fn in arms.values():
      fn()
  rates = {k: [] for k in arms}
  spans = {k: [] for k in arms}
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  for r in range(SG_ROUNDS):
    for name in (list(arms) if r % 2 == 0 else list(arms)[::-1]):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      start.record()
      for _ in range(SG_FORWARDS):
        arms[name]()
      end.record()
      torch.cuda.synchronize()
      rates[name].append(SG_FORWARDS * 256 / (time.perf_counter() - t0))
      spans[name].append(start.elapsed_time(end) / SG_FORWARDS)
  return {k: (float(np.median(rates[k])), min(rates[k]), max(rates[k]),
              float(np.median(spans[k]))) for k in arms}


def phase_sample_graph(dev: torch.device):
  """Slice 13, the compiled sampling programs: ``sample``, ``sample_u8``
  and ``generate`` as CUDA graphs on the headline G (256x3, EMA 0.999, 16
  batches of standing statistics), with ``kernel_eval=True`` (K2) and on
  the split path, in float32 and bf16: captured against the eager forward
  on the same tensors, bit-equal (deterministic kernels), fresh and after
  a trainer epoch, a restore and a ladder rung; the captured standing
  pass against the eager one, bit-equal, and K1 7 and K2 7 a replay;
  captured and eager imgs/s in turns (bf16). Returns the K1 and K2
  launches by path."""
  t_phase = time.perf_counter()
  gen = torch.Generator(device=dev).manual_seed(13)
  z64 = torch.randn((64, 128), device=dev, generator=gen)
  z256 = torch.randn((256, 128), device=dev, generator=gen)
  paths_k1, paths_k2, rates = {}, {}, {}
  for dtype in ("float32", "bfloat16"):
    for kernel_eval in (True, False):
      arm = f"{dtype} {'K2' if kernel_eval else 'split'}"
      trainer = _sg_trainer(dev, dtype, kernel_eval)
      with _deterministic():
        events = _sg_events(trainer, z64, z256)
        standing = _sg_eager_standing(trainer, 16)
        trainer._standing_cache = None
        torch.cuda.synchronize()
        cuda_wc.MOMENTS_LAUNCHES = cuda_wc.WC_APPLY_LAUNCHES = 0
        replays = _sg_programs(trainer, "standing_pass")["replay"]
        tensors = trainer.sampling_state()
        torch.cuda.synchronize()
        k1_standing = cuda_wc.MOMENTS_LAUNCHES
        replays = _sg_programs(trainer, "standing_pass")["replay"] - replays
        cuda_wc.WC_APPLY_LAUNCHES = 0
        imgs = trainer.generate(SG_N, batch=256)
        torch.cuda.synchronize()
        k2_generate = cuda_wc.WC_APPLY_LAUNCHES
      check(all(e[0] for e in events.values()), (arm, events))
      check(all(torch.equal(tensors[k], v) for k, v in standing.items()),
            (arm, "standing statistics captured vs eager"))
      check(replays == 16 and k1_standing == 7 * 16, (arm, replays,
                                                       k1_standing))
      check(k2_generate == (7 * SG_N // 256 if kernel_eval else 0)
            and imgs.shape == (SG_N, 32, 32, 3), (arm, k2_generate))
      paths_k1[f"sample-graph: {arm}, a captured standing recompute "
               "(16 replays)"] = k1_standing
      if kernel_eval:
        paths_k2[f"sample-graph: {arm}, captured generate({SG_N}, "
                 "batch=256)"] = k2_generate
      if dtype == "bfloat16":
        rates[arm] = _sg_rates(trainer, z256)
      log("sample-graph", f"{arm}: sample (64), sample_u8 (256) and "
          f"generate({SG_N}) captured vs eager, deterministic kernels: "
          + "; ".join(f"{e} bit-equal {v[0]} (max|d| {v[1]:.1e}, sampling "
                      f"warm-ups {v[2]})" for e, v in events.items())
          + f"; standing pass captured vs eager bit-equal over "
          f"{len(standing)} tensors, {replays} replays, K1 {k1_standing} "
          f"({k1_standing // 16} a replay); generate K2 {k2_generate}")
      del trainer
      torch.cuda.empty_cache()
  for arm, t in rates.items():
    cap, eag = t["captured"], t["eager"]
    log("sample-graph", f"{arm} batch-256 sample_u8 forwards on "
        f"{nvidia_smi()}, {SG_ROUNDS} windows of {SG_FORWARDS} in turns: "
        f"captured {cap[0]:.1f} imgs/s ({cap[1]:.1f}-{cap[2]:.1f}), "
        f"device span {cap[3]:.3f} ms a forward; eager {eag[0]:.1f} imgs/s "
        f"({eag[1]:.1f}-{eag[2]:.1f}), device span {eag[3]:.3f} ms a "
        f"forward (its idle gaps included); {cap[0] / eag[0]:.2f}x")
  check(_positive(*(v for t in rates.values() for r in t.values()
                    for v in r)), rates)
  log("sample-graph", f"phase {time.perf_counter() - t_phase:.1f} s")
  return paths_k1, paths_k2


# The NCCL checks: config 5's models at its per-rank batch, a chain of
# NCCL_SPC dataset steps, NCCL_CALLS calls (a warm-up, a capture, a replay).
NCCL_SPC, NCCL_CALLS = 3, 3
NCCL_TIME_ROUNDS, NCCL_TIME_CALLS = 3, 2


def _nccl_job(devices, dtype: str, time_rounds: int = 0):
  """``dryrun.jit_dp_rank`` on one rank a card of ``devices``: the
  compiled chain against the eager chain (deterministic kernels in
  float32), then, with ``time_rounds``, both timed in turns."""
  g, d, gan, _ = _dp_cfgs(dtype)
  calls = [("jit_dp_rank", (g, d, gan, len(devices) * DP_B, NCCL_SPC,
                            NCCL_CALLS, DP_SYNTHETIC, 0, time_rounds,
                            NCCL_TIME_CALLS))]
  if dtype == "float32":
    calls.insert(0, ("deterministic_rank", ()))
  t0 = time.perf_counter()
  ranks = launch.launch("wcgan_tpu_torch.parallel.dryrun:batch_rank",
                        devices, (calls,), timeout=900)
  return [r[-1] for r in ranks], time.perf_counter() - t0


def _nccl_check(ranks, what: str, float32: bool) -> None:
  """The compiled chain warmed up, captured and replayed at the same
  calls on every rank; each call's collectives and K1 launches the eager
  chain's; in float32 its state within GRAPH_RTOL of the eager chain's;
  both states replicated over the ranks."""
  for i, r in enumerate(ranks):
    check(r["jit_calls"]["warm-up"] == 1 and r["jit_calls"]["capture"] == 1
          and r["jit_calls"]["eager"] == 0, (what, i, r["jit_calls"]))
    check(r["same_generator"] and r["steps"][0] == r["steps"][1],
          (what, i, r["steps"]))
    for c in r["per_call"]:
      check(c["jit"]["calls"] == c["eager"]["calls"]
            and c["jit"]["bytes"] == c["eager"]["bytes"]
            and c["jit"]["k1"] == c["eager"]["k1"] > 0
            and all(np.isfinite(v) for v in c["jit"]["metrics"].values()),
            (what, i, c))
    if float32:
      check(r["rel"] <= GRAPH_RTOL, (what, i, r["rel"], r["where"]))
  for arm in (0, 1):
    check(len({r["digests"][arm] for r in ranks}) == 1,
          (what, "state not replicated", arm))


def _nccl_line(ranks, what: str, dt: float) -> str:
  r = ranks[0]
  c = r["per_call"][-1]
  return (f"{what}: the compiled chain of {NCCL_SPC} (calls "
          f"{r['jit_calls']}) vs the eager chain: max rel diff {r['rel']:.3e} "
          f"({r['where']}); a replay's collectives {c['jit']['calls']} "
          f"({sum(c['jit']['bytes'].values()) / 2**20:.2f} MiB), the eager "
          f"call's {c['eager']['calls']}; K1 {c['jit']['k1']} a call; "
          f"states replicated over {len(ranks)} rank(s); job {dt:.1f} s")


def phase_nccl(dev: torch.device, ranks_to_time: int = 0):
  """The compiled data-parallel chain over NCCL (config 5: cWC-sa G at
  64x64, 1,000 classes, projection-D; 64 images a rank), one rank a
  card: one rank in float32; with 2 or more cards, two ranks in float32;
  with ``ranks_to_time`` cards, that many ranks in float32 and then in
  bf16 timed, captured against eager in turns. Returns K1's launches by
  path."""
  del dev
  t_phase = time.perf_counter()
  paths = {}
  n = torch.cuda.device_count()
  sizes = [1, 2] + ([ranks_to_time] if ranks_to_time > 2 else [])
  for size in sizes:
    if size > n:
      log("nccl", f"{size} NCCL ranks did not run: this machine has {n} "
          f"card(s), and NCCL takes one card a rank")
      continue
    devices = [f"cuda:{i}" for i in range(size)]
    ranks, dt = _nccl_job(devices, "float32")
    _nccl_check(ranks, f"{size} rank(s) float32", True)
    paths[f"nccl: {size} rank(s), float32 config 5, {NCCL_CALLS} calls "
          f"of a chain of {NCCL_SPC} (rank 0, both arms)"] = sum(
              c[a]["k1"] for c in ranks[0]["per_call"] for a in c)
    log("nccl", _nccl_line(ranks, f"{size} NCCL rank(s), float32 config 5, "
                           f"{DP_B} images a rank", dt))
  if ranks_to_time and ranks_to_time <= n:
    devices = [f"cuda:{i}" for i in range(ranks_to_time)]
    ranks, dt = _nccl_job(devices, "bfloat16", NCCL_TIME_ROUNDS)
    _nccl_check(ranks, f"{ranks_to_time} ranks bf16", False)
    ms = ranks[0]["ms_per_step"]
    log("nccl", _nccl_line(ranks, f"{ranks_to_time} NCCL ranks, bf16 "
                           f"config 5, {DP_B} images a rank", dt))
    log("nccl", f"{ranks_to_time} NCCL ranks on {nvidia_smi()}, bf16 config "
        f"5 at {ranks_to_time * DP_B} images, {NCCL_TIME_ROUNDS} rounds of "
        f"{NCCL_TIME_CALLS} chains of {NCCL_SPC} in turns: captured "
        f"{ms['jit'][0]:.1f} ms a step ({ms['jit'][1]:.1f}-"
        f"{ms['jit'][2]:.1f}), eager {ms['eager'][0]:.1f} ms "
        f"({ms['eager'][1]:.1f}-{ms['eager'][2]:.1f}); "
        f"{ms['eager'][0] / ms['jit'][0]:.2f}x (rank 0's host clock)")
  log("nccl", f"phase {time.perf_counter() - t_phase:.1f} s")
  return paths


def _u8_diff(a: np.ndarray, b: np.ndarray):
  """(mean, 99.9th percentile, max) of |a - b| over uint8 images."""
  diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
  return float(diff.mean()), float(np.quantile(diff, 0.999)), int(diff.max())


def _generate(trainer: Trainer, n: int):
  """(uint8 images, seconds, peak MiB, K1 and K2 launches) of one
  ``generate(n, batch=256)`` with every count set to 0 just before."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  cuda_wc.MOMENTS_LAUNCHES = 0
  cuda_wc.WC_APPLY_LAUNCHES = 0
  t0 = time.perf_counter()
  imgs = trainer.generate(n, batch=256)
  dt = time.perf_counter() - t0
  return (imgs, dt, torch.cuda.max_memory_allocated() / 2**20,
          cuda_wc.MOMENTS_LAUNCHES, cuda_wc.WC_APPLY_LAUNCHES)


def _profile_k2_forward(trainer: Trainer) -> None:
  """One batch-256 generate forward with K2 under torch.profiler: every
  kernel by name and device time, K2's launches per call, its share of
  kernel time, and the device's busy share: kernel time over the span
  from the first kernel's start to the last one's end (the profiled wall
  time also holds the profiler's own start-up)."""
  from torch.profiler import ProfilerActivity, profile
  trainer.generate(256, batch=256)
  torch.cuda.synchronize()
  before = cuda_wc.WC_APPLY_LAUNCHES
  t0 = time.perf_counter()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    trainer.generate(256, batch=256)
    torch.cuda.synchronize()
  wall = (time.perf_counter() - t0) * 1e3
  calls = cuda_wc.WC_APPLY_LAUNCHES - before
  kernels = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  total = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
  span = (max(e.time_range.end for e in kernels)
          - min(e.time_range.start for e in kernels)) / 1e3
  by_name = {}
  for e in kernels:
    # "void (anonymous namespace)::rows_apply_bf16<128>(...)" ->
    # "rows_apply_bf16"
    name = re.split(r"[<(]", e.name.replace("(anonymous namespace)::", "")
                    )[0].split("::")[-1].replace("void ", "")[:48]
    n, ms = by_name.get(name, (0, 0.0))
    by_name[name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
  k2 = {k: v for k, v in by_name.items()
        if any(n in k for n in K2_KERNELS)}
  k2_launches = sum(n for n, _ in k2.values())
  k2_ms = sum(ms for _, ms in k2.values())
  check(calls == 7 and k2_launches <= 2 * calls and total > 0,
        (calls, k2))
  log("profile-k2", f"one generate(256, batch=256) forward with K2 under "
      f"torch.profiler on {nvidia_smi()}: {len(kernels)} kernels, "
      f"{total:.3f} ms of kernel time in a {span:.3f} ms device span (busy "
      f"{total / span:.2f}; profiled wall {wall:.1f} ms); K2 {k2_ms:.3f} ms "
      f"({k2_ms / total:.1%}) in "
      f"{k2_launches} kernels for {calls} calls "
      f"({k2_launches / calls:.0f} a call): " + ", ".join(
          f"{k} {n}x {ms:.3f} ms" for k, (n, ms) in sorted(
              k2.items())))
  log("profile-k2", "kernels by device time: " + "; ".join(
      f"{k} {n}x {ms:.3f} ms" for k, (n, ms) in sorted(
          by_name.items(), key=lambda kv: -kv[1][1])[:8]))


def phase_sampling(dev: torch.device, state, gan):
  """The sampling slice at full width: the trained G 256x3 (running
  statistics advanced by the slice's 12 G updates) through
  ``Trainer.generate(1024, batch=256)``, K2 forced on, then the split
  path. Returns (K2 launches, the exported generator npz)."""
  ds = get_dataset("synthetic", batch_size=64, seed=0, z_dim=gan.z_dim,
                   synthetic_size=256)
  out_dir = os.path.join("build", "chip_smoke_sampling")
  shutil.rmtree(out_dir, ignore_errors=True)
  cfg = TrainerConfig(name="smoke", output_dir=out_dir,
                      checkpoints_dir=os.path.join(out_dir, "ckpt"))
  split = Trainer(ds, state, gan, cfg)
  g_k = place(Generator(dataclasses.replace(state.g.cfg, kernel_eval=True),
                        torch.Generator().manual_seed(0)), dev)
  g_k.load_state_dict(state.g.state_dict())
  fused = Trainer(ds, dataclasses.replace(state, g=g_k), gan, cfg)
  cov = state.g.nc_out.cov
  check(float((cov - torch.eye(cov.shape[0], device=dev)).abs().max())
        > 1e-3, "running statistics still at their init")
  n = 1024
  for trainer in (fused, split):                     # warm-up
    trainer.generate(256, batch=256)
  runs = {}
  for name, trainer in (("K2", fused), ("split", split), ("K2 again", fused),
                        ("split again", split)):
    runs[name] = _generate(trainer, n)
  imgs_k, _, mem_k, k1_k, k2_k = runs["K2"]
  imgs_s, _, mem_s, k1_s, k2_s = runs["split"]
  forwards = n // 256
  check(k2_k == 7 * forwards and k1_k == 0, (k2_k, k1_k))
  check(k2_s == 0 and k1_s == 0, (k2_s, k1_s))
  check(imgs_k.dtype == np.uint8 and imgs_k.shape == (n, 32, 32, 3)
        and imgs_s.shape == imgs_k.shape, (imgs_k.dtype, imgs_k.shape))
  check(np.array_equal(imgs_k, runs["K2 again"][0]), "K2 not repeatable")
  mean, p999, top = _u8_diff(imgs_k, imgs_s)
  check(mean <= SAMPLE_MEAN_TOL and p999 <= SAMPLE_P999_TOL
        and top <= SAMPLE_MAX_TOL, (mean, p999, top))
  rate = {k: n / v[1] for k, v in runs.items()}
  log("sampling", f"G 256x3 bf16, generate({n}, batch=256) on "
      f"{nvidia_smi()}: K2 {rate['K2']:.1f} / {rate['K2 again']:.1f} imgs/s "
      f"({k2_k} K2 launches, 7/forward; peak {mem_k:.0f} MiB), split "
      f"{rate['split']:.1f} / {rate['split again']:.1f} imgs/s ({k2_s} K2 "
      f"launches; peak {mem_s:.0f} MiB); uint8 |K2 - split| mean "
      f"{mean:.4f}, p99.9 {p999:.0f}, max {top}")
  _profile_k2_forward(fused)
  path = split.save_sample_grid(0)
  check(os.path.getsize(path) > 0, path)
  split.export_weights(0)
  npz = os.path.join(cfg.checkpoints_dir, "smoke", "epoch_0_generator.npz")
  with np.load(npz) as data:
    arrays = len(data.files)
  check(arrays > 0, npz)
  log("sampling", f"save_sample_grid wrote {path}; export_weights wrote "
      f"{npz} ({arrays} arrays)")
  return k2_k, npz


# The CLI runs of the res slices: synthetic data, bf16.
RES_CLI = ("--dataset", "synthetic", "--arch", "res", "--bf16")


def _run_cli(args, out_dir: str, base=RES_CLI):
  cmd = [sys.executable, "-m", "wcgan_tpu_torch", "--device", "cuda", *base,
         "--output_dir", out_dir, "--name", "smoke", *args]
  t0 = time.perf_counter()
  proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
  if proc.returncode != 0:
    raise RuntimeError(f"CLI failed ({proc.returncode}):\n{proc.stdout}\n"
                       f"{proc.stderr}")
  with open(os.path.join(out_dir, "smoke", "log.txt")) as f:
    lines = [l.strip() for l in f]
  return cmd, time.perf_counter() - t0, lines


def _main_cli(args, out_dir: str, base=RES_CLI):
  """``_run_cli`` in this process, through ``cli_run.main``."""
  argv = ["--device", "cuda", *base, "--output_dir", out_dir, "--name",
          "smoke", *args]
  t0 = time.perf_counter()
  check(cli_run.main(argv) == 0, argv)
  with open(os.path.join(out_dir, "smoke", "log.txt")) as f:
    lines = [l.strip() for l in f]
  return argv, time.perf_counter() - t0, lines


def phase_cli(npz: str) -> None:
  out_dir = os.path.join("build", "chip_smoke_cli")
  shutil.rmtree(out_dir, ignore_errors=True)
  cmd, dt, lines = _run_cli(["--number_of_epochs", "2",
                             "--batches_per_epoch", "3", "--display_ratio",
                             "1"], out_dir)
  epochs = [l for l in lines if l.startswith("Epoch ")]
  grids = sorted(os.path.basename(p) for p in
                 glob.glob(os.path.join(out_dir, "smoke", "*.png")))
  check(len(epochs) == 2 and grids == ["epoch_00000.png",
                                       "epoch_00001.png"], (epochs, grids))
  log("cli", f"{' '.join(cmd[1:])}: rc 0 in {dt:.1f} s; {epochs[-1]}; "
      f"grids {grids}")
  test_dir = os.path.join("build", "chip_smoke_cli_test")
  shutil.rmtree(test_dir, ignore_errors=True)
  cmd, dt, lines = _run_cli(["--phase", "test", "--generator_checkpoint",
                             npz, "--start_epoch", "3"], test_dir)
  grid = os.path.join(test_dir, "smoke", "epoch_00003.png")
  check(os.path.isfile(grid) and any("wrote sample grid" in l
                                     for l in lines), lines)
  log("cli", f"{' '.join(cmd[1:])}: rc 0 in {dt:.1f} s; wrote {grid}")


# The run phase: the CLI's defaults (device data, chains of 8) with EMA
# weights, a checkpoint each epoch, 8 outer steps an epoch.
RUN_ARGS = ("--generator_ema", "0.999", "--checkpoint_ratio", "1",
            "--batches_per_epoch", "8")
DIAG_KEYS = ("wc_cov_cond_max", "wc_whiten_residual_max", "d_sigma_max")


def _bit_equal(a, b, where="state") -> None:
  """Nested dicts and lists of tensors and numbers, equal bit for bit."""
  bad = dryrun.replication_errors(a, b, where)
  check(not bad, ("not bit-equal", bad[:5]))


def _count(tensors) -> int:
  if isinstance(tensors, dict):
    return sum(_count(v) for v in tensors.values())
  if isinstance(tensors, (list, tuple)):
    return sum(_count(v) for v in tensors)
  return int(torch.is_tensor(tensors))


def _ms(fn, *args):
  """(result, host ms) of fn(*args), synchronised on both sides."""
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  out = fn(*args)
  torch.cuda.synchronize()
  return out, (time.perf_counter() - t0) * 1e3


def phase_run(dev: torch.device):
  """The CLI's default run at full width, then ``--resume auto``; the
  checkpoint restored into fresh trainers. Returns the launches of K1 (one
  outer step from a saved and from its restored state; one standing
  recompute) and K2 (EMA generate)."""
  out_dir = os.path.join("build", "chip_smoke_run")
  shutil.rmtree(out_dir, ignore_errors=True)
  base = [*RUN_ARGS, "--checkpoints_dir", os.path.join(out_dir, "ckpt")]
  cmd, dt1, _ = _run_cli(base + ["--number_of_epochs", "2"], out_dir)
  log("run", f"{' '.join(cmd[1:])}: rc 0 in {dt1:.1f} s")
  cmd, dt2, lines = _run_cli(base + ["--number_of_epochs", "3", "--resume",
                                     "auto"], out_dir)
  log("run", f"{' '.join(cmd[1:])}: rc 0 in {dt2:.1f} s; "
      + "; ".join(l for l in lines if l.startswith("resumed from")))
  counts = [sum(l.startswith(f"Epoch {i}:") for l in lines) for i in range(3)]
  check(any("(start_epoch 2)" in l for l in lines) and counts == [1, 1, 1],
        (counts, lines))
  ckpt = os.path.join(out_dir, "ckpt", "smoke")
  for i in range(3):
    for name in (os.path.join(f"epoch_{i}", CKPT_FILE),
                 f"epoch_{i}_generator.npz", f"epoch_{i}_discriminator.npz"):
      check(os.path.isfile(os.path.join(ckpt, name)), name)
  with open(os.path.join(out_dir, "smoke", "metrics.jsonl")) as f:
    records = [json.loads(l) for l in f]
  check([r["epoch"] for r in records] == [0, 1, 2], records)
  for r in records:
    check(all(np.isfinite(r[k]) for k in DIAG_KEYS), r)
    log("run", f"epoch {r['epoch']}: {r['seconds']:.3f} s, "
        f"{r['imgs_per_sec']:.1f} imgs/s (8 outer steps of 5 x 64 real "
        f"images, host clock) on {nvidia_smi()}; " + ", ".join(
            f"{k} {r[k]:.4g}" for k in DIAG_KEYS + ("d_loss", "g_loss")))

  args = cli_run.build_parser().parse_args(
      ["--device", "cuda", "--dataset", "synthetic", "--arch", "res",
       "--bf16", "--output_dir", os.path.join(out_dir, "inproc"), "--name",
       "smoke", *base])
  saved_path = os.path.join(ckpt, "epoch_2")
  a = cli_run.build_experiment(args)
  check(a.latest_checkpoint() == os.path.abspath(saved_path),
        a.latest_checkpoint())
  _, restore_ms = _ms(a.restore_checkpoint, saved_path)
  saved = torch.load(os.path.join(saved_path, CKPT_FILE), map_location=dev,
                     weights_only=True)
  check(saved["g"]["nc_out.cov"].device == dev, "map_location")
  _bit_equal(a.full_state(), saved)
  n_tensors = _count(saved)
  # A live state (a chain past the file), saved and restored in-process.
  a.step_fn(a.state, *a._device_data)
  _, save_ms = _ms(a.save_checkpoint, 3)
  b = cli_run.build_experiment(args)
  _, restore2_ms = _ms(b.restore_checkpoint, a.checkpoint_path(3))
  _bit_equal(b.full_state(), a.full_state())
  log("run", f"restored {saved_path} into a fresh trainer: {n_tensors} "
      f"tensors bit-equal to the file; save_checkpoint {save_ms:.1f} ms, "
      f"restore_checkpoint {restore_ms:.1f} / {restore2_ms:.1f} ms (host "
      f"clock, synchronised; on {nvidia_smi()}); a live state saved and "
      "restored bit-equal")

  gen = torch.Generator(device=dev).manual_seed(7)
  noise = {"z_d": torch.randn((5, 64, 128), generator=gen, device=dev),
           "z_g": torch.randn((128, 128), generator=gen, device=dev),
           "flip": torch.rand((5, 64), generator=gen, device=dev) < 0.5}
  real = a._device_data[0][:5 * 64].view(5, 64, 32, 32, 3)
  step = make_outer_step(a.gan_cfg)
  cuda_wc.MOMENTS_LAUNCHES = 0
  m_a = {k: float(v) for k, v in step(a.state, real, None, noise).items()}
  m_b = {k: float(v) for k, v in step(b.state, real, None, noise).items()}
  step_launches = cuda_wc.MOMENTS_LAUNCHES
  check(step_launches == 2 * 42, step_launches)
  for k in m_a:
    check(abs(m_a[k] - m_b[k]) <= STEP_RTOL * max(1.0, abs(m_a[k])),
          (k, m_a[k], m_b[k]))
  bufs_b = dict(b.state.g.named_buffers())
  stats_err = max(float((t - bufs_b[n]).abs().max())
                  for n, t in a.state.g.named_buffers())
  check(stats_err <= STATS_ATOL, stats_err)
  log("run", "one outer step with the same noise from the saved and from "
      "the restored state: " + ", ".join(
          f"{k} {m_a[k]:.6f}/{m_b[k]:.6f}" for k in m_a)
      + f"; wc_stats max|d| {stats_err:.2e}; K1 launches {step_launches}")

  diag, diag_ms = _ms(b.diagnostics)
  check(all(np.isfinite(diag[k]) for k in DIAG_KEYS), diag)
  cuda_wc.MOMENTS_LAUNCHES = 0
  first, standing_ms = _ms(b.sampling_state)
  standing_launches = cuda_wc.MOMENTS_LAUNCHES
  check(standing_launches == 7 * 16, standing_launches)
  cuda_wc.MOMENTS_LAUNCHES = 0
  check(b.sampling_state() is first and cuda_wc.MOMENTS_LAUNCHES == 0,
        cuda_wc.MOMENTS_LAUNCHES)
  step(b.state, real, None)
  cuda_wc.MOMENTS_LAUNCHES = 0
  again, standing2_ms = _ms(b.sampling_state)
  check(again is not first and cuda_wc.MOMENTS_LAUNCHES == 7 * 16,
        cuda_wc.MOMENTS_LAUNCHES)
  log("run", f"diagnostics() {diag_ms:.1f} ms; standing statistics (16 "
      f"train-mode G forwards at batch 64 under the EMA params) "
      f"{standing_ms:.1f} / {standing2_ms:.1f} ms with {standing_launches} "
      f"K1 launches, a cached second call 0, recomputed after one outer "
      f"step (host clock, synchronised; on {nvidia_smi()})")

  g_k = place(Generator(dataclasses.replace(b.state.g.cfg, kernel_eval=True),
                        torch.Generator().manual_seed(0)), dev)
  g_k.load_state_dict(b.state.g.state_dict())
  fused = Trainer(b.ds, dataclasses.replace(b.state, g=g_k), b.gan_cfg,
                  dataclasses.replace(b.cfg, device_data=False))
  n = 1024
  for trainer in (fused, b):                          # warm-up
    trainer.generate(256, batch=256)
  runs = {name: _generate(trainer, n) for name, trainer in (
      ("K2", fused), ("split", b), ("K2 again", fused))}
  imgs_k, dt_k, mem_k, k1_k, k2_k = runs["K2"]
  imgs_s, dt_s, _, _, k2_s = runs["split"]
  check(k2_k == 7 * (n // 256) and k1_k == 0 and k2_s == 0,
        (k2_k, k1_k, k2_s))
  check(imgs_k.shape == (n, 32, 32, 3)
        and np.array_equal(imgs_k, runs["K2 again"][0]), "EMA K2 repeat")
  # K2 held against its plain version on this path: every layer's call
  # swapped for whiten_color_apply_reference, the same inputs.
  with_k2 = cuda_wc.whiten_color_apply
  cuda_wc.whiten_color_apply = cuda_wc.whiten_color_apply_reference
  fused.invalidate_sampling()          # its graphs hold K2's launches
  try:
    imgs_p = fused.generate(n, batch=256)
  finally:
    cuda_wc.whiten_color_apply = with_k2
    fused.invalidate_sampling()
  diffs = {"plain": _u8_diff(imgs_k, imgs_p), "split": _u8_diff(imgs_k,
                                                                imgs_s)}
  mean, p999, top = diffs["plain"]
  check(mean <= SAMPLE_MEAN_TOL and p999 <= SAMPLE_P999_TOL
        and top <= SAMPLE_MAX_TOL, diffs)
  # Beside both, the same G in float32 on the same tensors: how far each
  # bf16 path is from it.
  g32 = place(Generator(dataclasses.replace(b.state.g.cfg, dtype="float32"),
                        torch.Generator().manual_seed(0)), dev)
  g32.load_state_dict(b.state.g.state_dict())
  f32 = Trainer(b.ds, dataclasses.replace(b.state, g=g32), b.gan_cfg,
                dataclasses.replace(b.cfg, device_data=False))
  tensors = fused.sampling_state()
  f32.sampling_state = lambda: tensors
  imgs_32 = f32.generate(n, batch=256)
  to_32 = {k: _u8_diff(v, imgs_32)[0] for k, v in (
      ("K2", imgs_k), ("plain", imgs_p), ("split", imgs_s))}
  log("run", f"EMA generate({n}, batch=256) with standing statistics on "
      f"{nvidia_smi()}: K2 {n / dt_k:.1f} / {n / runs['K2 again'][1]:.1f} "
      f"imgs/s ({k2_k} K2 launches, 7/forward, bitwise repeatable; peak "
      f"{mem_k:.0f} MiB), split {n / dt_s:.1f} imgs/s; uint8 |K2 - K2's "
      "plain version| mean {:.4f}, p99.9 {:.0f}, max {} (gated); |K2 - "
      "split| mean {:.4f}, p99.9 {:.0f}, max {}; mean |x - float32 G| K2 "
      "{:.4f}, plain {:.4f}, split {:.4f}".format(
          *diffs["plain"], *diffs["split"], to_32["K2"], to_32["plain"],
          to_32["split"]))
  return step_launches, standing_launches, k2_k


# --- the conditional slice ----------------------------------------------------

# K1 at the widths of the conditional models: (C, R) at batch 64 and the G
# update's 128. cWC-sa G (512, 256, 128, 64), 64x64: 9 WC layers; WC in
# D 128x4: blocks 1-3 nc1/nc2 at C=128, R = 256 B (block 1) and 64 B.
CWCSA_LAYERS = ((512, 1024), (512, 4096), (512, 4096), (256, 16384),
                (256, 16384), (128, 65536), (128, 65536), (64, 262144),
                (64, 262144))
D_WC_LAYERS = ((128, 16384), (128, 16384), (128, 4096), (128, 4096),
               (128, 4096), (128, 4096))
# The digits G (128, 128) from 4x4 to 16x16 at batch 64: blocks 1-2
# nc1/nc2 and the last coloring.
DIGITS_LAYERS = ((128, 1024), (128, 4096), (128, 4096), (128, 16384),
                 (128, 16384))
RAGGED_R = 1000


def _doubled(layers):
  return tuple((c, 2 * r) for c, r in layers)


def _k1_yardstick(x):
  """Plain float32 moments below R = 65,536; a float64 run above, where
  plain float32 drifts by up to ~5e-5 itself (the cuda lane's rule)."""
  if x.shape[0] < 65536:
    return cuda_wc.moments_reference(x)
  x64 = x.double()
  mean = x64.mean(dim=0)
  return mean, (x64 - mean).T @ (x64 - mean) / x64.shape[0]


def _k1_held(shapes, gen, dev, what: str) -> float:
  """K1 at each (C, R) of ``shapes``, f32 and bf16 rows, within TOL of its
  yardstick, bitwise repeatable, cov == cov^T; the worst error."""
  worst, errs = 0.0, []
  for c, r in shapes:
    for dtype in (torch.float32, torch.bfloat16):
      x = (torch.randn((r, c), generator=gen, device=dev) * 2 + 3).to(dtype)
      got, again = cuda_wc.moments_cuda(x), cuda_wc.moments_cuda(x)
      torch.cuda.synchronize()
      check(all(torch.equal(a, b) for a, b in zip(got, again))
            and torch.equal(got[1], got[1].T), ("not repeatable", c, r))
      err = max_err(got, _k1_yardstick(x))
      check(err <= TOL, (what, c, r, dtype, err))
      worst = max(worst, err)
      errs.append(f"{c}/{r}/{'f32' if dtype == torch.float32 else 'bf16'}:"
                  f"{err:.2e}")
  log(what, "K1 per C/R/rows (plain below R=65536, float64 from it): "
      + " ".join(errs) + "; bitwise repeatable, cov == cov^T")
  return worst


def _k1_timed(shapes, gen, dev, dtype=torch.bfloat16):
  """{(C, R): (K1, plain, torch.cov, bound, bytes floor, operations
  floor)} device ms, in turns. The floors count the rows' bytes in their
  own type and the Gram's operations at that type's peak (``ops_rate``);
  the bound is their larger."""
  out = {}
  for c, r in shapes:
    x = torch.randn((r, c), generator=gen, device=dev).to(dtype)
    xf = x.float()
    k, p, lib = _in_turns((cuda_wc.moments_cuda, (x,)),
                          (cuda_wc.moments_reference, (x,)),
                          (_torch_cov, (xf,)))
    flop = r * c * (c + 1)
    hbm = (r * c * x.element_size() + 4 * (c + c * c)) / HBM_BYTES * 1e3
    ops = flop / ops_rate(dtype) * 1e3
    out[(c, r)] = (k, p, lib, max(hbm, ops), hbm, ops)
  return out


def phase_k1_widths(dev: torch.device):
  """K1 at C = 64, 128 and 512 (and 256 for the sums) at every R of the
  conditional models plus a ragged R, f32 and bf16 rows: within TOL of
  its yardstick, bitwise repeatable, cov == cov^T. Then bf16 timing in
  turns against the plain version and torch.cov with each (C, R)'s bound,
  and the sums over one cWC-sa outer step (54 calls), over D's WC layers
  in one WGAN-GP outer step (96 calls) and over one digits outer step (30
  calls). Returns the worst error and those sums."""
  gen = torch.Generator(device=dev).manual_seed(11)
  shapes = sorted({(c, r) for c, r in CWCSA_LAYERS + _doubled(CWCSA_LAYERS)
                   + D_WC_LAYERS + _doubled(D_WC_LAYERS) + DIGITS_LAYERS
                   + _doubled(DIGITS_LAYERS) if c != 256})
  worst = 0.0
  for c in sorted({c for c, _ in shapes}):
    worst = max(worst, _k1_held(
        [(c, r) for cc, r in shapes if cc == c] + [(c, RAGGED_R)], gen, dev,
        "k1-widths"))
  per = _k1_timed(sorted(set(shapes) | {(256, 16384), (256, 32768)}), gen,
                  dev)
  for (c, r), (k, p, lib, bound, hbm, ops) in per.items():
    log("k1-widths", f"C={c} R={r}: K1 {k:.4f} ms, plain {p:.4f}, torch.cov "
        f"{lib:.4f}; bound {bound:.4f} ("
        f"{'bytes' if hbm >= ops else 'operations'}: HBM {hbm:.4f}, bf16 "
        f"operations {ops:.4f}); K1 at {bound / k:.1%} of it")
  sums = {}
  for name, layers, reps in (
      ("cWC-sa outer step, 54 calls", CWCSA_LAYERS, 5),
      ("WC in D, one WGAN-GP outer step, 96 calls", D_WC_LAYERS, 15),
      ("digits G, one outer step, 30 calls", DIGITS_LAYERS, 5)):
    calls = [l for l in layers for _ in range(reps)] + list(
        _doubled(layers))
    sums[name] = [sum(per[l][i] for l in calls) for i in range(6)]
    k, p, lib, bound, hbm, ops = sums[name]
    log("k1-widths", f"{name} (device ms, bf16 rows, on {nvidia_smi()}): K1 "
        f"{k:.4f}, plain {p:.4f}, torch.cov {lib:.4f}; bound {bound:.4f} "
        f"(HBM {hbm:.4f}, bf16 operations {ops:.4f}); K1 at "
        f"{bound / k:.1%} of it")
  return worst, sums


def _cond_cfgs(model: str, dtype: str, use_kernel=None):
  """(GeneratorConfig, DiscriminatorConfig, GANConfig, batch, resolution)
  of the full-width models: 'cwc' (preset cifar10_cwc_resnet_proj: G
  256x3 ucconv, 10 classes, SN D 128x4 with projection, hinge), 'cwcsa'
  (preset tiny_imagenet_cwcsa's shape: G (512, 256, 128, 64) ucconv-sa at
  64x64, 200 classes, D (64, ..., 1024) with projection), 'gp' (the cWC
  G, D 128x4 with WC layers 'd' and projection, WGAN-GP weight 10);
  'dcgan' (preset cifar10_wc_dcgan: DCGAN G (256, 128, 64) from 4x4 with
  'd'/'uconv', SN DCGAN D (64, 128, 256), ns, one D update) and 'dcgan-bn'
  (its G with 'b' norms); and the headline model with one step option,
  'opt:<name>' for a name of STEP_OPTIONS."""
  if model.startswith("opt:"):
    g_kw, d_kw, gan_kw = STEP_OPTIONS[model[4:]][:3]
    g = GeneratorConfig(filters=(256, 256, 256), dtype=dtype,
                        use_kernel=use_kernel, **g_kw)
    d = DiscriminatorConfig(filters=(128, 128, 128, 128), dtype=dtype,
                            use_kernel=use_kernel, **d_kw)
    gan = GANConfig(loss="hinge", training_ratio=5, random_flip=True,
                    **gan_kw)
    return g, d, gan, 64, 32
  if model in ("dcgan", "dcgan-bn"):
    norm = "b" if model == "dcgan-bn" else "d"
    g = GeneratorConfig(arch="dcgan", filters=(256, 128, 64), block_norm=norm,
                        last_norm=norm, dtype=dtype, use_kernel=use_kernel)
    d = DiscriminatorConfig(arch="dcgan", filters=(64, 128, 256),
                            downsample=(True, True, True), dtype=dtype,
                            use_kernel=use_kernel)
    gan = GANConfig(loss="ns", training_ratio=1, random_flip=True)
    return g, d, gan, 64, 32
  if model == "cwcsa":
    g = GeneratorConfig(resolution=64, filters=(512, 256, 128, 64),
                        block_coloring="ucconv-sa",
                        last_coloring="ucconv-sa", num_classes=200,
                        filters_emb=10, dtype=dtype, use_kernel=use_kernel)
    d = DiscriminatorConfig(resolution=64, filters=(64, 128, 256, 512, 1024),
                            downsample=(True, True, True, True, False),
                            projection=True, num_classes=200, dtype=dtype,
                            use_kernel=use_kernel)
    gan = GANConfig(loss="hinge", gan_type="projection", num_classes=200,
                    training_ratio=5, random_flip=True)
    return g, d, gan, 64, 64
  g = GeneratorConfig(filters=(256, 256, 256), block_coloring="ucconv",
                      last_coloring="ucconv", num_classes=10, dtype=dtype,
                      use_kernel=use_kernel)
  d = DiscriminatorConfig(filters=(128, 128, 128, 128), projection=True,
                          num_classes=10, dtype=dtype, use_kernel=use_kernel,
                          norm="d" if model == "gp" else "n")
  gan = GANConfig(loss="wgan-gp" if model == "gp" else "hinge",
                  gradient_penalty_weight=10.0 if model == "gp" else 0.0,
                  gan_type="projection", num_classes=10, training_ratio=5,
                  random_flip=True)
  return g, d, gan, 64, 32


def _cond_inputs(dev, gan, b, res, seed):
  """Real uint8 images, their labels (zeros when unconditional) and every
  draw of one outer step."""
  gen = torch.Generator(device=dev).manual_seed(seed)
  k, nc, gb = gan.training_ratio, gan.num_classes, 2 * b
  real = torch.randint(0, 256, (k, b, res, res, 3), dtype=torch.uint8,
                       generator=gen, device=dev)
  if not nc:
    noise = {"z_d": torch.randn((k, b, gan.z_dim), generator=gen,
                                device=dev),
             "z_g": torch.randn((gb, gan.z_dim), generator=gen, device=dev),
             "flip": torch.rand((k, b), generator=gen, device=dev) < 0.5}
    return real, torch.zeros((k, b), dtype=torch.long, device=dev), noise
  labels = torch.randint(0, nc, (k, b), generator=gen, device=dev)
  noise = {"z_d": torch.randn((k, b, gan.z_dim), generator=gen, device=dev),
           "z_g": torch.randn((gb, gan.z_dim), generator=gen, device=dev),
           "flip": torch.rand((k, b), generator=gen, device=dev) < 0.5,
           "y_d": torch.randint(0, nc, (k, b), generator=gen, device=dev),
           "y_g": torch.randint(0, nc, (gb,), generator=gen, device=dev)}
  if gan.gradient_penalty_weight > 0:
    noise["gp_eps"] = torch.rand((k, b), generator=gen, device=dev)
  return real, labels, noise


@contextlib.contextmanager
def _deterministic():
  """Deterministic kernels inside the block: cuDNN's deterministic
  algorithms, and PyTorch's for the rest (the gather backward of the
  class tables accumulates with atomics otherwise), so that two runs of
  one float32 step differ only where their code differs."""
  saved = (torch.are_deterministic_algorithms_enabled(),
           torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
  torch.use_deterministic_algorithms(True, warn_only=True)
  torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
      True, False)
  try:
    yield
  finally:
    torch.use_deterministic_algorithms(saved[0], warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        saved[1:])


def _rel(a: dict, b: dict) -> dict:
  return {k: abs(a[k] - b[k]) / max(1.0, abs(b[k])) for k in b}


def _permuted(perm, gperm, real, labels, noise):
  """The same step's inputs with every batch in another order: each D
  batch's images, labels and draws by ``perm``, the G update's by
  ``gperm``. Losses are batch means and the whitening statistics are sums
  over rows, so the step is the same in exact arithmetic and differs only
  in float32 rounding."""
  noise = {k: (v[gperm] if k in ("z_g", "y_g") else v[:, perm])
           for k, v in noise.items()}
  return real[:, perm], labels[:, perm], noise


def _f32_pair(dev, model: str):
  """One float32 outer step of ``model`` from the same state with K1 and
  with plain moments on the same images, labels and noise, then with plain
  moments on the same batches in another order, with deterministic
  kernels. K1 must agree with plain within STEP_RTOL (the statistics
  within STATS_ATOL) or, where plain's own float32 rounding (the reordered
  batch) moves a metric further, within twice that. Returns (metrics K1, metrics plain, wc_stats max|d| of G and
  D, K1 launches, seconds of the K1 step, the K1 state, the largest
  relative metric differences K1 vs plain and plain vs reordered)."""
  out = []
  with _deterministic():
    for use_kernel, reorder in ((True, False), (False, False),
                                (False, True)):
      g_cfg, d_cfg, gan, b, res = _cond_cfgs(model, "float32", use_kernel)
      state = create_state(g_cfg, d_cfg, OptimConfig(), gan.training_ratio,
                           dev, seed=3)
      inputs = _cond_inputs(dev, gan, b, res, seed=12)
      if reorder:
        gen = torch.Generator(device=dev).manual_seed(14)
        inputs = _permuted(
            torch.randperm(b, generator=gen, device=dev),
            torch.randperm(2 * b, generator=gen, device=dev), *inputs)
      real, labels, noise = inputs
      torch.cuda.synchronize()
      cuda_wc.MOMENTS_LAUNCHES = 0
      t0 = time.perf_counter()
      metrics = make_outer_step(gan)(state, real, labels, noise=noise)
      torch.cuda.synchronize()
      out.append(({k: float(v) for k, v in metrics.items()},
                  {f"{m}.{n}": t.detach().clone() for m in ("g", "d")
                   for n, t in getattr(state, m).named_buffers()
                   if n.endswith(("mean", "cov"))},
                  cuda_wc.MOMENTS_LAUNCHES, time.perf_counter() - t0,
                  state if not out else None))
  (m_k, s_k, n_k, dt, st), (m_p, s_p, n_p, _, _), (m_r, s_r, n_r, _, _) = (
      out)
  check(n_p == 0 and n_r == 0, (n_p, n_r))
  d_kp, d_pr = _rel(m_k, m_p), _rel(m_r, m_p)
  stats_err, stats_pr = (max(float((a[n] - s_p[n]).abs().max()) for n in s_p)
                         for a in (s_k, s_r))
  log(f"{model}-f32", "relative metric differences, deterministic kernels: "
      "K1 vs plain " + ", ".join(f"{k} {v:.2e}" for k, v in d_kp.items())
      + "; plain vs plain on the reordered batches " + ", ".join(
          f"{k} {v:.2e}" for k, v in d_pr.items())
      + f"; wc_stats max|d| K1 vs plain {stats_err:.2e}, plain vs reordered "
      f"{stats_pr:.2e}")
  for k in m_p:
    check(np.isfinite(m_k[k]) and d_kp[k] <= max(STEP_RTOL, 2 * d_pr[k]),
          (model, k, m_k[k], m_p[k], m_r[k]))
  check(stats_err <= max(STATS_ATOL, 2 * stats_pr),
        (model, stats_err, stats_pr))
  return (m_k, m_p, stats_err, n_k, dt, st, max(d_kp.values()),
          max(d_pr.values()))


def _run_steps(dev, g_cfg, d_cfg, gan, b, res, steps: int):
  """``steps`` outer steps after one warm-up, every count set to 0 just
  before them: (K1 launches, K2 launches, seconds, metrics of the last,
  state)."""
  opt = OptimConfig(lr_decay_schedule="linear", total_outer_steps=100)
  state = create_state(g_cfg, d_cfg, opt, gan.training_ratio, dev, seed=0)
  step = make_outer_step(gan)
  real, labels, _ = _cond_inputs(dev, gan, b, res, seed=4)
  step(state, real, labels)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  cuda_wc.MOMENTS_LAUNCHES = 0
  cuda_wc.WC_APPLY_LAUNCHES = 0
  t0 = time.perf_counter()
  metrics = [step(state, real, labels) for _ in range(steps)]
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  launches = (cuda_wc.MOMENTS_LAUNCHES, cuda_wc.WC_APPLY_LAUNCHES)
  values = {k: float(metrics[-1][k]) for k in metrics[-1]}
  check(all(np.isfinite(v) for v in values.values()), values)
  return launches + (dt, values, state)


def _bf16_steps(dev, model: str, steps: int):
  """``steps`` bf16 outer steps of ``model`` after one warm-up, counted
  from 0: (K1 launches, seconds, metrics of the last, state, GANConfig)."""
  g_cfg, d_cfg, gan, b, res = _cond_cfgs(model, "bfloat16")
  k1, _, dt, values, state = _run_steps(dev, g_cfg, d_cfg, gan, b, res,
                                        steps)
  return k1, dt, values, state, gan


def phase_cond_slice(dev: torch.device):
  """The two conditional models at full width: bf16 outer steps with the
  K1 launches counted (42 and 54 a step), outer steps/s and imgs/s on the
  host clock; one float32 outer step of each with K1 and with plain
  moments; one cWC step profiled. Returns the launches by path and the
  cWC state (for sampling)."""
  paths = {}
  cwc_state = None
  for model, steps, per_step, name in (
      ("cwc", 4, 42, "cWC + projection-D (cifar10_cwc_resnet_proj)"),
      ("cwcsa", 3, 54, "cWC-sa (tiny_imagenet_cwcsa's shape)")):
    launches, dt, last, state, gan = _bf16_steps(dev, model, steps)
    check(launches == per_step * steps, (model, launches))
    b = 64
    log("cond-slice", f"{name}, bf16, b64 x5 D + b128 G, {steps} outer "
        f"steps in {dt:.3f} s = {steps / dt:.3f} steps/s, "
        f"{steps * 5 * b / dt:.1f} imgs/s (host clock, synchronised) on "
        f"{nvidia_smi()}; K1 launches {launches} ({per_step}/step); peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; last "
        + ", ".join(f"{k} {v:.4f}" for k, v in last.items()))
    paths[f"cond-slice: {model}, {steps} bf16 outer steps"] = launches
    if model == "cwc":
      cwc_state, cwc_gan = state, gan
    else:
      del state
    m_k, m_p, stats_err, n_k, dt32, _, kp, pr = _f32_pair(dev, model)
    check(n_k == per_step, (model, n_k))
    paths[f"cond-slice: {model}, one float32 outer step"] = n_k
    log("cond-slice", f"{name}, float32, one outer step, K1 vs plain "
        f"moments: " + ", ".join(f"{k} {m_k[k]:.6f}/{m_p[k]:.6f}"
                                 for k in m_p)
        + f"; largest relative difference {kp:.2e} (plain vs reordered "
        f"{pr:.2e}); wc_stats max|d| {stats_err:.2e}; K1 launches {n_k}; "
        f"{dt32:.3f} s")
    torch.cuda.empty_cache()
  _profile_cond_step(cwc_state, cwc_gan)
  return paths, cwc_state, cwc_gan


def _profile_cond_step(state, gan) -> None:
  """One bf16 cWC outer step under torch.profiler: kernel time, busy
  share over the device span, K1's share."""
  dev = state.generator.device
  real, labels, _ = _cond_inputs(dev, gan, 64, 32, seed=9)
  step = make_outer_step(gan)
  step(state, real, labels)
  torch.cuda.synchronize()
  kernels, wall = _traced_kernels(lambda: step(state, real, labels))
  total = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
  span = (max(e.time_range.end for e in kernels)
          - min(e.time_range.start for e in kernels)) / 1e3
  k1 = [e for e in kernels if any(n in e.name for n in K1_KERNELS)]
  k1_ms = sum(e.time_range.elapsed_us() for e in k1) / 1e3
  gram = sum(1 for e in k1 if "centered_gram" in e.name)
  check(total > 0 and gram == 42, (total, gram))
  log("profile-cond", f"one cWC outer step (bf16) under torch.profiler on "
      f"{nvidia_smi()}: {len(kernels)} kernels, {total:.3f} ms of kernel "
      f"time in a {span:.3f} ms device span (busy {total / span:.2f}; "
      f"profiled wall {wall:.1f} ms); K1 {k1_ms:.3f} ms "
      f"({k1_ms / total:.1%}; {gram} Gram launches)")


def _d_grads(d, x, fake, labels, eps):
  """(the WGAN-GP D loss of one D update, its D-parameter gradient
  flattened, K1 launches): real and fake scored apart, the penalty on the
  interpolates, as ``train/step.py`` takes it."""
  before = cuda_wc.MOMENTS_LAUNCHES
  gp = losses.gradient_penalty(lambda xi: d(xi, labels)[0], x, fake, eps,
                               weight=10.0)
  loss = losses.wgan_d_loss(d(x, labels)[0], d(fake, labels)[0]) + gp
  grads = torch.autograd.grad(loss, list(d.parameters()), allow_unused=True,
                              materialize_grads=True)
  torch.cuda.synchronize()
  return (loss.detach().item(), torch.cat([g.flatten() for g in grads]),
          cuda_wc.MOMENTS_LAUNCHES - before)


def _cond_number(cov: torch.Tensor) -> float:
  eig = torch.linalg.eigvalsh(cov.double())
  return float(eig[-1] / eig[0].clamp(min=1e-30))


def phase_gp_dnorm(dev: torch.device):
  """WC in D with WGAN-GP at full width. First the D loss of one D update
  (penalty included) and its D-parameter gradient, which differentiates
  K1's backward a second time, through K1 and through plain moments on the
  same D and inputs, and through plain moments on the batch reordered
  (float32 rounding alone); then one float32 outer step with K1 (138
  launches) and with plain moments. Returns the step's K1 launches."""
  g_cfg, d_cfg, gan, b, res = _cond_cfgs("gp", "float32")
  state = create_state(g_cfg, d_cfg, OptimConfig(), 5, dev, seed=3)
  real, labels, noise = _cond_inputs(dev, gan, b, res, seed=13)
  x = step_lib.prepare_real(real[0], None)
  with torch.no_grad():
    fake = state.g(noise["z_d"][0], noise["y_d"][0], train=True,
                   update_stats=False)
  d_plain = place(Discriminator(dataclasses.replace(d_cfg, use_kernel=False),
                                torch.Generator().manual_seed(0)), dev)
  d_plain.load_state_dict(state.d.state_dict())
  perm = torch.randperm(b, generator=torch.Generator(device=dev).manual_seed(
      15), device=dev)
  y, eps = labels[0], noise["gp_eps"][0]
  with _deterministic(), L.capture_batch_moments(state.d) as moments:
    (loss_k, g_k, n1), (loss_p, g_p, n2), (loss_r, g_r, _) = (
        _d_grads(state.d, x, fake, y, eps), _d_grads(d_plain, x, fake, y, eps),
        _d_grads(d_plain, x[perm], fake[perm], y[perm], eps[perm]))
  conds = [_cond_number(v) for k, v in moments.items() if k.endswith("cov")]
  scale = float(g_p.abs().max())
  err_kp = float((g_k - g_p).abs().max()) / scale
  err_pr = float((g_r - g_p).abs().max()) / scale
  flips = float(((g_k > 0) != (g_p > 0)).float().mean())
  log("gp-dnorm", f"one D update's loss (real, fake and interpolates of 64, "
      f"penalty included): K1 {loss_k:.6f}, plain {loss_p:.6f}, plain on "
      f"the reordered batch {loss_r:.6f}; its D-parameter gradient through "
      f"K1's double backward, max|d| / max|grad| (max|grad| {scale:.3e}): "
      f"K1 vs plain {err_kp:.2e}, plain vs reordered {err_pr:.2e}; "
      f"gradient signs that differ K1 vs plain {flips:.2e}; K1 launches {n1} "
      f"(3 D passes x 6 WC layers); condition numbers of D's batch "
      f"covariances (fake pass) " + ", ".join(
          f"{c:.3g}" for c in conds))
  check(np.isfinite(loss_k) and bool(torch.isfinite(g_k).all())
        and abs(loss_k - loss_p) <= STEP_RTOL * max(1.0, abs(loss_p))
        and err_kp <= max(STEP_RTOL, 2 * err_pr) and n1 == 18 and n2 == 0,
        (loss_k, loss_p, err_kp, err_pr, n1, n2))
  del state, d_plain
  m_k, m_p, stats_err, n_k, dt, _, kp, pr = _f32_pair(dev, "gp")
  check(n_k == 5 * (7 + 6 + 6 + 6) + 7 + 6, n_k)
  log("gp-dnorm", "cWC G 256x3 + D 128x4 with WC layers 'd' and projection, "
      "WGAN-GP 10, float32, one outer step, K1 vs plain moments: "
      + ", ".join(f"{k} {m_k[k]:.6f}/{m_p[k]:.6f}" for k in m_p)
      + f"; largest relative difference {kp:.2e} (plain vs reordered "
      f"{pr:.2e}); wc_stats max|d| {stats_err:.2e}; K1 launches {n_k}; "
      f"{dt:.3f} s")
  return n_k


def phase_cond_sampling(dev: torch.device, state, gan):
  """Conditional sampling from the cWC G: ``generate(1024, batch=256)``
  (z, then labels, per batch) twice, bitwise equal, with no K2 launch;
  K2 forced on its conditional layers raises, naming one. Then the CLI: a
  conditional PROJECTIVE run with labelled grids and ``--phase test`` on
  its exported npz. Returns the K2 launches of the generate run."""
  ds = get_dataset("synthetic", batch_size=64, seed=0, conditional=True,
                   z_dim=gan.z_dim, synthetic_size=256)
  out_dir = os.path.join("build", "chip_smoke_cond")
  shutil.rmtree(out_dir, ignore_errors=True)
  cfg = TrainerConfig(name="smoke", output_dir=out_dir,
                      checkpoints_dir=os.path.join(out_dir, "ckpt"))
  trainer = Trainer(ds, state, gan, cfg)
  trainer.generate(256, batch=256)                       # warm-up
  imgs, dt, mem, k1, k2 = _generate(trainer, 1024)
  again = _generate(trainer, 1024)
  check(imgs.shape == (1024, 32, 32, 3) and imgs.dtype == np.uint8
        and np.array_equal(imgs, again[0]), "conditional generate repeat")
  check(k1 == 0 and k2 == 0 and again[4] == 0, (k1, k2))
  g_k = place(Generator(dataclasses.replace(state.g.cfg, kernel_eval=True),
                        torch.Generator().manual_seed(0)), dev)
  g_k.load_state_dict(state.g.state_dict())
  z = torch.randn((8, gan.z_dim), device=dev)
  try:
    g_k(z, torch.zeros(8, dtype=torch.long, device=dev), train=False)
    check(False, "kernel_eval=True on a conditional layer did not raise")
  except ValueError as e:
    check("block0.nc1" in str(e), str(e))
  log("cond-sampling", f"cWC G 256x3 bf16, conditional generate(1024, "
      f"batch=256) on {nvidia_smi()}: {1024 / dt:.1f} / "
      f"{1024 / again[1]:.1f} imgs/s (host clock), bitwise repeatable, K2 "
      f"launches {k2}, K1 {k1}; peak {mem:.0f} MiB; kernel_eval=True "
      "raises on block0.nc1")
  path = trainer.save_sample_grid(0)
  check(os.path.getsize(path) > 0, path)
  cli_dir = os.path.join("build", "chip_smoke_cond_cli")
  shutil.rmtree(cli_dir, ignore_errors=True)
  cond = ["--conditional", "--gan_type", "PROJECTIVE",
          "--generator_block_coloring", "ucconv",
          "--generator_last_coloring", "ucconv"]
  cmd, dt, lines = _run_cli(cond + [
      "--number_of_epochs", "2", "--batches_per_epoch", "3",
      "--checkpoint_ratio", "2", "--checkpoints_dir",
      os.path.join(cli_dir, "ckpt")], cli_dir)
  grids = sorted(os.path.basename(p) for p in
                 glob.glob(os.path.join(cli_dir, "smoke", "*.png")))
  npz = os.path.join(cli_dir, "ckpt", "smoke", "epoch_1_generator.npz")
  check(sum(l.startswith("Epoch ") for l in lines) == 2
        and grids == ["epoch_00000.png", "epoch_00001.png"]
        and os.path.isfile(npz), (lines, grids))
  with np.load(npz) as data:
    check("['block0']/['nc1']/['gamma_c']" in data.files, data.files[:8])
  log("cond-sampling", f"{' '.join(cmd[1:])}: rc 0 in {dt:.1f} s; "
      f"labelled grids {grids}; {npz}")
  test_dir = os.path.join("build", "chip_smoke_cond_test")
  shutil.rmtree(test_dir, ignore_errors=True)
  cmd, dt, lines = _run_cli(cond + ["--phase", "test", "--generator_checkpoint",
                                    npz, "--start_epoch", "2"], test_dir)
  grid = os.path.join(test_dir, "smoke", "epoch_00002.png")
  check(os.path.isfile(grid) and any("wrote sample grid" in l
                                     for l in lines), lines)
  log("cond-sampling", f"{' '.join(cmd[1:])}: rc 0 in {dt:.1f} s; wrote "
      f"{grid}")
  return k2


# --- slice 7: the DCGAN (BASELINE config 1), BatchNorm, the step options and
# the presets ---------------------------------------------------------------

# (C, R) of the DCGAN G's 4 WC layers (block0-2 nc, nc_out) at batch 64
# (the one D-phase forward of a step); the G update doubles R. In eval mode
# at the generate batch 256.
DCGAN_LAYERS = ((256, 1024), (256, 4096), (128, 16384), (64, 65536))
DCGAN_GENERATE = ((256, 4096), (256, 16384), (128, 65536), (64, 262144))
DCGAN_CLI = ("--preset", "cifar10_wc_dcgan", "--dataset", "synthetic",
             "--synthetic_resolution", "32")
# The headline model with one option of the reference's step:
# (G, D and GAN config fields, K1 launches a step, K2 launches a step with
# kernel_eval=True on the bf16 run). With remat the G update recomputes its
# 3 blocks' 2 WC layers each in the backward: 7 x 5 + 7 + 6.
STEP_OPTIONS = {
    "batched_fake_gen": ({}, {}, dict(batched_fake_gen=True), 14, 0),
    "d_fake_stats_running": ({}, {}, dict(d_fake_stats="running"), 7, 35),
    "remat": (dict(remat=True), dict(remat=True), {}, 7 * 5 + 7 + 6, 0),
    "sn_update_on_g_step": ({}, {}, dict(sn_update_on_g_step=True), 42, 0),
    "conv_singular": ({}, dict(conv_singular=True), {}, 42, 0),
}
# K1 at the 5 x 64 rows of one batched_fake_gen forward's last layers.
BATCHED_R = 5 * 65536


def phase_dcgan(dev: torch.device):
  """BASELINE config 1 (preset cifar10_wc_dcgan) at full width, float32 as
  the preset runs it. The CLI as a user runs it: 2 epochs of 8 outer
  steps with a checkpoint each, ``--resume auto`` for a third, then
  ``--phase test`` on its npz. K1 at the G's (C, R), timed. A direct
  step loop with K1 counted (8 a step: 4 WC layers in the D-phase G
  forward at batch 64, 4 in the G update at 128), and one float32 step
  with K1 against plain moments under ``_f32_pair``'s gates. Returns (K1
  launches by path, the worst K1 error, the trained state and its
  GANConfig)."""
  out_dir = os.path.join("build", "chip_smoke_dcgan")
  shutil.rmtree(out_dir, ignore_errors=True)
  ck = os.path.join(out_dir, "ckpt")
  base = ("--batches_per_epoch", "8", "--checkpoint_ratio", "1",
          "--checkpoints_dir", ck)
  cmd, dt1, _ = _run_cli(base + ("--number_of_epochs", "2"), out_dir,
                         DCGAN_CLI)
  cmd, dt2, lines = _run_cli(base + ("--number_of_epochs", "3", "--resume",
                                     "auto"), out_dir, DCGAN_CLI)
  counts = [sum(l.startswith(f"Epoch {i}:") for l in lines) for i in range(3)]
  check(any("(start_epoch 2)" in l for l in lines) and counts == [1, 1, 1],
        (counts, lines))
  with open(os.path.join(out_dir, "smoke", "metrics.jsonl")) as f:
    records = [json.loads(l) for l in f]
  check([r["epoch"] for r in records] == [0, 1, 2]
        and all(np.isfinite(r[k]) for r in records
                for k in DIAG_KEYS + ("d_loss", "g_loss")), records)
  log("dcgan", f"{' '.join(cmd[1:])}: rc 0, {dt1:.1f} s then {dt2:.1f} s "
      f"(resumed at epoch 2); per epoch on {nvidia_smi()} (8 outer steps "
      f"of 64 real images, host clock): " + "; ".join(
          f"{r['epoch']}: {r['imgs_per_sec']:.1f} imgs/s, d_loss "
          f"{r['d_loss']:.4f}, g_loss {r['g_loss']:.4f}, wc_cov_cond_max "
          f"{r['wc_cov_cond_max']:.4g}" for r in records))
  npz = os.path.join(ck, "smoke", "epoch_2_generator.npz")
  with np.load(npz) as data:
    check("['block0']/['deconv']/['kernel']" in data.files, data.files[:8])
  test_dir = os.path.join("build", "chip_smoke_dcgan_test")
  shutil.rmtree(test_dir, ignore_errors=True)
  cmd, dt, lines = _run_cli(("--phase", "test", "--generator_checkpoint", npz,
                             "--start_epoch", "3"), test_dir, DCGAN_CLI)
  grid = os.path.join(test_dir, "smoke", "epoch_00003.png")
  check(os.path.isfile(grid) and any("wrote sample grid" in l
                                     for l in lines), lines)
  log("dcgan", f"{' '.join(cmd[1:])}: rc 0 in {dt:.1f} s; wrote {grid}")

  gen = torch.Generator(device=dev).manual_seed(21)
  shapes = list(DCGAN_LAYERS) + list(_doubled(DCGAN_LAYERS))
  worst = _k1_held(shapes, gen, dev, "dcgan")
  timed = _k1_timed(shapes, gen, dev, torch.float32)
  for (c, r), (k, p, lib, bound, hbm, ops) in timed.items():
    log("dcgan", f"K1 C={c} R={r} float32 rows: {k:.4f} ms, plain {p:.4f}, "
        f"torch.cov {lib:.4f}; bound {bound:.4f} "
        f"({'bytes' if hbm >= ops else 'operations'}); K1 at "
        f"{bound / k:.1%} of it")
  sums = [sum(t[i] for t in timed.values()) for i in range(4)]
  log("dcgan", f"the 8 K1 calls of one DCGAN outer step (device ms, float32 "
      f"rows, on {nvidia_smi()}): K1 {sums[0]:.4f}, plain {sums[1]:.4f}, "
      f"torch.cov {sums[2]:.4f}; bound {sums[3]:.4f}; K1 at "
      f"{sums[3] / sums[0]:.1%} of it")

  g_cfg, d_cfg, gan, b, res = _cond_cfgs("dcgan", "float32")
  seen = []
  plain_moments = whiten.batch_moments

  def recorded(x2d, use_kernel=None, group=None):
    seen.append((x2d.shape[1], x2d.shape[0]))
    return plain_moments(x2d, use_kernel, group)

  steps = 6
  whiten.batch_moments = recorded
  try:
    k1, _, dt, last, state = _run_steps(dev, g_cfg, d_cfg, gan, b, res,
                                        steps)
  finally:
    whiten.batch_moments = plain_moments
  per_step = seen[-8:]
  check(k1 == 8 * steps and sorted(per_step) == sorted(shapes),
        (k1, per_step))
  log("dcgan", f"G (256, 128, 64) + D (64, 128, 256) float32, b64 D + b128 "
      f"G, {steps} outer steps in {dt:.3f} s = {steps * b / dt:.1f} imgs/s "
      f"(host clock) on {nvidia_smi()}; K1 launches {k1} (8/step) at (C, R) "
      f"{per_step}; peak memory "
      f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; last "
      + ", ".join(f"{k} {v:.4f}" for k, v in last.items()))
  m_k, m_p, stats_err, n_k, dt32, _, kp, pr = _f32_pair(dev, "dcgan")
  check(n_k == 8, n_k)
  log("dcgan", "one float32 outer step, K1 vs plain moments: " + ", ".join(
      f"{k} {m_k[k]:.6f}/{m_p[k]:.6f}" for k in m_p)
      + f"; largest relative difference {kp:.2e} (plain vs reordered "
      f"{pr:.2e}); wc_stats max|d| {stats_err:.2e}; K1 launches {n_k}")
  paths = {f"dcgan: {steps} float32 outer steps": k1,
           "dcgan: one float32 outer step": n_k}
  return paths, worst, state, gan


def phase_dcgan_bn(dev: torch.device) -> None:
  """The DCGAN G with 'b' norms (BatchNorm, then 'uconv' coloring): no K1
  launch, finite losses, its running statistics advanced."""
  g_cfg, d_cfg, gan, b, res = _cond_cfgs("dcgan-bn", "float32")
  steps = 3
  k1, k2, dt, last, state = _run_steps(dev, g_cfg, d_cfg, gan, b, res, steps)
  var = state.g.nc_out.norm.bn.var
  check(k1 == 0 and k2 == 0 and not torch.equal(var, torch.ones_like(var)),
        (k1, k2))
  log("dcgan-bn", f"DCGAN G with 'b' norms + D, float32, {steps} outer steps "
      f"in {dt:.3f} s = {steps * b / dt:.1f} imgs/s (host clock) on "
      f"{nvidia_smi()}; K1 launches {k1}, K2 {k2}; last " + ", ".join(
          f"{k} {v:.4f}" for k, v in last.items()))


def phase_dcgan_sampling(dev: torch.device, state, gan):
  """K2 on the DCGAN G: held against its plain version at C = 128 and 64
  (f32 and bf16 rows, both scalings), timed per width at the R of a
  batch-256 generate forward against torch.addmm and its bounds, then the
  trained float32 G's ``generate(1024, batch=256)`` with kernel_eval=True
  (4 K2 calls a forward), bitwise repeatable, against the same generate
  with K2's plain version and with the split path. Returns (K2 launches,
  the worst float32 error)."""
  gen = torch.Generator(device=dev).manual_seed(22)
  worst, errs = 0.0, []
  for cols, rows in ((128, 65536), (64, 262144), (128, 1000), (64, 130)):
    x, mean, cov, gamma, beta = _k2_inputs(rows, cols, gen, dev)
    for dtype, scaling in ((torch.float32, "trace"), (torch.float32, "fro"),
                           (torch.bfloat16, "trace"),
                           (torch.bfloat16, "fro")):
      xd = x.to(dtype)
      got = cuda_wc.whiten_color_apply_cuda(xd, mean, cov, gamma, beta,
                                            scaling=scaling)
      ref = cuda_wc.whiten_color_apply_reference(xd, mean, cov, gamma, beta,
                                                 scaling=scaling)
      err = float((got.float() - ref.float()).abs().max())
      gate = K2_F32_TOL if dtype == torch.float32 else _bf16_gate(ref)
      check(got.dtype == dtype and err <= gate, (cols, rows, dtype, err))
      if dtype == torch.float32:
        worst = max(worst, err)
      errs.append(f"{cols}/{rows}/{'f32' if dtype == torch.float32 else 'bf16'}"
                  f"/{scaling}:{err:.2e}(<={gate:.1e})")
  log("dcgan-sampling", "K2 vs plain, C/R/rows/scaling: " + " ".join(errs))
  sums = np.zeros(4)
  for cols, rows in DCGAN_GENERATE:
    x, mean, cov, gamma, beta = _k2_inputs(rows, cols, gen, dev)
    stats = (mean, cov, gamma, beta)
    m, bias = cuda_wc.whiten_color_fold_reference(*stats)
    mt = m.T.contiguous()
    for dtype in (torch.float32, torch.bfloat16):
      xd = x.to(dtype)
      k2, plain, addmm = _in_turns(
          (cuda_wc.whiten_color_apply_cuda, (xd,) + stats),
          (cuda_wc.whiten_color_apply_reference, (xd,) + stats),
          (torch.addmm, (bias, xd.float(), mt)))
      # Bytes: rows read and written in their type, the statistics once.
      # Operations: row apply and setup at the peak of the rows' type.
      nbytes = (2 * rows * cols * xd.element_size()
                + 4 * (2 * cols * cols + 2 * cols))
      flop = 2 * rows * cols ** 2 + 3 * 15 * 2 * cols ** 3
      hbm = nbytes / HBM_BYTES * 1e3
      ops = flop / ops_rate(dtype) * 1e3
      if dtype == torch.float32:
        sums += (k2, plain, addmm, max(hbm, ops))
      log("dcgan-sampling", f"K2 C={cols} R={rows} "
          f"{'f32' if dtype == torch.float32 else 'bf16'} rows: {k2:.4f} ms, "
          f"plain {plain:.4f}, torch.addmm (row apply alone, float32) "
          f"{addmm:.4f}; bound {max(hbm, ops):.4f} "
          f"({'bytes' if hbm >= ops else 'operations'}); K2 at "
          f"{max(hbm, ops) / k2:.1%} of it (on {nvidia_smi()})")
  log("dcgan-sampling", f"the 4 K2 calls of one batch-256 DCGAN forward "
      f"(device ms, float32 rows as the preset runs, on {nvidia_smi()}): K2 "
      f"{sums[0]:.4f}, plain {sums[1]:.4f}, torch.addmm {sums[2]:.4f}; bound "
      f"{sums[3]:.4f}; K2 at {sums[3] / sums[0]:.1%} of it")
  ds = get_dataset("synthetic", batch_size=64, seed=0, z_dim=gan.z_dim,
                   synthetic_size=256)
  out_dir = os.path.join("build", "chip_smoke_dcgan_sampling")
  shutil.rmtree(out_dir, ignore_errors=True)
  cfg = TrainerConfig(name="smoke", output_dir=out_dir,
                      checkpoints_dir=os.path.join(out_dir, "ckpt"))
  g_k = place(Generator(dataclasses.replace(state.g.cfg, kernel_eval=True),
                        torch.Generator().manual_seed(0)), dev)
  g_k.load_state_dict(state.g.state_dict())
  fused = Trainer(ds, dataclasses.replace(state, g=g_k), gan, cfg)
  split = Trainer(ds, state, gan, cfg)
  n = 1024
  for trainer in (fused, split):                     # warm-up
    trainer.generate(256, batch=256)
  runs = {name: _generate(trainer, n) for name, trainer in (
      ("K2", fused), ("split", split), ("K2 again", fused))}
  imgs_k, dt_k, mem_k, k1_k, k2_k = runs["K2"]
  check(k2_k == 4 * (n // 256) and k1_k == 0 and runs["split"][4] == 0,
        (k2_k, k1_k))
  # cuDNN's transposed convs (the deconvs) may pick non-deterministic
  # algorithms, so two runs of the same G differ by rounding: held to the
  # sampling gates here, and bitwise below with deterministic algorithms.
  repeat = _u8_diff(imgs_k, runs["K2 again"][0])
  check(imgs_k.shape == (n, 32, 32, 3) and repeat[0] <= SAMPLE_MEAN_TOL
        and repeat[1] <= SAMPLE_P999_TOL and repeat[2] <= SAMPLE_MAX_TOL,
        ("DCGAN K2 repeat", repeat))
  with _deterministic():
    imgs_d = fused.generate(n, batch=256)
    check(np.array_equal(imgs_d, fused.generate(n, batch=256)),
          "DCGAN K2 repeat with deterministic algorithms")
    with_k2 = cuda_wc.whiten_color_apply
    cuda_wc.whiten_color_apply = cuda_wc.whiten_color_apply_reference
    fused.invalidate_sampling()        # its graphs hold K2's launches
    try:
      imgs_p = fused.generate(n, batch=256)
    finally:
      cuda_wc.whiten_color_apply = with_k2
      fused.invalidate_sampling()
    imgs_s = split.generate(n, batch=256)
  diffs = {"plain": _u8_diff(imgs_d, imgs_p), "split": _u8_diff(imgs_d,
                                                                imgs_s)}
  mean, p999, top = diffs["plain"]
  check(mean <= SAMPLE_MEAN_TOL and p999 <= SAMPLE_P999_TOL
        and top <= SAMPLE_MAX_TOL, diffs)
  log("dcgan-sampling", f"DCGAN G float32, generate({n}, batch=256) on "
      f"{nvidia_smi()}: K2 {n / dt_k:.1f} / {n / runs['K2 again'][1]:.1f} "
      f"imgs/s ({k2_k} K2 launches, 4/forward; peak {mem_k:.0f} MiB), split "
      f"{n / runs['split'][1]:.1f} imgs/s; uint8 |K2 - K2 again| mean "
      "{:.4f}, p99.9 {:.0f}, max {} (cuDNN's own algorithms); with "
      "deterministic algorithms bitwise repeatable, |K2 - K2's plain "
      "version| mean {:.4f}, p99.9 {:.0f}, max {} (gated), |K2 - split| "
      "mean {:.4f}, p99.9 {:.0f}, max {}".format(
          *repeat, *diffs["plain"], *diffs["split"]))
  return k2_k, worst


def phase_step_options(dev: torch.device):
  """Each step option of STEP_OPTIONS on the headline model: 2 bf16 outer
  steps with K1 (and K2) counted, then one float32 outer step with K1
  against plain moments under ``_f32_pair``'s gates; K1 at batched_fake_gen's
  327,680 rows. Returns (K1 launches by path, K2 launches by path, the
  worst K1 error)."""
  gen = torch.Generator(device=dev).manual_seed(23)
  worst = _k1_held(((256, BATCHED_R), (256, BATCHED_R // 4)), gen, dev,
                   "step-options")
  (c, r), (k, p, lib, bound, hbm, ops) = next(iter(_k1_timed(
      ((256, BATCHED_R),), gen, dev).items()))
  log("step-options", f"K1 C={c} R={r} bf16 rows: {k:.4f} ms, plain "
      f"{p:.4f}, torch.cov {lib:.4f}; bound {bound:.4f} "
      f"({'bytes' if hbm >= ops else 'operations'}); K1 at "
      f"{bound / k:.1%} of it")
  k1_paths, k2_paths = {}, {}
  for name, (_, _, _, k1_per, k2_per) in STEP_OPTIONS.items():
    g_cfg, d_cfg, gan, b, res = _cond_cfgs(f"opt:{name}", "bfloat16")
    if k2_per:
      g_cfg = dataclasses.replace(g_cfg, kernel_eval=True)
    steps = 2
    k1, k2, dt, last, _ = _run_steps(dev, g_cfg, d_cfg, gan, b, res, steps)
    check(k1 == k1_per * steps and k2 == k2_per * steps, (name, k1, k2))
    k1_paths[f"step-options: {name}, {steps} bf16 outer steps"] = k1
    if k2:
      k2_paths[f"step-options: {name} with kernel_eval, {steps} bf16 outer "
               "steps"] = k2
    m_k, m_p, stats_err, n_k, dt32, _, kp, pr = _f32_pair(dev, f"opt:{name}")
    check(n_k == k1_per, (name, n_k))
    k1_paths[f"step-options: {name}, one float32 outer step"] = n_k
    log("step-options", f"{name}: bf16, {steps} outer steps in {dt:.3f} s = "
        f"{steps * 5 * b / dt:.1f} imgs/s (host clock) on {nvidia_smi()}; "
        f"K1 launches {k1} ({k1_per}/step), K2 {k2}; last " + ", ".join(
            f"{k} {v:.4f}" for k, v in last.items())
        + f". float32, one outer step, K1 vs plain: largest relative "
        f"difference {kp:.2e} (plain vs reordered {pr:.2e}); wc_stats "
        f"max|d| {stats_err:.2e}; K1 launches {n_k}")
    torch.cuda.empty_cache()
  return k1_paths, k2_paths, worst


def phase_presets(dev: torch.device):
  """Every preset through ``--preset <name> --smoke`` in-process (the
  CLI's ``main``), on the card; imagenet64_cwc_dp (--mesh 8) must fail on
  the GPU count. Then stl10_wc_resnet_sn at full width (48x48: G
  512/256/128 from 6x6, D 64..1024, float32) for 2 outer steps through the
  CLI, K1 counted (42 a step). Returns the K1 launches of that run."""
  out_dir = os.path.join("build", "chip_smoke_presets")
  shutil.rmtree(out_dir, ignore_errors=True)
  done = []
  for name in PRESETS:
    argv = ["--preset", name, "--smoke", "--output_dir", out_dir,
            "--checkpoints_dir", os.path.join(out_dir, "ckpt"), "--name", name]
    t0 = time.perf_counter()
    if name == "imagenet64_cwc_dp":
      # --mesh 8 wants a GPU a rank (the dp phase runs it on one card).
      try:
        cli_run.main(argv)
        check(False, "imagenet64_cwc_dp ran --mesh 8 on one GPU")
      except SystemExit as e:
        refusal = str(e)
      check("--mesh 8 --device cuda needs 8 CUDA GPUs" in refusal, refusal)
      done.append(f"{name}: {refusal}")
      continue
    check(cli_run.main(argv) == 0, name)
    with open(os.path.join(out_dir, name, "log.txt")) as f:
      text = f.read()
    check("Epoch 1:" in text and "nan" not in text.lower(), text)
    done.append(f"{name}: rc 0 in {time.perf_counter() - t0:.1f} s")
  log("presets", "--preset <name> --smoke on the card: " + "; ".join(done))
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  cuda_wc.MOMENTS_LAUNCHES = 0
  t0 = time.perf_counter()
  check(cli_run.main([
      "--preset", "stl10_wc_resnet_sn", "--dataset", "synthetic",
      "--synthetic_resolution", "48", "--number_of_epochs", "1",
      "--batches_per_epoch", "2", "--steps_per_call", "2",
      "--checkpoint_ratio", "0", "--output_dir", out_dir, "--name",
      "stl10"]) == 0, "stl10 full width")
  dt = time.perf_counter() - t0
  launches = cuda_wc.MOMENTS_LAUNCHES
  with open(os.path.join(out_dir, "stl10", "metrics.jsonl")) as f:
    record = json.loads(f.readline())
  check(launches == 2 * 42 and np.isfinite(record["d_loss"])
        and np.isfinite(record["g_loss"]), (launches, record))
  log("presets", f"stl10_wc_resnet_sn at full width (48x48, G 512/256/128, "
      f"D 64..1024, float32), 2 outer steps of 5 x 64: {dt:.1f} s with the "
      f"process's warm-up, epoch {record['imgs_per_sec']:.1f} imgs/s (host "
      f"clock) on {nvidia_smi()}; K1 launches {launches} (42/step); peak "
      f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; d_loss "
      f"{record['d_loss']:.4f}, g_loss {record['g_loss']:.4f}")
  return launches


# The eval phase: the reference's scorer defaults (make_scorer,
# wcgan_tpu/cli/run.py:215-223) on the headline G at full width (256x3,
# bf16) with EMA 0.999 and kernel_eval=True, random Inception weights.
EVAL_IS, EVAL_FID, EVAL_BATCH = 50000, 10000, 100
EVAL_FORWARDS = -(-EVAL_IS // 256)          # generate()'s batch-256 forwards
EVAL_NET_RTOL = 1e-4    # Inception on the card against the CPU, float32
EVAL_PRE_ATOL = 1e-5    # preprocess on the card against the CPU
EVAL_IS_RTOL = 1e-5     # IS against numpy float64 on the same probabilities
EVAL_FID_RTOL = 1e-3    # eigh FID against scipy float64 (the reference's)
EVAL_NS_RTOL = 1e-2     # ns FID against float64 on the reference's own
                        # validation case (tests/test_evaluation.py:77-90)
# Scores from K2's images against the split path's: the images differ by
# under 1 uint8 level on average (SAMPLE_MEAN_TOL), ~0.4 % of the range;
# FID moves by about twice the relative change of the features' offset.
EVAL_K2_IS_RTOL = 1e-3
EVAL_K2_FID_RTOL = 5e-2
EVAL_CLI_IS, EVAL_CLI_FID = 1000, 500   # the CLI's scoring, 2 epochs
EVAL_ARGV = ["--device", "cuda", "--dataset", "synthetic", "--arch", "res",
             "--bf16", "--synthetic_size", str(EVAL_FID), "--generator_ema",
             "0.999", "--name", "smoke"]


def _rel_err(a, b) -> float:
  return abs(a - b) / max(abs(b), 1e-30)


def _is64(probs: np.ndarray, splits: int = 10):
  """(mean, std) of the Inception Score in numpy float64."""
  p = probs.astype(np.float64)
  per = p.shape[0] // splits
  p = p[:per * splits].reshape(splits, per, -1)
  marg = p.mean(1, keepdims=True)
  kl = (p * (np.log(p + 1e-16) - np.log(marg + 1e-16))).sum(-1)
  scores = np.exp(kl.mean(1))
  return float(scores.mean()), float(scores.std())


def _fid_scipy(mu1, s1, mu2, s2, offset: float = 0.0) -> float:
  """FID of float32 moments in float64, ``scipy.linalg.sqrtm`` (of the
  covariances plus ``offset`` I, as the reference's test takes it)."""
  import scipy.linalg
  mu1, s1, mu2, s2 = (np.asarray(x.cpu(), np.float64)
                      for x in (mu1, s1, mu2, s2))
  eye = offset * np.eye(s1.shape[0])
  covmean = scipy.linalg.sqrtm((s1 + eye) @ (s2 + eye))
  check(np.all(np.isfinite(covmean)), "scipy sqrtm not finite")
  return float(np.sum((mu1 - mu2) ** 2) + np.trace(s1) + np.trace(s2)
               - 2 * np.trace(covmean.real))


def _fid_inner_eigvals(mu1, s1, mu2, s2) -> float:
  """FID by the reference's route for the trace: the eigenvalues of
  S1^1/2 S2 S1^1/2 (``wcgan_tpu/evaluation/metrics.py:84-94``), float32 on
  the card, at unit scale (unscaled, float32 ``eigvalsh`` does not converge
  on a random network's covariances). For comparison, not gated: the port
  sums the singular values of S2^1/2 S1^1/2."""
  with metrics.true_float32():
    half = metrics._sqrtm_eigh(s1)
    inner = half @ s2 @ half
    inner = 0.5 * (inner + inner.T)
    scale = metrics._pow2_scale(inner)
    w = torch.linalg.eigvalsh(inner / scale) * scale
    d = mu1 - mu2
    return float(d @ d + torch.trace(s1) + torch.trace(s2)
                 - 2.0 * torch.sqrt(torch.clamp(w, min=0.0)).sum())


def _eval_net_check(dev: torch.device):
  """InceptionV3 and preprocess on the card against the same module and
  weights on the CPU, float32, batch 8. Returns the card's network and its
  operations an image (2 x the multiply-adds of its convs and dense
  layer)."""
  net = inception_v3.init_params(0)
  net_dev = copy.deepcopy(net).to(dev)
  imgs = torch.from_numpy(np.random.default_rng(3).integers(
      0, 256, (8, 32, 32, 3), dtype=np.uint8))
  flops = []

  def count(m, _, out):
    """Multiply-adds x 2 of each conv and dense layer."""
    k = m.weight[0].numel()
    flops.append(2 * out.numel() * k)
  hooks = [m.register_forward_hook(count) for m in net.modules()
           if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
  with torch.no_grad(), metrics.true_float32():
    x_cpu = inception_v3.preprocess(imgs)
    x_dev = inception_v3.preprocess(imgs.to(dev))
    want = net(x_cpu)
    got = net_dev(x_dev)
  for h in hooks:
    h.remove()
  per_image = sum(flops) / imgs.shape[0]
  pre_err = float((x_dev.cpu() - x_cpu).abs().max())
  errs = [float((g.cpu() - w).abs().max() / w.abs().max())
          for g, w in zip(got, want)]
  check(pre_err <= EVAL_PRE_ATOL, ("preprocess", pre_err))
  check(max(errs) <= EVAL_NET_RTOL, ("Inception card vs CPU", errs))
  log("eval", f"InceptionV3 (random weights, seed 0) on {nvidia_smi()} "
      f"against the CPU, float32, TF32 off, batch 8 of 32x32 -> 299x299: "
      f"max rel err pool {errs[0]:.3e}, logits {errs[1]:.3e} (gate "
      f"{EVAL_NET_RTOL:g}); preprocess max|d| {pre_err:.3e} (gate "
      f"{EVAL_PRE_ATOL:g}); {per_image / 1e9:.4f} GFLOP an image, so at most "
      f"{FFMA_FLOPS / per_image:.1f} imgs/s in float32 (FFMA peak)")
  return net_dev, per_image


def phase_eval(dev: torch.device):
  """Scoring (slice 9) at the reference's defaults: 50,000 IS samples,
  10,000 FID samples, Inception batch 100.

  1. InceptionV3 and preprocess on the card against the CPU.
  2. IS and FID math on the card: the pool and probabilities of the first
     10,000 generated images and of 10,000 real ones; IS against numpy
     float64 (as is, and on the logits brought to a spread of 3), eigh
     FID against scipy's sqrtm in float64; on the reference's validation
     case both methods against scipy.
     The headline G (256x3, bf16, EMA 0.999) with ``kernel_eval=True``
     makes the images; the split path's images of the same z score
     within EVAL_K2_*_RTOL of K2's. The same images through TF32
     convolutions (the scorer's default): IS and FID against the same
     float64 yardsticks, with the same gates.
  3. One scorer call (``make_scorer``, TF32 convolutions) on that trainer
     from a cold standing cache: one generate, K1 112 (the standing
     recompute), K2 7 a forward (196 forwards), finite ``unverified_*``
     scores, its FID part 2's TF32 one, the log's wall clocks.
  4. The CLI: ``--score_every 1`` for 2 epochs (1,000 / 500 samples),
     then ``--phase test`` on the exported npz with scoring.
  Returns the K1 and K2 launches of the scorer call."""
  t_phase = time.perf_counter()
  net, per_image = _eval_net_check(dev)
  out_dir = os.path.join("build", "chip_smoke_eval")
  shutil.rmtree(out_dir, ignore_errors=True)
  args = cli_run.build_parser().parse_args(
      EVAL_ARGV + ["--output_dir", out_dir])
  split = cli_run.build_experiment(args)
  g_k = place(Generator(dataclasses.replace(split.state.g.cfg,
                                            kernel_eval=True),
                        torch.Generator().manual_seed(0)), dev)
  g_k.load_state_dict(split.state.g.state_dict())
  fused = Trainer(split.ds, dataclasses.replace(split.state, g=g_k),
                  split.gan_cfg, dataclasses.replace(split.cfg,
                                                     device_data=False))

  @torch.no_grad()
  def apply_fn(x, conv_tf32=False):
    with metrics.true_float32():
      torch.backends.cudnn.allow_tf32 = conv_tf32
      pool, logits = net(inception_v3.preprocess(x))
    return pool, torch.softmax(logits, dim=-1), logits

  def acts(images, conv_tf32=False):
    outs = [apply_fn(torch.from_numpy(images[i:i + EVAL_BATCH]).to(dev),
                     conv_tf32)
            for i in range(0, len(images), EVAL_BATCH)]
    return [torch.cat(o) for o in zip(*outs)]

  # 2. The math on the card, on the rows the scorer's FID takes (the first
  # EVAL_FID images of each generate call are the same), through K2 and
  # through the split path.
  t0 = time.perf_counter()
  fakes, reals = fused.generate(EVAL_FID), split.ds.real_sample(EVAL_FID)
  pool_f, probs, logits = acts(fakes)
  pool_r, _, _ = acts(reals)
  torch.cuda.synchronize()
  dt_acts = time.perf_counter() - t0
  pool_s, probs_s, _ = acts(split.generate(EVAL_FID))
  is_card = [float(v) for v in metrics.inception_score(probs)]
  is_ref = _is64(probs.cpu().numpy())
  # Random weights give near-uniform probabilities (IS ~1, its spread
  # below float32's spacing at 1), so the math is held on a confident
  # classifier too: the same logits, centred and brought to a spread of 3.
  sharp = torch.softmax(3.0 * (logits - logits.mean(0)) / logits.std(),
                        dim=-1)
  is_sharp = [float(v) for v in metrics.inception_score(sharp)]
  is_sharp_ref = _is64(sharp.cpu().numpy())
  check(_rel_err(is_card[0], is_ref[0]) <= EVAL_IS_RTOL
        and _rel_err(is_sharp[0], is_sharp_ref[0]) <= EVAL_IS_RTOL
        and abs(is_sharp[1] - is_sharp_ref[1])
        <= EVAL_IS_RTOL * is_sharp_ref[0],
        ("IS", is_card, is_ref, is_sharp, is_sharp_ref))
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  m_r = metrics.moments_from_activations(pool_r)
  m_f = metrics.moments_from_activations(pool_f)
  torch.cuda.synchronize()
  t1 = time.perf_counter()
  fid = metrics.fid_from_moments(*m_r, *m_f)
  t2 = time.perf_counter()
  fid_ns = metrics.fid_from_moments(*m_r, *m_f, method="ns")
  t3 = time.perf_counter()
  fid_ref = _fid_scipy(*m_r, *m_f)
  t4 = time.perf_counter()
  check(np.isfinite(fid) and _rel_err(fid, fid_ref) <= EVAL_FID_RTOL,
        ("FID vs scipy", fid, fid_ref))
  fid_inner = _fid_inner_eigvals(*m_r, *m_f)
  # ns on the reference's own validation case, on the card: rank-deficient
  # (120 and 150 rows in 256 dimensions), scales over 1e3. On the pool
  # moments above it is out of its envelope (reported, not gated): its
  # jitter, eps x the mean diagonal, adds ~sqrt(eps x mean diagonal) a
  # dimension to the square roots' traces, which outweighs the
  # geometric-mean trace of a random network's near-zero spectrum.
  rng = np.random.default_rng(7)
  scales = np.logspace(-1.5, 1.5, 256)
  a = (rng.standard_normal((120, 256)) * scales).astype(np.float32)
  b = (rng.standard_normal((150, 256)) * scales[::-1] + 0.5).astype(
      np.float32)
  v1, v2 = (metrics.moments_from_activations(torch.from_numpy(x).to(dev))
            for x in (a, b))
  v_ref = _fid_scipy(*v1, *v2, offset=1e-10)
  v_eigh = metrics.fid_from_moments(*v1, *v2)
  v_ns = metrics.fid_from_moments(*v1, *v2, method="ns", num_iters=40)
  check(_rel_err(v_eigh, v_ref) <= EVAL_FID_RTOL
        and _rel_err(v_ns, v_ref) <= EVAL_NS_RTOL,
        ("validation case", v_eigh, v_ns, v_ref))
  log("eval", f"{EVAL_FID:,} generated + {EVAL_FID:,} real images through "
      f"InceptionV3 at batch {EVAL_BATCH}: {dt_acts:.2f} s "
      f"({2 * EVAL_FID / dt_acts:.1f} imgs/s, with generate, host clock); IS "
      f"{is_card[0]:.9f} +- {is_card[1]:.3e} (numpy float64 "
      f"{is_ref[0]:.9f} +- {is_ref[1]:.3e}); logits at spread 3: "
      f"{is_sharp[0]:.6f} "
      f"+- {is_sharp[1]:.6f} (float64 {is_sharp_ref[0]:.6f} +- "
      f"{is_sharp_ref[1]:.6f}; gates: means rel {EVAL_IS_RTOL:g}, std "
      f"{EVAL_IS_RTOL:g} x the mean); FID eigh {fid:.6e}, scipy float64 "
      f"{fid_ref:.6e} (rel {_rel_err(fid, fid_ref):.2e}, gate "
      f"{EVAL_FID_RTOL:g}; the reference's route, eigenvalues of the inner "
      f"form, {fid_inner:.6e}, rel {_rel_err(fid_inner, fid_ref):.2e}), ns {fid_ns:.6e} (rel to eigh "
      f"{_rel_err(fid_ns, fid):.2e}, out of its envelope, not gated); the "
      f"reference's validation case (256-d, rank-deficient): eigh "
      f"{v_eigh:.6f}, ns(40) {v_ns:.6f}, scipy float64 {v_ref:.6f} (rel "
      f"{_rel_err(v_eigh, v_ref):.2e}, {_rel_err(v_ns, v_ref):.2e}; gates "
      f"{EVAL_FID_RTOL:g}, {EVAL_NS_RTOL:g}); on the card: "
      f"moments {1e3 * (t1 - t0):.1f} ms, eigh distance "
      f"{1e3 * (t2 - t1):.1f} ms, ns {1e3 * (t3 - t2):.1f} ms; scipy "
      f"{t4 - t3:.1f} s (host clock, {nvidia_smi()})")
  # The scorer's default, TF32 convolutions (its products and the math
  # true float32), on the same images: IS and FID against the float64
  # yardsticks of the float32 path's rows above, with the same gates.
  pool_t, probs_t, logits_t = acts(fakes, conv_tf32=True)
  pool_rt, _, _ = acts(reals, conv_tf32=True)
  is_t = float(metrics.inception_score(probs_t)[0])
  sharp_t = torch.softmax(3.0 * (logits_t - logits_t.mean(0)) / logits_t.std(),
                          dim=-1)
  is_sharp_t = float(metrics.inception_score(sharp_t)[0])
  fid_t = metrics.fid_from_moments(
      *metrics.moments_from_activations(pool_rt),
      *metrics.moments_from_activations(pool_t))
  pool_rel = float((pool_t - pool_f).abs().max() / pool_f.abs().max())
  check(_rel_err(is_t, is_ref[0]) <= EVAL_IS_RTOL
        and _rel_err(is_sharp_t, is_sharp_ref[0]) <= EVAL_IS_RTOL
        and np.isfinite(fid_t) and _rel_err(fid_t, fid_ref) <= EVAL_FID_RTOL,
        ("TF32 convolutions", is_t, is_ref[0], is_sharp_t, is_sharp_ref[0],
         fid_t, fid_ref))
  log("eval", f"TF32 convolutions (the scorer's default) on the same "
      f"images: pool {pool_rel:.2e} off the float32 path (max rel); IS "
      f"{is_t:.9f} (rel {_rel_err(is_t, is_ref[0]):.2e} to float64), at "
      f"spread 3 {is_sharp_t:.6f} (rel "
      f"{_rel_err(is_sharp_t, is_sharp_ref[0]):.2e}; gate "
      f"{EVAL_IS_RTOL:g}); FID {fid_t:.6e} (rel "
      f"{_rel_err(fid_t, fid_ref):.2e} to scipy float64; gate "
      f"{EVAL_FID_RTOL:g})")
  del pool_t, probs_t, logits_t, pool_rt, sharp_t
  is_split = float(metrics.inception_score(probs_s)[0])
  fid_split = metrics.fid_from_moments(
      *m_r, *metrics.moments_from_activations(pool_s))
  check(_rel_err(is_split, is_card[0]) <= EVAL_K2_IS_RTOL
        and _rel_err(fid_split, fid) <= EVAL_K2_FID_RTOL,
        ("K2 vs split scores", is_card[0], is_split, fid, fid_split))
  log("eval", f"the split path's images ({EVAL_FID:,}, the same z): IS "
      f"{is_split:.9f}, FID {fid_split:.6e}; relative to K2's "
      f"{_rel_err(is_split, is_card[0]):.2e} and {_rel_err(fid_split, fid):.2e} "
      f"(gates {EVAL_K2_IS_RTOL:g}, {EVAL_K2_FID_RTOL:g})")
  del pool_f, probs, logits, pool_r, sharp, pool_s, probs_s

  # 3. One scorer call (its default TF32 convolutions), counted, from a
  # cold standing cache.
  scorer = scorer_lib.make_scorer(split.ds, samples_inception=EVAL_IS,
                                  samples_fid=EVAL_FID, batch=EVAL_BATCH)
  calls, lines = [], []
  fused.logger.line = lines.append
  gen = fused.generate

  def counted(n, *a, **kw):
    calls.append(n)
    return gen(n, *a, **kw)
  fused.generate = counted
  fused._standing_cache = None
  torch.cuda.synchronize()
  cuda_wc.MOMENTS_LAUNCHES = 0
  cuda_wc.WC_APPLY_LAUNCHES = 0
  t0 = time.perf_counter()
  scores = scorer(fused)
  dt_k2 = time.perf_counter() - t0
  k1, k2 = cuda_wc.MOMENTS_LAUNCHES, cuda_wc.WC_APPLY_LAUNCHES
  log_k2 = list(lines)
  check(calls == [EVAL_IS], ("generate calls", calls))
  check(k1 == 7 * 16 and k2 == 7 * EVAL_FORWARDS, ("K1, K2", k1, k2))
  keys = ("unverified_inception_score", "unverified_is_std",
          "unverified_fid")
  # Its FID is part 2's TF32 one on the same rows (the pool piggybacked
  # on IS).
  check(sorted(scores) == sorted(keys)
        and all(np.isfinite(v) for v in scores.values())
        and _rel_err(scores[keys[2]], fid_t) <= 1e-4, (scores, fid_t))
  times = [float(v) for v in re.findall(r"([\d.]+)s", " ".join(log_k2))]
  log("eval", f"scorer({EVAL_IS:,} IS / {EVAL_FID:,} FID samples, batch "
      f"{EVAL_BATCH}) on the headline G 256x3 bf16, EMA 0.999, kernel_eval="
      f"True, on {nvidia_smi()}: {dt_k2:.2f} s, one generate call, K1 {k1} "
      f"(one cold standing recompute), K2 {k2} ({EVAL_FORWARDS} forwards x "
      f"7); {scores}; the log: " + " | ".join(log_k2))
  if len(times) == 4:
    gen_s, inc_s, real_s, dist_s = times
    log("eval", f"wall time split: generate {gen_s:.3f} s, Inception + IS "
        f"{inc_s:.3f} s ({EVAL_IS / inc_s:.1f} imgs/s at batch "
        f"{EVAL_BATCH}, {EVAL_IS * per_image / FFMA_FLOPS / inc_s:.1%} of "
        f"the float32 bound), real moments {real_s:.3f} s ({EVAL_FID / real_s:.1f} "
        f"imgs/s), fake moments + eigh distance {dist_s:.3f} s")

  # 4. The CLI, in this process (cli_run.main, as the presets phase runs
  # it): a new interpreter would cost ~20 s each, the training CLI runs
  # above already start ones.
  cli_dir = os.path.join("build", "chip_smoke_eval_cli")
  shutil.rmtree(cli_dir, ignore_errors=True)
  scoring = ["--compute_inception_score", "1", "--compute_fid", "1",
             "--samples_inception", str(EVAL_CLI_IS), "--samples_fid",
             str(EVAL_CLI_FID)]
  ckpt = os.path.join(cli_dir, "ckpt")
  cmd, dt_cli, lines = _main_cli(
      scoring + ["--score_every", "1", "--number_of_epochs", "2",
                 "--batches_per_epoch", "2", "--steps_per_call", "2",
                 "--checkpoint_ratio", "2", "--checkpoints_dir", ckpt],
      cli_dir)
  scored = [l for l in lines if l.startswith("Epoch ") and keys[2] in l]
  with open(os.path.join(cli_dir, "smoke", "metrics.jsonl")) as f:
    records = [r for r in map(json.loads, f) if keys[0] in r]
  check([l.split(":")[0] for l in scored] == ["Epoch 0", "Epoch 1"]
        and [r["epoch"] for r in records] == [0, 1]
        and all(np.isfinite(r[k]) for r in records for k in keys),
        (scored, records))
  log("eval-cli", f"{' '.join(cmd)}: rc 0 in {dt_cli:.1f} s; "
      + " | ".join(scored))
  npz = os.path.join(ckpt, "smoke", "epoch_1_generator.npz")
  test_dir = os.path.join("build", "chip_smoke_eval_test")
  shutil.rmtree(test_dir, ignore_errors=True)
  cmd, dt_test, lines = _main_cli(
      scoring + ["--phase", "test", "--generator_checkpoint", npz], test_dir)
  check(any("wrote sample grid" in l for l in lines)
        and all(k + " = " in lines[-1] for k in keys), lines[-3:])
  log("eval-cli", f"{' '.join(cmd)}: rc 0 in {dt_test:.1f} s; "
      f"{lines[-1]}")
  log("eval", f"phase {time.perf_counter() - t_phase:.1f} s")
  return k1, k2


# BASELINE config 5 (preset imagenet64_cwc_dp) on one card: 2 ranks over
# gloo, 64 images a rank (a global batch of 128 in place of 512), synthetic
# data of imagenet64's shape and 1,000 classes.
DP_RANKS, DP_B = 2, 64
DP_DEVICES = ["cuda:0"] * DP_RANKS
DP_SYNTHETIC = {"resolution": 64, "classes": 1000, "n": 1024, "seed": 0}
DP_OUT = os.path.join("build", "chip_smoke_dp")
DP_ARGV = ["--preset", "imagenet64_cwc_dp", "--dataset", "synthetic",
           "--batch_size", str(DP_RANKS * DP_B), "--mesh", str(DP_RANKS),
           "--batches_per_epoch", "3", "--steps_per_call", "3",
           "--display_ratio", "0", "--checkpoint_ratio", "0",
           "--output_dir", DP_OUT, "--name", "dp"]


def _dp_cfgs(dtype: str, use_kernel=None):
  """Config 5's models: the cWC-sa G (512, 256, 128, 64) at 64x64 and the
  projection-D (64, ..., 1024), 1,000 classes, hinge, ratio 5."""
  g, d, gan, _, res = _cond_cfgs("cwcsa", dtype, use_kernel)
  return (dataclasses.replace(g, num_classes=1000),
          dataclasses.replace(d, num_classes=1000),
          dataclasses.replace(gan, num_classes=1000), res)


def _split(a: torch.Tensor, axis: int):
  """``a`` cut into the ranks' contiguous blocks along ``axis``, numpy."""
  return [c.cpu().numpy() for c in torch.chunk(a, DP_RANKS, dim=axis)]


def phase_dp(dev: torch.device):
  """Data parallelism on the one card: two ranks over gloo, CUDA tensors.

  1. Config 5 through the CLI's experiment: one epoch of 3 outer steps to
     warm up, then one call of the trainer's dataset chain of 3, counted:
     K1 launches a rank and a step (the single-process count), all-reduce
     calls and bytes a step (moments and gradients), wall time a step
     (two ranks on one card: not a scaling number), the state bit-equal
     on both ranks.
  2. float32 at full width, deterministic kernels: the global-batch G
     forward (ranks' images against one process on the 128, within 2e-5
     or twice that process's own spread under a reordered batch); one
     outer step on the ranks (K1 route, and plain route) against one
     process on the global batch with the same draws, within STEP_RTOL or
     twice the reordered step's spread; the two routes against each
     other likewise.
  3. ``dryrun_multichip`` on the two ranks.
  4. ``--mesh 1 --device cuda`` through the CLI: a one-rank NCCL group
     (G and D 64 wide), one epoch with a checkpoint, then ``--resume
     auto``.
  Returns K1's launches on both ranks in the counted steps."""
  torch.cuda.empty_cache()      # the ranks share this card
  shutil.rmtree(DP_OUT, ignore_errors=True)
  t0 = time.perf_counter()
  ranks = launch.launch("wcgan_tpu_torch.parallel.dryrun:trainer_rank",
                        DP_DEVICES, (DP_ARGV, DP_SYNTHETIC), timeout=600)
  dt_job = time.perf_counter() - t0
  r0, steps = ranks[0], ranks[0]["steps"]
  for r in range(1, DP_RANKS):
    _bit_equal(r0["state"], ranks[r]["state"], f"dp rank {r}")
  where = (f"{DP_RANKS} ranks on {len(set(DP_DEVICES))} card(s) over "
           f"{mesh.backend_for([torch.device(d) for d in DP_DEVICES])}")
  check(r0["state"]["step"] == 2 * steps and all(
      np.isfinite(v) for v in r0["metrics"].values()), r0["metrics"])
  per = {k: (r0["calls"].get(k, 0) / steps, r0["bytes"].get(k, 0) / steps)
         for k in ("moments", "grads")}
  log("dp", f"config 5 (cWC-sa G 512..64 at 64x64, 1,000 classes, "
      f"projection-D 64..1024, hinge, bf16, ratio 5) on {where}, {DP_B} "
      f"images a rank: a chain of {steps} outer steps after a warm-up "
      f"epoch, {r0['seconds'] / steps * 1e3:.1f} ms a step (host clock; "
      f"not a scaling number where ranks share a card) on "
      f"{nvidia_smi()}; K1 a rank a step "
      f"{[r['k1'] / steps for r in ranks]}; all-reduce a step: moments "
      f"{per['moments'][0]:.0f} calls {per['moments'][1] / 2**20:.2f} MiB, "
      f"gradients and losses {per['grads'][0]:.0f} calls "
      f"{per['grads'][1] / 2**20:.2f} MiB; {len(r0['state']['g'])} + "
      f"{len(r0['state']['d'])} tensors of G and D, Adam and schedules "
      f"bit-equal on all ranks; metrics {r0['metrics']}; job "
      f"{dt_job:.1f} s")

  # float32 at full width against one process on the global batch.
  g_k, d_k, gan, res = _dp_cfgs("float32")
  g_p, d_p, _, _ = _dp_cfgs("float32", use_kernel=False)
  gb = DP_RANKS * DP_B
  real, labels, noise = _cond_inputs(dev, gan, gb, res, seed=21)
  axes = {"z_g": 0, "y_g": 0}
  cut = {k: _split(v, axes.get(k, 1)) for k, v in noise.items()}
  noises = [{k: cut[k][r] for k in cut} for r in range(DP_RANKS)]
  z = torch.randn((gb, gan.z_dim), generator=torch.Generator().manual_seed(
      5)).numpy()
  y = np.arange(gb, dtype=np.int64) % gan.num_classes
  g_weights = Generator(g_k, torch.Generator().manual_seed(6)).state_dict()
  real_np, labels_np = real.cpu().numpy(), labels.cpu().numpy()
  t0 = time.perf_counter()
  fwd, dp_k, dp_p = list(zip(*launch.launch(
      "wcgan_tpu_torch.parallel.dryrun:batch_rank", DP_DEVICES, ([
          ("deterministic_rank", ()),
          ("forward_rank", (g_k, g_weights, z, y, True)),
          ("step_rank", (g_k, d_k, gan, None, [real_np], [labels_np],
                         [noises], 3)),
          ("step_rank", (g_p, d_p, gan, None, [real_np], [labels_np],
                         [noises], 3))],), timeout=600)))[1:]
  dt_job = time.perf_counter() - t0
  out = np.concatenate([f["out"] for f in fwd])
  f_dev = float(np.max(np.abs(out - fwd[0]["reference"])))
  f_spread = float(np.max(np.abs(fwd[0]["reordered"] - fwd[0]["reference"])))
  check(f_dev <= max(2e-5, 2 * f_spread), ("dp forward", f_dev, f_spread))
  one = []
  with _deterministic():
    for reorder in (False, True):
      st = create_state(g_k, d_k, OptimConfig(), gan.training_ratio, dev,
                        seed=3)
      inputs = (real, labels, noise)
      if reorder:
        g = torch.Generator(device=dev).manual_seed(14)
        inputs = _permuted(torch.randperm(gb, generator=g, device=dev),
                           torch.randperm(2 * gb, generator=g, device=dev),
                           *inputs)
      torch.cuda.synchronize()
      cuda_wc.MOMENTS_LAUNCHES = 0
      m = make_outer_step(gan)(st, *inputs[:2], noise=inputs[2])
      one.append(({k: float(v) for k, v in m.items()},
                  cuda_wc.MOMENTS_LAUNCHES))
      del st
  (m_1, n_single), (m_r, _) = one
  check(all(r["k1"] == steps * n_single for r in ranks),
        ("K1 a rank a step", [r["k1"] for r in ranks], n_single))
  spread = _rel(m_r, m_1)
  m_k, m_p = dp_k[0]["metrics"][0], dp_p[0]["metrics"][0]
  for name, got, want in (("K1 route vs one process", m_k, m_1),
                          ("plain route vs one process", m_p, m_1),
                          ("K1 route vs plain route", m_k, m_p)):
    rel = _rel(got, want)
    for k in want:
      check(np.isfinite(got[k]) and rel[k] <= max(STEP_RTOL, 2 * spread[k]),
            ("dp step", name, k, got[k], want[k], spread[k]))
    log("dp-f32", f"{name}: relative metric differences "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
  for dp in (dp_k, dp_p):
    for r in range(1, DP_RANKS):
      _bit_equal(dp[0]["state"], dp[r]["state"], f"dp float32 rank {r}")
  log("dp-f32", f"one process vs the same on the reordered batch (the "
      f"gate's spread): " + ", ".join(f"{k} {v:.2e}" for k, v in
                                      spread.items())
      + f"; K1 {n_single} a step on one process; global-batch G forward "
      f"(float32, {gb} images): max|ranks - one process| {f_dev:.3e}, "
      f"reordered spread {f_spread:.3e}, gate "
      f"{max(2e-5, 2 * f_spread):.3e}; job {dt_job:.1f} s")

  t0 = time.perf_counter()
  report = dryrun.dryrun_multichip(devices=DP_DEVICES, timeout=600)
  log("dp-dryrun", f"dryrun_multichip on {where}, "
      f"{time.perf_counter() - t0:.1f} s: " + " | ".join(
          f"[{k}] metrics {v['metrics']}, max|d| {v['max_dev']} (gates "
          f"{v['gate']})" for k, v in report.items()))

  out_dir = os.path.join("build", "chip_smoke_mesh1")
  shutil.rmtree(out_dir, ignore_errors=True)
  base = ["--mesh", "1", "--batches_per_epoch", "1", "--steps_per_call",
          "1", "--checkpoint_ratio", "1", "--generator_filters", "64,64,64",
          "--discriminator_filters", "64,64,64,64", "--checkpoints_dir",
          os.path.join(out_dir, "ckpt")]
  cmd, dt1, lines = _run_cli(base + ["--number_of_epochs", "1"], out_dir)
  check(any("rank 0 of 1 (nccl)" in l for l in lines)
        and any("the outer step runs compiled under --mesh (nccl" in l
                for l in lines), lines)
  cmd, dt2, lines = _run_cli(base + ["--number_of_epochs", "2", "--resume",
                                     "auto"], out_dir)
  ckpt = os.path.join(out_dir, "ckpt", "smoke")
  check(any("(start_epoch 1)" in l for l in lines)
        and [l.split(":")[0] for l in lines if l.startswith("Epoch ")]
        == ["Epoch 0", "Epoch 1"]
        and all(os.path.isfile(os.path.join(ckpt, f"epoch_{i}", CKPT_FILE))
                for i in (0, 1)), lines)
  log("dp-mesh1", f"{' '.join(cmd[1:])}: a one-rank NCCL group running "
      f"the compiled chain, rc 0 in "
      f"{dt1:.1f} s, then --resume auto in {dt2:.1f} s; "
      + "; ".join(l for l in lines if l.startswith(("resumed", "Epoch 1"))))
  _dp_eval(dev)
  return sum(r["k1"] for r in ranks)


# The sharded scorer: the headline G (bf16, no EMA: --mesh refuses EMA
# standing statistics) under --mesh 2 with 2,048 IS / 1,024 FID samples.
DP_EVAL_ARGV = ["--device", "cuda", "--dataset", "synthetic", "--arch", "res",
                "--bf16", "--mesh", str(DP_RANKS), "--compute_inception_score",
                "1", "--compute_fid", "1", "--samples_inception", "2048",
                "--samples_fid", "1024", "--output_dir",
                os.path.join("build", "chip_smoke_dp_eval"), "--name", "dp"]
DP_EVAL_SYNTHETIC = {"resolution": 32, "classes": 10, "n": 2048, "seed": 0}
DP_EVAL_RTOL = 1e-4


def _fid64_rows(real: torch.Tensor, fake: torch.Tensor) -> float:
  """The eigh FID of two sets of pool rows in float64 (numpy)."""
  x, y = (a.double().cpu().numpy() for a in (real, fake))
  s1, s2 = np.cov(x, rowvar=False), np.cov(y, rowvar=False)
  w, v = np.linalg.eigh(s1)
  half = (v * np.sqrt(np.clip(w, 0, None))) @ v.T
  w = np.linalg.eigvalsh(half @ s2 @ half)
  return float(np.sum((x.mean(0) - y.mean(0)) ** 2) + np.trace(s1)
               + np.trace(s2) - 2 * np.sum(np.sqrt(np.clip(w, 0, None))))


def _dp_eval(dev: torch.device) -> None:
  """The CLI's scorer on 2 ranks sharing the card over gloo (each runs
  InceptionV3 on its 1,024 of the 2,048 images; the rows are gathered)
  against one process: IS within DP_EVAL_RTOL; FID within DP_EVAL_RTOL or,
  where float32 loses more (1,024 rows in 2,048 dimensions are
  rank-deficient), within one process's own distance from the float64 FID
  of its rows."""
  torch.cuda.empty_cache()
  n_is, n_fid = (int(DP_EVAL_ARGV[DP_EVAL_ARGV.index(f) + 1])
                 for f in ("--samples_inception", "--samples_fid"))
  t0 = time.perf_counter()
  ranks = launch.launch("wcgan_tpu_torch.parallel.dryrun:scorer_rank",
                        DP_DEVICES, (DP_EVAL_ARGV, DP_EVAL_SYNTHETIC),
                        timeout=600)
  dt_job = time.perf_counter() - t0
  ctx = launch.RankContext(None, 0, 1, dev)
  one = dryrun.scorer_rank(ctx, DP_EVAL_ARGV, DP_EVAL_SYNTHETIC)
  trainer = dryrun._experiment(ctx, DP_EVAL_ARGV, DP_EVAL_SYNTHETIC)
  net = inception_v3.init_params().to(dev)

  @torch.no_grad()
  def apply_fn(x):
    with metrics.true_float32():
      return net(inception_v3.preprocess(x))

  cut = dict(batch=EVAL_BATCH, device=dev, want_probs=False)
  fake, _ = scorer_lib._activations(apply_fn, trainer.generate(n_fid),
                                    **cut)
  real, _ = scorer_lib._activations(apply_fn,
                                    trainer.ds.real_sample(n_fid), **cut)
  fid64 = _fid64_rows(real, fake)
  want = one["scores"]
  gate = max(DP_EVAL_RTOL * want["unverified_fid"],
             abs(want["unverified_fid"] - fid64))
  for r in ranks:
    got = r["scores"]
    check(sorted(got) == sorted(want)
          and _rel_err(got["unverified_inception_score"],
                   want["unverified_inception_score"]) <= DP_EVAL_RTOL
          and abs(got["unverified_fid"] - want["unverified_fid"]) <= gate
          and r["calls"] == {"rows": 3}, ("dp scorer", got, want, gate,
                                         r["calls"]))
  rel = {k: _rel_err(ranks[0]["scores"][k], v) for k, v in want.items()}
  log("dp-eval", f"the CLI's scorer ({n_is:,} IS / {n_fid:,} FID samples) "
      f"on {DP_RANKS} ranks sharing the card over gloo, {dt_job:.1f} s with "
      f"the ranks' start ({ranks[0]['seconds']:.2f} s the call on rank 0), "
      f"one process {one['seconds']:.2f} s (host clock, {nvidia_smi()}): "
      f"ranks {ranks[0]['scores']}, one process {want}; relative "
      + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
      + f"; FID float64 of one process's rows {fid64:.6e}, gate "
      f"{gate:.3e}; all-gathers a rank {ranks[0]['calls']}, "
      f"{ranks[0]['bytes'].get('rows', 0) / 2**20:.2f} MiB")


# The digits phase (slice 10): the README's conditional digits run
# (tools/digits_quality.py: G (128, 128) cWC ucconv at 16x16, projection-D,
# hinge, bf16, batch 64, 5 outer steps an epoch) through the CLI at full
# width, cut from 300 epochs to DIGITS_EPOCHS, a checkpoint every 25; then
# both quality tools on its checkpoints. At 50 epochs the fidelity was
# 0.253 on an H100 (PERF.md §6), under the gate: the class
# conditioning comes after the digits' shapes (FID 24.8 at epoch 49, 1.9
# at 99 in a 300-epoch run).
DIGITS_EPOCHS = 100
DIGITS_K1_PER_STEP = 30     # 5 WC layers x 6 train-mode G forwards
DIGITS_JUDGE_ACC = 0.90     # the judge's training accuracy (reference 0.941)
DIGITS_FIDELITY = 0.30      # three times chance


def phase_digits() -> int:
  """The digits data without sklearn, a conditional digits run on it
  through the CLI, K1 counted, and its judges: the feature judge's
  accuracy, its calibration (floor below ceiling, real IS above noise),
  feature-FID at the last checkpoint below the first's and below half the
  noise ceiling, and the conditional fidelity of the last checkpoint.
  Returns K1's launches."""
  t_phase = time.perf_counter()
  out_dir = os.path.join("build", "chip_smoke_digits")
  shutil.rmtree(out_dir, ignore_errors=True)
  # The card's machine has no sklearn. While this entry stands an import
  # of sklearn raises, so the phase fails on any machine if the digits
  # path imports it.
  saved = sys.modules.get("sklearn")
  sys.modules["sklearn"] = None
  try:
    ds = get_dataset("digits", batch_size=64, conditional=True)
    check(ds.images.shape == (1797, 16, 16, 1) and ds.num_classes == 10,
          ds.images.shape)
    res = digits_quality.train_and_judge(
        "PROJECTIVE", DIGITS_EPOCHS, out_dir, "cuda",
        emit=lambda l: log("digits", l))
  finally:
    if saved is None:
      del sys.modules["sklearn"]
    else:
      sys.modules["sklearn"] = saved
  steps = DIGITS_EPOCHS * digits_quality.STEPS_PER_EPOCH
  check(res["k1_launches"] == DIGITS_K1_PER_STEP * steps,
        (res["k1_launches"], steps))
  fid, fidelity = res["fid"], res["fidelity"]
  traj = {ep: (f, i) for ep, f, i, _ in fid["trajectory"]}
  first, last = 24, DIGITS_EPOCHS - 1
  check(sorted(traj) == list(range(first, DIGITS_EPOCHS, 25)), sorted(traj))
  check(fid["judge_accuracy"] >= DIGITS_JUDGE_ACC, fid["judge_accuracy"])
  check(fid["floor"] < fid["ceiling"] and fid["is_real"] > fid["is_noise"],
        fid)
  check(traj[last][0] < traj[first][0]
        and traj[last][0] < 0.5 * fid["ceiling"], traj)
  check(fidelity["fidelity"] >= DIGITS_FIDELITY, fidelity)
  log("digits", f"python -m wcgan_tpu_torch --dataset digits --gan_type "
      f"PROJECTIVE ... --bf16 cut to {DIGITS_EPOCHS} of 300 epochs "
      f"({steps} outer steps) on {nvidia_smi()}: {res['wall_s']:.1f} s with "
      f"the process's warm-up (median epoch "
      f"{float(np.median(res['epoch_seconds'])):.3f} s); K1 "
      f"{res['k1_launches']} ({DIGITS_K1_PER_STEP} a step); judge accuracy "
      f"{fid['judge_accuracy']:.3f}; FID floor {fid['floor']:.3f} ceiling "
      f"{fid['ceiling']:.3f}; feature-FID by epoch "
      + ", ".join(f"{ep} {v[0]:.3f}" for ep, v in sorted(traj.items()))
      + f"; IS-analog {traj[first][1]:.3f} -> {traj[last][1]:.3f} "
      f"(real {fid['is_real']:.3f}, noise {fid['is_noise']:.3f}); fidelity "
      f"{fidelity['fidelity']:.3f}; tools {res['fid_wall_s']:.1f} s + "
      f"{res['fidelity_wall_s']:.1f} s; phase "
      f"{time.perf_counter() - t_phase:.1f} s")
  return res["k1_launches"]


# --- slice 14: --whitening_precision high (K3, bf16x3) ------------------------

HIGH_CC = (64, 128, 256, 512)        # C x C x C: Newton-Schulz, the bias
HIGH_RC = (1024, 16384, 131072)      # R x 256 x 256: K1's backward, float32
                                     # whiten_apply rows
HIGH_LAYOUTS = ("nn", "nt", "tn")    # as given / transposed, A then B
HIGH_ROWS_MIN = 16384                # from here R x 256 x 256 takes K3's
                                     # row path (wgmma, TMA); below, and
                                     # every C x C product, split-K
# K3 against its plain version, per element: both sum the same bf16
# products (each exact in float32) in float32, in another order, so they
# agree within a few float32 ulps of (|A| |B|)_ij; the tensor core's
# truncated sums inside a 32-deep K tile stay within the same few.
HIGH_ULPS = 16
EPS32 = 2.0 ** -23
HIGH_RESID = 1e-3      # the whitening residual under 'high' on the
                       # headline's covariances (C = 256; the JAX package's
                       # HIGH floor on its TPU: 6.1e-4; the trainer's
                       # threshold 1e-2). At conditioning 1e3 the jitter
                       # (eps x mean diagonal against the least eigenvalue)
                       # sets a floor of ~1.2e-3 under either precision:
                       # there 'high' may add at most HIGH_RESID to
                       # 'highest''s.
HIGH_PROBE_STEPS = 4   # captured steps between the two residual probes
# K3's launches in one headline outer step under 'high' (counted on the
# CPU through the plain version with K1's route forced: the count does not
# depend on the widths): 7 WC layers x 45 Newton-Schulz products in each
# of the 6 train-mode G forwards (1,890), and in the G update's backward
# 86 transposed products a layer (none where an operand is the constant I
# or the last Y, which W does not read) and K1's row product (602).
HIGH_K3_PER_STEP = 2499
HIGH_TIME_STEPS, HIGH_TIME_ROUNDS = 5, 3


def _high_operands(m, k, n, layout, gen, dev):
  """(A (m, k), B (k, n)), each a transposed view of a contiguous tensor
  where ``layout`` says 't'."""
  a = torch.randn((m, k) if layout[0] == "n" else (k, m), generator=gen,
                  device=dev)
  b = torch.randn((k, n) if layout[1] == "n" else (n, k), generator=gen,
                  device=dev)
  return (a if layout[0] == "n" else a.T), (b if layout[1] == "n" else b.T)


def _pieces_f64(a, b) -> torch.Tensor:
  """The bf16x3 sum of (a, b)'s pieces in float64: what both K3 and its
  plain version round."""
  (a_hi, a_lo), (b_hi, b_lo) = (
      [p.double() for p in mm_bf16x3.split_bf16(t)] for t in (a, b))
  return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _high_held(a, b):
  """K3 on (a, b) held against its plain version within HIGH_ULPS float32
  ulps of (|A| |B|)_ij, bitwise repeatable; where K >= 65,536 against the
  float64 sum of the same pieces instead, as K1 is held at such R: there
  the plain version's own float32 sums drift (its distance is printed).
  Returns (K3's largest |d|, the largest share of the gate it takes, its
  output, the plain version's share where float64 was the yardstick)."""
  got = mm_bf16x3.mm_bf16x3_cuda(a, b)
  again = mm_bf16x3.mm_bf16x3_cuda(a, b)
  plain = mm_bf16x3.mm_bf16x3_reference(a, b)
  gate = HIGH_ULPS * EPS32 * (a.abs() @ b.abs())
  plain_share = None
  if a.shape[1] >= 65536:
    want = _pieces_f64(a, b)
    plain_share = float(((plain.double() - want).abs() / gate).max())
  else:
    want = plain
  d = (got.double() - want.double()).abs()
  share = float((d / gate).max())
  check(torch.equal(got, again) and share <= 1.0,
        ("K3 against plain", tuple(a.shape), tuple(b.shape), a.stride(),
         b.stride(), share, plain_share, torch.equal(got, again)))
  return float(d.max()), share, got, plain_share


def _high_parity(dev: torch.device) -> float:
  """K3 against its plain version at the path's shapes in three layouts,
  and at the plain covariance's (C x R x C); K3 and a float32 product
  against float64; a non-finite input. Returns K3's largest |d|."""
  gen = torch.Generator(device=dev).manual_seed(14)
  worst, share_max, f64, paths = 0.0, 0.0, [], {}
  shapes = [(c, c, c) for c in HIGH_CC] + [(r, C, C) for r in HIGH_RC]
  for m, k, n in shapes:
    for layout in HIGH_LAYOUTS:
      a, b = _high_operands(m, k, n, layout, gen, dev)
      path = mm_bf16x3.plan(a, b)
      check(path[0] == ("rows" if m >= HIGH_ROWS_MIN else "split-k"),
            ("K3 path", m, k, n, layout, path))
      paths[f"{m}x{k}x{n}"] = path
      err, share, got, _ = _high_held(a, b)
      worst, share_max = max(worst, err), max(share_max, share)
      if layout == "nn":
        exact = a.double() @ b.double()
        scale = float((a.abs() @ b.abs()).max())
        e_k3 = float((got.double() - exact).abs().max()) / scale
        e_f32 = float(((a @ b).double() - exact).abs().max()) / scale
        check(e_f32 < e_k3 < 2.0 ** -14, ("K3 against float64", m, k, n,
                                           e_k3, e_f32))
        f64.append(f"{m}x{k}x{n} {e_k3:.2e}/{e_f32:.2e}")
      del a, b, got
  x = torch.randn((HIGH_RC[-1], C), generator=gen, device=dev)
  err, share, _, cov_plain = _high_held(x.T, x)
  worst, share_max = max(worst, err), max(share_max, share)
  del x
  # Rows off a 16-byte boundary: K3's element-by-element copies (the row
  # path's TMA needs aligned rows: such a tall product takes split-K);
  # the bias's vector (M = 1).
  base = torch.randn((C, C + 1), generator=gen, device=dev)
  tall = torch.randn((HIGH_RC[1], C + 1), generator=gen, device=dev)
  w = torch.randn((C, C), generator=gen, device=dev)
  for a, b in ((base[:, 1:], base[:, 1:].T), (base[:, 1:].T, base[:, 1:]),
               (tall[:, 1:], w), (base[:1, 1:], w.T)):
    err, share, _, _ = _high_held(a, b)
    worst, share_max = max(worst, err), max(share_max, share)
  check(mm_bf16x3.plan(tall[:, 1:], w)[0] == "split-k",
        mm_bf16x3.plan(tall[:, 1:], w))
  del tall
  a, b = _high_operands(C, C, C, "nn", gen, dev)
  a[3, 5], a[7, 1], b[9, 2] = float("inf"), float("nan"), float("-inf")
  got, ref = mm_bf16x3.mm_bf16x3_cuda(a, b), a @ b
  check(torch.equal(torch.isfinite(got), torch.isfinite(ref)),
        "K3 non-finite pattern differs from float32's")
  torch.cuda.synchronize()
  log("high", f"K3's paths (path, tile or column slice, CTAs a cluster): "
      + "; ".join(f"{k} {v}" for k, v in paths.items()))
  log("high", f"K3 against its plain version at C x C x C (C = "
      f"{', '.join(map(str, HIGH_CC))}) and R x {C} x {C} (R = "
      f"{', '.join(f'{r:,}' for r in HIGH_RC)}), layouts "
      f"{'/'.join(HIGH_LAYOUTS)}, and {C} x {HIGH_RC[-1]:,} x {C} (x^T x, "
      f"against the float64 sum of the pieces: K3 {share:.3f} of the gate, "
      f"the plain version {cov_plain:.3f}): max|d| "
      f"{worst:.3e}, at most {share_max:.3f} of the gate ({HIGH_ULPS} "
      f"float32 ulps of (|A||B|)_ij), offset views and M = 1 too; two calls "
      f"bitwise "
      f"equal; against "
      f"float64, max|d| / max(|A||B|), K3 / float32 (TF32 off): "
      + ", ".join(f64) + "; inf/nan inputs: non-finite where float32's is")
  return worst


def _ns_step(y, z, fused: bool):
  """One Newton-Schulz iteration under 'high': T by K3's epilogue
  (fused) or as K3's product followed by 1.5 I - 0.5 P (three
  elementwise launches)."""
  if fused:
    t = mm_bf16x3.mm_bf16x3_cuda(z, y, -0.5, 1.5)
  else:
    ident = torch.eye(z.shape[0], device=z.device)
    t = 1.5 * ident - 0.5 * mm_bf16x3.mm_bf16x3_cuda(z, y)
  return mm_bf16x3.mm_bf16x3_cuda(y, t), mm_bf16x3.mm_bf16x3_cuda(t, z)


def _ns_step_f32(y, z):
  """The same iteration under 'highest' (torch.matmul, TF32 off)."""
  t = 1.5 * torch.eye(z.shape[0], device=z.device) - 0.5 * (z @ y)
  return y @ t, t @ z


def _high_fused(dev: torch.device) -> None:
  """K3's epilogue against the unfused expression, bitwise: T = 1.5 I -
  0.5 Z Y at every C x C shape (random Z, Y; I and an SPD Y, the first
  iteration's operands), 15 iterations of the fused and the unfused loop
  from one SPD matrix, and the autograd function's first and second
  derivatives at C = 256 (alpha in the backward's epilogue)."""
  gen = torch.Generator(device=dev).manual_seed(18)
  for c in HIGH_CC:
    z, y = _high_operands(c, c, c, "nn", gen, dev)
    ident = torch.eye(c, device=dev)
    spd = _k2_inputs(4 * c, c, gen, dev)[2]
    spd = spd / torch.trace(spd)
    for a, b in ((z, y), (ident, spd)):
      want = 1.5 * ident - 0.5 * mm_bf16x3.mm_bf16x3_cuda(a, b)
      got = mm_bf16x3.mm_bf16x3_cuda(a, b, -0.5, 1.5)
      check(torch.equal(got, want), ("fused T", c))
    yz = [(spd, ident), (spd, ident)]
    for _ in range(15):
      yz = [_ns_step(*yz[0], True), _ns_step(*yz[1], False)]
    check(torch.equal(yz[0][0], yz[1][0]) and torch.equal(yz[0][1], yz[1][1]),
          ("15 fused iterations", c))
  z0, y0 = _high_operands(C, C, C, "nn", gen, dev)
  probe, probe2 = (torch.randn((C, C), generator=gen, device=dev)
                   for _ in range(2))
  ident = torch.eye(C, device=dev)
  results = []
  for fused in (True, False):
    z = z0.clone().requires_grad_(True)
    y = y0.clone().requires_grad_(True)
    t = (mm_bf16x3.mm_bf16x3(z, y, -0.5, 1.5) if fused
         else 1.5 * ident - 0.5 * mm_bf16x3.mm_bf16x3(z, y))
    gz, gy = torch.autograd.grad((t * probe).sum(), (z, y),
                                 create_graph=True)
    results.append((t, gz, gy) + torch.autograd.grad(
        (mm_bf16x3.mm_bf16x3(gz, gy) * probe2).sum() + (gz ** 2).sum(),
        (z, y)))
  check(all(torch.equal(a, b) for a, b in zip(*results)),
        "fused T's derivatives")
  torch.cuda.synchronize()
  log("high", f"K3's epilogue (alpha -0.5, beta 1.5): T bitwise equal to "
      f"K3's product followed by 1.5 I - 0.5 P at C = "
      f"{', '.join(map(str, HIGH_CC))}, and 15 fused Newton-Schulz "
      f"iterations to the unfused loop's Y and Z; the first and second "
      f"derivatives at C = {C} bitwise equal to the unfused expression's")


def _high_residual(cov: torch.Tensor) -> float:
  """max|W cov W^T - I| with W by the Newton-Schulz G runs (15 steps,
  trace scaling) at the set precision, taken in float64."""
  w = whiten.newton_schulz_inv_sqrt(cov.float(), num_iters=15).double()
  c = cov.double()
  return float((w @ c @ w.T - torch.eye(c.shape[0], dtype=torch.float64,
                                        device=c.device)).abs().max())


def _high_residuals(covs) -> dict:
  """The largest residual over ``covs`` under each precision."""
  out = {}
  for precision in ("highest", "high"):
    whiten.set_precision(precision)
    out[precision] = max(_high_residual(c) for c in covs)
  whiten.set_precision("high")
  return out


def _g_batch_covs(state, dev) -> list:
  """The batch covariances of G's WC layers in one train-mode forward at
  the G update's batch (128), the statistics left as they are."""
  z = torch.randn((128, state.g.cfg.z_dim), device=dev,
                  generator=torch.Generator(device=dev).manual_seed(15))
  with torch.no_grad(), L.capture_batch_moments(state.g) as stats:
    state.g(z, train=True, update_stats=False)
  return [v for k, v in stats.items() if k.endswith(".cov")]


def _high_f32_step(dev):
  """One float32 headline outer step (eager, deterministic kernels) from
  the same fresh state under each precision: their metrics and K3's
  launches under 'high'."""
  out = {}
  with _deterministic():
    for precision in ("highest", "high"):
      whiten.set_precision(precision)
      step_fn, state, (real, labels), _ = bench.build_bench(
          "headline", dtype="float32", device=dev.type, seed=0)
      mm_bf16x3.MM_BF16X3_LAUNCHES = 0
      metrics = step_fn.eager(state, real, labels)
      torch.cuda.synchronize()
      out[precision] = ({k: float(v) for k, v in metrics.items()},
                        mm_bf16x3.MM_BF16X3_LAUNCHES)
      del step_fn, state
  return out


def _high_windows(arms: dict) -> dict:
  """imgs/s and device span a step of each captured arm {precision:
  (step, state, real, labels)}, HIGH_TIME_ROUNDS windows of
  HIGH_TIME_STEPS steps in turns, each under its own precision (a graph
  is bound to the precision it was captured under)."""
  rates = {k: [] for k in arms}
  spans = {k: [] for k in arms}
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  for r in range(HIGH_TIME_ROUNDS):
    for name in (list(arms) if r % 2 == 0 else list(arms)[::-1]):
      whiten.set_precision(name)
      step, state, real, labels = arms[name]
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      start.record()
      for _ in range(HIGH_TIME_STEPS):
        step(state, real, labels)
      end.record()
      torch.cuda.synchronize()
      check(step.last == "replay", (name, step.calls))
      rates[name].append(HIGH_TIME_STEPS * 5 * 64
                         / (time.perf_counter() - t0))
      spans[name].append(start.elapsed_time(end) / HIGH_TIME_STEPS)
  return {k: (float(np.median(rates[k])), min(rates[k]), max(rates[k]),
              float(np.median(spans[k]))) for k in arms}


def _high_traced(arms: dict) -> dict:
  """One replay of each arm under torch.profiler: kernel ms, K3's and
  cuBLAS's GEMMs (launches, ms)."""
  out = {}
  for name, (step, state, real, labels) in arms.items():
    whiten.set_precision(name)
    kernels, wall = _traced_kernels(lambda: step(state, real, labels))
    ms = lambda es: sum(e.time_range.elapsed_us() for e in es) / 1e3  # noqa
    k3 = [e for e in kernels if "mm_bf16x3_" in e.name]
    gemm = [e for e in kernels if "gemm" in e.name.lower()]
    out[name] = dict(total=ms(kernels), wall=wall, kernels=len(kernels),
                     k3=(len(k3), ms(k3)), gemm=(len(gemm), ms(gemm)))
  return out


def _mm_tf32(a, b):
  """``a @ b`` with TF32 on: a yardstick only (the port never runs it)."""
  torch.backends.cuda.matmul.allow_tf32 = True
  try:
    return a @ b
  finally:
    torch.backends.cuda.matmul.allow_tf32 = False


def _k3_bound(m: int, k: int, n: int):
  """K3's bound on this card, ms: the larger of its bytes (A, B read once,
  C written once) over HBM and its three bf16 products (6 M N K flop)
  over the bf16 tensor-core peak; and which."""
  hbm = 4 * (m * k + k * n + m * n) / HBM_BYTES * 1e3
  ops = 6 * m * k * n / BF16_FLOPS * 1e3
  return max(hbm, ops), "bytes" if hbm >= ops else "operations"


def _high_kernel_times(dev):
  """K3, its plain version and torch.matmul in float32 (TF32 off, what
  'highest' runs; and on) in turns, at C x C x C (C = 256) and at
  131,072 x 256 x 256, with K3's bound on this card; K3 against
  torch.matmul float32 in turns at every C x C x C shape (HIGH_CC); one
  Newton-Schulz iteration at C = 256 (three products) fused, unfused and
  under 'highest', in turns."""
  gen = torch.Generator(device=dev).manual_seed(16)
  out = {}
  for m in (C, HIGH_RC[-1]):
    a, b = _high_operands(m, C, C, "nn", gen, dev)
    k3_ms, plain_ms, f32_ms, tf32_ms = _in_turns(
        (mm_bf16x3.mm_bf16x3_cuda, (a, b)),
        (mm_bf16x3.mm_bf16x3_reference, (a, b)), (torch.matmul, (a, b)),
        (_mm_tf32, (a, b)))
    bound, by = _k3_bound(m, C, C)
    out[m] = dict(ms=k3_ms, plain_ms=plain_ms, f32_ms=f32_ms,
                  tf32_ms=tf32_ms, bound_ms=bound, bound_by=by)
  small = {}
  for c in HIGH_CC:
    a, b = _high_operands(c, c, c, "nn", gen, dev)
    small[c] = _in_turns((mm_bf16x3.mm_bf16x3_cuda, (a, b)),
                         (torch.matmul, (a, b)))
  spd = _k2_inputs(4 * C, C, gen, dev)[2]
  y, z = spd / torch.trace(spd), torch.eye(C, device=dev)
  ns = _in_turns((_ns_step, (y, z, True)), (_ns_step, (y, z, False)),
                 (_ns_step_f32, (y, z)))
  return out, small, ns


def phase_high(dev: torch.device):
  """Slice 14, ``--whitening_precision high``: K3 (csrc/mm_bf16x3.cu)
  against its plain version and float64 on the path each shape picks;
  K3's fused Newton-Schulz epilogue against the unfused expression
  (slice 15); the whitening residual under 'high' and 'highest' on the
  headline's own covariances (fresh and after captured steps) and at
  conditioning 1e3; one float32 headline step under each from one state;
  the captured bf16 headline step under 'high' (K3 launches counted over
  one replay), its captured chain bit-equal to the eager one, timed in
  turns against 'highest', with each step's kernel ms and count; K3 timed
  against torch.matmul at every C x C x C shape and at R = 131,072.
  Leaves the precision at 'highest'. Returns (K3's launches by path, its
  largest |d|, its times at C = 256 and at R = 131,072)."""
  t_phase = time.perf_counter()
  try:
    err = _high_parity(dev)
    _high_fused(dev)
    times, small, ns = _high_kernel_times(dev)
    for m, t in times.items():
      check(_positive(t["ms"], t["plain_ms"], t["f32_ms"], t["tf32_ms"]), t)
      log("high", f"K3 {m:,}x{C}x{C} on {nvidia_smi()}: {t['ms']:.4f} ms a "
          f"call, bound {t['bound_ms']:.5f} ms ({t['bound_by']}; "
          f"{t['bound_ms'] / t['ms']:.1%} of it); plain version "
          f"{t['plain_ms']:.4f} ms; torch.matmul float32 TF32 off "
          f"{t['f32_ms']:.4f} ms, TF32 on {t['tf32_ms']:.4f} ms (yardsticks)")
    check(_positive(*(v for t in small.values() for v in t), *ns),
          (small, ns))
    log("high", f"K3 at C x C x C against torch.matmul float32 (TF32 off), "
        f"in turns, on {nvidia_smi()}: " + "; ".join(
            f"C = {c}: {k3 * 1e3:.2f} us / {f32 * 1e3:.2f} us = "
            f"{k3 / f32:.2f}x (bound {_k3_bound(c, c, c)[0] * 1e3:.3f} us)"
            for c, (k3, f32) in small.items()))
    log("high", f"one Newton-Schulz iteration at C = {C} (3 products), in "
        f"turns: K3 with its epilogue (3 launches) {ns[0] * 1e3:.2f} us, "
        f"K3 and the epilogue in torch (6) {ns[1] * 1e3:.2f} us "
        f"({ns[1] / ns[0]:.2f}x), 'highest' (torch.matmul float32, 6) "
        f"{ns[2] * 1e3:.2f} us ({ns[2] / ns[0]:.2f}x)")
    f32 = _high_f32_step(dev)
    (m_hi, n_hi), (m_st, _) = f32["high"], f32["highest"]
    rel = _rel(m_hi, m_st)
    check(all(np.isfinite(v) for v in m_hi.values())
          and max(rel.values()) <= STEP_RTOL, ("float32 step", rel))
    check(n_hi == HIGH_K3_PER_STEP, ("K3 launches, eager step", n_hi))
    log("high", f"one float32 headline outer step (eager, deterministic "
        f"kernels) from one fresh state: high against highest, relative "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + f" (gate {STEP_RTOL}); K3 {n_hi} launches")
    torch.cuda.empty_cache()

    whiten.set_precision("high")
    step, state, (real, labels), _ = bench.build_bench(
        "headline", device=dev.type, seed=0)
    gen = torch.Generator(device=dev).manual_seed(17)
    cond_cov = _k2_inputs(4096, C, gen, dev)[2]
    resid = {"fresh": _high_residuals(_g_batch_covs(state, dev)),
             "cond 1e3": _high_residuals([cond_cov])}
    for _ in range(2):                       # warm-up, capture + replay
      step(state, real, labels)
    mm_bf16x3.MM_BF16X3_LAUNCHES = cuda_wc.MOMENTS_LAUNCHES = 0
    metrics = step(state, real, labels)
    torch.cuda.synchronize()
    k3, k1 = mm_bf16x3.MM_BF16X3_LAUNCHES, cuda_wc.MOMENTS_LAUNCHES
    check(step.last == "replay" and k3 == HIGH_K3_PER_STEP and k1 == 42,
          (step.last, k3, k1))
    values = {k: float(v) for k, v in metrics.items()}
    check(all(np.isfinite(v) for v in values.values()), values)
    for _ in range(HIGH_PROBE_STEPS):
      step(state, real, labels)
    resid[f"after {HIGH_PROBE_STEPS + 3} steps"] = (
        _high_residuals(_g_batch_covs(state, dev)))
    check(all(r["high"] <= HIGH_RESID for k, r in resid.items()
              if k != "cond 1e3")
          and resid["cond 1e3"]["high"]
          <= resid["cond 1e3"]["highest"] + HIGH_RESID, resid)
    log("high", f"whitening residual max|W cov W^T - I| (15 steps, float64 "
        f"check), high / highest: " + "; ".join(
            f"{k} {v['high']:.3e} / {v['highest']:.3e}"
            for k, v in resid.items())
        + f" (gate under high: {HIGH_RESID}, at cond 1e3 highest's + "
        f"{HIGH_RESID}) on {nvidia_smi()}")
    log("high", f"captured bf16 headline step under high: one replay "
        f"launched K3 {k3}, K1 {k1}; metrics "
        + ", ".join(f"{k} {v:.4f}" for k, v in values.items()))
    ab, ab_at, cb, cb_at, same_gen, _, n_t, _ = _graph_parity(dev,
                                                              "bfloat16")
    check(ab == 0.0 and cb == 0.0 and same_gen,
          ("captured high chain against eager", ab, ab_at, cb, cb_at))
    log("high", f"bf16 headline under high, a chain of {GRAPH_CHAIN} dataset "
        f"steps (EMA 0.999, deterministic kernels) from one state: captured "
        f"vs eager max rel diff {ab:.3e}, eager vs eager {cb:.3e} over "
        f"{n_t} tensors and the metrics (bit-equal); generators equal")

    whiten.set_precision("highest")
    ref = bench.build_bench("headline", device=dev.type, seed=0)
    for _ in range(2):
      ref[0](ref[1], *ref[2])
    arms = {"high": (step, state, real, labels),
            "highest": (ref[0], ref[1], *ref[2])}
    rates = _high_windows(arms)
    check(_positive(*(v for t in rates.values() for v in t)), rates)
    traced = _high_traced(arms)
    # The device's own count of K3 in one traced replay, against the host
    # count the capture recorded (which each replay adds again).
    check(traced["high"]["k3"][0] == HIGH_K3_PER_STEP
          and traced["highest"]["k3"][0] == 0
          and traced["high"]["kernels"] < traced["highest"]["kernels"],
          ("K3 kernels in one traced replay",
           {k: (t["k3"][0], t["kernels"]) for k, t in traced.items()}))
    for name in arms:
      r, t = rates[name], traced[name]
      log("high", f"captured bf16 headline step, {name}, on {nvidia_smi()}: "
          f"{r[0]:.1f} imgs/s ({r[1]:.1f}-{r[2]:.1f}) over "
          f"{HIGH_TIME_ROUNDS} windows of {HIGH_TIME_STEPS} steps in turns, "
          f"device span {r[3]:.3f} ms a step; one traced replay "
          f"{t['total']:.3f} ms of kernel time in {t['kernels']} kernels; "
          f"K3 {t['k3'][0]} launches {t['k3'][1]:.3f} ms; cuBLAS GEMMs "
          f"{t['gemm'][0]} launches {t['gemm'][1]:.3f} ms")
    del arms, ref, step, state
    torch.cuda.empty_cache()
  finally:
    whiten.set_precision("highest")
  log("high", f"phase {time.perf_counter() - t_phase:.1f} s")
  paths = {"high: one captured bf16 headline step under 'high'": k3}
  return paths, err, times


def main_nccl() -> int:
  """``--phase nccl``: the NCCL checks alone, on every card of the
  machine (one rank a card), the last ones timed."""
  dev = phase_device()
  phase_build()
  phase_nccl(dev, torch.cuda.device_count())
  print(nvidia_smi(), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


def _k3_line(paths, err, times) -> dict:
  """K3's entry of the kernels line: its launches by path, its largest
  |d| against its plain version, its times at C x C x C (C = 256) and
  (rows_*) at 131,072 x 256 x 256, the library call torch.matmul in
  float32 with TF32 off."""
  t, rows = times[C], times[HIGH_RC[-1]]
  return {"name": "mm_bf16x3", "route": "cuda",
          "source": "wcgan_tpu_torch/csrc/mm_bf16x3.cu",
          "replaces": "no Pallas kernel: XLA's Precision.HIGH, "
                      "wcgan_tpu/ops/whiten.py:48",
          "launches": sum(paths.values()), "launches_by_path": paths,
          "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
          "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
          "library_ms": t["f32_ms"], "rows_ms": rows["ms"],
          "rows_plain_ms": rows["plain_ms"], "rows_bound_ms": rows["bound_ms"],
          "rows_library_ms": rows["f32_ms"]}


def main_high() -> int:
  """``--phase high``: K3 and the 'high' precision alone."""
  dev = phase_device()
  phase_build()
  paths, err, times = phase_high(dev)
  print(nvidia_smi(), flush=True)
  print(json.dumps({"kernels": [_k3_line(paths, err, times)]}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


def main(argv=None) -> int:
  argv = sys.argv[1:] if argv is None else argv
  if argv == ["--phase", "nccl"]:
    return main_nccl()
  if argv == ["--phase", "high"]:
    return main_high()
  if argv:
    raise SystemExit(f"usage: python3 chip_smoke.py [--phase nccl|high]; "
                     f"got {argv}")
  t_script = time.perf_counter()
  dev = phase_device()
  phase_build()
  err = phase_parity(dev)
  phase_f64(dev)
  k1_ms, k1_plain_ms, k1_lib_ms, k1_bound_ms, k1_bound_by = phase_timing(dev)
  k2_err = phase_k2_parity(dev)
  k2_ms, k2_plain_ms, k2_bound_ms, k2_lib_ms, k2_bound_by = phase_k2_timing(
      dev)
  phase_step_parity(dev)
  launches, state, gan = phase_slice(dev)
  bench_k1, bench_k2 = phase_bench(dev)
  graph_k1, graph_k2 = phase_graph(dev)
  sg_k1, sg_k2 = phase_sample_graph(dev)
  k3_paths, k3_err, k3_times = phase_high(dev)
  k2_launches, npz = phase_sampling(dev, state, gan)
  phase_cli(npz)
  run_step_launches, standing_launches, run_k2_launches = phase_run(dev)
  widths_err, _ = phase_k1_widths(dev)
  cond_paths, cwc_state, cwc_gan = phase_cond_slice(dev)
  gp_launches = phase_gp_dnorm(dev)
  cond_k2 = phase_cond_sampling(dev, cwc_state, cwc_gan)
  del cwc_state
  torch.cuda.empty_cache()
  dcgan_paths, dcgan_err, dcgan_state, dcgan_gan = phase_dcgan(dev)
  phase_dcgan_bn(dev)
  dcgan_k2, dcgan_k2_err = phase_dcgan_sampling(dev, dcgan_state, dcgan_gan)
  del dcgan_state
  option_k1, option_k2, option_err = phase_step_options(dev)
  stl10_launches = phase_presets(dev)
  eval_k1, eval_k2 = phase_eval(dev)
  dp_launches = phase_dp(dev)
  nccl_k1 = phase_nccl(dev)
  digits_launches = phase_digits()
  loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
      "wcgan_tpu", "jax", "jaxlib", "flax", "optax", "orbax"))
  check(not loaded, f"chip_smoke imported {loaded}")
  log("total", f"every phase passed in {time.perf_counter() - t_script:.1f} "
      "s")
  print(nvidia_smi(), flush=True)
  # Device ms: K1 over the 42 calls of one outer step (library: torch.cov),
  # K2 over the 7 calls of one batch-256 generate forward (library: the row
  # apply alone as torch.addmm in float32); bounds from this card's peak
  # rates, each the larger of its bytes and its operations. K2's plain_ms
  # is host-bound (its launches outlast the queue's hold).
  # max_abs_err: K1's worst against plain, K2's worst with float32 rows
  # (bf16 rows are held to 2 ulps, printed above), K3's worst against its
  # plain version. K3 (one C x C x C product at C = 256; library:
  # torch.matmul in float32, TF32 off) replaces no Pallas kernel: it is
  # XLA's HIGH, the JAX package's default whitening precision.
  # launches: the sum over the paths in launches_by_path, each counted from
  # 0 just before its run.
  k1_paths = {"training slice, 10 outer steps": launches, **bench_k1,
              **graph_k1, **sg_k1,
              "run: one outer step from a saved and from its restored "
              "state": run_step_launches,
              "run: one standing-statistics recompute": standing_launches,
              **cond_paths,
              "gp-dnorm: one float32 WGAN-GP outer step": gp_launches,
              **dcgan_paths, **option_k1,
              "presets: stl10_wc_resnet_sn at full width, 2 outer steps":
                  stl10_launches,
              "eval: one scorer call, the cold standing recompute": eval_k1,
              "dp": dp_launches, **nccl_k1,
              f"digits: {DIGITS_EPOCHS} epochs, "
              f"{DIGITS_EPOCHS * digits_quality.STEPS_PER_EPOCH} outer steps":
                  digits_launches}
  k2_paths = {"sampling: generate(1024, batch=256)": k2_launches,
              **bench_k2, **graph_k2, **sg_k2,
              "run: EMA generate(1024, batch=256)": run_k2_launches,
              "cond-sampling: conditional generate(1024, batch=256)":
                  cond_k2,
              "dcgan-sampling: generate(1024, batch=256)": dcgan_k2,
              **option_k2,
              "eval: one scorer call, generate(50000, batch=256)": eval_k2}
  print(json.dumps({"kernels": [{
      "name": "moments", "route": "cuda",
      "source": "wcgan_tpu_torch/csrc/moments.cu",
      "replaces": "wcgan_tpu/ops/pallas_wc.py:56",
      "launches": sum(k1_paths.values()), "launches_by_path": k1_paths,
      "max_abs_err": max(err, widths_err, dcgan_err, option_err),
      "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms,
      "bound_by": k1_bound_by, "library_ms": k1_lib_ms}, {
      "name": "whiten_color_apply", "route": "cuda",
      "source": "wcgan_tpu_torch/csrc/wc_apply.cu",
      "replaces": "wcgan_tpu/ops/pallas_wc.py:195",
      "launches": sum(k2_paths.values()), "launches_by_path": k2_paths,
      "max_abs_err": max(k2_err, dcgan_k2_err),
      "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
      "bound_by": k2_bound_by, "library_ms": k2_lib_ms},
      _k3_line(k3_paths, k3_err, k3_times)]}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
