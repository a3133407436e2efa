"""On-card smoke test of the PyTorch port (wcgan_tpu_torch) on one GPU.

  python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU, nvcc
and PyTorch built for CUDA. It builds K1 (wcgan_tpu_torch/csrc/moments.cu)
and K2 (csrc/wc_apply.cu) side by side and prints ptxas's registers and
spills (K1's Gram kernel and K2's row apply, whose wgmma accumulators live
in registers, must not spill), holds each against its plain PyTorch
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

and the CLI: a training run that writes sample grids, then ``--phase test``
on the npz that ``Trainer.export_weights`` wrote. One training outer step
is profiled (``torch.profiler``) for K1's share of kernel time, and one
K2 generate forward for K2's kernels, launches per call and the device's
busy share. Every
phase that fails stops the script with a non-zero exit. The last line is
{"ok": true, "device": {...}}; the line before it lists each kernel with
its launches on its path, error and times. Without a GPU it exits
non-zero and prints no result. It imports no JAX and nothing of the JAX
package, as the port does.
"""

from __future__ import annotations

import concurrent.futures
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

from wcgan_tpu_torch.data import get_dataset
from wcgan_tpu_torch.device import place
from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
from wcgan_tpu_torch.models.generator import Generator, GeneratorConfig
from wcgan_tpu_torch.ops import _build, cuda_wc
from wcgan_tpu_torch.train.state import OptimConfig, create_state
from wcgan_tpu_torch.train.step import GANConfig, make_outer_step
from wcgan_tpu_torch.train.trainer import Trainer, TrainerConfig

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
# HBM3.
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


def nvidia_smi() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  return out.stdout.strip().splitlines()[0]


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
  """Both kernels at once, one nvcc each; ptxas's registers and spills of
  every kernel function. K1's Gram kernel and K2's bf16 row apply (wgmma
  accumulators in registers) must not spill."""
  t0 = time.perf_counter()
  with concurrent.futures.ThreadPoolExecutor(2) as pool:
    builds = dict(zip(("moments", "wc_apply"), pool.map(
        _build.compile_library, ("moments", "wc_apply"))))
  _build.load_moments()
  _build.load_wc_apply()
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
    else:
      rows = [sp for k, _, sp in report if "rows_apply_bf16" in k]
      check(len(rows) == 2 and not any(rows), ("K2 row apply spills",
                                               report))
  log("build", f"both loaded in {time.perf_counter() - t0:.2f} s")


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


def phase_profile(state, gan) -> None:
  """One training outer step of the slice under torch.profiler: K1's
  device time and its share of all kernel time."""
  from torch.profiler import ProfilerActivity, profile
  step = make_outer_step(gan)
  dev = state.generator.device
  real = torch.randint(0, 256, (5, 64, 32, 32, 3), dtype=torch.uint8,
                       generator=torch.Generator(device=dev).manual_seed(9),
                       device=dev)
  labels = torch.zeros((5, 64), dtype=torch.int32, device=dev)
  step(state, real, labels)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    step(state, real, labels)
    torch.cuda.synchronize()
  wall = (time.perf_counter() - t0) * 1e3
  kernels = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  total = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
  k1 = [e for e in kernels if any(n in e.name for n in K1_KERNELS)]
  k1_ms = sum(e.time_range.elapsed_us() for e in k1) / 1e3
  gram = sum(1 for e in k1 if "centered_gram" in e.name)
  check(total > 0 and gram == 42, (total, gram))
  log("profile", f"one outer step under torch.profiler on {nvidia_smi()}: "
      f"{len(kernels)} kernels, {total:.3f} ms of kernel time in "
      f"{wall:.1f} ms of wall (busy {total / wall:.2f}); K1 {k1_ms:.3f} ms "
      f"({k1_ms / total:.1%}; {len(k1)} launches of its 4 kernels, {gram} "
      f"Gram) against 6.6 ms of 65.1 in the slice-1 profile")


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
  diff = np.abs(imgs_k.astype(np.int16) - imgs_s.astype(np.int16))
  p999 = float(np.quantile(diff, 0.999))
  check(diff.mean() <= SAMPLE_MEAN_TOL and p999 <= SAMPLE_P999_TOL
        and diff.max() <= SAMPLE_MAX_TOL,
        (float(diff.mean()), p999, int(diff.max())))
  rate = {k: n / v[1] for k, v in runs.items()}
  log("sampling", f"G 256x3 bf16, generate({n}, batch=256) on "
      f"{nvidia_smi()}: K2 {rate['K2']:.1f} / {rate['K2 again']:.1f} imgs/s "
      f"({k2_k} K2 launches, 7/forward; peak {mem_k:.0f} MiB), split "
      f"{rate['split']:.1f} / {rate['split again']:.1f} imgs/s ({k2_s} K2 "
      f"launches; peak {mem_s:.0f} MiB); uint8 |K2 - split| mean "
      f"{diff.mean():.4f}, p99.9 {p999:.0f}, max {int(diff.max())}")
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


def _run_cli(args, out_dir: str):
  cmd = [sys.executable, "-m", "wcgan_tpu_torch", "--device", "cuda",
         "--dataset", "synthetic", "--arch", "res", "--bf16",
         "--output_dir", out_dir, "--name", "smoke", *args]
  t0 = time.perf_counter()
  proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
  if proc.returncode != 0:
    raise RuntimeError(f"CLI failed ({proc.returncode}):\n{proc.stdout}\n"
                       f"{proc.stderr}")
  with open(os.path.join(out_dir, "smoke", "log.txt")) as f:
    lines = [l.strip() for l in f]
  return cmd, time.perf_counter() - t0, lines


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


def main() -> int:
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
  phase_profile(state, gan)
  k2_launches, npz = phase_sampling(dev, state, gan)
  phase_cli(npz)
  loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
      "wcgan_tpu", "jax", "jaxlib", "flax", "optax", "orbax"))
  check(not loaded, f"chip_smoke imported {loaded}")
  print(nvidia_smi(), flush=True)
  # Device ms: K1 over the 42 calls of one outer step (library: torch.cov),
  # K2 over the 7 calls of one batch-256 generate forward (library: the row
  # apply alone as torch.addmm in float32); bounds from this card's peak
  # rates, each the larger of its bytes and its operations. K2's plain_ms
  # is host-bound (its launches outlast the queue's hold).
  # max_abs_err: K1's worst against plain, K2's worst with float32 rows
  # (bf16 rows are held to 2 ulps, printed above).
  print(json.dumps({"kernels": [{
      "name": "moments", "route": "cuda",
      "source": "wcgan_tpu_torch/csrc/moments.cu",
      "replaces": "wcgan_tpu/ops/pallas_wc.py:56",
      "launches": launches, "max_abs_err": err,
      "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms,
      "bound_by": k1_bound_by, "library_ms": k1_lib_ms}, {
      "name": "whiten_color_apply", "route": "cuda",
      "source": "wcgan_tpu_torch/csrc/wc_apply.cu",
      "replaces": "wcgan_tpu/ops/pallas_wc.py:195",
      "launches": k2_launches, "max_abs_err": k2_err,
      "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
      "bound_by": k2_bound_by, "library_ms": k2_lib_ms}]}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
