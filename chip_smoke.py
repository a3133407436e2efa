"""On-card smoke test of the PyTorch port (wcgan_tpu_torch) on one GPU.

  python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU, nvcc
and PyTorch built for CUDA. It builds K1 (wcgan_tpu_torch/csrc/moments.cu),
holds it against its plain PyTorch version, times both, checks one outer
step with and without the kernel at small width in float32, then drives the
training slice at full width (G 256x3 + D 128x4, bf16, batch 64, 5 D
updates + 1 G update at batch 128) and the CLI. Every phase that fails
stops the script with a non-zero exit. The last line is
{"ok": true, "device": {...}}; the line before it lists each kernel with
its launches on the main path, error and times. Without a GPU it exits
non-zero and prints no result. It imports no JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import torch

from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
from wcgan_tpu_torch.models.generator import GeneratorConfig
from wcgan_tpu_torch.ops import _build, cuda_wc
from wcgan_tpu_torch.train.state import OptimConfig, create_state
from wcgan_tpu_torch.train.step import GANConfig, make_outer_step

C = 256
# R = N*H*W of the 7 WC layers of G 256x3 (4x4 -> 32x32) at the D-phase
# batch 64 (5 forwards per outer step) and the G-update batch 128 (1).
D_PHASE_R = (1024, 4096, 4096, 16384, 16384, 65536, 65536)
G_UPDATE_R = (2048, 8192, 8192, 32768, 32768, 131072, 131072)
CHECK_R = (1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072, 1000, 130)
TOL = 1e-4          # K1 against the plain float32 moments (reference gate)
STEP_RTOL = 1e-3    # one outer step, K1 against plain moments, float32
STATS_ATOL = 1e-4


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


def phase_build() -> None:
  t0 = time.perf_counter()
  path, out, compile_s = _build.compile_library("moments")
  _build.load_moments()
  regs = [l.strip() for l in out.splitlines() if "registers" in l]
  log("build", f"K1 {path.name} built in {compile_s:.2f} s (load total "
      f"{time.perf_counter() - t0:.2f} s); " + " | ".join(regs))


def phase_parity(dev: torch.device) -> float:
  gen = torch.Generator(device=dev).manual_seed(0)
  worst = 0.0
  for dtype in (torch.float32, torch.bfloat16):
    errs = []
    for r in CHECK_R:
      x = (torch.randn((r, C), generator=gen, device=dev) * 2 + 3).to(dtype)
      got = cuda_wc.moments_cuda(x)
      torch.cuda.synchronize()
      err = max_err(got, cuda_wc.moments_reference(x))
      errs.append(f"{r}:{err:.2e}")
      check(err <= TOL, (dtype, r, err))
      worst = max(worst, err)
    log("parity", f"K1 vs plain, C={C}, {dtype}: max|d| per R " +
        " ".join(errs))
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


def _time_ms(fn, x, iters: int = 20) -> float:
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn(x)
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def phase_timing(dev: torch.device):
  gen = torch.Generator(device=dev).manual_seed(1)
  per_r = {}
  for r in sorted(set(D_PHASE_R + G_UPDATE_R)):
    x = torch.randn((r, C), generator=gen, device=dev).to(torch.bfloat16)
    for fn in (cuda_wc.moments_cuda, cuda_wc.moments_reference):
      for _ in range(3):
        fn(x)
    # In turns, plain / kernel / kernel / plain, on the same input.
    p1 = _time_ms(cuda_wc.moments_reference, x)
    k1 = _time_ms(cuda_wc.moments_cuda, x)
    k2 = _time_ms(cuda_wc.moments_cuda, x)
    p2 = _time_ms(cuda_wc.moments_reference, x)
    per_r[r] = ((k1 + k2) / 2, (p1 + p2) / 2)
  log("timing", "bf16 rows, C=256, ms per call (K1 / plain): " + " ".join(
      f"R={r}:{k:.4f}/{p:.4f}" for r, (k, p) in per_r.items()))
  step_k = 5 * sum(per_r[r][0] for r in D_PHASE_R) + sum(
      per_r[r][0] for r in G_UPDATE_R)
  step_p = 5 * sum(per_r[r][1] for r in D_PHASE_R) + sum(
      per_r[r][1] for r in G_UPDATE_R)
  log("timing", f"the 42 calls of one outer step: K1 {step_k:.4f} ms, "
      f"plain {step_p:.4f} ms")
  return step_k, step_p


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
  return launches


def phase_cli() -> None:
  out_dir = os.path.join("build", "chip_smoke_cli")
  shutil.rmtree(out_dir, ignore_errors=True)
  cmd = [sys.executable, "-m", "wcgan_tpu_torch", "--device", "cuda",
         "--dataset", "synthetic", "--arch", "res", "--bf16",
         "--number_of_epochs", "2", "--batches_per_epoch", "3",
         "--output_dir", out_dir, "--name", "smoke"]
  t0 = time.perf_counter()
  proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
  if proc.returncode != 0:
    raise RuntimeError(f"CLI failed ({proc.returncode}):\n{proc.stdout}\n"
                       f"{proc.stderr}")
  with open(os.path.join(out_dir, "smoke", "log.txt")) as f:
    epochs = [l.strip() for l in f if l.startswith("Epoch ")]
  check(len(epochs) == 2, epochs)
  log("cli", f"{' '.join(cmd[1:])}: rc 0 in "
      f"{time.perf_counter() - t0:.1f} s; {epochs[-1]}")


def main() -> int:
  dev = phase_device()
  phase_build()
  err = phase_parity(dev)
  step_k, step_p = phase_timing(dev)
  phase_step_parity(dev)
  launches = phase_slice(dev)
  phase_cli()
  loaded = sorted(m for m in ("jax", "flax", "optax", "wcgan_tpu")
                  if m in sys.modules)
  check(not loaded, f"chip_smoke imported {loaded}")
  print(nvidia_smi(), flush=True)
  print(json.dumps({"kernels": [{
      "name": "moments", "route": "cuda",
      "source": "wcgan_tpu_torch/csrc/moments.cu",
      "replaces": "wcgan_tpu/ops/pallas_wc.py:56",
      "launches": launches, "max_abs_err": err,
      "ms": step_k, "plain_ms": step_p}]}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
