"""What holds K1 (wcgan_tpu_torch/csrc/moments.cu) back, measured on the card.

  python3 scripts/k1_variants.py

Run from the repository root on a machine with an NVIDIA Hopper GPU and
nvcc. It derives variants of moments.cu by text substitution (each
removes or changes one part of the Gram kernel), builds them in parallel
with the package's nvcc flags into build/k1_variants/, and for each prints
the device ms per call at R = 1,024, 16,384 and 131,072 (bf16 rows,
C = 256, the queue held while the host enqueues) and max|d| from the
plain float32 version at R = 131,072. Then it profiles the base kernel's
four launches and samples the card's SM clock and power while the base
kernel loops. Variants whose results are wrong by design (parts removed)
are marked "timing only". It needs the port (wcgan_tpu_torch) and no JAX.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from wcgan_tpu_torch.ops import _build, cuda_wc  # noqa: E402

OUT = ROOT / "build" / "k1_variants"
C = 256
TIMED_R = (1024, 16384, 131072)


def _sub(src: str, old: str, new: str) -> str:
  if old not in src:
    raise SystemExit(f"k1_variants: the source no longer contains {old!r}")
  return src.replace(old, new)


def variants(src: str):
  """name -> (source, timing only?)."""
  conv_a = src.index("#pragma unroll\n    for (int q = 0; q < 4; ++q) {\n"
                     "      const int kc = kc0 + 2 * q;")
  conv_b = src.index("    mbar_arrive(&empty[slot]);  // the raw stage")
  products = re.search(r"      wgmma_m64n128k8\(part, d_hi_a \+ 2 \* k8, "
                       r"d_lo_b.*?\n.*?\n.*?\n", src).group(0)
  sink = (("  float total[64], part[64];",
           "  float sink = 0.f;\n  float total[64], part[64];"),
          ("  float* out = ws + static_cast<int64_t>(blockIdx.x) * kTile"
           " * kTile;",
           "  float* out = ws + static_cast<int64_t>(blockIdx.x) * kTile"
           " * kTile;\n  if (sink == 12345.f) out[0] = sink;"))

  def conversion(body: str) -> str:
    out = src[:conv_a] + body + src[conv_b:]
    for old, new in sink:
      out = _sub(out, old, new)
    return out

  no_conv = src[:conv_a] + src[conv_b:]
  loads_only = """#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = (kc0 + 2 * q) * 4 + i;
        sink += to_f32(ra[k * box_cols + c]);
        if (!diag) sink += to_f32(rb[k * box_cols + c]);
      }
    }
"""
  stores_only = """#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kc = kc0 + 2 * q;
      const int off = c * 128 + ((kc ^ (c & 7)) << 4);
      const float4 v = make_float4(mu_a, mu_b, mu_a, mu_b);
      *reinterpret_cast<float4*>(operand(set, 0) + off) = v;
      *reinterpret_cast<float4*>(operand(set, 1) + off) = v;
      if (!diag) {
        *reinterpret_cast<float4*>(operand(set, 2) + off) = v;
        *reinterpret_cast<float4*>(operand(set, 3) + off) = v;
      }
    }
"""
  restart = "#pragma unroll\n    for (int i = 0; i < 64; ++i) total[i] += part[i];\n    named_barrier_sync"
  no_restart = _sub(_sub(src, restart, "    named_barrier_sync"),
                    "d_lo_b + 2 * k8, k8 > 0);",
                    "d_lo_b + 2 * k8, s > 0 || k8 > 0);")
  cvt_rna = _sub(src, "  return __uint_as_float((__float_as_uint(v) + 0x1000u) "
                 "& 0xffffe000u);",
                 "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r)"
                 " : \"f\"(v));\n  return __uint_as_float(r & 0xffffe000u);")
  input_cap = _sub(src, "  if (splits < 1) splits = 1;",
                   "  splits = min64(splits, rows * cols * 2 /\n"
                   "                 (p.pairs * int64_t(kTile) * kTile * 4));\n"
                   "  if (splits < 1) splits = 1;")
  per_warp = _sub(_sub(src, "      mbar_init(&empty[s], kConsumers);",
                       "      mbar_init(&empty[s], kConsumers / 32);"),
                  "    mbar_arrive(&empty[slot]);  // the raw stage",
                  "    __syncwarp();\n    if (c % 32 == 0) "
                  "mbar_arrive(&empty[slot]);  // the raw stage")
  return {
      "base": (src, False),
      "products, no conversion": (no_conv, True),
      "loads only": (no_conv.replace(products, ""), True),
      "conversion, no products": (src.replace(products, ""), True),
      "conversion's loads only": (conversion(loads_only), True),
      "conversion's stores only": (conversion(stores_only), True),
      "no accumulator restart": (no_restart, False),
      "ring of 6 stages": (_sub(src, "constexpr int kStages = 3;",
                                "constexpr int kStages = 6;"), False),
      "cvt.rna.tf32 rounding": (cvt_rna, False),
      "partials capped at input": (input_cap, False),
      "one empty arrival per warp": (per_warp, False),
  }


def build(name: str, source: str):
  slug = re.sub(r"\W+", "_", name).strip("_")
  cu, so = OUT / f"{slug}.cu", OUT / f"lib{slug}.so"
  cu.write_text(source)
  proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                         str(_build.CSRC_DIR), "-o", str(so), str(cu)],
                        capture_output=True, text=True)
  if proc.returncode:
    raise SystemExit(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
  lib = ctypes.CDLL(str(so))
  lib.wcgan_moments.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                                ctypes.c_int] + [ctypes.c_void_p] * 4
  lib.wcgan_moments_workspace_floats.argtypes = [ctypes.c_int64, ctypes.c_int]
  lib.wcgan_moments_workspace_floats.restype = ctypes.c_int64
  return lib


def moments(lib, x):
  rows, cols = x.shape
  mean = torch.empty(cols, device=x.device)
  cov = torch.empty((cols, cols), device=x.device)
  ws = torch.empty(lib.wcgan_moments_workspace_floats(rows, cols),
                   device=x.device)
  err = lib.wcgan_moments(x.data_ptr(), 1, rows, cols, mean.data_ptr(),
                          cov.data_ptr(), ws.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
  if err:
    raise RuntimeError(f"launch failed: cudaError_t {err}")
  return mean, cov


def device_ms(fn, iters: int = 20) -> float:
  for _ in range(3):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  torch.cuda._sleep(50_000_000)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def main() -> int:
  if not torch.cuda.is_available():
    raise SystemExit("k1_variants: needs a CUDA GPU")
  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip()
  print(f"card: {smi}", flush=True)
  OUT.mkdir(parents=True, exist_ok=True)
  src = (ROOT / "wcgan_tpu_torch" / "csrc" / "moments.cu").read_text()
  table = variants(src)
  with ThreadPoolExecutor(len(table)) as pool:
    libs = dict(zip(table, pool.map(lambda kv: build(kv[0], kv[1][0]),
                                    table.items())))
  dev = torch.device("cuda", 0)
  gen = torch.Generator(device=dev).manual_seed(0)
  xs = {r: torch.randn((r, C), generator=gen, device=dev).to(torch.bfloat16)
        for r in TIMED_R}
  ref = cuda_wc.moments_reference(xs[131072])[1]
  print("variant | " + " | ".join(f"ms R={r}" for r in TIMED_R)
        + " | max|d| from plain at R=131072", flush=True)
  for name, lib in libs.items():
    times = [device_ms(lambda: moments(lib, xs[r])) for r in TIMED_R]
    err = float((moments(lib, xs[131072])[1] - ref).abs().max())
    note = "timing only" if table[name][1] else f"{err:.2e}"
    print(f"{name} | " + " | ".join(f"{t:.4f}" for t in times)
          + f" | {note}", flush=True)
  from torch.profiler import ProfilerActivity, profile
  for r in (1024, 131072):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(10):
        moments(libs["base"], xs[r])
      torch.cuda.synchronize()
    per = {}
    for e in prof.events():
      if e.device_type == torch.autograd.DeviceType.CUDA:
        name = (re.findall(r"::(\w+)", e.name) or [e.name[:30]])[0]
        per[name] = per.get(name, 0.0) + e.time_range.elapsed_us() / 10
    print(f"base, R={r}, device us per launch: "
          + ", ".join(f"{k} {v:.2f}" for k, v in per.items()), flush=True)
  sampler = subprocess.Popen(
      ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
       "clocks_throttle_reasons.active", "--format=csv,noheader", "-lms",
       "200"], stdout=subprocess.PIPE, text=True)
  t0 = time.time()
  while time.time() - t0 < 3.0:
    for _ in range(20):
      moments(libs["base"], xs[131072])
    torch.cuda.synchronize()
  sampler.terminate()
  samples = sampler.communicate()[0].strip().splitlines()
  print("base looping at R=131072, nvidia-smi (SM clock, power, throttle "
        "reasons): " + " ; ".join(samples[len(samples) // 3:][:6]),
        flush=True)
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
