"""Variants of K3 (wcgan_tpu_torch/csrc/mm_bf16x3.cu), measured on the card.

  python3 scripts/k3_variants.py

Run from the repository root on a machine with an NVIDIA Hopper GPU and
nvcc. It derives variants of mm_bf16x3.cu by text substitution, builds
them in parallel with the package's nvcc flags into build/k3_variants/,
and swaps each in as the library ``ops.mm_bf16x3`` launches. For each it
says whether its outputs are bitwise those of the source as it is at
C x C x C (C = 256) and 131,072 x 256 x 256, then times all of them in
turns (the first variant, the others, then back) with CUDA events: one K3
call at C x C x C (C = 64, 128, 256, 512) and 131,072 x 256 x 256, and 15
fused Newton-Schulz iterations at C = 256 launched back to back. The
variants marked "step" also run the captured bf16 headline step under
--whitening_precision high (imgs/s over windows of 5 steps in turns, each
variant's step captured under it), one traced replay of it (kernel time,
K3's launches and ms) and its captured chain against the eager chain
(chip_smoke._graph_parity: bit-equal or not). Variants:

- base (step): the source as it is (K split over a cluster only where a
  CTA would walk more than 8 K tiles: C = 512, K = R);
- pdl (step): programmatic dependent launch (each kernel waits in
  griddepcontrol.wait before its first global access; the next K3 launch
  starts while this one drains);
- split1: K never split (one CTA a tile walks all of K);
- split2: split where a CTA would walk more than 4 K tiles (C = 256 over
  2 CTAs);
- split4: split wherever a CTA keeps one K tile and the grid one wave (C
  = 128 and 256 over 4 CTAs, C = 64 over 2);
- split4_noreduce (timing only, wrong by design): split4 with each CTA
  storing its partial tile, no cluster barrier or distributed shared
  memory read.

It needs the port (wcgan_tpu_torch) and no JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from wcgan_tpu_torch import bench  # noqa: E402
from wcgan_tpu_torch.device import card  # noqa: E402
from wcgan_tpu_torch.ops import _build, mm_bf16x3, whiten  # noqa: E402

OUT = ROOT / "build" / "k3_variants"
C = 256
ROWS = 131072
NS_ITERS = 15
STEPS, ROUNDS = 5, 3


def _sub(src: str, old: str, new: str) -> str:
  if old not in src:
    raise SystemExit(f"k3_variants: the source no longer contains {old!r}")
  return src.replace(old, new)


STEP_VARIANTS = ("base", "pdl")


def pdl(src: str) -> str:
  """Programmatic dependent launch: each kernel waits for the grid before
  it (griddepcontrol.wait) before its first global access and lets the
  next one start; every launch allows it."""
  wait = ('  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
          '  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");\n')
  out = _sub(src, "  const int64_t k_hi = k_lo + k_slab < k ? k_lo + k_slab : k;\n",
             "  const int64_t k_hi = k_lo + k_slab < k ? k_lo + k_slab : k;\n"
             + wait)
  out = _sub(out, '    asm volatile("fence.mbarrier_init.release.cluster;" ::: '
             '"memory");\n  }\n  __syncthreads();\n',
             '    asm volatile("fence.mbarrier_init.release.cluster;" ::: '
             '"memory");\n  }\n  __syncthreads();\n' + wait)
  return _sub(out, "  cfg.attrs = attrs;\n  cfg.numAttrs = cluster > 1 ? 1 : 0;\n",
              "  cudaLaunchAttribute both[2] = {attrs[0], {}};\n"
              "  both[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;\n"
              "  both[1].val.programmaticStreamSerializationAllowed = 1;\n"
              "  cfg.attrs = cluster > 1 ? both : both + 1;\n"
              "  cfg.numAttrs = cluster > 1 ? 2 : 1;\n")


def variants(src: str) -> dict:
  policy = "  while (p.split < kMaxSplit && k > kSplitTiles * kBK * p.split &&"
  direct = "  if (split == 1) {\n#pragma unroll\n    for (int i = 0; i < MT; ++i)"
  split4 = _sub(src, "constexpr int kSplitTiles = 8;",
                "constexpr int kSplitTiles = 1;")
  return {
      "base": src,
      "pdl": pdl(src),
      "split1": _sub(src, policy, policy.replace("while (", "while (false && ")),
      "split2": _sub(src, "constexpr int kSplitTiles = 8;",
                     "constexpr int kSplitTiles = 4;"),
      "split4": split4,
      "split4_noreduce": _sub(split4, direct,
                              direct.replace("if (split == 1)", "if (true)")),
  }


def build(name: str, src: str) -> Path:
  """nvcc of one variant (the package's flags, csrc/ on the include path)."""
  OUT.mkdir(parents=True, exist_ok=True)
  cu = OUT / f"mm_bf16x3_{name}.cu"
  cu.write_text(src)
  lib = OUT / f"libmm_bf16x3_{name}.so"
  cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
         "-o", str(lib), str(cu)]
  proc = subprocess.run(cmd, capture_output=True, text=True)
  if proc.returncode != 0:
    raise SystemExit(f"k3_variants: {name} failed to build:\n"
                     f"{proc.stdout}{proc.stderr}")
  return lib


def load(path: Path) -> ctypes.CDLL:
  """A variant's library with the signatures ``_build`` declares."""
  _build._LOADED.pop("mm_bf16x3", None)
  real = _build.compile_library
  _build.compile_library = lambda name: (path, "", 0.0)
  try:
    return _build.load_mm_bf16x3()
  finally:
    _build.compile_library = real


def use(lib: ctypes.CDLL) -> None:
  _build._LOADED["mm_bf16x3"] = lib


def ns_chain(y, z):
  """NS_ITERS fused Newton-Schulz iterations, K3 only (3 launches each)."""
  for _ in range(NS_ITERS):
    y, z = chip_smoke._ns_step(y, z, True)
  return y, z


def main() -> int:
  if not torch.cuda.is_available():
    raise SystemExit("k3_variants: needs a CUDA GPU")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda", 0)
  print(f"{card()} | torch {torch.__version__} cuda {torch.version.cuda}",
        flush=True)
  src = (_build.CSRC_DIR / "mm_bf16x3.cu").read_text()
  vs = variants(src)
  with ThreadPoolExecutor(len(vs)) as pool:
    paths = dict(zip(vs, pool.map(lambda kv: build(*kv), vs.items())))
  libs = {name: load(path) for name, path in paths.items()}
  names = list(libs)

  gen = torch.Generator(device=dev).manual_seed(0)
  smalls = {c: chip_smoke._high_operands(c, c, c, "nn", gen, dev)
            for c in chip_smoke.HIGH_CC}
  small = smalls[C]
  rows = chip_smoke._high_operands(ROWS, C, C, "nn", gen, dev)
  spd = chip_smoke._k2_inputs(4 * C, C, gen, dev)[2]
  yz = (spd / torch.trace(spd), torch.eye(C, device=dev))
  outs = {}
  for name in names:
    use(libs[name])
    outs[name] = [mm_bf16x3.mm_bf16x3_cuda(*small),
                  mm_bf16x3.mm_bf16x3_cuda(*rows), *ns_chain(*yz)]
  torch.cuda.synchronize()
  for name in names[1:]:
    same = all(torch.equal(a, b) for a, b in zip(outs[name], outs["base"]))
    print(f"{name}: outputs bitwise equal to base: {same}", flush=True)
  del outs

  def timed(fn, *args):
    def run(lib):
      use(lib)
      return chip_smoke._time_ms(fn, *args)
    return run

  order = names + names[::-1]
  timed_calls = [(f"K3 {c}x{c}x{c}", mm_bf16x3.mm_bf16x3_cuda, smalls[c])
                 for c in smalls] + [
      (f"K3 {ROWS}x256x256", mm_bf16x3.mm_bf16x3_cuda, rows),
      (f"{NS_ITERS} fused NS iterations, C = {C}", ns_chain, yz)]
  for what, fn, args in timed_calls:
    for name in names:
      use(libs[name])
      for _ in range(3):
        fn(*args)
    times = {n: [] for n in names}
    for name in order:
      times[name].append(timed(fn, *args)(libs[name]))
    print(f"{what}: " + "; ".join(
        f"{n} {np.mean(t) * 1e3:.2f} us ({', '.join(f'{v * 1e3:.2f}' for v in t)})"
        for n, t in times.items()) + f" on {card()}", flush=True)

  # The captured headline step under 'high', one per step variant.
  names = [n for n in names if n in STEP_VARIANTS]
  order = names + names[::-1]
  arms = {}
  try:
    whiten.set_precision("high")
    for name in names:
      use(libs[name])
      step, state, (real, labels), _ = bench.build_bench(
          "headline", device="cuda", seed=0)
      for _ in range(2):
        step(state, real, labels)
      arms[name] = (step, state, real, labels)
    rates = {n: [] for n in names}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for r in range(ROUNDS):
      for name in (order if r % 2 == 0 else order[::-1]):
        use(libs[name])
        step, state, real, labels = arms[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(STEPS):
          step(state, real, labels)
        end.record()
        torch.cuda.synchronize()
        assert step.last == "replay", step.calls
        rates[name].append((STEPS * 5 * 64 / (time.perf_counter() - t0),
                            start.elapsed_time(end) / STEPS))
    for name in names:
      r = np.array(rates[name])
      print(f"captured bf16 headline step under high, {name}: "
            f"{np.median(r[:, 0]):.1f} imgs/s ({r[:, 0].min():.1f}-"
            f"{r[:, 0].max():.1f}), device span {np.median(r[:, 1]):.3f} "
            f"ms a step, {len(r)} windows of {STEPS} in turns on {card()}",
            flush=True)
    for name in names:
      use(libs[name])
      step, state, real, labels = arms[name]
      kernels, _ = chip_smoke._traced_kernels(
          lambda: step(state, real, labels))
      k3 = [e for e in kernels if "mm_bf16x3_" in e.name]
      ms = lambda es: sum(e.time_range.elapsed_us() for e in es) / 1e3  # noqa
      print(f"one traced replay, {name}: {ms(kernels):.3f} ms of kernel "
            f"time in {len(kernels)} kernels; K3 {len(k3)} launches "
            f"{ms(k3):.3f} ms", flush=True)
    del arms
    for name in names:
      use(libs[name])
      ab, ab_at, cb, cb_at, same_gen, *_ = chip_smoke._graph_parity(
          dev, "bfloat16")
      print(f"{name}: captured chain of {chip_smoke.GRAPH_CHAIN} vs eager "
            f"max rel diff {ab:.3e} ({ab_at}), eager vs eager {cb:.3e}, "
            f"generators equal {same_gen}", flush=True)
  finally:
    whiten.set_precision("highest")
  print(json.dumps({"variants": names}), flush=True)
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
