"""Build the package's CUDA sources (K1 ``moments``, K2 ``wc_apply``, K3
``mm_bf16x3``, K4 ``avg_pool2x2``) into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface, so ``nvcc`` compiles it
in seconds (no PyTorch headers) into ``build/kernels/`` at the repository
root, on first use, and ``ctypes`` loads it. The library's file name carries
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source is rebuilt and an unchanged one is reused across
processes. A missing ``nvcc`` or a failed compile raises with the
compiler's output; nothing falls back. A compile is the span
``kernels.build`` (``trace``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

from wcgan_tpu_torch import trace

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"

# sm_90a: Hopper with its architecture-specific features (wgmma, setmaxnreg).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
  """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME."""
  found = shutil.which("nvcc")
  if found:
    return found
  home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
      or "/usr/local/cuda"
  candidate = Path(home) / "bin" / "nvcc"
  if candidate.is_file():
    return str(candidate)
  raise RuntimeError(
      "nvcc not found on PATH or under CUDA_HOME; the CUDA toolkit is "
      "needed to build the package's kernels")


def compile_library(name: str) -> Tuple[Path, str, float]:
  """Compile ``csrc/<name>.cu`` unless an identical build exists.

  Returns (library path, compiler output, seconds spent compiling; 0.0
  when the library was already built)."""
  src = CSRC_DIR / f"{name}.cu"
  # The shared headers count too: an edited header must not load a stale
  # library.
  digest = hashlib.sha256(b"".join(
      f.read_bytes() for f in (src, *sorted(CSRC_DIR.glob("*.cuh"))))
      + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
  out = BUILD_DIR / f"lib{name}_{digest}.so"
  if out.is_file():
    return out, "", 0.0
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_suffix(f".{os.getpid()}.tmp")
  cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
  t0 = time.perf_counter()
  with trace.span("kernels.build"):
    proc = subprocess.run(cmd, capture_output=True, text=True)
  seconds = time.perf_counter() - t0
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"nvcc failed to build {src} (exit "
                       f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
  os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
  return out, proc.stdout + proc.stderr, seconds


def load_moments() -> ctypes.CDLL:
  """The K1 library with its C signatures declared (built on first use)."""
  lib = _LOADED.get("moments")
  if lib is None:
    path, _, _ = compile_library("moments")
    lib = ctypes.CDLL(str(path))
    lib.wcgan_moments.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.wcgan_moments.restype = ctypes.c_int
    lib.wcgan_moments_workspace_floats.argtypes = [ctypes.c_int64,
                                                   ctypes.c_int]
    lib.wcgan_moments_workspace_floats.restype = ctypes.c_int64
    _LOADED["moments"] = lib
  return lib


def load_wc_apply() -> ctypes.CDLL:
  """The K2 library with its C signatures declared (built on first use)."""
  lib = _LOADED.get("wc_apply")
  if lib is None:
    path, _, _ = compile_library("wc_apply")
    lib = ctypes.CDLL(str(path))
    p, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
    lib.wcgan_whiten_color_apply.argtypes = [
        p, i32, i64, i32, p, p, p, p, i32, f32, i32, p, p, p]
    lib.wcgan_whiten_color_apply.restype = i32
    lib.wcgan_wc_setup.argtypes = [p, p, p, p, i32, i32, f32, i32, p, p]
    lib.wcgan_wc_setup.restype = i32
    lib.wcgan_wc_rows.argtypes = [p, i32, i64, i32, p, p, p]
    lib.wcgan_wc_rows.restype = i32
    for fn in (lib.wcgan_wc_apply_workspace_floats, lib.wcgan_wc_mt_offset,
               lib.wcgan_wc_bias_offset):
      fn.argtypes = [i32]
      fn.restype = i64
    _LOADED["wc_apply"] = lib
  return lib


def load_mm_bf16x3() -> ctypes.CDLL:
  """The K3 library with its C signatures declared (built on first use)."""
  lib = _LOADED.get("mm_bf16x3")
  if lib is None:
    path, _, _ = compile_library("mm_bf16x3")
    lib = ctypes.CDLL(str(path))
    p, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
    lib.wcgan_mm_bf16x3.argtypes = [p, i32, i64, p, i32, i64, p, i32, i32,
                                    i32, f32, f32, p]
    lib.wcgan_mm_bf16x3.restype = i32
    lib.wcgan_mm_bf16x3_plan.argtypes = [p, i64, i32, i32, i32, p]
    lib.wcgan_mm_bf16x3_plan.restype = i32
    lib.wcgan_mm_bf16x3_ns.argtypes = [p, i32, i32, p, p, p]
    lib.wcgan_mm_bf16x3_ns.restype = i32
    lib.wcgan_mm_bf16x3_ns_workspace_bytes.argtypes = [i32]
    lib.wcgan_mm_bf16x3_ns_workspace_bytes.restype = i64
    lib.wcgan_mm_bf16x3_prepare.argtypes = []
    lib.wcgan_mm_bf16x3_prepare.restype = i32
    # The row kernels' shared-memory opt-in, on the current device, before
    # any capture can hold the first launch.
    err = lib.wcgan_mm_bf16x3_prepare()
    if err != 0:
      raise RuntimeError(f"mm_bf16x3: preparing the kernels failed: "
                         f"cudaError_t {err}")
    _LOADED["mm_bf16x3"] = lib
  return lib


def load_avg_pool2x2() -> ctypes.CDLL:
  """The K4 library with its C signature declared (built on first use)."""
  lib = _LOADED.get("avg_pool2x2")
  if lib is None:
    path, _, _ = compile_library("avg_pool2x2")
    lib = ctypes.CDLL(str(path))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wcgan_avg_pool2x2.argtypes = [i32, p, i32, i32, i32, i32, p, p]
    lib.wcgan_avg_pool2x2.restype = i32
    _LOADED["avg_pool2x2"] = lib
  return lib
