"""What the benchmark loads: nothing of JAX or of the JAX package in a
run (top-level names compared whole: the port's own name begins with the
JAX package's), and nothing of the port in the plain reference. Also: a
run without a CUDA card, or without the program beside the benchmark,
prints no result and exits with another code than 0."""

import json
import os
import shutil
import subprocess
import sys

from wcbench.core import harness

ROOT = harness.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "wcgan_tpu"}


def _modules(script: str):
  env = dict(os.environ, PYTHONPATH=str(ROOT))
  env.pop("JAX_PLATFORMS", None)
  out = subprocess.run([sys.executable, "-c", script
                        + "\nimport json, sys\n"
                        "print(json.dumps(sorted(sys.modules)))\n"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=900)
  assert out.returncode == 0, out.stderr[-3000:]
  return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_a_run_loads_nothing_of_jax():
  loaded = _modules(
      "from wcbench.tests import tiny\n"
      "import wcbench.run, wcbench.control\n"
      "for cell, config in (('train.cifar10_wcres_high', None),\n"
      "                     ('train.cifar10_wcres_high', 'tinyin64_cwcsa'),\n"
      "                     ('sample.cifar10_wcres_high', None)):\n"
      "  tiny.run_cpu(cell, seconds=0.0, config=config)\n")
  assert "wcgan_tpu_torch" in loaded
  assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
  loaded = _modules("import wcbench.reference.wcgan\n"
                    "import wcbench.work.counts\n")
  assert not loaded & (FORBIDDEN | {"wcgan_tpu_torch"})


def test_the_forbidden_check_compares_whole_names(monkeypatch):
  monkeypatch.setitem(sys.modules, "wcgan_tpu_torch_probe", sys)
  assert "wcgan_tpu" not in harness.forbidden_modules()
  monkeypatch.setitem(sys.modules, "wcgan_tpu.probe", sys)
  assert harness.forbidden_modules() == ["wcgan_tpu"]


def _run(cwd):
  return subprocess.run(
      [sys.executable, "wcbench/run.py", "--workload",
       "train.cifar10_wcres_high", "--seed", "3000000007", "--seconds", "1",
       "--trace", "0"], cwd=cwd, capture_output=True, text=True,
      timeout=300, env=dict(os.environ, PYTHONPATH=""))


def test_no_card_no_result():
  out = _run(ROOT)
  assert out.returncode != 0
  assert out.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
  shutil.copytree(ROOT / "wcbench", tmp_path / "wcbench",
                  ignore=shutil.ignore_patterns("__pycache__"))
  shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
  out = _run(tmp_path)
  assert out.returncode != 0
  assert out.stdout.strip() == ""
