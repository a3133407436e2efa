"""BENCHMARK.json and the files the harness finds by name: every cell's
configuration, traffic, limits and metrics are there, names and units keep
to their characters, and a cell and a metric added as new files are
picked up without an edit to any file that is there."""

import json
import os
import re
import shutil
import subprocess
import sys

from wcbench.core import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.benchmark()


def test_top_level_keys():
  assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  assert BENCH["command"] == ["python3", "wcbench/run.py"]
  assert BENCH["paths"] == ["wcbench"]
  assert len(json.dumps(BENCH)) < 64 * 1024


def _names():
  for key in ("configs", "workloads", "end_to_end", "per_layer"):
    for entry in BENCH[key]:
      yield entry["name"]
  for w in BENCH["workloads"]:
    yield w["config"]
    yield w["traffic"]
  for c in BENCH["configs"]:
    yield from c["reduced"]


def test_names_and_units():
  names = list(_names())
  assert all(NAME.match(n) for n in names), names
  for key in ("configs", "workloads", "end_to_end", "per_layer"):
    entries = [e["name"] for e in BENCH[key]]
    assert len(entries) == len(set(entries))
  for m in BENCH["end_to_end"] + BENCH["per_layer"]:
    assert UNIT.match(m["unit"]), m
    assert m["better"] in ("lower", "higher")
  for text in ([w["why"] for w in BENCH["workloads"]]
               + [c["why"] for c in BENCH["configs"]]
               + [m["layer"] for m in BENCH["per_layer"]]):
    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_finds_its_files():
  for w in BENCH["workloads"]:
    cfg = harness.config(w["config"])
    traffic = harness.traffic(w["traffic"])
    assert harness.driver(traffic["driver"]).run
    limits = harness.cell(w["name"])["limits"]
    assert limits and all(v > 0 for v in limits.values())
    assert cfg["name"] == w["config"]
    reported = {m["name"] for m in harness.cell_metrics(w["name"], BENCH,
                                                        False)}
    assert "setup_s" in reported and len(reported) >= 2
    assert harness.cell_metrics(w["name"], BENCH, True)
  for c in BENCH["configs"]:
    assert c["file"] == f"wcbench/configs/{c['name']}.json"
    assert harness.config(c["name"])["reduced"] == c["reduced"]
  for m in BENCH["per_layer"]:
    assert callable(harness.metric_reader(m["name"]))
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_bounds_and_run_seconds():
  setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
  assert setup and setup[0]["bound"] <= 0.25
  for m in BENCH["end_to_end"]:
    assert 0.01 <= m["bound"] <= 0.25
  runs = 2 + 14 * 24
  assert (runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200
          <= 43200)


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
  """A throwaway cell (traffic, configuration, limits) and a per-layer
  metric, added as new files to a copy, are run without an edit to any
  file of the copy but BENCHMARK.json's new entries."""
  copy = tmp_path / "checkout"
  shutil.copytree(ROOT / "wcbench", copy / "wcbench",
                  ignore=shutil.ignore_patterns("__pycache__"))
  bench = json.loads(json.dumps(BENCH))
  base = harness.config("cifar10_wcres_high")
  (copy / "wcbench/configs/probe_cfg.json").write_text(
      json.dumps(dict(base, name="probe_cfg")))
  (copy / "wcbench/traffic/probe_mix.json").write_text(json.dumps(
      dict(harness.traffic("chain8_device_data"), steps_per_call=2)))
  (copy / "wcbench/cells/train.probe.json").write_text(
      json.dumps({"limits": {"g_grad_gap": 1.0, "d_grad_gap": 1.0,
                             "change_gap": 1.0}}))
  (copy / "wcbench/metrics/probe_calls.train.py").write_text(
      "def read(ctx):\n  return float(ctx.window['calls'])\n")
  bench["configs"].append({"name": "probe_cfg", "source": "x",
                           "file": "wcbench/configs/probe_cfg.json",
                           "reduced": [], "why": "probe"})
  bench["workloads"].append({"name": "train.probe", "config": "probe_cfg",
                             "traffic": "probe_mix", "chips": 1,
                             "why": "probe"})
  bench["per_layer"].append({"name": "probe_calls.train", "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "outer step",
                             "moves": "train_imgs_per_s",
                             "workloads": ["train.probe"]})
  for m in bench["end_to_end"]:
    if m["name"] == "train_imgs_per_s":
      m["workloads"].append("train.probe")
  (copy / "BENCHMARK.json").write_text(json.dumps(bench))
  before = {p: p.read_bytes() for p in (ROOT / "wcbench").rglob("*.json")}
  script = (
      "import json, sys\n"
      "from wcbench.core import harness\n"
      "from wcbench.tests import tiny\n"
      "from wcbench import run as R\n"
      "run, res = tiny.run_cpu('train.probe', seconds=0.0)\n"
      "run.trace = True\n"
      "m = R.metrics_of(run, res, harness.benchmark())\n"
      "print(json.dumps(sorted(m)))\n")
  env = dict(os.environ, PYTHONPATH=f"{copy}{os.pathsep}{ROOT}")
  out = subprocess.run([sys.executable, "-c", script], cwd=copy, env=env,
                       capture_output=True, text=True, timeout=600)
  assert out.returncode == 0, out.stderr[-3000:]
  assert "probe_calls.train" in json.loads(out.stdout.splitlines()[-1])
  assert before == {p: p.read_bytes()
                    for p in (ROOT / "wcbench").rglob("*.json")}
