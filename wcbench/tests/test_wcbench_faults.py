"""The comparison fails what it must: each fault a cell can have, planted
under the timed path of a whole run (the look for a card skipped, on the
CPU at the configuration's tiny copy), and the control (the reference with
float8 activation products in the program's place) read against the
cell's limits (a training cell's at its full widths, a small batch and
chains of 2). Of the faults, ``stale_draws`` is one only a CUDA graph can
have (replays that draw the capture's numbers); on the CPU it is planted
in the calls that follow the first after the warm-up, as on the card.
A sound run of the tiny size passes them."""

import argparse
import copy

import pytest
import torch

from wcbench import control
from wcbench import run as bench_run
from wcbench.core import check, harness
from wcbench.tests import tiny

TRAIN = "train.cifar10_wcres_high"
# The training cell's configuration, and the conditional cWC-sa one that no
# cell runs yet, under the training cell's traffic and limits.
CONFIGS = ("cifar10_wcres_high", "tinyin64_cwcsa")
# The faults the training limits are set to catch (``PERF.md``); D's own
# faults (``half_batch_d``, ``double_lr_d``) they catch on some seeds only.
CAUGHT = ("half_batch", "stale_draws", "unchanged_state")
SAMPLE = ("sample.cifar10_wcres_high",)
CASES = ([(TRAIN, c, f) for c in CONFIGS for f in CAUGHT]
         + [(c, None, f) for c in SAMPLE for f in control.FAULTS["sample"]])


def _correct(run, result):
  line = bench_run.result_line(run, result, harness.benchmark(),
                               bench_run.device_of(run, result))
  return line["correct"]


@pytest.mark.parametrize("cell,config,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, config, fault):
  kind = "train" if cell == TRAIN else "sample"
  with control.FAULTS[kind][fault]():
    run, result = tiny.run_cpu(cell, seed=11, seconds=0.0, config=config)
  assert not _correct(run, result), result.numbers


@pytest.mark.parametrize("cell,config", [(TRAIN, c) for c in CONFIGS]
                         + [(c, None) for c in SAMPLE])
def test_a_sound_run_is_correct(cell, config):
  run, result = tiny.run_cpu(cell, seed=12, seconds=0.0, config=config)
  assert _correct(run, result), result.numbers


def _small_batch_run(config):
  """The training cell's run at ``config``'s full widths, 4 images a batch,
  64 in the dataset and chains of 2 (the control's size on the CPU: at the
  tiny copy's few channels float8 rounding reads under the limits)."""
  cfg = copy.deepcopy(harness.config(config))
  cfg["batch_size"], cfg["dataset"]["images"] = 4, 64
  a = argparse.Namespace(workload=TRAIN, seed=13, seconds=0.0, trace=0)
  run = bench_run.make_run(a, torch.device("cpu"), harness.benchmark(),
                           cfg=cfg)
  run.traffic = dict(run.traffic, steps_per_call=2)
  return run


@pytest.mark.parametrize("config", CONFIGS)
def test_the_control_is_not_correct(config):
  run = _small_batch_run(config)
  ok, checks = check.judge(control.control_numbers(run), run.limits)
  assert not ok, checks


@pytest.mark.parametrize("cell", SAMPLE)
def test_the_sampling_control_is_not_correct(cell):
  run, _ = tiny.run_cpu(cell, seed=13, seconds=0.0)
  ok, checks = check.judge(control.control_numbers(run), run.limits)
  assert not ok, checks
