"""The plain reference against the port run in float32 (whitening products
in true float32), on the CPU at the configurations' tiny copies (the
conditional cWC-sa one, which no cell runs yet, under the training
cell's traffic): the same
weights, data and draws give the same losses, gradients and weights to
float32 rounding. The bf16 program's gaps (what a run reads) are far
larger, so these bounds say the reference is the model the program
runs, not how close a bf16 run comes."""

import pytest

from wcbench.tests import tiny


@pytest.mark.parametrize("config", ["cifar10_wcres_high",
                                    "tinyin64_cwcsa"])
def test_reference_follows_the_program_in_float32(config):
  _, result = tiny.run_cpu("train.cifar10_wcres_high", seed=21, seconds=0.0,
                           config=config, dtype="float32",
                           whitening_precision="highest")
  n = {k: v["value"] for k, v in result.numbers.items()}
  assert result.numbers["change_gap"]["loss_gap"] < 1e-4, result.numbers
  assert n["g_grad_gap"] < 1e-3, result.numbers
  assert n["d_grad_gap"] < 1e-3, result.numbers
  assert n["change_gap"] < 1e-3, result.numbers


def test_reference_images_equal_the_programs_in_float32():
  _, result = tiny.run_cpu("sample.cifar10_wcres_high", seed=22,
                           seconds=0.3, dtype="float32",
                           whitening_precision="highest")
  assert result.numbers["image_gap"]["checked"] > 0
  assert result.numbers["image_gap"]["value"] < 0.05, result.numbers
