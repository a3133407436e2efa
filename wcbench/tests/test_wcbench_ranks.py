"""The harness's path over ranks (one process a card, as a four-card cell
runs) rehearsed on the CPU: the training cell in four processes of one
gloo group (``wcgan_tpu_torch.parallel.launch``), each holding its shard
of the data and its rows of the global batch, rank 0 checking against
the reference on the global batch, at the configuration's tiny copy."""

import pytest

from wcgan_tpu_torch.parallel import launch

CELL = "train.cifar10_wcres_high"
FLOAT32 = {"dtype": "float32", "whitening_precision": "highest"}


def _rank0(seed, changes=None, fault=None):
  return launch.launch("wcbench.tests.tiny:dp_rank", ["cpu"] * 4,
                       (CELL, seed, changes, fault), timeout=600)[0]


def test_ranks_follow_the_reference_in_float32():
  out = _rank0(31, FLOAT32)
  assert out["loss_gap"] < 1e-5, out
  assert out["numbers"]["g_grad_gap"] < 1e-4, out
  assert out["numbers"]["d_grad_gap"] < 1e-4, out
  assert out["numbers"]["change_gap"] < 1e-5, out


def test_a_sound_run_is_correct():
  assert _rank0(32)["correct"]


@pytest.mark.parametrize("fault", ["no_exchange", "half_batch"])
def test_a_planted_fault_is_not_correct(fault):
  assert not _rank0(33, fault=fault)["correct"]
