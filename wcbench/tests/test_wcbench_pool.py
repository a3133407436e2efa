"""``pool_ms_per_step.train`` on a synthetic traced slice: the device time
a step of the kernels of D's 2x2 average pool, whether ATen's NHWC kernels
run it (a program without K4) or K4 does; nothing where neither ran."""

import types

import pytest

from wcbench.core import harness
from wcbench.core.trace import Slice

ATEN = ("avg_pool2d_out_cuda_frame_nhwc",
        "avg_pool2d_backward_out_cuda_frame_nhwc")
K4 = ("avg_pool2x2_fwd", "avg_pool2x2_bwd")


def _ctx(kernels, steps=2):
  s = Slice(calls=1, wall_s=1e-3, kernels=kernels, host=[], start_us=0.0,
            end_us=1000.0)
  return types.SimpleNamespace(
      slice=s, result=types.SimpleNamespace(slice_steps=steps))


@pytest.mark.parametrize("names", [ATEN, K4], ids=["aten", "k4"])
def test_pool_ms_reads_the_pool_kernels(names):
  fwd, bwd = names
  kernels = [("conv", 0.0, 100.0), (fwd, 100.0, 130.0),
             ("vectorized_elementwise_kernel", 130.0, 200.0),
             (bwd, 200.0, 290.0), (fwd, 500.0, 530.0),
             ("upsample_nearest2d_nhwc_out_frame", 600.0, 700.0)]
  read = harness.metric_reader("pool_ms_per_step.train")
  assert read(_ctx(kernels)) == pytest.approx((30 + 90 + 30) * 1e-3 / 2)
  assert read(_ctx(kernels, steps=3)) == pytest.approx(150e-3 / 3)


def test_pool_ms_gives_nothing_without_pools():
  read = harness.metric_reader("pool_ms_per_step.train")
  assert read(_ctx([("conv", 0.0, 100.0)])) is None
  assert read(_ctx([(ATEN[0], 0.0, 10.0)], steps=0)) is None
  assert read(types.SimpleNamespace(
      slice=None, result=types.SimpleNamespace(slice_steps=2))) is None
