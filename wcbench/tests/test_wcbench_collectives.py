"""The collectives' bytes (``wcbench/work/collectives.py``, from the
configuration's shapes) against the program's counter (``mesh.STATS``)
over one data-parallel outer step on two gloo ranks, at the tiny copies
of the training configurations; each all-reduce inside a ``mesh.*`` span;
and the readers of the collectives' metrics on a synthetic slice."""

import types

import pytest
import torch

from wcbench.core import harness, program
from wcbench.core.trace import Slice
from wcbench.tests import tiny
from wcbench.work import collectives
from wcgan_tpu_torch.parallel import launch

CONFIGS = ("in64_cwcsa_dp4", "cifar10_wcres_high")


def one_step_rank(ctx, cfgs):
  """One eager outer step of each configuration in ``cfgs`` on this rank,
  in the group: the collectives ``mesh.STATS`` counted and the ``mesh.*``
  spans that ended, by configuration."""
  from wcgan_tpu_torch import trace
  from wcgan_tpu_torch.parallel import mesh
  from wcgan_tpu_torch.train.step import make_outer_step
  out = {}
  for name, cfg in cfgs.items():
    state, gan = program.build_state(cfg, ctx.device, group=ctx.group)
    b, k, res = cfg["batch_size"], gan.training_ratio, cfg["resolution"]
    gen = torch.Generator().manual_seed(ctx.rank)
    real = torch.randint(0, 256, (k, b, res, res, 3), generator=gen,
                         dtype=torch.uint8)
    labels = torch.randint(0, max(gan.num_classes, 1), (k, b),
                           generator=gen)
    mesh.STATS.reset()
    trace.reset()
    make_outer_step(gan, ctx.group)(state, real, labels)
    out[name] = {"calls": dict(mesh.STATS.calls),
                 "bytes": dict(mesh.STATS.bytes),
                 "spans": {n: e["count"] for n, e in trace.table().items()
                           if n.startswith("mesh.")}}
  return out


@pytest.fixture(scope="module")
def counted():
  cfgs = {name: tiny.tiny_config(name) for name in CONFIGS}
  ranks = launch.launch(f"{__name__}:one_step_rank", ["cpu"] * 2, (cfgs,),
                        timeout=600, quiet=True)
  return cfgs, ranks


@pytest.mark.parametrize("name", CONFIGS)
def test_bytes_a_step_equal_the_counter(counted, name):
  cfgs, ranks = counted
  want = collectives.per_step(cfgs[name])
  for r in ranks:
    assert r[name]["calls"] == want["calls"]
    assert r[name]["bytes"] == want["bytes"]


@pytest.mark.parametrize("name", CONFIGS)
def test_every_allreduce_lies_in_a_mesh_span(counted, name):
  for r in counted[1]:
    got = r[name]
    assert got["spans"] == {"mesh.moments": got["calls"]["moments"],
                            "mesh.grads": got["calls"]["grads"]}


def test_the_cell_config_counts():
  """The cell's configuration: 9 WC layers, 2 statistics all-reduces each
  in 5 fakes' forwards, the G update's forward and its backward; one
  all-reduce an update."""
  cfg = harness.config("in64_cwcsa_dp4")
  got = collectives.per_step(cfg)
  assert got["calls"] == {"moments": 9 * 2 * 7, "grads": 6}
  c = [l.c for l in collectives.S.wc_layers(cfg)]
  assert c == [512, 512, 512, 256, 256, 128, 128, 64, 64]
  assert got["bytes"]["moments"] == 7 * 4 * sum(x + x * x for x in c)
  one = collectives.AllReduce("grads", 4 * 10 ** 6)
  assert one.least_s(4) == pytest.approx(
      4e6 * 1.5 / collectives.NVLINK_BYTES_PER_S)
  assert one.least_s(1) == 0.0


def _ctx(kernels, world=4, steps=2):
  s = Slice(calls=1, wall_s=1e-3, kernels=kernels, host=[], start_us=0.0,
            end_us=1000.0)
  return types.SimpleNamespace(
      slice=s, cfg=harness.config("in64_cwcsa_dp4"),
      run=types.SimpleNamespace(world=world),
      result=types.SimpleNamespace(slice_steps=steps))


def test_share_and_roofline_read_the_nccl_kernels():
  kernels = [("conv", 0.0, 400.0),
             ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 300.0, 500.0),
             ("gemm", 600.0, 800.0)]
  share = harness.metric_reader("collective_share.train")
  roof = harness.metric_reader("allreduce_roofline.train")
  assert share(_ctx(kernels)) == pytest.approx(100.0 * 200 / 700)
  least = collectives.least_s_per_step(harness.config("in64_cwcsa_dp4"), 4)
  assert roof(_ctx(kernels)) == pytest.approx(100.0 * 2 * least / 200e-6)
  plain = [k for k in kernels if not k[0].startswith("nccl")]
  assert share(_ctx(plain)) is None and roof(_ctx(plain)) is None
  assert share(_ctx(kernels, world=1)) is None
  assert roof(_ctx(kernels, world=1)) is None
