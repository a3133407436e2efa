"""K4's wrapper (``wcgan_tpu_torch/ops/pool.py``) on the CPU.

On the CPU ``models.layers.downsample_avg`` runs the plain version,
``F.avg_pool2d(x, 2)``, as it did before K4: every CPU test keeps its
numbers. Here that route is held to ``F.avg_pool2d`` bit for bit and to
the JAX package's reshape-mean (``wcgan_tpu/models/layers.py``) within
two roundings of the output type (the two sum a window in another order),
forward and backward; its double backward by ``gradgradcheck`` in
float64; and the input checks the kernel's wrapper makes on CUDA tensors
as a plain function. The kernel itself runs only on a card
(``tests/test_torch_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wcgan_tpu.models import layers as jlayers
from wcgan_tpu_torch import compiled
from wcgan_tpu_torch.models import layers
from wcgan_tpu_torch.ops import pool

# (N, C, H, W): the optimized block's 3-channel image, D's widths at small
# sizes, STL-10's 48 -> 24 -> 12 -> 6, and a 2 x 2 image.
SHAPES = [(2, 3, 8, 8), (2, 16, 8, 8), (3, 8, 12, 12), (1, 5, 6, 10),
          (2, 4, 2, 2), (2, 8, 48, 48)]
DTYPES = [torch.float32, torch.bfloat16]
# float32's and bfloat16's unit roundoff.
ROUND = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -8}


def _input(shape, dtype, seed=0):
  gen = torch.Generator().manual_seed(seed)
  x = torch.randn(shape, generator=gen) * 3 + 1
  return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _jax_pool(x):
  """The JAX package's downsample_avg of NCHW ``x`` on its NHWC layout."""
  nhwc = jnp.asarray(x.float().permute(0, 2, 3, 1).numpy())
  if x.dtype == torch.bfloat16:
    nhwc = nhwc.astype(jnp.bfloat16)
  out = jlayers.downsample_avg(nhwc)
  return torch.from_numpy(np.array(out.astype(jnp.float32))).permute(
      0, 3, 1, 2)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_route_is_avg_pool2d_and_the_jax_reshape_mean(shape, dtype):
  x = _input(shape, dtype)
  got = layers.downsample_avg(x)
  assert got.dtype == dtype and got.shape == x.shape[:2] + (
      x.shape[2] // 2, x.shape[3] // 2)
  assert torch.equal(got, F.avg_pool2d(x, 2))
  want = _jax_pool(x)
  scale = float(want.abs().max())
  assert float((got.float() - want).abs().max()) <= 2 * ROUND[dtype] * scale


@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_route_gradient_is_the_jax_vjp(shape, dtype):
  """dx = g / 4 on each input of g's window: on the CPU route and through
  the JAX package's reshape-mean."""
  x = _input(shape, dtype).requires_grad_(True)
  g = _input((shape[0], shape[1], shape[2] // 2, shape[3] // 2), dtype, 1)
  layers.downsample_avg(x).backward(g)
  xp = x.detach().clone().requires_grad_(True)
  F.avg_pool2d(xp, 2).backward(g)
  assert torch.equal(x.grad, xp.grad)
  nhwc = jnp.asarray(x.detach().float().permute(0, 2, 3, 1).numpy())
  g_nhwc = jnp.asarray(g.float().permute(0, 2, 3, 1).numpy())
  _, vjp = jax.vjp(jlayers.downsample_avg, nhwc)
  want = torch.from_numpy(np.array(vjp(g_nhwc)[0])).permute(0, 3, 1, 2)
  assert torch.equal(x.grad.float(), want.to(dtype).float())
  assert torch.equal(
      x.grad, (g.float() / 4).to(dtype).repeat_interleave(2, 2)
      .repeat_interleave(2, 3))


@pytest.mark.parametrize("shape", [(2, 3, 4, 4), (1, 4, 6, 2)])
def test_cpu_route_double_backward(shape):
  x = torch.randn(shape, dtype=torch.float64).contiguous(
      memory_format=torch.channels_last).requires_grad_(True)
  assert torch.autograd.gradcheck(pool.avg_pool2x2, (x,))
  assert torch.autograd.gradgradcheck(pool.avg_pool2x2, (x,))


@pytest.mark.parametrize("shape", [(128, 3, 64, 64), (128, 64, 64, 64),
                                   (128, 512, 8, 8), (64, 128, 32, 32),
                                   (64, 256, 48, 48), (1, 1, 2, 2)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_pool_input_checks_take_every_configurations_shape(shape, dtype):
  x = torch.empty(shape, dtype=dtype, device="meta").to(
      memory_format=torch.channels_last)
  pool.check_pool_input(x)


@pytest.mark.parametrize("shape,dtype,layout,err", [
    ((2, 8, 7, 8), torch.bfloat16, "cl", "even"),
    ((2, 8, 8, 5), torch.float32, "cl", "even"),
    ((2, 8, 8, 8), torch.bfloat16, "nchw", "channels_last"),
    ((2, 8, 8, 8), torch.float32, "slice", "channels_last"),
    ((2, 8, 8, 8), torch.float16, "cl", "float32 or bfloat16"),
    ((2, 8, 8, 8), torch.float64, "cl", "float32 or bfloat16"),
    ((8, 8, 8), torch.float32, "3d", "channels_last"),
    ((1, 2 ** 14, 2, 2 ** 16), torch.bfloat16, "cl", "2\\^31"),
])
def test_pool_input_checks_refuse(shape, dtype, layout, err):
  if layout == "3d":
    x = torch.empty(shape, dtype=dtype, device="meta")
  else:
    x = torch.empty(shape, dtype=dtype, device="meta").to(
        memory_format=torch.contiguous_format if layout == "nchw"
        else torch.channels_last)
    if layout == "slice":
      x = torch.empty((2, 16, 8, 8), dtype=dtype, device="meta").to(
          memory_format=torch.channels_last)[:, ::2]
  with pytest.raises((ValueError, TypeError), match=err):
    pool.check_pool_input(x)


def test_gradient_copies_to_channels_last_and_counts_it(monkeypatch):
  before = pool.AVG_POOL2X2_COPIES
  monkeypatch.setattr(pool, "AVG_POOL2X2_COPIES", before)
  g = torch.randn((2, 8, 4, 4)).contiguous(memory_format=torch.channels_last)
  assert pool._channels_last(g) is g
  assert pool.AVG_POOL2X2_COPIES == before
  nchw = torch.randn((2, 8, 4, 4))
  got = pool._channels_last(nchw)
  assert got.is_contiguous(memory_format=torch.channels_last)
  assert torch.equal(got, nchw) and pool.AVG_POOL2X2_COPIES == before + 1


def test_compiled_counts_carry_k4s_counters(monkeypatch):
  """A replay adds the captured call's K4 launches and copies."""
  monkeypatch.setattr(pool, "AVG_POOL2X2_LAUNCHES", 5)
  monkeypatch.setattr(pool, "AVG_POOL2X2_COPIES", 2)
  counts = compiled._counts(None)
  assert counts["avg_pool2x2"] == 5 and counts["avg_pool2x2_copies"] == 2
  counts["avg_pool2x2"], counts["avg_pool2x2_copies"] = 96, 3
  compiled._put(counts, None)
  assert pool.AVG_POOL2X2_LAUNCHES == 96 and pool.AVG_POOL2X2_COPIES == 3
