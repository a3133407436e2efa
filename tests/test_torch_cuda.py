"""K1 on a CUDA card (marker ``cuda``; skipped without one).

These need a GPU and nvcc, and import no JAX, so they run where the port
runs. tests/conftest.py imports JAX, so on such a machine skip it:

  python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

K1 is held against its plain float32 version on the same tensors, to
1e-4: the reference's own on-chip gate for its moments kernel. bf16 input
is the same bf16 values on both sides, upcast."""

import pytest
import torch

from wcgan_tpu_torch.ops import cuda_wc

pytestmark = pytest.mark.cuda
ATOL = 1e-4


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device("cuda", 0)


def _max_err(a, b):
  return max(float((x - y).abs().max()) for x, y in zip(a, b))


# The ragged shapes of tests/test_pallas_wc.py, then the main path's C=256
# at its smallest and largest R.
@pytest.mark.parametrize("rows,cols", [(512, 16), (1000, 32), (64, 8),
                                       (130, 16), (1024, 256),
                                       (131072, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain(rows, cols, dtype, dev):
  gen = torch.Generator(device=dev).manual_seed(rows + cols)
  x = (torch.randn((rows, cols), generator=gen, device=dev) * 2 + 3).to(dtype)
  before = cuda_wc.MOMENTS_LAUNCHES
  mean, cov = cuda_wc.moments_cuda(x)
  torch.cuda.synchronize()
  assert cuda_wc.MOMENTS_LAUNCHES == before + 1
  assert mean.dtype == cov.dtype == torch.float32
  assert torch.equal(cov, cov.T)
  assert _max_err((mean, cov), cuda_wc.moments_reference(x)) <= ATOL


def test_k1_large_mean_keeps_diagonal(dev):
  """|mu| = 1000, sigma = 0.01: the mean is final before the products."""
  gen = torch.Generator(device=dev).manual_seed(0)
  x = torch.randn((4096, 256), generator=gen, device=dev) * 0.01 + 1000.0
  _, cov = cuda_wc.moments_cuda(x)
  diag = torch.diagonal(cov)
  assert float(diag.min()) >= 0
  assert float(((diag - 1e-4) / 1e-4).abs().max()) <= 0.2
  assert _max_err((cov,), cuda_wc.moments_reference(x)[1:]) <= 1e-6


def test_k1_gradient_matches_autograd_of_plain(dev):
  gen = torch.Generator(device=dev).manual_seed(1)
  x = torch.randn((4096, 256), generator=gen, device=dev) * 2 + 3
  w = torch.randn((256, 256), generator=gen, device=dev)
  grads = []
  for fn in (cuda_wc.moments, cuda_wc.moments_reference):
    xg = x.clone().requires_grad_(True)
    mean, cov = fn(xg)
    (torch.sum(cov * w) + torch.sum(mean ** 2)).backward()
    grads.append(xg.grad)
  assert _max_err(grads[:1], grads[1:]) <= ATOL


def test_k1_refuses_what_it_does_not_take(dev):
  before = cuda_wc.MOMENTS_LAUNCHES
  with pytest.raises(TypeError, match="float32 or bfloat16"):
    cuda_wc.moments(torch.zeros((8, 4), dtype=torch.float16, device=dev))
  with pytest.raises(ValueError, match="contiguous"):
    cuda_wc.moments(torch.zeros((4, 8), device=dev).T)
  assert cuda_wc.MOMENTS_LAUNCHES == before

