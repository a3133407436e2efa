"""InceptionV3 in torchvision's layout: the FID/IS feature network.

Counterpart of ``wcgan_tpu/evaluation/inception_v3.py``, written out by
hand (torchvision is not a dependency): the stock torchvision blocks in
eval mode, without ``transform_input`` and without the AuxLogits head,
and with none of pytorch-fid's FID-specific variants, as the reference
builds it. Every ``BasicConv`` is a convolution without bias, BatchNorm
with eps 1e-3 on its running statistics, and ReLU; the 3x3 average pools
(stride 1, padding 1) count the padding; the 3x3 max pools (stride 2)
are VALID. The forward takes NCHW float images in [-1, 1] of at least
75x75 (``preprocess``) and returns (pool (N, 2048), logits (N, 1000)):
the pool feeds FID, the softmax of the logits IS.

Parameter and buffer names are torchvision's ``inception_v3``
``state_dict`` keys (``Mixed_5b.branch1x1.conv.weight``,
``...bn.running_var``, ``fc.weight``), so the npz of such a state_dict
(``load_npz``, the reference's weight format) loads with no renaming.
The repository ships no weights: without them the network runs on random
ones (``init_params``) and the scorer marks its scores ``unverified_``.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# torchvision state_dict keys of parts this network does not have.
_SKIPPED_PREFIX = "AuxLogits."
_BOOKKEEPING = "num_batches_tracked"


class BasicConv(nn.Module):
  """Conv (no bias) + BatchNorm (eps 1e-3, always on its running
  statistics) + ReLU."""

  def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
    super().__init__()
    self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                          bias=False)
    self.bn = nn.BatchNorm2d(cout, eps=1e-3)

  def forward(self, x):
    bn = self.bn
    x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var,
                     bn.weight, bn.bias, False, 0.0, bn.eps)
    return F.relu(x)


def _avg_pool_3(x):
  return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool_3s2(x):
  return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):

  def __init__(self, cin: int, pool_features: int):
    super().__init__()
    self.branch1x1 = BasicConv(cin, 64, 1)
    self.branch5x5_1 = BasicConv(cin, 48, 1)
    self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
    self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
    self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
    self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
    self.branch_pool = BasicConv(cin, pool_features, 1)

  def forward(self, x):
    b5 = self.branch5x5_2(self.branch5x5_1(x))
    b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
    bp = self.branch_pool(_avg_pool_3(x))
    return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):

  def __init__(self, cin: int):
    super().__init__()
    self.branch3x3 = BasicConv(cin, 384, 3, stride=2)
    self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
    self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
    self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

  def forward(self, x):
    bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
    return torch.cat([self.branch3x3(x), bd, _max_pool_3s2(x)], dim=1)


class InceptionC(nn.Module):

  def __init__(self, cin: int, channels_7x7: int):
    super().__init__()
    c7 = channels_7x7
    self.branch1x1 = BasicConv(cin, 192, 1)
    self.branch7x7_1 = BasicConv(cin, c7, 1)
    self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
    self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
    self.branch7x7dbl_1 = BasicConv(cin, c7, 1)
    self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
    self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
    self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
    self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
    self.branch_pool = BasicConv(cin, 192, 1)

  def forward(self, x):
    b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
    bd = self.branch7x7dbl_1(x)
    for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3,
                  self.branch7x7dbl_4, self.branch7x7dbl_5):
      bd = layer(bd)
    bp = self.branch_pool(_avg_pool_3(x))
    return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):

  def __init__(self, cin: int):
    super().__init__()
    self.branch3x3_1 = BasicConv(cin, 192, 1)
    self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
    self.branch7x7x3_1 = BasicConv(cin, 192, 1)
    self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
    self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
    self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

  def forward(self, x):
    b3 = self.branch3x3_2(self.branch3x3_1(x))
    b7 = self.branch7x7x3_1(x)
    for layer in (self.branch7x7x3_2, self.branch7x7x3_3,
                  self.branch7x7x3_4):
      b7 = layer(b7)
    return torch.cat([b3, b7, _max_pool_3s2(x)], dim=1)


class InceptionE(nn.Module):

  def __init__(self, cin: int):
    super().__init__()
    self.branch1x1 = BasicConv(cin, 320, 1)
    self.branch3x3_1 = BasicConv(cin, 384, 1)
    self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
    self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
    self.branch3x3dbl_1 = BasicConv(cin, 448, 1)
    self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
    self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
    self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
    self.branch_pool = BasicConv(cin, 192, 1)

  def forward(self, x):
    b3 = self.branch3x3_1(x)
    b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
    bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
    bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                   dim=1)
    bp = self.branch_pool(_avg_pool_3(x))
    return torch.cat([self.branch1x1(x), b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
  """The eval-mode InceptionV3 trunk; returns (pool_2048, logits_1000)."""

  def __init__(self, num_classes: int = 1000):
    super().__init__()
    self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
    self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
    self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
    self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
    self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
    self.Mixed_5b = InceptionA(192, 32)
    self.Mixed_5c = InceptionA(256, 64)
    self.Mixed_5d = InceptionA(288, 64)
    self.Mixed_6a = InceptionB(288)
    self.Mixed_6b = InceptionC(768, 128)
    self.Mixed_6c = InceptionC(768, 160)
    self.Mixed_6d = InceptionC(768, 160)
    self.Mixed_6e = InceptionC(768, 192)
    self.Mixed_7a = InceptionD(768)
    self.Mixed_7b = InceptionE(1280)
    self.Mixed_7c = InceptionE(2048)
    self.fc = nn.Linear(2048, num_classes)

  def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
    x = _max_pool_3s2(x)
    x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
    x = _max_pool_3s2(x)
    for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d,
                  self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                  self.Mixed_6d, self.Mixed_6e, self.Mixed_7a,
                  self.Mixed_7b, self.Mixed_7c):
      x = block(x)
    pool = x.mean(dim=(2, 3))               # global average pool
    return pool, self.fc(pool)


def preprocess(images_u8: torch.Tensor, size: int = 299) -> torch.Tensor:
  """uint8 NHWC images of any resolution -> NCHW float32 in [-1, 1] at
  ``size`` x ``size``: /255, one channel repeated to three, bilinear
  (half-pixel centres, antialiased when shrinking, as
  ``jax.image.resize`` is; PyTorch's antialiased path rounds otherwise
  when enlarging, so it runs only to shrink), then x2 - 1. pytorch-fid's
  preprocessing."""
  x = images_u8.float().div(255.0).permute(0, 3, 1, 2)
  if x.shape[1] == 1:
    x = x.expand(-1, 3, -1, -1)
  x = F.interpolate(x, size=(size, size), mode="bilinear",
                    align_corners=False,
                    antialias=size < max(x.shape[-2:]))
  return x * 2.0 - 1.0


def init_params(seed: int = 0) -> InceptionV3:
  """The network with random weights drawn from a ``torch.Generator``
  seeded with ``seed``, by flax's initializers (the reference's random
  network): conv and dense kernels LeCun-normal (truncated at two
  standard deviations), biases 0, BatchNorm scale 1, shift 0, mean 0,
  variance 1."""
  gen = torch.Generator().manual_seed(seed)
  net = InceptionV3()
  with torch.no_grad():
    for m in net.modules():
      if isinstance(m, (nn.Conv2d, nn.Linear)):
        w = m.weight
        # Standard normals redrawn until all lie within 2 (rejection
        # sampling: about 5 % a round), then scaled as flax's
        # truncated_normal, which keeps the variance 1 / fan_in.
        w.normal_(generator=gen)
        out = w.abs() > 2.0
        while bool(out.any()):
          w[out] = torch.randn(int(out.sum()), generator=gen)
          out = w.abs() > 2.0
        w.mul_(math.sqrt(1.0 / math.prod(w.shape[1:])) / .87962566103423978)
        if m.bias is not None:
          m.bias.zero_()
  return net.eval()


def load_state(net: InceptionV3, state: Mapping[str, np.ndarray]
               ) -> InceptionV3:
  """``state`` (torchvision ``inception_v3`` state_dict keys, numpy values)
  copied into ``net``, by the reference's contract: ``AuxLogits.*`` and
  ``num_batches_tracked`` keys are skipped; an unknown key raises
  ``KeyError``, a shape that differs ``ValueError``; and a parameter or
  buffer left unloaded raises ``KeyError`` (a partially random network
  would score garbage without the ``unverified_`` mark)."""
  own: Dict[str, torch.Tensor] = {
      k: v for k, v in net.state_dict(keep_vars=True).items()
      if not k.endswith(_BOOKKEEPING)}
  written = set()
  with torch.no_grad():
    for key, val in state.items():
      if key.startswith(_SKIPPED_PREFIX) or key.endswith(_BOOKKEEPING):
        continue
      if key not in own:
        raise KeyError(f"unrecognized weight key {key}")
      val = np.array(val)
      if tuple(val.shape) != tuple(own[key].shape):
        raise ValueError(f"{key}: {val.shape} != {tuple(own[key].shape)}")
      own[key].copy_(torch.from_numpy(val))
      written.add(key)
  missing = sorted(set(own) - written)
  if missing:
    raise KeyError(f"weights left {len(missing)} parameters and buffers "
                   f"unloaded (e.g. {missing[:3]}); refusing a "
                   "partially-random network")
  return net.eval()


def load_npz(path: str) -> InceptionV3:
  """The network with the weights of ``path``, an npz of a torchvision
  ``inception_v3`` state_dict (``load_state``'s contract), made with:

      import torch, torchvision, numpy as np
      sd = torchvision.models.inception_v3(weights="DEFAULT").state_dict()
      np.savez("inception_v3.npz", **{k: v.numpy() for k, v in sd.items()})
  """
  with np.load(path) as data:
    state = dict(data)
  try:
    return load_state(InceptionV3(), state)
  except KeyError as e:
    raise KeyError(f"npz {path}: {e.args[0]}") from None
