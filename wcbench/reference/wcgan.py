"""The plain reference: a WC-GAN in float32 PyTorch, written from the paper.

Siarohin et al., "Whitening and Coloring Batch Transform for GANs", ICLR
2019: a ResNet generator whose normalization layers whiten each batch's
activations with the inverse square root of their full channel covariance
(coupled Newton-Schulz, 15 iterations, trace-normalized, with an SPD
jitter) and color them with a learned 1x1 convolution ('uconv') or, for a
conditional G, a class filter mixed from shared basis filters plus a
class-agnostic one ('ucconv-sa'); an SN ResNet discriminator (Miyato et
al. 2018, one power iteration a forward), with a projection head when
conditional; hinge losses; Adam. One outer step is K D updates on real
and fake images, then one G update at twice the batch, the only place the
generator's running statistics advance (momentum 0.99).

Everything is a function of explicit tensors: parameters ``P`` (name ->
tensor), buffers ``B`` (running statistics, SN vectors), inputs. No
kernel, no batching trick, no cache; float32 throughout (the caller turns
TF32 off). The products of activations go through ``Act``, so that the
control can run the same model with its activations in a lower precision
(``Act('fp8')``: per-tensor scaled float8 e4m3 operands, float32
accumulation, gradients straight through).

This file imports torch and the benchmark's shape lists only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from wcbench.work import shapes as S

Tensors = Dict[str, torch.Tensor]

E4M3_MAX = 448.0


class Act:
  """Products of activations (convolutions, dense layers, the WC layers'
  row products) in float32 (``None``) or with float8 e4m3 operands
  (``'fp8'``), each operand scaled by its largest magnitude."""

  def __init__(self, kind: Optional[str] = None):
    if kind not in (None, "fp8"):
      raise ValueError(f"unknown activation precision {kind!r}")
    self.kind = kind

  def q(self, t: torch.Tensor) -> torch.Tensor:
    if self.kind is None:
      return t
    with torch.no_grad():
      scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
      low = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (low - t.detach())

  def mm(self, a, b):
    return self.q(a) @ self.q(b)

  def bmm(self, a, b):
    return torch.bmm(self.q(a), self.q(b))

  def conv(self, x, w, b):
    return F.conv2d(self.q(x), self.q(w), b, padding=w.shape[-1] // 2)


# -- parameters ---------------------------------------------------------------


def g_specs(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
  """(name, shape, init) of every generator parameter and buffer; init is
  ('normal', std), ('zeros',), ('ones',) or ('eye',)."""
  g = cfg["generator"]
  ncls, emb = S.num_classes(cfg), g.get("filters_emb", 10)
  out = []
  for l in S.g_layers(cfg):
    if isinstance(l, S.WC):
      c = l.c
      if l.coloring == "uconv":
        out += [(f"{l.name}.gamma", (c, c), ("eye",)),
                (f"{l.name}.beta", (c,), ("zeros",))]
      else:
        out += [(f"{l.name}.gamma_a", (c, c), ("eye",)),
                (f"{l.name}.beta_a", (c,), ("zeros",)),
                (f"{l.name}.basis", (emb, c, c), ("normal", 0.02)),
                (f"{l.name}.embedding", (ncls, emb), ("ones",)),
                (f"{l.name}.beta_c", (ncls, c), ("zeros",))]
      out += [(f"{l.name}.mean", (c,), ("zeros",)),
              (f"{l.name}.cov", (c, c), ("eye",))]
    else:
      shape = ((l.cout, l.cin) if l.name == "fc_in"
               else (l.cout, l.cin, l.k, l.k))
      std = math.sqrt(1.0 / (l.cin * l.k * l.k))
      out += [(f"{l.name}.weight", shape, ("normal", std)),
              (f"{l.name}.bias", (l.cout,), ("zeros",))]
  return out


def d_specs(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
  """(name, shape, init) of every discriminator parameter and SN vector."""
  out = []
  for l in S.d_layers(cfg):
    shape = ((l.cout, l.cin) if l.name == "fc_out"
             else (l.cout, l.cin, l.k, l.k))
    std = math.sqrt(2.0 / ((l.cin + l.cout) * l.k * l.k))
    out += [(f"{l.name}.weight", shape, ("normal", std)),
            (f"{l.name}.bias", (l.cout,), ("zeros",)),
            (f"{l.name}.u", (l.cout,), ("normal", 1.0))]
  if S.projection(cfg):
    ncls, feat = S.num_classes(cfg), S.d_features(cfg)
    out += [("proj_emb.embedding", (ncls, feat),
             ("normal", math.sqrt(2.0 / (ncls + feat)))),
            ("proj_emb.u", (feat,), ("normal", 1.0))]
  return out


BUFFER_SUFFIXES = (".mean", ".cov", ".u")


def is_buffer(name: str) -> bool:
  return name.endswith(BUFFER_SUFFIXES)


# -- whitening ----------------------------------------------------------------


def ns_inv_sqrt(cov: torch.Tensor, iters: int, eps: float = 1e-5
                ) -> torch.Tensor:
  """W with W cov W^T = I: the coupled Newton-Schulz iteration on
  A = (cov + jitter I) / tr(cov + jitter I); Z -> A^{-1/2}."""
  c = cov.shape[-1]
  eye = torch.eye(c, device=cov.device)
  diag = torch.diagonal(cov)
  jitter = (eps * torch.clamp(diag.sum() / c, min=0.0)
            + 2.0 * torch.clamp(-diag.min(), min=0.0) + 1e-12)
  a = cov + jitter * eye
  scale = torch.diagonal(a).sum()
  y, z = a / scale, eye
  for _ in range(iters):
    t = 1.5 * eye - 0.5 * (z @ y)
    y, z = y @ t, t @ z
  return z / torch.sqrt(scale)


def _rows(x: torch.Tensor) -> torch.Tensor:
  return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


def wc_layer(cfg: dict, P: Tensors, B: Tensors, new_b: Optional[Tensors],
             l: S.WC, x: torch.Tensor, labels, train: bool, act: Act
             ) -> torch.Tensor:
  """Whitening with the batch's moments (train) or the running ones
  (eval), then the coloring; the running statistics advance into
  ``new_b`` when it is given. out = (x - mu) W^T G^T + b, computed as
  x M^T + (b - mu M^T) with M = G W."""
  g = cfg["generator"]
  n, c, h, w = x.shape
  rows = _rows(x)
  if train:
    mean = rows.mean(0)
    xc = rows - mean
    cov = xc.T @ xc / rows.shape[0]
    if new_b is not None:
      m = g["wc_momentum"]
      new_b[f"{l.name}.mean"] = m * B[f"{l.name}.mean"] + (1 - m) * mean.detach()
      new_b[f"{l.name}.cov"] = m * B[f"{l.name}.cov"] + (1 - m) * cov.detach()
  else:
    mean, cov = B[f"{l.name}.mean"], B[f"{l.name}.cov"]
  wm = ns_inv_sqrt(cov, g["ns_iters"])
  if l.coloring == "uconv":
    fold = P[f"{l.name}.gamma"] @ wm
    out = act.mm(rows, fold.T) + (P[f"{l.name}.beta"] - mean @ fold.T)
  else:
    y = labels.long()
    colour = (torch.einsum("nk,koc->noc", P[f"{l.name}.embedding"][y],
                           P[f"{l.name}.basis"]) + P[f"{l.name}.gamma_a"])
    bias = P[f"{l.name}.beta_c"][y] + P[f"{l.name}.beta_a"]
    fold = colour @ wm                                    # (N, C, C)
    bias = bias - torch.einsum("c,noc->no", mean, fold)
    out = act.bmm(rows.view(n, h * w, c), fold.transpose(1, 2))
    out = (out + bias[:, None, :]).reshape(-1, c)
  return out.view(n, h, w, c).permute(0, 3, 1, 2)


# -- the two networks ---------------------------------------------------------


def generator(cfg: dict, P: Tensors, B: Tensors, z: torch.Tensor,
              labels: Optional[torch.Tensor], train: bool, act: Act,
              new_b: Optional[Tensors] = None) -> torch.Tensor:
  """Images (N, 3, H, W) in [-1, 1] from z (N, z_dim) and labels."""
  g = cfg["generator"]
  layers = {l.name: l for l in S.g_layers(cfg)}
  base, f0 = g["base_resolution"], g["filters"][0]

  def conv(name, h):
    return act.conv(h, P[f"{name}.weight"], P[f"{name}.bias"])

  def wc(name, h):
    return wc_layer(cfg, P, B, new_b, layers[name], h, labels, train, act)

  h = act.mm(z, P["fc_in.weight"].T) + P["fc_in.bias"]
  h = h.view(-1, base, base, f0).permute(0, 3, 1, 2)
  for i in range(len(g["filters"])):
    up = F.relu(wc(f"block{i}.nc1", h))
    up = F.interpolate(up, scale_factor=2, mode="nearest")
    r = conv(f"block{i}.conv1", up)
    r = conv(f"block{i}.conv2", F.relu(wc(f"block{i}.nc2", r)))
    sc = conv(f"block{i}.conv_sc",
              F.interpolate(h, scale_factor=2, mode="nearest"))
    h = r + sc
  h = conv("conv_out", F.relu(wc("nc_out", h)))
  return torch.tanh(h)


def _l2n(v: torch.Tensor) -> torch.Tensor:
  return v * torch.rsqrt(torch.sum(v * v) + 1e-12)


def _sn(w2d: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
  """sigma of a (rows, cols) matrix by one power iteration from u, and the
  next u; sigma keeps its gradient in W."""
  with torch.no_grad():
    v = _l2n(u @ w2d)
    u_new = _l2n(w2d @ v)
  return u_new @ w2d @ v, u_new


def sn_read(w2d: torch.Tensor, u_after: torch.Tensor) -> torch.Tensor:
  """A vector u from which one power iteration at ``w2d`` (``_sn``) gives
  ``u_after``: the SN vector a D update read, worked back from the one it
  left. The iteration's v lies in W's row space, where W^+ inverts W, so
  v = W^+ u_after normalized, and any u with W^T u along v reads it."""
  pinv = torch.linalg.pinv(w2d.double())
  v = _l2n(pinv @ u_after.double())
  return _l2n(pinv.T @ v).to(u_after.dtype)


def d_sn_read(cfg: dict, PD: Tensors, BD: Tensors) -> Tensors:
  """``BD`` with every SN vector worked back by ``sn_read`` at ``PD``."""
  out = dict(BD)
  for l in S.d_layers(cfg):
    w = PD[f"{l.name}.weight"].detach()
    out[f"{l.name}.u"] = sn_read(w.reshape(w.shape[0], -1),
                                 BD[f"{l.name}.u"])
  if S.projection(cfg):
    out["proj_emb.u"] = sn_read(PD["proj_emb.embedding"].detach().T,
                                BD["proj_emb.u"])
  return out


def discriminator(cfg: dict, P: Tensors, B: Tensors, x: torch.Tensor,
                  labels: Optional[torch.Tensor], act: Act,
                  new_b: Optional[Tensors] = None) -> torch.Tensor:
  """Scores (N,) of images (N, 3, H, W); each SN vector advances into
  ``new_b`` when it is given."""
  d = cfg["discriminator"]
  filters, down = d["filters"], d["downsample"]
  names = {l.name for l in S.d_layers(cfg)}

  def weight(name):
    w = P[f"{name}.weight"]
    sigma, u_new = _sn(w.reshape(w.shape[0], -1), B[f"{name}.u"])
    if new_b is not None:
      new_b[f"{name}.u"] = u_new
    return w / sigma

  def conv(name, h):
    return act.conv(h, weight(name), P[f"{name}.bias"])

  h = F.avg_pool2d(conv("block0.conv2", F.relu(conv("block0.conv1", x))), 2)
  h = h + conv("block0.conv_sc", F.avg_pool2d(x, 2))
  for i in range(1, len(filters)):
    r = conv(f"block{i}.conv1", F.relu(h))
    r = conv(f"block{i}.conv2", F.relu(r))
    sc = h
    if f"block{i}.conv_sc" in names:
      sc = conv(f"block{i}.conv_sc", sc)
    if down[i]:
      r, sc = F.avg_pool2d(r, 2), F.avg_pool2d(sc, 2)
    h = r + sc
  feat = torch.sum(F.relu(h), dim=(2, 3))
  score = (act.mm(feat, weight("fc_out").T) + P["fc_out.bias"])[:, 0]
  if S.projection(cfg):
    table = P["proj_emb.embedding"]
    sigma, u_new = _sn(table.T, B["proj_emb.u"])
    if new_b is not None:
      new_b["proj_emb.u"] = u_new
    score = score + torch.sum((table / sigma)[labels.long()] * feat, dim=-1)
  return score


# -- training -----------------------------------------------------------------


class Adam:
  """Adam (eps after the bias-corrected square root) with the LR
  schedule's factor of the update count: 'none' or 'linear' to 0 over
  ``total`` updates."""

  def __init__(self, names: List[str], lr: float, b1: float, b2: float,
               eps: float, schedule: str, total: int):
    self.names, self.lr, self.b1, self.b2, self.eps = names, lr, b1, b2, eps
    self.schedule, self.total = schedule, max(int(total), 1)
    self.m: Tensors = {}
    self.v: Tensors = {}
    self.t = 0

  def _factor_at(self, t: int) -> float:
    if self.schedule in ("none", "", None):
      return 1.0
    if self.schedule == "linear":
      return 1.0 - min(t, self.total) / self.total
    raise ValueError(f"no reference for LR schedule {self.schedule!r}")

  @torch.no_grad()
  def step(self, P: Tensors, grads: List[torch.Tensor]) -> None:
    lr = self.lr * self._factor_at(self.t)
    self.t += 1
    bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
    for name, g in zip(self.names, grads):
      m = self.m.get(name, torch.zeros_like(g))
      v = self.v.get(name, torch.zeros_like(g))
      m = self.b1 * m + (1 - self.b1) * g
      v = self.b2 * v + (1 - self.b2) * g * g
      self.m[name], self.v[name] = m, v
      P[name].sub_(lr / bc1 * m / (torch.sqrt(v / bc2) + self.eps))

  def undo(self, P: Tensors) -> Tensors:
    """The parameters before this Adam's last update, from ``P`` after
    it and the moments it left (in float64, rounded to ``P``'s type)."""
    lr = self.lr * self._factor_at(self.t - 1)
    bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
    out = {}
    for name in self.names:
      m, v = self.m[name].double(), self.v[name].double()
      step = lr / bc1 * m / (torch.sqrt(v / bc2) + self.eps)
      out[name] = (P[name].double() + step).to(P[name].dtype)
    return out


def draw_step(cfg: dict, gen: torch.Generator, n_data: int, batch: int,
              device, shards: int = 1) -> Dict[str, torch.Tensor]:
  """The draws of one outer step at global batch ``batch``, in the order
  the system under test takes them from its generator: the dataset picks
  (K, B), z for the D updates (K, B, z) and the G update (gB, z), the flips
  (K, B), then, when conditional, the fake labels. With ``shards`` > 1 the
  data is split into that many equal contiguous shards, one a rank, and
  the B columns into as many blocks: a pick is drawn within a shard, and
  block r's picks index shard r."""
  gan = cfg["gan"]
  k, gb = gan["training_ratio"], batch * gan["generator_batch_multiple"]
  shard = n_data // shards
  idx = torch.randint(0, shard, (k, batch), generator=gen, device=device)
  if shards > 1:
    block = torch.arange(batch, device=device) // (batch // shards)
    idx = idx + block * shard
  out = {"idx": idx,
         "z_d": torch.randn((k, batch, cfg["z_dim"]), generator=gen,
                            device=device),
         "z_g": torch.randn((gb, cfg["z_dim"]), generator=gen,
                            device=device)}
  if gan["random_flip"]:
    out["flip"] = torch.rand((k, batch), generator=gen, device=device) < 0.5
  if S.num_classes(cfg):
    ncls = S.num_classes(cfg)
    out["y_d"] = torch.randint(0, ncls, (k, batch), generator=gen,
                               device=device)
    out["y_g"] = torch.randint(0, ncls, (gb,), generator=gen, device=device)
  return out


def real_images(u8: torch.Tensor, flip: Optional[torch.Tensor]
                ) -> torch.Tensor:
  """uint8 (..., H, W, C) -> float32 (..., C, H, W) in [-1, 1], flipped
  along W where ``flip``."""
  x = u8.float() / 127.5 - 1.0
  if flip is not None:
    x = torch.where(flip[..., None, None, None], x.flip(-2), x)
  return x.movedim(-1, -3)


class Trainer:
  """The reference's training run: G and D parameters, buffers and two
  Adams, advanced one outer step at a time, from the benchmark's weights
  or from some run's state (``load``)."""

  def __init__(self, cfg: dict, weights: Dict[str, Tensors], act: Act):
    self.cfg, self.act = cfg, act
    self.BG, self.BD = ({n: t.clone() for n, t in weights[m].items()
                         if is_buffer(n)} for m in ("g", "d"))
    self.PG, self.PD = ({n: t.clone().requires_grad_(True)
                         for n, t in weights[m].items() if not is_buffer(n)}
                        for m in ("g", "d"))
    o, k = cfg["optim"], cfg["gan"]["training_ratio"]
    self.opt_g = Adam(list(self.PG), o["generator_lr"], o["beta1"],
                      o["beta2"], o["eps"], o["lr_decay_schedule"],
                      o["total_outer_steps"])
    self.opt_d = Adam(list(self.PD), o["discriminator_lr"], o["beta1"],
                      o["beta2"], o["eps"], o["lr_decay_schedule"],
                      o["total_outer_steps"] * k)
    self.last_grads: Dict[str, Tensors] = {}

  @classmethod
  def load(cls, cfg: dict, state: Dict[str, dict], act: Act, device
           ) -> "Trainer":
    """A trainer at ``state`` (``snapshot``'s form: by model, its
    ``tensors``, Adam's ``m`` and ``v`` by name and its count ``t``),
    moved to ``device``."""
    ref = cls(cfg, {m: {n: t.to(device) for n, t in s["tensors"].items()}
                    for m, s in state.items()}, act)
    for m, opt in (("g", ref.opt_g), ("d", ref.opt_d)):
      opt.m = {n: t.to(device) for n, t in state[m]["m"].items()}
      opt.v = {n: t.to(device) for n, t in state[m]["v"].items()}
      opt.t = state[m]["t"]
    return ref

  def snapshot(self) -> Dict[str, dict]:
    """Every tensor, Adam's moments and count, by model, on the host."""
    out = {}
    for m, opt in (("g", self.opt_g), ("d", self.opt_d)):
      out[m] = {"tensors": {n: t.detach().cpu()
                            for n, t in self.tensors()[m].items()},
                "m": {n: t.cpu() for n, t in opt.m.items()},
                "v": {n: t.cpu() for n, t in opt.v.items()}, "t": opt.t}
    return out

  def outer_step(self, draws: Dict[str, torch.Tensor], data_x, data_y
                 ) -> Tuple[float, float]:
    """One outer step; returns (mean D loss over the K updates, G loss)
    as tensors, and keeps each model's last gradient by name
    (``last_grads['g' | 'd']``)."""
    cfg, act = self.cfg, self.act
    k = draws["idx"].shape[0]
    d_losses = []
    for i in range(k):
      real, y_real, z, y_fake = d_update_inputs(cfg, draws, i, data_x,
                                                data_y)
      new_b: Tensors = {}
      loss, grads = d_update_gradient(cfg, self.PG, self.BG, self.PD,
                                      self.BD, real, y_real, z, y_fake, act,
                                      new_b)
      self.BD.update(new_b)
      self.opt_d.step(self.PD, grads)
      self.last_grads["d"] = dict(zip(self.PD, grads))
      d_losses.append(loss)
    new_b = {}
    g_loss, grads = g_update_gradient(cfg, self.PG, self.BG, self.PD,
                                      self.BD, draws["z_g"], draws.get("y_g"),
                                      act, new_b)
    self.BG.update(new_b)
    self.opt_g.step(self.PG, grads)
    self.last_grads["g"] = dict(zip(self.PG, grads))
    return torch.stack(d_losses).mean(), g_loss

  def tensors(self) -> Dict[str, Tensors]:
    """Every parameter and buffer, by model ('g', 'd') and name."""
    return {"g": {**{n: p.detach() for n, p in self.PG.items()}, **self.BG},
            "d": {**{n: p.detach() for n, p in self.PD.items()}, **self.BD}}


def d_update_inputs(cfg: dict, draws: Dict[str, torch.Tensor], i: int,
                    data_x: torch.Tensor, data_y: torch.Tensor):
  """(real images, their labels, z, fake labels) of the ``i``-th D update
  of an outer step's ``draws`` (labels None when unconditional)."""
  cond = S.num_classes(cfg) > 0
  idx = draws["idx"][i]
  flip = draws["flip"][i] if "flip" in draws else None
  real = real_images(data_x.index_select(0, idx), flip)
  y_real = data_y.index_select(0, idx) if cond else None
  return real, y_real, draws["z_d"][i], draws["y_d"][i] if cond else None


def d_update_gradient(cfg: dict, PG: Tensors, BG: Tensors, PD: Tensors,
                      BD: Tensors, real: torch.Tensor, y_real, z: torch.Tensor,
                      y_fake, act: Act, new_b: Optional[Tensors] = None):
  """A D update's hinge loss on ``real`` and G's fakes of ``z`` (G in
  train mode, its statistics frozen) and its gradient in every D
  parameter (in ``PD``'s order); each SN vector advances into ``new_b``
  when it is given."""
  b = real.shape[0]
  with torch.no_grad():
    fake = generator(cfg, PG, BG, z, y_fake, True, act)
  labels = torch.cat([y_real, y_fake]) if y_real is not None else None
  scores = discriminator(cfg, PD, BD, torch.cat([real, fake]), labels, act,
                         new_b)
  loss = (torch.mean(F.relu(1.0 - scores[:b]))
          + torch.mean(F.relu(1.0 + scores[b:])))
  return loss.detach(), torch.autograd.grad(loss, list(PD.values()))


def g_update_gradient(cfg: dict, PG: Tensors, BG: Tensors, PD: Tensors,
                      BD: Tensors, z: torch.Tensor,
                      labels: Optional[torch.Tensor], act: Act,
                      new_b: Optional[Tensors] = None):
  """The G update's loss -E[D(G(z))] and its gradient in every G
  parameter (in ``PG``'s order), D reading its SN vectors as they are;
  G's running statistics advance into ``new_b`` when it is given."""
  fake = generator(cfg, PG, BG, z, labels, True, act, new_b)
  g_loss = -torch.mean(discriminator(cfg, PD, BD, fake, labels, act))
  return g_loss.detach(), torch.autograd.grad(g_loss, list(PG.values()))


def to_u8(images: torch.Tensor) -> torch.Tensor:
  """(N, 3, H, W) in [-1, 1] -> uint8 (N, H, W, 3), as a sampler delivers
  them: clipped, scaled to [0, 255], truncated."""
  x = images.permute(0, 2, 3, 1)
  return (torch.clamp(x, -1.0, 1.0) * 127.5 + 127.5).to(torch.uint8)
