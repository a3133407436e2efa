"""The outer step: K discriminator updates, then one generator update.

Counterpart of ``wcgan_tpu/train/step.py::make_outer_step``. The reference
compiles the outer step into one XLA program; here it runs eagerly and
updates the state in place. Semantics kept from the reference:

- During the K D updates G is frozen and runs in train mode (batch-stat
  whitening), but its running statistics do not advance.
- A D without WC layers scores real and fake images in one concatenated
  forward per D update, which advances every SN ``u`` once. A D with WC
  layers scores them apart, so that each batch is whitened with its own
  statistics; only the real pass advances D's statistics and ``u``.
- WGAN-GP (``gradient_penalty_weight`` > 0) adds the penalty on
  interpolates of the real and fake batch, scored with the real labels.
- Conditional runs draw the fake labels uniformly per D update and per G
  update; D sees labels when it projects, classifies or colors by class.
  AC-GAN adds the auxiliary cross-entropy on real logits to the D loss and
  on fake logits to the G loss.
- The G update runs at ``generator_batch_multiple`` x B; it is the only
  place G's running statistics advance, and D's statistics do not. D's
  ``u`` advances there only with ``sn_update_on_g_step``. With
  ``g_ema_decay`` > 0 the EMA shadow follows each G update.

Options of the reference's step:

- ``batched_fake_gen``: one G forward over the K per-update z batches
  concatenated (K x B rows, so a WC G whitens them with K x B-row
  statistics), its K chunks going to the D updates in order;
- ``d_fake_stats='running'``: the D-phase fakes come from G in eval mode,
  on its running statistics (the split path, or K2 under ``kernel_eval``),
  so the moments kernel K1 runs only in the G update;
- ``sn_update_on_g_step``: the G update's D forward advances D's ``u``.

The reference's scores of fake images, of interpolates and of the G update
read D's pre-update ``u`` and statistics (its mutable collections are
threaded through, not rebound). The port rebinds them in place, so every
pass that must not see the update runs before the pass that makes it.

``make_dataset_step`` draws the real batches on the device from a
dataset that lives there, and ``_multi`` chains outer steps, as the
reference's device-data path does.

The compiled step (the reference's ``make_jit_step`` and
``make_jit_dataset_step``, ``jax.jit`` of the step and of its
``steps_per_call`` chain, and with a process group its
``make_sharded_step`` and ``make_sharded_dataset_step``): on CUDA each is
a ``torch.cuda.CUDAGraph`` of one outer step or of a whole chain, one
replay a call (``JitStep``, on ``compiled.Program``); under an NCCL group
each rank captures its own graph, its all-reduces inside it. On the CPU
the same callables run the eager body on the same static buffers. A gloo
group on CUDA is refused: gloo's collectives run on the host.

Data parallelism (the reference's ``make_sharded_step`` and
``make_sharded_dataset_step``): with a process ``group`` every rank runs
the outer step on its own rows of the global batch, its models built with
the same group so that their statistics are the global batch's. Each
update's gradients and loss are averaged over the ranks in one all-reduce
before Adam, so every parameter, buffer, Adam slot and schedule stays
equal on all ranks (not ``DistributedDataParallel``, which would
broadcast rank 0's buffers over the statistics and SN vectors). Every
rank draws the global batch's noise, labels, flips and dataset picks from
the replicated ``state.generator`` and keeps its own block of them, so
that the generator stays replicated, the ranks draw apart, and a
sharded step draws what one process draws on the global batch; the draws
live on the device and advance on every replay. The reference folds the
replica index into the step's key instead, so the draws match its only in
distribution. Injected ``noise`` overrides them, rank by rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from wcgan_tpu_torch import compiled
from wcgan_tpu_torch.ops import losses as loss_ops
from wcgan_tpu_torch.parallel import mesh
from wcgan_tpu_torch.train.state import GANTrainState

GAN_TYPES = ("gan", "projection", "acgan")


@dataclasses.dataclass(frozen=True)
class GANConfig:
  """Objective and update schedule (the subset the port supports)."""

  loss: str = "hinge"                 # hinge | ns | wgan | wgan-gp
  gan_type: str = "gan"               # gan | projection | acgan
  training_ratio: int = 5
  generator_batch_multiple: int = 2
  gradient_penalty_weight: float = 0.0
  num_classes: int = 0                # 0 => unconditional
  z_dim: int = 128
  random_flip: bool = False
  g_ema_decay: float = 0.0            # EMA of G params for sampling (0 = off)
  sn_update_on_g_step: bool = False   # the G update's D pass advances u
  batched_fake_gen: bool = False      # one G forward for the K fake batches
  d_fake_stats: str = "batch"         # 'batch' | 'running' (eval-mode G in
                                      # the D phase)

  def __post_init__(self):
    if self.gan_type not in GAN_TYPES:
      raise ValueError(f"gan_type must be one of {GAN_TYPES}, got "
                       f"{self.gan_type!r}")
    if self.d_fake_stats not in ("batch", "running"):
      raise ValueError(f"d_fake_stats must be 'batch' or 'running', "
                       f"got {self.d_fake_stats!r}")

  @property
  def conditional(self) -> bool:
    return self.num_classes > 0


def prepare_real(real: torch.Tensor, flip: Optional[torch.Tensor]
                 ) -> torch.Tensor:
  """uint8 (..., B, H, W, C) -> float32 in [-1, 1], each image flipped
  along W where ``flip`` (..., B) is True, returned as (..., B, C, H, W)
  in channels_last memory (the NHWC bytes, permuted)."""
  if real.dtype == torch.uint8:
    real = real.float() / 127.5 - 1.0
  if flip is not None:
    real = torch.where(flip[..., None, None, None], real.flip(-2), real)
  return real.movedim(-1, -3)


def as_tensor(a, device: torch.device) -> torch.Tensor:
  if torch.is_tensor(a):
    return a.to(device)
  # np.array copies: arrays handed over from other frameworks are often
  # read-only, which torch.from_numpy does not support.
  return torch.from_numpy(np.array(a)).to(device)


def _global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
  return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


def _apply(params, grads, opt, sched) -> None:
  for p, g in zip(params, grads):
    p.grad = g
  opt.step()
  sched.step()
  opt.zero_grad(set_to_none=True)


# The draws laid out along the G update's batch (axis 0); the others are
# (K, B, ...), along axis 1.
_G_BATCH_DRAWS = ("z_g", "y_g")


def rank_block(draws: Dict[str, torch.Tensor], group: mesh.Group
               ) -> Dict[str, torch.Tensor]:
  """This rank's contiguous block of the global batch's ``draws`` (all of
  them when ``group`` is None), as ``make_outer_step`` lays them out."""
  if group is None:
    return draws
  n, r = mesh.world_size(group), mesh.rank(group)
  out = {}
  for k, v in draws.items():
    axis = 0 if k in _G_BATCH_DRAWS else 1
    lo, hi = mesh.shard_block(v.shape[axis], r, n)
    out[k] = v.narrow(axis, lo, hi - lo)
  return out


def _check_divisible(batch_size: int, group: mesh.Group) -> int:
  """The rows of each rank of a global batch of ``batch_size``."""
  n = mesh.world_size(group)
  if batch_size % n:
    raise ValueError(f"batch_size {batch_size} must be divisible by the "
                     f"mesh size {n}")
  return batch_size // n


def draw_noise(cfg: GANConfig, gen: torch.Generator, b: int, device
               ) -> Dict[str, torch.Tensor]:
  """Every random draw of one outer step of a global batch of ``b`` rows
  (D batches of ``b``, a G update of ``generator_batch_multiple`` x
  ``b``), from ``gen``: the unconditional draws first, in the order of
  ``make_outer_step``'s ``noise``."""
  ratio = cfg.training_ratio
  g_batch = b * cfg.generator_batch_multiple
  noise = {
      "z_d": torch.randn((ratio, b, cfg.z_dim), generator=gen,
                         device=device),
      "z_g": torch.randn((g_batch, cfg.z_dim), generator=gen,
                         device=device),
  }
  if cfg.random_flip:
    noise["flip"] = torch.rand((ratio, b), generator=gen,
                               device=device) < 0.5
  if cfg.conditional:
    noise["y_d"] = torch.randint(0, cfg.num_classes, (ratio, b),
                                 generator=gen, device=device)
    noise["y_g"] = torch.randint(0, cfg.num_classes, (g_batch,),
                                 generator=gen, device=device)
  if cfg.gradient_penalty_weight > 0.0:
    noise["gp_eps"] = torch.rand((ratio, b), generator=gen, device=device)
  return noise


def make_outer_step(cfg: GANConfig, group: mesh.Group = None
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
  """The outer-step function for ``cfg``, on this rank's rows when
  ``group`` is given (G and D must reduce over the same group).

  ``outer_step(state, real_u8, labels, noise=None)`` takes ``real_u8``
  (K, B, H, W, C) uint8 (numpy or tensor) with K = ``training_ratio``, and
  ``labels`` (K, B), the real images' classes (unused, and may be None,
  when the run is unconditional). ``noise`` optionally injects every
  random draw: ``{"z_d": (K, B, z), "z_g": (gB, z), "flip": (K, B) bool,
  "y_d": (K, B), "y_g": (gB,), "gp_eps": (K, B)}`` (the labels when
  conditional, the interpolation weights under WGAN-GP); without it all
  are drawn from ``state.generator`` (under a group, the global batch's
  draws, of which this rank keeps its block: ``rank_block``), the
  unconditional draws first in the order above.
  Updates ``state`` in place and returns the metrics d_loss and
  d_grad_norm (means over the K D updates), g_loss and g_grad_norm as 0-d
  tensors on the state's device, without synchronising; under a group
  the losses and gradients are the means over the ranks."""
  d_loss_fn, g_loss_fn = loss_ops.get_losses(cfg.loss)
  ratio = cfg.training_ratio
  gp_weight = cfg.gradient_penalty_weight
  acgan = cfg.gan_type == "acgan"
  d_fake_train = cfg.d_fake_stats == "batch"
  world = mesh.world_size(group)

  def reduced(loss, grads):
    """(loss, grads) averaged over the ranks, in one all-reduce."""
    loss = loss.detach()
    if group is None:
      return loss, grads
    loss, *grads = mesh.pmean_many([loss, *grads], group)
    return loss, grads

  def fakes(state: GANTrainState, z, zy):
    """D-phase fakes of a frozen G: its statistics do not advance."""
    with torch.no_grad():
      return state.g(z, zy, train=d_fake_train, update_stats=False)

  def d_update(state: GANTrainState, x, y, fake, zy, eps, d_has_norm: bool,
               d_takes_labels: bool):
    b = x.shape[0]
    y_in = y if d_takes_labels else None
    zy_in = zy if d_takes_labels else None
    d = state.d
    penalty = None
    if gp_weight > 0.0:
      penalty = loss_ops.gradient_penalty(
          lambda xi: d(xi, y_in)[0], x, fake, eps, weight=gp_weight)
    if d_has_norm:
      fs, _ = d(fake, zy_in)
      rs, rl = d(x, y_in, update_sn=True, update_stats=True)
    else:
      yy = torch.cat([y_in, zy_in]) if y_in is not None else None
      scores, logits = d(torch.cat([x, fake]), yy, update_sn=True,
                         update_stats=True)
      rs, fs = scores[:b], scores[b:]
      rl = logits[:b] if logits is not None else None
    loss = d_loss_fn(rs, fs)
    if penalty is not None:
      loss = loss + penalty
    if acgan and rl is not None:
      loss = loss + loss_ops.ac_gan_aux_loss(rl, y)
    params = list(d.parameters())
    loss, grads = reduced(loss, torch.autograd.grad(loss, params))
    gnorm = _global_norm(grads)
    _apply(params, grads, state.d_opt, state.d_sched)
    return loss, gnorm

  def g_update(state: GANTrainState, z, zy, d_takes_labels: bool):
    fake = state.g(z, zy, train=True, update_stats=True)
    # D's only pass here, so advancing u in it reads the old u first.
    fs, fl = state.d(fake, zy if d_takes_labels else None,
                     update_sn=cfg.sn_update_on_g_step)
    loss = g_loss_fn(fs)
    if acgan and fl is not None:
      loss = loss + loss_ops.ac_gan_aux_loss(fl, zy)
    params = list(state.g.parameters())
    loss, grads = reduced(loss, torch.autograd.grad(loss, params))
    gnorm = _global_norm(grads)
    _apply(params, grads, state.g_opt, state.g_sched)
    if cfg.g_ema_decay > 0.0 and state.g_ema:
      # e <- d*e + (1-d)*p, the reference's form and rounding (lerp rounds
      # otherwise).
      with torch.no_grad():
        ema = list(state.g_ema.values())
        torch._foreach_mul_(ema, cfg.g_ema_decay)
        torch._foreach_add_(ema, params, alpha=1.0 - cfg.g_ema_decay)
    state.g_version += 1
    return loss, gnorm

  def outer_step(state: GANTrainState, real_u8, labels,
                 noise: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    device = state.generator.device
    real = as_tensor(real_u8, device)
    if real.shape[0] != ratio:
      raise ValueError(f"got {real.shape[0]} D batches, expected "
                       f"training_ratio={ratio}")
    b = real.shape[1]
    d_cfg = state.d.cfg
    d_has_norm = d_cfg.norm != "n"
    d_takes_labels = cfg.conditional and (
        d_cfg.projection or d_cfg.ac_gan or d_cfg.num_classes > 0)
    if noise is None:
      noise = rank_block(
          draw_noise(cfg, state.generator, b * world, device), group)
    noise = {k: as_tensor(v, device) for k, v in noise.items()}
    real = prepare_real(real, noise.get("flip") if cfg.random_flip else None)
    y_real = y_d = y_g = None
    if cfg.conditional:
      y_real = as_tensor(labels, device).long()
      y_d, y_g = noise["y_d"].long(), noise["y_g"].long()

    if cfg.batched_fake_gen:
      z_all = noise["z_d"].reshape(ratio * b, -1)
      y_all = None if y_d is None else y_d.reshape(ratio * b)
      fake_all = fakes(state, z_all, y_all)
      fake_all = fake_all.view((ratio, b) + tuple(fake_all.shape[1:]))
    d_losses, d_gnorms = [], []
    for k in range(ratio):
      zy = None if y_d is None else y_d[k]
      fake = (fake_all[k] if cfg.batched_fake_gen
              else fakes(state, noise["z_d"][k], zy))
      loss, gnorm = d_update(
          state, real[k], None if y_real is None else y_real[k], fake, zy,
          noise["gp_eps"][k] if gp_weight > 0.0 else None, d_has_norm,
          d_takes_labels)
      d_losses.append(loss)
      d_gnorms.append(gnorm)
    g_loss, g_gnorm = g_update(state, noise["z_g"], y_g, d_takes_labels)
    state.step += 1
    return {"d_loss": torch.stack(d_losses).mean(), "g_loss": g_loss,
            "d_grad_norm": torch.stack(d_gnorms).mean(),
            "g_grad_norm": g_gnorm}

  return outer_step


def _batch_block(group: mesh.Group) -> Callable[[Sequence], Tuple]:
  """(real_u8, labels) of the global batch -> this rank's contiguous block
  of their B / world_size rows; B must divide by the world size."""
  n, r = mesh.world_size(group), mesh.rank(group)

  def block(inputs: Sequence) -> Tuple:
    real_u8, labels = inputs
    _check_divisible(real_u8.shape[1], group)
    lo, hi = mesh.shard_block(real_u8.shape[1], r, n)
    return (real_u8[:, lo:hi],
            None if labels is None else labels[:, lo:hi])

  return block


def make_sharded_step(cfg: GANConfig, group: mesh.Group
                      ) -> Callable[..., Dict[str, torch.Tensor]]:
  """The data-parallel outer step on host-fed batches, the reference's
  ``make_sharded_step``: ``step(state, real_u8, labels, noise=None)``
  takes the global batch (K, B, H, W, C) on every rank and runs this
  rank's contiguous block of B / world_size rows (``noise`` is this
  rank's own). B must divide by the world size."""
  inner = make_outer_step(cfg, group)
  block = _batch_block(group)

  def step(state: GANTrainState, real_u8, labels,
           noise: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    return inner(state, *block((real_u8, labels)), noise=noise)

  return step


def make_dataset_step(cfg: GANConfig, batch_size: int,
                      group: mesh.Group = None
                      ) -> Callable[..., Dict[str, torch.Tensor]]:
  """The outer step over a dataset that lives on the state's device.

  ``step(state, data_x, data_y, noise=None)`` takes the whole dataset,
  ``data_x`` (N, H, W, C) uint8 and ``data_y`` (N,), draws ``ratio * B``
  indices uniformly with replacement from ``state.generator`` and runs
  the outer step on the gathered batches: i.i.d. picks in place of
  shuffled epochs, as the reference's ``make_dataset_step``. The picks
  cannot equal the reference's threefry draws; they share its
  distribution.

  With a ``group`` it is the reference's ``make_sharded_dataset_step``:
  ``data_x``/``data_y`` are this rank's shard of the dataset: every rank
  draws the picks of the global batch ``batch_size`` into its shard from
  the replicated generator and keeps its block of B / world_size of them.
  B must divide by the world size."""
  local = _check_divisible(batch_size, group)
  inner = make_outer_step(cfg, group)
  ratio = cfg.training_ratio
  lo, _ = mesh.shard_block(batch_size, mesh.rank(group),
                           mesh.world_size(group))

  def step(state: GANTrainState, data_x: torch.Tensor, data_y: torch.Tensor,
           noise: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    idx = torch.randint(0, data_x.shape[0], (ratio, batch_size),
                        generator=state.generator, device=data_x.device)
    idx = idx[:, lo:lo + local].reshape(-1)
    real = data_x.index_select(0, idx).view(
        (ratio, local) + tuple(data_x.shape[1:]))
    labels = data_y.index_select(0, idx).view(ratio, local)
    return inner(state, real, labels, noise=noise)

  return step


def _multi(fn: Callable[..., Dict[str, torch.Tensor]], steps_per_call: int
           ) -> Callable[..., Dict[str, torch.Tensor]]:
  """``steps_per_call`` outer steps of ``fn`` per call, returning their
  mean metrics; the chain sets the epoch length and the probe cadence, as
  the reference's one-program chain does. Run as it is, the steps run
  eagerly; ``make_jit_dataset_step`` captures the whole chain as one CUDA
  graph. ``noise``, when given, holds each step's draws along a leading
  axis of ``steps_per_call``."""
  if steps_per_call <= 1:
    return fn

  def multi(state: GANTrainState, data_x: torch.Tensor,
            data_y: torch.Tensor, noise: Optional[Dict] = None
            ) -> Dict[str, torch.Tensor]:
    if noise is None:
      metrics = [fn(state, data_x, data_y) for _ in range(steps_per_call)]
    else:
      metrics = [fn(state, data_x, data_y,
                    noise={k: v[i] for k, v in noise.items()})
                 for i in range(steps_per_call)]
    return {k: torch.stack([m[k] for m in metrics]).mean()
            for k in metrics[0]}

  return multi


# --- the compiled step ---------------------------------------------------------


def _state_tensors(state: GANTrainState) -> List[torch.Tensor]:
  """Every tensor of ``state`` a step reads or writes: G's and D's
  parameters and buffers, the optimizers' slots, counts and LRs, the
  schedules' counts, the EMA shadow."""
  out = [*state.g.parameters(), *state.g.buffers(), *state.d.parameters(),
         *state.d.buffers()]
  for opt in (state.g_opt, state.d_opt):
    for slots in opt.state.values():
      out.extend(v for v in slots.values() if torch.is_tensor(v))
    out.extend(g["lr"] for g in opt.param_groups if torch.is_tensor(g["lr"]))
  for sched in (state.g_sched, state.d_sched):
    count = getattr(sched, "count", None)
    if torch.is_tensor(count):
      out.append(count)
  if state.g_ema:
    out.extend(state.g_ema.values())
  return out


def _state_key(state: GANTrainState) -> Tuple:
  """What a captured graph is bound to in ``state``: its objects, and each
  tensor's identity and address."""
  return ((id(state), id(state.g), id(state.d), id(state.g_opt),
           id(state.d_opt), id(state.g_sched), id(state.d_sched),
           id(state.generator)),
          tuple((id(t), t.data_ptr()) for t in _state_tensors(state)))


def _input_key(copied: Sequence, held: Sequence,
               noise: Optional[Dict]) -> Tuple:
  """What a captured graph is bound to in a call's inputs: the shapes,
  dtypes and devices of those copied into static buffers, the identity of
  those read where they lie, and the noise's keys and shapes."""
  return (compiled.spec(list(copied)),
          tuple((id(a), a.data_ptr(), compiled.spec(a))
                if torch.is_tensor(a) else None for a in held),
          compiled.spec(noise))



def refuse_host_collectives(name: str, group: mesh.Group,
                            device: torch.device) -> None:
  """Raise for a process group whose collectives a CUDA graph cannot
  capture: any but NCCL, on CUDA."""
  backend = mesh.backend(group)
  if device.type == "cuda" and backend not in (None, "nccl"):
    raise ValueError(
        f"{name} cannot be captured with a {backend} group on CUDA: "
        f"{backend}'s collectives run on the host, where a CUDA graph "
        "cannot capture them; run the eager make_sharded_step / "
        "make_dataset_step with that group, or NCCL (a card a rank)")


class JitStep:
  """A step function run through static buffers, the port's ``jax.jit``
  of a step (a ``compiled.Program``): ``step(state, *inputs, noise=None)``
  with the signature of the eager function ``eager``, whose call runs
  ``steps`` outer steps.

  ``fn`` is the function the program runs; ``select``, when given, maps
  a call's inputs to ``fn``'s (this rank's block of a global batch), and
  ``eager`` is then ``fn`` after it. The inputs at the positions
  ``copied`` are copied into static buffers on the state's device before
  each call (a host-fed batch; ``None`` stays ``None``); the others are
  read where they lie (the device dataset; the step keeps no reference to
  them, so a dataset the caller drops is freed). ``noise``, when given, is
  copied into static buffers too.

  On CUDA, after a warm-up call, each call is one replay of a
  ``torch.cuda.CUDAGraph`` of ``fn`` (see ``compiled``): the graph is
  bound to the state's tensors, its optimizers and schedules, the inputs'
  shapes, dtypes and devices, the device data's tensors and the noise's
  keys, and any change warms up and captures anew; ``state.generator`` is
  registered with it; the host counts a call advances (``state.step``,
  ``state.g_version``, the kernels' launch counts, ``mesh.STATS``) are the
  captured call's, added on each replay; the metrics are new tensors on
  each call. Under an NCCL ``group`` every rank warms up, captures and
  replays at the same call (the binding changes only with replicated
  events: a rotated window, a restore, a ladder rung), each rank's
  all-reduces inside its graph; a gloo group on CUDA raises.

  On the CPU every call after the warm-up runs ``fn`` eagerly on the
  static buffers. ``last`` says what the last call did: 'warm-up',
  'capture', 'replay' or 'eager' (the CPU's), and ``calls`` counts each."""

  def __init__(self, fn: Callable[..., Dict[str, torch.Tensor]], steps: int,
               copied: Sequence[bool], name: str, group: mesh.Group = None,
               select: Optional[Callable[[Sequence], Sequence]] = None):
    self.steps = steps
    self.name = name
    self._fn = fn
    self._copied = tuple(copied)
    self._group = group
    self._select = select
    self._program = compiled.Program(name)
    if select is None:
      self.eager = fn
    else:
      def eager(state, *inputs, noise=None):
        return fn(state, *select(inputs), noise=noise)
      self.eager = eager

  @property
  def calls(self) -> Dict[str, int]:
    return self._program.calls

  @property
  def last(self) -> Optional[str]:
    return self._program.last

  def invalidate(self) -> None:
    """Drop the graph and the static buffers: the next call warms up
    again, the one after it captures anew."""
    self._program.invalidate()

  def __call__(self, state: GANTrainState, *inputs,
               noise: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    if len(inputs) != len(self._copied):
      raise TypeError(f"{self.name} takes {len(self._copied)} inputs after "
                      f"the state, got {len(inputs)}")
    device = state.generator.device
    refuse_host_collectives(self.name, self._group, device)
    if self._select is not None:
      inputs = tuple(self._select(inputs))
    copied = [a for a, c in zip(inputs, self._copied) if c]
    held = [a for a, c in zip(inputs, self._copied) if not c]
    inputs_key = _input_key(copied, held, noise)

    def run(static):
      buffers = iter(static[0])
      args = [next(buffers) if c else a for a, c in zip(inputs, self._copied)]
      return self._fn(state, *args, noise=static[1])

    return self._program(run, lambda: (_state_key(state), inputs_key),
                         [copied, noise], device, state=state)


def make_jit_step(cfg: GANConfig, group: mesh.Group = None) -> JitStep:
  """The compiled outer step, the reference's ``make_jit_step`` (with a
  ``group``, its ``make_sharded_step``): ``step(state, real_u8, labels,
  noise=None)`` as ``make_outer_step``'s (``make_sharded_step``'s: the
  global batch, of which this rank's block fills the static buffers),
  with the batch, the labels and the noise copied into static buffers on
  the state's device; on CUDA one CUDA-graph replay a call
  (``JitStep``)."""
  if group is None:
    return JitStep(make_outer_step(cfg), 1, (True, True), "make_jit_step")
  return JitStep(make_outer_step(cfg, group), 1, (True, True),
                 "make_jit_step", group, _batch_block(group))


def make_jit_dataset_step(cfg: GANConfig, batch_size: int,
                          steps_per_call: int = 1,
                          group: mesh.Group = None) -> JitStep:
  """The compiled chain of ``steps_per_call`` dataset steps, the
  reference's ``make_jit_dataset_step`` (with a ``group``, its
  ``make_sharded_dataset_step``): ``step(state, data_x, data_y,
  noise=None)`` as ``_multi(make_dataset_step(cfg, batch_size, group),
  steps_per_call)``'s (the noise with a leading axis of ``steps_per_call``
  when it chains more than one step), the dataset (this rank's shard)
  read where it lies; on CUDA one CUDA graph of the whole chain, one
  replay a call (``JitStep``), the counterpart of the reference's
  ``lax.scan``. A new dataset tensor (a rotated window) means a new
  capture."""
  return JitStep(_multi(make_dataset_step(cfg, batch_size, group),
                        steps_per_call),
                 max(steps_per_call, 1), (False, False),
                 "make_jit_dataset_step", group)
