"""The epoch loop around the outer step, the sampling surfaces and the
run's bookkeeping.

Counterpart of ``wcgan_tpu/train/trainer.py`` (names, defaults, log lines
and file names are the reference's):

- the epoch loop: by default the dataset lives on the device and each
  outer step draws its real batches there (``device_data``), in chains of
  ``steps_per_call`` steps, the epoch rounded down to whole chains; with
  ``device_data=False`` host-fed shuffled batches. Datasets over
  ``device_data_limit`` bytes train on a rotating random window, the next
  one copied on a side stream while the current one trains. One
  ``log.txt`` line and one ``metrics.jsonl`` record (with ``diagnostics()``)
  per epoch; a sample grid every ``display_ratio`` epochs; a full-state
  checkpoint every ``checkpoint_ratio`` epochs;
- whitening health: the Newton-Schulz residual probe of G's running
  covariances after every epoch (and every ``residual_probe_every`` outer
  steps), and the guard that warns, aborts or walks the fallback ladder;
  a non-finite metric checkpoints and aborts;
- sampling (``sample``, ``sample_u8``, ``save_sample_grid``, ``generate``)
  from ``sampling_state()``: G's EMA parameters, when the run keeps them,
  with standing statistics re-estimated under them; else the live G in
  eval mode on its running statistics. A conditional run samples with
  labels: the dataset's fixed test labels in grids, uniform draws in
  ``generate`` and the standing statistics. ``sample``, ``sample_u8`` and
  the standing pass are compiled programs (the reference's ``_sample``,
  ``_sample_u8`` and ``_standing_pass``; ``compiled.Program``): on CUDA
  one CUDA-graph replay a call after a warm-up and a capture, one graph
  per input signature (batch, conditional); on the CPU the eager body on
  static buffers. The standing statistics live in fixed tensors, each
  recompute copied into them, so that the graphs stay bound; a restore
  and each rung of the fallback ladder invalidate the graphs;
- checkpoints: the full state under ``checkpoints_dir/name/epoch_{i}/``
  (``torch.save``, loadable with ``weights_only=True``) beside the
  weights-only ``epoch_{i}_{generator,discriminator}.npz`` in the JAX
  package's format. G's statistics are its WC layers' ``wc_stats`` and its
  BatchNorms' ``batch_stats``, everywhere (checkpoint, standing
  statistics, the sampling cache); ``diagnostics()`` reads the WC layers
  only, since a BatchNorm has no covariance;
- the step: the compiled step, the reference's ``make_jit_dataset_step``
  with device data and ``make_jit_step`` without (on CUDA a CUDA graph a
  call, ``step.JitStep``; on the CPU the eager body on static buffers),
  on one process and under an NCCL group. A restore and each rung of the
  fallback ladder invalidate it, so that its next call warms up and
  captures anew;
- debugging: ``profile_dir`` writes a ``torch.profiler`` Chrome trace of
  the run's first few step calls after the first (after the first two on
  CUDA, where the second captures the graph: the trace holds replays; the
  reference traces with ``jax.profiler``); ``debug_nans`` checks each step
  call's metrics and raises at the first non-finite one (the CLI also
  turns on ``torch.autograd`` anomaly detection, the reference's
  ``jax_debug_nans``; a capture keeps it on without its NaN check).

Data parallelism (the reference's ``mesh=``): with a process ``group``
the state must have been built with it (``create_state(group=...)``) and
each rank runs this loop on its own process. The device data is rounded
down to a multiple of the ranks (windows too), and rank r stages its
contiguous block of the rows, as ``NamedSharding(P('data'))`` lays them
out; the step functions are the data-parallel ones, compiled under NCCL
(each rank captures its own graph) and eager under gloo, whose
collectives run on the host where a CUDA graph cannot capture them; the
log says which in one line. Rank 0 alone writes
(``log.txt``, ``metrics.jsonl``, grids, checkpoints, traces); every rank
computes ``diagnostics()`` from the replicated statistics, so the guard
acts alike on all. EMA sampling with standing statistics re-estimates
them with train-mode forwards, which would reduce over the ranks from
rank 0 alone: the reference fails there too (its standing pass applies
G, whose layers name the mesh axis, outside ``shard_map``), so the
combination is refused.

Scoring: with a ``scorer`` (``evaluation.scorer.make_scorer``) and
``score_every`` N, every N epochs, after the grid and the checkpoint, the
scorer's IS/FID go to ``log.txt`` and ``metrics.jsonl`` and into the dict
``train()`` returns. Under a group every rank calls the scorer (it
gathers over the ranks); rank 0 alone writes.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from wcgan_tpu_torch import compiled
from wcgan_tpu_torch.data.base import ArrayDataset
from wcgan_tpu_torch.models import layers as L
from wcgan_tpu_torch.utils.images import make_grid, save_png
from wcgan_tpu_torch.utils.logging import MetricsLogger
from wcgan_tpu_torch import weights
from wcgan_tpu_torch.parallel import mesh
from wcgan_tpu_torch.train import schedules
from wcgan_tpu_torch.train import state as state_lib
from wcgan_tpu_torch.train import step as step_lib
from wcgan_tpu_torch.train.state import GANTrainState

CKPT_FILE = "state.pt"            # the full state inside epoch_{i}/

# (images, labels, event the copy records on its side stream or None)
Staged = Tuple[torch.Tensor, torch.Tensor, Optional[torch.cuda.Event]]


@dataclasses.dataclass
class TrainerConfig:
  """Loop and bookkeeping settings, the reference's defaults."""

  name: str = "run"
  output_dir: str = "output"
  checkpoints_dir: str = "checkpoints"
  number_of_epochs: int = 100
  start_epoch: int = 0
  checkpoint_ratio: int = 10      # full state + npz every N epochs; 0 = never
  display_ratio: int = 1          # sample grid every N epochs; 0 = never
  batches_per_epoch: Optional[int] = None  # outer steps; None = dataset size
  grid_samples: int = 64
  seed: int = 0
  device_data: bool = True        # dataset on the device, batches drawn
                                  # there; above device_data_limit bytes a
                                  # rotating window of half of it
  device_data_limit: int = 2_000_000_000
  steps_per_call: int = 8         # outer steps per chain (device_data only)
  wc_residual_action: str = "warn"  # 'warn', 'abort' (checkpoint, raise)
                                  # or 'fallback' (checkpoint, walk the
                                  # ladder of _apply_whitening_fallback,
                                  # abort once it is exhausted)
  fallback_cooldown: int = -1     # outer steps after a rung in which
                                  # breaches do not escalate; -1 =
                                  # ceil(5 / (1 - wc_momentum))
  residual_probe_every: int = 0   # also probe every N outer steps inside
                                  # the epoch (in whole chains); 0 = off
  ema_standing_batches: int = 16  # batches of standing statistics under
                                  # the EMA params; 0 = the live statistics
  profile_dir: Optional[str] = None  # Chrome trace of a few step calls
  debug_nans: bool = False        # raise at a step call's first
                                  # non-finite metric
  score_every: int = 0            # epochs between IS/FID scores; 0 = off


class _Silent:
  """The logger of a rank other than 0: it writes nothing."""

  def line(self, text: str) -> None:
    del text

  def epoch_line(self, epoch, metrics, extra=None) -> None:
    del epoch, metrics, extra

  def jsonl(self, record) -> None:
    del record


def check_ema_under_mesh(data_parallel: bool, g_ema_decay: float,
                         ema_standing_batches: int) -> None:
  """Raise for EMA sampling with standing statistics under data
  parallelism (see the module's docstring)."""
  if data_parallel and g_ema_decay > 0.0 and ema_standing_batches > 0:
    raise ValueError(
        "--mesh with --generator_ema and --ema_standing_stats > 0 is not "
        "supported: the standing statistics are train-mode G forwards, "
        "which reduce over the ranks while rank 0 alone samples (the JAX "
        "package fails the same way, NameError 'unbound axis name'); use "
        "--ema_standing_stats 0 or no --mesh")


class Trainer:
  """Drives training of one GAN experiment on ``state``'s device, as one
  rank of ``group`` when one is given."""

  def __init__(self, dataset: ArrayDataset, state: GANTrainState,
               gan_cfg: step_lib.GANConfig, cfg: TrainerConfig,
               group: mesh.Group = None,
               scorer: Optional[Callable[..., Dict[str, float]]] = None):
    check_ema_under_mesh(group is not None, gan_cfg.g_ema_decay,
                         cfg.ema_standing_batches)
    self.ds = dataset
    self.scorer = scorer
    self.state = state
    self.gan_cfg = gan_cfg
    self.cfg = cfg
    self.group = group
    self.is_main = mesh.rank(group) == 0
    self.logger = MetricsLogger(cfg.output_dir) if self.is_main else _Silent()
    self._outer_steps_done = 0      # monotone; probe bookkeeping
    self._fallback_cooldown_until = -1
    self._ns_escalated = False      # the ns_iters rung fires once
    self._standing_cache = None     # (key, pinned buffers, tensors)
    # The sampling and standing-pass programs, by kind and input signature.
    self._programs: Dict[Tuple, compiled.Program] = {}
    self._device_data: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    self._window_elems = 0
    self._window_rng = np.random.default_rng(cfg.seed + 17)
    self._window_next: Optional[Staged] = None
    self._stage_stream = None
    self._steps_per_call = 1
    self._step_calls = 0            # monotone; profiler window
    self._profiler = None
    self._profile_from = 0          # the step call the trace starts at
    if cfg.device_data:
      # A chain longer than the epoch would run more outer steps than
      # configured, so it is clamped to the epoch.
      self._steps_per_call = max(
          min(cfg.steps_per_call, self.epoch_batches()), 1)
      n_total = len(dataset.images)
      if dataset.images.nbytes > cfg.device_data_limit:
        # Two windows are in flight (the one training and the next one
        # being copied), so each gets half the budget.
        bytes_per = int(np.prod(dataset.image_shape))
        self._window_elems = min(max(
            (cfg.device_data_limit // 2) // bytes_per, dataset.batch_size),
            n_total)
      # Each rank holds an equal block of the rows.
      world = mesh.world_size(group)
      n = (self._window_elems or n_total) // world * world
      if self._window_elems:
        self._window_elems = n
        self._window_next = self._make_window()
      else:
        self._device_data = self._take(self._stage(np.arange(n)))
    if group is not None:
      backend = mesh.backend(group)
      self.logger.line(
          "the outer step runs compiled under --mesh (nccl: one CUDA graph "
          "a call on each rank, its all-reduces inside)"
          if backend == "nccl" else
          f"the outer step runs eagerly under --mesh ({backend}'s "
          "collectives run on the host, where a CUDA graph cannot capture "
          "them)")
    self.step_fn = self._make_step_fn()

  def _make_step_fn(self):
    """The step function for the current ``gan_cfg``: chains of
    ``steps_per_call`` dataset steps with device data, else one outer step
    on host-fed batches; the compiled ones (``make_jit_dataset_step``,
    ``make_jit_step``) on one process and under NCCL, the eager
    data-parallel ones under gloo. The fallback ladder rebuilds it after
    changing ``gan_cfg``."""
    jit = mesh.backend(self.group) in (None, "nccl")
    if self.cfg.device_data:
      if jit:
        return step_lib.make_jit_dataset_step(
            self.gan_cfg, self.ds.batch_size, self._steps_per_call,
            self.group)
      return step_lib._multi(
          step_lib.make_dataset_step(self.gan_cfg, self.ds.batch_size,
                                     self.group),
          self._steps_per_call)
    if jit:
      return step_lib.make_jit_step(self.gan_cfg, self.group)
    return step_lib.make_sharded_step(self.gan_cfg, self.group)

  def _invalidate_step(self) -> None:
    """Drop the compiled step's graph and the sampling and standing-pass
    graphs (after a restore or a change of G): each next call warms up
    and captures anew, never replays stale."""
    invalidate = getattr(self.step_fn, "invalidate", None)
    if invalidate is not None:
      invalidate()
    self.invalidate_sampling()

  def invalidate_sampling(self) -> None:
    """Drop the graphs of ``sample``, ``sample_u8`` and the standing pass:
    the next call of each warms up and captures anew (after anything they
    call was swapped, say)."""
    for program in self._programs.values():
      program.invalidate()

  def _program(self, kind: str, signature) -> compiled.Program:
    key = (kind, signature)
    if key not in self._programs:
      self._programs[key] = compiled.Program(f"Trainer.{kind}")
    return self._programs[key]

  def _g_key(self, tensors: Dict[str, torch.Tensor]) -> Tuple:
    """What a sampling or standing-pass graph reads of G: the module (its
    configuration, parameters and buffers) and ``tensors``, the ones
    ``functional_call`` puts in their place."""
    return (compiled.module_key(self.state.g), tuple(tensors),
            compiled.tensors_key(tensors.values()))

  @property
  def device(self) -> torch.device:
    return self.state.generator.device

  def epoch_batches(self) -> int:
    """Outer steps per epoch: the configured count, else the dataset's
    batches over the D updates one outer step consumes."""
    return self.cfg.batches_per_epoch or max(
        self.ds.number_of_batches_per_epoch // self.gan_cfg.training_ratio,
        1)

  # -- checkpoints ------------------------------------------------------------

  @property
  def ckpt_dir(self) -> str:
    return os.path.abspath(os.path.join(self.cfg.checkpoints_dir,
                                        self.cfg.name))

  def checkpoint_path(self, epoch: int) -> str:
    return os.path.join(self.ckpt_dir, f"epoch_{epoch}")

  def full_state(self) -> Dict[str, Any]:
    """Everything a resume needs, as tensors, dicts, lists and numbers
    (what ``torch.load(weights_only=True)`` takes): G and D with their
    statistics and SN vectors, both Adams and LR schedules, the EMA
    shadow, the noise generator, the outer-step counts. The tensors are
    the live ones, not copies."""
    return {**state_lib.full_state(self.state),
            "outer_steps_done": self._outer_steps_done}

  def save_checkpoint(self, epoch: int) -> None:
    """The full state to ``epoch_{epoch}/``, then the weights-only npz
    (rank 0 only: the state is replicated)."""
    if not self.is_main:
      return
    path = self.checkpoint_path(epoch)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, CKPT_FILE + ".tmp")
    torch.save(self.full_state(), tmp)
    os.replace(tmp, os.path.join(path, CKPT_FILE))
    self.export_weights(epoch)

  def restore_checkpoint(self, path: str) -> None:
    """Load a ``save_checkpoint`` directory into the live state, in place:
    every tensor keeps its device and layout and takes the saved values
    bit for bit (Adam's slots are new tensors, each ``step`` count where
    the live Adam keeps it: on the card when capturable, else on the
    CPU). The compiled step is invalidated."""
    st = self.state
    # Loaded to the CPU, then copied into the live tensors.
    ck = torch.load(os.path.join(path, CKPT_FILE), map_location="cpu",
                    weights_only=True)
    have = None if st.g_ema is None else sorted(st.g_ema)
    saved = None if ck["g_ema"] is None else sorted(ck["g_ema"])
    if have != saved:
      raise ValueError(
          f"checkpoint {path} has EMA weights {saved is not None} where the "
          f"run has {have is not None} (--generator_ema must match)")
    st.g.load_state_dict(ck["g"])
    st.d.load_state_dict(ck["d"])
    schedules.load_adam(st.g_opt, ck["g_opt"])
    schedules.load_adam(st.d_opt, ck["d_opt"])
    st.g_sched.load_state_dict(ck["g_sched"])
    st.d_sched.load_state_dict(ck["d_sched"])
    if st.g_ema is not None:
      with torch.no_grad():
        for name, t in st.g_ema.items():
          t.copy_(ck["g_ema"][name])
    st.generator.set_state(ck["generator"])
    st.step = int(ck["step"])
    st.g_version += 1
    self._outer_steps_done = int(ck["outer_steps_done"])
    self._invalidate_step()

  def checkpoint_epochs(self) -> List[int]:
    """The epochs of the full-state checkpoints ``epoch_<n>``, sorted;
    weights-only npz files and names whose suffix is not an integer are
    skipped."""
    if not os.path.isdir(self.ckpt_dir):
      return []
    epochs = []
    for d in os.listdir(self.ckpt_dir):
      if d.startswith("epoch_") and not d.endswith(".npz"):
        try:
          epochs.append(int(d.split("_")[1]))
        except ValueError:
          continue
    return sorted(epochs)

  def latest_checkpoint(self) -> Optional[str]:
    epochs = self.checkpoint_epochs()
    return self.checkpoint_path(epochs[-1]) if epochs else None

  def export_weights(self, epoch: int) -> None:
    """Weights-only ``epoch_{epoch}_{generator,discriminator}.npz`` under
    ``checkpoints_dir/name``, in the JAX package's format (params only)."""
    os.makedirs(self.ckpt_dir, exist_ok=True)
    for model, module in (("generator", self.state.g),
                          ("discriminator", self.state.d)):
      np.savez(os.path.join(self.ckpt_dir, f"epoch_{epoch}_{model}.npz"),
               **weights.export_npz(module))

  # -- data staging -----------------------------------------------------------

  def _stage(self, idx: np.ndarray) -> Staged:
    """Images ``idx`` (this rank's block of them under a group) and their
    labels on the device. On CUDA the copy runs from pinned memory on a
    side stream, so the next window's copy overlaps training; ``_take``
    makes the training stream wait for it."""
    lo, hi = mesh.shard_block(len(idx), mesh.rank(self.group),
                              mesh.world_size(self.group))
    idx = idx[lo:hi]
    imgs = torch.from_numpy(self.ds.images[idx])
    labels = torch.from_numpy(
        self.ds.labels[idx] if self.ds.labels is not None
        else np.zeros((len(idx),), np.int32))
    if self.device.type != "cuda":
      return imgs.to(self.device), labels.to(self.device), None
    if self._stage_stream is None:
      self._stage_stream = torch.cuda.Stream(self.device)
    imgs, labels = imgs.pin_memory(), labels.pin_memory()
    with torch.cuda.stream(self._stage_stream):
      imgs = imgs.to(self.device, non_blocking=True)
      labels = labels.to(self.device, non_blocking=True)
      done = torch.cuda.Event()
      done.record(self._stage_stream)
    return imgs, labels, done

  def _take(self, staged: Staged) -> Tuple[torch.Tensor, torch.Tensor]:
    imgs, labels, done = staged
    if done is not None:
      stream = torch.cuda.current_stream(self.device)
      stream.wait_event(done)
      imgs.record_stream(stream)
      labels.record_stream(stream)
    return imgs, labels

  def _make_window(self) -> Staged:
    idx = self._window_rng.choice(len(self.ds.images),
                                  size=self._window_elems, replace=False)
    return self._stage(np.sort(idx))

  def _maybe_rotate_window(self) -> None:
    if not self._window_elems:
      return
    if self._window_next is not None:
      self._device_data = self._take(self._window_next)
      self._window_next = self._make_window()   # copied while this trains
    else:   # after train() released the prestaged window
      self._device_data = self._take(self._make_window())

  def _drop_pending_window(self) -> None:
    """Release the window staged for an epoch that will not run, after its
    copy has finished; a later train() stages synchronously."""
    if self._window_next is not None:
      done = self._window_next[2]
      if done is not None:
        done.synchronize()
      self._window_next = None

  # -- diagnostics ------------------------------------------------------------

  def _wc_covs(self) -> List[np.ndarray]:
    """G's running covariances (the WC layers' ``cov`` buffers), float32."""
    return [b.detach().float().cpu().numpy()
            for name, b in self.state.g.named_buffers()
            if name.endswith("cov") and b.ndim == 2
            and b.shape[0] == b.shape[1]]

  def _ns_residuals(self) -> List[float]:
    """max|W cov W^T - I| per WC layer, with W from the Newton-Schulz
    configuration G runs (ns_iters, scaling, float32), on the host."""
    iters = self.state.g.cfg.ns_iters
    scaling = self.state.g.cfg.ns_scaling
    eps = 1e-5
    res = [0.0]
    for cov in self._wc_covs():
      c = cov.shape[0]
      ident = np.eye(c, dtype=np.float32)
      # The jitter of ops/whiten.py::_spd_jitter, so that the probe
      # iterates the matrix G iterates (an all-negative-rounded diagonal
      # included).
      mean_diag = max(np.trace(cov) / c, 0.0)
      neg_diag = max(-np.min(np.diagonal(cov)), 0.0)
      a = cov + (eps * mean_diag + 2.0 * neg_diag + 1e-12) * ident
      tr = np.trace(a) if scaling == "trace" else np.linalg.norm(a)
      y, z = a / tr, ident.copy()
      for _ in range(iters):
        t = 0.5 * (3.0 * ident - z @ y)
        y, z = y @ t, t @ z
      w = z / np.sqrt(tr)
      res.append(float(np.max(np.abs(w @ cov @ w.T - ident))))
    return res

  # Step calls a profile_dir trace holds.
  PROFILE_CALLS = 3

  # The reference's threshold: an order of magnitude past a healthy run's
  # residual, well before the ns12 blow-up plateau (~0.3) it measured.
  RESIDUAL_THRESHOLD = 1e-2

  def _residual_guard(self, epoch: int, resid: float,
                      cond: float = float("nan"),
                      where: str = "epoch probe") -> None:
    """Act on an unhealthy whitening probe per ``wc_residual_action``. A
    non-finite residual trips it too."""
    if not (resid > self.RESIDUAL_THRESHOLD or not np.isfinite(resid)):
      return
    self.logger.line(
        f"Epoch {epoch}: WARNING whitening under-converged "
        f"({where}: wc_whiten_residual_max = {resid:.2e}, cov cond "
        f"max = {cond:.3g}); increase --ns_iters or use "
        "--whitening_precision highest")
    action = self.cfg.wc_residual_action
    if action == "fallback":
      if self._outer_steps_done < self._fallback_cooldown_until:
        self.logger.line(
            f"Epoch {epoch}: fallback recovery window — breach at outer "
            f"step {self._outer_steps_done} is within "
            f"{self._fallback_cooldown_until - self._outer_steps_done} "
            "steps of the last demotion (the probe measures RUNNING "
            "covariances, which re-converge at EMA speed); not "
            "escalating")
        return
      if self._apply_whitening_fallback(epoch):
        self._fallback_cooldown_until = (
            self._outer_steps_done + self._fallback_cooldown_steps())
        return
      self.logger.line(
          f"Epoch {epoch}: whitening-fallback ladder exhausted (already "
          "at batch stats / 'd' norms / escalated ns_iters) — the "
          "conditioning is past the doubled-NS convergence envelope "
          "(~1e5 at eps=1e-5, the jitter floor); aborting like 'abort'")
      action = "abort"
    if action == "abort":
      self.save_checkpoint(epoch)
      self.logger.line(
          f"Epoch {epoch}: --wc_residual_action {action} — checkpointed "
          "and aborting (state preserved for post-mortem/resume)")
      raise FloatingPointError(
          f"whitening under-converged ({where}: residual {resid:.2e} > "
          f"{self.RESIDUAL_THRESHOLD:g}); aborted per "
          f"--wc_residual_action {self.cfg.wc_residual_action}")

  def _fallback_cooldown_steps(self) -> int:
    """The configured recovery window, else five EMA time constants of the
    statistics' momentum."""
    if self.cfg.fallback_cooldown >= 0:
      return self.cfg.fallback_cooldown
    m = float(self.state.g.cfg.wc_momentum)
    return int(math.ceil(5.0 / max(1.0 - m, 1e-6)))

  def _apply_whitening_fallback(self, epoch: int) -> bool:
    """One rung of the reference's ladder, after a checkpoint of the
    breached state; False when none is left.

    The reference's ladder:
      1. ``d_fake_stats`` running -> batch (the step function is rebuilt);
      2. 'dr' norm codes -> 'd';
      3. ns_iters x2, once.
    Rungs 2 and 3 change the live G in place (``Generator.reconfigure``);
    its state carries over unchanged, and the compiled step is
    invalidated, so that its next call warms up and captures the new
    settings."""
    if self.gan_cfg.d_fake_stats == "running":
      self.save_checkpoint(epoch)
      self.gan_cfg = dataclasses.replace(self.gan_cfg, d_fake_stats="batch")
      self.step_fn = self._make_step_fn()
      self.invalidate_sampling()
      self.logger.line(
          f"Epoch {epoch}: --wc_residual_action fallback — demoting "
          "d_fake_stats running -> batch (exact per-forward moments; "
          "docs/SOAK.md r4/r5); training continues")
      return True
    g = self.state.g
    g_cfg = g.cfg
    if "dr" in (g_cfg.block_norm, g_cfg.last_norm):
      self.save_checkpoint(epoch)
      g.reconfigure(
          block_norm="d" if g_cfg.block_norm == "dr" else g_cfg.block_norm,
          last_norm="d" if g_cfg.last_norm == "dr" else g_cfg.last_norm)
      self._invalidate_step()
      self._standing_cache = None
      self.logger.line(
          f"Epoch {epoch}: --wc_residual_action fallback — demoting "
          "generator 'dr' norm codes -> 'd' (batch-stat whitening; the "
          "dr feedback explosion is measured at docs/SOAK.md r5); "
          "training continues")
      return True
    if not self._ns_escalated:
      self.save_checkpoint(epoch)
      new_iters = 2 * g_cfg.ns_iters
      g.reconfigure(ns_iters=new_iters)
      self._invalidate_step()
      self._ns_escalated = True
      self._standing_cache = None
      self.logger.line(
          f"Epoch {epoch}: --wc_residual_action fallback — escalating "
          f"ns_iters {g_cfg.ns_iters} -> {new_iters} (doubling extends "
          "the NS convergence envelope ~25x in covariance conditioning); "
          "training continues")
      return True
    return False

  def _intra_epoch_probe(self, epoch: int, steps_done: int) -> None:
    """The residual probe between chains (``residual_probe_every``): the
    covariances only, no condition numbers or sigmas."""
    resid = float(np.max(self._ns_residuals()))
    self._residual_guard(epoch, resid, where=f"step-{steps_done} probe")

  def diagnostics(self) -> Dict[str, float]:
    """Health probes on the host: the condition number of each WC layer's
    running covariance and the whitening residual; sigma of D's raw
    kernels (SN divides it out at apply time), by power iteration on each
    kernel in the flax layout, (-1, out), as the reference reshapes it.
    A non-finite covariance reads as NaN (the reference's ``eigvalsh``
    raises on it, before its non-finite checkpoint), and the maxima keep
    a NaN, so that the guard sees it."""
    conds = []
    for cov in self._wc_covs():
      if np.all(np.isfinite(cov)):
        eig = np.linalg.eigvalsh(cov)
        conds.append(float(eig[-1] / max(eig[0], 1e-12)))
      else:
        conds.append(float("nan"))
    out: Dict[str, float] = {}
    if conds:
      out.update(wc_cov_cond_max=float(np.max(conds)),
                 wc_cov_cond_mean=float(np.mean(conds)),
                 wc_whiten_residual_max=float(np.max(self._ns_residuals())))
    sigmas = []
    d_params = weights.params_to_jax(dict(self.state.d.named_parameters()))
    for path, arr in weights._flatten(d_params):
      if "kernel" in path and arr.ndim >= 2:
        w2d = np.asarray(arr, np.float32).reshape(-1, arr.shape[-1])
        v = np.random.default_rng(0).standard_normal(w2d.shape[1])
        for _ in range(8):
          u = w2d @ v
          u /= np.linalg.norm(u) + 1e-12
          v = w2d.T @ u
          v /= np.linalg.norm(v) + 1e-12
        sigmas.append(float(u @ w2d @ v))
    if sigmas:
      out.update(d_sigma_max=max(sigmas),
                 d_sigma_mean=float(np.mean(sigmas)))
    return out

  # -- EMA standing statistics ------------------------------------------------

  @torch.no_grad()
  def standing_g_state(self, params: Dict[str, torch.Tensor],
                       n_batches: int, rng_seed: int = 4321
                       ) -> Dict[str, torch.Tensor]:
    """G's normalization statistics re-estimated under ``params`` (BigGAN's
    standing statistics; the EMA shadow covers only parameters, and the
    running statistics describe the raw trajectory): ``n_batches``
    train-mode forwards of ``ds.batch_size`` z from
    ``np.random.default_rng(rng_seed)`` (then, for a conditional G, as many
    uniform labels from it), each layer's batch statistics (a WC layer's
    mean and covariance, a BatchNorm's mean and biased variance)
    captured as they are computed, averaged with equal weights. The live
    statistics do not move. With 'dr' codes the transform reads the live
    running statistics, so the estimate is one sweep, not a fixed
    point."""
    g = self.state.g
    live = dict(g.named_buffers())
    if not live or n_batches <= 0:
      return live
    rng = np.random.default_rng(rng_seed)
    b = self.ds.batch_size
    acc: Dict[str, torch.Tensor] = {}
    for _ in range(n_batches):
      moments = self._standing_pass(params, *self._draw(rng, b))
      acc = {k: acc[k] + v if k in acc else v for k, v in moments.items()}
    inv = 1.0 / n_batches
    return {**live, **{k: v * inv for k, v in acc.items()}}

  def _standing_pass(self, params: Dict[str, torch.Tensor], z, labels
                     ) -> Dict[str, torch.Tensor]:
    """One train-mode forward of G under ``params`` (its statistics do not
    advance) and its layers' batch statistics, the reference's jitted
    ``_standing_pass``: a compiled program."""
    g = self.state.g
    inputs = [z, labels]
    signature = compiled.spec(inputs)

    def body(static):
      with torch.no_grad(), L.capture_batch_moments(g) as moments:
        functional_call(g, params, tuple(static),
                        {"train": True, "update_stats": False})
      return dict(moments)

    return self._program("standing_pass", signature)(
        body, lambda: (self._g_key(params), compiled.backend_key(),
                       signature), inputs, self.device)

  def sampling_state(self) -> Dict[str, torch.Tensor]:
    """The tensors every sampling surface runs G on, by name, for
    ``functional_call``: nothing (the live G) without an EMA shadow; the
    shadow with G's live statistics when ``ema_standing_batches`` is 0;
    else the shadow with standing statistics under it. Those are cached
    until a G update or a restore (``state.g_version``, which a replayed
    step advances too) or a change to G's statistics buffers (their
    identity and version) comes between; a recompute returns a new dict,
    its standing statistics copied into the tensors of the last one (the
    sampling graphs read them there)."""
    st = self.state
    n = self.cfg.ema_standing_batches
    if not st.g_ema:
      return {}
    if n <= 0:
      return st.g_ema
    bufs = list(st.g.buffers())
    key = (st.g_version, n, tuple(b._version for b in bufs))
    cache = self._standing_cache
    if (cache is None or cache[0] != key or len(cache[1]) != len(bufs)
        or any(a is not b for a, b in zip(cache[1], bufs))):
      old = {} if cache is None else cache[2]
      live = {id(t) for t in bufs} | {id(t) for t in st.g_ema.values()}
      tensors = dict(st.g_ema)
      for k, t in self.standing_g_state(st.g_ema, n).items():
        held = old.get(k)
        if (id(t) not in live and held is not None
            and id(held) not in live and held.shape == t.shape
            and held.dtype == t.dtype):
          held.copy_(t)
          t = held
        tensors[k] = t
      # The buffers stay referenced, so no new tensor can reuse them.
      cache = self._standing_cache = (key, bufs, tensors)
    return cache[2]

  # -- sampling ---------------------------------------------------------------

  def _draw(self, rng: np.random.Generator, b: int):
    """(z (b, z_dim), labels (b,) or None) on the device from ``rng``: z,
    then, when the run is conditional, the labels, uniform over the
    classes, as the reference draws them."""
    z = rng.standard_normal((b, self.gan_cfg.z_dim)).astype(np.float32)
    labels = None
    if self.gan_cfg.conditional:
      labels = torch.from_numpy(rng.integers(
          0, self.gan_cfg.num_classes, b).astype(np.int32)).to(self.device)
    return torch.from_numpy(z).to(self.device), labels

  def sample(self, z, labels=None) -> torch.Tensor:
    """Images (N, H, W, C), float32 in [-1, 1], on the device, from z
    (N, z_dim) and, when the run is conditional, labels (N,): G in eval
    mode on ``sampling_state()``, a compiled program."""
    return self._sample("sample", z, labels)

  def sample_u8(self, z, labels=None) -> torch.Tensor:
    """``sample`` clipped and converted to uint8 on the device, so that
    only a quarter of the bytes cross to the host; a program of its own,
    as the reference jits it apart."""
    return self._sample("sample_u8", z, labels)

  def sample_eager(self, z, labels=None, u8: bool = False) -> torch.Tensor:
    """The eager body of ``sample`` (``sample_u8`` with ``u8``) on the
    same tensors: what their graphs replay, the eager arm of the checks
    and of the bench."""
    z, labels = self._sampling_inputs(z, labels)
    return self._sample_body("sample_u8" if u8 else "sample",
                             self.sampling_state(), z, labels)

  def _sampling_inputs(self, z, labels):
    z = step_lib.as_tensor(z, self.device)
    if self.gan_cfg.conditional and labels is not None:
      labels = step_lib.as_tensor(labels, self.device)
    else:
      labels = None
    return z, labels

  @torch.no_grad()
  def _sample_body(self, kind: str, tensors: Dict[str, torch.Tensor], z,
                   labels) -> torch.Tensor:
    imgs = functional_call(self.state.g, tensors, (z, labels),
                           {"train": False}).permute(0, 2, 3, 1)
    if kind == "sample_u8":
      imgs = (torch.clamp(imgs.float(), -1.0, 1.0) * 127.5 + 127.5).to(
          torch.uint8)
    return imgs

  def _sample(self, kind: str, z, labels) -> torch.Tensor:
    inputs = list(self._sampling_inputs(z, labels))
    tensors = self.sampling_state()
    signature = compiled.spec(inputs)
    return self._program(kind, signature)(
        lambda static: self._sample_body(kind, tensors, *static),
        lambda: (self._g_key(tensors), compiled.backend_key(), signature),
        inputs, self.device)

  def save_sample_grid(self, epoch: int) -> str:
    """The grid of ``grid_samples`` images from the dataset's fixed test
    z and labels, written to ``output_dir/epoch_{epoch:05d}.png``."""
    z, labels = self.ds.test_batch(self.cfg.grid_samples)
    imgs = self.sample(z, labels).cpu().numpy()
    path = os.path.join(self.cfg.output_dir, f"epoch_{epoch:05d}.png")
    save_png(path, make_grid(imgs))
    return path

  def generate(self, n: int, batch: int = 256,
               rng_seed: int = 1234) -> np.ndarray:
    """n generated images as uint8 (N, H, W, C) (for IS/FID scoring).
    Every batch is a full one, its z (then, when conditional, its labels)
    from a numpy generator seeded with ``rng_seed``; the tail is sliced
    off."""
    rng = np.random.default_rng(rng_seed)
    out = []
    for i in range(0, n, batch):
      b = min(batch, n - i)
      out.append(self.sample_u8(*self._draw(rng, batch))[:b].cpu().numpy())
    return np.concatenate(out)

  # -- main loop --------------------------------------------------------------

  def train(self) -> Dict[str, float]:
    batches = self.epoch_batches()
    if self._device_data is not None or self._window_elems:
      spc = self._steps_per_call
      rounded = (batches // spc) * spc
      if rounded != batches:
        # spc <= batches, so the epoch only ever gets shorter.
        self.logger.line(
            f"epoch length rounded {batches} -> {rounded} outer steps "
            f"(steps_per_call={spc} chaining)")
    try:
      return self._train_epochs(batches)
    finally:
      self._stop_profiler()
      self._drop_pending_window()

  def _profile_start(self) -> int:
    """The step call a ``profile_dir`` trace starts at: the one after the
    warm-up, and on CUDA after the compiled step's capture too."""
    compiled = isinstance(self.step_fn, step_lib.JitStep)
    return 2 if compiled and self.device.type == "cuda" else 1

  def _call_step(self, *batches) -> Dict[str, torch.Tensor]:
    """One ``step_fn`` call. With ``profile_dir`` the ``PROFILE_CALLS``
    calls after the warm-up (``_profile_start``) run under
    ``torch.profiler``; with ``debug_nans`` the call's metrics are checked
    at once."""
    cfg = self.cfg
    if (cfg.profile_dir and self.is_main and self._profiler is None
        and self._step_calls == self._profile_start()):
      from torch.profiler import ProfilerActivity, profile
      activities = [ProfilerActivity.CPU]
      if self.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
      self._profiler = profile(activities=activities)
      self._profile_from = self._step_calls
      self._profiler.start()
    metrics = self.step_fn(self.state, *batches)
    self._step_calls += 1
    if (self._profiler is not None
        and self._step_calls - self._profile_from >= self.PROFILE_CALLS):
      self._stop_profiler()
    if cfg.debug_nans:
      bad = {k: float(v) for k, v in metrics.items()
             if not math.isfinite(float(v))}
      if bad:
        raise FloatingPointError(
            f"non-finite metrics at step call {self._step_calls} (outer "
            f"step {self.state.step}): {bad}")
    return metrics

  def _stop_profiler(self) -> None:
    """End the trace, if one runs, and write it to ``profile_dir`` as a
    Chrome trace."""
    prof, self._profiler = self._profiler, None
    if prof is None:
      return
    if self.device.type == "cuda":
      torch.cuda.synchronize(self.device)
    prof.stop()
    os.makedirs(self.cfg.profile_dir, exist_ok=True)
    path = os.path.join(self.cfg.profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    self.logger.line(f"wrote profiler trace {path} "
                     f"({self._step_calls - self._profile_from} step calls)")

  def _train_epochs(self, batches: int) -> Dict[str, float]:
    cfg, ds = self.cfg, self.ds
    ratio = self.gan_cfg.training_ratio
    probe_n = cfg.residual_probe_every
    last: Dict[str, float] = {}
    for epoch in range(cfg.start_epoch, cfg.number_of_epochs):
      t0 = time.perf_counter()
      self._maybe_rotate_window()
      accum = []
      if self._device_data is not None:
        spc = self._steps_per_call
        calls = max(batches // spc, 1)
        steps_done = calls * spc
        # The probe cadence counts whole chains.
        probe_calls = max(probe_n // spc, 1) if probe_n else 0
        for ci in range(calls):
          accum.append(self._call_step(*self._device_data))
          self._outer_steps_done += spc
          if probe_calls and (ci + 1) % probe_calls == 0 and ci + 1 < calls:
            self._intra_epoch_probe(epoch, (ci + 1) * spc)
      else:
        steps_done = batches
        for bi in range(batches):
          real, labels = ds.next_batches(ratio)
          accum.append(self._call_step(real, labels))
          self._outer_steps_done += 1
          if probe_n and (bi + 1) % probe_n == 0 and bi + 1 < batches:
            self._intra_epoch_probe(epoch, bi + 1)
      # The metrics come back to the host once per epoch; the synchronise
      # then counts the epoch's last optimizer update in its time.
      means = {k: torch.stack([m[k] for m in accum]).mean().item()
               for k in accum[0]}
      if self.device.type == "cuda":
        torch.cuda.synchronize(self.device)
      dt = time.perf_counter() - t0
      imgs_per_sec = steps_done * ratio * ds.batch_size / dt
      self.logger.epoch_line(epoch, means,
                             extra=f"imgs/sec = {imgs_per_sec:.1f}")
      diag = self.diagnostics()
      self.logger.jsonl(dict(epoch=epoch, **means, **diag,
                             imgs_per_sec=imgs_per_sec, seconds=dt))
      # An under-converged inverse square root feeds back into the
      # conditioning while the losses still look healthy.
      self._residual_guard(epoch, diag.get("wc_whiten_residual_max", 0.0),
                           cond=diag.get("wc_cov_cond_max", float("nan")))
      if not all(math.isfinite(v) for v in means.values()):
        self.save_checkpoint(epoch)
        self.logger.line(f"Epoch {epoch}: NON-FINITE metrics {means}; "
                         "checkpointed and aborting")
        raise FloatingPointError(f"non-finite training metrics: {means}")
      if (cfg.display_ratio and (epoch + 1) % cfg.display_ratio == 0
          and self.is_main):
        self.save_sample_grid(epoch)
      if cfg.checkpoint_ratio and (epoch + 1) % cfg.checkpoint_ratio == 0:
        self.save_checkpoint(epoch)
      if (self.scorer is not None and cfg.score_every
          and (epoch + 1) % cfg.score_every == 0):
        scores = self.scorer(self)
        self.logger.line(
            f"Epoch {epoch}: " + "; ".join(
                f"{k} = {v:.4f}" for k, v in scores.items()))
        self.logger.jsonl(dict(epoch=epoch, **scores))
        last.update(scores)
      last.update(means)
    return last
