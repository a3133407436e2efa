"""Scoring: sample G, run InceptionV3, compute IS and FID.

Counterpart of ``wcgan_tpu/evaluation/scorer.py``: every ``score_every``
epochs the Trainer calls the scorer with itself; it generates images
(``Trainer.generate``), pushes them through InceptionV3 in batches on the
trainer's device, and returns {'inception_score', 'is_std', 'fid'}.
Without ``inception_weights`` (an npz of torchvision's state_dict; see
``inception_v3.load_npz``) the network has random weights and every key
is prefixed ``unverified_``, so that a meaningless score cannot pass for
a real one.

With a process ``group`` (the reference's ``mesh``) every rank calls the
scorer: ``generate`` gives every rank the same images (the state is
replicated and the seed fixed), rank r runs InceptionV3 on its contiguous
block of them (``mesh.split_block``), and the pool and probability rows
are gathered in order on every rank (``mesh.all_gather_rows``). Inception
is in eval mode, so the rows, and so every rank's scores, are one
process's up to float32 reordering.

The network's convolutions run in TF32 by default (``conv_tf32``, as the
reference leaves InceptionV3's convolutions at JAX's default precision,
``wcgan_tpu/evaluation/inception_v3.py:40-42``); its products and the
IS/FID math stay true float32 (``metrics.true_float32``: TF32 off,
whatever the caller set), and ``conv_tf32=False`` makes the convolutions
true float32 too. Its forward is a compiled
program (the reference's ``jax.jit`` ``apply_fn``; ``compiled.Program``):
on CUDA one CUDA-graph replay a batch after a warm-up and a capture, its
graph keyed on the batch's shape and on the precision settings that
chose its kernels; on the CPU the eager forward on static buffers. Under
a group each rank captures its own; the gather stays outside the graph.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from wcgan_tpu_torch import compiled
from wcgan_tpu_torch.evaluation import inception_v3, metrics
from wcgan_tpu_torch.parallel import mesh

ApplyFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _activations(apply_fn: ApplyFn, images_u8: np.ndarray, batch: int,
                 device: torch.device, want_pool: bool = True,
                 want_probs: bool = True, pool_rows: Optional[int] = None,
                 group: mesh.Group = None
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
  """(pool rows, probability rows) of ``images_u8`` (N, H, W, C) on
  ``device``, ``batch`` images a forward; only the outputs asked for are
  kept. ``pool_rows`` keeps the pool of the first N rows only (FID's
  piggyback on the IS pass); more rows than images raise. Under a
  ``group`` this rank runs its block of the images and the rows are
  gathered from every rank, in order.

  Every forward takes ``batch`` images (or all of this rank's, when it
  holds fewer): a short last batch is padded with zeros to that size and
  its rows sliced, as the reference pads it, so that one compiled program
  (one CUDA graph) serves every batch. Eval mode has no cross-sample op,
  so the rows are the unpadded batch's."""
  n = images_u8.shape[0]
  if want_pool and pool_rows is not None and pool_rows > n:
    raise ValueError(
        f"pool_rows={pool_rows} exceeds available rows {n} — the FID "
        f"sample count must not exceed the images provided")
  world = mesh.world_size(group)
  if n < world:
    raise ValueError(f"{n} images cannot be shared by {world} ranks")
  lo, hi = mesh.split_block(n, mesh.rank(group), world)
  cap = n if pool_rows is None else pool_rows
  size = min(batch, hi - lo)
  pools, probs = [], []
  for i in range(lo, hi, batch):
    chunk = images_u8[i:min(i + batch, hi)]
    rows = chunk.shape[0]
    if rows < size:
      chunk = np.concatenate([chunk, np.zeros(
          (size - rows,) + chunk.shape[1:], chunk.dtype)])
    pool, prob = apply_fn(torch.from_numpy(chunk).to(device))
    if want_pool:
      # A 0-row slice past the cap keeps the pool's width for the gather.
      pools.append(pool[:max(min(cap - i, rows), 0)])
    if want_probs:
      probs.append(prob[:rows])
  pool = mesh.all_gather_rows(torch.cat(pools), group) if want_pool else None
  prob = mesh.all_gather_rows(torch.cat(probs), group) if want_probs else None
  return pool, prob


def make_scorer(dataset, compute_is: bool = True, compute_fid: bool = True,
                samples_inception: int = 50000, samples_fid: int = 10000,
                inception_weights: Optional[str] = None,
                batch: int = 100,
                group: mesh.Group = None,
                conv_tf32: bool = True) -> Callable[..., Dict[str, float]]:
  """The Trainer's scorer callback. InceptionV3 is built at the first
  call, on the trainer's device; the real images' moments (FID) are
  computed once and cached across calls. ``conv_tf32`` (the default, and
  so the CLI's) lets cuDNN run InceptionV3's convolutions in TF32 (its
  products and the IS/FID math stay true float32): FID within 1e-3 of
  float64 and IS within 1e-5 on the card, 3.41x faster (PERF.md);
  ``False`` runs them in true float32, as ``wcgan_tpu_torch.bench``'s
  float32 arm does."""
  cache = {}

  def get_net(device: torch.device) -> Tuple[ApplyFn, bool]:
    if "apply" not in cache:
      if inception_weights:
        net = inception_v3.load_npz(inception_weights)
        cache["verified"] = True
      else:
        net = inception_v3.init_params()
        cache["verified"] = False
      net = net.to(device).eval()
      program = compiled.Program("the scorer's InceptionV3 forward")

      @torch.no_grad()
      def forward(static):
        with metrics.true_float32():
          torch.backends.cudnn.allow_tf32 = conv_tf32
          pool, logits = net(inception_v3.preprocess(static[0]))
        return pool, torch.softmax(logits.float(), dim=-1)

      def apply_fn(images_u8: torch.Tensor):
        signature = compiled.spec(images_u8)
        return program(forward, lambda: (
            compiled.module_key(net), compiled.backend_key(), conv_tf32,
            signature), [images_u8], device)

      cache["apply"] = apply_fn
    return cache["apply"], cache["verified"]

  def scorer(trainer) -> Dict[str, float]:
    device = trainer.device
    apply_fn, verified = get_net(device)
    out: Dict[str, float] = {}
    # Wall clocks of each part go to the run's log.
    log = getattr(getattr(trainer, "logger", None), "line",
                  lambda s: None)

    # Trainer.generate reseeds every call, so with both metrics on, FID's
    # fakes would be the first samples_fid images of the IS set: they are
    # generated and run through the network once, their pool kept from
    # the IS pass.
    piggyback = compute_is and compute_fid and \
        samples_fid <= samples_inception
    pool_head = None

    if compute_is:
      t0 = time.perf_counter()
      imgs = trainer.generate(samples_inception)
      t1 = time.perf_counter()
      pool_head, probs = _activations(
          apply_fn, imgs, batch, device, want_pool=piggyback,
          pool_rows=samples_fid if piggyback else None, group=group)
      mean, std = metrics.inception_score(probs)
      out["inception_score"] = float(mean)
      out["is_std"] = float(std)
      dt = time.perf_counter() - t1
      log(f"scorer: IS over {samples_inception} samples — generate "
          f"{t1 - t0:.3f}s, inception+score {dt:.3f}s "
          f"({samples_inception / dt:.1f} imgs/s)"
          + (" (FID pool piggybacked)" if piggyback else ""))

    if compute_fid:
      t0 = time.perf_counter()
      if "real_moments" not in cache:
        real = dataset.real_sample(samples_fid)
        if real.shape[0] != samples_fid:
          # real_sample clamps to the dataset's size; the log must not
          # claim samples_fid real rows.
          log(f"scorer: WARNING dataset has only {real.shape[0]} real "
              f"images (< samples_fid {samples_fid}); FID real moments "
              f"use {real.shape[0]} rows")
        pool_r, _ = _activations(apply_fn, real, batch, device,
                                 want_probs=False, group=group)
        cache["real_moments"] = metrics.moments_from_activations(pool_r)
      t1 = time.perf_counter()
      if pool_head is not None:
        pool_f = pool_head
      else:
        fake = trainer.generate(samples_fid)
        pool_f, _ = _activations(apply_fn, fake, batch, device,
                                 want_probs=False, group=group)
      mu_f, sig_f = metrics.moments_from_activations(pool_f)
      mu_r, sig_r = cache["real_moments"]
      out["fid"] = metrics.fid_from_moments(mu_r, sig_r, mu_f, sig_f)
      log(f"scorer: FID over {samples_fid} samples — real moments "
          f"{t1 - t0:.3f}s (cached after first call), fake+distance "
          f"{time.perf_counter() - t1:.3f}s")

    if not verified:
      out = {f"unverified_{k}": v for k, v in out.items()}
    return out

  return scorer
