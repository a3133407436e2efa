"""Data-parallel dry runs, and the rank functions that drive one
data-parallel piece of the port on every rank.

``dryrun_multichip(n)`` is the counterpart of
``__graft_entry__.py::dryrun_multichip``. For each of its three
configurations (the flagship cWC + projection-D, hinge, ratio 5; config
4's cWC-sa with a plain SN D under WGAN-GP, ratio 2; AC-GAN, ratio 2), at
thin widths and 32x32, bf16, with random flips and 2 images a rank:

- one data-parallel outer step on ``n`` ranks: finite metrics, and every
  tensor of the state bit-equal on every rank;
- the global-batch equivalence of one train-mode G forward: the ranks'
  outputs, concatenated, against one process on the concatenated batch,
  within 2e-5 in float32 and 1e-2 in bf16 (the reference's gates), or,
  where it is larger, within twice the process's own spread: in float32
  its deviation when only the order of the batch changes, in bf16 its
  deviation from its float32 images (two bf16 computations of one
  function differ by up to the sum of their errors). In bf16 a rounding
  flip of a folded whitening matrix moves the images by more than 1e-2
  (2.28e-2 for the flagship G on the CPU) whatever the sharding, and
  which orders flip it is chance.

The rank functions (``moments_rank``, ``forward_rank``, ``step_rank``,
``trainer_rank``, ``scorer_rank``) run under ``launch.launch``: the tests
hold them against the JAX package, and ``chip_smoke.py`` runs them on the
card. They take numpy arrays of the
global batch and state dicts, and return their results on the CPU.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from wcgan_tpu_torch.cli import run as cli_run
from wcgan_tpu_torch.data.base import ArrayDataset
from wcgan_tpu_torch.data.datasets import _synthetic
from wcgan_tpu_torch.device import place
from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
from wcgan_tpu_torch.models.generator import Generator, GeneratorConfig
from wcgan_tpu_torch.ops import cuda_wc, whiten
from wcgan_tpu_torch.parallel import launch, mesh
from wcgan_tpu_torch.train.state import OptimConfig, create_state, full_state
from wcgan_tpu_torch.train.step import GANConfig, make_sharded_step


def to_cpu(tree: Any) -> Any:
  """``tree`` with every tensor copied to the CPU."""
  if torch.is_tensor(tree):
    return tree.detach().cpu().clone()
  if isinstance(tree, dict):
    return {k: to_cpu(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(to_cpu(v) for v in tree)
  return tree


def replication_errors(a: Any, b: Any, where: str = "state") -> List[str]:
  """Where two trees of tensors and numbers are not bit-equal (tensors
  compared by value, wherever they live)."""
  if torch.is_tensor(a):
    same = (torch.is_tensor(b) and a.dtype == b.dtype
            and a.shape == b.shape and torch.equal(a.cpu(), b.cpu()))
    return [] if same else [where]
  if isinstance(a, dict):
    if not isinstance(b, dict) or set(a) != set(b):
      return [where]
    return [e for k in a for e in replication_errors(a[k], b[k],
                                                     f"{where}.{k}")]
  if isinstance(a, (list, tuple)):
    if not isinstance(b, (list, tuple)) or len(a) != len(b):
      return [where]
    return [e for i, (x, y) in enumerate(zip(a, b))
            for e in replication_errors(x, y, f"{where}[{i}]")]
  return [] if a == b else [where]


def _block(a: np.ndarray, ctx: launch.RankContext, axis: int = 0):
  """This rank's contiguous block of ``a`` along ``axis``."""
  lo, hi = mesh.shard_block(a.shape[axis], ctx.rank, ctx.world_size)
  return np.take(a, np.arange(lo, hi), axis=axis)


def _tensor(a: Optional[np.ndarray], device: torch.device):
  return None if a is None else torch.from_numpy(np.array(a)).to(device)


def moments_rank(ctx: launch.RankContext, x: np.ndarray, w_mean: np.ndarray,
                 w_cov: np.ndarray) -> Dict[bool, Dict[str, np.ndarray]]:
  """``whiten.batch_moments`` of this rank's rows of ``x`` (R, C) over the
  group, by each route (``use_kernel`` True and False), with the gradient
  of this rank's rows under the loss (sum(w_mean * mean) + sum(w_cov *
  cov)) / ranks: the ranks' losses sum to that of one process on all of
  ``x``."""
  out = {}
  for use_kernel in (True, False):
    rows = _tensor(_block(x, ctx), ctx.device).requires_grad_(True)
    mean, cov = whiten.batch_moments(rows, use_kernel, ctx.group)
    loss = (torch.sum(mean * _tensor(w_mean, ctx.device))
            + torch.sum(cov * _tensor(w_cov, ctx.device))) / ctx.world_size
    loss.backward()
    out[use_kernel] = {"mean": mean.detach().cpu().numpy(),
                       "cov": cov.detach().cpu().numpy(),
                       "grad": rows.grad.cpu().numpy()}
  return out


def forward_rank(ctx: launch.RankContext, g_cfg: GeneratorConfig,
                 g_weights: Dict, z: np.ndarray,
                 labels: Optional[np.ndarray] = None,
                 reference: bool = False) -> Dict[str, Any]:
  """One train-mode G forward of this rank's rows of ``z`` (and labels)
  over the group: its images (NHWC, float32) and G's running statistics
  after it. With ``reference``, rank 0 also runs G without a group on
  all of ``z`` ('reference'), and on all of it in reverse order, the
  images put back in order ('reordered')."""
  init = torch.Generator().manual_seed(0)
  rev = slice(None, None, -1)
  runs = [("out", ctx.group, _block(z, ctx),
           None if labels is None else _block(labels, ctx))]
  if reference and ctx.rank == 0:
    runs += [("reference", None, z, labels),
             ("reordered", None, z[rev], None if labels is None
              else labels[rev])]
  res = {}
  for name, group, zz, yy in runs:
    g = Generator(g_cfg, init, group)
    g.load_state_dict(g_weights)
    g = place(g, ctx.device)
    out = g(_tensor(zz, ctx.device), _tensor(yy, ctx.device), train=True,
            update_stats=True)
    res[name] = out.float().permute(0, 2, 3, 1).detach().cpu().numpy()
    if name == "out":
      res["stats"] = to_cpu(dict(g.named_buffers()))
  if "reordered" in res:
    res["reordered"] = res["reordered"][rev]
  return res


def step_rank(ctx: launch.RankContext, g_cfg: GeneratorConfig,
              d_cfg: DiscriminatorConfig, gan_cfg: GANConfig,
              weights: Optional[Dict], real: Sequence[np.ndarray],
              labels: Sequence[Optional[np.ndarray]],
              noises: Optional[Sequence[Sequence[Dict]]] = None,
              seed: int = 0) -> Dict[str, Any]:
  """``len(real)`` data-parallel outer steps (``make_sharded_step``) from
  ``create_state``'s state of ``seed`` (with ``weights``, {"g": state
  dict, "d": state dict}, loaded into it when given): step i on the
  global batch ``real[i]`` (K, B, H, W, C) uint8 with ``labels[i]`` (K,
  B), and this rank's noise ``noises[i][rank]`` (drawn from its generator
  when ``noises`` is None). Returns the metrics of each step and the
  whole state after them."""
  state = create_state(g_cfg, d_cfg, OptimConfig(), gan_cfg.training_ratio,
                       ctx.device, seed, group=ctx.group)
  if weights is not None:
    state.g.load_state_dict(weights["g"])
    state.d.load_state_dict(weights["d"])
  step = make_sharded_step(gan_cfg, ctx.group)
  metrics = []
  for i, (x, y) in enumerate(zip(real, labels)):
    noise = None if noises is None else noises[i][ctx.rank]
    metrics.append({k: float(v) for k, v in step(state, x, y,
                                                 noise=noise).items()})
  return {"metrics": metrics, "state": to_cpu(full_state(state))}


def deterministic_rank(ctx: launch.RankContext) -> None:
  """Deterministic kernels for the rest of this rank's job (cuDNN's and
  PyTorch's), so that two runs differ only where their code does."""
  del ctx
  torch.use_deterministic_algorithms(True, warn_only=True)
  torch.backends.cudnn.deterministic = True
  torch.backends.cudnn.benchmark = False


def _experiment(ctx: launch.RankContext, argv: Sequence[str],
                synthetic: Dict[str, int]):
  """The CLI's experiment of ``argv`` on this rank, on the synthetic
  dataset of ``synthetic``'s shape and class count ({"resolution",
  "classes", "n", "seed"}; the synthetic dataset of ``--dataset`` has 10
  classes)."""
  args = cli_run.build_parser().parse_args(cli_run.expand_preset(
      list(argv)))
  args.device = str(ctx.device)
  cli_run.set_precision()
  images, labels = _synthetic(synthetic["resolution"], synthetic["classes"],
                              n=synthetic["n"], seed=synthetic["seed"])
  dataset = ArrayDataset(images, labels, args.batch_size,
                         num_classes=synthetic["classes"], z_dim=args.z_dim,
                         seed=args.seed)
  return cli_run.build_experiment(args, ctx.group, dataset=dataset)


def trainer_rank(ctx: launch.RankContext, argv: Sequence[str],
                 synthetic: Dict[str, int]) -> Dict[str, Any]:
  """The CLI's experiment of ``argv`` on this rank (``_experiment``):
  one epoch to warm up, then one call of the trainer's step chain
  (``steps_per_call`` outer steps on the device data), counted and timed
  without the epoch's bookkeeping. Returns the chain's K1 launches,
  all-reduce calls and bytes by kind, seconds, outer steps and mean
  metrics, the state after it, and the rows of the dataset this rank
  holds."""
  trainer = _experiment(ctx, argv, synthetic)
  trainer.cfg.number_of_epochs = 1
  trainer.train()
  sync = (torch.cuda.synchronize if ctx.device.type == "cuda"
          else lambda: None)
  sync()
  cuda_wc.MOMENTS_LAUNCHES = 0
  mesh.STATS.reset()
  t0 = time.perf_counter()
  metrics = trainer.step_fn(trainer.state, *trainer._device_data)
  metrics = {k: float(v) for k, v in metrics.items()}
  sync()
  return {"k1": cuda_wc.MOMENTS_LAUNCHES, "calls": dict(mesh.STATS.calls),
          "bytes": dict(mesh.STATS.bytes),
          "seconds": time.perf_counter() - t0,
          "steps": trainer._steps_per_call, "metrics": metrics,
          "state": to_cpu(full_state(trainer.state)),
          "rows": len(trainer._device_data[0])}


def scorer_rank(ctx: launch.RankContext, argv: Sequence[str],
                synthetic: Dict[str, int]) -> Dict[str, Any]:
  """One call of the scorer that the CLI builds from ``argv`` (its
  scoring flags) on this rank's experiment (``_experiment``), over the
  group; with ``ctx.group`` None, one process. Returns the scores, the
  collectives by kind, the seconds and the scorer's log lines."""
  trainer = _experiment(ctx, argv, synthetic)
  lines: List[str] = []
  trainer.logger.line = lines.append
  sync = (torch.cuda.synchronize if ctx.device.type == "cuda"
          else lambda: None)
  mesh.STATS.reset()
  t0 = time.perf_counter()
  scores = trainer.scorer(trainer)
  sync()
  return {"scores": scores, "calls": dict(mesh.STATS.calls),
          "bytes": dict(mesh.STATS.bytes),
          "seconds": time.perf_counter() - t0, "log": lines}


def batch_rank(ctx: launch.RankContext,
               calls: Sequence[Any]) -> List[Any]:
  """Several rank functions of this module in one job: ``calls`` is a
  list of (function name, arguments after ``ctx``)."""
  return [globals()[name](ctx, *args) for name, args in calls]


# --- the dry run ------------------------------------------------------------

ZDIM, CLASSES, RES = 16, 10, 32
_G = dict(z_dim=ZDIM, resolution=RES, base_resolution=4, filters=(16, 16, 16),
          block_norm="d", last_norm="d", num_classes=CLASSES, ns_iters=6)
_D = dict(resolution=RES, filters=(16, 16, 16, 16),
          downsample=(True, True, False, False), ns_iters=6)

# (name, G kwargs, D kwargs, GANConfig kwargs, the parameter that shows the
# path is the configuration's), as __graft_entry__.py's _DRYRUN_CONFIGS.
DRYRUN_CONFIGS = (
    ("flagship cond cWC ucconv + projection-D, hinge, ratio 5",
     dict(block_coloring="ucconv", last_coloring="ucconv"),
     dict(num_classes=CLASSES, projection=True),
     dict(training_ratio=5, gan_type="projection"),
     "nc_out.gamma_a"),
    ("config-4-class cond cWC-sa (ucconv-sa, K=10) + plain SN-D, "
     "wgan-gp(10), ratio 2",
     dict(block_coloring="ucconv-sa", last_coloring="ucconv-sa",
          filters_emb=10),
     dict(),
     dict(training_ratio=2, loss="wgan-gp", gradient_penalty_weight=10.0),
     "nc_out.basis"),
    ("AC-GAN cond cWC ucconv + SN-D aux classifier head, hinge, ratio 2",
     dict(block_coloring="ucconv", last_coloring="ucconv"),
     dict(num_classes=CLASSES, ac_gan=True),
     dict(training_ratio=2, gan_type="acgan"),
     "fc_cls.weight"),
)
EQUIVALENCE_ATOL = {"float32": 2e-5, "bfloat16": 1e-2}


def dryrun_rank(ctx: launch.RankContext) -> Dict[str, Dict[str, Any]]:
  """This rank's part of ``dryrun_multichip``, for every configuration."""
  batch = 2 * ctx.world_size
  out = {}
  for name, g_kw, d_kw, gan_kw, param in DRYRUN_CONFIGS:
    g_cfg = GeneratorConfig(**_G, **g_kw, dtype="bfloat16")
    d_cfg = DiscriminatorConfig(**_D, **d_kw, dtype="bfloat16")
    gan = GANConfig(z_dim=ZDIM, num_classes=CLASSES, random_flip=True,
                    generator_batch_multiple=2, **gan_kw)
    ratio = gan.training_ratio
    real = np.zeros((ratio, batch, RES, RES, 3), np.uint8)
    labels = np.tile(np.arange(batch, dtype=np.int32) % CLASSES, (ratio, 1))
    res = step_rank(ctx, g_cfg, d_cfg, gan, None, [real], [labels])
    names = set(res["state"]["g"]) | {f"D/{k}" for k in res["state"]["d"]}
    res["has_param"] = any(k.endswith(param) for k in names)
    z = torch.randn((batch, ZDIM),
                    generator=torch.Generator().manual_seed(1)).numpy()
    y = np.arange(batch, dtype=np.int32) % CLASSES
    init = Generator(GeneratorConfig(**_G, **g_kw),
                     torch.Generator().manual_seed(2)).state_dict()
    res["forward"] = {
        dtype: forward_rank(ctx, GeneratorConfig(**_G, **g_kw, dtype=dtype),
                            init, z, y, reference=True)
        for dtype in EQUIVALENCE_ATOL}
    out[name] = res
  return out


def dryrun_multichip(n_devices: int = 2,
                     devices: Optional[Sequence[str]] = None,
                     timeout: float = 900.0) -> Dict[str, Dict[str, Any]]:
  """The dry run on ``n_devices`` CPU ranks, or on ``devices`` (e.g.
  ['cuda:0', 'cuda:0']: two ranks on one card, over gloo). Raises on a
  failed check; returns, per configuration, the metrics and the largest
  deviation of the sharded forward by dtype."""
  devices = list(devices or ["cpu"] * n_devices)
  ranks = launch.launch("wcgan_tpu_torch.parallel.dryrun:dryrun_rank",
                        devices, timeout=timeout, quiet=True)
  report = {}
  for name in ranks[0]:
    res = ranks[0][name]
    metrics = res["metrics"][0]

    def check(ok: bool, what: str) -> None:
      if not ok:
        raise RuntimeError(f"dryrun_multichip [{name}]: {what}")

    check(res["has_param"], "the configuration's path is not active")
    check(res["state"]["step"] == 1, "the step did not run")
    check(all(math.isfinite(v) for v in metrics.values()),
          f"non-finite metrics {metrics}")
    for r in range(1, len(ranks)):
      bad = replication_errors(res["state"], ranks[r][name]["state"])
      check(not bad, f"rank {r} differs from rank 0 at {bad[:5]}")
    max_dev, gate = {}, {}
    f32 = res["forward"]["float32"]["reference"]
    for dtype, atol in EQUIVALENCE_ATOL.items():
      fwd = res["forward"][dtype]
      got = np.concatenate([rk[name]["forward"][dtype]["out"]
                            for rk in ranks])
      max_dev[dtype] = float(np.max(np.abs(got - fwd["reference"])))
      own = fwd["reordered"] if dtype == "float32" else f32
      spread = float(np.max(np.abs(own - fwd["reference"])))
      gate[dtype] = max(atol, 2.0 * spread)
      check(max_dev[dtype] <= gate[dtype],
            f"global-batch equivalence violated ({dtype}): max|sharded - "
            f"single| = {max_dev[dtype]:.3e} > {gate[dtype]:.3e} (the "
            f"larger of {atol} and twice the process's own spread "
            f"{spread:.3e})")
    report[name] = {"metrics": metrics, "max_dev": max_dev, "gate": gate}
  return report
