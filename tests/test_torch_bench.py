"""The port's benchmark (``wcgan_tpu_torch.bench``, ``tools/bench_shapes``)
against the JAX package's ``wcgan_tpu/tools/bench_shapes.py``, on the CPU.

The shapes are held to the reference's field by field; the bench's CLI,
its sampling arms and its modes run at small sizes; its FLOP count is held
to an analytic count of the same outer step."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from wcgan_tpu.tools import bench_shapes as j_shapes
from wcgan_tpu_torch import bench
from wcgan_tpu_torch.models.discriminator import DiscriminatorConfig
from wcgan_tpu_torch.models.generator import GeneratorConfig
from wcgan_tpu_torch.ops import cuda_wc, whiten
from wcgan_tpu_torch.tools import bench_shapes as t_shapes
from wcgan_tpu_torch.train.step import GANConfig

ROOT = Path(__file__).resolve().parent.parent
# Config fields that only one side has: the reference's mesh axis (the
# port passes a process group to the modules instead), and the port's
# kernel switches (K1 for the moments, K2 for eval-mode WC layers).
ONLY_JAX = {"axis_name"}
ONLY_PORT_G = {"use_kernel", "kernel_eval"}
ONLY_PORT_D = {"use_kernel"}


@pytest.fixture(autouse=True)
def _default_precision_after():
  """Each test leaves the whitening precision at the default 'highest':
  ``bench.main`` sets it for its mode ('high' for the ablation modes),
  and the next test in the same worker may be a parity test against
  JAX."""
  yield
  whiten.set_precision("highest")


def _fields(cfg) -> dict:
  return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_configs_copy_matches():
  assert t_shapes.CONFIGS == j_shapes.CONFIGS
  assert list(t_shapes.CONFIGS) == list(j_shapes.CONFIGS)


@pytest.mark.parametrize("config", list(j_shapes.CONFIGS))
def test_build_models_matches_jax(config):
  jg, jd, jspec = j_shapes.build_models(config, dtype="float32", ns_iters=16,
                                        ns_scaling="fro", zdim=96,
                                        block_norm="dr")
  tg, td, tspec = t_shapes.build_models(config, dtype="float32", ns_iters=16,
                                        ns_scaling="fro", zdim=96,
                                        block_norm="dr")
  assert tspec == jspec
  for (j, t, only_port) in ((jg.cfg, tg, ONLY_PORT_G),
                            (jd.cfg, td, ONLY_PORT_D)):
    jf, tf = _fields(j), _fields(t)
    assert set(jf) - set(tf) == ONLY_JAX
    assert set(tf) - set(jf) == only_port
    for name in set(jf) & set(tf):
      assert tf[name] == jf[name], (config, type(t).__name__, name)
  # The fields the bench sets, named: widths, resolutions, classes,
  # coloring, the conditional heads, Newton-Schulz and the dtype.
  assert tg.base_resolution * 2 ** len(tg.filters) == tg.resolution
  assert td.projection == (tspec["ncls"] > 0 and not tspec.get("acgan"))
  assert td.ac_gan == bool(tspec.get("acgan"))
  assert tg.use_kernel is None and td.use_kernel is None


def test_build_models_refuses_an_unknown_config():
  with pytest.raises(KeyError, match="unknown config 'nope'"):
    t_shapes.build_models("nope")


@pytest.mark.parametrize("config", ["headline", "cfg2"])
def test_build_bench_matches_jax(config):
  _, _, (j_real, j_labels), j_spec = j_shapes.build_bench(
      config, batch=2, dtype="float32")
  step_fn, state, (real, labels), spec = t_shapes.build_bench(
      config, batch=2, dtype="float32", device="cpu")
  assert spec == j_spec
  assert tuple(real.shape) == j_real.shape and real.dtype == torch.uint8
  assert str(j_real.dtype) == "uint8"
  assert tuple(labels.shape) == j_labels.shape
  assert labels.dtype == torch.int32 and str(j_labels.dtype) == "int32"
  assert 0 <= int(labels.min()) and int(labels.max()) < max(spec["ncls"], 1)
  g_cfg, d_cfg, _ = t_shapes.build_models(config, dtype="float32")
  assert state.g.cfg == g_cfg and state.d.cfg == d_cfg
  metrics = step_fn(state, real, labels)
  assert sorted(metrics) == ["d_grad_norm", "d_loss", "g_grad_norm",
                             "g_loss"]
  assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
  assert state.step == 1


@pytest.fixture(autouse=True)
def one_thread():
  """One intra-op thread: the suite runs several workers at once, and a
  full-width step under thread oversubscription slows down by orders of
  magnitude."""
  before = torch.get_num_threads()
  torch.set_num_threads(1)
  try:
    yield
  finally:
    torch.set_num_threads(before)


def test_bench_cli_record_on_cpu():
  """The record, parsed from its last line, from a CPU run (on one
  thread, as ``one_thread``)."""
  env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
             MKL_NUM_THREADS="1")
  proc = subprocess.run(
      [sys.executable, "-m", "wcgan_tpu_torch.bench", "--device", "cpu",
       "--batch", "2", "--steps", "1", "--repeats", "2", "--no-b128",
       "--no-dfake", "--f32"], cwd=ROOT, env=env, capture_output=True,
      text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr[-2000:]
  rec = json.loads(proc.stdout.strip().splitlines()[-1])
  for key in ("metric", "value", "unit", "vs_baseline", "spread",
              "k1_launches_per_step", "device", "tf32_matmul", "tf32_cudnn",
              "cudnn_benchmark", "torch", "cuda", "flops_per_outer_step",
              "mfu", "peak", "max_memory_mib"):
    assert key in rec, key
  assert rec["unit"] == "imgs/sec/chip" and "float32" in rec["metric"]
  assert rec["device"]["platform"] == "cpu"
  assert rec["mfu"] is None and rec["peak"] is None
  assert "busy" not in rec and "profile" not in rec
  assert rec["tf32_matmul"] is False and rec["tf32_cudnn"] is False
  lo, hi = rec["spread"]["value"]
  assert 0 < lo <= rec["value"] <= hi
  assert rec["vs_baseline"] == pytest.approx(
      rec["value"] / bench.BASELINE_IMGS_PER_SEC)
  # The wrapper counts kernel launches only: the CPU runs K1's plain version.
  assert rec["k1_launches_per_step"] == 0
  assert rec["flops_per_outer_step"] > 0
  assert "value_b128" not in rec and "value_dfake_running" not in rec


def test_bench_cuda_without_a_card_raises():
  if torch.cuda.is_available():
    pytest.skip("a CUDA GPU is present")
  with pytest.raises(RuntimeError, match="no CUDA"):
    bench.main(["--sampling"])


def test_sampling_arms_on_cpu(monkeypatch):
  """Every arm at batch 2, the compiled ones (on the CPU their eager body
  on static buffers) beside the eager ones; the K2 arms run K2's plain
  version, 7 calls a forward, the split arms none; none launches a
  kernel."""
  calls = []
  reference = cuda_wc.whiten_color_apply_reference

  def counted(*a, **kw):
    calls.append(a[0].shape)
    return reference(*a, **kw)
  monkeypatch.setattr(cuda_wc, "whiten_color_apply_reference", counted)
  row = bench.bench_sampling("float32", batch=2, forwards=1, repeats=2,
                             device="cpu")
  # Two warm-up and two timed forwards on each of the two K2 arms.
  assert len(calls) == 7 * 4 * 2
  assert sorted(set(shape[1] for shape in calls)) == [256]
  for arm in ("k2_kernel", "k2_kernel_eager", "split", "split_eager"):
    assert row[arm]["n"] == 2
    assert 0 < row[arm]["min"] <= row[arm]["median"] <= row[arm]["max"]
    assert row[arm]["k2_launches_per_forward"] == 0
  assert row["dtype"] == "float32" and row["batch"] == 2


# A tiny program for the FLOP count: the headline's structure (res G with
# fused WC 'uconv' layers, SN res D without norms, hinge, flips, G update
# at twice the batch) at widths 8.
TINY = dict(z=8, res=16, batch=2, ratio=2, g=(8, 8),
            d=((8, 8, 8), (True, True, False)))
HEADLINE = dict(z=128, res=32, batch=64, ratio=5, g=(256, 256, 256),
                d=((128, 128, 128, 128), (True, True, False, False)))
NS = 15
# The reference's XLA count of the unrolled headline outer step
# (scripts/mfu.py:55-57), and the counter's count of the port's.
XLA_HEADLINE_FLOPS = 3.764e12
PORT_HEADLINE_FLOPS = 4_130_862_698_240


def _tiny_bench():
  g_cfg = GeneratorConfig(z_dim=TINY["z"], resolution=TINY["res"],
                          base_resolution=4, filters=TINY["g"], ns_iters=NS)
  d_cfg = DiscriminatorConfig(resolution=TINY["res"], filters=TINY["d"][0],
                              downsample=TINY["d"][1], ns_iters=NS)
  spec = dict(res=TINY["res"], ncls=0, coloring="uconv", arch="res",
              ratio=TINY["ratio"], loss="hinge")
  gan = GANConfig(training_ratio=TINY["ratio"], generator_batch_multiple=2,
                  z_dim=TINY["z"], random_flip=True)
  return t_shapes.bench_from(g_cfg, d_cfg, spec, gan, TINY["batch"], "cpu",
                             0)


def _taps(size: int, k: int, xla: bool) -> int:
  """Kernel taps summed over one spatial dim of a stride-1 'SAME' conv:
  k per output, or (XLA's convention) only those inside the input."""
  if not xla:
    return size * k
  pad = (k - 1) // 2
  return sum(min(k, size - o + pad) - max(0, pad - o) for o in range(size))


def analytic_flops(m: dict, xla: bool = False) -> int:
  """Every product of one outer step of the headline-structured program
  ``m``, counted from the model's structure: 2 flops a multiply-add of
  each matrix product and convolution (one-row products included;
  matrix-vector products and elementwise work are not, as
  FlopCounterMode does not count them).

  - A WC layer (C channels, R rows) forward: the covariance xc^T xc
    (2RC^2), 15 Newton-Schulz iterations of 3 C x C products (90C^3), the
    fold Gamma W (2C^3), the bias mean M^T (2C^2) and the rows x M^T
    (2RC^2). Backward: both operands of the rows' product, the bias's,
    the fold's and the covariance's (8RC^2 + 4C^2 + 4C^3), and of the
    iteration every product on the path to Z_15 (Y_15 is not) with an
    operand that needs a gradient (Z_0 = I does not): 86 products.
  - A spectral-normalized layer (out, K) forward: u W twice (the power
    step and sigma = u W v; W v and the dot are matrix-vector), 4 out K;
    backward, where its weight's gradient is asked for, u^T g (2 out K).
  - A conv's backward: its input's gradient where that needs one (not
    of the images) and its weight's where asked for, each as its forward.

  ``xla`` counts as XLA's cost analysis counts the reference's program:
  a scanned Newton-Schulz loop's body once (forward 3 products, backward
  6), the moments' backward as its one analytic product (K1's VJP), and
  only the conv taps inside the input (no padding)."""
  z, res, b, ratio = m["z"], m["res"], m["batch"], m["ratio"]
  ns_fwd, ns_bwd, cov_bwd = (3, 6, 1) if xla else (3 * NS, 86, 2)

  def conv(n, cin, cout, k, size):
    return 2 * n * cout * cin * _taps(size, k, xla) ** 2

  def wc(c, r):
    return 4 * r * c * c + (2 * ns_fwd + 2) * c ** 3 + 2 * c * c

  def wc_bwd(c, r):
    return (4 + 2 * cov_bwd) * r * c * c + 4 * c * c + \
        (4 + 2 * ns_bwd) * c ** 3

  def g_pass(n, backward):
    f0 = m["g"][0]
    fwd = bwd = 2 * n * z * 16 * f0           # fc_in (backward: weight)
    c, s = f0, 4
    for f in m["g"]:
      convs = [conv(n, c, f, 3, 2 * s), conv(n, f, f, 3, 2 * s),
               conv(n, c, f, 1, 2 * s)]
      fwd += wc(c, n * s * s) + wc(f, n * 4 * s * s) + sum(convs)
      bwd += wc_bwd(c, n * s * s) + wc_bwd(f, n * 4 * s * s) + \
          2 * sum(convs)
      c, s = f, 2 * s
    out = conv(n, c, 3, 3, res)
    fwd += wc(c, n * res * res) + out
    bwd += wc_bwd(c, n * res * res) + 2 * out
    return fwd + (bwd if backward else 0)

  def d_pass(n, weights, image_grad):
    """D forward and the backward asked for: the weights' gradients (a D
    update) or the images' (the G update)."""
    filters, down = m["d"]
    f0 = filters[0]
    layers = []     # (conv flops, SN out x K, input is the image)
    layers += [(conv(n, 3, f0, 3, res), f0 * 27, True),
               (conv(n, f0, f0, 3, res), f0 * f0 * 9, False),
               (conv(n, 3, f0, 1, res // 2), f0 * 3, True)]
    c, s = f0, res // 2
    for f, d in zip(filters[1:], down[1:]):
      layers += [(conv(n, c, f, 3, s), f * c * 9, False),
                 (conv(n, f, f, 3, s), f * f * 9, False)]
      if d or c != f:
        layers.append((conv(n, c, f, 1, s), f * c, False))
      c, s = f, s // 2 if d else s
    layers.append((2 * n * c, c, False))      # fc_out, features -> 1
    total = 0
    for flops, sn, on_image in layers:
      total += flops + 4 * sn
      if weights:
        total += flops + 2 * sn
      if image_grad or not on_image:
        total += flops
    return total

  d_updates = ratio * (g_pass(b, False) + d_pass(2 * b, True, False))
  g_update = g_pass(2 * b, True) + d_pass(2 * b, False, True)
  return d_updates + g_update


def test_flop_count_matches_an_analytic_count():
  """FlopCounterMode over one tiny outer step, on the plain moments,
  equals the analytic count of its products exactly (ratio 1, tolerance
  0: both count the same products by their shapes)."""
  counted = bench.count_flops(_tiny_bench())
  want = analytic_flops(TINY)
  assert counted == want, (counted, want, counted / want)


def test_xla_conventions_explain_the_reference_count():
  """The reference's 3.764 TFLOP and the port's 4.131 count one program
  by two conventions. XLA's cost analysis counts a scan's body once and
  only the conv taps inside the input (checked here on a tiny conv and a
  tiny scan), and the reference's moments backward is one product. Under
  those conventions the analytic count of the headline comes within 2 %
  of the reference's; the rest is what XLA counts that the model does
  not (elementwise work) and what neither sees."""
  import jax
  import jax.numpy as jnp

  def xla_flops(fn, *args):
    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    return (cost[0] if isinstance(cost, list) else cost)["flops"]

  conv = lambda x, w: jax.lax.conv_general_dilated(          # noqa: E731
      x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
  got = xla_flops(conv, jnp.ones((1, 4, 4, 8)), jnp.ones((3, 3, 8, 16)))
  assert got == 2 * 8 * 16 * _taps(4, 3, True) ** 2 < 2 * 8 * 16 * 144
  scan = lambda y: jax.lax.scan(                             # noqa: E731
      lambda c, _: (c @ c, None), y, None, length=15)[0]
  assert xla_flops(scan, jnp.ones((8, 8))) < 2 * 2 * 8 ** 3
  assert analytic_flops(HEADLINE) == PORT_HEADLINE_FLOPS
  assert abs(analytic_flops(HEADLINE, xla=True) / XLA_HEADLINE_FLOPS - 1) \
      < 0.02


def test_flop_count_sees_k1s_products(monkeypatch):
  """The count is taken on the plain moments whatever the layers ask for:
  with use_kernel=True (K1's wrapper, whose products the counter cannot
  see on the card) the count is the same, and the layers keep their
  setting."""
  step_fn, state, batch, spec = _tiny_bench()
  for m in state.g.modules():
    if hasattr(m, "use_kernel"):
      m.use_kernel = True
  assert bench.count_flops((step_fn, state, batch, spec)) == \
      analytic_flops(TINY)
  assert all(m.use_kernel for m in state.g.modules()
             if hasattr(m, "use_kernel"))


def test_flop_count_is_the_same_under_either_precision():
  """Model FLOPs: under 'high' a whitening product is still one 2MNK
  product (K3 on the card, which the counter cannot see; three float32
  products of the bf16 pieces on the CPU), so the count is the one under
  'highest', and the precision set stays set."""
  with whiten.precision("high"):
    assert bench.count_flops(_tiny_bench()) == analytic_flops(TINY)
    assert whiten.get_precision() == "high"


def test_flop_count_of_remat_counts_the_recomputation():
  """Under ``remat`` the backward runs G's blocks again, and the counter
  counts those products too: hardware FLOPs, not model FLOPs. So no row
  that runs remat reports an MFU."""
  step_fn, state, batch, spec = _tiny_bench()
  state.g.cfg = dataclasses.replace(state.g.cfg, remat=True)
  assert bench.count_flops((step_fn, state, batch, spec)) > \
      analytic_flops(TINY)


def test_mfu_names_its_peak():
  cpu, gpu = torch.device("cpu"), torch.device("cuda")
  assert bench.mfu(10**12, 100.0, 320, "bfloat16", cpu)["mfu"] is None
  got = bench.mfu(10**12, 100.0, 320, "bfloat16", gpu)
  assert got["mfu"] == pytest.approx(1e12 * 100.0 / 320 / 989e12)
  assert "989" in got["peak"]
  assert "67" in bench.mfu(1, 1.0, 1, "float32", gpu)["peak"]


@pytest.fixture
def narrow(monkeypatch):
  """Every CONFIGS shape at width 8 (the same blocks, resolutions and
  classes), measured without the warm-up."""
  monkeypatch.setattr(bench, "WARMUP_STEPS", 0)
  g_presets, d_presets = t_shapes.g_presets, t_shapes.d_presets
  monkeypatch.setattr(t_shapes, "g_presets", lambda arch, res: tuple(
      8 for _ in g_presets(arch, res)))
  monkeypatch.setattr(t_shapes, "d_presets", lambda arch, res: (
      tuple(8 for _ in d_presets(arch, res)[0]), d_presets(arch, res)[1]))


def _rows(capsys, argv):
  assert bench.main(["--device", "cpu", "--steps", "1", "--repeats", "1",
                     "--batch", "2", "--f32"] + argv) == 0
  return [json.loads(l) for l in capsys.readouterr().out.splitlines()]


def test_shapes_and_acgan_reach_every_config(narrow, capsys):
  rows = _rows(capsys, ["--shapes"]) + _rows(capsys, ["--acgan"])
  reached = {r["config"] for r in rows[:6]} | {r["swing"] for r in rows[6:]}
  assert [r["config"] for r in rows[:6]] == [n for n, _ in bench.SHAPES]
  assert [r["swing"] for r in rows[6:]] == ["cfg2_r0", "acgan_r0",
                                            "cfg2_r1", "acgan_r1"]
  keys = {k for n, k in bench.SHAPES if n in reached} | {"cfg2", "acgan"}
  assert keys == set(t_shapes.CONFIGS)
  for r in rows:
    assert r["imgs_per_sec"] > 0 and r["flops_per_outer_step"] > 0
    assert r["mfu"] is None


def test_whitening_precision_flag_and_the_ablation_rows(narrow, capsys,
                                                        monkeypatch):
  """--whitening-precision sets --shapes' precision (and the record's,
  --sampling's, --scoring's) and every line names it; the
  ablation modes run the reference's: 'high' for every row but --swing's
  ns15_highest_b64, and refuse the flag."""
  rows = _rows(capsys, ["--shapes", "--only", "headline",
                        "--whitening-precision", "high"])
  assert [(r["config"], r["whitening_precision"]) for r in rows] == [
      ("cifar10_wc_resnet_headline", "high")]
  assert rows[0]["imgs_per_sec"] > 0
  monkeypatch.setattr(bench, "variant_bench", lambda **kw: None)
  monkeypatch.setattr(bench, "_row", lambda *args: {})
  rows = _rows(capsys, ["--swing"])
  assert [(r["swing"], r["whitening_precision"]) for r in rows] == [
      ("baseline_ns15_b64", "high"), ("ns15_highest_b64", "highest"),
      ("ns12_b64", "high"), ("baseline_ns15_b128", "high"),
      ("ns12_b128", "high")]
  with pytest.raises(SystemExit):
    bench.parse_args(["--swing", "--whitening-precision", "highest"])
  assert bench.parse_args([]).whitening_precision == "highest"
  assert bench.parse_args(["--shapes"]).steps == 20
  assert bench.parse_args(["--sampling"]).steps == 30
