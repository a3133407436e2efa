"""The compiled programs of the trainer and the scorer (``compiled.Program``)
on the CPU, where each call after the warm-up runs the program's eager
body on its static buffers; their CUDA graphs are held in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s sample-graph phase.

- ``sample``, ``sample_u8`` and ``generate`` after their warm-up against
  the JAX Trainer's ``_sample``, ``_sample_u8`` and ``generate``, with
  ``test_torch_sampling.py``'s tolerances (float images 1e-4, uint8
  images equal but at rounding edges);
- the standing pass after its warm-up against JAX's ``standing_g_state``,
  with ``test_torch_trainer.py``'s 1e-4;
- after a step call, a restore and each rung of the fallback ladder,
  ``sample`` equals a fresh eager ``functional_call`` on
  ``sampling_state()`` bit for bit (a restore and a rung invalidate the
  graphs), and successive outputs do not alias;
- a replayed G update moves ``g_version`` and no tensor's version:
  ``sampling_state()`` recomputes, into the tensors the graphs read;
- the scorer's compiled network forward on a padded tail gives the rows
  of the unpadded batch (1e-5 of each output's largest value: another
  batch size may sum in another order), with a small network of
  InceptionV3's per-image kinds of op in its place.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from test_torch_jit_step import _trainer
from test_torch_sampling import _assert_u8_close, trainers  # noqa: F401
from test_torch_trainer import ema_pair  # noqa: F401
from wcgan_tpu_torch import weights
from wcgan_tpu_torch.evaluation import scorer as t_scorer

CPU = torch.device("cpu")


def _program(tt, kind, rows=None):
  """The trainer's program of ``kind`` (the one at a z of ``rows``)."""
  (program,) = [p for (k, signature), p in tt._programs.items()
                if k == kind and rows in (None, signature[0][0][0])]
  return program


def test_compiled_sampling_matches_jax(trainers):  # noqa: F811
  jt, tt = trainers
  z, labels = jt.ds.test_batch(8)
  img_j = np.asarray(jt._sample(jt.sampling_state(), jnp.asarray(z),
                                jnp.asarray(labels)))
  u8_j = np.asarray(jt._sample_u8(jt.sampling_state(), jnp.asarray(z),
                                  jnp.asarray(labels)))
  for _ in range(2):
    img_t, u8_t = tt.sample(z), tt.sample_u8(z)
  for kind in ("sample", "sample_u8"):
    assert _program(tt, kind, 8).calls == {"warm-up": 1, "capture": 0,
                                           "replay": 0, "eager": 1}, kind
  np.testing.assert_allclose(img_t.numpy(), img_j, atol=1e-4)
  _assert_u8_close(u8_t.numpy(), u8_j, img_j)
  got_t = tt.generate(10, batch=4, rng_seed=7)
  assert _program(tt, "sample_u8", 4).calls["eager"] == 2
  got_j = jt.generate(10, batch=4, rng_seed=7)
  rng = np.random.default_rng(7)
  zz = np.concatenate([rng.standard_normal((4, 16)).astype(np.float32)
                       for _ in range(3)])[:10]
  _assert_u8_close(got_t, got_j, tt.sample(zz).numpy())


def test_compiled_standing_pass_matches_jax(ema_pair):  # noqa: F811
  jt, tt = ema_pair
  stats = jt.standing_g_state(jt.state.g_ema, n_batches=3)["wc_stats"]
  want = weights.state_dict_from_jax({}, {"wc_stats": _np_tree(stats)})
  got = tt.standing_g_state(tt.state.g_ema, n_batches=3)
  assert _program(tt, "standing_pass").calls == {
      "warm-up": 1, "capture": 0, "replay": 0, "eager": 2}
  for k in want:
    np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4,
                               atol=1e-4, err_msg=k)


def _np_tree(tree):
  if isinstance(tree, dict):
    return {k: _np_tree(v) for k, v in tree.items()}
  return np.asarray(tree)


def test_no_stale_graph_after_a_step_a_restore_and_each_rung(tmp_path):
  """EMA sampling with standing statistics, on every surface's program:
  the images of two calls after each event equal a fresh eager forward,
  and each call's images are new tensors."""
  tt = _trainer(tmp_path, "--generator_ema", "0.5", "--ema_standing_stats",
                "2", "--d_fake_stats", "running", "--generator_block_norm",
                "dr", "--generator_last_norm", "dr", "--wc_residual_action",
                "fallback")
  z = torch.from_numpy(np.random.default_rng(0).standard_normal(
      (4, 16)).astype(np.float32))

  def fresh():
    with torch.no_grad():
      return functional_call(tt.state.g, tt.sampling_state(), (z, None),
                             {"train": False}).permute(0, 2, 3, 1)

  def sample_twice(first):
    outs = [tt.sample(z) for _ in range(2)]
    assert _program(tt, "sample").last == "eager"
    assert _program(tt, "sample").calls[first] >= 1
    kept = outs[0].clone()
    assert outs[0].data_ptr() != outs[1].data_ptr()
    assert torch.equal(outs[0], kept)
    for out in outs:
      assert torch.equal(out, fresh())
    return outs[1]

  before = sample_twice("warm-up")
  tt.step_fn(tt.state, *tt._device_data)
  calls = dict(_program(tt, "sample").calls)
  after = sample_twice("eager")
  assert _program(tt, "sample").calls["warm-up"] == calls["warm-up"]
  assert not torch.equal(before, after)
  tt.save_checkpoint(0)
  tt.step_fn(tt.state, *tt._device_data)
  tt.restore_checkpoint(tt.checkpoint_path(0))
  assert torch.equal(tt.sample(z), after)
  assert _program(tt, "sample").last == "warm-up"
  sample_twice("warm-up")
  for rung in range(3):
    warm = _program(tt, "sample").calls["warm-up"]
    assert tt._apply_whitening_fallback(rung)
    sample_twice("warm-up")
    assert _program(tt, "sample").calls["warm-up"] == warm + 1, rung
  assert tt.state.g.cfg.block_norm == "d" and tt.state.g.cfg.ns_iters == 12


def test_a_replayed_update_recomputes_into_the_same_tensors(tmp_path):
  """A replayed G update moves the EMA shadow and G's statistics in place
  without a version, and ``state.g_version`` (a replay adds it): the
  cache recomputes on ``g_version`` alone, and the standing statistics go
  into the tensors the sampling graphs are bound to."""
  tt = _trainer(tmp_path, "--generator_ema", "0.5", "--ema_standing_stats",
                "2")
  first = tt.sampling_state()
  live = {id(t) for t in tt.state.g.buffers()}
  standing = {k: t for k, t in first.items()
              if k not in tt.state.g_ema and id(t) not in live}
  assert standing
  old = {k: t.clone() for k, t in standing.items()}
  with torch.no_grad():
    for t in tt.state.g_ema.values():
      t.mul_(0.9)
  assert tt.sampling_state() is first
  tt.state.g_version += 1
  again = tt.sampling_state()
  assert again is not first
  want = tt.standing_g_state(tt.state.g_ema, 2)
  for k, t in standing.items():
    assert again[k] is t, k
    assert torch.equal(t, want[k]), k
  assert any(not torch.equal(t, old[k]) for k, t in standing.items())


class SmallNet(torch.nn.Module):
  """A strided convolution, an eval-mode BatchNorm, a pool and a dense
  head: InceptionV3's per-image kinds of op at a sliver of its cost."""

  def __init__(self):
    super().__init__()
    self.conv = torch.nn.Conv2d(3, 8, 5, stride=8)
    self.bn = torch.nn.BatchNorm2d(8)
    self.fc = torch.nn.Linear(8, 5)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
      for t in [*self.parameters(), self.bn.running_mean]:
        t.copy_(0.3 * torch.randn(t.shape, generator=gen))
      self.bn.running_var.uniform_(0.5, 2.0, generator=gen)

  def forward(self, x):
    pool = torch.relu(self.bn(self.conv(x))).mean(dim=(2, 3))
    return pool, self.fc(pool)


def test_scorer_padded_tail_gives_the_unpadded_rows(monkeypatch):
  """The scorer's compiled network forward on 6 images: batches of 4 (the
  tail of 2 padded to 4, then sliced) against one batch of 6."""
  monkeypatch.setattr(t_scorer.inception_v3, "init_params", SmallNet)
  rng = np.random.default_rng(3)
  imgs = rng.integers(0, 256, (6, 16, 16, 3)).astype(np.uint8)
  real = t_scorer._activations
  seen = []

  class Stop(Exception):
    pass

  def spy(apply_fn, *args, **kw):
    seen.append(apply_fn)
    raise Stop

  monkeypatch.setattr(t_scorer, "_activations", spy)
  scorer = t_scorer.make_scorer(None, compute_fid=False,
                                samples_inception=6, batch=4)
  with pytest.raises(Stop):
    scorer(types.SimpleNamespace(device=CPU, generate=lambda n: imgs))
  (apply_fn,) = seen
  sizes = []
  counted = lambda x: sizes.append(x.shape[0]) or apply_fn(x)  # noqa: E731
  padded = real(counted, imgs, 4, CPU)
  assert sizes == [4, 4]
  whole = real(counted, imgs, 8, CPU)
  assert sizes == [4, 4, 6]
  for got, want in zip(padded, whole):
    assert got.shape == want.shape and got.shape[0] == 6
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
