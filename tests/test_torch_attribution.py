"""The port's traffic attribution and EWMA capacity model against the
JAX package's: `dest_histogram`, the ``[P, P]`` src -> dst-range
matrices of the mesh loader (the ring graph of the JAX package's
attribution tests, the induced-subgraph step and the fused tree epoch),
`attribution_stats` key for key, the counters' snapshot round trip and a
restore from before attribution, the GNS sketch's `range_mass` and
`register_hotness_gauges`, and `EwmaCapacityModel` with the loaders'
`capacity_retune` on one feed.  The port replays JAX's keys
(`test_torch_dist_gns.jax_key_draws`); everything is exact.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphlearn_tpu.models import TreeSAGE as FlaxTreeSAGE
from graphlearn_tpu.ops import gns as jgns
from graphlearn_tpu.parallel import DistDataset as JaxDistDataset
from graphlearn_tpu.parallel import DistNeighborLoader as JaxLoader
from graphlearn_tpu.parallel import DistNeighborSampler as JaxSampler
from graphlearn_tpu.parallel import DistSubGraphLoader as JaxSubGraphLoader
from graphlearn_tpu.parallel import exchange as jex
from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu.parallel.fused import (
    FusedDistTreeEpoch as JaxFusedDistTreeEpoch)
from graphlearn_tpu_torch.models import TreeSAGE, tree_sage_from_flax
from graphlearn_tpu_torch.ops import gns as tgns
from graphlearn_tpu_torch.parallel import (DistDataset, DistNeighborLoader,
                                           DistNeighborSampler,
                                           DistSubGraphLoader,
                                           FusedDistTreeEpoch, make_mesh)
from graphlearn_tpu_torch.parallel import exchange as tex
from graphlearn_tpu_torch.parallel.partition_book import range_owner_fn
from graphlearn_tpu_torch.telemetry import live
from test_torch_dist_gns import _clean_env, _graph, _numpy_tree, jax_key_draws
from test_torch_fused_mesh import jax_epoch_draws

N = 64


def _ring(num_parts=4):
  rows = np.concatenate([np.arange(N), np.arange(N)])
  cols = np.concatenate([(np.arange(N) + 1) % N, (np.arange(N) + 2) % N])
  feats = np.arange(N, dtype=np.float32)[:, None] * np.ones((1, 4),
                                                           np.float32)
  kw = dict(node_feat=feats, node_label=(np.arange(N) % 5).astype(np.int32),
            num_nodes=N, node_pb=(np.arange(N) % num_parts).astype(np.int32))
  return (JaxDistDataset.from_full_graph(num_parts, rows, cols, **kw),
          DistDataset.from_full_graph(num_parts, rows, cols, device='cpu',
                                      **kw))


def _ring_samplers(monkeypatch):
  _clean_env(monkeypatch)
  jds, ds = _ring()
  js = JaxSampler(jds, [2], mesh=jax_make_mesh(4), seed=0)
  ts = DistNeighborSampler(ds, [2], draws=jax_key_draws(0), device='cpu')
  seeds = jds.old2new[np.arange(16).reshape(4, 4)]
  js.sample_from_nodes(seeds)
  ts.sample_from_nodes(seeds)
  return js, ts


def test_dest_histogram_equals_jax():
  rng = np.random.default_rng(0)
  bounds = np.array([0, 16, 32, 48, 64], np.int64)
  ids = rng.integers(-1, 64, (4, 40)).astype(np.int32)
  jown = lambda v: jnp.searchsorted(jnp.asarray(bounds), v,  # noqa: E731
                                    side='right') - 1
  want = np.stack([np.asarray(jex.dest_histogram(jnp.asarray(r), jown, 4))
                   for r in ids])
  got = tex.dest_histogram(torch.from_numpy(ids),
                           range_owner_fn(torch.from_numpy(bounds)), 4)
  np.testing.assert_array_equal(got.numpy(), want)
  assert got.dtype == torch.int64


def test_ring_matrices_and_stats_equal_jax(monkeypatch):
  js, ts = _ring_samplers(monkeypatch)
  for a, b in zip(ts.attribution_matrices(), js.attribution_matrices()):
    np.testing.assert_array_equal(a, b)
  np.testing.assert_array_equal(ts.attribution_matrices()[0],
                                np.ones((4, 4), np.int64))
  jst = js.attribution_stats(tick_metrics=False)
  tst = ts.attribution_stats(tick_metrics=False)
  assert tst == jst
  assert tst['cross_partition_ids_frac'] == pytest.approx(0.75)
  # the watermarked live counters tick once by the totals
  c_l = live.counter('exchange.local_ids_total')
  c_c = live.counter('exchange.cross_ids_total')
  base = (c_l.value(), c_c.value())
  for _ in range(2):
    st = ts.attribution_stats()
  assert (c_l.value() - base[0], c_c.value() - base[1]) == (
      st['local_ids'], st['cross_ids'])


def test_snapshot_round_trip_and_pre_attribution_restore(monkeypatch):
  js, ts = _ring_samplers(monkeypatch)
  packed = ts._stats_state()
  np.testing.assert_array_equal(packed, js._stats_state())
  _, ds = _ring()
  fresh = DistNeighborSampler(ds, [2], draws=jax_key_draws(0), device='cpu')
  fresh._load_stats_state(packed)
  for a, b in zip(fresh.attribution_matrices(), ts.attribution_matrices()):
    np.testing.assert_array_equal(a, b)
  assert fresh.exchange_stats(tick_metrics=False) == \
      ts.exchange_stats(tick_metrics=False)
  fresh._load_stats_state(np.arange(13, dtype=np.int64))   # 7 + 6
  for m in fresh.attribution_matrices():
    np.testing.assert_array_equal(m, np.zeros((4, 4), np.int64))
  assert fresh.exchange_stats(tick_metrics=False)[
      'dist.frontier.offered'] == 0
  # the sampler's data-plane state carries the matrices too
  state = ts.data_plane_state()
  fresh.load_data_plane_state(state)
  np.testing.assert_array_equal(fresh.attribution_matrices()[1],
                                ts.attribution_matrices()[1])
  fresh.load_data_plane_state({'step_cnt': 0})
  assert fresh.attribution_matrices()[1].sum() == 0


def test_subgraph_step_matrices_equal_jax(monkeypatch):
  _clean_env(monkeypatch)
  jds, ds = _ring()
  seeds = np.arange(N)
  jl = JaxSubGraphLoader(jds, [2], seeds, batch_size=4, mesh=jax_make_mesh(4))
  tl = DistSubGraphLoader(ds, [2], seeds, batch_size=4,
                          draws=jax_key_draws(0), device='cpu')
  for _ in itertools.islice(zip(jl, tl), 2):
    pass
  for a, b in zip(tl.sampler.attribution_matrices(),
                  jl.sampler.attribution_matrices()):
    np.testing.assert_array_equal(a, b)
    assert a.sum() > 0


def test_fused_tree_matrices_equal_jax(monkeypatch):
  _clean_env(monkeypatch)
  n, bs = 96, 8
  rows, cols, feats, labels = _graph(n)
  kw = dict(node_feat=feats, node_label=labels, num_nodes=n)
  jds = JaxDistDataset.from_full_graph(4, rows, cols, **kw)
  ds = DistDataset.from_full_graph(4, rows, cols, device='cpu', **kw)
  jf = JaxFusedDistTreeEpoch(
      jds, [3, 2], np.arange(n),
      FlaxTreeSAGE(hidden_features=8, out_features=5, num_layers=2),
      optax.adam(1e-3), batch_size=bs, mesh=jax_make_mesh(4), seed=0)
  jstate = jf.init_state(jax.random.key(0))
  model = TreeSAGE(feats.shape[1], 8, 5, num_layers=2)
  model.load_state_dict(tree_sage_from_flax(_numpy_tree(jstate.params)))
  tf = FusedDistTreeEpoch(ds, [3, 2], np.arange(n), model,
                          torch.optim.Adam(model.parameters(), lr=1e-3),
                          batch_size=bs, seed=0, draws=jax_epoch_draws(0),
                          device='cpu')
  jf.run(jstate)
  tf.run()
  for a, b in zip(tf.sampler.attribution_matrices(),
                  jf.sampler.attribution_matrices()):
    np.testing.assert_array_equal(a, b)
    assert a.sum() - np.trace(a) > 0


def test_range_mass_and_hotness_gauges_equal_jax():
  bounds = np.array([0, 16, 32, 48, 64], np.int64)
  rng = np.random.default_rng(3)
  js = jgns.DecayedSketch(slots=64, decay=0.5, bounds=bounds)
  ts = tgns.DecayedSketch(slots=64, decay=0.5, bounds=bounds)
  for _ in range(4):
    ids = rng.integers(-1, 64, 20)
    js.update(ids)
    ts.update(ids)
  np.testing.assert_array_equal(ts.range_mass, js.range_mass)
  np.testing.assert_array_equal(ts.scores, js.scores)
  assert ts.hot_ranges(2) == js.hot_ranges(2)
  st = ts.state_dict()
  assert set(st) == set(js.state_dict())
  back = tgns.DecayedSketch(slots=64, decay=0.5, bounds=bounds)
  back.load_state_dict(st)
  np.testing.assert_array_equal(back.range_mass, ts.range_mass)
  del st['range_mass']
  back.load_state_dict(st)                       # an older state restores
  assert tgns.DecayedSketch(slots=8).range_mass is None

  class Reg:
    def __init__(self):
      self.fns = {}

    def gauge(self, name, labels=None, fn=None):
      self.fns[(name, labels['partition'])] = fn

  jr, tr = Reg(), Reg()
  jgns.register_hotness_gauges(lambda: [js], 4, registry=jr)
  tgns.register_hotness_gauges(lambda: [ts], 4, registry=tr)
  assert set(jr.fns) == set(tr.fns) and len(tr.fns) == 4
  assert {k: f() for k, f in tr.fns.items()} == \
      {k: f() for k, f in jr.fns.items()}
  assert sum(f() is not None for f in tr.fns.values()) == 1     # K = 1


def test_ewma_model_equals_jax():
  rng = np.random.default_rng(1)
  jm = jex.EwmaCapacityModel(8, alpha=0.5, headroom=1.3)
  tm = tex.EwmaCapacityModel(8, alpha=0.5, headroom=1.3)
  for steps in (3, 0, 5, 2):
    for ch in ('frontier', 'feature'):
      m = rng.integers(0, 50, (8, 8))
      assert tm.observe(ch, m, steps) == jm.observe(ch, m, steps)
      assert tm.caps(ch) == jm.caps(ch)
  assert tm.state_dict() == jm.state_dict()
  back = tex.EwmaCapacityModel(8, alpha=0.5, headroom=1.3)
  back.load_state_dict(tm.state_dict())
  assert {c: back.caps(c) for c in back.CHANNELS} == \
      {c: tm.caps(c) for c in tm.CHANNELS}
  assert tex.EwmaCapacityModel(4).caps('frontier') == (None, None)
  for x in (0.2, 1, 3, 64, 65, 1000.5):
    assert tex._quantize_pow2(x) == jex._quantize_pow2(x)


def test_capacity_retune_takes_jax_decisions(monkeypatch):
  """Under ``GLT_EXCHANGE_EWMA=1`` both loaders feed their model at each
  epoch end and size the next epoch from its caps: the same caps, the
  same batches and counters, epoch after epoch."""
  _clean_env(monkeypatch)
  monkeypatch.setenv('GLT_EXCHANGE_EWMA', '1')
  n = 256
  rows, cols, feats, _ = _graph(n)
  kw = dict(node_feat=feats, num_nodes=n)
  jds = JaxDistDataset.from_full_graph(4, rows, cols, **kw)
  ds = DistDataset.from_full_graph(4, rows, cols, device='cpu', **kw)
  lkw = dict(batch_size=16, shuffle=True, seed=0, exchange_slack=1.25)
  jl = JaxLoader(jds, [3, 2], np.arange(n), mesh=jax_make_mesh(4), **lkw)
  tl = DistNeighborLoader(ds, [3, 2], np.arange(n), draws=jax_key_draws(0),
                          device='cpu', **lkw)
  caps = []
  for _ in range(3):
    for jb, tb in zip(jl, tl):
      for f in ('node', 'x', 'edge_index'):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)))
    assert tl.sampler._ewma_caps() == jl.sampler._ewma_caps()
    caps.append(tl.sampler._ewma_caps())
  assert caps[0] is None and caps[1] is not None
  keys = [k for k in jl.sampler.exchange_stats(tick_metrics=False)
          if k.startswith(('dist.frontier.', 'dist.feature.'))
          and k != 'dist.feature.cold_hit_rate']
  js = jl.sampler.exchange_stats(tick_metrics=False)
  ts = tl.sampler.exchange_stats(tick_metrics=False)
  assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
  assert tl.sampler.capacity_retune() == jl.sampler.capacity_retune()
