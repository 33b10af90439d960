"""The port's locality partitioner, replica cache and online rebalance
against the JAX package's `parallel/locality.py` and
`DistDataset.from_full_graph(partitioner=, replica_frac=)`, on the
graphs of the JAX package's locality tests (N = 200, P = 8).

`locality_partition` must give JAX's ``node_pb`` and stats byte for byte
(its greedy is a host loop, ported decision for decision); the replica
cache JAX's ids and rows; the locality and replica-armed loaders JAX's
batches and attribution; `rebalance_plan` JAX's plan wherever JAX's book
accepts it.  The JAX planner can send a later move to a position whose
own range an earlier move of the same plan took away (its book refuses
that cutover); the port's planner skips such a destination, and the
mid-epoch rebalance holds the contract of the JAX package's test: the
epoch byte-identical to the undisturbed one, one book bump a move, no
adoption, a lower cross-partition fraction.
"""
import numpy as np
import pytest
import torch

from graphlearn_tpu.parallel import DistDataset as JaxDistDataset
from graphlearn_tpu.parallel import DistNeighborLoader as JaxLoader
from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu.parallel import locality as jloc
from graphlearn_tpu.parallel.dist_data import (
    build_replica_cache as jax_build_replica_cache)
from graphlearn_tpu.parallel.dist_hetero import (
    DistHeteroDataset as JaxHeteroDataset)
from graphlearn_tpu_torch.parallel import (DistDataset, DistHeteroDataset,
                                           DistHeteroNeighborSampler,
                                           DistNeighborLoader, ShardStore)
from graphlearn_tpu_torch.parallel import locality as tloc
from graphlearn_tpu_torch.parallel.dist_data import build_replica_cache
from test_torch_dist_gns import _clean_env, jax_key_draws

P = 8
N, E = 200, 1200
C = N // P


def _community_edges(seed=0, intra=0.85):
  rng = np.random.default_rng(seed)
  rows = rng.integers(0, N, E)
  within = (rows // C) * C + rng.integers(0, C, E)
  anywhere = rng.integers(0, N, E)
  return rows, np.where(rng.random(E) < intra, within, anywhere)


def _hub_edges(seed=0, hubs=20, frac=0.5):
  rng = np.random.default_rng(seed)
  rows = rng.integers(0, N, E)
  return rows, np.where(rng.random(E) < frac, rng.integers(0, hubs, E),
                        rng.integers(0, N, E))


def _feat():
  return (np.arange(N)[:, None] + np.zeros((1, 6))).astype(np.float32)


def _loader(ds, seeds=None, jax_mesh=False, **kw):
  kw = dict(dict(batch_size=4, shuffle=True, seed=0, exchange_slack=1.5),
            **kw)
  seeds = np.arange(ds.graph.bounds[-1]) if seeds is None else seeds
  if jax_mesh:
    return JaxLoader(ds, [3, 2], seeds, mesh=jax_make_mesh(P), **kw)
  return DistNeighborLoader(ds, [3, 2], seeds, draws=jax_key_draws(0),
                            device='cpu', **kw)


def _batches(loader):
  return [{f: np.asarray(getattr(b, f)) for f in
           ('node', 'x', 'edge_index', 'batch')} for b in loader]


def _assert_equal(ref, got, what):
  assert len(ref) == len(got), what
  for i, (a, b) in enumerate(zip(ref, got)):
    for f in a:
      np.testing.assert_array_equal(b[f], a[f], err_msg=f'{what} {i} {f}')


@pytest.mark.parametrize('seed', [0, 7])
@pytest.mark.parametrize('eps', [0.05, 0.2])
@pytest.mark.parametrize('passes', [0, 1])
def test_locality_partition_equals_jax(seed, eps, passes):
  rows, cols = _community_edges(seed)
  hot = np.bincount(cols, minlength=N)
  for hotness in (None, hot):
    want, wst = jloc.locality_partition(rows, cols, N, P, seed=seed,
                                        hotness=hotness, balance_eps=eps,
                                        passes=passes)
    got, st = tloc.locality_partition(rows, cols, N, P, seed=seed,
                                      hotness=hotness, balance_eps=eps,
                                      passes=passes)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and st == wst
  assert tloc.edge_cut_frac(rows, cols, got) == \
      jloc.edge_cut_frac(rows, cols, want)


def test_partitioner_resolution_equals_jax(monkeypatch):
  _clean_env(monkeypatch)
  assert tloc.resolve_partitioner() == jloc.resolve_partitioner() == 'range'
  monkeypatch.setenv('GLT_PARTITIONER', 'locality')
  assert tloc.resolve_partitioner() == 'locality'
  with pytest.raises(ValueError, match='fennel'):
    tloc.resolve_partitioner('fennel')
  rows, cols = _community_edges()
  ds = DistDataset.from_full_graph(P, rows, cols, _feat(), num_nodes=N,
                                   device='cpu')
  jds = JaxDistDataset.from_full_graph(P, rows, cols, _feat(), num_nodes=N)
  assert ds.partitioner == jds.partitioner == 'locality'
  np.testing.assert_array_equal(ds.old2new, jds.old2new)
  monkeypatch.delenv('GLT_PARTITIONER')
  ds = DistDataset.from_full_graph(P, rows, cols, _feat(), num_nodes=N,
                                   device='cpu')
  assert ds.partitioner == 'range'


def test_replica_cache_equals_jax():
  rows, cols = _hub_edges()
  feat = _feat()
  jds = JaxDistDataset.from_full_graph(P, rows, cols, feat, num_nodes=N,
                                       partitioner='locality',
                                       replica_frac=0.1)
  ds = DistDataset.from_full_graph(P, rows, cols, feat, num_nodes=N,
                                   partitioner='locality', replica_frac=0.1,
                                   device='cpu')
  np.testing.assert_array_equal(ds.node_features.cache_ids.numpy(),
                                jds.node_features.cache_ids)
  np.testing.assert_array_equal(ds.node_features.cache_rows.numpy(),
                                jds.node_features.cache_rows)
  assert ds.node_features.cache_local and jds.node_features.cache_local
  # the builder alone, on a hotness with ties
  hot = np.bincount(ds.old2new[cols], minlength=N) // 3
  ids, rws = build_replica_cache(feat, ds.old2new, ds.graph.bounds, hot,
                                 0.07, device='cpu')
  feats_new = np.empty_like(feat)
  feats_new[ds.old2new] = feat
  jids, jrows = jax_build_replica_cache(feats_new, ds.graph.bounds, hot, 0.07)
  np.testing.assert_array_equal(ids.numpy(), jids)
  np.testing.assert_array_equal(rws.numpy(), jrows)


def test_zero_budget_builds_no_cache():
  rows, cols = _community_edges()
  ds = DistDataset.from_full_graph(P, rows, cols, _feat(), num_nodes=N,
                                   partitioner='locality', replica_frac=0.0,
                                   device='cpu')
  assert ds.node_features.cache_ids is None
  assert not ds.node_features.cache_local and not ds.node_features.has_cache


def test_replica_rows_exact_and_off_wire(monkeypatch):
  """The replica-armed loader gives the cache-less twin's batches and
  JAX's, with lookups kept off the wire (`locally_served_ids`) and a
  lower cross fraction; the attribution equals JAX's key for key."""
  _clean_env(monkeypatch)
  rows, cols = _hub_edges()
  feat = _feat()

  def build(frac, cls=DistDataset, **kw):
    return cls.from_full_graph(P, rows, cols, feat, num_nodes=N,
                               partitioner='locality', replica_frac=frac,
                               **kw)
  l0 = _loader(build(0.0, device='cpu'))
  l1 = _loader(build(0.1, device='cpu'))
  j1 = _loader(build(0.1, JaxDistDataset), jax_mesh=True)
  ref = _batches(l0)
  got = _batches(l1)
  _assert_equal(ref, got, 'replica overlay')
  _assert_equal(_batches(j1), got, 'replica vs JAX')
  assert l1.sampler.cache_local and l1.sampler.replica_hits() > 0
  a0 = l0.sampler.attribution_stats(tick_metrics=False)
  a1 = l1.sampler.attribution_stats(tick_metrics=False)
  assert a1['locally_served_ids'] > 0 == a0['locally_served_ids']
  assert a1['cross_partition_bytes_frac'] < a0['cross_partition_bytes_frac']
  assert a1 == j1.sampler.attribution_stats(tick_metrics=False)
  st = l1.sampler.exchange_stats(tick_metrics=False)
  jst = j1.sampler.exchange_stats(tick_metrics=False)
  for k in ('dist.feature.offered', 'dist.feature.dropped',
            'dist.feature.slots', 'dist.frontier.offered'):
    assert st[k] == jst[k], k


def test_locality_and_rename_twin_equal_jax(monkeypatch):
  """The locality arm's batches equal JAX's, and its twin — the same
  placement replayed as an explicit ``node_pb`` over the relabelled
  edges — relabels to the identity and gives the same batches."""
  _clean_env(monkeypatch)
  rows, cols = _community_edges()
  feat = _feat()
  kw = dict(num_nodes=N, partitioner='locality', replica_frac=0.1)
  jds = JaxDistDataset.from_full_graph(P, rows, cols, feat, **kw)
  ds = DistDataset.from_full_graph(P, rows, cols, feat, device='cpu', **kw)
  ref = _batches(_loader(ds))
  _assert_equal(_batches(_loader(jds, jax_mesh=True)), ref, 'locality')
  o2n, n2o = ds.old2new, ds.new2old
  pb_new = (np.searchsorted(ds.graph.bounds, np.arange(N), 'right')
            - 1).astype(np.int32)
  twin = DistDataset.from_full_graph(
      P, o2n[rows], o2n[cols], node_feat=feat[n2o], num_nodes=N,
      node_pb=pb_new, replica_frac=0.1,
      hotness=np.bincount(o2n[cols], minlength=N), device='cpu')
  np.testing.assert_array_equal(twin.old2new, np.arange(N))
  assert twin.partitioner == 'explicit'
  _assert_equal(ref, _batches(_loader(twin, seeds=o2n[np.arange(N)])),
                'rename twin')


def _plan_fields(plan):
  return [(m['range'], m['frm'], m['to'], m['demand']) for m in plan]


def test_rebalance_plan_equals_jax_on_single_moves():
  m = np.ones((P, P))
  m[:, 3] = 40.0
  m[5, 3] = 90.0
  att = {'bytes_matrix': m}
  for kw in ({}, {'max_moves': 1}, {'max_moves': 0},
             {'overload_factor': 50.0}):
    got = tloc.rebalance_plan(att, **kw)
    assert _plan_fields(got) == _plan_fields(jloc.rebalance_plan(att, **kw))
  assert _plan_fields(tloc.rebalance_plan(att))[0] == (3, 3, 5, m[:, 3].sum())
  assert tloc.rebalance_plan({'bytes_matrix': None}) == []
  assert tloc.rebalance_plan({}) == []

  class Flat:
    range_mass = np.ones(P)

  class Skewed:
    range_mass = np.r_[np.ones(3), 50.0, np.ones(P - 4)]

  m2 = np.ones((P, P))
  m2[:, 3] = 40.0
  for sk in (Flat(), Skewed()):
    assert _plan_fields(tloc.rebalance_plan({'bytes_matrix': m2}, sk)) == \
        _plan_fields(jloc.rebalance_plan({'bytes_matrix': m2}, sk))
  assert tloc.rebalance_plan({'bytes_matrix': m2}, Skewed())[0][
      'demand'] == 50.0


def test_mid_epoch_rebalance_holds_the_contract(monkeypatch, tmp_path):
  _clean_env(monkeypatch)
  rows, cols = _hub_edges()
  feat = _feat()
  pb = (np.arange(N) % P).astype(np.int32)
  pb[:20] = 3                        # every hub on partition 3

  def build():
    return DistDataset.from_full_graph(P, rows, cols, feat, num_nodes=N,
                                       node_pb=pb, device='cpu')
  ref = _batches(_loader(build()))
  ds = build()
  loader = _loader(ds)
  it = iter(loader)
  got = [next(it) for _ in range(3)]
  att = loader.sampler.attribution_stats(tick_metrics=False)
  plan = tloc.rebalance_plan(att, book=ds.partition_book)
  jplan = jloc.rebalance_plan(att, book=ds.partition_book)
  assert plan and plan[0]['range'] == 3
  # the JAX plan's later move to a position whose range moved earlier is
  # the one its book refuses; the port skips that destination and agrees
  # with JAX's plan on every move before it
  assert all(m['to'] not in {e['range'] for e in plan[:i]}
             for i, m in enumerate(plan))
  jmoved, cut = set(), len(jplan)
  for i, m in enumerate(jplan):
    if m['to'] in jmoved:
      cut = i
      break
    jmoved.add(m['range'])
  assert cut < len(jplan), 'the JAX plan no longer shows the refused move'
  assert _plan_fields(plan[:cut]) == _plan_fields(jplan[:cut])
  infos = tloc.execute_rebalance(ds, plan, store=ShardStore(tmp_path / 's'))
  got.extend(it)
  _assert_equal(ref, [{f: np.asarray(getattr(b, f)) for f in
                       ('node', 'x', 'edge_index', 'batch')} for b in got],
                'mid-epoch rebalance')
  book = ds.partition_book
  assert len(infos) == len(plan) == book.version
  assert int(book.view().owners[3]) == plan[0]['to']
  assert book.transfers()[0]['range'] == 3 and book.adoptions() == []
  att2 = loader.sampler.attribution_stats(tick_metrics=False)
  assert att2['cross_partition_bytes_frac'] < att['cross_partition_bytes_frac']


def test_hetero_locality_equals_jax(monkeypatch):
  _clean_env(monkeypatch)
  nu, ni, parts = 32, 16, 4
  urow = np.repeat(np.arange(nu), 2)
  icol = np.stack([np.arange(nu) % ni, (np.arange(nu) + 1) % ni],
                  1).reshape(-1)
  ets = {('user', 'clicks', 'item'): (urow, icol),
         ('item', 'rev_clicks', 'user'): (icol, urow)}
  feats = {'user': np.tile(np.arange(nu, dtype=np.float32)[:, None], (1, 4)),
           'item': np.tile(np.arange(ni, dtype=np.float32)[:, None], (1, 4))}
  kw = dict(node_feat_dict=feats, num_nodes_dict={'user': nu, 'item': ni},
            partitioner='locality')
  jds = JaxHeteroDataset.from_full_graph(parts, ets, **kw)
  ds = DistHeteroDataset.from_full_graph(parts, ets, device='cpu', **kw)
  for nt in ('user', 'item'):
    np.testing.assert_array_equal(ds.old2new[nt], jds.old2new[nt])
    np.testing.assert_array_equal(ds.bounds[nt], jds.bounds[nt])
  union = np.diff(ds.bounds['user']) + np.diff(ds.bounds['item'])
  assert union.max() <= int(np.ceil(1.05 * (nu + ni) / parts))
  sampler = DistHeteroNeighborSampler(ds, [2, 2], seed=0, device='cpu')
  out = sampler.sample_from_nodes(
      'user', ds.old2new['user'][np.arange(nu).reshape(parts, -1)])
  inodes = out['node']['item'].numpy()
  assert (inodes >= 0).any()
  assert (ds.new2old['item'][inodes[inodes >= 0]] < ni).all()
