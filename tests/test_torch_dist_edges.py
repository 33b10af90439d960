"""The mesh's sampled edges in the port against the JAX package at P = 4
(the port on the CPU, the JAX side on four devices of the virtual CPU
mesh): `build_dist_edge_feature` and `DistDataset.from_full_graph(
edge_feat=)`, mod ownership, `dist_gather_multi(shard_mode='mod')`, and
`DistNeighborLoader(with_edge=True)` untiered (the uniform kernel's
edge-id arm) and tiered with GNS at both dispatch orders (the GNS
kernel's edge-id arm).

The port's loader replays the JAX loader's keys (`test_torch_dist_gns.
jax_key_draws`).  Edge-feature rows encode ``(edge id, source, target)``
in the input id space, so every gathered row is also checked against its
edge arithmetically.  Tolerance: none — batches (``edge``, ``edge_attr``,
``edge_weight`` included) and exchange counters byte-equal / exact.
"""
import itertools

import numpy as np
import pytest
import torch

from graphlearn_tpu.parallel import DistDataset as JaxDistDataset
from graphlearn_tpu.parallel import DistNeighborLoader as JaxLoader
from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu.parallel import partition_book as jpb
from graphlearn_tpu.parallel.dist_data import \
    build_dist_edge_feature as jax_build_edge
from graphlearn_tpu_torch.parallel import (DistDataset, DistNeighborLoader,
                                           build_dist_edge_feature,
                                           dist_gather_multi, make_mesh)
from graphlearn_tpu_torch.parallel import partition_book as pb
from test_torch_dist_gns import _clean_env, _graph, jax_key_draws

P = 4
N = 320
FANOUTS = [3, 2]
BATCH = 8
BATCHES = 4
FIELDS = ('node', 'x', 'y', 'edge_index', 'edge_mask', 'edge', 'edge_attr',
          'num_sampled_nodes')


def _edge_graph(n=N, seed=0):
  rows, cols, feats, labels = _graph(n, seed=seed)
  efeat = np.stack([np.arange(len(rows)), rows, cols], 1).astype(np.float32)
  return rows, cols, feats, labels, efeat


def _datasets(split, n=N):
  rows, cols, feats, labels, efeat = _edge_graph(n)
  kw = dict(node_feat=feats, node_label=labels, num_nodes=n,
            split_ratio=split, edge_feat=efeat)
  return (JaxDistDataset.from_full_graph(P, rows, cols, **kw),
          DistDataset.from_full_graph(P, rows, cols, device='cpu', **kw),
          rows, cols)


@pytest.mark.parametrize('dim', [3, 1])
def test_build_dist_edge_feature_matches_jax(dim):
  rows, cols, _, _, efeat = _edge_graph()
  table = efeat[:, :dim] if dim > 1 else efeat[:, 0]
  ref = jax_build_edge(table, P)
  got = build_dist_edge_feature(table, P, device='cpu')
  assert got.mod_sharded and ref.mod_sharded and not got.is_tiered
  assert got.shards.dtype == torch.float32
  np.testing.assert_array_equal(got.shards.numpy(), ref.shards)
  np.testing.assert_array_equal(got.bounds, ref.bounds)
  np.testing.assert_array_equal(got.hot_counts, ref.hot_counts)
  # the torch form of the table gives the same shards
  again = build_dist_edge_feature(torch.from_numpy(table), P, device='cpu')
  assert torch.equal(again.shards, got.shards)


def test_dataset_edge_features_match_jax_and_share():
  jds, ds, rows, cols = _datasets(0.3)
  ef, jef = ds.edge_features, jds.edge_features
  np.testing.assert_array_equal(ef.shards.numpy(), jef.shards)
  assert ef.mod_sharded == jef.mod_sharded is True
  np.testing.assert_array_equal(ds.graph.edge_ids.numpy(),
                                jds.graph.edge_ids)
  # a built table is shared, not rebuilt; a range-owned one is refused
  rows_, cols_, feats, _, _ = _edge_graph()
  other = DistDataset.from_full_graph(P, rows_, cols_, node_feat=feats,
                                      num_nodes=N, edge_feat=ef,
                                      device='cpu')
  assert other.edge_features is ef
  with pytest.raises(ValueError, match='mod-sharded'):
    DistDataset.from_full_graph(P, rows_, cols_, num_nodes=N,
                                edge_feat=ds.node_features, device='cpu')
  assert DistDataset.from_full_graph(P, rows_, cols_, num_nodes=N,
                                     device='cpu').edge_features is None


def test_mod_ownership_matches_jax():
  ids = np.array([-1, 0, 1, 2, 3, 4, 7, 8, 1001, 2 ** 30], np.int64)
  valid = ids >= 0
  t = torch.from_numpy(ids[valid])
  np.testing.assert_array_equal(pb.edge_owner_fn(P)(t).numpy(),
                                jpb.edge_owner_host(ids[valid], P))
  np.testing.assert_array_equal(pb.edge_local_rows(t, P).numpy(),
                                jpb.edge_local_rows_host(ids[valid], P))


@pytest.mark.parametrize('capacity', [None, 8])
def test_mod_gather_returns_each_edges_row(capacity):
  """`dist_gather_multi(shard_mode='mod')`: every delivered id's row is
  its edge's; invalid ids and, at a small capacity, the ids past an
  owner's share come back zero and count as dropped."""
  efeat = _edge_graph()[4] + 1                # no row is all zero
  ef = build_dist_edge_feature(efeat, P, device='cpu')
  rng = np.random.default_rng(3)
  ids = rng.integers(-1, len(efeat), (P, 40)).astype(np.int32)
  ids[0, :20] = 4 * np.arange(20)          # one owner's run
  (got,), stats = dist_gather_multi(make_mesh(P, device='cpu'),
                                    (ef.shards,), ef.bounds,
                                    torch.from_numpy(ids), capacity=capacity,
                                    shard_mode='mod')
  got = got.numpy()
  ok = np.abs(got).sum(-1) > 0
  valid = ids >= 0
  np.testing.assert_array_equal(got[ok], efeat[ids[ok]])
  assert not ok[~valid].any()
  offered, dropped, slots = (int(v) for v in stats)
  assert offered == int(valid.sum())
  assert dropped == int((valid & ~ok).sum())
  assert (dropped > 0) == (capacity is not None)
  assert slots == P * P * (40 if capacity is None else capacity)


def _np(b):
  out = {f: np.asarray(getattr(b, f)) for f in FIELDS}
  ew = b.metadata.get('edge_weight')
  out['edge_weight'] = None if ew is None else np.asarray(ew)
  return out


def _port(b):
  out = {f: getattr(b, f).numpy() for f in FIELDS}
  ew = b.metadata.get('edge_weight')
  out['edge_weight'] = None if ew is None else ew.numpy()
  return out


def _exchange_keys(js):
  return [k for k in js if k.startswith('dist.')
          and k != 'dist.feature.cold_hit_rate']


@pytest.mark.parametrize('split,gns,order', [
    pytest.param(1.0, False, '1', id='untiered'),
    pytest.param(0.3, True, '1', id='tiered-gns-pipelined'),
    pytest.param(0.3, True, '0', id='tiered-gns-sequential')])
def test_with_edge_loader_byte_equal_to_jax(monkeypatch, split, gns, order):
  _clean_env(monkeypatch)
  monkeypatch.setenv('GLT_COLD_PREFETCH', order)
  jds, ds, rows, cols = _datasets(split)
  kw = dict(batch_size=BATCH, shuffle=True, seed=0, gns=gns, with_edge=True)
  if split < 1.0:
    kw['cold_cache_rows'] = 24
  jl = JaxLoader(jds, FANOUTS, np.arange(N), mesh=jax_make_mesh(P), **kw)
  tl = DistNeighborLoader(ds, FANOUTS, np.arange(N), draws=jax_key_draws(0),
                          device='cpu', **kw)
  s = tl.sampler
  assert s.with_edge and s.collect_edge_features and s.gns == gns
  assert s.ds.edge_features.mod_sharded
  assert jl.sampler._ef_shard_mode == 'mod'
  assert tl._cold_pipeline == (split < 1.0 and order == '1')
  jb = [_np(b) for b in itertools.islice(iter(jl), BATCHES)]
  tb = [_port(b) for b in itertools.islice(iter(tl), BATCHES)]
  for i, (r, g) in enumerate(zip(jb, tb)):
    for f in FIELDS:
      assert g[f].dtype == r[f].dtype, (i, f)
      np.testing.assert_array_equal(g[f], r[f], err_msg=f'batch {i} {f}')
    if gns:
      np.testing.assert_array_equal(g['edge_weight'], r['edge_weight'],
                                    err_msg=f'batch {i} edge_weight')
    else:
      assert g['edge_weight'] is None and r['edge_weight'] is None
    # every valid edge: its id names the sampled (source, target) pair
    # of the input graph, and its row is that edge's
    em, e, ea = g['edge_mask'], g['edge'], g['edge_attr']
    assert em.any() and (e[~em] == -1).all() and not ea[~em].any()
    ids = e[em]
    np.testing.assert_array_equal(ea[em][:, 0], ids)
    for p in range(P):
      m = em[p]
      # the edge list is transposed (row = neighbor, col = seed side)
      nbr = ds.new2old[g['node'][p][g['edge_index'][p, 0][m]]]
      seed = ds.new2old[g['node'][p][g['edge_index'][p, 1][m]]]
      np.testing.assert_array_equal(rows[e[p][m]], seed)
      np.testing.assert_array_equal(cols[e[p][m]], nbr)
  js = jl.sampler.exchange_stats(tick_metrics=False)
  ts = tl.sampler.exchange_stats()
  keys = _exchange_keys(js)
  assert 'dist.negative.lost' in keys and len(keys) >= 13
  for k in keys:
    assert ts[k] == js[k], k
  assert ts['dist.feature.offered'] > 0


def test_with_edge_without_edge_features():
  """``with_edge`` over a dataset without edge features returns the ids
  and no rows, as JAX; the edge ids must fit int32."""
  rows, cols, feats, _, _ = _edge_graph()
  ds = DistDataset.from_full_graph(P, rows, cols, node_feat=feats,
                                   num_nodes=N, device='cpu')
  jds = JaxDistDataset.from_full_graph(P, rows, cols, node_feat=feats,
                                       num_nodes=N)
  kw = dict(batch_size=BATCH, shuffle=True, seed=2, with_edge=True)
  jb = next(iter(JaxLoader(jds, FANOUTS, np.arange(N),
                           mesh=jax_make_mesh(P), **kw)))
  tl = DistNeighborLoader(ds, FANOUTS, np.arange(N), draws=jax_key_draws(2),
                          device='cpu', **kw)
  tb = next(iter(tl))
  assert tb.edge_attr is None and jb.edge_attr is None
  np.testing.assert_array_equal(tb.edge.numpy(), np.asarray(jb.edge))
  assert not tl.sampler.collect_edge_features
  plain = next(iter(DistNeighborLoader(ds, FANOUTS, np.arange(N),
                                       batch_size=BATCH, device='cpu')))
  assert plain.edge is None and plain.edge_attr is None
  big = DistDataset.from_full_graph(P, rows, cols, num_nodes=N, device='cpu')
  big.graph.edge_ids = torch.where(big.graph.edge_ids >= 0,
                                   big.graph.edge_ids + (1 << 31), -1)
  s = DistNeighborLoader(big, FANOUTS, np.arange(N), batch_size=BATCH,
                         with_edge=True, device='cpu').sampler
  with pytest.raises(ValueError, match='int32'):
    s._edge_ids()
