"""The port's one-card mesh path against the JAX package on
``make_mesh(1)``: `DistDataset.from_full_graph` (tiered, split 0.3),
`DistNeighborLoader` with the victim cache admitting between batches,
GNS on (both dispatch orders) and off, and GraphSAGE training through
`make_dp_supervised_step`.

The port's loader replays the JAX loader's keys through its ``draws``
provider: ``fold_in(key(seed), step)`` -> ``fold_in(., hop)`` ->
``fold_in(., card 0)`` -> ``split`` into the uniform and the window
stream.  Tolerances: batches and counters byte-equal / exact; logits,
loss and parameters within 1e-5 (f32 matmuls and scatter-adds reduce
in another order in XLA:CPU than in torch).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphlearn_tpu.models import GraphSAGE as FlaxGraphSAGE
from graphlearn_tpu.models import create_train_state
from graphlearn_tpu.parallel import DistDataset as JaxDistDataset
from graphlearn_tpu.parallel import DistNeighborLoader as JaxLoader
from graphlearn_tpu.parallel import make_dp_supervised_step as jax_dp_step
from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu.parallel import replicate
from graphlearn_tpu_torch.models import GraphSAGE, graphsage_from_flax
from graphlearn_tpu_torch.parallel import (DistDataset, DistNeighborLoader,
                                           make_dp_supervised_step,
                                           make_mesh)

FANOUTS = [3, 2]
BATCHES = 6


def _graph(n, deg=8, dim=6, seed=0):
  rng = np.random.default_rng(seed)
  rows = np.repeat(np.arange(n), deg)
  cols = rng.integers(0, n, n * deg)
  # a few hubs so some rows reach past the window and the hot split
  # holds high in-degree nodes
  cols[::7] = rng.integers(0, 12, cols[::7].shape[0])
  feats = rng.standard_normal((n, dim)).astype(np.float32)
  labels = (np.arange(n) % 5).astype(np.int32)
  return rows, cols, feats, labels


def jax_key_draws(seed):
  """A draws provider that replays the JAX mesh sampler's keys."""
  base = jax.random.key(seed)

  def draws(step, hop, rows, k, w, gns, owner=0):
    own = jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(base, step), hop), owner)
    k_rand, k_win = jax.random.split(own)
    u = jax.random.uniform(k_rand, (rows, k))
    v = (jax.random.uniform(k_win, (rows, k)) if gns else
         jax.random.gumbel(k_win, (rows, w), dtype=jnp.float32))
    return torch.from_numpy(np.array(u)), torch.from_numpy(np.array(v))
  return draws


def _clean_env(monkeypatch):
  for env in ('GLT_GNS', 'GLT_GNS_BOOST', 'GLT_COLD_CACHE_ROWS',
              'GLT_PALLAS_SAMPLE', 'GLT_EXCHANGE_LAYOUT', 'GLT_PARTITIONER',
              'GLT_COLD_PREFETCH'):
    monkeypatch.delenv(env, raising=False)


def _loaders(n, gns, batch_size=16, cache_rows=24, seed=0, prefetch=0,
             n_seeds=None):
  rows, cols, feats, labels = _graph(n, seed=seed)
  seeds = np.arange(n if n_seeds is None else n_seeds)
  jds = JaxDistDataset.from_full_graph(1, rows, cols, node_feat=feats,
                                       node_label=labels, num_nodes=n,
                                       split_ratio=0.3)
  ds = DistDataset.from_full_graph(1, rows, cols, node_feat=feats,
                                   node_label=labels, num_nodes=n,
                                   split_ratio=0.3, device='cpu')
  kw = dict(batch_size=batch_size, shuffle=True, seed=0,
            cold_cache_rows=cache_rows, gns=gns)
  jl = JaxLoader(jds, FANOUTS, seeds, mesh=jax_make_mesh(1), **kw)
  tl = DistNeighborLoader(ds, FANOUTS, seeds, draws=jax_key_draws(0),
                          device='cpu', prefetch=prefetch, **kw)
  return jds, ds, jl, tl, feats


def test_dataset_matches_jax():
  n = 200
  rows, cols, feats, labels = _graph(n, seed=3)
  jds = JaxDistDataset.from_full_graph(1, rows, cols, node_feat=feats,
                                       node_label=labels, num_nodes=n,
                                       split_ratio=0.3)
  ds = DistDataset.from_full_graph(1, rows, cols, node_feat=feats,
                                   node_label=labels, num_nodes=n,
                                   split_ratio=0.3, device='cpu')
  np.testing.assert_array_equal(ds.old2new, jds.old2new)
  np.testing.assert_array_equal(ds.new2old, jds.new2old)
  g, jg = ds.graph, jds.graph
  np.testing.assert_array_equal(g.bounds, jg.bounds)
  for a, b in ((g.indptr, jg.indptr), (g.indices, jg.indices),
               (g.edge_ids, jg.edge_ids)):
    assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
  nf, jnf = ds.node_features, jds.node_features
  np.testing.assert_array_equal(nf.shards.numpy(), jnf.shards)
  np.testing.assert_array_equal(nf.hot_counts, jnf.hot_counts)
  np.testing.assert_array_equal(nf.cold_host.numpy(), jnf.cold_host)
  np.testing.assert_array_equal(ds.node_labels.numpy(), jds.node_labels)
  assert nf.is_tiered and int(nf.hot_counts[0]) == int(np.ceil(0.3 * n))


def _batch_np(b, fields=('node', 'x', 'y', 'edge_index', 'edge_mask')):
  out = {f: np.asarray(getattr(b, f)) for f in fields}
  ew = b.metadata.get('edge_weight')
  out['edge_weight'] = None if ew is None else np.asarray(ew)
  return out


def _port_np(b):
  out = {f: getattr(b, f).numpy() for f in
         ('node', 'x', 'y', 'edge_index', 'edge_mask')}
  ew = b.metadata.get('edge_weight')
  out['edge_weight'] = None if ew is None else ew.numpy()
  return out


@pytest.mark.parametrize('gns,prefetch,depth', [
    pytest.param(True, '1', 0, id='True-1'),
    pytest.param(True, '0', 0, id='True-0'),
    pytest.param(False, '1', 0, id='False-1'),
    pytest.param(True, '1', 2, id='True-1-prefetch2')])
def test_loader_batches_byte_equal_to_jax(monkeypatch, gns, prefetch, depth):
  """``depth`` is the port loader's ``prefetch=``: with a worker
  thread the epoch is exactly `BATCHES` batches and is read to its end,
  so the worker dispatches no batch past the compared ones."""
  _clean_env(monkeypatch)
  monkeypatch.setenv('GLT_COLD_PREFETCH', prefetch)
  n = 320
  jds, ds, jl, tl, feats = _loaders(
      n, gns, prefetch=depth, n_seeds=BATCHES * 16 if depth else None)
  assert tl.sampler.gns == jl.sampler.gns == gns
  assert tl._cold_pipeline == jl._cold_pipeline == (prefetch == '1')
  jb = [_batch_np(b) for b in itertools.islice(iter(jl), BATCHES)]
  tb = [_port_np(b) for b in itertools.islice(iter(tl),
                                               BATCHES + bool(depth))]
  assert len(tb) == BATCHES
  for i, (r, g) in enumerate(zip(jb, tb)):
    for f in ('node', 'x', 'y', 'edge_index', 'edge_mask'):
      assert g[f].dtype == r[f].dtype, (i, f)
      np.testing.assert_array_equal(g[f], r[f], err_msg=f'batch {i} {f}')
    if gns:
      np.testing.assert_array_equal(g['edge_weight'], r['edge_weight'],
                                    err_msg=f'batch {i} edge_weight')
      ew, em = g['edge_weight'], g['edge_mask']
      assert (ew[~em] == 0).all() and (ew[em] > 0).all()
    else:
      assert g['edge_weight'] is None and r['edge_weight'] is None
    # every valid row is the source row of its node, across both tiers
    node = g['node'][0]
    ok = node >= 0
    np.testing.assert_array_equal(g['x'][0][ok],
                                  feats[ds.new2old[node[ok]]])
  js = jl.sampler.exchange_stats(tick_metrics=False)
  ts = tl.sampler.exchange_stats()
  # the JAX package's `cold_hit_rate` is an alias of `cache_hit_rate`
  # (compared here); the port keeps one name
  keys = [k for k in js if k.startswith(('dist.feature.', 'dist.frontier.'))
          and k != 'dist.feature.cold_hit_rate']
  assert js['dist.feature.cold_hit_rate'] == js['dist.feature.cache_hit_rate']
  assert len(keys) >= 12
  for k in keys:
    assert ts[k] == js[k], k
  assert ts['dist.feature.cache_admits'] > 0 and ts['dist.feature.cache_hits']
  assert ts['dist.frontier.dropped'] == 0


def test_weights_differ_from_one_and_gns_changes_the_sample(monkeypatch):
  _clean_env(monkeypatch)
  n = 320
  _, _, _, on, _ = _loaders(n, True)
  _, _, _, off, _ = _loaders(n, False)
  b_on, b_off = next(iter(on)), next(iter(off))
  ew = b_on.metadata['edge_weight'].numpy()
  em = b_on.edge_mask.numpy()
  assert (ew[em] != 1.0).any()
  np.testing.assert_array_equal(b_on.batch.numpy(), b_off.batch.numpy())
  assert not np.array_equal(b_on.node.numpy(), b_off.node.numpy())


def _numpy_tree(params):
  return jax.tree_util.tree_map(np.asarray, params)


def test_graphsage_and_dp_steps_match_jax(monkeypatch):
  """Logits on a GNS batch within 1e-5; two Adam(1e-3) steps of the DP
  step leave loss and every parameter within 1e-5 of JAX's."""
  _clean_env(monkeypatch)
  n, bs = 320, 16
  _, _, jl, tl, feats = _loaders(n, True, batch_size=bs)
  jbatches = list(itertools.islice(iter(jl), 2))
  tbatches = list(itertools.islice(iter(tl), 2))
  fmodel = FlaxGraphSAGE(hidden_features=8, out_features=5, num_layers=2)
  single = jax.tree_util.tree_map(lambda v: v[0], jbatches[0])
  tx = optax.adam(1e-3)
  state, _ = create_train_state(fmodel, jax.random.key(0), single, tx)
  params = _numpy_tree(state.params)

  model = GraphSAGE(feats.shape[1], 8, 5, num_layers=2)
  model.load_state_dict(graphsage_from_flax(params))
  tb0 = tbatches[0]
  with torch.no_grad():
    got = model(tb0.x[0], tb0.edge_index[0], tb0.edge_mask[0],
                edge_weight=tb0.metadata['edge_weight'][0])
  ref = fmodel.apply(state.params, single.x, single.edge_index,
                     single.edge_mask,
                     edge_weight=single.metadata['edge_weight'])
  np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                             atol=1e-5)

  jstep = jax_dp_step(fmodel.apply, tx, bs, jax_make_mesh(1))
  jstate = replicate(state, jax_make_mesh(1))
  opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
  step = make_dp_supervised_step(model, opt, bs, make_mesh(1, device='cpu'))
  for jb, tb in zip(jbatches, tbatches):
    jstate, jloss, jcorrect = jstep(jstate, jb)
    loss, correct = step(tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    assert int(correct) == int(jcorrect)
  ref_state = graphsage_from_flax(_numpy_tree(jstate.params))
  for name, p in model.state_dict().items():
    np.testing.assert_allclose(p.numpy(), ref_state[name].numpy(),
                               rtol=1e-5, atol=1e-5, err_msg=name)


def test_mesh_and_capacity_contract():
  two = make_mesh(2, device='cpu')
  x = torch.arange(12).reshape(2, 2, 3)
  assert two.size == 2 and two.device.type == 'cpu'
  assert torch.equal(two.all_to_all(x), x.transpose(0, 1))
  mesh = make_mesh(1, device='cpu')
  x = torch.arange(6).reshape(1, 1, 6)
  assert torch.equal(mesh.all_to_all(x), x) and mesh.size == 1
  n = 96
  rows, cols, feats, labels = _graph(n)
  ds = DistDataset.from_full_graph(1, rows, cols, node_feat=feats,
                                   node_label=labels, num_nodes=n,
                                   split_ratio=0.3, device='cpu')
  loader = DistNeighborLoader(ds, FANOUTS, np.arange(n), batch_size=8,
                              device='cpu')
  assert not loader.sampler.gns and loader.sampler.tiered
  assert loader.sampler.node_capacity(8) == 8 + 24 + 48
  b = next(iter(loader))
  assert b.x.shape == (1, 80, feats.shape[1]) and b.y.dtype == torch.int32
  assert b.edge_index.shape == (1, 2, 24 + 48)
  full = DistDataset.from_full_graph(1, rows, cols, node_feat=feats,
                                     num_nodes=n, device='cpu')
  s = DistNeighborLoader(full, FANOUTS, np.arange(n), batch_size=8,
                         gns=True, device='cpu').sampler
  assert not s.tiered and not s.gns and not s.collect_labels


def test_build_dist_graph_three_partitions_matches_jax():
  """The relabel and per-partition CSR for P=3 (`build_dist_graph` is
  general in P even though the mesh runs one card)."""
  from graphlearn_tpu.parallel.dist_data import \
      build_dist_graph as jax_build
  from graphlearn_tpu_torch.parallel import build_dist_graph
  n = 150
  rows, cols, _, _ = _graph(n, seed=4)
  node_pb = (np.arange(n) * 7 % 3).astype(np.int32)
  hot = np.bincount(cols, minlength=n)
  jg, jo2n = jax_build(rows, cols, node_pb, n, num_parts=3, hotness=hot)
  g, o2n = build_dist_graph(rows, cols, node_pb, n, num_parts=3,
                            hotness=hot, device='cpu')
  np.testing.assert_array_equal(o2n, jo2n)
  np.testing.assert_array_equal(g.bounds, jg.bounds)
  np.testing.assert_array_equal(g.indptr.numpy(), jg.indptr)
  np.testing.assert_array_equal(g.indices.numpy(), jg.indices)
  np.testing.assert_array_equal(g.edge_ids.numpy(), jg.edge_ids)


def test_clock_cache_policy_matches_jax():
  """The host policy over several waves (free slots, then CLOCK sweeps
  with second chances): tags, bits, hand, versions and lookups."""
  from graphlearn_tpu.data.cold_cache import ClockShardCache as JaxClock
  from graphlearn_tpu.data.cold_cache import \
      resolve_cache_rows as jax_rows
  from graphlearn_tpu_torch.data.cold_cache import (ClockShardCache,
                                                    resolve_cache_rows)
  a, b = ClockShardCache(40), JaxClock(40)
  rng = np.random.default_rng(9)
  for wave in range(8):
    ids = rng.integers(0, 120, 70)
    for c in (a, b):
      hit, slot = c.lookup(ids, active=ids % 3 != 0)
    uniq, counts = np.unique(ids, return_counts=True)
    pa, pb = a.plan_admissions(uniq, counts), b.plan_admissions(uniq, counts)
    for x, y in zip(pa, pb):
      np.testing.assert_array_equal(x, y)
    a.commit(*pa[:2])
    b.commit(*pb[:2])
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.ref, b.ref)
    assert a.hand == b.hand and a.version == b.version
    np.testing.assert_array_equal(a.resident_ids(), b.resident_ids())
  for spec, cold in (('auto', 1000), (None, 0), (7, 50), (0, 50)):
    assert resolve_cache_rows(spec, cold) == jax_rows(spec, cold)


def test_mesh_cold_cache_plans_match_jax():
  """`MeshColdCache.plan_admissions` (each admitted id's first position
  among the miss rows, found by a search instead of a dict) equals the
  JAX cache's plan."""
  from jax.sharding import NamedSharding, PartitionSpec
  from graphlearn_tpu.data.cold_cache import MeshColdCache as JaxCache
  from graphlearn_tpu_torch.data.cold_cache import MeshColdCache
  mesh = jax_make_mesh(1)
  jc = JaxCache(16, 3, np.float32, 1, mesh, 'data', lambda a: jax.device_put(
      a, NamedSharding(mesh, PartitionSpec('data'))))
  tc = MeshColdCache(16, 3, torch.float32, 1, device='cpu')
  rng = np.random.default_rng(2)
  for _ in range(4):
    ids = rng.integers(-1, 60, (1, 50))
    miss = (ids >= 0) & (rng.random((1, 50)) < 0.6)
    for c in (jc, tc):
      c.lookup(ids, miss)
    pj, pt = jc.plan_admissions(ids, miss), tc.plan_admissions(ids, miss)
    for x, y in zip(pj[0], pt[0]):
      np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    x = torch.arange(150, dtype=torch.float32).reshape(1, 50, 3)
    tc.commit_admissions(x, pt)
    jc.commit_admissions(jnp.asarray(x.numpy()), pj, jc.admit_width(pj))
    np.testing.assert_array_equal(tc.rows.numpy(), np.asarray(jc.rows))
    assert tc.version == jc.version


def test_single_card_step_matches_jax(monkeypatch):
  """`make_supervised_step` on one card's piece of a batch against
  JAX's jitted `make_supervised_step` (Adam 1e-3): loss, correct count
  and parameters within 1e-5 after two steps."""
  from graphlearn_tpu.models import make_supervised_step as jax_step
  from graphlearn_tpu_torch.models import make_supervised_step
  from graphlearn_tpu_torch.parallel.dp import local_piece
  _clean_env(monkeypatch)
  n, bs = 320, 16
  _, _, jl, tl, feats = _loaders(n, True, batch_size=bs)
  jbatches = [jax.tree_util.tree_map(lambda v: v[0], b)
              for b in itertools.islice(iter(jl), 2)]
  tbatches = [local_piece(b) for b in itertools.islice(iter(tl), 2)]
  fmodel = FlaxGraphSAGE(hidden_features=8, out_features=5, num_layers=3)
  tx = optax.adam(1e-3)
  state, _ = create_train_state(fmodel, jax.random.key(1), jbatches[0], tx)
  model = GraphSAGE(feats.shape[1], 8, 5, num_layers=3)
  model.load_state_dict(graphsage_from_flax(_numpy_tree(state.params)))
  step = make_supervised_step(
      model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8), bs)
  jstep = jax_step(fmodel.apply, tx, bs)
  for jb, tb in zip(jbatches, tbatches):
    assert tb.x.ndim == 2 and tb.batch_size == bs
    state, jloss, jcorrect = jstep(state, jb)
    loss, correct = step(tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    assert int(correct) == int(jcorrect)
  ref = graphsage_from_flax(_numpy_tree(state.params))
  for name, p in model.state_dict().items():
    np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=name)
