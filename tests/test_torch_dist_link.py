"""The mesh's link engine in the port against the JAX package at P = 4
(the port on the CPU, the JAX side on four devices of the virtual CPU
mesh): `dist_edge_exists` (with a capacity that drops pairs),
`dist_sample_negative` (free rows and ``rows_fixed``),
`DistLinkNeighborLoader` in binary, triplet and no-negative modes
(padded tail batches, a dense graph whose slots exhaust their trials at
an exchange slack that drops ids, and ``with_edge=True, gns=True`` on a
tiered store), the seed packing, and `make_dp_unsupervised_step`.

The port replays the JAX keys through its ``draws`` provider: the
expansion's as `test_torch_dist_gns.jax_key_draws`, the negatives'
``negatives(step, stream, trials, r, high, part=p)`` as JAX's
``fold_in(fold_in(key_step, p), 977)`` split into the row (stream 0) and
the column (stream 1) ``randint`` keys.  Tolerance: batches, link
metadata and exchange counters byte-equal / exact; loss and parameters
of the DP step within 1e-5 (f32 matmuls and scatter-adds reduce in
another order in XLA:CPU than in torch, and JAX's gradient mean is a
collective).
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from graphlearn_tpu.models import GraphSAGE as FlaxGraphSAGE
from graphlearn_tpu.models import create_train_state
from graphlearn_tpu.parallel import DistDataset as JaxDistDataset
from graphlearn_tpu.parallel import DistLinkNeighborLoader as JaxLinkLoader
from graphlearn_tpu.parallel import make_dp_unsupervised_step as jax_unsup
from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu.parallel import replicate
from graphlearn_tpu.parallel import dist_sampler as jds_mod
from graphlearn_tpu.parallel.shard_map_compat import shard_map
from graphlearn_tpu_torch.models import GraphSAGE, graphsage_from_flax
from graphlearn_tpu_torch.parallel import (DistDataset,
                                           DistLinkNeighborLoader,
                                           dist_edge_exists,
                                           dist_sample_negative,
                                           make_dp_unsupervised_step,
                                           make_mesh)
from graphlearn_tpu_torch.parallel import dist_sampler as tds_mod
from test_torch_dist_gns import _clean_env, _graph, _numpy_tree, jax_key_draws

P = 4
N = 300
FANOUTS = [3, 2]
BATCH = 8
PAIRS = 70                      # 3 batches of 4 x 8, the last padded


def link_draws(seed):
  """`jax_key_draws` plus the JAX link step's negative keys."""
  base = jax.random.key(seed)
  draws = jax_key_draws(seed)

  def negatives(step, stream, trials, r, high, part=None):
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(base, step), part), 977)
    kr, kc = jax.random.split(key)
    return torch.from_numpy(np.array(jax.random.randint(
        kr if stream == 0 else kc, (trials, r), 0, high, dtype=jnp.int32)))
  draws.negatives = negatives
  return draws


def _edge_graph(n=N, deg=8, seed=0):
  rows, cols, feats, _ = _graph(n, deg=deg, seed=seed)
  efeat = np.stack([np.arange(len(rows)), rows, cols], 1).astype(np.float32)
  return rows, cols, feats, efeat


def _pair(split=1.0, n=N, deg=8, pairs=PAIRS, seed=1, **kw):
  rows, cols, feats, efeat = _edge_graph(n, deg)
  dkw = dict(node_feat=feats, num_nodes=n, split_ratio=split,
             edge_feat=efeat)
  jds = JaxDistDataset.from_full_graph(P, rows, cols, **dkw)
  ds = DistDataset.from_full_graph(P, rows, cols, device='cpu', **dkw)
  seeds = (rows[:pairs], cols[:pairs])
  kw = dict(batch_size=BATCH, shuffle=True, seed=seed, **kw)
  if split < 1.0:
    kw['cold_cache_rows'] = 24
  jl = JaxLinkLoader(jds, FANOUTS, seeds, mesh=jax_make_mesh(P), **kw)
  tl = DistLinkNeighborLoader(ds, FANOUTS, seeds, draws=link_draws(seed),
                              device='cpu', **kw)
  return jl, tl, ds, rows, cols


FIELDS = ('node', 'x', 'edge_index', 'edge_mask', 'batch',
          'num_sampled_nodes')


def _assert_batch_equal(jb, tb, i, with_edge=False):
  for f in FIELDS + (('edge', 'edge_attr') if with_edge else ()):
    a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
    assert a.dtype == b.dtype, (i, f, a.dtype, b.dtype)
    np.testing.assert_array_equal(b, a, err_msg=f'batch {i} {f}')
  assert set(jb.metadata) == set(tb.metadata), i
  for k, v in jb.metadata.items():
    a, b = np.asarray(v), tb.metadata[k].numpy()
    assert a.dtype == b.dtype, (i, k, a.dtype, b.dtype)
    np.testing.assert_array_equal(b, a, err_msg=f'batch {i} {k}')


def _assert_stats_equal(jl, tl):
  js = jl.sampler.exchange_stats(tick_metrics=False)
  ts = tl.sampler.exchange_stats(tick_metrics=False)
  keys = [k for k in js if k.startswith('dist.')
          and k != 'dist.feature.cold_hit_rate']
  for k in keys:
    assert ts[k] == js[k], k
  return ts


def _is_edge(rows, cols):
  edges = set(zip(rows.tolist(), cols.tolist()))
  return lambda r, c: np.array([(a, b) in edges for a, b in zip(r, c)])


# -- the existence exchange and the strict negatives ------------------------

def _jax_mesh_fn(body, n_in):
  return jax.jit(shard_map(body, mesh=jax_make_mesh(P),
                           in_specs=(PS('data'),) * 2 + (PS(),)
                           + (PS('data'),) * n_in,
                           out_specs=PS('data')))


@pytest.mark.parametrize('capacity', [None, 16])
def test_dist_edge_exists_matches_jax(capacity):
  rows, cols, feats, _ = _edge_graph()
  jds = JaxDistDataset.from_full_graph(P, rows, cols, num_nodes=N)
  ds = DistDataset.from_full_graph(P, rows, cols, num_nodes=N, device='cpu')
  rng = np.random.default_rng(4)
  q_rows = rng.integers(-1, N, (P, 48)).astype(np.int32)
  q_cols = rng.integers(0, N, (P, 48)).astype(np.int32)
  # half the queries are real edges (relabelled)
  pick = rng.integers(0, len(rows), (P, 24))
  q_rows[:, :24] = ds.old2new[rows[pick]]
  q_cols[:, :24] = ds.old2new[cols[pick]]

  def body(indptr, indices, bounds, r, c):
    return jds_mod.dist_edge_exists(indptr[0], indices[0], bounds, r[0],
                                    c[0], 'data', P, capacity)[None]
  g = jds.graph
  ref = np.asarray(_jax_mesh_fn(body, 2)(g.indptr, g.indices, g.bounds,
                                         q_rows, q_cols))
  tg = ds.graph
  got = dist_edge_exists(make_mesh(P, device='cpu'), tg.indptr, tg.indices,
                         torch.from_numpy(tg.bounds), torch.from_numpy(q_rows),
                         torch.from_numpy(q_cols), capacity).numpy()
  np.testing.assert_array_equal(got, ref)
  truth = _is_edge(ds.old2new[rows], ds.old2new[cols])(
      q_rows.reshape(-1), q_cols.reshape(-1)).reshape(P, -1)
  valid = q_rows >= 0
  if capacity is None:
    np.testing.assert_array_equal(got, truth & valid)
  else:
    # a pair past its owner's capacity answers "exists"
    dropped = got & ~truth & valid
    assert dropped.any() and (got[truth & valid]).all()


@pytest.mark.parametrize('fixed', [False, True], ids=['free', 'rows_fixed'])
def test_dist_sample_negative_matches_jax(fixed):
  n = 40
  rows, cols, _, _ = _edge_graph(n, deg=32)
  jds = JaxDistDataset.from_full_graph(P, rows, cols, num_nodes=n)
  ds = DistDataset.from_full_graph(P, rows, cols, num_nodes=n, device='cpu')
  req, cap = 64, 64
  rf = np.random.default_rng(6).integers(0, n, (P, req)).astype(np.int32)
  base = jax.random.key(3)
  g = jds.graph

  def body(indptr, indices, bounds, rfix):
    me = jax.lax.axis_index('data')
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(base, 1), me), 977)
    out = jds_mod.dist_sample_negative(
        indptr[0], indices[0], bounds, n, n, req, key, 'data', P,
        exchange_capacity=cap, rows_fixed=rfix[0] if fixed else None)
    return jnp.stack([out[0], out[1], out[2].astype(jnp.int32)])[None]
  ref = np.asarray(_jax_mesh_fn(body, 1)(g.indptr, g.indices, g.bounds, rf))
  tg = ds.graph
  r, c, ok = dist_sample_negative(
      make_mesh(P, device='cpu'), tg.indptr, tg.indices,
      torch.from_numpy(tg.bounds), n, n, req, link_draws(3), 1,
      capacity=cap, rows_fixed=torch.from_numpy(rf) if fixed else None)
  np.testing.assert_array_equal(r.numpy(), ref[:, 0])
  np.testing.assert_array_equal(c.numpy(), ref[:, 1])
  np.testing.assert_array_equal(ok.numpy(), ref[:, 2].astype(bool))
  if fixed:
    np.testing.assert_array_equal(r.numpy(), rf)
  # kept pairs are non-edges; this dense graph exhausts some slots
  is_edge = _is_edge(ds.old2new[rows], ds.old2new[cols])
  okn = ok.numpy()
  assert not is_edge(r.numpy()[okn], c.numpy()[okn]).any()
  assert (~okn).any() and okn.any()


# -- the link loader -------------------------------------------------------

@pytest.mark.parametrize('mode', ['binary', 'triplet', 'none'])
def test_link_loader_byte_equal_to_jax(monkeypatch, mode):
  """Three batches of 4 x 8 seed edges (the last padded) with edges and
  edge features on the untiered store."""
  _clean_env(monkeypatch)
  neg = {'binary': 'binary', 'triplet': ('triplet', 2), 'none': None}[mode]
  jl, tl, ds, rows, cols = _pair(neg_sampling=neg, with_edge=True)
  assert len(tl) == len(jl) == 3
  tb = list(tl)
  jb = list(jl)
  assert len(tb) == len(jb) == 3
  for i, (a, b) in enumerate(zip(jb, tb)):
    _assert_batch_equal(a, b, i, with_edge=True)
  last = tb[-1]
  pad = last.batch.numpy() < 0
  assert pad.any() and not pad.all()
  md = last.metadata
  if mode == 'binary':
    # the tail keeps ceil(valid pairs * 1.0) negatives a partition
    keep = md['edge_label_mask'].numpy()[:, BATCH:]
    assert (keep.sum(1) <= (~pad).sum(1)).all()
    assert (md['edge_label'].numpy()[:, BATCH:] == 0).all()
  elif mode == 'triplet':
    assert md['dst_neg_index'].shape == (P, BATCH, 2)
    assert (md['pair_mask'].numpy() == ~pad).all()
  else:
    assert (md['edge_label_mask'].numpy() == ~pad).all()
  ts = _assert_stats_equal(jl, tl)
  assert ts['dist.feature.offered'] > 0


def test_link_loader_tiered_gns_with_edge_byte_equal_to_jax(monkeypatch):
  """Binary negatives with ``with_edge=True, gns=True`` on the tiered
  store: the GNS kernel's edge-id arm on the link path, the weights
  beside the edge list, the cold overlay and the victim cache."""
  _clean_env(monkeypatch)
  jl, tl, ds, rows, cols = _pair(split=0.3, neg_sampling='binary',
                                 with_edge=True, gns=True)
  assert tl.sampler.gns and tl.sampler.tiered and tl._cold_pipeline
  for i, (a, b) in enumerate(zip(jl, tl)):
    _assert_batch_equal(a, b, i, with_edge=True)
    ew, em = b.metadata['edge_weight'].numpy(), b.edge_mask.numpy()
    assert (ew[~em] == 0).all() and (ew[em] > 0).all()
    e, ea = b.edge.numpy(), b.edge_attr.numpy()
    np.testing.assert_array_equal(ea[em][:, 0], e[em])
  ts = _assert_stats_equal(jl, tl)
  assert ts['dist.feature.cold_lookups'] > 0


def test_exhausted_and_dropped_negatives_byte_equal_to_jax(monkeypatch):
  """A dense graph (40 nodes of out-degree 32) at exchange slack 0.75:
  slots whose five trials are all edges and pairs past an owner's
  capacity (they answer "exists"); the counters, with
  ``dist.negative.lost``, equal JAX's; every kept negative is a
  non-edge."""
  _clean_env(monkeypatch)
  n = 40
  rows, cols, feats, _ = _edge_graph(n, deg=32)
  jds = JaxDistDataset.from_full_graph(P, rows, cols, node_feat=feats,
                                       num_nodes=n)
  ds = DistDataset.from_full_graph(P, rows, cols, node_feat=feats,
                                   num_nodes=n, device='cpu')
  seeds = (rows[:300], cols[:300])
  kw = dict(neg_sampling='binary', batch_size=64, shuffle=True, seed=5,
            exchange_slack=0.75)
  jl = JaxLinkLoader(jds, FANOUTS, seeds, mesh=jax_make_mesh(P), **kw)
  tl = DistLinkNeighborLoader(ds, FANOUTS, seeds, draws=link_draws(5),
                              device='cpu', **kw)
  is_edge = _is_edge(ds.old2new[rows], ds.old2new[cols])
  for i, (a, b) in enumerate(zip(jl, tl)):
    _assert_batch_equal(a, b, i)
    md = b.metadata
    keep = md['edge_label_mask'].numpy()[:, 64:]
    eli = md['edge_label_index'].numpy()[:, :, 64:]
    node = b.node.numpy()
    for p in range(P):
      src = node[p][eli[p, 0][keep[p]]]
      dst = node[p][eli[p, 1][keep[p]]]
      assert not is_edge(src, dst).any()
  ts = _assert_stats_equal(jl, tl)
  assert ts['dist.negative.lost'] > 0


def test_seed_packing_matches_jax():
  rows, cols, _, _ = _edge_graph()
  ds = DistDataset.from_full_graph(P, rows, cols, num_nodes=N, device='cpu')
  jds = JaxDistDataset.from_full_graph(P, rows, cols, num_nodes=N)
  lab = np.arange(len(rows)) % 3
  for mode in ('binary', 'triplet', None):
    for label in (None, lab):
      for space in ('old', 'new'):
        got = tds_mod.pack_link_seeds_relabeled((rows, cols), label, mode,
                                                ds, space)
        ref = jds_mod.pack_link_seeds_relabeled((rows, cols), label, mode,
                                                jds, space)
        np.testing.assert_array_equal(got, ref)
  with pytest.raises(ValueError, match='integer'):
    tds_mod.pack_link_seeds((rows, cols), lab.astype(np.float32), 'binary')
  from graphlearn_tpu.distributed.dist_options import \
      binary_num_negatives as jax_nn
  for b, amount in ((8, 1.0), (7, 0.5), (3, 2.5), (1024, 1.0)):
    assert tds_mod.binary_num_negatives(b, amount) == jax_nn(b, amount)


# -- the data-parallel unsupervised step --------------------------------------

@pytest.mark.parametrize('mode', ['binary', 'triplet'])
def test_dp_unsupervised_step_matches_jax(monkeypatch, mode):
  """Three Adam(1e-3) steps of `make_dp_unsupervised_step` on the same
  batches: loss and every parameter within 1e-5 of JAX's."""
  _clean_env(monkeypatch)
  neg = 'binary' if mode == 'binary' else ('triplet', 2)
  jl, tl, ds, _, _ = _pair(neg_sampling=neg, pairs=96)
  jbatches, tbatches = list(jl), list(tl)
  assert len(jbatches) == len(tbatches) == 3
  fmodel = FlaxGraphSAGE(hidden_features=8, out_features=4, num_layers=2)
  single = jax.tree_util.tree_map(lambda v: v[0], jbatches[0])
  tx = optax.adam(1e-3)
  state, _ = create_train_state(fmodel, jax.random.key(0), single, tx)
  model = GraphSAGE(single.x.shape[-1], 8, 4, num_layers=2)
  model.load_state_dict(graphsage_from_flax(_numpy_tree(state.params)))
  mesh = jax_make_mesh(P)
  jstep = jax_unsup(fmodel.apply, tx, mesh)
  jstate = replicate(state, mesh)
  opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
  step = make_dp_unsupervised_step(model, opt, make_mesh(P, device='cpu'))
  for jb, tb in zip(jbatches, tbatches):
    jstate, jloss = jstep(jstate, jb)
    loss = step(tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
  ref = graphsage_from_flax(_numpy_tree(jstate.params))
  for name, p in model.state_dict().items():
    np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=name)


def test_partition_negatives_stream():
  """`TorchDraws.negatives(..., part=p)`: the partition is one more
  coordinate (each partition draws its own candidates, the same on every
  call), and without ``part`` the single-card stream is unchanged
  (`test_torch_negative.test_candidate_streams` pins its digest); a
  digest of recorded values pins the new stream."""
  from graphlearn_tpu_torch.ops import TorchDraws
  td = TorchDraws(7, 'cpu')
  single = td.negatives(3, 0, 5, 40, 1000)
  got = {(p, s): td.negatives(3, s, 5, 40, 1000, part=p)
         for p in range(4) for s in (0, 1)}
  for (p, s), t in got.items():
    assert t.shape == (5, 40) and t.dtype == torch.int32
    assert int(t.min()) >= 0 and int(t.max()) < 1000
    assert torch.equal(t, td.negatives(3, s, 5, 40, 1000, part=p))
    assert not torch.equal(t, single)
  assert len({t.numpy().tobytes() for t in got.values()}) == len(got)
  h = hashlib.sha256()
  for p in range(4):
    for s in (0, 1):
      h.update(got[p, s].numpy().tobytes())
  assert h.hexdigest() == ('1156576241f68bfc6e6bc99a9e2656ec'
                           '49497b7afccfe36c6947e914f7e707fa')
