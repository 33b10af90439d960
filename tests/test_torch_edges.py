"""Sampled edge ids and edge features against the JAX package: the
one-hop sampler's ``eids`` on every arm (the plain version and the
kernel wrapper's CPU path, with and without ``edge_ids``, both row
orders), `Graph.edge_ids`, `NeighborLoader`, `SubGraphLoader` and
`LinkNeighborLoader` with ``with_edge`` and edge features, the
heterogeneous ``edge_attr_dict`` and a tiered edge table.

The port replays the JAX samplers' keys (`test_torch_sample._jax_draws`,
`test_torch_neighbor_loader.jax_key_draws`, `test_torch_hetero.
jax_hetero_draws`, `test_torch_negative.jax_neg_draws`).  Tolerance:
byte-equal, dtypes included, for ids, masks, edge ids and gathered
edge rows.
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.data import Dataset as JaxDataset
from graphlearn_tpu.loader import LinkNeighborLoader as JaxLinkLoader
from graphlearn_tpu.loader import NeighborLoader as JaxLoader
from graphlearn_tpu.loader import SubGraphLoader as JaxSubGraphLoader
from graphlearn_tpu.ops.neighbor import sample_one_hop as jax_sample
from graphlearn_tpu.ops.pallas_sample import sample_one_hop_fused as jax_fused
from graphlearn_tpu.sampler import NegativeSampling as JaxNeg
from graphlearn_tpu.sampler import NodeSamplerInput as JaxInput
from graphlearn_tpu.sampler.hetero_neighbor_sampler import (
    HeteroNeighborSampler as JaxHeteroSampler)
from graphlearn_tpu_torch import typing as tt
from graphlearn_tpu_torch.data import Dataset
from graphlearn_tpu_torch.loader import (LinkNeighborLoader, NeighborLoader,
                                         SubGraphLoader)
from graphlearn_tpu_torch.ops import (CounterDraws, TorchDraws, default_window,
                                      gather_rows_plain, sample_one_hop,
                                      sample_one_hop_fused)
from graphlearn_tpu_torch.ops.neighbor import check_edge_ids
from graphlearn_tpu_torch.sampler import (HeteroNeighborSampler,
                                          NegativeSampling, NeighborSampler,
                                          NodeSamplerInput)
from test_torch_hetero import P, datasets as hetero_datasets
from test_torch_hetero import jax_hetero_draws
from test_torch_negative import jax_neg_draws
# _clean_env is an autouse fixture: importing it applies it here too
from test_torch_neighbor_loader import _clean_env  # noqa: F401
from test_torch_neighbor_loader import N, _graph, jax_key_draws
from test_torch_sample import _csr, _jax_draws, _seeds

FANOUTS = [3, 2]
EDGE_DIM = 3


def _same(got, ref, what):
  ref = np.asarray(ref)
  got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
  assert got.dtype == ref.dtype, what
  np.testing.assert_array_equal(got, ref, err_msg=what)


@pytest.mark.parametrize('k,window', [(1, None), (5, None), (5, 256),
                                      (15, None), (32, None)])
@pytest.mark.parametrize('with_ids', [False, True], ids=['pos', 'ids'])
@pytest.mark.parametrize('sort_locality', [False, True],
                         ids=['unsorted', 'sorted'])
def test_one_hop_eids_match_jax(k, window, with_ids, sort_locality):
  """``eids`` on every arm: the plain version and the wrapper's CPU path
  against JAX's XLA sampler and (windows up to 128) its Pallas kernel in
  interpret mode; CSR positions without ``edge_ids``, a permutation's
  ids with them."""
  w = default_window(k) if window is None else window
  indptr, indices = _csr(k, w=w)
  seeds = _seeds(len(indptr) - 1)
  e = len(indices)
  edge_ids = (np.random.default_rng(k).permutation(e).astype(np.int32)
              if with_ids else None)
  key = jax.random.key(7 + k)
  args = (jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(seeds), k,
          key, None if edge_ids is None else jnp.asarray(edge_ids))
  ref = jax_sample(*args, window=window, with_edge_ids=True,
                   sort_locality=sort_locality)
  refs = [ref]
  if w <= 128:
    refs.append(jax_fused(*args, window=window, with_edge_ids=True,
                          sort_locality=sort_locality, interpret=True))
  u, g = _jax_draws(key, len(seeds), k, w)
  t = [torch.from_numpy(a) for a in (indptr, indices, seeds)]
  eid_t = None if edge_ids is None else torch.from_numpy(edge_ids)
  got_fused = sample_one_hop_fused(*t, k, torch.from_numpy(u),
                                   torch.from_numpy(g),
                                   sort_locality=sort_locality,
                                   edge_ids=eid_t, with_edge_ids=True)
  gots = [got_fused]
  if not sort_locality:
    gots.append(sample_one_hop(*t, k, torch.from_numpy(u),
                               torch.from_numpy(g), eid_t, True))
  for r in refs:
    for got in gots:
      _same(got.nbrs, r.nbrs, 'nbrs')
      _same(got.mask, r.mask, 'mask')
      _same(got.eids, r.eids, 'eids')
  eids, mask = got_fused.eids.numpy(), got_fused.mask.numpy()
  assert (eids[~mask] == -1).all() and (eids[mask] >= 0).all()
  # without the arm the draws and neighbors do not move
  plain = sample_one_hop_fused(*t, k, torch.from_numpy(u),
                               torch.from_numpy(g),
                               sort_locality=sort_locality)
  assert plain.eids is None and torch.equal(plain.nbrs, got_fused.nbrs)


def test_edge_id_contract():
  """int32 ids of one per edge; positions must fit int32; a graph's
  caller ids survive a tensor CSR, a numpy CSR re-sort and COO input,
  as JAX keeps them."""
  check_edge_ids(10, None, True)
  check_edge_ids(1 << 31, None, False)
  with pytest.raises(ValueError, match='int32'):
    check_edge_ids(1 << 31, None, True)
  with pytest.raises(ValueError, match='int32'):
    check_edge_ids(4, torch.arange(4), True)
  with pytest.raises(ValueError, match=r'\[5\]'):
    check_edge_ids(5, torch.arange(4, dtype=torch.int32), True)
  rng = np.random.default_rng(3)
  rows, cols = rng.integers(0, 30, 200), rng.integers(0, 30, 200)
  jds = JaxDataset().init_graph((rows, cols), num_nodes=30)
  ds = Dataset().init_graph((rows, cols), num_nodes=30, device='cpu')
  _same(ds.get_graph().edge_ids, jds.get_graph().edge_ids, 'COO ids')
  g = ds.get_graph()
  ids = rng.permutation(200).astype(np.int32) + 1000
  # a numpy CSR whose rows are not sorted: the ids follow the re-sort
  order = rng.permutation(200)
  indptr = np.asarray(g.indptr)
  shuffled = np.concatenate([rng.permutation(np.arange(a, b))
                             for a, b in zip(indptr[:-1], indptr[1:])])
  csr = (indptr, np.asarray(g.indices)[shuffled])
  jcsr = JaxDataset().init_graph(csr, edge_ids=ids, layout='CSR',
                                 num_nodes=30)
  tcsr = Dataset().init_graph(csr, edge_ids=ids, layout='CSR', num_nodes=30,
                              device='cpu')
  _same(tcsr.get_graph().edge_ids, jcsr.get_graph().edge_ids, 'CSR ids')
  # a tensor CSR is taken as it is, ids with it
  tens = Dataset().init_graph((g.indptr, g.indices), edge_ids=torch.from_numpy(
      ids[order]), layout='CSR', device='cpu')
  _same(tens.get_graph().edge_ids, ids[order], 'tensor CSR ids')
  assert Dataset().init_graph((g.indptr, g.indices), layout='CSR',
                              device='cpu').get_graph().edge_ids is None
  with pytest.raises(ValueError, match='one id per edge'):
    Dataset().init_graph((g.indptr, g.indices), edge_ids=ids[:5],
                         layout='CSR', device='cpu')


def _edge_datasets(seed=0, split_ratio=1.0):
  rows, cols, feats, labels = _graph(seed)
  efeat = np.random.default_rng(seed + 50).standard_normal(
      (rows.shape[0], EDGE_DIM)).astype(np.float32)
  jds = (JaxDataset().init_graph((rows, cols), num_nodes=N)
         .init_node_features(feats).init_node_labels(labels)
         .init_edge_features(efeat, split_ratio=split_ratio))
  ds = (Dataset().init_graph((rows, cols), num_nodes=N, device='cpu')
        .init_node_features(feats, device='cpu').init_node_labels(labels)
        .init_edge_features(efeat, split_ratio=split_ratio, device='cpu'))
  return jds, ds, rows, cols, efeat


def _check_batch(got, ref, what):
  for f in ('x', 'y', 'edge_index', 'edge_mask', 'node', 'edge',
            'edge_attr'):
    _same(getattr(got, f), getattr(ref, f), f'{what} {f}')


def _check_edges(batch, rows, cols, efeat, transposed=True):
  """Every valid edge id names the COO edge between its endpoints (row
  0 the neighbor when ``transposed``), its row holds that edge's
  features and masked slots hold -1 and zero rows."""
  e, m = batch.edge.numpy(), batch.edge_mask.numpy()
  node, ei = batch.node.numpy(), batch.edge_index.numpy()
  src, dst = (ei[1], ei[0]) if transposed else (ei[0], ei[1])
  ok = np.nonzero(m)[0]
  np.testing.assert_array_equal(rows[e[ok]], node[src[ok]])
  np.testing.assert_array_equal(cols[e[ok]], node[dst[ok]])
  np.testing.assert_array_equal(batch.edge_attr.numpy()[ok], efeat[e[ok]])
  assert (e[~m] == -1).all() and not batch.edge_attr.numpy()[~m].any()
  return len(ok)


@pytest.mark.parametrize('split_ratio', [1.0, 0.5], ids=['hot', 'tiered'])
def test_neighbor_loader_with_edge_matches_jax(split_ratio):
  """Three shuffled batches (the last padded) with edge ids and edge
  features, from a wholly hot edge table and from one tiered at 0.5
  (its cold half served from host memory), byte-equal to JAX."""
  jds, ds, rows, cols, efeat = _edge_datasets(split_ratio=split_ratio)
  seeds = np.random.default_rng(4).permutation(N)[:40]
  jl = JaxLoader(jds, FANOUTS, seeds, batch_size=16, shuffle=True,
                 with_edge=True, seed=0)
  tl = NeighborLoader(ds, FANOUTS, seeds, batch_size=16, shuffle=True,
                      with_edge=True, seed=0, draws=jax_key_draws(0),
                      device='cpu')
  assert ds.get_edge_feature().is_tiered == (split_ratio < 1)
  n = 0
  for i, (jb, tb) in enumerate(zip(jl, tl)):
    _check_batch(tb, jb, f'batch {i}')
    n += _check_edges(tb, rows, cols, efeat)
  assert i == 2 and n > 100


def test_subgraph_loader_with_edge_matches_jax():
  """Induced subgraphs with their edges' ids and features (the closure
  sampled without edge ids, as in JAX)."""
  jds, ds, rows, cols, efeat = _edge_datasets(seed=2)
  seeds = np.random.default_rng(5).integers(0, N, 12)
  jl = JaxSubGraphLoader(jds, [2], seeds, batch_size=4, with_edge=True,
                         seed=0)
  tl = SubGraphLoader(ds, [2], seeds, batch_size=4, with_edge=True, seed=0,
                      draws=jax_key_draws(0), device='cpu')
  n = 0
  for i, (jb, tb) in enumerate(zip(jl, tl)):
    _check_batch(tb, jb, f'subgraph {i}')
    _same(tb.metadata['mapping'], jb.metadata['mapping'], 'mapping')
    n += _check_edges(tb, rows, cols, efeat, transposed=False)
  assert i == 2 and n > 0


@pytest.mark.parametrize('mode', [None, ('binary', 1.0), ('triplet', 2)],
                         ids=['none', 'binary', 'triplet'])
def test_link_loader_with_edge_matches_jax(mode):
  """Link batches with edge ids and features, in every negative mode."""
  jds, ds, rows, cols, efeat = _edge_datasets(seed=1)
  pick = np.random.default_rng(6).permutation(rows.shape[0])[:20]
  edges = (rows[pick], cols[pick])
  jl = JaxLinkLoader(jds, FANOUTS, edges, batch_size=8, with_edge=True,
                     neg_sampling=None if mode is None else JaxNeg(*mode),
                     seed=0)
  tl = LinkNeighborLoader(
      ds, FANOUTS, edges, batch_size=8, with_edge=True,
      neg_sampling=None if mode is None else NegativeSampling(*mode),
      seed=0, draws=jax_key_draws(0),
      neg_draws=jax_neg_draws(0, triplet=mode is not None
                              and mode[0] == 'triplet'), device='cpu')
  for i, (jb, tb) in enumerate(zip(jl, tl)):
    _check_batch(tb, jb, f'link {i}')
    for k in jb.metadata:
      np.testing.assert_array_equal(tb.metadata[k].numpy(),
                                    np.asarray(jb.metadata[k]), err_msg=k)
    _check_edges(tb, rows, cols, efeat)
  assert i == 2


#: edge tables keyed by emitted (reversed) edge types, and by one the
#: sampler never emits: ``cites`` is a self-relation, emitted as itself
EMITTED_TABLES = [(P, 'cites', P), (P, 'rev_writes', 'author'),
                  ('institution', 'rev_affiliated_with', 'author')]
NEVER_EMITTED = (P, 'rev_cites', P)


def _hetero_edge_tables(edges, seed=0):
  rng = np.random.default_rng(seed + 9)
  tables = {}
  for et in EMITTED_TABLES + [NEVER_EMITTED]:
    fwd = tt.reverse_edge_type(et) if et != NEVER_EMITTED else et[::-1]
    fwd = fwd if fwd in edges else (P, 'cites', P)
    tables[et] = rng.standard_normal(
        (edges[fwd][0].shape[0], EDGE_DIM)).astype(np.float32)
  return tables


@pytest.mark.parametrize('split_ratio', [1.0, 0.5], ids=['hot', 'tiered'])
def test_hetero_edge_attr_dict_matches_jax(split_ratio):
  """``edge_attr_dict`` is looked up under the EMITTED (reversed) edge
  type, as JAX does, so the table under ``rev_cites`` (no edge type is
  emitted so) is never read; every sampled ``edge`` id names an edge of
  the forward type between the emitted endpoints."""
  from test_torch_hetero import hetero_graph
  jds, ds, _, _ = hetero_datasets()
  edges, _, _ = hetero_graph(0)
  tables = _hetero_edge_tables(edges)
  jds.init_edge_features(tables, split_ratio=split_ratio)
  ds.init_edge_features(tables, split_ratio=split_ratio, device='cpu')
  seeds = np.arange(30)
  jl = JaxLoader(jds, [3, 2], (P, seeds), batch_size=12, with_edge=True,
                 seed=0)
  tl = NeighborLoader(ds, [3, 2], (P, seeds), batch_size=12, with_edge=True,
                      seed=0, draws=jax_hetero_draws(0), device='cpu')
  read = set()
  for i, (jb, tb) in enumerate(zip(jl, tl)):
    assert set(tb.edge_attr_dict) == set(jb.edge_attr_dict)
    read |= set(tb.edge_attr_dict)
    for et in jb.edge_attr_dict:
      _same(tb.edge_attr_dict[et], jb.edge_attr_dict[et], f'{i} {et}')
    for et in jb.edge_index_dict:
      _same(tb.edge_index_dict[et], jb.edge_index_dict[et], f'{i} {et}')
  assert i == 2 and read == set(EMITTED_TABLES)
  # the sampler's edge ids, against JAX's and against the COO
  js = JaxHeteroSampler(jds.get_graph(), [3, 2], with_edge=True,
                        num_nodes=jds.num_nodes_dict(), seed=1)
  ts = HeteroNeighborSampler(ds.get_graph(), [3, 2], device='cpu',
                             with_edge=True, num_nodes=ds.num_nodes_dict(),
                             draws=jax_hetero_draws(1))
  node = np.arange(16, dtype=np.int32)
  node[-3:] = -1
  ref = js.sample_from_nodes(JaxInput(node=node, input_type=P))
  got = ts.sample_from_nodes(NodeSamplerInput(node=node, input_type=P))
  assert set(got.edge) == set(ref.edge) == set(got.row)
  checked = 0
  for et, e in got.edge.items():
    _same(e, ref.edge[et], f'edge {et}')
    fwd = tt.reverse_edge_type(et)
    ok = got.edge_mask[et].numpy()
    ids = e.numpy()[ok]
    assert (e.numpy()[~ok] == -1).all()
    np.testing.assert_array_equal(
        edges[fwd][0][ids], got.node[fwd[0]].numpy()[got.col[et].numpy()[ok]])
    np.testing.assert_array_equal(
        edges[fwd][1][ids], got.node[fwd[2]].numpy()[got.row[et].numpy()[ok]])
    checked += len(ids)
  assert checked > 50


#: recorded with-edge outputs of `test_with_edge_leaves_draws_unchanged`
DIGEST_WITH_EDGE = ('090684c30b9d9b3e1e7f9873abda304a'
                    '49e7f39aa03280a257292ea3fcc137c4')


def test_with_edge_leaves_draws_unchanged():
  """The edge-id arm adds an output and no draw: with either default
  provider a with-edge sampler samples what one without samples, and so
  does the heterogeneous sampler with its default draws; and a digest of
  the with-edge outputs (the sampled ids and their edge ids)."""
  _, ds, _, _, _ = _edge_datasets(seed=3)
  g = ds.get_graph()
  seeds = np.random.default_rng(8).integers(0, N, 24)
  h = hashlib.sha256()
  for draws in (TorchDraws(5, 'cpu'),
                lambda step, hop, rows, k, w, cd=CounterDraws(5, 'cpu'):
                cd(0, None, step, hop, rows, k, w)):
    a = NeighborSampler(g, FANOUTS, device='cpu', draws=draws,
                        with_edge=True)
    b = NeighborSampler(g, FANOUTS, device='cpu', draws=draws)
    for _ in range(2):
      oa = a.sample_from_nodes(NodeSamplerInput(node=seeds))
      ob = b.sample_from_nodes(NodeSamplerInput(node=seeds))
      for f in ('node', 'row', 'col', 'edge_mask'):
        assert torch.equal(getattr(oa, f), getattr(ob, f)), f
      assert ob.edge is None and oa.edge.shape == oa.row.shape
      for t in (oa.node, oa.row, oa.edge):
        h.update(t.numpy().tobytes())
  _, hds, _, _ = hetero_datasets()
  outs = [HeteroNeighborSampler(hds.get_graph(), [3, 2], device='cpu',
                                with_edge=we, seed=4).sample_from_nodes(
      NodeSamplerInput(node=np.arange(10), input_type=P))
      for we in (True, False)]
  assert outs[1].edge is None
  for et in sorted(outs[0].row):
    for f in ('row', 'col', 'edge_mask'):
      assert torch.equal(getattr(outs[0], f)[et], getattr(outs[1], f)[et])
    h.update(outs[0].edge[et].numpy().tobytes())
  for nt in sorted(outs[0].node):
    assert torch.equal(outs[0].node[nt], outs[1].node[nt])
  assert h.hexdigest() == DIGEST_WITH_EDGE


def test_edge_rows_gather_zero_rows_for_invalid_ids():
  """Masked edge slots (-1) gather zero rows through the row gather,
  as JAX's clamped-and-masked gather."""
  table = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 1
  ids = torch.tensor([2, -1, 0, -1, 3], dtype=torch.int32)
  got = gather_rows_plain(table, ids)
  assert torch.equal(got[[1, 3]], torch.zeros(2, 3))
  assert torch.equal(got[[0, 2, 4]], table[[2, 0, 3]])
