"""The host samplers and the collocated loaders against the JAX
package's: the same numpy inputs and batch seeds give byte-equal
`SampleMessage`s (homogeneous node, link in every negative mode, and
subgraph; heterogeneous node and link), and the collocated
`DistNeighborLoader` / `DistLinkNeighborLoader` / `DistSubGraphLoader`
give JAX's epoch batch for batch — each collated `Batch` /
`HeteroBatch` tensor equal to JAX's array (``device='cpu'``; exact, no
tolerance: both sides only copy and pad).
"""
import numpy as np
import pytest
import torch

from graphlearn_tpu import distributed as jdist
from graphlearn_tpu_torch import distributed as pdist
from graphlearn_tpu_torch.loader.transform import Batch, HeteroBatch

N = 120
PAPER, AUTHOR = 'paper', 'author'
WRITES = (AUTHOR, 'writes', PAPER)
CITES = (PAPER, 'cites', PAPER)


def _homo(mod, n=N, seed=0):
  rng = np.random.default_rng(seed)
  rows = rng.integers(0, n, 6 * n)
  rows[:40] = 3                                   # a hub
  cols = rng.integers(0, n, 6 * n)
  keep = rows != 5                                # an isolated row
  rows, cols = rows[keep], cols[keep]
  feats = rng.standard_normal((n, 6)).astype(np.float32)
  efeats = rng.standard_normal((len(rows), 3)).astype(np.float32)
  return mod.HostDataset.from_coo(rows, cols, n, node_features=feats,
                                  node_labels=np.arange(n) % 7,
                                  edge_features=efeats)


def _hetero(mod, seed=1):
  rng = np.random.default_rng(seed)
  np_, na = 80, 50
  w = (rng.integers(0, na, 300), rng.integers(0, np_, 300))
  c = (rng.integers(0, np_, 400), rng.integers(0, np_, 400))
  feats = {PAPER: rng.standard_normal((np_, 5)).astype(np.float32),
           AUTHOR: rng.standard_normal((na, 4)).astype(np.float32)}
  efeats = {WRITES: rng.standard_normal((300, 2)).astype(np.float32)}
  return mod.HostHeteroDataset.from_coo(
      {WRITES: w, CITES: c}, {PAPER: np_, AUTHOR: na}, node_features=feats,
      node_labels={PAPER: np.arange(np_) % 3}, edge_features=efeats)


@pytest.fixture(scope='module')
def homo():
  return _homo(pdist), _homo(jdist)


@pytest.fixture(scope='module')
def hetero():
  return _hetero(pdist), _hetero(jdist)


def assert_msg_equal(got, ref):
  assert list(got) == list(ref)
  for k in ref:
    a, b = np.asarray(got[k]), np.asarray(ref[k])
    assert a.dtype == b.dtype and a.shape == b.shape, k
    assert a.tobytes() == b.tobytes(), k


def _np(v):
  return v.numpy() if isinstance(v, torch.Tensor) else v


def assert_tree_equal(got, ref, path='batch'):
  """A port batch field (torch tensors, nested dicts) equals JAX's."""
  if isinstance(ref, dict):
    assert isinstance(got, dict) and set(got) == set(ref), path
    for k in ref:
      assert_tree_equal(got[k], ref[k], f'{path}.{k}')
    return
  if ref is None:
    assert got is None, path
    return
  if isinstance(ref, (int, float, str, tuple)):
    assert got == ref, path
    return
  a, b = _np(got), np.asarray(ref)
  assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
  assert a.tobytes() == b.tobytes(), path


def assert_batch_equal(got, ref):
  assert isinstance(got, (Batch, HeteroBatch))
  assert got.batch_size == ref.batch_size
  for name in got.FIELDS:
    if hasattr(ref, name):
      assert_tree_equal(getattr(got, name), getattr(ref, name), name)


@pytest.mark.parametrize('with_edge', [False, True])
def test_node_messages_byte_equal(homo, with_edge):
  ps = pdist.HostNeighborSampler(homo[0], [4, 3], with_edge=with_edge,
                                 seed=5)
  js = jdist.HostNeighborSampler(homo[1], [4, 3], with_edge=with_edge,
                                 seed=5)
  for seeds in (np.array([3, 5, 7, 3]), np.arange(30, 50)):
    for bs in (None, (2 * 1000003 + 7) * 131071):
      assert_msg_equal(ps.sample_from_nodes(seeds, batch_seed=bs),
                       js.sample_from_nodes(seeds, batch_seed=bs))


@pytest.mark.parametrize('neg', [None, 'binary', 'triplet'])
def test_link_messages_byte_equal(homo, neg):
  ps = pdist.HostNeighborSampler(homo[0], [3, 2], with_edge=True, seed=2)
  js = jdist.HostNeighborSampler(homo[1], [3, 2], with_edge=True, seed=2)
  src, dst = np.arange(0, 16), np.arange(16, 32)
  label = np.arange(16) % 2
  for bs in (11, 12):
    assert_msg_equal(
        ps.sample_from_edges(src, dst, label=label, neg_mode=neg,
                             neg_amount=2.0, batch_seed=bs),
        js.sample_from_edges(src, dst, label=label, neg_mode=neg,
                             neg_amount=2.0, batch_seed=bs))


def test_subgraph_messages_byte_equal(homo):
  ps = pdist.HostNeighborSampler(homo[0], [3, 2], with_edge=True, seed=1)
  js = jdist.HostNeighborSampler(homo[1], [3, 2], with_edge=True, seed=1)
  seeds = np.array([3, 8, 40, 41])
  assert_msg_equal(ps.sample_subgraph(seeds, batch_seed=9),
                   js.sample_subgraph(seeds, batch_seed=9))


def test_hetero_messages_byte_equal(hetero):
  fan = {WRITES: [3, 2], CITES: [2, 2]}
  ps = pdist.HostHeteroNeighborSampler(hetero[0], fan, with_edge=True,
                                       seed=4)
  js = jdist.HostHeteroNeighborSampler(hetero[1], fan, with_edge=True,
                                       seed=4)
  seeds = np.array([1, 2, 70, 1])
  assert_msg_equal(ps.sample_from_nodes(PAPER, seeds, batch_seed=3),
                   js.sample_from_nodes(PAPER, seeds, batch_seed=3))
  src, dst = np.arange(0, 8), np.arange(10, 18)
  for neg in (None, 'binary', 'triplet'):
    assert_msg_equal(
        ps.sample_from_edges(WRITES, src, dst, neg_mode=neg, batch_seed=6),
        js.sample_from_edges(WRITES, src, dst, neg_mode=neg, batch_seed=6))


def test_shard_dataset_refused_and_partition_dir_names_slice(homo):
  ds = _homo(pdist)
  ds.node_pb = np.zeros(N, np.int64)
  with pytest.raises(ValueError, match='partition shard'):
    pdist.HostNeighborSampler(ds, [2])
  with pytest.raises(NotImplementedError, match='slice 25'):
    pdist.HostDataset.from_partition_dir('/nonexistent', 0)


def _loaders(cls_p, cls_j, dp, dj, *args, **kw):
  return (cls_p(dp, *args, device='cpu', **kw),
          cls_j(dj, *args, to_device=False, **kw))


def _epochs_equal(pl, jl, epochs=2):
  n = 0
  for _ in range(epochs):
    got, ref = list(pl), list(jl)
    assert len(got) == len(ref) == len(pl)
    for a, b in zip(got, ref):
      assert_batch_equal(a, b)
      n += 1
  return n


def test_collocated_node_loader_epochs_equal(homo):
  pl, jl = _loaders(pdist.DistNeighborLoader, jdist.DistNeighborLoader,
                    homo[0], homo[1], [4, 3], np.arange(70), batch_size=16,
                    shuffle=True, with_edge=True, seed=3)
  assert _epochs_equal(pl, jl) == 10        # 5 batches, the tail padded
  b = next(iter(pl))
  assert b.x.device.type == 'cpu' and b.edge_index.dtype == torch.int32
  assert pl.phase_secs['collate'] > 0


@pytest.mark.parametrize('neg', [None, 'binary', ('triplet', 2)])
def test_collocated_link_loader_epochs_equal(homo, neg):
  pairs = np.stack([np.arange(0, 40), np.arange(40, 80)])
  pl, jl = _loaders(pdist.DistLinkNeighborLoader,
                    jdist.DistLinkNeighborLoader, homo[0], homo[1], [3, 2],
                    pairs, edge_label=np.arange(40) % 2, neg_sampling=neg,
                    batch_size=16, shuffle=True, seed=1)
  _epochs_equal(pl, jl, epochs=1)


def test_collocated_subgraph_loader_epochs_equal(homo):
  pl, jl = _loaders(pdist.DistSubGraphLoader, jdist.DistSubGraphLoader,
                    homo[0], homo[1], [3, 2], np.arange(24), batch_size=8,
                    with_edge=True)
  _epochs_equal(pl, jl, epochs=1)


def test_collocated_hetero_loaders_epochs_equal(hetero):
  fan = {WRITES: [3, 2], CITES: [2, 2]}
  pl, jl = _loaders(pdist.DistNeighborLoader, jdist.DistNeighborLoader,
                    hetero[0], hetero[1], fan, (PAPER, np.arange(30)),
                    batch_size=8, shuffle=True, with_edge=True, seed=2)
  _epochs_equal(pl, jl, epochs=1)
  pairs = (WRITES, np.stack([np.arange(0, 12), np.arange(20, 32)]))
  pl, jl = _loaders(pdist.DistLinkNeighborLoader,
                    jdist.DistLinkNeighborLoader, hetero[0], hetero[1], fan,
                    pairs, neg_sampling='binary', batch_size=6, seed=2)
  _epochs_equal(pl, jl, epochs=1)
  b = next(iter(pl))
  assert isinstance(b, HeteroBatch)


def test_from_dataset_borrows_the_port_dataset(homo):
  from graphlearn_tpu_torch.data import Dataset
  rows = np.array([0, 0, 1, 2, 3]), np.array([1, 2, 2, 3, 0])
  feats = np.arange(8, dtype=np.float32).reshape(4, 2)
  ds = (Dataset().init_graph(rows, layout='COO', num_nodes=4, device='cpu')
        .init_node_features(feats, device='cpu')
        .init_node_labels(np.array([1, 0, 1, 0])))
  h = pdist.HostDataset.from_dataset(ds)
  topo = ds.get_graph().csr_topo
  assert h.indptr.tolist() == topo.indptr.tolist()
  assert h.indices.tolist() == topo.indices.tolist()
  assert h.node_features.tobytes() == feats.tobytes()
  assert h.node_labels.tolist() == [1, 0, 1, 0]
