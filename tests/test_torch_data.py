"""The port's CSR topology, device graph and feature table against the
JAX package's `Dataset` built from the same input."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.data import Dataset as JaxDataset
from graphlearn_tpu.utils import padding as jax_padding
from graphlearn_tpu.utils import tensor as jax_tensor
from graphlearn_tpu.utils import topo as jax_topo
from graphlearn_tpu_torch.data import CSRTopo, Dataset, Feature
from graphlearn_tpu_torch.utils import (coo_to_csr, id2idx,
                                        next_power_of_two, ptr2ind,
                                        round_up)

N, D = 50, 4


def _coo(seed=0, e=300):
  rng = np.random.default_rng(seed)
  rows = rng.integers(0, N - 3, e)     # trailing isolated nodes
  cols = rng.integers(0, N, e)
  return rows, cols


def _feats(seed=1):
  return np.random.default_rng(seed).standard_normal((N, D)).astype(
      np.float32)


def _edge_input(layout, rows, cols):
  if layout == 'COO':
    return (rows, cols)
  src, dst = (rows, cols) if layout == 'CSR' else (cols, rows)
  # an unsorted CSR/CSC (columns out of order within rows)
  order = np.argsort(src, kind='stable')
  indptr = np.zeros(N + 1, np.int64)
  np.cumsum(np.bincount(src, minlength=N), out=indptr[1:])
  return indptr, dst[order]


@pytest.mark.parametrize('layout', ['COO', 'CSR', 'CSC'])
def test_csr_byte_equal(layout):
  rows, cols = _coo()
  ei = _edge_input(layout, rows, cols)
  ref = JaxDataset().init_graph(ei, layout=layout, num_nodes=N).get_graph()
  ds = Dataset().init_graph(ei, layout=layout, num_nodes=N, device='cpu')
  got = ds.get_graph()
  for name in ('indptr', 'indices', 'edge_ids'):
    a, b = getattr(ref.csr_topo, name), getattr(got.csr_topo, name)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
  assert got.indptr.dtype == torch.int64
  assert got.indices.dtype == torch.int32
  np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(ref.indptr))
  assert got.indices.numpy().tobytes() == np.asarray(ref.indices).tobytes()
  assert got.num_nodes == ref.num_nodes and got.num_edges == ref.num_edges


def test_graph_from_tensors_keeps_canonical_csr():
  topo = CSRTopo(_coo(seed=2), num_nodes=N)
  ds = Dataset().init_graph(
      (torch.from_numpy(topo.indptr), torch.from_numpy(topo.indices)),
      layout='CSR', device='cpu')
  g = ds.get_graph()
  assert g.csr_topo is None
  assert g.indptr.dtype == torch.int64 and g.indices.dtype == torch.int32
  np.testing.assert_array_equal(g.indptr.numpy(), topo.indptr)
  np.testing.assert_array_equal(g.indices.numpy(), topo.indices)
  with pytest.raises(ValueError, match='num_nodes'):
    Dataset().init_graph((g.indptr, g.indices), layout='CSR',
                         num_nodes=N + 1, device='cpu')


@pytest.mark.parametrize('with_map', [False, True])
def test_feature_rows_byte_equal(with_map):
  feats = _feats()
  m = None
  if with_map:
    m = np.random.default_rng(3).permutation(N).astype(np.int64)
    m[[2, 7]] = -1
  ids = np.array([0, 4, 4, N - 1, -1, 2, 7, 11], np.int32)
  ref = JaxDataset().init_node_features(feats, id2idx=m).node_features
  got = Dataset().init_node_features(feats, id2idx=m,
                                     device='cpu').node_features
  want = np.asarray(ref[jnp.asarray(ids)])
  assert got[ids].numpy().tobytes() == want.tobytes()
  assert got.get(torch.from_numpy(ids)).numpy().tobytes() == want.tobytes()
  assert got.shape == tuple(ref.shape) and got.feature_dim == D
  assert got.size(0) == N


def test_feature_dtype_and_tiers():
  f = Feature(_feats(), device='cpu', dtype=torch.bfloat16)
  assert f.dtype == torch.bfloat16 and f.hot_tier.is_contiguous()
  assert Feature(np.arange(5.0), device='cpu').shape == (5, 1)
  # a tiered table (half the rows on the device, the rest in host
  # memory behind a victim cache) serves the fully-hot table's bytes
  feats = _feats()
  tiered = Feature(feats, split_ratio=0.5, device='cpu', cold_cache_rows=3)
  assert tiered.is_tiered and tiered.hot_rows == N // 2
  assert tiered.hot_tier.shape == (N // 2, D)
  ids = np.array([0, N - 1, -1, 30, 30, 7, 41], np.int64)
  want = Feature(feats, device='cpu').get(ids).numpy()
  for _ in range(2):
    assert tiered.get(ids).numpy().tobytes() == want.tobytes()
  assert tiered.cold_stats == {'lookups': 12, 'cold_lookups': 8}
  with pytest.raises(NotImplementedError, match='slice 8'):
    Dataset().init_graph({('a', 'to', 'b'): _coo()}, device='cpu')


def test_labels_and_utils_match_jax():
  labels = np.arange(N) % 3
  ds = Dataset().init_node_labels(labels)
  np.testing.assert_array_equal(ds.node_labels, labels)
  t = torch.arange(4)
  assert Dataset().init_node_labels(t).node_labels is t
  rows, cols = _coo(seed=4)
  for a, b in zip(coo_to_csr(rows, cols, N), jax_topo.coo_to_csr(rows, cols,
                                                                 N)):
    assert a.tobytes() == b.tobytes()
  indptr = coo_to_csr(rows, cols, N)[0]
  assert ptr2ind(indptr).tobytes() == jax_topo.ptr2ind(indptr).tobytes()
  ids = np.array([7, 2, 9])
  assert id2idx(ids).tobytes() == jax_tensor.id2idx(ids).tobytes()
  assert id2idx(torch.from_numpy(ids), max_id=12).tobytes() == \
      jax_tensor.id2idx(ids, max_id=12).tobytes()
  for x in (0, 1, 5, 64, 65, 1000):
    assert next_power_of_two(x) == jax_padding.next_power_of_two(x)
    assert round_up(x, 8) == jax_padding.round_up(x, 8)
