"""Induced subgraphs against the JAX package: `induced_subgraph` (exact
and truncated windows, padded node sets, edge ids as positions and as
`edge_ids`), `Graph.max_degree`, `NeighborSampler.subgraph` and
`SubGraphLoader` batches with their ``mapping``.

The sampler replays the JAX keys as `test_torch_neighbor_loader` does
(one step a subgraph).  Tolerance: byte-equal, dtypes included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.data import Dataset as JaxDataset
from graphlearn_tpu.loader import SubGraphLoader as JaxSubGraphLoader
from graphlearn_tpu.ops.subgraph import induced_subgraph as jax_induced
from graphlearn_tpu.sampler import NeighborSampler as JaxSampler
from graphlearn_tpu.sampler import NodeSamplerInput as JaxInput
from graphlearn_tpu_torch.data import Dataset, Graph
from graphlearn_tpu_torch.loader import SubGraphLoader
from graphlearn_tpu_torch.ops import induced_subgraph
from graphlearn_tpu_torch.sampler import NeighborSampler, NodeSamplerInput
# _clean_env is an autouse fixture: importing it applies it here too
from test_torch_neighbor_loader import _clean_env  # noqa: F401
from test_torch_neighbor_loader import _graph, jax_key_draws

FANOUTS = [3, 2]
N = 400


def _same(got: torch.Tensor, ref, what):
  ref = np.asarray(ref)
  assert got.numpy().dtype == ref.dtype, what
  np.testing.assert_array_equal(got.numpy(), ref, err_msg=what)


def _datasets(seed=0):
  rows, cols, _, _ = _graph(seed)
  jds = JaxDataset().init_graph((rows, cols), num_nodes=N)
  ds = Dataset().init_graph((rows, cols), num_nodes=N, device='cpu')
  return jds, ds


@pytest.mark.parametrize('max_degree', [None, 7, 1])
@pytest.mark.parametrize('edge_ids', ['none', 'positions', 'given'])
def test_induced_subgraph_matches_jax(max_degree, edge_ids):
  """A node set of hubs (degree 100), window and isolated rows and
  duplicate-free random ids, -1 padded; the exact window (the graph's
  max degree) and truncated ones."""
  jds, ds = _datasets()
  jg, g = jds.get_graph(), ds.get_graph()
  assert g.max_degree == jg.max_degree == 100
  rng = np.random.default_rng(6)
  nodes = np.full(64, -1, np.int32)
  nodes[:50] = rng.permutation(N)[:50]
  nodes[:3] = [0, N - 1, 2]                 # hubs and an isolated node
  d = max_degree or g.max_degree
  eids = rng.permutation(g.num_edges).astype(np.int32)
  kw = dict(with_edge_ids=edge_ids != 'none')
  ref = jax_induced(jg.indptr, jg.indices, jnp.asarray(nodes), max_degree=d,
                    edge_ids=jnp.asarray(eids) if edge_ids == 'given'
                    else None, **kw)
  got = induced_subgraph(g.indptr, g.indices, torch.from_numpy(nodes),
                         max_degree=d,
                         edge_ids=torch.from_numpy(eids)
                         if edge_ids == 'given' else None, **kw)
  for f in ('nodes', 'rows', 'cols', 'edge_mask'):
    _same(getattr(got, f), getattr(ref, f), f)
  if edge_ids == 'none':
    assert got.eids is None and ref.eids is None
  else:
    _same(got.eids, ref.eids, 'eids')
  # every induced edge is an edge among the set, relabelled
  em = got.edge_mask.numpy()
  src = nodes[got.rows.numpy()[em]]
  dst = nodes[got.cols.numpy()[em]]
  indptr, indices = g.indptr.numpy(), g.indices.numpy()
  assert all(c in indices[indptr[r]:indptr[r + 1]] for r, c in zip(src, dst))
  assert em.sum() > 0


def test_graph_max_degree_without_host_topology():
  """A graph made from tensors reads its maximum degree on the device,
  once."""
  indptr = torch.tensor([0, 2, 2, 7, 8])
  g = Graph.from_tensors(indptr, torch.zeros(8, dtype=torch.int32),
                         device='cpu')
  assert g.max_degree == 5
  g.indptr = torch.tensor([0, 9, 9, 9, 9])
  assert g.max_degree == 5                  # cached


def test_sampler_subgraph_matches_jax():
  """Three subgraph calls (steps 1-3) with duplicate and padded seeds,
  at the exact window and a truncated one."""
  jds, ds = _datasets(seed=1)
  js = JaxSampler(jds.get_graph(), FANOUTS, seed=0)
  ts = NeighborSampler(ds.get_graph(), FANOUTS, device='cpu',
                       draws=jax_key_draws(0))
  rng = np.random.default_rng(7)
  for call, max_degree in enumerate((None, 5, None)):
    seeds = rng.integers(0, N, 6).astype(np.int32)
    seeds[0] = 0                              # a hub
    if call:
      seeds[-2:] = -1
      seeds[1] = seeds[2]
    ref = js.subgraph(JaxInput(node=seeds), max_degree=max_degree)
    got = ts.subgraph(NodeSamplerInput(node=seeds), max_degree=max_degree)
    for f in ('node', 'node_count', 'row', 'col', 'edge_mask', 'batch',
              'num_sampled_nodes'):
      _same(getattr(got, f), getattr(ref, f), f'call {call} {f}')
    assert got.edge is None and ref.edge is None
    assert set(got.metadata) == set(ref.metadata) == {'seed_local',
                                                      'mapping'}
    for k in ref.metadata:
      _same(got.metadata[k], ref.metadata[k], f'call {call} {k}')


def test_subgraph_loader_matches_jax():
  """SEAL's loading: one link's two endpoints a batch over 7 links (no
  features, no labels), every batch byte-equal and ``mapping`` the
  endpoints' local ids."""
  jds, ds = _datasets(seed=2)
  pairs = np.random.default_rng(8).integers(0, N, (7, 2)).reshape(-1)
  jl = JaxSubGraphLoader(jds, [4], pairs, batch_size=2, seed=0)
  tl = SubGraphLoader(ds, [4], pairs, batch_size=2, seed=0,
                      draws=jax_key_draws(0), device='cpu')
  n = 0
  for jb, tb in zip(jl, tl):
    for f in ('node', 'node_mask', 'edge_index', 'edge_mask', 'batch'):
      _same(getattr(tb, f), getattr(jb, f), f'batch {n} {f}')
    _same(tb.metadata['mapping'], jb.metadata['mapping'], f'batch {n}')
    mapping = tb.metadata['mapping'].numpy()
    np.testing.assert_array_equal(tb.node.numpy()[mapping],
                                  pairs[2 * n:2 * n + 2])
    assert tb.x is None and tb.y is None
    n += 1
  assert n == 7
