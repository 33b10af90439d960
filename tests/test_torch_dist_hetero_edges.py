"""The heterogeneous mesh's sampled edges in the port against the JAX
package's at P = 4 (the port on the CPU, the JAX side on four devices of
the virtual CPU mesh), on `test_torch_dist_hetero_link.py`'s store
(caller-global edge ids, mod-sharded edge features):
`DistHeteroNeighborLoader(with_edge=True)`, the stored edge ids and
tables, a link epoch with ``prefetch`` against the synchronous one, and
the CUDA default.

The port replays the JAX keys through `test_torch_dist_gns.
jax_key_draws` (with the edge type).  Tolerance: batches and tables
byte-equal.
"""
import itertools

import numpy as np
import pytest
import torch

from examples.igbh.train_rgnn import P as PAPER
from graphlearn_tpu.parallel import DistHeteroNeighborLoader as JaxLoader
from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu_torch.parallel import (DistHeteroLinkNeighborLoader,
                                           DistHeteroNeighborLoader,
                                           TorchDraws)
from test_torch_dist_gns import jax_key_draws
from test_torch_dist_hetero_link import (BATCH, CITES, FANOUTS, NP, SIZES,
                                         WRITES, _assert_equal,
                                         _check_edges, _datasets, _flat,
                                         data)  # noqa: F401 (a fixture)

BATCHES = 3


def test_node_loader_with_edge_byte_equal_to_jax(data):
  """`DistHeteroNeighborLoader(with_edge=True)`: the edge ids of every
  sampled edge type, the rows of the two featured ones."""
  jds, ds = _datasets(data)
  seeds = (PAPER, np.arange(SIZES['npaper']))
  kw = dict(batch_size=BATCH, shuffle=True, seed=0, with_edge=True)
  jl = JaxLoader(jds, FANOUTS, seeds, mesh=jax_make_mesh(NP), **kw)
  tl = DistHeteroNeighborLoader(ds, FANOUTS, seeds, draws=jax_key_draws(0),
                                device='cpu', **kw)
  jb = list(itertools.islice(iter(jl), BATCHES))
  tb = list(itertools.islice(iter(tl), BATCHES))
  _assert_equal(jb, tb)
  for b in tb:
    assert len(b.edge_attr_dict) == 2
    assert _check_edges(b, ds, data) > 0


def test_link_loader_epoch_with_prefetch(data):
  """An epoch with a worker two batches ahead equals the synchronous
  one, batch for batch; the key set is the same in every batch."""
  _, ds = _datasets(data)
  rows, cols = data[0][WRITES]
  out = []
  for prefetch in (0, 2):
    tl = DistHeteroLinkNeighborLoader(
        ds, FANOUTS, (WRITES, (rows, cols)), neg_sampling='binary',
        batch_size=BATCH * 2, shuffle=True, seed=1, with_edge=True,
        prefetch=prefetch, draws=TorchDraws(7, 'cpu'), device='cpu')
    out.append([_flat(b, True) for b in tl])
    tl.close()
  assert len(out[0]) == len(out[1]) == -(-len(rows) // (BATCH * 2 * NP))
  assert len({tuple(sorted(f)) for f in out[0]}) == 1
  for a, b in zip(*out):
    assert set(a) == set(b)
    for k in a:
      np.testing.assert_array_equal(a[k], b[k])


def test_edges_stored_as_jax(data):
  jds, ds = _datasets(data)
  for et in jds.etypes:
    np.testing.assert_array_equal(ds.graphs[et].edge_ids.numpy(),
                                  np.asarray(jds.graphs[et].edge_ids))
  assert set(ds.edge_features) == set(jds.edge_features) == {CITES, WRITES}
  for et, f in ds.edge_features.items():
    assert f.mod_sharded
    np.testing.assert_array_equal(f.shards.numpy(),
                                  np.asarray(jds.edge_features[et].shards))
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='CUDA'):
      DistHeteroLinkNeighborLoader(ds, FANOUTS, (WRITES, data[0][WRITES]))
