"""The mesh's random walker in the port against the JAX package's at P =
4 (the port on the CPU, the JAX side on four devices of the virtual CPU
mesh): `DistRandomWalker` walks and exchange counters over a graph with
dead ends (nodes without out-edges) and -1 padded starts, exact and at
a capped exchange slack that drops ids, and its refusals.

The port replays the JAX keys through its ``draws`` provider
(`test_torch_dist_gns.jax_key_draws`): walk step ``t`` of call ``s``
(from 1) draws at ``(step s, hop t)``, JAX's ``fold_in(fold_in(fold_in(
key(seed), s), t), owner)``.  Tolerance: walks and counters byte-equal /
exact.
"""
import numpy as np
import pytest
import torch

from graphlearn_tpu.parallel import DistDataset as JaxDistDataset
from graphlearn_tpu.parallel import DistRandomWalker as JaxWalker
from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu_torch.parallel import (DistDataset, DistRandomWalker,
                                           TorchDraws)
from test_torch_dist_gns import _graph, jax_key_draws
from test_torch_mesh import _exchange_keys

P = 4
N = 240
LENGTH = 6


def _dead_end_graph(n=N):
  """`_graph` with every node ``= 3 (mod 7)`` stripped of its
  out-edges: walks that reach one end there."""
  rows, cols, _, _ = _graph(n)
  keep = rows % 7 != 3
  return rows[keep], cols[keep]


def _starts(seed, b, ds):
  """Relabelled starts; the third call's all lie in partition 0's range,
  so a capped exchange drops some."""
  rng = np.random.default_rng(seed)
  if seed < 2:
    s = ds.old2new[rng.integers(0, N, (P, b))]
  else:
    s = rng.integers(ds.graph.bounds[0], ds.graph.bounds[1], (P, b))
  s = s.astype(np.int32)
  s[:, -2:] = -1
  s[0, 0] = ds.old2new[3]          # a dead end at the start
  return s


@pytest.mark.parametrize('slack', [None, 1.0])
def test_walks_byte_equal_to_jax(slack):
  rows, cols = _dead_end_graph()
  jds = JaxDistDataset.from_full_graph(P, rows, cols, num_nodes=N)
  ds = DistDataset.from_full_graph(P, rows, cols, num_nodes=N, device='cpu')
  jw = JaxWalker(jds, LENGTH, mesh=jax_make_mesh(P), exchange_slack=slack,
                 seed=0)
  tw = DistRandomWalker(ds, LENGTH, exchange_slack=slack,
                        draws=jax_key_draws(0), device='cpu')
  edges = set(zip(rows.tolist(), cols.tolist()))
  for call, b in enumerate((16, 16, 160)):
    starts = _starts(call, b, ds)
    got = tw.walk(starts)
    want = np.asarray(jw.walk(starts))
    assert got.dtype == torch.int32 and got.shape == (P, b, LENGTH + 1)
    np.testing.assert_array_equal(got.numpy(), want, err_msg=f'call {call}')
    w = got.numpy()
    np.testing.assert_array_equal(w[..., 0], starts)
    assert (w[:, -2:] == -1).all()
    old = np.where(w >= 0, ds.new2old[np.maximum(w, 0)], -1)
    for a, c in zip(old[..., :-1].reshape(-1), old[..., 1:].reshape(-1)):
      if a >= 0 and c >= 0:
        assert (a, c) in edges
      if a < 0:
        assert c < 0                 # an ended walk stays ended
    assert (old[0, 0, 1:] == -1).all()
  js = jw.exchange_stats(tick_metrics=False)
  ts = tw.exchange_stats(tick_metrics=False)
  for k in _exchange_keys(js):
    assert ts[k] == js[k], k
  assert ts['dist.frontier.offered'] > 0
  assert (ts['dist.frontier.dropped'] > 0) == (slack is not None)


def test_walker_refusals_and_defaults():
  rows, cols = _dead_end_graph()
  ds = DistDataset.from_full_graph(P, rows, cols, num_nodes=N, device='cpu')
  with pytest.raises(ValueError, match='adaptive'):
    DistRandomWalker(ds, 2, exchange_slack='adaptive', device='cpu')
  tw = DistRandomWalker(ds, 2, exchange_slack='auto', device='cpu')
  assert tw.exchange_slack is None and not tw.collect_features
  assert not tw.with_edge
  # the default draws: a seeded generator, reproducible
  starts = ds.old2new[np.arange(8 * P)].reshape(P, 8).astype(np.int32)
  a = DistRandomWalker(ds, 3, seed=4, device='cpu').walk(starts)
  b = DistRandomWalker(ds, 3, draws=TorchDraws(4, 'cpu'),
                       device='cpu').walk(starts)
  assert torch.equal(a, b)
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='CUDA'):
      DistRandomWalker(ds, 2)
