"""The mesh's induced-subgraph engine in the port against the JAX
package's at P = 4 (the port on the CPU, the JAX side on four devices of
the virtual CPU mesh): `DistSubGraphLoader` batches and exchange
counters with exact windows (with and without edge ids, one exchange of
the whole closure and chunks of 8) and a truncating ``max_degree=2``,
the exact window's independence of the draws, `resolve_hop_chunk`, and
the refusals.

The port replays the JAX keys through its ``draws`` provider
(`test_torch_dist_gns.jax_key_draws`): the expansion's hops as the mesh
loader's, and, with a truncating width, chunk ``ci`` of the full-window
hop at hop ``ci`` (JAX keys it ``fold_in(step key, ci)``).  The exact
window takes no draw.  Tolerance: batches, metadata and counters
byte-equal / exact.
"""
import itertools

import numpy as np
import pytest
import torch

from graphlearn_tpu.parallel import DistDataset as JaxDistDataset
from graphlearn_tpu.parallel import DistSubGraphLoader as JaxSubGraphLoader
from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu.parallel.dist_sampler import (
    resolve_hop_chunk as jax_resolve_hop_chunk)
from graphlearn_tpu_torch.parallel import (DistDataset, DistSubGraphLoader,
                                           TorchDraws, make_mesh,
                                           resolve_hop_chunk)
from graphlearn_tpu_torch.parallel import dist_sampler as tds_mod
from test_torch_dist_gns import _clean_env, _graph, jax_key_draws
from test_torch_mesh import _exchange_keys

P = 4
N = 200
FANOUTS = [3, 2]
BATCH = 4
BATCHES = 3
FIELDS = ('node', 'x', 'y', 'edge_index', 'edge_mask', 'batch',
          'num_sampled_nodes')


def _datasets(n=N):
  rows, cols, feats, labels = _graph(n)
  kw = dict(node_feat=feats, node_label=labels, num_nodes=n)
  return (JaxDistDataset.from_full_graph(P, rows, cols, **kw),
          DistDataset.from_full_graph(P, rows, cols, device='cpu', **kw),
          rows, cols)


def _assert_batch_equal(jb, tb, i, with_edge):
  for f in FIELDS + (('edge',) if with_edge else ()):
    a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
    assert a.dtype == b.dtype, (i, f, a.dtype, b.dtype)
    np.testing.assert_array_equal(b, a, err_msg=f'batch {i} {f}')
  if not with_edge:
    assert jb.edge is None and tb.edge is None
  assert set(jb.metadata) == set(tb.metadata) == {'seed_local', 'mapping'}
  for k in ('seed_local', 'mapping'):
    np.testing.assert_array_equal(tb.metadata[k].numpy(),
                                  np.asarray(jb.metadata[k]))


def _induced(batch, new2old, rows, cols, p):
  """The batch's induced edge set on partition ``p`` (input ids) and
  the brute-force set over its node table."""
  node = batch.node.numpy()[p]
  ok = node >= 0
  ei = batch.edge_index.numpy()[p]
  em = batch.edge_mask.numpy()[p]
  got = {(int(new2old[node[ei[0, i]]]), int(new2old[node[ei[1, i]]]))
         for i in np.nonzero(em)[0]}
  kept = set(new2old[node[ok]].tolist())
  want = {(u, v) for u, v in zip(rows.tolist(), cols.tolist())
          if u in kept and v in kept}
  return got, want


#: with_edge, hop_chunk, max_degree (None = the true max: exact)
CASES = {
    'exact': (False, None, None),
    'exact-edge': (True, None, None),
    'exact-edge-chunk8': (True, 8, None),
    'truncating': (False, None, 2),
    'truncating-edge-chunk8': (True, 8, 2),
}


@pytest.mark.parametrize('case', list(CASES))
def test_subgraph_loader_byte_equal_to_jax(monkeypatch, case):
  _clean_env(monkeypatch)
  with_edge, chunk, max_degree = CASES[case]
  jds, ds, rows, cols = _datasets()
  seeds = np.arange(N)
  kw = dict(batch_size=BATCH, shuffle=True, seed=0, with_edge=with_edge,
            hop_chunk=chunk, max_degree=max_degree)
  jl = JaxSubGraphLoader(jds, FANOUTS, seeds, mesh=jax_make_mesh(P), **kw)
  tl = DistSubGraphLoader(ds, FANOUTS, seeds, draws=jax_key_draws(0),
                          device='cpu', **kw)
  assert tl.sampler.exact_window == (max_degree is None)
  assert tl.sampler.max_degree == jl.sampler.max_degree
  jb = list(itertools.islice(iter(jl), BATCHES))
  tb = list(itertools.islice(iter(tl), BATCHES))
  for i, (a, b) in enumerate(zip(jb, tb)):
    _assert_batch_equal(a, b, i, with_edge)
  js = jl.sampler.exchange_stats(tick_metrics=False)
  ts = tl.sampler.exchange_stats(tick_metrics=False)
  for k in _exchange_keys(js):
    assert ts[k] == js[k], k
  assert ts['dist.frontier.offered'] > 0
  b = tb[0]
  e = b.edge.numpy() if with_edge else None
  for p in range(P):
    got, want = _induced(b, ds.new2old, rows, cols, p)
    if max_degree is None:
      assert got == want, (p, got ^ want)
    else:
      assert got <= want and len(got) < len(want), p
    if with_edge:
      em = b.edge_mask.numpy()[p]
      node, ei = b.node.numpy()[p], b.edge_index.numpy()[p]
      u = ds.new2old[node[ei[0, em]]]
      v = ds.new2old[node[ei[1, em]]]
      np.testing.assert_array_equal(rows[e[p, em]], u)
      np.testing.assert_array_equal(cols[e[p, em]], v)
      assert (e[p, ~em] == -1).all()


def test_hop_chunk_gives_the_same_subgraphs():
  """One exchange of the whole closure and chunks of 8 (and 'auto')
  give the same batches under the same draws."""
  _, ds, _, _ = _datasets()
  out = []
  for chunk in (None, 8, 'auto'):
    tl = DistSubGraphLoader(ds, FANOUTS, np.arange(64), batch_size=BATCH,
                            with_edge=True, hop_chunk=chunk,
                            draws=TorchDraws(3, 'cpu'), device='cpu')
    out.append([[t.numpy() for t in (b.node, b.edge_index, b.edge, b.x)]
                for b in tl])
  for other in out[1:]:
    for a, b in zip(out[0], other):
      for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_exact_window_takes_no_draw_and_equals_the_sampler():
  """The exact arm draws nothing (the loader's draw calls are the
  expansion's alone), and its window hop equals the uniform sampler's
  hop at ``k = max_degree`` under any draws: every row's degree is at
  most ``k``, so the sampler returns the CSR window whatever it
  draws."""
  _, ds, _, _ = _datasets()
  calls = []
  base = TorchDraws(5, 'cpu')

  def counting(*a, **kw):
    calls.append(a[1])
    return base(*a, **kw)
  tl = DistSubGraphLoader(ds, FANOUTS, np.arange(32), batch_size=BATCH,
                          draws=counting, device='cpu')
  n = len(list(tl))
  assert n == 2 and len(calls) == n * P * len(FANOUTS)
  assert sorted(set(calls)) == [0, 1]

  g = ds.graph
  mesh = make_mesh(P, device='cpu')
  bounds = torch.from_numpy(g.bounds)
  fr = torch.from_numpy(np.random.default_rng(0).integers(
      -1, N, (P, 24)).astype(np.int32))
  d = int((g.indptr[:, 1:] - g.indptr[:, :-1]).max())
  eids = g.edge_ids.to(torch.int32)
  win = tds_mod._dist_window_hop(mesh, g.indptr, g.indices, bounds, fr, d,
                                 None, eids_loc=eids)
  for seed in (1, 2):
    hop = tds_mod._dist_one_hop(mesh, g.indptr, g.indices, bounds, fr, d,
                                TorchDraws(seed, 'cpu'), 1, 0, None,
                                eids_loc=eids)
    for a, b in zip(win[:3], hop[:3]):
      assert torch.equal(a, b)
    assert torch.equal(win[3], hop[4])


def test_resolve_hop_chunk_matches_jax():
  for node_cap in (8, 1000, 4096, 1 << 16, 1 << 20, 3_000_003):
    for max_degree in (1, 7, 64, 255, 4096, 1 << 14, 1 << 20):
      for hc in ('auto', None, 16):
        assert resolve_hop_chunk(hc, node_cap, max_degree) == \
            jax_resolve_hop_chunk(hc, node_cap, max_degree), (
                hc, node_cap, max_degree)
  with pytest.raises(ValueError, match='hop_chunk'):
    resolve_hop_chunk('wide', 8, 8)


def test_refusals_and_cuda_default():
  jds, ds, _, _ = _datasets()
  for loader, kw in ((JaxSubGraphLoader, dict(mesh=jax_make_mesh(P))),
                     (DistSubGraphLoader, dict(device='cpu'))):
    with pytest.raises(ValueError, match='adaptive'):
      loader(jds if loader is JaxSubGraphLoader else ds, FANOUTS,
             np.arange(8), exchange_slack='adaptive', **kw)
  # a truncating width whose sampler window passes the kernel's cap
  rows = np.concatenate([np.zeros(40, np.int64), np.arange(1, 41)])
  cols = np.concatenate([np.arange(1, 41), np.zeros(40, np.int64)])
  hub = DistDataset.from_full_graph(P, rows, cols, num_nodes=41,
                                    device='cpu')
  with pytest.raises(ValueError, match='max_degree'):
    DistSubGraphLoader(hub, [2], np.arange(8), max_degree=33, device='cpu')
  assert DistSubGraphLoader(hub, [2], np.arange(8), max_degree=32,
                            device='cpu').sampler.max_degree == 32
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='CUDA'):
      DistSubGraphLoader(ds, FANOUTS, np.arange(8))
