"""The port's heterogeneous mesh engine at P = 4 (on the CPU) against the
JAX package's on four devices of the virtual CPU mesh, on the IGBH
example's schema (`examples/igbh/train_rgnn.py::synthetic`, cut down):
`DistHeteroDataset.from_full_graph` untiered and tiered at 0.5,
`DistHeteroNeighborLoader` batches and exchange counters (list and
per-edge-type dict fanouts, untiered and tiered with the cold rows
overlaid, exact and dropping exchange slack), `local_piece` and the
RGNN example's model on `chip_smoke.union_graph` against its pieces,
the prefetching and adaptive-slack loaders, the refusals left, the CUDA
default and the homogeneous draws' digest (the DP step:
`test_torch_dist_hetero_dp.py`).

The port's loader replays the JAX loader's keys through its ``draws``
provider: ``fold_in(key(seed), step)`` -> ``fold_in(., hop)`` ->
``fold_in(., edge type)`` -> ``fold_in(., owner)`` -> ``split``
(`test_torch_dist_gns.jax_key_draws` with ``etype``).  Tolerances:
batches and counters byte-equal / exact; logits within 1e-5.
"""
import hashlib
import itertools

import numpy as np
import pytest
import torch

from examples.igbh.train_rgnn import P as PAPER
from examples.igbh.train_rgnn import synthetic
from graphlearn_tpu.parallel import DistHeteroDataset as JaxDataset
from graphlearn_tpu.parallel import DistHeteroNeighborLoader as JaxLoader
from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu_torch.loader import HeteroBatch
from graphlearn_tpu_torch.parallel import (DistDataset, DistHeteroDataset,
                                           DistHeteroNeighborLoader,
                                           DistNeighborLoader, TorchDraws,
                                           local_piece)
from test_torch_dist_gns import _graph, jax_key_draws
from test_torch_gat import chip_smoke

NP = 4
BATCHES = 3
SIZES = dict(npaper=240, nauthor=96, ninst=6, nfos=16, classes=4, d=8)


@pytest.fixture(scope='module')
def data():
  return synthetic(**SIZES)


def _datasets(data, split, **extra):
  edges, feats, nnodes, topic = data
  kw = dict(node_feat_dict=feats, node_label_dict={PAPER: topic},
            num_nodes_dict=nnodes, split_ratio=split, **extra)
  return (JaxDataset.from_full_graph(NP, edges, **kw),
          DistHeteroDataset.from_full_graph(NP, edges, device='cpu', **kw))


@pytest.mark.parametrize('split,book', [(1.0, False), (0.5, False),
                                        (0.5, True)])
def test_dataset_matches_jax(data, split, book):
  """``book``: an explicit partition book for the authors, the other
  types placed by the seeded round-robin."""
  pb = ({'author': (np.arange(SIZES['nauthor']) % 3).astype(np.int32)}
        if book else None)
  jds, ds = _datasets(data, split, node_pb_dict=pb)
  assert ds.etypes == jds.etypes and ds.ntypes == jds.ntypes
  assert ds.num_nodes_dict() == jds.num_nodes_dict()
  for nt in jds.ntypes:
    np.testing.assert_array_equal(ds.bounds[nt], jds.bounds[nt])
    np.testing.assert_array_equal(ds.old2new[nt], jds.old2new[nt])
    np.testing.assert_array_equal(ds.new2old[nt], jds.new2old[nt])
  for et in jds.etypes:
    g, jg = ds.graphs[et], jds.graphs[et]
    np.testing.assert_array_equal(g.bounds, jg.bounds)
    for a, b in ((g.indptr, jg.indptr), (g.indices, jg.indices),
                 (g.edge_ids, jg.edge_ids)):
      assert a.dtype == torch.from_numpy(np.asarray(b)).dtype, et
      np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=et)
  for nt, jf in jds.node_features.items():
    f = ds.node_features[nt]
    np.testing.assert_array_equal(f.shards.numpy(), np.asarray(jf.shards))
    np.testing.assert_array_equal(f.hot_counts, jf.hot_counts)
    assert f.is_tiered == jf.is_tiered == (split < 1)
    if split < 1:
      np.testing.assert_array_equal(f.cold_host.numpy(), jf.cold_host)
  np.testing.assert_array_equal(ds.node_labels[PAPER].numpy(),
                                np.asarray(jds.node_labels[PAPER]))


def _dict_fanout(jds):
  """Every edge type out of a paper at [3, 2], the rest at [2] (one
  hop: their hop-1 frontiers sample nothing), institute's out-edges
  left out."""
  return {et: ([3, 2] if et[0] == PAPER else [2]) for et in jds.etypes
          if et[0] != 'institute'}


#: split ratio, fanout kind, exchange slack and per-partition batch; the
#: tight case takes a graph and batch large enough for its hop-1 paper
#: frontiers and its node tables to pass the exchanges' 64-id floor and
#: drop ids
CASES = {
    'list-untiered-exact': (1.0, 'list', None, 16),
    'list-tiered-exact': (0.5, 'list', None, 16),
    'dict-tiered-tight': (0.5, 'dict', 0.75, 96),
    'dict-untiered-auto': (1.0, 'dict', 'auto', 16),
}
BIG = dict(npaper=1200, nauthor=480, ninst=12, nfos=32, classes=4, d=8)


def _batch_np(b, torch_side):
  conv = (lambda t: t.numpy()) if torch_side else np.asarray
  out = {}
  for f in ('x_dict', 'y_dict', 'node_dict', 'node_mask_dict',
            'edge_index_dict', 'edge_mask_dict', 'batch_dict'):
    for k, v in getattr(b, f).items():
      out[(f, k)] = conv(v)
  out['seed_local'] = conv(b.metadata['seed_local'])
  return out


@pytest.mark.parametrize('case', list(CASES))
def test_loader_batches_byte_equal_to_jax(data, case):
  split, fan_kind, slack, bs = CASES[case]
  if bs > 16:
    data = synthetic(**BIG)
  jds, ds = _datasets(data, split)
  fan = [3, 2] if fan_kind == 'list' else _dict_fanout(jds)
  seeds = (PAPER, np.arange(len(data[3])))
  kw = dict(batch_size=bs, shuffle=True, seed=0, exchange_slack=slack)
  jl = JaxLoader(jds, fan, seeds, mesh=jax_make_mesh(NP), **kw)
  tl = DistHeteroNeighborLoader(ds, fan, seeds, draws=jax_key_draws(0),
                                device='cpu', **kw)
  jb = [_batch_np(b, False) for b in itertools.islice(iter(jl), BATCHES)]
  tb = [_batch_np(b, True) for b in itertools.islice(iter(tl), BATCHES)]
  for i, (r, g) in enumerate(zip(jb, tb)):
    assert set(g) == set(r), (i, set(g) ^ set(r))
    for key in r:
      assert g[key].dtype == r[key].dtype, (i, key)
      np.testing.assert_array_equal(g[key], r[key], err_msg=f'{i} {key}')
  jst = jl.sampler.exchange_stats()
  st = tl.sampler.exchange_stats()
  names = [k for k in st if k.startswith('dist.')]
  assert {k: st[k] for k in names} == {k: jst[k] for k in names}
  if split < 1:
    assert st['dist.feature.cold_misses'] == st['dist.feature.cold_lookups']
    assert st['dist.feature.cold_misses'] > 0
    assert st['dist.feature.cache_hit_rate'] == 0.0
  if slack == 0.75:
    assert st['dist.frontier.dropped'] > 0
    assert st['dist.feature.dropped'] > 0


def test_local_piece_and_union_graph(data):
  """`local_piece` slices a stacked `HeteroBatch` key by key, and the
  RGNN on `chip_smoke.union_graph` (every partition at once) gives each
  partition's seed logits as the model on that partition's piece alone
  (within 1e-5)."""
  _, ds = _datasets(data, 1.0)
  tb = next(iter(DistHeteroNeighborLoader(
      ds, [3, 2], (PAPER, np.arange(SIZES['npaper'])), batch_size=16,
      shuffle=True, seed=0, device='cpu')))
  cs = chip_smoke()
  model = cs.rgnn_model(torch, ds.node_features, tuple(tb.edge_index_dict),
                        {nt: SIZES['d'] for nt in ds.node_features},
                        SIZES['classes'], 'rgat', hidden=16, heads=2)
  with torch.no_grad():
    union = cs.rgnn_seed_logits(torch, model, tb, 16)
    for p in range(NP):
      piece = local_piece(tb, p)
      assert type(piece) is HeteroBatch and piece.batch_size == 16
      for f in ('x_dict', 'y_dict', 'edge_index_dict', 'node_dict',
                'node_mask_dict', 'edge_mask_dict', 'batch_dict'):
        whole = getattr(tb, f)
        assert set(getattr(piece, f)) == set(whole)
        for k, v in getattr(piece, f).items():
          assert torch.equal(v, whole[k][p]), (f, k)
      assert torch.equal(piece.metadata['seed_local'],
                         tb.metadata['seed_local'][p])
      assert piece.metadata['input_type'] == PAPER
      alone = model(piece.x_dict, piece.edge_index_dict,
                    piece.edge_mask_dict)[:16]
      np.testing.assert_allclose(union[p].numpy(), alone.numpy(), rtol=1e-5,
                                 atol=1e-5)


#: sha256 of the homogeneous mesh loader's draws and batches below,
#: recorded before the draws gained their edge-type argument
HOMO_DIGEST = ('040aa349284eba2ed545fbdf94627306'
               '73a6fe16d53c57bf20f8f22f04ec501f')


def test_homo_mesh_draws_unchanged_by_etype():
  """The homogeneous mesh loader calls its draws without an edge type,
  and its draws and batches hash as before the argument existed."""
  rows, cols, feats, labels = _graph(200, seed=5)
  ds = DistDataset.from_full_graph(NP, rows, cols, node_feat=feats,
                                   node_label=labels, num_nodes=200,
                                   device='cpu')
  base = TorchDraws(3, 'cpu')
  h = hashlib.sha256()
  calls = []

  def draws(*a, **kw):
    calls.append(kw)
    out = base(*a, **kw)
    for t in out:
      h.update(t.numpy().tobytes())
    return out

  lo = DistNeighborLoader(ds, [3, 2], np.arange(200), batch_size=8,
                          shuffle=True, seed=1, draws=draws, device='cpu')
  for b in itertools.islice(iter(lo), 2):
    for t in (b.node, b.x, b.y, b.edge_index):
      h.update(t.numpy().tobytes())
  assert calls and all('etype' not in kw for kw in calls)
  assert h.hexdigest() == HOMO_DIGEST


def test_prefetch_and_adaptive_slack(data):
  """``prefetch=2`` yields the batches of ``prefetch=0`` (one worker
  draws in order); ``exchange_slack='adaptive'`` attaches the ladder,
  which retunes the sampler's slack between epochs."""
  _, ds = _datasets(data, 0.5)
  kw = dict(batch_size=16, shuffle=True, seed=3, draws=TorchDraws(1, 'cpu'),
            device='cpu')
  seeds = (PAPER, np.arange(SIZES['npaper']))
  plain = [_batch_np(b, True) for b in
           DistHeteroNeighborLoader(ds, [3, 2], seeds, **kw)]
  pre = DistHeteroNeighborLoader(ds, [3, 2], seeds, prefetch=2,
                                 **dict(kw, draws=TorchDraws(1, 'cpu')))
  fetched = [_batch_np(b, True) for b in pre]
  pre.close()
  assert len(plain) == len(fetched) == len(pre)
  for a, b in zip(plain, fetched):
    assert set(a) == set(b)
    for k in a:
      np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
  ada = DistHeteroNeighborLoader(ds, [3, 2], seeds, exchange_slack='adaptive',
                                 **kw)
  assert ada.sampler.exchange_slack == 2.0
  for _ in range(2):
    for _ in ada:
      pass
  assert ada.sampler.exchange_slack == ada._adaptive.slack < 2.0


def test_unported_options_raise(data):
  """The options still refused; edge features and ``with_edge`` are
  ported (`test_torch_dist_hetero_link.py`), as is the locality
  partitioner (`test_torch_locality.py`): it builds here."""
  edges, feats, nnodes, topic = data
  loc = DistHeteroDataset.from_full_graph(NP, edges, device='cpu',
                                          partitioner='locality')
  assert sum(int(b[-1]) for b in loc.bounds.values()) == sum(
      int(b[-1]) for b in DistHeteroDataset.from_full_graph(
          NP, edges, device='cpu').bounds.values())
  with pytest.raises(NotImplementedError, match='item 14'):
    DistHeteroDataset.from_partition_dir('/nonexistent')
  with pytest.raises(NotImplementedError, match='item 14'):
    DistHeteroDataset({}, {PAPER: [0, 1]}, device='cpu', host_parts=[0])
  _, ds = _datasets(data, 1.0)
  assert DistHeteroNeighborLoader(ds, [2], (PAPER, np.arange(8)),
                                  with_edge=True, device='cpu').sampler.with_edge


def test_hetero_mesh_entry_points_default_to_cuda(data):
  if torch.cuda.is_available():
    pytest.skip('the default device exists here')
  edges, feats, nnodes, topic = data
  with pytest.raises(RuntimeError, match='CUDA'):
    DistHeteroDataset.from_full_graph(NP, edges, node_feat_dict=feats)
  _, ds = _datasets(data, 1.0)
  with pytest.raises(RuntimeError, match='CUDA'):
    DistHeteroNeighborLoader(ds, [2], (PAPER, np.arange(8)))
