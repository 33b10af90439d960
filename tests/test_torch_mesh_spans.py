"""The mesh loader's spans: the port's `DistNeighborLoader` at P = 8 on
the CPU against the JAX package's on the 8-device virtual CPU mesh, the
JAX loader's keys replayed.

With each package's recorder on, every batch records one ``batch`` root
with ``sample.exchange`` under it (``exchange.layout`` before it on a
configuration's first dispatch, and again after the adaptive slack moved),
``feature.lookup`` for a tiered store's cold overlay, and ``stitch``: the
span names and the parent structure of each batch are equal in both
packages, untiered at adaptive slack and tiered through the pipelined
cold overlay.  The port's batches are byte-equal with the recorder on and
off, and equal to JAX's.  The link and subgraph loaders and the random
walker take the same spans where JAX has them.
"""
import numpy as np
import pytest

from graphlearn_tpu.parallel import DistDataset as JaxDistDataset
from graphlearn_tpu.parallel import DistNeighborLoader as JaxLoader
from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu.telemetry import recorder as jax_recorder
from graphlearn_tpu_torch.parallel import (DistDataset, DistNeighborLoader,
                                           DistSubGraphLoader, make_mesh)
from graphlearn_tpu_torch.telemetry import recorder
from test_torch_dist_gns import _clean_env, _graph, jax_key_draws
from test_torch_mesh import _assert_batches_equal, _jax_np, _torch_np

P = 8
FANOUTS = [3, 2]
N = 1600
BATCH = 16


def _datasets(split):
  rows, cols, feats, labels = _graph(N, seed=2)
  kw = dict(node_feat=feats, node_label=labels, num_nodes=N,
            split_ratio=split)
  return (JaxDistDataset.from_full_graph(P, rows, cols, **kw),
          DistDataset.from_full_graph(P, rows, cols, device='cpu', **kw))


def _trees(events):
  """Per batch root, in order: the sorted (name, parent name) pairs of
  every span in its trace."""
  ends = [e for e in events if e['kind'] == 'span.end']
  names = {e['span_id']: e['name'] for e in ends}
  roots = [e for e in ends if e['name'] == 'batch']
  roots.sort(key=lambda e: e['mono'])
  out = []
  for r in roots:
    tree = sorted((e['name'], names.get(e['parent_id']))
                  for e in ends if e['trace_id'] == r['trace_id'])
    out.append(tree)
  return out


def _run(loader, rec, epochs, as_np):
  rec.enable()
  rec.clear()
  try:
    batches = [as_np(b) for _ in range(epochs) for b in iter(loader)]
    return batches, _trees(rec.events())
  finally:
    rec.clear()
    rec.disable()


@pytest.mark.parametrize('split,slack', [(1.0, 'adaptive'), (0.3, 'auto')],
                         ids=['untiered-adaptive', 'tiered'])
def test_span_trees_equal_to_jax(monkeypatch, split, slack):
  _clean_env(monkeypatch)
  jds, ds = _datasets(split)
  seeds = np.random.default_rng(1).permutation(N)[:P * BATCH * 2]
  kw = dict(batch_size=BATCH, shuffle=True, seed=0, exchange_slack=slack,
            cold_cache_rows=24)
  jl = JaxLoader(jds, FANOUTS, seeds, mesh=jax_make_mesh(P), **kw)
  tl = DistNeighborLoader(ds, FANOUTS, seeds, draws=jax_key_draws(0),
                          device='cpu', **kw)
  jb, jtrees = _run(jl, jax_recorder, 3, _jax_np)
  tb, ttrees = _run(tl, recorder, 3, _torch_np)
  _assert_batches_equal(jb, tb, False)
  assert len(ttrees) == len(jtrees) == 6
  assert ttrees == jtrees
  first = dict.fromkeys(n for n, _ in ttrees[0])
  assert ('exchange.layout', 'batch') in ttrees[0]
  assert ('sample.exchange', 'batch') in ttrees[0]
  assert ('stitch', 'batch') in ttrees[0]
  assert (('feature.lookup', 'batch') in ttrees[0]) == (split < 1.0)
  assert 'exchange.layout' in first
  assert all(('exchange.layout', 'batch') not in t for t in ttrees[1:2])


def test_batches_byte_equal_with_recorder_on_and_off(monkeypatch):
  _clean_env(monkeypatch)
  _, ds = _datasets(0.3)
  seeds = np.random.default_rng(1).permutation(N)[:P * BATCH * 2]
  out = []
  for on in (False, True):
    loader = DistNeighborLoader(ds, FANOUTS, seeds, batch_size=BATCH,
                                shuffle=True, seed=0, cold_cache_rows=24,
                                draws=jax_key_draws(0), device='cpu')
    if on:
      batches, trees = _run(loader, recorder, 2, _torch_np)
      assert len(trees) == 4
    else:
      batches = [_torch_np(b) for _ in range(2) for b in iter(loader)]
    out.append(batches)
  for off, on in zip(*out):
    for f in off:
      if off[f] is None:
        assert on[f] is None
      else:
        assert off[f].tobytes() == on[f].tobytes(), f


def test_subgraph_loader_and_walker_spans():
  _, ds = _datasets(1.0)
  recorder.enable()
  recorder.clear()
  try:
    sub = DistSubGraphLoader(ds, [2], np.arange(P * 4), batch_size=4,
                             device='cpu')
    for _ in iter(sub):
      pass
    trees = _trees(recorder.events())
    assert trees == [sorted([('batch', None), ('exchange.layout', 'batch'),
                             ('sample.exchange', 'batch'),
                             ('stitch', 'batch')])]
    from graphlearn_tpu_torch.parallel import (DistLinkNeighborLoader,
                                               DistRandomWalker)
    recorder.clear()
    rng = np.random.default_rng(3)
    pairs = rng.integers(0, N, (2, P * 4))
    link = DistLinkNeighborLoader(ds, [2], pairs, neg_sampling='binary',
                                  batch_size=4, device='cpu')
    for _ in iter(link):
      pass
    assert _trees(recorder.events()) == [sorted([
        ('batch', None), ('exchange.layout', 'batch'),
        ('sample.exchange', 'batch'), ('stitch', 'batch')])]
    modes = {e['name']: e.get('mode') for e in recorder.events('span.end')}
    assert modes['exchange.layout'] == modes['sample.exchange'] == 'link'
    recorder.clear()
    walker = DistRandomWalker(ds, 3, device='cpu', mesh=make_mesh(
        P, device='cpu'))
    walker.walk(np.arange(P * 2).reshape(P, 2))
    walker.walk(np.arange(P * 2).reshape(P, 2))
    layout = [e for e in recorder.events('span.end')
              if e['name'] == 'exchange.layout']
    assert len(layout) == 1 and layout[0]['mode'] == 'walk'
  finally:
    recorder.clear()
    recorder.disable()


def _fused_trees(events):
  """``fused.epoch`` roots with their children's names, in order."""
  ends = [e for e in events if e['kind'] == 'span.end']
  names = {e['span_id']: e['name'] for e in ends}
  return [sorted((e['name'], names.get(e['parent_id'])) for e in ends
                 if e['trace_id'] == r['trace_id'])
          for r in ends if r['name'] == 'fused.epoch']


def test_fused_epoch_spans_equal_to_jax():
  """`FusedEpoch` in chunks of 2 over 5 steps: one ``fused.epoch`` root
  with one ``fused.dispatch`` a chunk, in both packages."""
  import optax
  from graphlearn_tpu.loader import FusedEpoch as JaxFusedEpoch
  from test_torch_fused import _datasets as fused_datasets
  from test_torch_fused import _jax_state, _port
  jds, ds = fused_datasets()
  train = np.random.default_rng(1).permutation(300)[:72]
  tx = optax.adam(3e-3)
  state, apply_fn = _jax_state(jds, tx)
  _, _, tf = _port(ds, state.params, train)
  jf = JaxFusedEpoch(jds, [3, 2], train, apply_fn, tx, batch_size=16,
                     shuffle=True, seed=0, max_steps_per_program=2)
  trees = []
  for rec, run in ((jax_recorder, lambda: jf.run(state)),
                   (recorder, tf.run)):
    rec.enable()
    rec.clear()
    try:
      run()
      trees.append(_fused_trees(rec.events()))
    finally:
      rec.clear()
      rec.disable()
  assert trees[0] == trees[1]
  assert trees[1] == [sorted([('fused.epoch', None)]
                             + [('fused.dispatch', 'fused.epoch')] * 3)]


def test_fused_mesh_epoch_spans():
  """`FusedDistEpoch` (one chunk: one dispatch span over its steps)."""
  import torch
  from graphlearn_tpu_torch.models import GraphSAGE
  from graphlearn_tpu_torch.parallel import FusedDistEpoch
  _, ds = _datasets(1.0)
  model = GraphSAGE(6, 8, 5, num_layers=2)
  opt = torch.optim.Adam(model.parameters(), lr=3e-3)
  fused = FusedDistEpoch(ds, FANOUTS, np.arange(P * BATCH * 2), model, opt,
                         batch_size=BATCH, seed=0, device='cpu')
  recorder.enable()
  recorder.clear()
  try:
    fused.run()
    events = recorder.events()
  finally:
    recorder.clear()
    recorder.disable()
  assert _fused_trees(events) == [sorted([('fused.epoch', None),
                                          ('fused.dispatch', 'fused.epoch')])]
  assert len([e for e in events if e['kind'] == 'hop.padding']) == 3
