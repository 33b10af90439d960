"""The port's mesh of P = 4 partitions (on the CPU) against the JAX
package's mesh engine on four devices of the virtual CPU mesh:
`DistNeighborLoader` batches and exchange counters (untiered at slack
``'auto'``, tiered at split 0.3 with the victim cache admitting, GNS on
and off), the `AdaptiveSlack` ladder over epochs, and the data-parallel
train and eval steps.

The port's loader replays the JAX loader's keys through its ``draws``
provider: ``fold_in(key(seed), step)`` -> ``fold_in(., hop)`` ->
``fold_in(., owner)`` -> ``split`` into the uniform and the window
stream, the owner being the partition that samples the rows.
Tolerances: batches, counters and ladder states byte-equal / exact;
logits, loss and parameters within 1e-5 (f32 matmuls and scatter-adds
reduce in another order in XLA:CPU than in torch, and JAX's gradient
mean is a collective).
"""
import itertools

import jax
import numpy as np
import optax
import pytest
import torch

from graphlearn_tpu.models import GraphSAGE as FlaxGraphSAGE
from graphlearn_tpu.models import create_train_state
from graphlearn_tpu.parallel import DistDataset as JaxDistDataset
from graphlearn_tpu.parallel import DistNeighborLoader as JaxLoader
from graphlearn_tpu.parallel import local_batch_piece
from graphlearn_tpu.parallel import make_dp_supervised_step as jax_dp_step
from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu.parallel import replicate
from graphlearn_tpu.parallel.dp import make_dp_eval_step as jax_dp_eval
from graphlearn_tpu_torch.models import GraphSAGE, graphsage_from_flax
from graphlearn_tpu_torch.parallel import (DistDataset, DistNeighborLoader,
                                           make_dp_eval_step,
                                           make_dp_supervised_step,
                                           make_mesh)
from graphlearn_tpu_torch.telemetry import live, recorder
from test_torch_dist_gns import (_batch_np, _clean_env, _graph, _numpy_tree,
                                 _port_np, jax_key_draws)

P = 4
FANOUTS = [3, 2]
BATCHES = 4
FIELDS = ('node', 'x', 'y', 'edge_index', 'edge_mask')


def _datasets(n, split, seed=0):
  rows, cols, feats, labels = _graph(n, seed=seed)
  kw = dict(node_feat=feats, node_label=labels, num_nodes=n,
            split_ratio=split)
  return (JaxDistDataset.from_full_graph(P, rows, cols, **kw),
          DistDataset.from_full_graph(P, rows, cols, device='cpu', **kw),
          feats, labels)


def _pair(jds, ds, seeds, fanouts=FANOUTS, **kw):
  jl = JaxLoader(jds, fanouts, seeds, mesh=jax_make_mesh(P), **kw)
  tl = DistNeighborLoader(ds, fanouts, seeds, draws=jax_key_draws(0),
                          device='cpu', **kw)
  return jl, tl


def _jax_np(b):
  return _batch_np(b, FIELDS + ('num_sampled_nodes',))


def _torch_np(b):
  return _port_np(b) | {'num_sampled_nodes': b.num_sampled_nodes.numpy()}


def _assert_batches_equal(jb, tb, gns):
  for i, (r, g) in enumerate(zip(jb, tb)):
    for f in FIELDS + ('num_sampled_nodes',):
      assert g[f].dtype == r[f].dtype, (i, f)
      np.testing.assert_array_equal(g[f], r[f], err_msg=f'batch {i} {f}')
    if gns:
      np.testing.assert_array_equal(g['edge_weight'], r['edge_weight'],
                                    err_msg=f'batch {i} edge_weight')
    else:
      assert g['edge_weight'] is None and r['edge_weight'] is None


def _exchange_keys(js):
  # the JAX package's `cold_hit_rate` is an alias of `cache_hit_rate`
  return [k for k in js if k.startswith(('dist.feature.', 'dist.frontier.'))
          and k != 'dist.feature.cold_hit_rate']


@pytest.mark.parametrize('split,gns', [(1.0, False), (0.3, True),
                                       (0.3, False)])
def test_loader_batches_and_counters_byte_equal_to_jax(monkeypatch, split,
                                                       gns):
  _clean_env(monkeypatch)
  n, bs = 400, 16
  jds, ds, feats, labels = _datasets(n, split)
  kw = dict(batch_size=bs, shuffle=True, seed=0, gns=gns)
  if split < 1.0:
    kw['cold_cache_rows'] = 24
  jl, tl = _pair(jds, ds, np.arange(n), **kw)
  assert tl.sampler.tiered == (split < 1.0) and tl.sampler.gns == gns
  assert tl.sampler.exchange_slack == jl.sampler.exchange_slack == 2.0
  jb = [_jax_np(b) for b in itertools.islice(iter(jl), BATCHES)]
  tb = []
  for b in itertools.islice(iter(tl), BATCHES):
    tb.append(_torch_np(b))
    assert b.x.shape[0] == b.node.shape[0] == P
  _assert_batches_equal(jb, tb, gns)
  for g in tb:                   # every valid row is its node's source row
    ok = g['node'] >= 0
    src = ds.new2old[g['node'][ok]]
    np.testing.assert_array_equal(g['x'][ok], feats[src])
    np.testing.assert_array_equal(g['y'][ok], labels[src])
    if gns:
      ew, em = g['edge_weight'], g['edge_mask']
      assert (ew[~em] == 0).all() and (ew[em] > 0).all()
  js = jl.sampler.exchange_stats(tick_metrics=False)
  ts = tl.sampler.exchange_stats()
  keys = _exchange_keys(js)
  assert len(keys) >= 12
  for k in keys:
    assert ts[k] == js[k], k
  assert ts['dist.frontier.offered'] > 0 and ts['dist.frontier.dropped'] == 0
  if split < 1.0:
    assert ts['dist.feature.cache_admits'] > 0
    assert ts['dist.feature.cache_hits'] > 0


def _ladder(ctl):
  return (ctl._idx, ctl._pinned, ctl._pin_reason, ctl._tightened_from)


def test_adaptive_slack_takes_the_jax_rungs(monkeypatch):
  """Both controllers walk the ladder the same way over 6 epochs: with
  the floor lowered to 0.75, drop-free epochs tighten 2.0 -> 1.5 ->
  1.25 -> 1.0 -> 0.75, where the hop-1 frontier (~75 ids an owner at
  fanout 6) overflows its cap of 72, so the walk widens back to 1.0 and
  pins on the reversal."""
  _clean_env(monkeypatch)
  monkeypatch.setenv('GLT_SLACK_FLOOR', '0.75')
  n, bs = 2000, 64
  jds, ds, _, _ = _datasets(n, 1.0, seed=5)
  seeds = np.random.default_rng(1).permutation(n)[:P * bs * 2]
  jl, tl = _pair(jds, ds, seeds, fanouts=[6, 4], batch_size=bs,
                 shuffle=True, seed=0, exchange_slack='adaptive')
  assert tl._adaptive.slack == jl._adaptive.slack == 2.0
  transitions = live.snapshot().get('dist.slack.transitions', 0)
  recorder.clear()
  recorder.enable()
  try:
    rungs = []
    for _ in range(6):
      jb = [_jax_np(b) for b in iter(jl)]
      tb = [_torch_np(b) for b in iter(tl)]
      _assert_batches_equal(jb, tb, False)
      assert _ladder(tl._adaptive) == _ladder(jl._adaptive)
      assert tl.sampler.exchange_slack == jl.sampler.exchange_slack
      rungs.append(tl._adaptive.slack)
  finally:
    recorder.disable()
  js = jl.sampler.exchange_stats(tick_metrics=False)
  ts = tl.sampler.exchange_stats()
  for k in _exchange_keys(js):
    assert ts[k] == js[k], k
  moves = [(e['from_slack'], e['to_slack'], e['reason'])
           for e in recorder.events('slack.transition')]
  # the slack each epoch ran at
  assert rungs == [2.0, 1.5, 1.25, 1.0, 0.75, 1.0]
  assert moves == [(2.0, 1.5, 'drop_free'), (1.5, 1.25, 'drop_free'),
                   (1.25, 1.0, 'drop_free'), (1.0, 0.75, 'drop_free'),
                   (0.75, 1.0, 'drops')]
  assert (live.snapshot()['dist.slack.transitions'] - transitions
          == len(moves))
  assert ts['dist.frontier.dropped'] > 0
  assert tl._adaptive._pinned and tl._adaptive._pin_reason == 'reversal'
  assert [e['pin_reason'] for e in recorder.events('slack.pinned')] == [
      'reversal']


def test_adaptive_slack_needs_shuffled_seeds():
  _, ds, _, _ = _datasets(80, 1.0)
  with pytest.raises(ValueError, match='shuffle=True'):
    DistNeighborLoader(ds, FANOUTS, np.arange(80), batch_size=4,
                       exchange_slack='adaptive', device='cpu')


def test_dp_train_and_eval_steps_match_jax(monkeypatch):
  """Two Adam(1e-3) steps of the DP step over stacked GNS batches leave
  loss and every parameter within 1e-5 of JAX's (the gradients are the
  mean over the 4 pieces); the eval step's counts are exact."""
  _clean_env(monkeypatch)
  n, bs = 400, 16
  jds, ds, feats, _ = _datasets(n, 0.3)
  jl, tl = _pair(jds, ds, np.arange(n), batch_size=bs, shuffle=True, seed=0,
                 cold_cache_rows=24, gns=True)
  jbatches = list(itertools.islice(iter(jl), 3))
  tbatches = list(itertools.islice(iter(tl), 3))
  fmodel = FlaxGraphSAGE(hidden_features=8, out_features=5, num_layers=2)
  tx = optax.adam(1e-3)
  state, _ = create_train_state(fmodel, jax.random.key(0),
                                local_batch_piece(jbatches[0], P), tx)
  model = GraphSAGE(feats.shape[1], 8, 5, num_layers=2)
  model.load_state_dict(graphsage_from_flax(_numpy_tree(state.params)))
  mesh = make_mesh(P, device='cpu')
  jmesh = jax_make_mesh(P)
  jstep = jax_dp_step(fmodel.apply, tx, bs, jmesh)
  jstate = replicate(state, jmesh)
  opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
  step = make_dp_supervised_step(model, opt, bs, mesh)
  for jb, tb in zip(jbatches[:2], tbatches[:2]):
    jstate, jloss, jcorrect = jstep(jstate, jb)
    loss, correct = step(tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    assert int(correct) == int(jcorrect)
  ref = graphsage_from_flax(_numpy_tree(jstate.params))
  for name, p in model.state_dict().items():
    np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=name)
  last = tbatches[2]
  with torch.no_grad():
    logits = model(last.x[1], last.edge_index[1], last.edge_mask[1])
  jlast = jax.tree_util.tree_map(lambda v: v[1], jbatches[2])
  jlogits = fmodel.apply(jstate.params, jlast.x, jlast.edge_index,
                         jlast.edge_mask)
  np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                             rtol=1e-5, atol=1e-5)
  jcorrect, jtotal = jax_dp_eval(fmodel.apply, bs, jmesh)(jstate.params,
                                                          jbatches[2])
  correct, total = make_dp_eval_step(model, bs, mesh)(last)
  assert (int(correct), int(total)) == (int(jcorrect), int(jtotal))
  assert int(total) == P * bs
