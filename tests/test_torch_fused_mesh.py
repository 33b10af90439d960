"""The fused mesh epochs, `FusedDistEpoch` and `FusedDistTreeEpoch`, at
P = 4 partitions (on the CPU) against the JAX package's on four devices
of the virtual CPU mesh, and `AdaptiveSlack`'s state against JAX's.

The port's epochs replay the JAX keys through their ``draws(epoch, step,
hop, rows, k, w, gns, owner)`` provider: ``fold_in(key(seed), epoch)``
(eval: ``fold_in(fold_in(key(seed), 0), 1)``) -> ``fold_in(., step)``
-> ``fold_in(., hop)`` -> ``fold_in(., owner)`` -> ``split`` into the
uniform and the window stream.  Tolerances: per-step losses and final
parameters within 1e-5 (f32 matmuls and scatter-adds reduce in another
order in XLA:CPU than in torch, and JAX's gradient mean is a
collective); exchange counters, correct and valid counts and `evaluate`
exact; ``remat=True`` against ``remat=False`` within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphlearn_tpu.models import GraphSAGE as FlaxGraphSAGE
from graphlearn_tpu.models import TreeSAGE as FlaxTreeSAGE
from graphlearn_tpu.models import create_train_state
from graphlearn_tpu.parallel import DistNeighborLoader as JaxLoader
from graphlearn_tpu.parallel import local_batch_piece
from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu.parallel import replicate
from graphlearn_tpu.parallel.dist_sampler import (
    AdaptiveSlack as JaxAdaptiveSlack)
from graphlearn_tpu.parallel.fused import (
    FusedDistEpoch as JaxFusedDistEpoch)
from graphlearn_tpu.parallel.fused import (
    FusedDistTreeEpoch as JaxFusedDistTreeEpoch)
from graphlearn_tpu_torch.models import (GraphSAGE, TreeSAGE,
                                         graphsage_from_flax,
                                         tree_sage_from_flax)
from graphlearn_tpu_torch.ops import CounterDraws, TorchDraws
from graphlearn_tpu_torch.parallel import (AdaptiveSlack, DistNeighborLoader,
                                           FusedDistEpoch, FusedDistTreeEpoch)
from graphlearn_tpu_torch.telemetry import recorder
from test_torch_dist_gns import _clean_env, _numpy_tree
from test_torch_mesh import _datasets, _exchange_keys

P = 4
FANOUTS = [3, 2]
N, BS, CLASSES = 400, 16, 5


def jax_epoch_draws(seed):
  """A draws provider that replays the JAX fused mesh epochs' keys."""
  base = jax.random.key(seed)

  def draws(epoch, step, hop, rows, k, w, gns=False, owner=0):
    key = (jax.random.fold_in(jax.random.fold_in(base, 0), 1) if epoch == 0
           else jax.random.fold_in(base, epoch))
    own = jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(key, step), hop), owner)
    k_rand, k_win = jax.random.split(own)
    u = jax.random.uniform(k_rand, (rows, k))
    v = (jax.random.uniform(k_win, (rows, k)) if gns else
         jax.random.gumbel(k_win, (rows, w), dtype=jnp.float32))
    return torch.from_numpy(np.array(u)), torch.from_numpy(np.array(v))
  return draws


def _params_close(model, params, from_flax):
  ref = from_flax(_numpy_tree(params))
  for name, p in model.state_dict().items():
    np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=name)


def _stats_equal(ts, js):
  keys = _exchange_keys(js)
  assert len(keys) >= 6
  for k in keys:
    assert ts[k] == js[k], k


def test_fused_dist_epoch_matches_jax(monkeypatch):
  _clean_env(monkeypatch)
  jds, ds, feats, _ = _datasets(N, 1.0)
  train, test = np.arange(0, 300), np.arange(300, 400)
  jmesh = jax_make_mesh(P)
  batch = next(iter(JaxLoader(jds, FANOUTS, train, batch_size=BS,
                              mesh=jmesh)))
  fmodel = FlaxGraphSAGE(hidden_features=8, out_features=CLASSES,
                         num_layers=2)
  tx = optax.adam(3e-3)
  state, apply_fn = create_train_state(fmodel, jax.random.key(0),
                                       local_batch_piece(batch, P), tx)
  model = GraphSAGE(feats.shape[1], 8, CLASSES, num_layers=2)
  model.load_state_dict(graphsage_from_flax(_numpy_tree(state.params)))
  opt = torch.optim.Adam(model.parameters(), lr=3e-3, eps=1e-8)
  jf = JaxFusedDistEpoch(jds, FANOUTS, train, apply_fn, tx, batch_size=BS,
                         mesh=jmesh, seed=0)
  tf = FusedDistEpoch(ds, FANOUTS, train, model, opt, batch_size=BS,
                      seed=0, draws=jax_epoch_draws(0), device='cpu')
  assert len(tf) == len(jf) == 5                 # 300 seeds, 64 a step
  jstate = replicate(state, jmesh)
  for _ in range(2):
    jstate, jstats = jf.run(jstate)
    stats = tf.run()
    np.testing.assert_allclose(stats.losses.numpy(),
                               np.asarray(jstats.losses), rtol=1e-5,
                               atol=1e-5)
    assert (stats.correct, stats.seeds) == (jstats.correct, jstats.seeds)
  assert stats.seeds == 300
  _params_close(model, jstate.params, graphsage_from_flax)
  assert tf.evaluate(test) == jf.evaluate(jstate.params, test)
  ts = tf.sampler.exchange_stats()
  _stats_equal(ts, jf.sampler.exchange_stats(tick_metrics=False))
  assert ts['dist.frontier.offered'] > 0

  # the per-batch loader at the same keys counts the same exchanges:
  # its step s (from 1) is the epochs' step (s - 1) % 5 of epoch
  # (s - 1) // 5 + 1
  lo = DistNeighborLoader(
      ds, FANOUTS, train, batch_size=BS, shuffle=True, seed=0,
      draws=lambda step, *a, **kw: jax_epoch_draws(0)(
          (step - 1) // 5 + 1, (step - 1) % 5, *a, **kw),
      device='cpu')
  for _ in range(2):
    for _ in lo:
      pass
  # evaluation keeps the epoch's (shuffled) slack
  eval_lo = DistNeighborLoader(
      ds, FANOUTS, test, batch_size=BS, shuffle=False, exchange_slack=2.0,
      draws=lambda step, *a, **kw: jax_epoch_draws(0)(0, step - 1, *a,
                                                      **kw),
      device='cpu')
  for _ in eval_lo:
    pass
  ls = lo.sampler.exchange_stats(tick_metrics=False)
  es = eval_lo.sampler.exchange_stats(tick_metrics=False)
  for k in _exchange_keys(ts):
    if k.endswith(('offered', 'dropped', 'slots')):
      assert ts[k] == ls[k] + es[k], k


def test_fused_dist_tree_epoch_matches_jax(monkeypatch):
  _clean_env(monkeypatch)
  jds, ds, feats, _ = _datasets(N, 1.0, seed=1)
  train, test = np.arange(0, 280), np.arange(280, 400)
  jmesh = jax_make_mesh(P)
  tx = optax.adam(3e-3)
  jf = JaxFusedDistTreeEpoch(
      jds, FANOUTS, train,
      FlaxTreeSAGE(hidden_features=8, out_features=CLASSES, num_layers=2),
      tx, batch_size=BS, mesh=jmesh, seed=0)
  jstate = jf.init_state(jax.random.key(0))
  model = TreeSAGE(feats.shape[1], 8, CLASSES, num_layers=2)
  model.load_state_dict(tree_sage_from_flax(_numpy_tree(jstate.params)))
  opt = torch.optim.Adam(model.parameters(), lr=3e-3, eps=1e-8)
  tf = FusedDistTreeEpoch(ds, FANOUTS, train, model, opt, batch_size=BS,
                          seed=0, draws=jax_epoch_draws(0), device='cpu')
  assert len(tf) == len(jf) == 5                 # the last step padded
  recorder.clear()
  recorder.enable()
  try:
    for _ in range(2):
      jstate, jstats = jf.run(jstate)
      stats = tf.run()
      np.testing.assert_allclose(stats.losses.numpy(),
                                 np.asarray(jstats.losses), rtol=1e-5,
                                 atol=1e-5)
      assert (stats.correct, stats.seeds) == (jstats.correct, jstats.seeds)
    hops = [e for e in recorder.events('hop.padding')
            if e.get('scope') == 'FusedDistTreeEpoch']
  finally:
    recorder.disable()
  assert stats.seeds == 280
  assert {int(s['step']) for s in opt.state.values()} == {10}
  _params_close(model, jstate.params, tree_sage_from_flax)
  assert tf.evaluate(test) == jf.evaluate(jstate.params, test)
  _stats_equal(tf.sampler.exchange_stats(),
               jf.sampler.exchange_stats(tick_metrics=False))
  # one event a level per epoch; the seed level holds every valid seed
  assert [e['hop'] for e in hops] == [0, 1, 2] * 2
  assert hops[0]['nodes'] == 280 and hops[0]['capacity'] == 5 * P * BS


def test_fused_mesh_epochs_contract(monkeypatch):
  _clean_env(monkeypatch)
  _, ds, feats, _ = _datasets(120, 1.0)
  model = TreeSAGE(feats.shape[1], 8, CLASSES, num_layers=2)
  model.reset_parameters(torch.Generator().manual_seed(0))
  opt = torch.optim.Adam(model.parameters(), lr=3e-3)
  for cls in (FusedDistEpoch, FusedDistTreeEpoch):
    with pytest.raises(ValueError, match="'adaptive'"):
      cls(ds, FANOUTS, np.arange(120), model, opt, 4,
          exchange_slack='adaptive', device='cpu')
  with pytest.raises(ValueError, match='num_layers'):
    FusedDistTreeEpoch(ds, [3, 2, 2], np.arange(120), model, opt, 4,
                       device='cpu')
  _, tiered, _, _ = _datasets(120, 0.5)
  for cls in (FusedDistEpoch, FusedDistTreeEpoch):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
      cls(tiered, FANOUTS, np.arange(120), model, opt, 4, device='cpu')
  # the default draws: finite losses, training moves the weights, and
  # the exchanges count
  before = model.layer0_self.weight.detach().clone()
  tf = FusedDistTreeEpoch(ds, FANOUTS, np.arange(120), model, opt, 4,
                          seed=3, device='cpu')
  stats = tf.run()
  assert stats.losses.shape == (8,) and np.isfinite(stats.loss)
  assert not torch.equal(before, model.layer0_self.weight)
  assert 0.0 <= tf.evaluate(np.arange(60)) <= 1.0
  assert tf.cluster_exchange_stats()['dist.frontier.offered'] > 0


@pytest.mark.parametrize('cls,model_cls', [
    (FusedDistEpoch, GraphSAGE), (FusedDistTreeEpoch, TreeSAGE)])
def test_fused_mesh_default_draws_are_generator_draws(monkeypatch, cls,
                                                      model_cls):
  """The mesh epochs run eagerly, so by default they draw as the
  per-batch loader does, from `TorchDraws` at coordinates ``(epoch,
  step, hop, owner)``: the same losses and parameters, bitwise, as that
  provider passed in, and other losses than the counter hash gives."""
  _clean_env(monkeypatch)
  _, ds, feats, _ = _datasets(120, 1.0)
  gen = TorchDraws(1, 'cpu')
  cd = CounterDraws(1, 'cpu')
  providers = (None,
               lambda e, s, h, r, k, w, gns=False, owner=0: gen.draw(
                   (e, s, h, owner), r, k, w, gns),
               lambda e, s, h, r, k, w, gns=False, owner=0: cd.draw(
                   (e, s, h, owner), r, k, w, gns))
  runs = []
  for draws in providers:
    model = model_cls(feats.shape[1], 8, CLASSES, num_layers=2)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    fused = cls(ds, FANOUTS, np.arange(120), model, opt, 4, seed=1,
                draws=draws, device='cpu')
    runs.append((fused.run().losses,
                 [p.detach().clone() for p in model.parameters()]))
  (l0, p0), (l1, p1), (l2, _) = runs
  assert torch.equal(l0, l1)
  assert all(torch.equal(a, b) for a, b in zip(p0, p1))
  assert not torch.equal(l0, l2)


@pytest.mark.parametrize('cls,model_cls', [
    (FusedDistEpoch, GraphSAGE), (FusedDistTreeEpoch, TreeSAGE)])
def test_fused_mesh_remat_equals_plain_forward(monkeypatch, cls, model_cls):
  """``remat=True`` recomputes the same forward on the CPU: losses and
  parameters within 1e-6 of ``remat=False``."""
  _clean_env(monkeypatch)
  _, ds, feats, _ = _datasets(120, 1.0)
  runs = []
  for remat in (False, True):
    model = model_cls(feats.shape[1], 8, CLASSES, num_layers=2)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    fused = cls(ds, FANOUTS, np.arange(120), model, opt, 4, seed=1,
                remat=remat, device='cpu')
    runs.append((fused.run().losses.numpy(),
                 [p.detach().clone() for p in model.parameters()]))
  (l0, p0), (l1, p1) = runs
  np.testing.assert_allclose(l1, l0, rtol=1e-6, atol=1e-6)
  for a, b in zip(p1, p0):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_adaptive_slack_state_round_trip(monkeypatch):
  """The ladder's position goes through ``state_dict`` with JAX's
  fields and values, and a restored controller sits on the same rung,
  pin and tighten origin, and sets its sampler's slack."""
  _clean_env(monkeypatch)
  jds, ds, _, _ = _datasets(200, 1.0)
  jlo = JaxLoader(jds, FANOUTS, np.arange(200), batch_size=8, shuffle=True,
                  mesh=jax_make_mesh(P), exchange_slack='adaptive')
  tlo = DistNeighborLoader(ds, FANOUTS, np.arange(200), batch_size=8,
                           shuffle=True, exchange_slack='adaptive',
                           device='cpu')
  jctl = JaxAdaptiveSlack(jlo.sampler)
  tctl = AdaptiveSlack(tlo.sampler)
  for ctl in (jctl, tctl):
    ctl._set(2, reason='test')
    ctl._tightened_from = 3
    ctl._pin('reversal', 0.5)
  js, ts = jctl.state_dict(), tctl.state_dict()
  assert set(ts) == set(js) == {'idx', 'pinned', 'pin_reason',
                                'tightened_from'}
  for k in js:
    assert ts[k] == js[k], k
  fresh = AdaptiveSlack(DistNeighborLoader(
      ds, FANOUTS, np.arange(200), batch_size=8, shuffle=True,
      exchange_slack='adaptive', device='cpu').sampler)
  fresh.load_state_dict({k: np.asarray(v) for k, v in js.items()})
  assert fresh.state_dict() == ts
  assert fresh.sampler.exchange_slack == fresh.slack == 1.25
  fresh.load_state_dict({**ts, 'tightened_from': -1, 'pinned': 0})
  assert fresh._tightened_from is None and not fresh._pinned
