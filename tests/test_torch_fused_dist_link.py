"""`FusedDistLinkEpoch` at P = 4 partitions (on the CPU) against the JAX
package's on four devices of the virtual CPU mesh, against the port's
own per-batch loop (`DistLinkNeighborLoader` and
`make_dp_unsupervised_step`) at the same draws, and its refusals.

The port's epoch replays the JAX keys through its draws provider: the
hops' as `test_torch_fused_mesh.jax_epoch_draws` (``fold_in(key(seed),
epoch)``, eval ``fold_in(fold_in(key(seed), 0), 1)``, then step, hop,
owner), and the negatives' ``negatives(epoch, step, stream, trials, r,
high, part)`` as JAX's ``fold_in(fold_in(step key, part), 977)`` split
into the rows (stream 0) and the columns (stream 1).  Tolerances: losses
and parameters within 1e-5 of JAX's (f32 matmuls and scatter-adds reduce
in another order in XLA:CPU than in torch, and JAX's gradient mean is a
collective), `evaluate`'s AUC within 1e-6, exchange counters exact; the
per-batch loop equal to the epoch bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphlearn_tpu.models import GraphSAGE as FlaxGraphSAGE
from graphlearn_tpu.models import create_train_state
from graphlearn_tpu.parallel import DistDataset as JaxDistDataset
from graphlearn_tpu.parallel import DistLinkNeighborLoader as JaxLinkLoader
from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu.parallel import replicate
from graphlearn_tpu.parallel.fused import (
    FusedDistLinkEpoch as JaxFusedDistLinkEpoch)
from graphlearn_tpu_torch.models import GraphSAGE, graphsage_from_flax
from graphlearn_tpu_torch.parallel import (DistDataset,
                                           DistLinkNeighborLoader,
                                           FusedDistLinkEpoch,
                                           make_dp_unsupervised_step)
from test_torch_dist_gns import _clean_env, _graph, _numpy_tree
from test_torch_fused_mesh import jax_epoch_draws
from test_torch_mesh import _exchange_keys

P = 4
N = 300
FANOUTS = [3, 2]
BATCH = 8
PAIRS = 80                      # 3 steps of 4 x 8 edges, the last padded


def jax_link_epoch_draws(seed):
  """`jax_epoch_draws` plus the JAX fused link epoch's negative keys."""
  base = jax.random.key(seed)
  draws = jax_epoch_draws(seed)

  def negatives(epoch, step, stream, trials, r, high, part=None):
    key = (jax.random.fold_in(jax.random.fold_in(base, 0), 1) if epoch == 0
           else jax.random.fold_in(base, epoch))
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(key, step), part), 977)
    kr, kc = jax.random.split(key)
    return torch.from_numpy(np.array(jax.random.randint(
        kr if stream == 0 else kc, (trials, r), 0, high, dtype=jnp.int32)))
  draws.negatives = negatives
  return draws


def _data():
  rows, cols, feats, _ = _graph(N)
  kw = dict(node_feat=feats, num_nodes=N)
  return (JaxDistDataset.from_full_graph(P, rows, cols, **kw),
          DistDataset.from_full_graph(P, rows, cols, device='cpu', **kw),
          rows, cols, feats)


def _init(jds, rows, cols, feats, neg):
  """Flax GraphSAGE parameters from one JAX link batch, and the port's
  model loaded with them."""
  jl = JaxLinkLoader(jds, FANOUTS, (rows[:64], cols[:64]),
                     neg_sampling=neg, batch_size=BATCH,
                     mesh=jax_make_mesh(P))
  single = jax.tree_util.tree_map(lambda v: v[0], next(iter(jl)))
  fmodel = FlaxGraphSAGE(hidden_features=8, out_features=4, num_layers=2)
  tx = optax.adam(1e-3)
  state, apply_fn = create_train_state(fmodel, jax.random.key(0), single,
                                       tx)
  model = GraphSAGE(feats.shape[1], 8, 4, num_layers=2)
  model.load_state_dict(graphsage_from_flax(_numpy_tree(state.params)))
  return state, apply_fn, tx, model


def _params_close(model, params):
  ref = graphsage_from_flax(_numpy_tree(params))
  for name, p in model.state_dict().items():
    np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=name)


@pytest.mark.parametrize('mode', ['binary', 'triplet'])
def test_fused_dist_link_epoch_matches_jax(monkeypatch, mode):
  _clean_env(monkeypatch)
  neg = 'binary' if mode == 'binary' else ('triplet', 2)
  jds, ds, rows, cols, feats = _data()
  state, apply_fn, tx, model = _init(jds, rows, cols, feats, neg)
  jmesh = jax_make_mesh(P)
  train = (rows[:PAIRS], cols[:PAIRS])
  jf = JaxFusedDistLinkEpoch(jds, FANOUTS, train, apply_fn, tx,
                             batch_size=BATCH, neg_sampling=neg, mesh=jmesh,
                             seed=0)
  opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
  tf = FusedDistLinkEpoch(ds, FANOUTS, train, model, opt, batch_size=BATCH,
                          neg_sampling=neg, seed=0,
                          draws=jax_link_epoch_draws(0), device='cpu')
  assert len(tf) == len(jf) == 3
  jstate = replicate(state, jmesh)
  for _ in range(2):
    jstate, jstats = jf.run(jstate)
    stats = tf.run()
    np.testing.assert_allclose(stats.losses.numpy(),
                               np.asarray(jstats.losses), rtol=1e-5,
                               atol=1e-5)
    assert stats.seeds == jstats.seeds == PAIRS
  _params_close(model, jstate.params)
  if mode == 'binary':
    test = (rows[400:560], cols[400:560])
    auc = tf.evaluate(test)
    assert abs(auc - jf.evaluate(jstate.params, test)) <= 1e-6
    assert 0.0 < auc < 1.0
  else:
    with pytest.raises(ValueError, match='binary'):
      tf.evaluate((rows[:8], cols[:8]))
  js = jf.sampler.exchange_stats(tick_metrics=False)
  ts = tf.sampler.exchange_stats(tick_metrics=False)
  for k in _exchange_keys(js) + ['dist.negative.lost']:
    assert ts[k] == js[k], k
  assert ts['dist.frontier.offered'] > 0


class _LoaderDraws:
  """The per-batch loader's ``draws(step, ...)`` at a fused epoch's
  coordinates: loader step ``s`` (from 1) is step ``(s - 1) % steps``
  of epoch ``(s - 1) // steps + 1``."""

  def __init__(self, draws, steps):
    self.draws, self.steps = draws, steps

  def _at(self, step):
    return (step - 1) // self.steps + 1, (step - 1) % self.steps

  def __call__(self, step, hop, rows, k, w, gns=False, owner=0):
    return self.draws(*self._at(step), hop, rows, k, w, gns, owner)

  def negatives(self, step, stream, trials, r, high, part=None):
    return self.draws.negatives(*self._at(step), stream, trials, r, high,
                                part=part)


@pytest.mark.parametrize('remat', [False, True])
def test_fused_equals_the_per_batch_loop(monkeypatch, remat):
  """Two epochs of the fused epoch and of `DistLinkNeighborLoader` +
  `make_dp_unsupervised_step` at the same draws (the epoch's default
  generator draws): the same batches, so the same losses and
  parameters, bit for bit."""
  _clean_env(monkeypatch)
  _, ds, rows, cols, feats = _data()
  train = (rows[:PAIRS], cols[:PAIRS])
  models = [GraphSAGE(feats.shape[1], 8, 4, num_layers=2) for _ in range(2)]
  models[1].load_state_dict(models[0].state_dict())
  opts = [torch.optim.Adam(m.parameters(), lr=1e-3) for m in models]
  tf = FusedDistLinkEpoch(ds, FANOUTS, train, models[0], opts[0],
                          batch_size=BATCH, seed=3, remat=remat,
                          device='cpu')
  lo = DistLinkNeighborLoader(ds, FANOUTS, train, neg_sampling='binary',
                              batch_size=BATCH, shuffle=True, seed=3,
                              draws=_LoaderDraws(tf.draws, len(tf)),
                              device='cpu')
  step = make_dp_unsupervised_step(models[1], opts[1], lo.sampler.mesh)
  for _ in range(2):
    fused = tf.run().losses
    loop = torch.stack([step(b) for b in lo])
    assert torch.equal(fused, loop)
  for a, b in zip(models[0].parameters(), models[1].parameters()):
    assert torch.equal(a, b)
  assert (tf.sampler.exchange_stats(tick_metrics=False)
          == lo.sampler.exchange_stats(tick_metrics=False))


def test_refusals_and_cuda_default():
  _, ds, rows, cols, feats = _data()
  model = GraphSAGE(feats.shape[1], 8, 4, num_layers=2)
  opt = torch.optim.Adam(model.parameters())
  train = (rows[:PAIRS], cols[:PAIRS])
  with pytest.raises(ValueError, match='adaptive'):
    FusedDistLinkEpoch(ds, FANOUTS, train, model, opt, BATCH,
                       exchange_slack='adaptive', device='cpu')
  tiered = DistDataset.from_full_graph(P, rows, cols, node_feat=feats,
                                       num_nodes=N, split_ratio=0.5,
                                       device='cpu')
  with pytest.raises(NotImplementedError, match='tiered'):
    FusedDistLinkEpoch(tiered, FANOUTS, train, model, opt, BATCH,
                       device='cpu')
  bare = DistDataset.from_full_graph(P, rows, cols, num_nodes=N,
                                     device='cpu')
  with pytest.raises(ValueError, match='node features'):
    FusedDistLinkEpoch(bare, FANOUTS, train, model, opt, BATCH,
                       device='cpu')
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='CUDA'):
      FusedDistLinkEpoch(ds, FANOUTS, train, model, opt, BATCH)
