"""`FusedHeteroEpoch` against the JAX package's.

One epoch of 5 steps in chunks of 2 (``max_steps_per_program=2``: the
chunk keys and a padded tail step are exercised) with `RGCN` from the
same Flax parameters, then `evaluate` over a 3-batch split.  The port's
epoch replays the JAX keys through its ``draws(epoch, chunk, step, hop,
rows, k, w, etype)`` provider: ``fold_in(key(seed), epoch)`` (eval:
``fold_in(fold_in(key(seed), 0), 1)``), then ``fold_in(., chunk)`` when
the epoch has more than one chunk, ``fold_in(., step)``, ``fold_in(.,
hop)``, ``fold_in(., etype)`` (the edge type's index in the sorted edge
types) and ``split`` into the uniform and the Gumbel stream.

Tolerances: per-step losses and final parameters within 1e-5 (f32
matmuls and scatter-adds reduce in another order in XLA:CPU than in
torch); correct and valid counts, Adam's step count and eval accuracy
equal; ``remat=True`` against ``remat=False`` within 1e-6 (the CPU
recomputes the same forward).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphlearn_tpu.loader import FusedHeteroEpoch as JaxFusedHeteroEpoch
from graphlearn_tpu.loader import NeighborLoader as JaxLoader
from graphlearn_tpu.models import RGCN as FlaxRGCN
from graphlearn_tpu.models.train import TrainState
from graphlearn_tpu_torch.data import Dataset
from graphlearn_tpu_torch.loader import FusedHeteroEpoch
from graphlearn_tpu_torch.models import RGCN, rgcn_from_flax
from graphlearn_tpu_torch.ops import gather_rows_plain, sample_one_hop
from graphlearn_tpu_torch.typing import reverse_edge_type
# _clean_env is an autouse fixture: importing it applies it here too
from test_torch_hetero import _clean_env  # noqa: F401
from test_torch_hetero import CLASSES, NNODES, P, D, datasets

FANOUTS = [3, 2]
BATCH, HIDDEN = 16, 8


def jax_hetero_epoch_draws(seed):
  """A draws provider that replays the JAX `FusedHeteroEpoch`'s keys."""
  base = jax.random.key(seed)

  def draws(epoch, chunk, step, hop, rows, k, w, etype):
    key = (jax.random.fold_in(jax.random.fold_in(base, 0), 1) if epoch == 0
           else jax.random.fold_in(base, epoch))
    if chunk is not None:
      key = jax.random.fold_in(key, chunk)
    for c in (step, hop, etype):
      key = jax.random.fold_in(key, c)
    k_rand, k_win = jax.random.split(key)
    u = jax.random.uniform(k_rand, (rows, k))
    g = jax.random.gumbel(k_win, (rows, w), dtype=jnp.float32)
    return torch.from_numpy(np.array(u)), torch.from_numpy(np.array(g))
  return draws


def _flax_params(jds, etypes):
  batch = next(iter(JaxLoader(jds, FANOUTS, (P, np.arange(BATCH)),
                              batch_size=BATCH)))
  fmodel = FlaxRGCN(etypes=etypes, hidden_features=HIDDEN,
                    out_features=CLASSES, num_layers=2, target_ntype=P)
  params = fmodel.init(jax.random.key(0), batch.x_dict,
                       batch.edge_index_dict, batch.edge_mask_dict)
  return fmodel, params


def _port(ds, etypes, params, train, remat=False, **kw):
  model = RGCN(etypes, D, HIDDEN, CLASSES, num_layers=2, target_ntype=P)
  model.load_state_dict(rgcn_from_flax(
      jax.tree_util.tree_map(np.asarray, params)))
  opt = torch.optim.Adam(model.parameters(), lr=1e-2, eps=1e-8)
  fused = FusedHeteroEpoch(ds, FANOUTS, (P, train), model, opt,
                           batch_size=BATCH, shuffle=True, seed=0,
                           max_steps_per_program=2, remat=remat,
                           draws=jax_hetero_epoch_draws(0), device='cpu',
                           **kw)
  return model, opt, fused


def _etypes(ds):
  return tuple(sorted(reverse_edge_type(et) for et in ds.get_edge_types()))


def test_fused_hetero_epoch_matches_jax():
  jds, ds, _, _ = datasets(seed=3)
  idx = np.random.default_rng(1).permutation(NNODES[P])
  train, test = idx[:72], idx[72:112]           # 5 steps; 3 eval batches
  etypes = _etypes(ds)
  fmodel, params = _flax_params(jds, etypes)
  tx = optax.adam(1e-2)
  state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
  model, opt, tf = _port(ds, etypes, params, train)
  jf = JaxFusedHeteroEpoch(jds, FANOUTS, (P, train), fmodel.apply, tx,
                           batch_size=BATCH, shuffle=True, seed=0,
                           max_steps_per_program=2)
  assert len(tf) == len(jf) == 5

  sample_one_hop.calls = gather_rows_plain.calls = 0
  state, jstats = jf.run(state)
  stats = tf.run()
  # 5 real steps of 3 chunks; the padded sixth step ran nothing.  A step
  # samples 2 edge types at hop 0 and 4 at hop 1 and gathers 3 types.
  assert stats.losses.shape == (5,) == np.asarray(jstats.losses).shape
  assert (sample_one_hop.calls, gather_rows_plain.calls) == (5 * 6, 5 * 3)
  np.testing.assert_allclose(stats.losses.numpy(),
                             np.asarray(jstats.losses), rtol=1e-5,
                             atol=1e-5)
  assert (stats.correct, stats.seeds) == (jstats.correct, jstats.seeds)
  assert stats.seeds == 72
  assert int(state.step) == 5
  assert {int(s['step']) for s in opt.state.values()} == {5}
  ref = rgcn_from_flax(jax.tree_util.tree_map(np.asarray, state.params))
  for name, p in model.state_dict().items():
    np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=name)
  assert tf.evaluate(test) == jf.evaluate(state.params, test)
  assert tf.compile_count() == 0               # the CPU captures nothing


def test_remat_equals_plain_forward():
  jds, ds, _, _ = datasets(seed=4)
  etypes = _etypes(ds)
  _, params = _flax_params(jds, etypes)
  runs = []
  for remat in (False, True):
    model, _, fused = _port(ds, etypes, params, np.arange(72), remat=remat)
    runs.append((fused.run().losses.numpy(),
                 {k: v.clone() for k, v in model.state_dict().items()},
                 fused.evaluate(np.arange(72, 112))))
  (l0, p0, a0), (l1, p1, a1) = runs
  np.testing.assert_allclose(l1, l0, rtol=1e-6, atol=1e-6)
  for name in p0:
    np.testing.assert_allclose(p1[name].numpy(), p0[name].numpy(),
                               rtol=1e-6, atol=1e-6, err_msg=name)
  assert a1 == a0


def test_fused_hetero_epoch_refuses_what_jax_refuses():
  """The refusals of the JAX package's `test_fused_hetero_epoch.py:130`,
  and the missing labels of the seed type."""
  _, ds, _, _ = datasets()
  _, tiered, _, _ = datasets(split_ratio=0.5)
  etypes = _etypes(ds)
  model = RGCN(etypes, D, HIDDEN, CLASSES, target_ntype=P)
  opt = torch.optim.Adam(model.parameters(), lr=1e-2)
  with pytest.raises(ValueError, match='split_ratio'):
    FusedHeteroEpoch(tiered, FANOUTS, (P, np.arange(48)), model, opt, 16,
                     device='cpu')
  with pytest.raises(ValueError, match='node_type'):
    FusedHeteroEpoch(ds, FANOUTS, np.arange(48), model, opt, 16,
                     device='cpu')
  homo = (Dataset().init_graph((np.arange(8), (np.arange(8) + 1) % 8),
                               layout='COO', num_nodes=8, device='cpu')
          .init_node_features(np.ones((8, 4), np.float32), device='cpu')
          .init_node_labels(np.zeros(8, np.int32)))
  with pytest.raises(ValueError, match='hetero Dataset'):
    FusedHeteroEpoch(homo, [3], (P, np.arange(8)), model, opt, 4,
                     device='cpu')
  unlabeled = Dataset().init_graph(
      {et: (g.csr_topo.indptr, g.csr_topo.indices)
       for et, g in ds.get_graph().items()}, layout='CSR', device='cpu')
  unlabeled.init_node_features(
      {nt: f.host_get() for nt, f in ds.node_features.items()},
      device='cpu')
  with pytest.raises(ValueError, match="labels of 'paper'"):
    FusedHeteroEpoch(unlabeled, FANOUTS, (P, np.arange(48)), model, opt,
                     16, device='cpu')
  with pytest.raises(ValueError, match='per-type node features'):
    FusedHeteroEpoch(Dataset().init_graph(
        {et: (g.csr_topo.indptr, g.csr_topo.indices)
         for et, g in ds.get_graph().items()}, layout='CSR', device='cpu'),
        FANOUTS, (P, np.arange(48)), model, opt, 16, device='cpu')
  # the default draws: the loss is finite and training moves the weights
  before = model.conv0.lin_self_paper.weight.detach().clone()
  fused = FusedHeteroEpoch(ds, FANOUTS, (P, np.arange(40)), model, opt, 8,
                           seed=3, device='cpu')
  stats = fused.run()
  assert stats.losses.shape == (5,) and np.isfinite(stats.loss)
  assert not torch.equal(before, model.conv0.lin_self_paper.weight)
  assert 0.0 <= fused.evaluate(np.arange(40, 80)) <= 1.0
