"""`FusedLinkEpoch` against the JAX package's, binary (with labels, so
the +1 shift runs) and triplet, and its `evaluate` AUC.

One epoch of 5 steps in chunks of 2 (``max_steps_per_program=2``: the
chunk keys and a padded tail step are exercised) from the same Flax
`GraphSAGE` params.  The port replays the JAX keys: a step's key is
``fold_in(key(seed), epoch)`` (eval: ``fold_in(fold_in(key(seed), 0),
1)``), ``fold_in(., chunk)`` when the epoch has more than one chunk, then
``fold_in(., step)``; its negatives draw from ``fold_in(step key, 0)``
(``split`` into the row and column candidates for binary negatives, the
destinations from it whole for triplet ones), its hops from
``fold_in(fold_in(step key, 1), hop)`` split into the uniform and the
Gumbel stream.  Evaluation is one chunk.  Tolerances: per-step losses
and final parameters within 1e-5; valid pair counts, Adam's step count
and the AUC equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphlearn_tpu.data import Dataset as JaxDataset
from graphlearn_tpu.loader import FusedLinkEpoch as JaxFusedLinkEpoch
from graphlearn_tpu.loader import NeighborLoader as JaxLoader
from graphlearn_tpu.models import GraphSAGE as FlaxGraphSAGE
from graphlearn_tpu.models import create_train_state
from graphlearn_tpu.sampler import NegativeSampling as JaxNeg
from graphlearn_tpu_torch.data import Dataset
from graphlearn_tpu_torch.loader import FusedLinkEpoch
from graphlearn_tpu_torch.models import GraphSAGE, graphsage_from_flax
from graphlearn_tpu_torch.ops import gather_rows_plain, sample_one_hop
from graphlearn_tpu_torch.sampler import NegativeSampling
# _clean_env is an autouse fixture: importing it applies it here too
from test_torch_fused_tree import _clean_env  # noqa: F401
from test_torch_fused_tree import _graph, _numpy_tree

FANOUTS = [3, 2]
N, D, BATCH = 300, 6, 8


def jax_link_draws(seed, triplet=False):
  """``(draws, neg_draws)`` providers that replay the JAX fused link
  epoch's keys (module docstring)."""
  base = jax.random.key(seed)

  def step_key(epoch, chunk, step):
    key = (jax.random.fold_in(jax.random.fold_in(base, 0), 1) if epoch == 0
           else jax.random.fold_in(base, epoch))
    if chunk is not None:
      key = jax.random.fold_in(key, chunk)
    return jax.random.fold_in(key, step)

  def draws(epoch, chunk, step, hop, rows, k, w):
    k_rand, k_win = jax.random.split(jax.random.fold_in(
        jax.random.fold_in(step_key(epoch, chunk, step), 1), hop))
    u = jax.random.uniform(k_rand, (rows, k))
    g = jax.random.gumbel(k_win, (rows, w), dtype=jnp.float32)
    return torch.from_numpy(np.array(u)), torch.from_numpy(np.array(g))

  def neg_draws(epoch, chunk, step, stream, trials, r, high):
    key = jax.random.fold_in(step_key(epoch, chunk, step), 0)
    if not triplet:
      key = jax.random.split(key)[stream]
    return torch.from_numpy(np.array(jax.random.randint(
        key, (trials, r), 0, high, dtype=jnp.int32)))
  return draws, neg_draws


def _setup(mode, labels):
  rows, cols, feats, _ = _graph(seed=5)
  jds = (JaxDataset().init_graph((rows, cols), num_nodes=N)
         .init_node_features(feats))
  ds = (Dataset().init_graph((rows, cols), num_nodes=N, device='cpu')
        .init_node_features(feats, device='cpu'))
  rng = np.random.default_rng(9)
  pick = rng.permutation(rows.shape[0])
  train = (rows[pick[:37]], cols[pick[:37]])      # 5 steps of 8
  test = (rows[pick[37:61]], cols[pick[37:61]])   # 3 eval batches
  edge_label = rng.integers(0, 3, 37) if labels else None
  tx = optax.adam(3e-3)
  batch = next(iter(JaxLoader(jds, FANOUTS, np.arange(BATCH),
                              batch_size=BATCH)))
  fmodel = FlaxGraphSAGE(hidden_features=8, out_features=8, num_layers=2)
  state, apply_fn = create_train_state(fmodel, jax.random.key(0), batch, tx)
  jf = JaxFusedLinkEpoch(jds, FANOUTS, train, apply_fn, tx, BATCH,
                         neg_sampling=JaxNeg(*mode), edge_label=edge_label,
                         shuffle=True, seed=0, max_steps_per_program=2)
  model = GraphSAGE(D, 8, 8, num_layers=2)
  model.load_state_dict(graphsage_from_flax(_numpy_tree(state.params)))
  opt = torch.optim.Adam(model.parameters(), lr=3e-3, eps=1e-8)
  draws, neg_draws = jax_link_draws(0, triplet=mode[0] == 'triplet')
  tf = FusedLinkEpoch(ds, FANOUTS, train, model, opt, BATCH,
                      neg_sampling=NegativeSampling(*mode),
                      edge_label=edge_label, shuffle=True, seed=0,
                      max_steps_per_program=2, draws=draws,
                      neg_draws=neg_draws, device='cpu')
  return jf, tf, state, model, opt, test


@pytest.mark.parametrize('mode,labels', [(('binary', 1.0), True),
                                         (('binary', 2.0), False),
                                         (('triplet', 2), False)],
                         ids=['binary_labels', 'binary_x2', 'triplet'])
def test_fused_link_epoch_matches_jax(mode, labels):
  jf, tf, state, model, opt, test = _setup(mode, labels)
  assert len(tf) == len(jf) == 5
  sample_one_hop.calls = gather_rows_plain.calls = 0
  state, jstats = jf.run(state)
  stats = tf.run()
  # 5 real steps of 3 chunks; the padded sixth step ran nothing
  assert stats.losses.shape == (5,) == np.asarray(jstats.losses).shape
  assert (sample_one_hop.calls, gather_rows_plain.calls) == (5 * 2, 5)
  np.testing.assert_allclose(stats.losses.numpy(),
                             np.asarray(jstats.losses), rtol=1e-5,
                             atol=1e-5)
  assert stats.seeds == jstats.seeds == 37 and stats.correct == 0
  assert {int(s['step']) for s in opt.state.values()} == {5}
  ref = graphsage_from_flax(_numpy_tree(state.params))
  for name, p in model.state_dict().items():
    np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=name)
  if mode[0] == 'binary':
    auc = tf.evaluate(test)
    assert auc == jf.evaluate(state.params, test)
    assert 0.0 <= auc <= 1.0
  else:
    with pytest.raises(ValueError, match='binary'):
      tf.evaluate(test)
  assert tf.compile_count() == 0               # the CPU captures nothing


def test_fused_link_epoch_contract():
  """The default counter draws train (finite losses, weights move, an
  AUC in [0, 1]); a tiered store and a hetero dataset are refused."""
  rows, cols, feats, _ = _graph(seed=6)
  ds = (Dataset().init_graph((rows, cols), num_nodes=N, device='cpu')
        .init_node_features(feats, device='cpu'))
  model = GraphSAGE(D, 8, 8, num_layers=2)
  model.reset_parameters(torch.Generator().manual_seed(0))
  opt = torch.optim.Adam(model.parameters(), lr=3e-3)
  before = model.conv0.lin_self.weight.detach().clone()
  fused = FusedLinkEpoch(ds, FANOUTS, (rows[:40], cols[:40]), model, opt, 8,
                         seed=3, device='cpu')
  stats = fused.run()
  assert stats.losses.shape == (5,) and np.isfinite(stats.loss)
  assert not torch.equal(before, model.conv0.lin_self.weight)
  assert 0.0 <= fused.evaluate((rows[40:80], cols[40:80])) <= 1.0
  with pytest.raises(ValueError, match='empty'):
    fused.evaluate((rows[:0], cols[:0]))
  tiered = (Dataset().init_graph((rows, cols), num_nodes=N, device='cpu')
            .init_node_features(feats, split_ratio=0.5, device='cpu'))
  with pytest.raises(NotImplementedError, match='tiered'):
    FusedLinkEpoch(tiered, FANOUTS, (rows, cols), model, opt, 8,
                   device='cpu')
