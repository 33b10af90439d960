"""`FusedTreeEpoch` against the JAX package's: one epoch of 5 steps in
chunks of 2 (``max_steps_per_program=2``, so the chunk keys and a
padded tail step are exercised) from the same Flax `TreeSAGE` params,
then `evaluate` over a 3-batch split.

The port's epoch replays the JAX keys through its ``draws(epoch, chunk,
step, hop, rows, k, w)`` provider: ``fold_in(key(seed), epoch)`` (eval:
``fold_in(fold_in(key(seed), 0), 1)``), then ``fold_in(., chunk)`` when
the epoch has more than one chunk, ``fold_in(., step)``, ``fold_in(.,
hop)`` and ``split`` into the uniform and the Gumbel stream, frontier
rows unsorted.  Tolerances: per-step losses and final parameters within
1e-5 (f32 matmuls reduce in another order in XLA:CPU than in torch);
correct counts, step counts and eval accuracy equal.  The bf16 epoch
(``TreeSAGE(dtype=bfloat16)`` on both sides, f32 params) holds losses
to 2e-2 (each library rounds to bf16 at its own places, ~4e-3 relative
a rounding), each parameter's change over the epoch to within 2e-2 of
the norm of JAX's change (Adam moves a parameter by about the learning
rate a step, so the change, not the parameter, is what the backward and
the update decide; 5 steps at lr 3e-3 agree to 4e-3 of that norm), and
the correct counts to within 2 of 72 seeds (an argmax between two
logits closer than a bf16 rounding may go either way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphlearn_tpu.data import Dataset as JaxDataset
from graphlearn_tpu.loader import FusedTreeEpoch as JaxFusedTreeEpoch
from graphlearn_tpu.models import TreeSAGE as FlaxTreeSAGE
from graphlearn_tpu_torch.data import Dataset
from graphlearn_tpu_torch.loader import FusedTreeEpoch
from graphlearn_tpu_torch.models import TreeSAGE, tree_sage_from_flax
from graphlearn_tpu_torch.ops import gather_rows_plain, sample_one_hop

FANOUTS = [3, 2]
N, D, CLASSES, BATCH = 300, 6, 5, 16


def _graph(seed=0):
  """Hubs past the window (degree 90 > 64), window rows, take-all rows
  and isolated nodes; labels a linear function of the features."""
  rng = np.random.default_rng(seed)
  deg = rng.integers(0, 5, N)
  deg[::7] = rng.integers(5, 60, deg[::7].shape[0])
  deg[:4] = 90
  deg[-15:] = 0
  rows = np.repeat(np.arange(N), deg)
  cols = rng.integers(0, N, rows.shape[0])
  feats = rng.standard_normal((N, D)).astype(np.float32)
  proj = rng.standard_normal((D, CLASSES)).astype(np.float32)
  labels = np.argmax(feats @ proj, axis=1).astype(np.int32)
  return rows, cols, feats, labels


def jax_epoch_draws(seed):
  """A draws provider that replays the JAX fused epoch's keys."""
  base = jax.random.key(seed)

  def draws(epoch, chunk, step, hop, rows, k, w):
    key = (jax.random.fold_in(jax.random.fold_in(base, 0), 1) if epoch == 0
           else jax.random.fold_in(base, epoch))
    if chunk is not None:
      key = jax.random.fold_in(key, chunk)
    k_rand, k_win = jax.random.split(
        jax.random.fold_in(jax.random.fold_in(key, step), hop))
    u = jax.random.uniform(k_rand, (rows, k))
    g = jax.random.gumbel(k_win, (rows, w), dtype=jnp.float32)
    return torch.from_numpy(np.array(u)), torch.from_numpy(np.array(g))
  return draws


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
  for env in ('GLT_PALLAS_SAMPLE', 'GLT_PALLAS', 'GLT_FUSED_COMPILE_CACHE'):
    monkeypatch.delenv(env, raising=False)


def _numpy_tree(params):
  return jax.tree_util.tree_map(np.asarray, params)


def _epochs(dtype=None):
  rows, cols, feats, labels = _graph()
  idx = np.random.default_rng(1).permutation(N)
  train, test = idx[:72], idx[72:112]           # 5 steps; 3 eval batches
  jds = (JaxDataset().init_graph((rows, cols), num_nodes=N)
         .init_node_features(feats).init_node_labels(labels))
  ds = (Dataset().init_graph((rows, cols), num_nodes=N, device='cpu')
        .init_node_features(feats, device='cpu').init_node_labels(labels))
  tx = optax.adam(3e-3)
  jf = JaxFusedTreeEpoch(
      jds, FANOUTS, train,
      FlaxTreeSAGE(hidden_features=8, out_features=CLASSES, num_layers=2,
                   dtype=None if dtype is None else jnp.bfloat16),
      tx, batch_size=BATCH, shuffle=True, seed=0, max_steps_per_program=2)
  state = jf.init_state(jax.random.key(0))
  model = TreeSAGE(D, 8, CLASSES, num_layers=2, dtype=dtype)
  model.load_state_dict(tree_sage_from_flax(_numpy_tree(state.params)))
  opt = torch.optim.Adam(model.parameters(), lr=3e-3, eps=1e-8)
  tf = FusedTreeEpoch(ds, FANOUTS, train, model, opt, batch_size=BATCH,
                      shuffle=True, seed=0, max_steps_per_program=2,
                      draws=jax_epoch_draws(0), device='cpu')
  assert len(tf) == len(jf) == 5
  return jf, tf, state, model, opt, test


def test_fused_tree_epoch_matches_jax():
  jf, tf, state, model, opt, test = _epochs()

  sample_one_hop.calls = gather_rows_plain.calls = 0
  state, jstats = jf.run(state)
  stats = tf.run()
  # 5 real steps of 3 chunks; the padded sixth step ran nothing
  assert stats.losses.shape == (5,) == np.asarray(jstats.losses).shape
  assert (sample_one_hop.calls, gather_rows_plain.calls) == (5 * 2, 5 * 3)
  np.testing.assert_allclose(stats.losses.numpy(),
                             np.asarray(jstats.losses), rtol=1e-5,
                             atol=1e-5)
  assert (stats.correct, stats.seeds) == (jstats.correct, jstats.seeds)
  assert stats.seeds == 72
  assert int(state.step) == 5
  assert {int(s['step']) for s in opt.state.values()} == {5}
  ref = tree_sage_from_flax(_numpy_tree(state.params))
  for name, p in model.state_dict().items():
    np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=name)
  assert tf.evaluate(test) == jf.evaluate(state.params, test)


def test_bf16_fused_tree_epoch_matches_jax():
  jf, tf, state, model, opt, test = _epochs(torch.bfloat16)
  start = {k: v.clone() for k, v in model.state_dict().items()}
  state, jstats = jf.run(state)
  stats = tf.run()
  np.testing.assert_allclose(stats.losses.numpy(),
                             np.asarray(jstats.losses), rtol=2e-2,
                             atol=2e-2)
  assert stats.seeds == jstats.seeds == 72
  assert abs(stats.correct - jstats.correct) <= 2
  assert {int(s['step']) for s in opt.state.values()} == {5}
  ref = tree_sage_from_flax(_numpy_tree(state.params))
  for name, p in model.state_dict().items():
    assert p.dtype == torch.float32
    moved, jax_moved = p - start[name], ref[name] - start[name]
    # Adam moved every parameter by a few learning rates: a port that
    # left it in place, or moved it another way, is off by ~1x the norm
    assert float(jax_moved.norm()) > 10 * 2e-2 * 3e-3, name
    rel = float((moved - jax_moved).norm() / jax_moved.norm())
    assert rel <= 2e-2, (name, rel)
  assert abs(tf.evaluate(test) - jf.evaluate(state.params, test)) <= 2 / 40


def test_fused_tree_epoch_contract():
  rows, cols, feats, labels = _graph(seed=2)
  ds = (Dataset().init_graph((rows, cols), num_nodes=N, device='cpu')
        .init_node_features(feats, device='cpu'))
  model = TreeSAGE(D, 8, CLASSES, num_layers=2)
  model.reset_parameters(torch.Generator().manual_seed(0))
  opt = torch.optim.Adam(model.parameters(), lr=3e-3)
  with pytest.raises(ValueError, match='labels'):
    FusedTreeEpoch(ds, FANOUTS, np.arange(40), model, opt, 8, device='cpu')
  ds.init_node_labels(labels)
  with pytest.raises(ValueError, match='num_layers'):
    FusedTreeEpoch(ds, [3, 2, 2], np.arange(40), model, opt, 8,
                   device='cpu')
  # the default draws: the loss is finite and training moves the weights
  before = model.layer0_self.weight.detach().clone()
  tf = FusedTreeEpoch(ds, FANOUTS, np.arange(40), model, opt, 8, seed=3,
                      device='cpu')
  stats = tf.run()
  assert stats.losses.shape == (5,) and np.isfinite(stats.loss)
  assert not torch.equal(before, model.layer0_self.weight)
  assert 0.0 <= tf.evaluate(np.arange(40, 80)) <= 1.0
  with pytest.raises(ValueError, match='empty'):
    tf.evaluate(np.arange(0))
