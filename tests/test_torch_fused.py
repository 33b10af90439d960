"""`FusedEpoch` against the JAX package's, and the fused epochs' counter
draws.

One epoch of 5 steps in chunks of 2 (``max_steps_per_program=2``: the
chunk keys and a padded tail step are exercised) from the same Flax
`GraphSAGE` params, then `evaluate` over a 3-batch split.  The port's
epoch replays the JAX keys through its ``draws(epoch, chunk, step, hop,
rows, k, w)`` provider: ``fold_in(key(seed), epoch)`` (eval:
``fold_in(fold_in(key(seed), 0), 1)``), then ``fold_in(., chunk)`` when
the epoch has more than one chunk, ``fold_in(., step)``, ``fold_in(.,
hop)`` and ``split`` into the uniform and the Gumbel stream; draw row
``j`` belongs to the ``j``-th frontier row in ascending seed order.

Tolerances: per-step losses and final parameters within 1e-5 (f32
matmuls and scatter-adds reduce in another order in XLA:CPU than in
torch); correct and valid counts, Adam's step count and eval accuracy
equal; ``remat=True`` against ``remat=False`` within 1e-6 (the CPU
recomputes the same forward).
"""
import jax
import numpy as np
import optax
import pytest
import torch

from graphlearn_tpu.data import Dataset as JaxDataset
from graphlearn_tpu.loader import FusedEpoch as JaxFusedEpoch
from graphlearn_tpu.models import GraphSAGE as FlaxGraphSAGE
from graphlearn_tpu.models import create_train_state
from graphlearn_tpu.loader import NeighborLoader as JaxLoader
from graphlearn_tpu_torch.data import Dataset
from graphlearn_tpu_torch.loader import FusedEpoch
from graphlearn_tpu_torch.models import GraphSAGE, graphsage_from_flax
from graphlearn_tpu_torch.ops import (CounterDraws, gather_rows_plain,
                                      sample_one_hop)
# _clean_env is an autouse fixture: importing it applies it here too
from test_torch_fused_tree import _clean_env  # noqa: F401
from test_torch_fused_tree import _graph, _numpy_tree, jax_epoch_draws

FANOUTS = [3, 2]
N, D, CLASSES, BATCH = 300, 6, 5, 16


def _datasets(seed=0):
  rows, cols, feats, labels = _graph(seed)
  jds = (JaxDataset().init_graph((rows, cols), num_nodes=N)
         .init_node_features(feats).init_node_labels(labels))
  ds = (Dataset().init_graph((rows, cols), num_nodes=N, device='cpu')
        .init_node_features(feats, device='cpu').init_node_labels(labels))
  return jds, ds


def _jax_state(jds, tx):
  batch = next(iter(JaxLoader(jds, FANOUTS, np.arange(BATCH),
                              batch_size=BATCH)))
  fmodel = FlaxGraphSAGE(hidden_features=8, out_features=CLASSES,
                         num_layers=2)
  return create_train_state(fmodel, jax.random.key(0), batch, tx)


def _port(ds, params, train, remat=False, **kw):
  model = GraphSAGE(D, 8, CLASSES, num_layers=2)
  model.load_state_dict(graphsage_from_flax(_numpy_tree(params)))
  opt = torch.optim.Adam(model.parameters(), lr=3e-3, eps=1e-8)
  fused = FusedEpoch(ds, FANOUTS, train, model, opt, batch_size=BATCH,
                     shuffle=True, seed=0, max_steps_per_program=2,
                     remat=remat, draws=jax_epoch_draws(0), device='cpu',
                     **kw)
  return model, opt, fused


def test_fused_epoch_matches_jax():
  jds, ds = _datasets()
  idx = np.random.default_rng(1).permutation(N)
  train, test = idx[:72], idx[72:112]           # 5 steps; 3 eval batches
  tx = optax.adam(3e-3)
  state, apply_fn = _jax_state(jds, tx)
  model, opt, tf = _port(ds, state.params, train)
  jf = JaxFusedEpoch(jds, FANOUTS, train, apply_fn, tx, batch_size=BATCH,
                     shuffle=True, seed=0, max_steps_per_program=2)
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
  assert (stats.correct, stats.seeds) == (jstats.correct, jstats.seeds)
  assert stats.seeds == 72
  assert int(state.step) == 5
  assert {int(s['step']) for s in opt.state.values()} == {5}
  ref = graphsage_from_flax(_numpy_tree(state.params))
  for name, p in model.state_dict().items():
    np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=name)
  assert tf.evaluate(test) == jf.evaluate(state.params, test)
  assert tf.compile_count() == 0               # the CPU captures nothing


def test_remat_equals_plain_forward():
  jds, ds = _datasets(seed=3)
  train = np.arange(72)
  state, _ = _jax_state(jds, optax.adam(3e-3))
  runs = []
  for remat in (False, True):
    model, _, fused = _port(ds, state.params, train, remat=remat)
    runs.append((fused.run().losses.numpy(),
                 {k: v.clone() for k, v in model.state_dict().items()},
                 fused.evaluate(np.arange(100, 160))))
  (l0, p0, a0), (l1, p1, a1) = runs
  np.testing.assert_allclose(l1, l0, rtol=1e-6, atol=1e-6)
  for name in p0:
    np.testing.assert_allclose(p1[name].numpy(), p0[name].numpy(),
                               rtol=1e-6, atol=1e-6, err_msg=name)
  assert a1 == a0


def test_padded_step_leaves_adam_untouched():
  """5 steps in chunks of 4 (the second chunk holds 3 padded steps)
  against the same 5 steps in one chunk of 5, both drawing by the
  step's place in the epoch: the parameters and Adam's whole state end
  bitwise equal, and no padded step ran the sampler."""
  _, ds = _datasets(seed=4)
  cd = CounterDraws(5, 'cpu')

  def draws(epoch, chunk, step, hop, rows, k, w):
    return cd(epoch, None, (chunk or 0) + step, hop, rows, k, w)
  ends = []
  for chunk in (4, 5):
    model = GraphSAGE(D, 8, CLASSES, num_layers=2)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    fused = FusedEpoch(ds, FANOUTS, np.arange(72), model, opt, BATCH,
                       seed=0, max_steps_per_program=chunk, draws=draws,
                       device='cpu')
    sample_one_hop.calls = 0
    stats = fused.run()
    assert stats.losses.shape == (5,) and sample_one_hop.calls == 5 * 2
    ends.append((stats.losses, [p.detach() for p in model.parameters()],
                 [t for st in opt.state.values() for t in st.values()]))
  (l4, p4, s4), (l5, p5, s5) = ends
  assert torch.equal(l4, l5)
  assert all(torch.equal(a, b) for a, b in zip(p4, p5))
  assert len(s4) == len(s5) and all(torch.equal(a, b)
                                    for a, b in zip(s4, s5))
  assert {int(t) for t in s4[::3]} == {5}       # Adam's step counts


def test_fused_epoch_contract():
  rows, cols, feats, labels = _graph(seed=2)
  ds = Dataset().init_graph((rows, cols), num_nodes=N, device='cpu')
  model = GraphSAGE(D, 8, CLASSES, num_layers=2)
  model.reset_parameters(torch.Generator().manual_seed(0))
  opt = torch.optim.Adam(model.parameters(), lr=3e-3)
  with pytest.raises(ValueError, match='features'):
    FusedEpoch(ds, FANOUTS, np.arange(40), model, opt, 8, device='cpu')
  ds.init_node_features(feats, device='cpu')
  with pytest.raises(ValueError, match='labels'):
    FusedEpoch(ds, FANOUTS, np.arange(40), model, opt, 8, device='cpu')
  ds.init_node_labels(labels)
  # the default draws: the loss is finite and training moves the weights
  before = model.conv0.lin_self.weight.detach().clone()
  fused = FusedEpoch(ds, FANOUTS, np.arange(40), model, opt, 8, seed=3,
                     device='cpu')
  stats = fused.run()
  assert stats.losses.shape == (5,) and np.isfinite(stats.loss)
  assert not torch.equal(before, model.conv0.lin_self.weight)
  assert 0.0 <= fused.evaluate(np.arange(40, 80)) <= 1.0
  with pytest.raises(ValueError, match='empty'):
    fused.evaluate(np.arange(0))


def test_counter_draws_int_and_tensor_coordinates():
  d = CounterDraws(7, 'cpu')
  u, g = d(3, None, 2, 1, 40, 5, 64)
  for coords in ((3, 0, 2, 1), tuple(torch.tensor([3, 0, 2, 1]).unbind(0)),
                 (torch.tensor(3), 0, torch.tensor(2), torch.tensor(1))):
    u2, g2 = d.draw(coords, 40, 5, 64)
    assert torch.equal(u, u2) and torch.equal(g, g2)
  assert u.shape == (40, 5) and g.shape == (40, 64)
  assert u.dtype == g.dtype == torch.float32
  assert bool(((u > 0) & (u < 1)).all()) and bool(torch.isfinite(g).all())
  # every coordinate, the seed and the stream move the values
  for other in (d(4, None, 2, 1, 40, 5, 64), d(3, 2, 2, 1, 40, 5, 64),
                d(3, None, 3, 1, 40, 5, 64), d(3, None, 2, 0, 40, 5, 64),
                CounterDraws(8, 'cpu')(3, None, 2, 1, 40, 5, 64)):
    assert not torch.equal(u, other[0]) and not torch.equal(g, other[1])
  u3, v3 = d.draw((3, 0, 2, 1), 40, 5, 64, gns=True)
  assert torch.equal(u3, u) and not torch.equal(v3, u)
  # rows are a prefix: a wider draw extends a narrower one
  assert torch.equal(d(3, None, 2, 1, 80, 5, 64)[0][:40], u)
  # uniform enough: the mean of 40 x 64 values sits near 1/2
  assert abs(float(d.draw((1,), 40, 64, 64)[0].mean()) - 0.5) < 0.02


def test_launch_registry_holds_every_kernel_wrapper():
  """`ops.LAUNCH_COUNTED` holds each kernel's wrapper once, one for each
  CUDA source, so the captured step accounts for every kernel a replay
  launches without naming them."""
  import pathlib

  import graphlearn_tpu_torch
  import graphlearn_tpu_torch.parallel  # noqa: F401  (push_rows)
  from graphlearn_tpu_torch.ops import LAUNCH_COUNTED
  names = sorted(fn.__name__ for fn in LAUNCH_COUNTED)
  assert names == sorted({'sample_one_hop_fused', 'sample_one_hop_gns_fused',
                          'gather_rows', 'csr_window_gather', 'merge_ranks',
                          'cold_gather', 'push_rows'})
  csrc = pathlib.Path(graphlearn_tpu_torch.__file__).parent / 'csrc'
  assert len(names) == len(list(csrc.glob('*.cu')))
  assert all(isinstance(fn.launches, int) for fn in LAUNCH_COUNTED)
