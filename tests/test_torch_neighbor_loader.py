"""The per-batch training path against the JAX package: `NeighborSampler.
sample_from_nodes`, `NeighborLoader` batches, `GraphSAGE` logits, two
Adam steps of `make_supervised_step` and `make_eval_step`.

The port's sampler replays the JAX sampler's keys through its ``draws``
provider: ``fold_in(key(seed), step)`` -> ``fold_in(., hop)`` ->
``split`` into the uniform and the Gumbel stream, draw row ``j`` the
``j``-th frontier row in ascending seed order.  Tolerances: sampler
outputs and batches byte-equal, dtypes included; logits, losses and
parameters within 1e-5 (f32 matmuls and scatter-adds reduce in another
order in XLA:CPU than in torch); eval counts equal.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphlearn_tpu.data import Dataset as JaxDataset
from graphlearn_tpu.loader import NeighborLoader as JaxLoader
from graphlearn_tpu.models import GraphSAGE as FlaxGraphSAGE
from graphlearn_tpu.models import create_train_state
from graphlearn_tpu.models import make_eval_step as jax_eval_step
from graphlearn_tpu.models import make_supervised_step as jax_step
from graphlearn_tpu.sampler import NeighborSampler as JaxSampler
from graphlearn_tpu.sampler import NodeSamplerInput as JaxInput
from graphlearn_tpu_torch.data import Dataset
from graphlearn_tpu_torch.loader import NeighborLoader, NodeLoader
from graphlearn_tpu_torch.models import (GraphSAGE, graphsage_from_flax,
                                         make_eval_step, make_supervised_step)
from graphlearn_tpu_torch.sampler import (EdgeSamplerInput, NeighborSampler,
                                          NodeSamplerInput)

FANOUTS = [3, 2]
N, D, CLASSES = 400, 6, 5


def _graph(seed=0):
  """Rows through every sampler arm at k 3 and 2 (window 64): hubs of
  degree 100, window rows of degree 4-64, take-all rows and isolated
  nodes (the last 20 have no out-edges)."""
  rng = np.random.default_rng(seed)
  deg = rng.integers(0, 4, N)
  deg[::9] = rng.integers(4, 65, deg[::9].shape[0])
  deg[:5] = 100
  deg[-20:] = 0
  rows = np.repeat(np.arange(N), deg)
  cols = rng.integers(0, N, rows.shape[0])
  feats = rng.standard_normal((N, D)).astype(np.float32)
  labels = rng.integers(0, CLASSES, N).astype(np.int32)
  return rows, cols, feats, labels


def _datasets(seed=0):
  rows, cols, feats, labels = _graph(seed)
  jds = (JaxDataset().init_graph((rows, cols), num_nodes=N)
         .init_node_features(feats).init_node_labels(labels))
  ds = (Dataset().init_graph((rows, cols), num_nodes=N, device='cpu')
        .init_node_features(feats, device='cpu').init_node_labels(labels))
  return jds, ds, feats, labels


def jax_key_draws(seed):
  """A draws provider that replays the JAX `NeighborSampler`'s keys."""
  base = jax.random.key(seed)

  def draws(step, hop, rows, k, w):
    k_rand, k_win = jax.random.split(
        jax.random.fold_in(jax.random.fold_in(base, step), hop))
    u = jax.random.uniform(k_rand, (rows, k))
    g = jax.random.gumbel(k_win, (rows, w), dtype=jnp.float32)
    return torch.from_numpy(np.array(u)), torch.from_numpy(np.array(g))
  return draws


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
  for env in ('GLT_PALLAS_SAMPLE', 'GLT_PALLAS'):
    monkeypatch.delenv(env, raising=False)


def _same(got: torch.Tensor, ref, what):
  ref = np.asarray(ref)
  assert got.numpy().dtype == ref.dtype, what
  np.testing.assert_array_equal(got.numpy(), ref, err_msg=what)


def test_sampler_matches_jax():
  """Three calls (steps 1-3): duplicate seeds, isolated seeds, hubs and
  a padded tail; every output byte-equal."""
  jds, ds, _, _ = _datasets()
  js = JaxSampler(jds.get_graph(), FANOUTS, seed=0)
  ts = NeighborSampler(ds.get_graph(), FANOUTS, device='cpu',
                       draws=jax_key_draws(0))
  assert ts.node_capacity(24) == js.node_capacity(24)
  rng = np.random.default_rng(5)
  deg = np.diff(ds.get_graph().indptr.numpy())
  frontier_degs = []
  for call in range(3):
    seeds = rng.integers(0, N, 24).astype(np.int32)
    seeds[:4] = [0, 0, N - 1, N - 3]        # a hub twice, isolated seeds
    seeds[4:6] = seeds[7]                    # more duplicates
    if call:
      seeds[-5 * call:] = -1                 # a padded tail
    ref = js.sample_from_nodes(JaxInput(node=seeds))
    got = ts.sample_from_nodes(NodeSamplerInput(node=seeds))
    for f in ('node', 'node_count', 'row', 'col', 'edge_mask', 'batch',
              'num_sampled_nodes', 'num_sampled_edges'):
      _same(getattr(got, f), getattr(ref, f), f'call {call} {f}')
    _same(got.metadata['seed_local'], ref.metadata['seed_local'],
          f'call {call} seed_local')
    assert got.batch_size == ref.batch_size == 24 and got.edge is None
    node = got.node.numpy()
    frontier_degs.append(deg[node[node >= 0]])
  # the sampled rows went through every arm: empty, take-all (<= k),
  # the window (k < deg <= 64) and hubs past it
  d = np.concatenate(frontier_degs)
  assert (d == 0).any() and ((d > 0) & (d <= 2)).any()
  assert ((d > 3) & (d <= 64)).any() and (d > 64).any()


def _loaders(batch_size=16, n_seeds=40):
  jds, ds, feats, labels = _datasets(seed=1)
  idx = np.random.default_rng(2).permutation(N)[:n_seeds]
  jl = JaxLoader(jds, FANOUTS, idx, batch_size=batch_size, shuffle=True,
                 seed=0)
  tl = NeighborLoader(ds, FANOUTS, idx, batch_size=batch_size,
                      shuffle=True, seed=0, draws=jax_key_draws(0),
                      device='cpu')
  return jl, tl, feats, labels


def test_loader_batches_byte_equal_to_jax():
  """Three shuffled batches (the last padded): every `Batch` field."""
  jl, tl, feats, labels = _loaders()
  assert len(tl) == len(jl) == 3
  for i, (jb, tb) in enumerate(zip(jl, tl)):
    for f in ('x', 'y', 'edge_index', 'node', 'node_mask', 'edge_mask',
              'batch', 'num_sampled_nodes', 'num_sampled_edges'):
      _same(getattr(tb, f), getattr(jb, f), f'batch {i} {f}')
    _same(tb.metadata['seed_local'], jb.metadata['seed_local'],
          f'batch {i} seed_local')
    assert tb.batch_size == jb.batch_size == 16 and tb.edge is None
    node = tb.node.numpy()
    ok = node >= 0
    np.testing.assert_array_equal(tb.x.numpy()[ok], feats[node[ok]])
    np.testing.assert_array_equal(tb.y.numpy()[ok], labels[node[ok]])
    assert not tb.x.numpy()[~ok].any() and not tb.y.numpy()[~ok].any()
  assert (tb.batch.numpy() < 0).sum() == 8


def _numpy_tree(params):
  return jax.tree_util.tree_map(np.asarray, params)


def test_graphsage_train_and_eval_steps_match_jax():
  """Logits from the same Flax params within 1e-5; two Adam(3e-3) steps
  leave losses and every parameter within 1e-5 and equal correct
  counts; `make_eval_step` counts equal JAX's."""
  jl, tl, _, _ = _loaders()
  jbatches = list(itertools.islice(iter(jl), 3))
  tbatches = list(itertools.islice(iter(tl), 3))
  fmodel = FlaxGraphSAGE(hidden_features=8, out_features=CLASSES,
                         num_layers=2)
  tx = optax.adam(3e-3)
  state, apply_fn = create_train_state(fmodel, jax.random.key(0),
                                       jbatches[0], tx)
  model = GraphSAGE(D, 8, CLASSES, num_layers=2)
  model.load_state_dict(graphsage_from_flax(_numpy_tree(state.params)))
  b0, j0 = tbatches[0], jbatches[0]
  with torch.no_grad():
    got = model(b0.x, b0.edge_index, b0.edge_mask)
  ref = apply_fn(state.params, j0.x, j0.edge_index, j0.edge_mask)
  np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                             atol=1e-5)

  jstep = jax_step(apply_fn, tx, 16)
  step = make_supervised_step(
      model, torch.optim.Adam(model.parameters(), lr=3e-3, eps=1e-8), 16)
  for jb, tb in zip(jbatches[:2], tbatches[:2]):
    state, jloss, jcorrect = jstep(state, jb)
    loss, correct = step(tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    assert int(correct) == int(jcorrect)
  ref_state = graphsage_from_flax(_numpy_tree(state.params))
  for name, p in model.state_dict().items():
    np.testing.assert_allclose(p.numpy(), ref_state[name].numpy(),
                               rtol=1e-5, atol=1e-5, err_msg=name)

  jeval, teval = jax_eval_step(apply_fn, 16), make_eval_step(model, 16)
  for jb, tb in zip(jbatches, tbatches):
    jc, jt = jeval(state.params, jb)
    c, t = teval(tb)
    assert (int(c), int(t)) == (int(jc), int(jt))
  assert int(t) == 8                        # the padded batch's seeds


def test_sampler_and_loader_contract():
  _, ds, _, _ = _datasets()
  g = ds.get_graph()
  # with_edge: every valid edge carries its id, -1 elsewhere (the parity
  # tests: test_torch_edges.py)
  se = NeighborSampler(g, FANOUTS, device='cpu', with_edge=True)
  out = se.sample_from_nodes(NodeSamplerInput(node=np.arange(6)))
  assert out.edge.dtype == torch.int32 and out.edge.shape == out.row.shape
  assert bool((out.edge[out.edge_mask] >= 0).all())
  assert bool((out.edge[~out.edge_mask] == -1).all())
  s = NeighborSampler(g, FANOUTS, device='cpu')
  with pytest.raises(NotImplementedError, match='slice 11'):
    s.sample_prob(np.arange(3))
  # link and subgraph sampling run (their parity tests:
  # test_torch_link.py, test_torch_subgraph.py)
  link = s.sample_from_edges(EdgeSamplerInput(np.arange(4), np.arange(4, 8)))
  assert link.metadata['edge_label_index'].shape == (2, 4)
  sub = s.subgraph(NodeSamplerInput(node=np.arange(2)))
  assert sub.metadata['mapping'].tolist() == [0, 1]
  # prefetch=2 on a worker thread yields the synchronous loader's seeds
  pre = NodeLoader(ds, s, np.arange(10), batch_size=4, prefetch=2)
  assert [b.batch.tolist() for b in pre] == [
      [0, 1, 2, 3], [4, 5, 6, 7], [8, 9, -1, -1]]
  pre.close()
  assert pre._active_prefetch is None
  cap = s.node_capacity(8)
  assert cap == 8 + 24 + 48
  # the default draws (a torch generator) give a well-formed batch
  mask = np.zeros(N, bool)
  mask[:30] = True
  b = next(iter(NeighborLoader(ds, FANOUTS, mask, batch_size=8,
                               device='cpu')))
  assert b.x.shape == (cap, D) and b.edge_index.shape == (2, 24 + 48)
  assert b.y.dtype == torch.int32 and b.node.dtype == torch.int32
  ei, nc = b.edge_index.numpy(), int((b.node >= 0).sum())
  assert ((ei >= -1) & (ei < nc)).all()
  assert (b.edge_mask.numpy() == (ei[0] >= 0)).all()
