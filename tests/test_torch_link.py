"""Link prediction against the JAX package: `NeighborSampler.
sample_from_edges` without negatives and with binary and triplet ones,
`LinkNeighborLoader` batches (the padded tail and the binary label
shift), the binary and triplet link losses and `make_unsupervised_step`
from carried Flax `GraphSAGE` params.

The port replays the JAX sampler's keys: a link batch takes two steps,
the negatives' ``fold_in(key(seed), step)`` (``split`` into the row and
column candidates for binary negatives, whole for triplet ones) and the
hops' ``fold_in(key(seed), step + 1)`` (`test_torch_neighbor_loader.
jax_key_draws`).  Tolerances: sampler outputs, metadata and batches
byte-equal (labels compared by value: JAX keeps a numpy label array's
own dtype where no negative is drawn); losses and parameters within
1e-5.
"""
import jax
import numpy as np
import optax
import pytest
import torch

from graphlearn_tpu.data import Dataset as JaxDataset
from graphlearn_tpu.loader import LinkNeighborLoader as JaxLinkLoader
from graphlearn_tpu.models import GraphSAGE as FlaxGraphSAGE
from graphlearn_tpu.models import create_train_state
from graphlearn_tpu.models import make_unsupervised_step as jax_step
from graphlearn_tpu.models.train import (
    triplet_link_loss as jax_triplet_loss,
    unsupervised_link_loss as jax_binary_loss)
from graphlearn_tpu.sampler import EdgeSamplerInput as JaxEdgeInput
from graphlearn_tpu.sampler import NegativeSampling as JaxNeg
from graphlearn_tpu.sampler import NeighborSampler as JaxSampler
from graphlearn_tpu_torch.data import Dataset
from graphlearn_tpu_torch.loader import (FusedLinkEpoch, LinkNeighborLoader,
                                         SubGraphLoader)
from graphlearn_tpu_torch.models import (GraphSAGE, graphsage_from_flax,
                                         make_unsupervised_step,
                                         triplet_link_loss,
                                         unsupervised_link_loss)
from graphlearn_tpu_torch.ops import gather_rows_plain, sample_one_hop
from graphlearn_tpu_torch.sampler import (EdgeSamplerInput, NegativeSampling,
                                          NeighborSampler,
                                          RandomNegativeSampler)
from test_torch_negative import jax_neg_draws
# _clean_env is an autouse fixture: importing it applies it here too
from test_torch_neighbor_loader import _clean_env  # noqa: F401
from test_torch_neighbor_loader import _graph, jax_key_draws

FANOUTS = [3, 2]
N, D = 400, 6
MODES = [None, ('binary', 1.5), ('triplet', 2)]


def _datasets(seed=0):
  rows, cols, feats, _ = _graph(seed)
  jds = (JaxDataset().init_graph((rows, cols), num_nodes=N)
         .init_node_features(feats))
  ds = (Dataset().init_graph((rows, cols), num_nodes=N, device='cpu')
        .init_node_features(feats, device='cpu'))
  return jds, ds, rows, cols


def _same(got: torch.Tensor, ref, what, dtype=True):
  ref = np.asarray(ref)
  if dtype:
    assert got.numpy().dtype == ref.dtype, what
  np.testing.assert_array_equal(got.numpy(), ref, err_msg=what)


def _check_metadata(got: dict, ref: dict, what):
  assert set(got) == set(ref), what
  for k in ref:
    _same(got[k], ref[k], f'{what} {k}', dtype=k != 'edge_label')


def _port_sampler(ds, mode, seed=0):
  return NeighborSampler(ds.get_graph(), FANOUTS, device='cpu',
                         draws=jax_key_draws(seed),
                         neg_draws=jax_neg_draws(
                             seed, triplet=mode is not None
                             and mode[0] == 'triplet'))


@pytest.mark.parametrize('mode', MODES, ids=['none', 'binary', 'triplet'])
def test_sample_from_edges_matches_jax(mode):
  """Three link batches (steps 1-6) with a padded tail and labels: the
  sampled tables, COO, masks, seeds and metadata byte-equal."""
  jds, ds, rows, cols = _datasets()
  js = JaxSampler(jds.get_graph(), FANOUTS, seed=0)
  ts = _port_sampler(ds, mode)
  rng = np.random.default_rng(3)
  for call in range(3):
    pick = rng.integers(0, rows.shape[0], 20)
    src = rows[pick].astype(np.int32)
    dst = cols[pick].astype(np.int32)
    lab = rng.integers(0, 3, 20).astype(np.int32)
    if call:
      src[-4 * call:] = dst[-4 * call:] = -1
    neg = None if mode is None else JaxNeg(*mode)
    ref = js.sample_from_edges(JaxEdgeInput(src, dst, lab, neg_sampling=neg))
    got = ts.sample_from_edges(EdgeSamplerInput(
        src, dst, lab, neg_sampling=None if mode is None
        else NegativeSampling(*mode)))
    for f in ('node', 'node_count', 'row', 'col', 'edge_mask', 'batch',
              'num_sampled_nodes', 'num_sampled_edges'):
      _same(getattr(got, f), getattr(ref, f), f'call {call} {f}')
    _check_metadata(got.metadata, ref.metadata, f'call {call}')
  assert ts._step == js._step == 6


@pytest.mark.parametrize('mode', MODES, ids=['none', 'binary', 'triplet'])
def test_link_loader_batches_byte_equal_to_jax(mode):
  """A shuffled epoch of 37 labelled edges in batches of 8 (the last
  batch padded): every batch's x, node, edge_index, masks, seeds and
  metadata byte-equal; binary labels shifted by one on valid slots."""
  jds, ds, rows, cols = _datasets(seed=1)
  rng = np.random.default_rng(4)
  pick = rng.permutation(rows.shape[0])[:37]
  edges = (rows[pick], cols[pick])
  labels = rng.integers(0, 4, 37)
  kw = dict(edge_label=labels, batch_size=8, shuffle=True, seed=2)
  jl = JaxLinkLoader(jds, FANOUTS, edges,
                     neg_sampling=None if mode is None else JaxNeg(*mode),
                     **kw)
  tl = LinkNeighborLoader(
      ds, FANOUTS, edges,
      neg_sampling=None if mode is None else NegativeSampling(*mode),
      draws=jax_key_draws(2),
      neg_draws=jax_neg_draws(2, triplet=mode is not None
                              and mode[0] == 'triplet'),
      device='cpu', **kw)
  assert len(tl) == len(jl) == 5
  sample_one_hop.calls = gather_rows_plain.calls = 0
  n = 0
  for jb, tb in zip(jl, tl):
    for f in ('x', 'node', 'node_mask', 'edge_index', 'edge_mask', 'batch'):
      _same(getattr(tb, f), getattr(jb, f), f'batch {n} {f}')
    _check_metadata(tb.metadata, jb.metadata, f'batch {n}')
    n += 1
  assert n == 5
  assert (sample_one_hop.calls, gather_rows_plain.calls) == (5 * 2, 5)
  if mode is not None and mode[0] == 'binary':
    lab = tb.metadata['edge_label'][:8]
    valid = tb.metadata['edge_label_mask'][:8]
    assert bool((lab[~valid] == 0).all()) and bool((lab[valid] >= 1).all())


def _state(jds, edges, mode, tx):
  """A JAX loader and a train state initialised on another loader's
  batch (the init batch advances its loader's sampler)."""
  def loader():
    return JaxLinkLoader(jds, FANOUTS, edges, neg_sampling=JaxNeg(*mode),
                         batch_size=8, seed=0)
  fmodel = FlaxGraphSAGE(hidden_features=8, out_features=8, num_layers=2)
  state, apply_fn = create_train_state(fmodel, jax.random.key(0),
                                       next(iter(loader())), tx)
  return loader(), state, apply_fn


def _numpy_tree(params):
  return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize('mode', MODES[1:], ids=['binary', 'triplet'])
def test_link_losses_and_steps_match_jax(mode):
  """The loss of one batch from the same embeddings, then three
  `make_unsupervised_step` Adam steps from the same Flax params over the
  same (byte-equal) batches: losses and parameters within 1e-5."""
  jds, ds, rows, cols = _datasets(seed=2)
  edges = (rows[:40], cols[:40])
  tx = optax.adam(3e-3)
  jl, state, apply_fn = _state(jds, edges, mode, tx)
  model = GraphSAGE(D, 8, 8, num_layers=2)
  model.load_state_dict(graphsage_from_flax(_numpy_tree(state.params)))
  opt = torch.optim.Adam(model.parameters(), lr=3e-3, eps=1e-8)
  tl = LinkNeighborLoader(
      ds, FANOUTS, edges, neg_sampling=NegativeSampling(*mode), batch_size=8,
      seed=0, draws=jax_key_draws(0),
      neg_draws=jax_neg_draws(0, triplet=mode[0] == 'triplet'),
      device='cpu')
  emb = np.random.default_rng(5).standard_normal(
      (jl.sampler.node_capacity(8 * 4), 8)).astype(np.float32)
  jloss_fn = jax_binary_loss if mode[0] == 'binary' else jax_triplet_loss
  tloss_fn = (unsupervised_link_loss if mode[0] == 'binary'
              else triplet_link_loss)
  step = jax_step(apply_fn, tx)
  tstep = make_unsupervised_step(model, opt)
  for i, (jb, tb) in enumerate(zip(jl, tl)):
    if i == 0:
      e = emb[:tb.x.shape[0]]
      np.testing.assert_allclose(
          float(tloss_fn(torch.from_numpy(e), tb.metadata)),
          float(jloss_fn(e, jb.metadata)), rtol=1e-6, atol=1e-6)
    state, jloss = step(state, jb)
    loss = tstep(tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    if i == 2:
      break
  ref = graphsage_from_flax(_numpy_tree(state.params))
  for name, p in model.state_dict().items():
    np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=name)


def test_link_entry_points():
  """Seed edges of an edge type need a heterogeneous dataset (a
  homogeneous one raises ValueError; hetero link loading is held
  against JAX in test_torch_hetero_link.py); the entry points default
  to the card (and raise without one)."""
  _, ds, rows, cols = _datasets()
  with pytest.raises(ValueError, match='heterogeneous'):
    LinkNeighborLoader(ds, FANOUTS, (('a', 'to', 'b'), (rows, cols)),
                       device='cpu')
  sampler = NeighborSampler(ds.get_graph(), FANOUTS, device='cpu')
  with pytest.raises(ValueError, match='HeteroNeighborSampler'):
    sampler.sample_from_edges(EdgeSamplerInput(
        rows[:4], cols[:4], input_type=('a', 'to', 'b')))
  assert NegativeSampling.cast('triplet') == NegativeSampling('triplet', 1)
  assert NegativeSampling.cast(('binary', 2)).sample_size(3) == 6
  assert NegativeSampling.cast(None) is None
  with pytest.raises(ValueError):
    NegativeSampling('ternary')
  if torch.cuda.is_available():
    return
  model = GraphSAGE(D, 8, 8, num_layers=2)
  opt = torch.optim.Adam(model.parameters())
  for make in (lambda: LinkNeighborLoader(ds, FANOUTS, (rows, cols)),
               lambda: SubGraphLoader(ds, FANOUTS, np.arange(4)),
               lambda: RandomNegativeSampler(ds.get_graph()),
               lambda: FusedLinkEpoch(ds, FANOUTS, (rows, cols), model, opt,
                                      8)):
    with pytest.raises(RuntimeError, match='CUDA'):
      make()
