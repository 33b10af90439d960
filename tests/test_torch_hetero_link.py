"""Heterogeneous link prediction against the JAX package: the five
cases of `tests/test_hetero_link_loader.py` (bipartite binary and
triplet negatives, a same-type relation, edges emitted under the
reversed types, the node counts forwarded as the negatives' space) with
every batch byte-equal to JAX's, `HeteroConv(make_conv=SAGEConv)`
against Flax's factory mode, and the bipartite example's ``BiSAGE``
(`chip_smoke.bisage_model`) loss and gradients from Flax parameters.

The port replays the JAX sampler's keys: a link batch's negatives at
``fold_in(key(seed), step)`` (`test_torch_negative.jax_neg_draws`; the
columns in the destination type's id space), its hops at ``step + 1``
(`test_torch_hetero.jax_hetero_draws`).  Tolerances: batches byte-equal
(labels by value); forwards, losses and gradients within 1e-5.
"""
import importlib.util
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphlearn_tpu.data import Dataset as JaxDataset
from graphlearn_tpu.loader import LinkNeighborLoader as JaxLinkLoader
from graphlearn_tpu.models import HeteroConv as FlaxHeteroConv
from graphlearn_tpu.models import SAGEConv as FlaxSAGEConv
from graphlearn_tpu.sampler import NegativeSampling as JaxNeg
from graphlearn_tpu_torch.data import Dataset
from graphlearn_tpu_torch.loader import HeteroBatch, LinkNeighborLoader
from graphlearn_tpu_torch.models import (HeteroConv, SAGEConv,
                                         hetero_conv_from_flax)
from graphlearn_tpu_torch.sampler import NegativeSampling
from graphlearn_tpu_torch.typing import reverse_edge_type
from test_torch_hetero import jax_hetero_draws
from test_torch_hetero_models import _batches
from test_torch_negative import jax_neg_draws
# _clean_env is an autouse fixture: importing it applies it here too
from test_torch_neighbor_loader import _clean_env  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
U, I = 'user', 'item'
ET = (U, 'clicks', I)
ET_REV = (I, 'rev_clicks', U)


def _chip_smoke():
  spec = importlib.util.spec_from_file_location('chip_smoke',
                                                ROOT / 'chip_smoke.py')
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _bipartite(nu=30, ni=12, deg=3, seed=0):
  """`tests/test_hetero_link_loader.py::_bipartite`: features whose
  value is the node id."""
  rng = np.random.default_rng(seed)
  rows = np.repeat(np.arange(nu), deg)
  cols = rng.integers(0, ni, nu * deg)
  ufeat = np.tile(np.arange(nu, dtype=np.float32)[:, None], (1, 4))
  ifeat = np.tile(np.arange(ni, dtype=np.float32)[:, None], (1, 4))
  edges = {ET: (rows, cols), ET_REV: (cols, rows)}
  counts = {U: nu, I: ni}
  jds = (JaxDataset().init_graph(edges, layout='COO', num_nodes=counts)
         .init_node_features({U: ufeat, I: ifeat}, split_ratio=1.0))
  ds = (Dataset().init_graph(edges, layout='COO', num_nodes=counts,
                             device='cpu')
        .init_node_features({U: ufeat, I: ifeat}, device='cpu'))
  return jds, ds, rows, cols


def _loaders(jds, ds, fanouts, seeds, mode, batch_size, seed=0):
  neg = None if mode is None else mode
  jl = JaxLinkLoader(jds, fanouts, seeds,
                     neg_sampling=None if neg is None else JaxNeg(*neg),
                     batch_size=batch_size, seed=seed)
  tl = LinkNeighborLoader(
      ds, fanouts, seeds,
      neg_sampling=None if neg is None else NegativeSampling(*neg),
      batch_size=batch_size, seed=seed, draws=jax_hetero_draws(seed),
      neg_draws=jax_neg_draws(seed, triplet=neg is not None
                              and neg[0] == 'triplet'), device='cpu')
  return jl, tl


def _same(got, ref, what, dtype=True):
  ref = np.asarray(ref)
  if dtype:
    assert got.numpy().dtype == ref.dtype, what
  np.testing.assert_array_equal(got.numpy(), ref, err_msg=what)


def _check_against_jax(tb: HeteroBatch, jb, what):
  """Every field of a hetero link batch byte-equal to JAX's (dict keys
  compared as sets: JAX's jitted sampler sorts them)."""
  assert isinstance(tb, HeteroBatch)
  for f in ('x_dict', 'node_dict', 'node_mask_dict', 'edge_index_dict',
            'edge_mask_dict', 'batch_dict'):
    got, ref = getattr(tb, f), getattr(jb, f)
    assert set(got) == set(ref), f'{what} {f}'
    for k in ref:
      _same(got[k], ref[k], f'{what} {f} {k}')
  assert tb.batch_size == jb.batch_size
  md, jmd = tb.metadata, jb.metadata
  assert set(md) == set(jmd), what
  assert md['input_type'] == jmd['input_type']
  assert set(md['seed_local']) == set(jmd['seed_local'])
  for nt in jmd['seed_local']:
    _same(md['seed_local'][nt], jmd['seed_local'][nt], f'{what} seed_local')
  for k in set(jmd) - {'input_type', 'seed_local'}:
    _same(md[k], jmd[k], f'{what} {k}', dtype=k != 'edge_label')


def test_bipartite_binary_negatives():
  """`test_hetero_link_loader.py:36-66`: positives resolve to edges
  through the two tables, negatives are strict non-edges in the item
  space, features prove the tables; byte-equal to JAX."""
  jds, ds, rows, cols = _bipartite()
  existing = set(zip(rows.tolist(), cols.tolist()))
  jl, tl = _loaders(jds, ds, [2, 2], (ET, (rows[:16], cols[:16])),
                    ('binary', 1.0), 8)
  batches = 0
  for jb, tb in zip(jl, tl):
    _check_against_jax(tb, jb, f'batch {batches}')
    batches += 1
    eli = tb.metadata['edge_label_index'].numpy()
    label = tb.metadata['edge_label'].numpy()
    mask = tb.metadata['edge_label_mask'].numpy()
    unodes, inodes = tb.node_dict[U].numpy(), tb.node_dict[I].numpy()
    assert eli.shape == (2, 16)
    for j in np.nonzero(mask)[0]:
      u, v = int(unodes[eli[0, j]]), int(inodes[eli[1, j]])
      assert 0 <= v < 12
      assert ((u, v) in existing) == (label[j] >= 1)
      assert float(tb.x_dict[U][eli[0, j], 0]) == float(u)
  assert batches == 2


def test_bipartite_triplet_metadata():
  """`test_hetero_link_loader.py:69-93`: triplet indices into the two
  tables, strict negative destinations in the item space."""
  jds, ds, rows, cols = _bipartite()
  existing = set(zip(rows.tolist(), cols.tolist()))
  jl, tl = _loaders(jds, ds, [2], (ET, (rows[:10], cols[:10])),
                    ('triplet', 2), 10)
  jb, tb = next(zip(jl, tl))
  _check_against_jax(tb, jb, 'triplet')
  unodes, inodes = tb.node_dict[U].numpy(), tb.node_dict[I].numpy()
  src = tb.metadata['src_index'].numpy()
  dpos = tb.metadata['dst_pos_index'].numpy()
  dneg = tb.metadata['dst_neg_index'].numpy()
  assert dneg.shape == (10, 2)
  for j in range(10):
    u, v = int(unodes[src[j]]), int(inodes[dpos[j]])
    assert (u, v) in existing
    for t in range(2):
      w = int(inodes[dneg[j, t]])
      assert 0 <= w < 12 and (u, w) not in existing


def test_same_type_hetero_link():
  """`test_hetero_link_loader.py:96-121`: source and destination types
  coincide (one table, sources first)."""
  p, e = 'paper', ('paper', 'cites', 'paper')
  rng = np.random.default_rng(0)
  n = 24
  rows = np.repeat(np.arange(n), 2)
  cols = rng.integers(0, n, n * 2)
  feats = np.tile(np.arange(n, dtype=np.float32)[:, None], (1, 4))
  jds = (JaxDataset().init_graph({e: (rows, cols)}, layout='COO',
                                 num_nodes={e: n})
         .init_node_features({p: feats}, split_ratio=1.0))
  ds = (Dataset().init_graph({e: (rows, cols)}, layout='COO',
                             num_nodes={e: n}, device='cpu')
        .init_node_features({p: feats}, device='cpu'))
  existing = set(zip(rows.tolist(), cols.tolist()))
  for mode in (('binary', 1.0), None):
    jl, tl = _loaders(jds, ds, [2], (e, (rows[:8], cols[:8])), mode, 8)
    jb, tb = next(zip(jl, tl))
    _check_against_jax(tb, jb, f'same type {mode}')
    eli = tb.metadata['edge_label_index'].numpy()
    label = tb.metadata['edge_label'].numpy()
    nodes = tb.node_dict[p].numpy()
    for j in range(eli.shape[1]):
      if label[j] >= 1:
        assert (int(nodes[eli[0, j]]), int(nodes[eli[1, j]])) in existing


def test_edges_emitted_under_reversed_types():
  """`test_hetero_link_loader.py:124-145`: the sampled edges come under
  the reversed types, row the discovered item and col the seed user;
  with ``with_edge`` each names its stored edge, and an item table kept
  under the emitted type is what ``edge_attr_dict`` reads."""
  jds, ds, rows, cols = _bipartite()
  rev = reverse_edge_type(ET)
  etab = np.random.default_rng(1).standard_normal(
      (rows.shape[0], 3)).astype(np.float32)
  jds.init_edge_features({rev: etab})
  ds.init_edge_features({rev: etab}, device='cpu')
  existing = set(zip(rows.tolist(), cols.tolist()))
  for with_edge in (False, True):
    jl = JaxLinkLoader(jds, [2, 2], (ET, (rows[:8], cols[:8])),
                       neg_sampling=JaxNeg('binary', 1.0), batch_size=8,
                       with_edge=with_edge, seed=0)
    tl = LinkNeighborLoader(ds, [2, 2], (ET, (rows[:8], cols[:8])),
                            neg_sampling=NegativeSampling('binary', 1.0),
                            batch_size=8, with_edge=with_edge, seed=0,
                            draws=jax_hetero_draws(0),
                            neg_draws=jax_neg_draws(0), device='cpu')
    jb, tb = next(zip(jl, tl))
    _check_against_jax(tb, jb, f'with_edge {with_edge}')
    assert set(tb.edge_index_dict) <= {rev, reverse_edge_type(ET_REV)}
    assert set(tb.edge_attr_dict) == set(jb.edge_attr_dict) == (
        {rev} if with_edge else set())
    ei = tb.edge_index_dict[rev].numpy()
    em = tb.edge_mask_dict[rev].numpy()
    unodes, inodes = tb.node_dict[U].numpy(), tb.node_dict[I].numpy()
    for j in np.nonzero(em)[0]:
      assert (int(unodes[ei[1, j]]), int(inodes[ei[0, j]])) in existing
    if with_edge:
      _same(tb.edge_attr_dict[rev], jb.edge_attr_dict[rev], 'edge_attr')
      ea = tb.edge_attr_dict[rev].numpy()
      assert not ea[~em].any()
      # each row is its stored edge's: the one between its endpoints
      for j in np.nonzero(em)[0]:
        hit = [k for k in range(rows.shape[0])
               if np.array_equal(etab[k], ea[j])]
        assert len(hit) == 1
        assert (rows[hit[0]], cols[hit[0]]) == (unodes[ei[1, j]],
                                                inodes[ei[0, j]])


def test_num_nodes_forwarded_for_negative_space():
  """`test_hetero_link_loader.py:148-166`: items without a click stay
  reachable as negatives (the count comes from ``init_graph``'s
  ``num_nodes``), and the batches match JAX's."""
  nu, ni = 10, 20
  rows = np.arange(nu)
  cols = rows % 8
  ufeat = np.ones((nu, 4), np.float32)
  jds = (JaxDataset().init_graph({ET: (rows, cols)}, layout='COO',
                                 num_nodes={U: nu, I: ni})
         .init_node_features({U: ufeat}, split_ratio=1.0))
  ds = (Dataset().init_graph({ET: (rows, cols)}, layout='COO',
                             num_nodes={U: nu, I: ni}, device='cpu')
        .init_node_features({U: ufeat}, device='cpu'))
  jl, tl = _loaders(jds, ds, [2], (ET, (rows, cols)), ('binary', 1.0), 10)
  assert tl.sampler._num_nodes[I] == jl.sampler._num_nodes[I] == ni
  jb, tb = next(zip(jl, tl))
  _check_against_jax(tb, jb, 'negative space')
  items = tb.node_dict[I].numpy()
  assert items.max() >= 8                 # an unclicked item was drawn


def _factory_inputs():
  (jb, tb), = _batches(1)
  return jb, tb, tuple(sorted(jb.edge_index_dict))


@pytest.mark.parametrize('aggr', ['sum', 'mean'])
@pytest.mark.parametrize('subset', [False, True], ids=['all', 'two'])
def test_hetero_conv_factory_matches_flax(aggr, subset):
  """`HeteroConv(make_conv=SAGEConv)` against Flax's factory mode
  (``lambda: SAGEConv(d)``) from the same parameters: every edge type
  (a self-relation run directly, the others bipartite), or two of them,
  so that the types nothing targets take their ``lin_self``; forward
  and gradients within 1e-5."""
  from test_torch_hetero import D
  jb, tb, etypes = _factory_inputs()
  if subset:
    etypes = (('paper', 'cites', 'paper'), ('author', 'writes', 'paper'))
  out = 5
  fconv = FlaxHeteroConv(etypes=etypes, out_features=out, aggr=aggr,
                         make_conv=lambda: FlaxSAGEConv(out))
  params = fconv.init(jax.random.key(2), jb.x_dict, jb.edge_index_dict,
                      jb.edge_mask_dict)
  conv = HeteroConv(etypes, {nt: D for nt in tb.x_dict}, out, aggr=aggr,
                    make_conv=SAGEConv)
  conv.load_state_dict(hetero_conv_from_flax(
      jax.tree_util.tree_map(np.asarray, params)))
  if subset:
    assert {n for n in dict(conv.named_children()) if 'self' in n} == {
        'lin_self_author', 'lin_self_institution'}

  def jloss(p):
    h = fconv.apply(p, jb.x_dict, jb.edge_index_dict, jb.edge_mask_dict)
    return sum(jnp.sum(v * v) for v in h.values()), h
  (lref, href), grads = jax.value_and_grad(jloss, has_aux=True)(params)
  h = conv(tb.x_dict, tb.edge_index_dict, tb.edge_mask_dict)
  assert set(h) == set(href)
  for nt in href:
    np.testing.assert_allclose(h[nt].detach().numpy(), np.asarray(href[nt]),
                               rtol=1e-5, atol=1e-5, err_msg=nt)
  sum((v * v).sum() for v in h.values()).backward()
  ref = hetero_conv_from_flax(jax.tree_util.tree_map(np.asarray, grads))
  named = dict(conv.named_parameters())
  assert set(ref) == set(named)
  for name, p in named.items():
    np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=1e-5,
                               atol=1e-4 * max(1.0, float(np.abs(
                                   ref[name].numpy()).max())),
                               err_msg=name)


def test_bisage_loss_and_grads_match_jax():
  """The bipartite example's ``BiSAGE`` and link loss
  (`examples/hetero/bipartite_sage_unsup.py:83-128`) in Flax against
  `chip_smoke.bisage_model` / `bisage_loss` on the same link batch and
  parameters: the loss and every gradient within 1e-5."""
  cs = _chip_smoke()
  rng = np.random.default_rng(3)
  nu, ni, d, hidden = 40, 16, 6, 8
  rows = np.repeat(np.arange(nu), 3)
  cols = rng.integers(0, ni, nu * 3)
  ufeat = rng.standard_normal((nu, d)).astype(np.float32)
  ifeat = rng.standard_normal((ni, d)).astype(np.float32)
  edges = {ET: (rows, cols), ET_REV: (cols, rows)}
  counts = {U: nu, I: ni}
  jds = (JaxDataset().init_graph(edges, layout='COO', num_nodes=counts)
         .init_node_features({U: ufeat, I: ifeat}))
  ds = (Dataset().init_graph(edges, layout='COO', num_nodes=counts,
                             device='cpu')
        .init_node_features({U: ufeat, I: ifeat}, device='cpu'))
  jl, tl = _loaders(jds, ds, [3, 3], (ET, (rows[:24], cols[:24])),
                    ('binary', 1.0), 12)
  jb, tb = next(zip(jl, tl))
  etypes = tuple(jb.edge_index_dict.keys())

  class FlaxBiSAGE(fnn.Module):
    @fnn.compact
    def __call__(self, x_dict, ei_dict, em_dict):
      h = {nt: fnn.Dense(hidden)(x) for nt, x in x_dict.items()}
      for li in range(2):
        conv = FlaxHeteroConv(etypes, hidden,
                              make_conv=lambda: FlaxSAGEConv(hidden),
                              name=f'conv{li}')
        h = conv(h, ei_dict, em_dict)
        if li == 0:
          h = {nt: fnn.relu(v) for nt, v in h.items()}
      return h
  fmodel = FlaxBiSAGE()
  params = fmodel.init(jax.random.key(0), jb.x_dict, jb.edge_index_dict,
                       jb.edge_mask_dict)

  def jloss(p):
    h = fmodel.apply(p, jb.x_dict, jb.edge_index_dict, jb.edge_mask_dict)
    eli = jb.metadata['edge_label_index']
    lab = jnp.minimum(jb.metadata['edge_label'], 1).astype(jnp.float32)
    mask = jb.metadata['edge_label_mask']
    eu = h[U][jnp.clip(eli[0], 0, h[U].shape[0] - 1)]
    ev = h[I][jnp.clip(eli[1], 0, h[I].shape[0] - 1)]
    ls = optax.sigmoid_binary_cross_entropy(jnp.sum(eu * ev, axis=-1), lab)
    w = (mask & (eli[0] >= 0) & (eli[1] >= 0)).astype(jnp.float32)
    return (ls * w).sum() / jnp.maximum(w.sum(), 1.0)
  lref, grads = jax.value_and_grad(jloss)(params)

  def port_state(tree):
    """Flax's per-type ``Dense_{i}`` (in the batch's type order) are the
    port's ``lin_{type}``."""
    state = hetero_conv_from_flax(jax.tree_util.tree_map(np.asarray, tree))
    for i, nt in enumerate(jb.x_dict):
      for leaf in ('weight', 'bias'):
        state[f'lin_{nt}.{leaf}'] = state.pop(f'Dense_{i}.{leaf}')
    return state
  model = cs.bisage_model(torch, tuple(sorted(etypes)), {U: d, I: d},
                          hidden)
  model.load_state_dict(port_state(params))
  h = model(tb.x_dict, tb.edge_index_dict, tb.edge_mask_dict)
  loss = cs.bisage_loss(torch, h, tb.metadata)
  loss.backward()
  np.testing.assert_allclose(float(loss.detach()), float(lref), rtol=1e-5,
                             atol=1e-5)
  ref = port_state(grads)
  named = dict(model.named_parameters())
  assert set(ref) == set(named)
  for name, p in named.items():
    np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=name)
