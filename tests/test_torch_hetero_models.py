"""`RGCN` and `HGT` against the JAX package's Flax modules: forwards from
the same parameters (carried over by `rgcn_from_flax` / `hgt_from_flax`)
on the same `HeteroBatch`, gradients of the masked seed loss, a batch
that lacks an edge type, and two Adam steps of the heterogeneous
supervised step against the JAX example's step.

Tolerances: f32 logits and gradients within 1e-5 (matmuls and
scatter-adds reduce in another order in XLA:CPU than in torch); bf16
(``dtype=bfloat16`` on both sides, f32 parameters) within 2e-2 of the
largest reference value (each library rounds to bf16 at its own
places, ~4e-3 relative a rounding, and a layer adds several); losses
and parameters after two Adam steps within 1e-5, correct counts equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphlearn_tpu.loader import NeighborLoader as JaxLoader
from graphlearn_tpu.models import GATConv as FlaxGATConv
from graphlearn_tpu.models import HGT as FlaxHGT
from graphlearn_tpu.models import RGCN as FlaxRGCN
from graphlearn_tpu.models.train import supervised_loss as jax_loss
from graphlearn_tpu_torch.loader import NeighborLoader
from graphlearn_tpu_torch.models import (HGT, RGCN, HeteroConv, SAGEConv,
                                         hgt_from_flax,
                                         make_hetero_eval_step,
                                         make_hetero_supervised_step,
                                         rgcn_from_flax, supervised_loss)
# _clean_env is an autouse fixture: importing it applies it here too
from test_torch_hetero import _clean_env  # noqa: F401
from test_torch_hetero import (CLASSES, NNODES, P, REV_WRITES, D,
                               datasets, jax_hetero_draws)

BATCH = 16
HIDDEN = 8


def _batches(n=2):
  jds, ds, _, _ = datasets(seed=2)
  idx = np.random.default_rng(3).permutation(NNODES[P])[:40]
  jl = JaxLoader(jds, [3, 2], (P, idx), batch_size=BATCH, shuffle=True,
                 seed=0)
  tl = NeighborLoader(ds, [3, 2], (P, idx), batch_size=BATCH, shuffle=True,
                      seed=0, draws=jax_hetero_draws(0), device='cpu')
  return list(zip(jl, tl))[:n]


def _flax_model(kind, etypes, dtype=None):
  if kind == 'rgcn':
    return FlaxRGCN(etypes=etypes, hidden_features=HIDDEN,
                    out_features=CLASSES, num_layers=2, target_ntype=P,
                    dtype=dtype)
  return FlaxHGT(ntypes=tuple(sorted(NNODES)), etypes=etypes,
                 hidden_features=HIDDEN, out_features=CLASSES,
                 num_layers=2, heads=2, target_ntype=P, dtype=dtype)


def _port_model(kind, etypes, params, dtype=None):
  tree = jax.tree_util.tree_map(np.asarray, params)
  if kind == 'rgcn':
    model = RGCN(etypes, D, HIDDEN, CLASSES, num_layers=2, target_ntype=P,
                 dtype=dtype)
    model.load_state_dict(rgcn_from_flax(tree))
  else:
    model = HGT(tuple(sorted(NNODES)), etypes, D, HIDDEN, CLASSES,
                num_layers=2, heads=2, target_ntype=P, dtype=dtype)
    model.load_state_dict(hgt_from_flax(tree))
  return model


def _inputs(batch, drop=None):
  ei = {et: v for et, v in batch.edge_index_dict.items() if et != drop}
  em = {et: v for et, v in batch.edge_mask_dict.items() if et != drop}
  return batch.x_dict, ei, em


def _close(got, ref, tol, what):
  got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
  scale = max(1.0, float(np.abs(ref).max())) if tol > 1e-4 else 1.0
  np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale,
                             err_msg=what)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('kind', ['rgcn', 'hgt'])
def test_forward_and_gradients_match_flax(kind, dtype):
  (jb, tb), = _batches(1)
  etypes = tuple(sorted(jb.edge_index_dict))
  jdt, tdt, tol = ((None, None, 1e-5) if dtype == 'f32'
                   else (jnp.bfloat16, torch.bfloat16, 2e-2))
  fmodel = _flax_model(kind, etypes, jdt)
  params = fmodel.init(jax.random.key(0), jb.x_dict, jb.edge_index_dict,
                       jb.edge_mask_dict)
  model = _port_model(kind, etypes, params, tdt)

  def jloss(p):
    logits = fmodel.apply(p, jb.x_dict, jb.edge_index_dict,
                          jb.edge_mask_dict)
    return jax_loss(logits, jb.y_dict[P], jb.batch_dict[P], BATCH), logits
  (lref, logits_ref), grads = jax.value_and_grad(jloss, has_aux=True)(params)
  logits = model(*_inputs(tb))
  assert logits.dtype == torch.float32 and logits.shape == (
      tb.x_dict[P].shape[0], CLASSES)
  _close(logits.detach().numpy(), logits_ref, tol, f'{kind} logits')
  loss = supervised_loss(logits, tb.y_dict[P], tb.batch_dict[P], BATCH)
  loss.backward()
  _close(float(loss.detach()), float(lref), tol, f'{kind} loss')
  ref = (rgcn_from_flax if kind == 'rgcn' else hgt_from_flax)(
      jax.tree_util.tree_map(np.asarray, grads))
  named = dict(model.named_parameters())
  assert set(ref) == set(named)
  for name, p in named.items():
    # a parameter the target's logits do not reach has no torch gradient
    # and a zero JAX one
    g = p.grad if p.grad is not None else torch.zeros_like(p)
    _close(g.numpy(), ref[name].numpy(), tol, f'{kind} grad {name}')


@pytest.mark.parametrize('kind', ['rgcn', 'hgt'])
def test_batch_without_an_edge_type_matches_flax(kind):
  """``rev_writes`` (emitted as ``writes``) dropped from the batch: RGCN
  runs it on an empty edge set, HGT skips it; both as in JAX, from
  parameters made on the full batch."""
  (jb, tb), = _batches(1)
  etypes = tuple(sorted(jb.edge_index_dict))
  drop = (REV_WRITES[2], 'writes', REV_WRITES[0])
  assert drop in etypes
  fmodel = _flax_model(kind, etypes)
  params = fmodel.init(jax.random.key(1), jb.x_dict, jb.edge_index_dict,
                       jb.edge_mask_dict)
  model = _port_model(kind, etypes, params)
  jx, jei, jem = _inputs(jb, drop)
  ref = fmodel.apply(params, jx, jei, jem)
  with torch.no_grad():
    got = model(*_inputs(tb, drop))
    full = model(*_inputs(tb))
  _close(got.numpy(), ref, 1e-5, f'{kind} without {drop}')
  assert not torch.allclose(got, full)


def test_make_conv_is_not_ported():
  """The factory mode is ported (held against Flax in
  test_torch_hetero_link.py and, for GAT, test_torch_gat.py): a
  `SAGEConv` or `GATConv` factory gives one conv per edge type and no
  self term for a targeted type; a factory that gives no torch module,
  such as JAX's own RGAT factory of Flax `GATConv`s, raises, and so
  does a compute dtype beside a factory."""
  from graphlearn_tpu_torch.models import GATConv
  etypes = [REV_WRITES, (P, 'cites', P)]
  conv = HeteroConv(etypes, D, 4, make_conv=SAGEConv)
  assert set(dict(conv.named_children())) == {
      'conv_paper__rev_writes__author', 'conv_paper__cites__paper'}
  gat = HeteroConv(etypes, D, 4,
                   make_conv=lambda i, o: GATConv(i, o // 2, heads=2))
  assert all(isinstance(getattr(gat, f'conv_{s}'), GATConv) for s in (
      'paper__rev_writes__author', 'paper__cites__paper'))
  with pytest.raises(NotImplementedError, match='not a torch module'):
    HeteroConv(etypes, D, 4, make_conv=lambda i, o: FlaxGATConv(o))
  with pytest.raises(ValueError, match='dtype'):
    HeteroConv(etypes, D, 4, make_conv=SAGEConv, dtype=torch.bfloat16)


@pytest.mark.parametrize('kind', ['rgcn', 'hgt'])
def test_hetero_train_and_eval_steps_match_jax(kind):
  """Two steps of `make_hetero_supervised_step` against the JAX
  example's step (`examples/hetero/train_hgt_mag.py:183-192`), then
  `make_hetero_eval_step`'s counts.  RGCN takes Adam(1e-3); HGT takes
  SGD(0.1): the biases of its ``k_*`` projections shift every score of
  a (target, edge type) segment alike, which that segment's max takes
  back, so their gradient is zero up to rounding, and Adam would turn
  each library's rounding noise into steps of up to its learning
  rate."""
  pairs = _batches(2)
  jb0 = pairs[0][0]
  etypes = tuple(sorted(jb0.edge_index_dict))
  fmodel = _flax_model(kind, etypes)
  params = fmodel.init(jax.random.key(2), jb0.x_dict, jb0.edge_index_dict,
                       jb0.edge_mask_dict)
  model = _port_model(kind, etypes, params)
  if kind == 'rgcn':
    tx = optax.adam(1e-3)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
  else:
    tx = optax.sgd(0.1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
  opt_state = tx.init(params)

  @jax.jit
  def jstep(params, opt_state, batch):
    def loss_fn(p):
      logits = fmodel.apply(p, batch.x_dict, batch.edge_index_dict,
                            batch.edge_mask_dict)
      return jax_loss(logits, batch.y_dict[P], batch.batch_dict[P], BATCH)
    loss, g = jax.value_and_grad(loss_fn)(params)
    upd, opt_state = tx.update(g, opt_state, params)
    return optax.apply_updates(params, upd), opt_state, loss

  step = make_hetero_supervised_step(model, opt, BATCH, P)
  for jb, tb in pairs:
    params, opt_state, jl = jstep(params, opt_state, jb)
    loss, correct = step(tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-5)
    assert 0 <= int(correct) <= BATCH
  ref = (rgcn_from_flax if kind == 'rgcn' else hgt_from_flax)(
      jax.tree_util.tree_map(np.asarray, params))
  for name, p in model.state_dict().items():
    np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=name)
  evaluate = make_hetero_eval_step(model, BATCH, P)
  for jb, tb in pairs:
    logits = fmodel.apply(params, jb.x_dict, jb.edge_index_dict,
                          jb.edge_mask_dict)
    seeds = np.asarray(jb.batch_dict[P])
    pred = np.argmax(np.asarray(logits)[:BATCH], axis=1)
    want = int(((pred == np.asarray(jb.y_dict[P])[:BATCH])
                & (seeds >= 0)).sum())
    c, t = evaluate(tb)
    assert (int(c), int(t)) == (want, int((seeds >= 0).sum()))
