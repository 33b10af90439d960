"""`GCNConv`, `GCN` and SEAL's `DGCNN` against the JAX package's Flax
modules, from carried parameters (`gcn_from_flax`, `dgcnn_from_flax`):
logits and every parameter's gradient of a weighted sum of the logits.

DGCNN runs behind a label embedding as SEAL's classifier does
(`examples/seal_link_pred.py`'s ``SealDGCNN``: ``Embed(16, 32)`` then
``DGCNN(32, 2, 3 layers, k)``), on a subgraph with masked edges and
padded node slots, on one whose sort keys all tie exactly (the last
GCN layer zeroed: the pool must keep the lower index first, as
`jax.lax.top_k` does), and on one with fewer valid nodes than ``k``.
Tolerance: 1e-5 (f32 matmuls and scatter-adds reduce in another order
in XLA:CPU than in torch).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from graphlearn_tpu.models import DGCNN as FlaxDGCNN
from graphlearn_tpu.models import GCN as FlaxGCN
from graphlearn_tpu.models.conv import GCNConv as FlaxGCNConv
from graphlearn_tpu_torch.models import (DGCNN, GCN, GCNConv,
                                         dgcnn_from_flax, gcn_from_flax)

TOL = dict(rtol=1e-5, atol=1e-5)


def _subgraph(n, e, seed, masked=0.2):
  """A random local COO over ``n`` slots with a share of masked (-1)
  edges."""
  rng = np.random.default_rng(seed)
  ei = rng.integers(0, n, (2, e)).astype(np.int32)
  em = rng.random(e) >= masked
  ei[:, ~em] = -1
  return ei, em


def _numpy(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _grads(model, inputs, c):
  model.zero_grad()
  out = model(*inputs)
  (out * torch.from_numpy(c)).sum().backward()
  return out.detach().numpy(), {k: p.grad.numpy()
                                for k, p in model.named_parameters()}


def _check(model, fmodel, params, to_state, jin, tin, seed):
  model.load_state_dict(to_state(_numpy(params)))
  out = fmodel.apply(params, *jin)
  c = np.random.default_rng(seed).standard_normal(out.shape).astype(
      np.float32)
  g = jax.grad(lambda p: jnp.sum(fmodel.apply(p, *jin) * c))(params)
  got, grads = _grads(model, tin, c)
  np.testing.assert_allclose(got, np.asarray(out), **TOL)
  ref = to_state(_numpy(g))
  assert set(ref) == set(grads)
  for name in ref:
    np.testing.assert_allclose(grads[name], ref[name].numpy(), **TOL,
                               err_msg=name)


@pytest.mark.parametrize('masked', [0.0, 0.3])
def test_gcn_conv_and_gcn_match_flax(masked):
  n, d = 30, 5
  ei, em = _subgraph(n, 90, seed=1, masked=masked)
  x = np.random.default_rng(2).standard_normal((n, d)).astype(np.float32)
  jin = (jnp.asarray(x), jnp.asarray(ei), jnp.asarray(em))
  tin = (torch.from_numpy(x), torch.from_numpy(ei), torch.from_numpy(em))

  fconv = FlaxGCNConv(7)
  params = fconv.init(jax.random.key(0), *jin)

  def conv_state(p):              # the one conv's entries, unprefixed
    return {k.split('.', 1)[1]: v
            for k, v in gcn_from_flax({'c': p['params']}).items()}
  _check(GCNConv(d, 7), fconv, params, conv_state, jin, tin, seed=3)

  fgcn = FlaxGCN(hidden_features=8, out_features=4, num_layers=3)
  params = fgcn.init(jax.random.key(1), *jin)
  _check(GCN(d, 8, 4, num_layers=3), fgcn, params, gcn_from_flax, jin,
         tin, seed=4)


class FlaxSeal(fnn.Module):
  """`examples/seal_link_pred.py`'s ``SealDGCNN``."""
  hidden: int = 32
  max_label: int = 16
  k: int = 30

  @fnn.compact
  def __call__(self, lab, edge_index, edge_mask, node_mask):
    x = fnn.Embed(self.max_label, self.hidden)(
        jnp.clip(lab, 0, self.max_label - 1))
    return FlaxDGCNN(hidden_features=self.hidden, out_features=2,
                     num_layers=3, k=self.k)(x, edge_index, edge_mask,
                                             node_mask)


class Seal(nn.Module):
  """The same classifier on the port's modules."""

  def __init__(self, hidden=32, max_label=16, k=30):
    super().__init__()
    self.max_label = max_label
    self.embed = nn.Embedding(max_label, hidden)
    self.dgcnn = DGCNN(hidden, hidden, 2, num_layers=3, k=k)

  def forward(self, lab, edge_index, edge_mask, node_mask):
    x = self.embed(lab.long().clamp(0, self.max_label - 1))
    return self.dgcnn(x, edge_index, edge_mask, node_mask)


@pytest.mark.parametrize('case', ['subgraph', 'ties', 'fewer_than_k',
                                  'small_k'])
def test_dgcnn_matches_flax(case):
  n, k = {'subgraph': (48, 30), 'ties': (40, 30), 'fewer_than_k': (12, 30),
          'small_k': (24, 3)}[case]
  rng = np.random.default_rng(5)
  ei, em = _subgraph(n, 4 * n, seed=6)
  lab = rng.integers(0, 20, n).astype(np.int32)   # some past max_label
  nm = np.ones(n, bool)
  nm[n - n // 6:] = False                         # padded slots
  if case == 'fewer_than_k':
    nm[5:] = False
  ei[:, ~(nm[np.clip(ei[0], 0, n - 1)] & nm[np.clip(ei[1], 0, n - 1)])] = -1
  em &= ei[0] >= 0
  jin = tuple(jnp.asarray(a) for a in (lab, ei, em, nm))
  tin = tuple(torch.from_numpy(a) for a in (lab, ei, em, nm))
  fmodel = FlaxSeal(k=k)
  params = fmodel.init(jax.random.key(7), *jin)
  if case == 'ties':
    # the 1-wide layer outputs 0 everywhere: every valid key ties
    last = params['params']['DGCNN_0']['conv3']['Dense_0']
    last['kernel'] = jnp.zeros_like(last['kernel'])
    last['bias'] = jnp.zeros_like(last['bias'])
  model = Seal(k=k)
  _check(model, fmodel, params, dgcnn_from_flax, jin, tin, seed=8)
  if case == 'ties':
    out = model(*tin)
    # the pool took the first k valid slots in index order: moving the
    # last valid node (past the first k) to the front changes the logits
    last = n - n // 6 - 1
    assert last >= k
    perm = np.r_[last, np.arange(last), np.arange(last + 1, n)]
    inv = np.argsort(perm)
    ei_p = np.where(ei >= 0, inv[np.clip(ei, 0, n - 1)], -1).astype(np.int32)
    moved = model(torch.from_numpy(lab[perm]), torch.from_numpy(ei_p),
                  torch.from_numpy(em), torch.from_numpy(nm[perm]))
    assert not torch.allclose(out, moved)
