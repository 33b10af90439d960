"""The port's `TreeSAGE` against the Flax module, with the Flax params
carried across by `tree_sage_from_flax`.

Tolerance ``rtol=1e-5, atol=1e-5``: f32 matmuls reduce in another order
on XLA:CPU than in torch.  With ``dtype=bfloat16`` (params f32, compute
bf16, f32 logits) ``rtol=atol=2e-2``: every bf16 rounding (8 mantissa
bits, ~4e-3 relative) happens at its own place in each library's
matmul and mean, and a few roundings add up over the layers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.models.tree import TreeSAGE as FlaxTreeSAGE
from graphlearn_tpu.models.tree import tree_level_sizes as jax_level_sizes
from graphlearn_tpu_torch.models import (TreeSAGE, tree_level_sizes,
                                         tree_sage_from_flax)

D, HIDDEN, OUT = 6, 8, 5


def _levels(batch, fanouts, seed):
  rng = np.random.default_rng(seed)
  sizes = tree_level_sizes(batch, fanouts)
  xs = [rng.standard_normal((s, D)).astype(np.float32) for s in sizes]
  masks = [rng.random(s) < 0.7 for s in sizes]
  masks[0][:] = True
  masks[0][-1] = False                    # a masked seed slot
  k1 = fanouts[0]
  masks[1][:k1] = False                   # a fully-masked child window
  return xs, masks


def _numpy_tree(params):
  return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize('fanouts', [(3, 2), (4, 3, 2)])
def test_logits_match_flax(fanouts):
  layers = len(fanouts)
  xs, masks = _levels(4, fanouts, seed=layers)
  flax_model = FlaxTreeSAGE(hidden_features=HIDDEN, out_features=OUT,
                            num_layers=layers)
  jxs = [jnp.asarray(x) for x in xs]
  jms = [jnp.asarray(m) for m in masks]
  params = flax_model.init(jax.random.key(layers), jxs, jms)
  ref = np.asarray(flax_model.apply(params, jxs, jms))

  model = TreeSAGE(D, HIDDEN, OUT, num_layers=layers)
  model.load_state_dict(tree_sage_from_flax(_numpy_tree(params)))
  with torch.no_grad():
    got = model([torch.from_numpy(x) for x in xs],
                [torch.from_numpy(m) for m in masks])
  assert got.dtype == torch.float32 and got.shape == (4, OUT)
  np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
  assert tree_level_sizes(4, fanouts) == jax_level_sizes(4, fanouts)


def test_flax_layout_and_init():
  fanouts = (3, 2)
  xs, masks = _levels(2, fanouts, seed=9)
  flax_model = FlaxTreeSAGE(hidden_features=HIDDEN, out_features=OUT,
                            num_layers=2)
  params = _numpy_tree(flax_model.init(
      jax.random.key(0), [jnp.asarray(x) for x in xs],
      [jnp.asarray(m) for m in masks]))
  state = tree_sage_from_flax(params['params'])    # no 'params' level
  k = params['params']['layer0_self']['kernel']
  assert state['layer0_self.weight'].shape == (HIDDEN, D)
  np.testing.assert_array_equal(state['layer0_self.weight'].numpy(), k.T)
  assert 'layer0_neigh.bias' not in state
  model = TreeSAGE(D, HIDDEN, OUT, num_layers=2)
  assert set(model.state_dict()) == set(state)

  a, b = (TreeSAGE(D, HIDDEN, OUT, num_layers=2) for _ in range(2))
  a.reset_parameters(torch.Generator().manual_seed(3))
  b.reset_parameters(torch.Generator().manual_seed(3))
  for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
    assert torch.equal(pa, pb)
    fan_in = a.get_submodule(name.rsplit('.', 1)[0]).in_features
    assert pa.abs().max() <= 1.0 / np.sqrt(fan_in)
  with pytest.raises(ValueError, match='levels'):
    a([torch.zeros(1, D)], [torch.ones(1, dtype=torch.bool)])


@pytest.mark.parametrize('fanouts', [(3, 2), (4, 3, 2)])
def test_bf16_logits_match_flax(fanouts):
  layers = len(fanouts)
  xs, masks = _levels(4, fanouts, seed=10 + layers)
  flax_model = FlaxTreeSAGE(hidden_features=HIDDEN, out_features=OUT,
                            num_layers=layers, dtype=jnp.bfloat16)
  jxs = [jnp.asarray(x) for x in xs]
  jms = [jnp.asarray(m) for m in masks]
  params = flax_model.init(jax.random.key(layers), jxs, jms)
  assert all(p.dtype == jnp.float32
             for p in jax.tree_util.tree_leaves(params))
  ref = np.asarray(flax_model.apply(params, jxs, jms))
  assert ref.dtype == np.float32

  model = TreeSAGE(D, HIDDEN, OUT, num_layers=layers, dtype=torch.bfloat16)
  model.load_state_dict(tree_sage_from_flax(_numpy_tree(params)))
  assert all(p.dtype == torch.float32 for p in model.parameters())
  with torch.no_grad():
    got = model([torch.from_numpy(x) for x in xs],
                [torch.from_numpy(m) for m in masks])
  assert got.dtype == torch.float32 and got.shape == (4, OUT)
  np.testing.assert_allclose(got.numpy(), ref, rtol=2e-2, atol=2e-2)
  # the logits really are bf16 values, not an f32 forward
  assert torch.equal(got, got.bfloat16().float())
  f32 = TreeSAGE(D, HIDDEN, OUT, num_layers=layers)
  f32.load_state_dict(model.state_dict())
  with torch.no_grad():
    full = f32([torch.from_numpy(x) for x in xs],
               [torch.from_numpy(m) for m in masks])
  assert not torch.equal(got, full)
