"""The port's graph attention against the JAX package's Flax modules:
`segment_softmax` (targets with no valid edge, fully masked inputs),
`GATConv` with heads concatenated and averaged, and the RGAT of
`tests/test_hetero_models.py:110` (per-type Dense, two
`HeteroConv(make_conv=GATConv)` layers, a Dense head) loaded through
`gat_conv_from_flax` / `hetero_conv_from_flax`, on inputs made from a
numpy seed with masked edges, a target with no valid edge and an edge
type whose every edge is masked.  Tolerance: values and gradients
within 1e-5 (XLA's segment sums and torch's ``index_add_`` add in
different orders).
"""
import importlib.util
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.models import GATConv as FlaxGATConv
from graphlearn_tpu.models import HeteroConv as FlaxHeteroConv
from graphlearn_tpu.models.conv import segment_softmax as jax_softmax
from graphlearn_tpu_torch.models import (GATConv, gat_conv_from_flax,
                                         hetero_conv_from_flax,
                                         segment_softmax)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
U, I = 'user', 'item'


def chip_smoke():
  """`chip_smoke.py` as a module: its ``rgnn_model``, ``rgnn_dp_step`` and
  ``union_graph`` are the IGBH example's RGNN and DP step that run on
  the card."""
  spec = importlib.util.spec_from_file_location('chip_smoke',
                                                ROOT / 'chip_smoke.py')
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _edges(rng, n_src, n_dst, e, masked_targets=(), all_masked=False):
  """``[2, e]`` int32 edges (-1 in masked slots) and their mask: about
  a fifth masked, no valid edge into ``masked_targets``."""
  src = rng.integers(0, n_src, e).astype(np.int32)
  dst = rng.integers(0, n_dst, e).astype(np.int32)
  mask = rng.random(e) > 0.2
  mask &= ~np.isin(dst, masked_targets)
  if all_masked:
    mask[:] = False
  src = np.where(mask, src, -1).astype(np.int32)
  dst = np.where(mask, dst, -1).astype(np.int32)
  return np.stack([src, dst]), mask


def test_segment_softmax_matches_jax():
  rng = np.random.default_rng(0)
  n, e, h = 9, 60, 3
  scores = rng.standard_normal((e, h)).astype(np.float32) * 3
  ei, mask = _edges(rng, n, n, e, masked_targets=(2, 5))
  dst = ei[1]
  cot = rng.standard_normal((e, h)).astype(np.float32)

  def jf(s):
    w = jax_softmax(s, jnp.asarray(dst), n, jnp.asarray(mask))
    return jnp.sum(w * cot), w
  (_, jw), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(scores))
  s = torch.from_numpy(scores).requires_grad_()
  w = segment_softmax(s, torch.from_numpy(dst), n, torch.from_numpy(mask))
  (w * torch.from_numpy(cot)).sum().backward()
  np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), rtol=TOL,
                             atol=TOL)
  np.testing.assert_allclose(s.grad.numpy(), np.asarray(jg), rtol=TOL,
                             atol=TOL)
  # weights sum to 1 over each target's valid edges, 0 elsewhere
  tot = np.zeros((n, h), np.float32)
  np.add.at(tot, dst[mask], w.detach().numpy()[mask])
  has = np.isin(np.arange(n), dst[mask])
  np.testing.assert_allclose(tot[has], 1.0, atol=1e-6)
  assert not tot[~has].any() and not w.detach().numpy()[~mask].any()
  # every edge masked: zero weights, a finite zero gradient
  s2 = torch.from_numpy(scores).requires_grad_()
  w2 = segment_softmax(s2, torch.from_numpy(dst), n,
                       torch.zeros(e, dtype=torch.bool))
  (w2 * torch.from_numpy(cot)).sum().backward()
  assert not w2.detach().any() and torch.equal(s2.grad,
                                               torch.zeros_like(s2))


@pytest.mark.parametrize('concat', [True, False])
def test_gat_conv_matches_flax(concat):
  rng = np.random.default_rng(1)
  n, d, f, heads = 12, 7, 4, 3
  x = rng.standard_normal((n, d)).astype(np.float32)
  ei, mask = _edges(rng, n, n, 50, masked_targets=(4,))
  fconv = FlaxGATConv(f, heads=heads, concat=concat)
  params = fconv.init(jax.random.key(3), x, ei, mask)

  def jloss(p, xx):
    out = fconv.apply(p, xx, ei, mask)
    return jnp.sum(out * out), out
  (_, jout), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(params, x)
  conv = GATConv(d, f, heads=heads, concat=concat)
  conv.load_state_dict(gat_conv_from_flax(_np(params)))
  xt = torch.from_numpy(x).requires_grad_()
  out = conv(xt, torch.from_numpy(ei), torch.from_numpy(mask))
  assert out.shape == ((n, heads * f) if concat else (n, f))
  np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                             rtol=TOL, atol=TOL)
  (out * out).sum().backward()
  np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=TOL,
                             atol=TOL)
  ref = gat_conv_from_flax(_np(jg))
  for name, p in conv.named_parameters():
    np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), rtol=TOL,
                               atol=TOL, err_msg=name)
  # the target with no valid edge aggregates nothing
  assert not out[4].any()


def _rgat_inputs():
  """Two node types of 10 and 7 rows (width 12), three edge types: one
  within users, one user -> item with a target left without edges, and
  an item -> user type whose every edge is masked."""
  rng = np.random.default_rng(2)
  x = {U: rng.standard_normal((10, 12)).astype(np.float32),
       I: rng.standard_normal((7, 12)).astype(np.float32)}
  ei, em = {}, {}
  for et, (ns, nd, kw) in {
      (U, 'follows', U): (10, 10, {}),
      (U, 'clicks', I): (10, 7, {'masked_targets': (3,)}),
      (I, 'rev_clicks', U): (7, 10, {'all_masked': True})}.items():
    ei[et], em[et] = _edges(rng, ns, nd, 40, **kw)
  return x, ei, em


def test_rgat_hetero_conv_matches_flax():
  """The Flax RGAT of `tests/test_hetero_models.py:110` (Dense(16) a
  type, two `HeteroConv(make_conv=lambda: GATConv(8, heads=2))` layers,
  Dense(3) on users) and `chip_smoke.rgnn_model` (the port's RGNN) with
  the same parameters: logits and every parameter's gradient within
  1e-5."""
  x, ei, em = _rgat_inputs()
  etypes = tuple(ei)

  class RGAT(fnn.Module):
    @fnn.compact
    def __call__(self, x_dict, ei_dict, em_dict):
      h = {nt: fnn.Dense(16)(v) for nt, v in x_dict.items()}
      for li in range(2):
        conv = FlaxHeteroConv(etypes, 16,
                              make_conv=lambda: FlaxGATConv(8, heads=2),
                              name=f'conv{li}')
        h = conv(h, ei_dict, em_dict)
        h = {nt: fnn.relu(v) for nt, v in h.items()}
      return fnn.Dense(3)(h[U])

  fmodel = RGAT()
  # Flax names the per-type Dense layers in the dict's (sorted) order
  jx = {nt: x[nt] for nt in sorted(x)}
  params = fmodel.init(jax.random.key(4), jx, ei, em)

  def jloss(p):
    out = fmodel.apply(p, jx, ei, em)
    return jnp.sum(out * out), out
  (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(params)
  model = chip_smoke().rgnn_model(torch, sorted(x), etypes, {U: 12, I: 12},
                                 3, 'rgat', hidden=16, heads=2, target=U)
  model.load_state_dict(hetero_conv_from_flax(_np(params)))
  t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
  out = model(t(x), t(ei), t(em))
  np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                             rtol=TOL, atol=TOL)
  (out * out).sum().backward()
  ref = hetero_conv_from_flax(_np(jg))
  named = dict(model.named_parameters())
  assert set(ref) == set(named)
  for name, p in named.items():
    # a parameter the head does not reach (the last layer's item
    # output) has no gradient in torch and a zero one in JAX
    g = p.grad if p.grad is not None else torch.zeros_like(p)
    np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=TOL,
                               atol=TOL, err_msg=name)
  # the all-masked edge type's attention parameters get no gradient
  assert not named['conv1.conv_item__rev_clicks__user.att_src'].grad.any()
