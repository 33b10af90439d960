"""One step of the distributed RGNN example's data-parallel train step
(`examples/igbh/dist_train_rgnn.py:119-160`, RGAT) at P = 4: the port's
`chip_smoke.rgnn_dp_step` on the port's batch against JAX's
``shard_map`` step on JAX's byte-equal batch
(`test_torch_dist_hetero.py` holds the batches), from the same Flax
parameters.  Tolerance: loss and parameters within 1e-5 (XLA's segment
sums and torch's ``index_add_`` add in different orders, and JAX's
gradient mean is a collective).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from graphlearn_tpu.models import GATConv as FlaxGATConv
from graphlearn_tpu.models import HeteroConv as FlaxHeteroConv
from graphlearn_tpu.parallel import DistHeteroNeighborLoader as JaxLoader
from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu.parallel.shard_map_compat import shard_map
from graphlearn_tpu_torch.models import hetero_conv_from_flax
from graphlearn_tpu_torch.parallel import DistHeteroNeighborLoader
from test_torch_dist_gns import _numpy_tree, jax_key_draws
from test_torch_dist_hetero import NP, PAPER, SIZES, _datasets, data  # noqa: F401
from test_torch_gat import chip_smoke


def _flax_rgnn(etypes, hidden, heads, classes):
  class RGNN(fnn.Module):
    @fnn.compact
    def __call__(self, x_dict, ei_dict, em_dict):
      h = {nt: fnn.Dense(hidden)(x) for nt, x in x_dict.items()}
      for li in range(2):
        conv = FlaxHeteroConv(
            etypes, hidden,
            make_conv=lambda: FlaxGATConv(hidden // heads, heads=heads),
            name=f'conv{li}')
        h = conv(h, ei_dict, em_dict)
        h = {nt: fnn.relu(v) for nt, v in h.items()}
      return fnn.Dense(classes)(h[PAPER])
  return RGNN()


def test_dp_rgat_step_matches_jax(data):
  """One step of the distributed example's DP step (masked
  cross-entropy a partition, gradients and loss averaged over the
  partitions, Adam 1e-3) on the same batch: `chip_smoke.rgnn_dp_step`
  (the partitions as one union graph) leaves the loss and every updated
  parameter within 1e-5 of JAX's ``shard_map`` step."""
  hidden, heads, classes, bs = 16, 2, SIZES['classes'], 16
  jds, ds = _datasets(data, 1.0)
  seeds = (PAPER, np.arange(SIZES['npaper']))
  kw = dict(batch_size=bs, shuffle=True, seed=0)
  jb = next(iter(JaxLoader(jds, [3, 2], seeds, mesh=jax_make_mesh(NP),
                           **kw)))
  tb = next(iter(DistHeteroNeighborLoader(ds, [3, 2], seeds,
                                          draws=jax_key_draws(0),
                                          device='cpu', **kw)))
  etypes = tuple(jb.edge_index_dict.keys())
  model = _flax_rgnn(etypes, hidden, heads, classes)
  single = jax.tree_util.tree_map(lambda v: v[0], jb)
  params = model.init(jax.random.key(0), single.x_dict,
                      single.edge_index_dict, single.edge_mask_dict)
  tx = optax.adam(1e-3)
  opt = tx.init(params)

  def device_step(params, opt, batch):
    batch = jax.tree_util.tree_map(lambda v: v[0], batch)

    def loss_fn(p):
      logits = model.apply(p, batch.x_dict, batch.edge_index_dict,
                           batch.edge_mask_dict)
      y = batch.y_dict[PAPER][:bs]
      valid = (batch.batch_dict[PAPER].reshape(-1) >= 0).astype(
          logits.dtype)
      ce = optax.softmax_cross_entropy_with_integer_labels(logits[:bs], y)
      return (ce * valid).sum() / jnp.maximum(valid.sum(), 1.0)

    loss, g = jax.value_and_grad(loss_fn)(params)
    g = jax.lax.pmean(g, 'data')
    loss = jax.lax.pmean(loss, 'data')
    upd, opt = tx.update(g, opt, params)
    return optax.apply_updates(params, upd), opt, loss[None]

  spec = jax.sharding.PartitionSpec
  step = jax.jit(shard_map(device_step, mesh=jax_make_mesh(NP),
                           in_specs=(spec(), spec(), spec('data')),
                           out_specs=(spec(), spec(), spec('data'))))
  new_params, _, jloss = step(params, opt, jb)

  cs = chip_smoke()
  tmodel = cs.rgnn_model(torch, ds.node_features, etypes,
                         {nt: f.feature_dim for nt, f in
                          ds.node_features.items()}, classes, 'rgat',
                         hidden=hidden, heads=heads)
  tmodel.load_state_dict(hetero_conv_from_flax(_numpy_tree(params)))
  opt_t = torch.optim.Adam(tmodel.parameters(), lr=1e-3, eps=1e-8)
  loss = cs.rgnn_dp_step(torch, tmodel, opt_t, bs)(tb)
  assert abs(float(loss) - float(np.asarray(jloss)[0])) <= 1e-5
  want = hetero_conv_from_flax(_numpy_tree(new_params))
  got = tmodel.state_dict()
  assert set(got) == set(want)
  for k, v in want.items():
    np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                               atol=1e-5, err_msg=k)
