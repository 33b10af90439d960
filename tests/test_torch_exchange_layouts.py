"""The port's exchange layouts (`parallel.exchange`: dense, compact,
hier) against the JAX package's `parallel/exchange.py`.

The capacity plans (`capacity_spec`, `resolve_layout`, `mesh_factors`)
must equal JAX's field for field at every mesh size from 1 to 128; a
P = 16 loader must run the compact exchange JAX's ``'auto'`` picks there
(the slots counter holds JAX's `ExchangeSpec.slots`); the compact and
hier plans must equal JAX's `plan_exchange` under `shard_map` on the
8-device CPU mesh (receive buffers, kept and delivered masks, counters,
replies), with and without payload; a P = 8 `DistNeighborLoader` under
each layout must give JAX's batches and counters, and the hier
`AdaptiveSlack` walk JAX's rungs.  Everything is exact.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.parallel import DistDataset as JaxDistDataset
from graphlearn_tpu.parallel import DistNeighborLoader as JaxLoader
from graphlearn_tpu.parallel import exchange as jex
from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu.parallel.partition_book import range_owner_fn as jrof
from graphlearn_tpu.parallel.shard_map_compat import shard_map
from graphlearn_tpu_torch.parallel import (DistDataset, DistNeighborLoader,
                                           make_mesh)
from graphlearn_tpu_torch.parallel import exchange as tex
from graphlearn_tpu_torch.parallel.dist_sampler import (_BookPlan,
                                                        _LayoutPlan,
                                                        _make_plan)
from graphlearn_tpu_torch.parallel.partition_book import (identity_spec,
                                                          range_owner_fn)
from test_torch_dist_gns import _clean_env, _graph, jax_key_draws

FIELDS = ('node', 'x', 'y', 'edge_index', 'edge_mask')
COUNTERS = ('dist.frontier.offered', 'dist.frontier.dropped',
            'dist.frontier.slots', 'dist.feature.offered',
            'dist.feature.dropped', 'dist.feature.slots')


@pytest.fixture
def no_ragged(monkeypatch):
  """JAX's resolution without `jax.lax.ragged_all_to_all` (its CPU
  behaviour on JAX releases that lack it), which the port always has."""
  _clean_env(monkeypatch)
  monkeypatch.setattr(jex, 'HAVE_RAGGED', False)


def _fields(spec):
  if spec is None:
    return None
  return (spec.layout, spec.num_parts, spec.capacity, spec.pool, spec.rows,
          spec.cols, tuple(spec.stage_caps), spec.slots)


def test_capacity_spec_and_resolution_equal_jax(no_ragged):
  for p in range(1, 129):
    assert tex.mesh_factors(p) == jex.mesh_factors(p), p
    for layout in (None, 'auto', 'dense', 'compact', 'hier', 'ragged'):
      assert tex.resolve_layout(layout, p) == jex.resolve_layout(layout, p)
      for n in (64, 1024, 10240):
        for slack in (None, 0.75, 1.0, 1.25, 2.0, 3.0):
          want = jex.capacity_spec(n, p, slack, layout=layout)
          assert _fields(tex.capacity_spec(n, p, slack, layout=layout)) == \
              _fields(want), (p, layout, n, slack)
  for p in (8, 16, 64):                  # the EWMA caps
    for d, t in ((1, 8), (40, 300), (512, 4096), (None, 64), (96, None)):
      for layout in ('compact', 'dense', 'hier'):
        assert _fields(tex.capacity_spec(1000, p, 1.25, layout=layout,
                                         dest_cap=d, traffic_cap=t)) == \
            _fields(jex.capacity_spec(1000, p, 1.25, layout=layout,
                                      dest_cap=d, traffic_cap=t))
  with pytest.raises(ValueError):
    tex.resolve_layout('spiral', 8)


@pytest.mark.parametrize('env', ['hier', 'compact', 'dense', 'ragged'])
def test_env_layout_and_fallbacks_equal_jax(no_ragged, monkeypatch, env):
  """``GLT_EXCHANGE_LAYOUT`` wins over 'auto' only; hier falls back to
  dense below four partitions and to compact at a prime count; 'ragged'
  runs compact."""
  monkeypatch.setenv('GLT_EXCHANGE_LAYOUT', env)
  for p in (1, 2, 3, 4, 7, 8, 9, 13, 16, 64):
    for layout in (None, 'auto', 'dense', 'hier'):
      assert tex.resolve_layout(layout, p) == jex.resolve_layout(layout, p)
  assert tex.resolve_layout('ragged', 16) == 'compact'


@pytest.mark.parametrize('slack', ['auto', 'adaptive'])
def test_p16_loader_runs_jax_compact_exchange(monkeypatch, slack):
  """At P = 16 the default layout is compact in both packages, and the
  port's frontier exchange takes JAX's `ExchangeSpec.slots` per hop (the
  dense plan took ``P * max(ceil(n / P * 2), 64)`` a partition)."""
  _clean_env(monkeypatch)
  p, n, b, fanouts = 16, 2000, 8, (3, 2)
  rows, cols, _, _ = _graph(n)
  ds = DistDataset.from_full_graph(p, rows, cols, num_nodes=n, device='cpu')
  tl = DistNeighborLoader(ds, list(fanouts), np.arange(n), batch_size=b,
                          shuffle=True, collect_features=False,
                          exchange_slack=slack, device='cpu')
  assert tl.sampler.exchange_layout == 'auto'
  assert tex.resolve_layout(None, p) == jex.resolve_layout(None, p) == \
      'compact'
  next(iter(tl))
  st = tl.sampler.exchange_stats(tick_metrics=False)
  widths = [b * int(np.prod(fanouts[:h])) for h in range(len(fanouts))]
  want = sum(p * jex.capacity_spec(w, p, 2.0).slots for w in widths)
  assert jex.capacity_spec(widths[0], p, 2.0).layout == 'compact'
  assert st['dist.frontier.slots'] == want
  assert st['dist.frontier.slots'] < sum(
      p * jex.capacity_spec(w, p, 2.0, layout='dense').slots for w in widths)


# -- the plans against JAX's under shard_map --------------------------------

P8 = 8
BOUNDS = np.arange(P8 + 1, dtype=np.int64) * 30


def _jax_plan(ids, payload, spec):
  mesh = jax_make_mesh(P8)
  bounds = jnp.asarray(BOUNDS)
  from jax.sharding import PartitionSpec as PS

  def per_device(ids_s, pl_s):
    plan = jex.plan_exchange(ids_s[0], jrof(bounds), P8, 'data', spec,
                             payload=None if payload is None else pl_s[0])
    # each owner answers with its id * 3 + 1 (-1 where empty)
    ans = jnp.where(plan.recv >= 0, plan.recv * 3 + 1, -1)
    out = (plan.recv, plan.kept, plan.delivered, jnp.stack(plan.stats),
           plan.reply(ans, fill=-7),
           plan.recv_payload if payload is not None else plan.recv)
    return tuple(o[None] for o in out)

  fn = shard_map(per_device, mesh=mesh, in_specs=(PS('data'), PS('data')),
                 out_specs=tuple(PS('data') for _ in range(6)))
  pl = payload if payload is not None else ids
  return [np.asarray(o) for o in jax.jit(fn)(ids, pl)]


@pytest.mark.parametrize('layout,slack,with_payload', [
    ('compact', 1.25, False), ('compact', 1.25, True),
    ('compact', 0.75, False), ('compact', 0.2, True),
    ('hier', 1.0, False), ('hier', 0.75, True), ('dense', 1.0, True)])
def test_plan_equals_jax_plan(no_ragged, layout, slack, with_payload):
  rng = np.random.default_rng(5)
  f = 64
  ids = rng.integers(-1, int(BOUNDS[-1]), (P8, f)).astype(np.int32)
  # skew: a third of every request goes to range 2
  ids[:, ::3] = rng.integers(60, 90, (P8, ids[:, ::3].shape[1]))
  payload = (rng.integers(0, 1000, (P8, f)).astype(np.int32)
             if with_payload else None)
  jspec = jex.capacity_spec(f, P8, slack, layout=layout)
  tspec = tex.capacity_spec(f, P8, slack, layout=layout)
  assert _fields(jspec) == _fields(tspec) and tspec.layout == layout
  recv, kept, delivered, stats, reply, recv_pl = _jax_plan(ids, payload,
                                                           jspec)
  mesh = make_mesh(P8, device='cpu')
  bounds_t = torch.from_numpy(BOUNDS)
  plan = tex.plan_exchange(torch.from_numpy(ids), range_owner_fn(bounds_t),
                           P8, mesh, tspec,
                           None if payload is None else
                           torch.from_numpy(payload))
  np.testing.assert_array_equal(plan.recv.numpy(), recv)
  np.testing.assert_array_equal(plan.kept.numpy(), kept)
  np.testing.assert_array_equal(plan.delivered.numpy(), delivered)
  np.testing.assert_array_equal(plan.stats.numpy(), stats)
  if payload is not None:
    np.testing.assert_array_equal(plan.recv_payload.numpy(), recv_pl)
  ans = torch.where(plan.recv >= 0, plan.recv * 3 + 1, -1)
  np.testing.assert_array_equal(plan.reply(ans, fill=-7).numpy(), reply)
  # the samplers' lane view: the layout plan at the identity book
  lp = _make_plan(torch.from_numpy(ids), bounds_t, identity_spec(P8), mesh,
                  tspec)
  assert isinstance(lp, _LayoutPlan if layout != 'dense' else _BookPlan)
  own = lp.owned.numpy()
  r = lp.recv_lanes.numpy()
  lo, hi = BOUNDS[:-1, None], BOUNDS[1:, None]
  np.testing.assert_array_equal(own, (r >= lo) & (r < hi))


# -- loaders -----------------------------------------------------------------

def _loader_pair(layout, slack, n=600, batch=12, seed=0):
  rows, cols, feats, labels = _graph(n, seed=seed)
  kw = dict(node_feat=feats, node_label=labels, num_nodes=n)
  jds = JaxDistDataset.from_full_graph(P8, rows, cols, **kw)
  ds = DistDataset.from_full_graph(P8, rows, cols, device='cpu', **kw)
  lkw = dict(batch_size=batch, shuffle=True, seed=0, exchange_slack=slack,
             exchange_layout=layout)
  jl = JaxLoader(jds, [4, 3], np.arange(n), mesh=jax_make_mesh(P8), **lkw)
  tl = DistNeighborLoader(ds, [4, 3], np.arange(n), draws=jax_key_draws(0),
                          device='cpu', **lkw)
  return jl, tl


def _np(b):
  return {f: np.asarray(getattr(b, f)) for f in FIELDS}


@pytest.mark.parametrize('layout,slack', [('compact', 0.5), ('hier', 0.5)])
def test_p8_loader_byte_equal_to_jax(no_ragged, monkeypatch, layout, slack):
  # a pool of 32 slots: the compact overflow drops too
  monkeypatch.setenv('GLT_EXCHANGE_POOL_FRAC', '0.02')
  jl, tl = _loader_pair(layout, slack, n=400, batch=40)
  for i, (jb, tb) in enumerate(itertools.islice(zip(jl, tl), 2)):
    j, t = _np(jb), _np(tb)
    for f in FIELDS:
      np.testing.assert_array_equal(t[f], j[f], err_msg=f'{layout} {i} {f}')
  js = jl.sampler.exchange_stats(tick_metrics=False)
  ts = tl.sampler.exchange_stats(tick_metrics=False)
  assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
  assert ts['dist.frontier.dropped'] + ts['dist.feature.dropped'] > 0


def test_hier_adaptive_walk_takes_jax_rungs(no_ragged, monkeypatch):
  """Under hier the ladder's widen tolerance halves in both packages."""
  monkeypatch.setenv('GLT_SLACK_FLOOR', '0.75')
  jl, tl = _loader_pair('hier', 'adaptive', n=256, batch=16)
  walk_j, walk_t = [], []
  for _ in range(4):
    for _ in jl:
      pass
    for _ in tl:
      pass
    for ctl, walk in ((jl._adaptive, walk_j), (tl._adaptive, walk_t)):
      walk.append((ctl._idx, ctl._pinned, ctl._pin_reason,
                   ctl._tightened_from))
  assert walk_t == walk_j
  assert len({w[0] for w in walk_t}) > 1          # the ladder moved


def test_dense_default_below_16_is_the_book_plan(monkeypatch):
  """At P <= 8 the default stays the dense exchange through `_BookPlan`
  (the earlier slices' path, its outputs and launches unchanged), and an
  explicit 'dense' loader gives the default's batches."""
  _clean_env(monkeypatch)
  for p in (1, 4, 8):
    spec = tex.capacity_spec(256, p, 2.0)
    assert spec.layout == 'dense'
    plan = _make_plan(torch.zeros((p, 256), dtype=torch.int32),
                      torch.arange(p + 1) * 10, identity_spec(p),
                      make_mesh(p, device='cpu'), spec)
    assert type(plan) is _BookPlan
  n = 300
  rows, cols, feats, _ = _graph(n)
  ds = DistDataset.from_full_graph(P8, rows, cols, node_feat=feats,
                                   num_nodes=n, device='cpu')
  out = []
  for layout in (None, 'dense'):
    tl = DistNeighborLoader(ds, [3, 2], np.arange(n), batch_size=8,
                            shuffle=True, exchange_layout=layout,
                            device='cpu')
    out.append([_np(b) for b in itertools.islice(iter(tl), 2)])
  for a, b in zip(*out):
    for f in ('node', 'x', 'edge_index'):
      np.testing.assert_array_equal(a[f], b[f])


def test_hier_gns_loader_reads_the_fallback_row(no_ragged):
  """Hier's stage-2 rows have no requester: a GNS loader's owners bias
  them by the hot-split-only row (JAX's `fallback_req_index`), and the
  batches, weights included, equal JAX's."""
  from test_torch_mesh import _datasets, _pair
  jds, ds, _, _ = _datasets(400, 0.3)
  jl, tl = _pair(jds, ds, np.arange(400), batch_size=16, shuffle=True,
                 seed=0, gns=True, cold_cache_rows=24, exchange_slack=1.0,
                 exchange_layout='hier')
  assert tl.sampler.gns
  for i, (jb, tb) in enumerate(itertools.islice(zip(jl, tl), 2)):
    for f in ('node', 'x', 'edge_index'):
      np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                    np.asarray(getattr(jb, f)),
                                    err_msg=f'{i} {f}')
    np.testing.assert_array_equal(tb.metadata['edge_weight'].numpy(),
                                  np.asarray(jb.metadata['edge_weight']))
