"""The mesh loader's exchange telemetry in the port against the JAX
package at P = 4 (on the CPU; the JAX side on four devices of the
virtual CPU mesh): `exchange_stats(tick_metrics=...)`,
`cluster_exchange_stats()`, the live counters a ticking drain moves, the
``dist.exchange`` / ``dist.cold_tier`` events, and
`AdaptiveSlack(start=, floor=)`.

Both loaders run the same batches (the port replays the JAX keys, as in
`test_torch_mesh.py`), so every counter must be exact.  The JAX package
carries one key the port does not: ``dist.feature.cold_hit_rate`` (an
alias of ``cache_hit_rate``).  ``dist.negative.lost`` (strict-negative
slots of the link loader whose every trial was an edge) is 0 here, where
the node loader samples no negative pairs.
"""
import numpy as np
import pytest

from graphlearn_tpu.parallel.dist_sampler import \
    AdaptiveSlack as JaxAdaptiveSlack
from graphlearn_tpu.telemetry.recorder import recorder as jax_recorder
from graphlearn_tpu.utils.profiling import metrics as jax_metrics
from graphlearn_tpu_torch.parallel.dist_sampler import AdaptiveSlack
from graphlearn_tpu_torch.telemetry import live, recorder
from graphlearn_tpu_torch.telemetry.aggregate import exchange_summary
from test_torch_dist_gns import _clean_env
from test_torch_mesh import P, _datasets, _pair

JAX_ONLY = {'dist.feature.cold_hit_rate'}
COUNTERS = ('dist.frontier.offered', 'dist.frontier.dropped',
            'dist.frontier.slots', 'dist.feature.offered',
            'dist.feature.dropped', 'dist.feature.slots',
            'dist.feature.lookups', 'dist.feature.cold_lookups',
            'dist.feature.cold_misses', 'dist.feature.cache_hits',
            'dist.feature.cache_admits', 'dist.feature.cache_evicts')
COLD = COUNTERS[6:]              # the host's cold-tier counters


def _loaders(monkeypatch, split, batches=3, gns=False):
  _clean_env(monkeypatch)
  n, bs = 400, 16
  jds, ds, _, _ = _datasets(n, split)
  kw = dict(batch_size=bs, shuffle=True, seed=0, gns=gns)
  if split < 1.0:
    kw['cold_cache_rows'] = 24
  jl, tl = _pair(jds, ds, np.arange(n), **kw)
  jit, tit = iter(jl), iter(tl)
  for _ in range(batches):
    next(jit), next(tit)
  return jl, tl, (jit, tit)


def _assert_same(ts, js):
  assert set(js) - set(ts) == JAX_ONLY
  assert set(ts) <= set(js)
  assert js['dist.negative.lost'] == ts['dist.negative.lost'] == 0
  for k, v in ts.items():
    assert v == js[k], k


def _deltas(before, after):
  return {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}


@pytest.mark.parametrize('split,gns', [(1.0, False), (0.3, True)])
def test_stats_and_cluster_stats_equal_jax(monkeypatch, split, gns):
  jl, tl, _ = _loaders(monkeypatch, split, gns=gns)
  js = jl.sampler.exchange_stats(tick_metrics=False)
  ts = tl.sampler.exchange_stats(tick_metrics=False)
  _assert_same(ts, js)
  assert ts['dist.frontier.offered'] > 0
  if split < 1.0:
    assert ts['dist.feature.cold_lookups'] > 0
  jc = jl.sampler.cluster_exchange_stats()
  tc = tl.sampler.cluster_exchange_stats()
  _assert_same(tc, jc)
  assert tc['num_hosts'] == 1
  summary = exchange_summary(tc)
  assert summary and all(tc[k] == v for k, v in summary.items())
  assert 0 < tc['frontier_padding_waste_pct'] < 100
  assert tc['frontier_drop_rate_pct'] == 0.0
  assert ('cold_hit_rate' in tc) == (split < 1.0)


def test_tick_metrics_ticks_the_drained_deltas(monkeypatch):
  jl, tl, (jit, tit) = _loaders(monkeypatch, 0.3)
  t0, j0 = live.snapshot(), jax_metrics.snapshot()
  ts = tl.sampler.exchange_stats()
  js = jl.sampler.exchange_stats()
  td = _deltas(t0, live.snapshot())
  assert td == {k: ts[k] for k in COUNTERS}
  assert td == _deltas(j0, jax_metrics.snapshot())
  assert td['dist.feature.cold_lookups'] > 0
  # a second drain with no new batch ticks nothing
  t1, j1 = live.snapshot(), jax_metrics.snapshot()
  assert tl.sampler.exchange_stats() == ts
  jl.sampler.exchange_stats()
  assert not any(_deltas(t1, live.snapshot()).values())
  assert not any(_deltas(j1, jax_metrics.snapshot()).values())
  # the next batch's drain ticks exactly its deltas
  next(jit), next(tit)
  t2, j2 = live.snapshot(), jax_metrics.snapshot()
  ts2 = tl.sampler.exchange_stats()
  jl.sampler.exchange_stats()
  td2 = _deltas(t2, live.snapshot())
  assert td2 == {k: ts2[k] - ts[k] for k in COUNTERS}
  assert td2 == _deltas(j2, jax_metrics.snapshot())
  assert td2['dist.frontier.offered'] > 0
  # a drain that does not tick moves no counter; as in JAX, it takes the
  # exchange deltas with it, while the cold-tier counters tick from the
  # last ticking drain
  next(jit), next(tit)
  t3, j3 = live.snapshot(), jax_metrics.snapshot()
  ts3 = tl.sampler.exchange_stats(tick_metrics=False)
  jl.sampler.exchange_stats(tick_metrics=False)
  assert not any(_deltas(t3, live.snapshot()).values())
  assert not any(_deltas(j3, jax_metrics.snapshot()).values())
  tl.sampler.exchange_stats()
  jl.sampler.exchange_stats()
  td3 = _deltas(t3, live.snapshot())
  assert td3 == _deltas(j3, jax_metrics.snapshot())
  assert all(td3[k] == ts3[k] - ts2[k] for k in COLD)
  assert td3['dist.feature.cold_lookups'] > 0
  assert td3['dist.frontier.offered'] == 0


def _fields(ev):
  return {k: v for k, v in ev.items()
          if k not in ('ts', 'mono', 'pid', 'tid')}


def test_exchange_and_cold_tier_events_carry_jax_fields(monkeypatch):
  jl, tl, _ = _loaders(monkeypatch, 0.3)
  for rec in (recorder, jax_recorder):
    rec.clear()
    rec.enable()
  try:
    tl.sampler.exchange_stats()
    jl.sampler.exchange_stats()
    tl.sampler.exchange_stats()      # nothing moved: no event
    jl.sampler.exchange_stats()
  finally:
    recorder.disable()
    jax_recorder.disable()
  for kind in ('dist.exchange', 'dist.cold_tier'):
    tev = [_fields(e) for e in recorder.events(kind)]
    jev = [_fields(e) for e in jax_recorder.events(kind)]
    assert len(tev) == len(jev) == 1, kind
    t, j = tev[0], jev[0]
    assert set(t) == set(j), kind
    assert t == {k: j[k] for k in t}, kind
  ex = recorder.events('dist.exchange')[0]
  assert ex['frontier_offered'] > 0 and ex['feature_slots'] > 0
  cold = recorder.events('dist.cold_tier')[0]
  assert cold['cold_lookups'] > 0 and 0.0 <= cold['hit_rate'] <= 1.0


def _ladder(ctl):
  return (ctl._idx, ctl._pinned, ctl._pin_reason, ctl._tightened_from,
          ctl.floor, ctl.slack)


def test_adaptive_slack_start_and_floor_walk_the_jax_rungs(monkeypatch):
  """``start=1.5, floor=1.25`` (the argument overrides
  ``GLT_SLACK_FLOOR``): a drop-free epoch tightens to 1.25, the next
  one pins at the floor, in both packages."""
  _clean_env(monkeypatch)
  monkeypatch.setenv('GLT_SLACK_FLOOR', '0.75')
  n, bs = 2000, 64
  jds, ds, _, _ = _datasets(n, 1.0, seed=5)
  seeds = np.random.default_rng(1).permutation(n)[:P * bs * 2]
  jl, tl = _pair(jds, ds, seeds, fanouts=[6, 4], batch_size=bs,
                 shuffle=True, seed=0, exchange_slack='adaptive')
  jl._adaptive = JaxAdaptiveSlack(jl.sampler, start=1.5, floor=1.25)
  tl._adaptive = AdaptiveSlack(tl.sampler, start=1.5, floor=1.25)
  assert _ladder(tl._adaptive) == _ladder(jl._adaptive)
  assert tl.sampler.exchange_slack == jl.sampler.exchange_slack == 1.5
  assert tl._adaptive.floor == 1.25
  rungs = []
  for _ in range(4):
    for jb, tb in zip(iter(jl), iter(tl)):
      np.testing.assert_array_equal(tb.node.numpy(), np.asarray(jb.node))
    assert _ladder(tl._adaptive) == _ladder(jl._adaptive)
    assert tl.sampler.exchange_slack == jl.sampler.exchange_slack
    rungs.append(tl._adaptive.slack)
  assert rungs == [1.5, 1.25, 1.25, 1.25]
  assert tl._adaptive._pinned and tl._adaptive._pin_reason == 'floor'
  js = jl.sampler.exchange_stats(tick_metrics=False)
  ts = tl.sampler.exchange_stats(tick_metrics=False)
  _assert_same(ts, js)
  assert ts['dist.frontier.dropped'] == 0
