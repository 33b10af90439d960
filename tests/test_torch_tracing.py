"""Request tracing: the port's `telemetry.tracing`, `telemetry.spans` and
`telemetry.export` against the JAX package's, and the trace tree a port
fleet records against a JAX fleet's.

The same mint / span / resolve sequence runs through a fresh JAX
`Tracer` and a fresh port one, with each module's clock and span ids
patched to the same deterministic sequence: retention verdicts,
`traces()`, `spans_of` and the Chrome export must be equal.  On a local
fleet over the tiered serving engine (the JAX engine's draws replayed),
one routed request records the same tree in both packages: the
``serving.route`` root, ``serving.queue_wait`` under it,
``serving.dispatch_slice``, and ``serving.sample_collect`` +
``serving.cold_fill`` under the slice.  Tracing never touches the data
plane: ``sample=0`` and ``sample=1`` answer byte-identically.
"""
import importlib
import itertools
import json

import numpy as np
import pytest

from graphlearn_tpu.serving import FleetRouter as JaxFleetRouter
from graphlearn_tpu.serving import LocalReplica as JaxLocalReplica
from graphlearn_tpu.serving import ServingFrontend as JaxServingFrontend
from graphlearn_tpu_torch.serving import (AdmissionRejected, FleetRouter,
                                          LocalReplica, ServingFrontend)
from test_torch_serving import BUCKETS, SEEDS, _tiered_pair

jtracing = importlib.import_module('graphlearn_tpu.telemetry.tracing')
ptracing = importlib.import_module('graphlearn_tpu_torch.telemetry.tracing')
jexport = importlib.import_module('graphlearn_tpu.telemetry.export')
pexport = importlib.import_module('graphlearn_tpu_torch.telemetry.export')
jspans = importlib.import_module('graphlearn_tpu.telemetry.spans')
pspans = importlib.import_module('graphlearn_tpu_torch.telemetry.spans')


class _Clock:
  """A deterministic ``time``: every read advances 1.5 ms."""

  def __init__(self):
    self.n = itertools.count()

  def monotonic(self):
    return 100.0 + 0.0015 * next(self.n)

  def time(self):
    return 1_722_700_000.0 + 0.0015 * next(self.n)


@pytest.fixture
def patched(monkeypatch):
  """Both tracers' clocks and ids replaced by the same sequences."""
  for mod in (jtracing, ptracing):
    monkeypatch.setattr(mod, 'time', _Clock())
    ids = itertools.count(1)
    monkeypatch.setattr(mod, '_new_id',
                        lambda ids=ids: f'{next(ids):016x}')
  yield


def _script(tr):
  """One fixed sequence over tracer ``tr``; returns every verdict."""
  out = []
  ctxs = [tr.mint() for _ in range(6)]
  out.append([c['k'] for c in ctxs])
  for i, c in enumerate(ctxs):
    sid = tr.span('serving.route', c, span_id=c['t'], dur=0.002 * i,
                  replica='r0', outcome='ok')
    tr.span('serving.queue_wait', c, dur=0.001)
    child = tr.span('serving.dispatch_slice', c, dur=0.003, bucket=4,
                    requests=2)
    tr.span('serving.cold_fill', c, parent_id=child, dur=0.0005)
    tr.span('serving.rpc', jtracing.child_ctx(c, sid), dur=0.004)
  out.append(tr.resolve(ctxs[0], 'ok', 1.0))      # sampled
  out.append(tr.resolve(ctxs[1], 'ok', 1.0))      # fast, unsampled: drop
  out.append(tr.resolve(ctxs[2], 'ok', 80.0))     # slow tail
  out.append(tr.resolve(ctxs[3], 'shed', 0.1))    # shed
  out.append(tr.resolve(ctxs[4], 'error', 0.1))   # failed
  tr.span('serving.rpc', ctxs[2], dur=0.01)       # late span merges
  out.append(tr.resolve(ctxs[2], 'error', 90.0))  # idempotent merge
  out.append(tr.resolve(None))
  out.append(tr.traces())
  out.append({c['t']: tr.spans_of(c['t']) for c in ctxs})
  st = tr.stats()
  out.append(st)
  return out, ctxs


def test_tracer_sequence_equal_to_jax(patched):
  jt = jtracing.Tracer(sample=2, slow_ms=50.0, buffer=3)
  pt = ptracing.Tracer(sample=2, slow_ms=50.0, buffer=3)
  got, ctxs = _script(pt)
  want, _ = _script(jt)
  assert got == want
  assert got[-1]['retained'] == 3        # the ring kept the newest three
  for c in ctxs:
    spans = pt.spans_of(c['t'])
    if spans:
      jchrome = jexport.to_chrome_trace(jtracing.spans_to_events(spans))
      pchrome = pexport.to_chrome_trace(ptracing.spans_to_events(spans))
      assert json.dumps(pchrome, sort_keys=True) == \
          json.dumps(jchrome, sort_keys=True)
      assert pt.events_of(c['t']) == jt.events_of(c['t'])


def test_retained_ring_is_bounded():
  tr = ptracing.Tracer(sample=1, slow_ms=0.0, buffer=3)
  tids = []
  for _ in range(5):
    ctx = tr.mint()
    tids.append(ctx['t'])
    tr.resolve(ctx, outcome='ok')
  assert [e['trace_id'] for e in tr.traces()] == list(reversed(tids[-3:]))
  assert tr.stats()['retained'] == 3


def test_resolve_merge_is_idempotent():
  tr = ptracing.Tracer(sample=1, slow_ms=0.0, buffer=8)
  ctx = tr.mint()
  tr.span('serving.queue_wait', ctx, dur=0.001)
  assert tr.resolve(ctx, outcome='ok', latency_ms=2.0)
  tr.span('serving.rpc', ctx, dur=0.002)
  assert tr.resolve(ctx, outcome='error', latency_ms=5.0)
  assert tr.resolve(ctx, outcome='ok', latency_ms=1.0)
  (entry,) = tr.traces()
  assert entry['outcome'] == 'error' and entry['latency_ms'] == 5.0
  assert {s['name'] for s in tr.spans_of(ctx['t'])} == \
      {'serving.queue_wait', 'serving.rpc'}


def test_tracing_off_is_one_check():
  tr = ptracing.Tracer(sample=0)
  assert tr.mint() is None and not tr.enabled
  assert tr.span('serving.route', None) is None
  assert tr.resolve(None) is False


def test_span_tree_and_chrome_export_equal_to_jax(monkeypatch):
  """`spans.span` over each package's recorder: the same nesting gives
  the same begin/end events (ids and clocks patched), and the Chrome
  exports and span durations agree."""
  from graphlearn_tpu.telemetry import recorder as jrec
  from graphlearn_tpu_torch.telemetry import recorder as prec
  out = {}
  for name, mod, rec, exp in (('jax', jspans, jrec, jexport),
                              ('port', pspans, prec, pexport)):
    ids = itertools.count(1)
    monkeypatch.setattr(mod, '_new_id', lambda ids=ids: f'{next(ids):016x}')
    rec.enable()
    rec.clear()
    try:
      with mod.span('batch', scope='DistNeighborLoader', batch=1):
        with mod.span('sample.exchange', step=1, batch=4):
          pass
        with mod.span('feature.lookup', step=1, ts='x'):  # reserved
          pass
        with pytest.raises(KeyError):
          with mod.span('stitch'):
            raise KeyError('boom')
      evs = [e for e in rec.events() if e['kind'].startswith('span.')]
    finally:
      rec.clear()
      rec.disable()
    shape = [(e['kind'], e['name'], e['span_id'], e['parent_id'],
              e.get('error'), e.get('ts_'))
             for e in evs]
    chrome = exp.to_chrome_trace(evs)
    out[name] = (shape, sorted(exp.span_durations(evs)),
                 [(e['name'], e['ph']) for e in chrome['traceEvents']
                  if e.get('ph') in ('X', 'B', 'E')])
  assert out['port'] == out['jax']


# -- a local fleet over the tiered engine --------------------------------------
@pytest.fixture(scope='module')
def fleets():
  jeng, peng = _tiered_pair(4)
  pfe = ServingFrontend(peng, auto_start=True, max_wait_ms=1.0,
                        default_deadline_ms=30000.0)
  jfe = JaxServingFrontend(jeng, auto_start=True, warmup=True,
                           max_wait_ms=1.0, default_deadline_ms=30000.0)
  prouter = FleetRouter([LocalReplica('r0', pfe)], auto_start=False)
  jrouter = JaxFleetRouter([JaxLocalReplica('r0', jfe)], auto_start=False)
  yield prouter, jrouter
  prouter.close(close_replicas=True)
  jrouter.close(close_replicas=True)


@pytest.fixture
def both_tracers():
  yield ptracing.tracer, jtracing.tracer
  for tr in (ptracing.tracer, jtracing.tracer):
    tr.configure(sample=0, slow_ms=0.0, buffer=None)
    tr.clear()


def _tree(tr):
  """name -> parent name of the one retained trace."""
  (entry,) = tr.traces()
  spans = tr.spans_of(entry['trace_id'])
  by_id = {s['span_id']: s['name'] for s in spans}
  tree = sorted((s['name'], by_id.get(s['parent_id'])) for s in spans)
  root = [s for s in spans if s['parent_id'] is None]
  assert len(root) == 1 and root[0]['span_id'] == entry['trace_id']
  return entry['outcome'], tree


def test_fleet_trace_tree_equal_to_jax(fleets, both_tracers):
  from graphlearn_tpu_torch.telemetry.live import live
  prouter, jrouter = fleets
  trees = []
  for router, tr in zip((prouter, jrouter), both_tracers):
    tr.configure(sample=1, slow_ms=0.0, buffer=64)
    tr.clear()
    router.infer(SEEDS, timeout=60)
    trees.append(_tree(tr))
  assert trees[0] == trees[1]
  outcome, tree = trees[0]
  assert outcome == 'ok'
  assert tree == sorted([
      ('serving.route', None),
      ('serving.queue_wait', 'serving.route'),
      ('serving.dispatch_slice', 'serving.route'),
      ('serving.sample_collect', 'serving.dispatch_slice'),
      ('serving.cold_fill', 'serving.dispatch_slice')])
  # the trace id landed as a latency bucket's exemplar
  tid = ptracing.tracer.traces()[0]['trace_id']
  ex = [ln for ln in live.prometheus_text().splitlines()
        if f'trace_id="{tid}"' in ln]
  assert ex and all('glt_serving_request_latency_bucket{' in ln
                    for ln in ex)


def test_sample_zero_and_one_byte_identical(fleets, both_tracers):
  prouter, jrouter = fleets
  tr = both_tracers[0]
  out = {}
  for sample in (0, 1, 0):
    tr.configure(sample=sample, slow_ms=0.0, buffer=64)
    tr.clear()
    res = prouter.infer(SEEDS, timeout=60)
    out.setdefault(sample, []).append(res)
    assert tr.stats()['retained'] == sample
  ref = jrouter.infer(SEEDS, timeout=60)
  for res in out[0] + out[1]:
    assert res.nodes.tobytes() == out[0][0].nodes.tobytes()
    assert res.x.tobytes() == out[0][0].x.tobytes()
    assert res.nodes.tobytes() == np.asarray(ref.nodes).tobytes()
    assert res.x.tobytes() == np.asarray(ref.x).tobytes()


def test_logits_identical_with_tracing_on():
  _, peng = _tiered_pair(4, model=True)
  fe = ServingFrontend(peng, auto_start=True, max_wait_ms=1.0,
                       default_deadline_ms=30000.0)
  router = FleetRouter([LocalReplica('r0', fe)], auto_start=False)
  try:
    got = []
    for sample in (0, 1):
      ptracing.tracer.configure(sample=sample, slow_ms=0.0, buffer=8)
      got.append(router.infer(SEEDS, timeout=60))
    assert got[0].logits.tobytes() == got[1].logits.tobytes()
    assert got[0].nodes.tobytes() == got[1].nodes.tobytes()
  finally:
    ptracing.tracer.configure(sample=0, slow_ms=0.0, buffer=None)
    ptracing.tracer.clear()
    router.close(close_replicas=True)


def test_shed_trace_is_retained(fleets, both_tracers):
  prouter, jrouter = fleets
  verdicts = []
  for router, tr in zip((prouter, jrouter), both_tracers):
    tr.configure(sample=1_000_000, slow_ms=0.0, buffer=64)
    tr.clear()
    tr.mint()                       # spend the 1-in-N head sample
    with pytest.raises(Exception) as e:
      router.infer(list(range(BUCKETS[-1] + 1)), timeout=60)
    assert type(e.value).__name__ == 'AdmissionRejected'
    (entry,) = tr.traces()
    verdicts.append((entry['outcome'], entry['sampled'], entry['spans']))
  # a door shed: retained at once, before any span was recorded
  assert verdicts[0] == verdicts[1] == ('shed', 0, 0)
  assert issubclass(AdmissionRejected, RuntimeError)
