"""Fleet federation and the ops endpoint: the port's
`telemetry.federation` and `telemetry.opsserver` against the JAX
package's.

The same replica expositions (registries driven from one numpy seed)
merge into a byte-equal ``/fleet`` text and an equal JSON rollup in both
packages (counters summed, gauges at their max, histograms' buckets
summed with merged quantiles), and a malformed replica is refused, not
merged.  A real port `OpsServer` on ``127.0.0.1`` with an ephemeral port
answers every route; `FleetRouter.make_scraper` federates two local
replicas; the ``ops.scrape`` chaos site turns a scrape into a 503 that
the scraper counts.  Every HTTP call carries a timeout.
"""
import importlib
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from graphlearn_tpu.utils.profiling import Metrics as JaxMetrics
from graphlearn_tpu_torch.serving import (FleetRouter, LocalReplica,
                                          ServingEngine, ServingFrontend)
from graphlearn_tpu_torch.telemetry import OpsServer, tracer
from graphlearn_tpu_torch.testing import chaos
from test_torch_serving import BUCKETS, FANOUTS, SEED, _port_dataset

jfed = importlib.import_module('graphlearn_tpu.telemetry.federation')
jlive = importlib.import_module('graphlearn_tpu.telemetry.live')
pfed = importlib.import_module('graphlearn_tpu_torch.telemetry.federation')
plive = importlib.import_module('graphlearn_tpu_torch.telemetry.live')
ptimeseries = importlib.import_module(
    'graphlearn_tpu_torch.telemetry.timeseries')

TIMEOUT = 10


@pytest.fixture(autouse=True)
def _clean():
  chaos.uninstall()
  yield
  chaos.uninstall()


def _get(url):
  with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
    return r.status, r.read().decode('utf-8')


def _status(url):
  try:
    return _get(url)
  except urllib.error.HTTPError as e:
    return e.code, e.read().decode('utf-8')


def _replica(mod, metrics_cls, seed):
  reg = mod.LiveRegistry(store=metrics_cls(), strict=True)
  rng = np.random.default_rng(seed)
  reg.counter('serving.requests_total').inc(int(rng.integers(1, 99)))
  reg.counter('serving.shed_total',
              labels={'reason': 'deadline'}).inc(int(rng.integers(0, 9)))
  depth = float(rng.integers(0, 30))
  reg.gauge('serving.queue_depth', fn=lambda: depth)
  for bucket in (1, 4):
    h = reg.histogram('serving.request_latency', labels={'bucket': bucket})
    for i, v in enumerate(rng.exponential(5e-3, 30)):
      h.observe(float(v), exemplar=f'{seed:08x}{i:08x}' if i == 3 else None)
  return reg


def _fleets(n=3, junk=False):
  out = []
  for fed, mod, metrics_cls in ((jfed, jlive, JaxMetrics),
                                (pfed, plive, plive.Metrics)):
    fs = fed.FleetScraper(registry=mod.LiveRegistry(store=metrics_cls()),
                          clock=lambda: 1_722_700_000.5)
    for i in range(n):
      fs.add_registry(f'r{i}', _replica(mod, metrics_cls, seed=i))
    if junk:
      class Junk(fed.ReplicaTarget):
        def scrape(self):
          return 'glt_x this-is-not-a-number\n', {'ok': True}
      fs.add_target(Junk('bad'))
    out.append(fs)
  return out


@pytest.fixture
def frozen_live(monkeypatch):
  class Clock:
    def time(self):
      return 1_722_700_000.25

    def monotonic(self):
      return time.monotonic()
  for mod in (jlive, plive):
    monkeypatch.setattr(mod, 'time', Clock())


@pytest.mark.parametrize('junk', [False, True])
def test_merged_fleet_text_and_rollup_equal_to_jax(junk, frozen_live):
  jfs, pfs = _fleets(junk=junk)
  jlast, plast = jfs.scrape(), pfs.scrape()
  assert plast.keys() == jlast.keys()
  for name in plast:
    assert plast[name]['ok'] == jlast[name]['ok']
    assert plast[name]['text'] == jlast[name]['text']
  text = pfs.prometheus_text()
  assert text == jfs.prometheus_text()
  parsed = plive.parse_prometheus_text(text)       # strict
  assert parsed['glt_fleet_serving_requests_total'] == sum(
      parsed[f'glt_serving_requests_total{{replica="r{i}"}}']
      for i in range(3))
  assert parsed['glt_fleet_serving_queue_depth'] == max(
      parsed[f'glt_serving_queue_depth{{replica="r{i}"}}']
      for i in range(3))
  assert 'glt_fleet_serving_request_latency_p99_secs{bucket="4"}' in parsed
  roll = pfs.fleet_json()
  assert json.dumps(roll, sort_keys=True, default=repr) == json.dumps(
      jfs.fleet_json(), sort_keys=True, default=repr)
  if junk:
    # refused, not merged: its sample never reaches the fleet text
    assert not plast['bad']['ok'] and 'glt_x' not in text
    assert roll['ok'] is False and roll['replicas_up'] == 3


def test_parse_exposition_equal_to_jax():
  texts = [_replica(plive, plive.Metrics, 5).prometheus_text(),
           '# HELP glt_x a thing\n# TYPE glt_x counter\n'
           'glt_x{replica="a"} 3\nglt_x 1\n# TYPE glt_h histogram\n'
           'glt_h_bucket{le="+Inf"} 2\nglt_h_sum 0.5\nglt_h_count 2\n']
  for text in texts:
    assert pfed.parse_exposition(text) == jfed.parse_exposition(text)


def test_local_replica_target_equal_to_jax():
  class FakeReplica:
    def heartbeat(self):
      return {'serving': {'inflight': 3, 'healthy': True,
                          'slo': {'windows': [1, 2]}}, 'epoch': 7}

  got = pfed.LocalReplicaTarget('r0', FakeReplica()).scrape()
  assert got == jfed.LocalReplicaTarget('r0', FakeReplica()).scrape()
  assert 'glt_serving_healthy' not in got[0]


def _ops_registry():
  reg = plive.LiveRegistry(store=plive.Metrics(), strict=True)
  reg.counter('serving.requests_total').inc(4)
  reg.histogram('serving.request_latency', labels={'bucket': 2}).observe(
      0.01, exemplar='feedfacefeedface')
  reg.register_health('serving', lambda: {'healthy': True, 'depth': 0})
  return reg


def test_ops_server_answers_every_route():
  reg = _ops_registry()
  srv = OpsServer(registry=reg, port=0, host='127.0.0.1')
  tracer.configure(sample=1, slow_ms=0.0, buffer=8)
  tracer.clear()
  try:
    assert srv.url.startswith('http://127.0.0.1:') and srv.port > 0
    status, body = _get(f'{srv.url}/metrics')
    parsed = plive.parse_prometheus_text(body)
    assert status == 200
    assert parsed['glt_serving_requests_total'] == 4
    assert 'trace_id="feedfacefeedface"' in body
    status, body = _get(f'{srv.url}/varz')
    varz = json.loads(body)
    assert status == 200 and varz['metrics']['serving.requests_total'] == 4
    assert 'ring_capacity' in varz['recorder']
    status, body = _get(f'{srv.url}/healthz')
    assert status == 200 and json.loads(body)['ok'] is True
    reg.register_health('worker', lambda: {'healthy': False})
    status, body = _status(f'{srv.url}/healthz')
    assert status == 503 and json.loads(body)['components']['worker']
    # /timeseries needs a store; /fleet needs an attached scraper
    assert _status(f'{srv.url}/fleet')[0] == 404
    if ptimeseries.global_store() is None:
      assert _status(f'{srv.url}/timeseries')[0] == 404
    store = ptimeseries.TimeSeriesStore(registry=reg, cadence_ms=1000.0,
                                        retention_s=10.0)
    store.sample_once(now=100.0)
    reg.counter('serving.requests_total').inc(6)
    store.sample_once(now=101.0)
    ptimeseries._global = store
    try:
      status, body = _get(f'{srv.url}/timeseries?names='
                          'serving.requests_total')
    finally:
      ptimeseries._global = None
    ts = json.loads(body)
    assert status == 200
    rates = ts['series']['serving.requests_total:rate']['points']
    assert rates[-1][1] == pytest.approx(6.0)
    # a retained trace: index, spans and the Chrome rendering
    ctx = tracer.mint()
    tracer.span('serving.route', ctx, span_id=ctx['t'], dur=0.002)
    tracer.span('serving.queue_wait', ctx, dur=0.001)
    tracer.resolve(ctx, outcome='ok', latency_ms=2.0)
    status, body = _get(f'{srv.url}/traces')
    assert status == 200
    assert json.loads(body)['traces'][0]['trace_id'] == ctx['t']
    status, body = _get(f'{srv.url}/trace?trace_id={ctx["t"]}')
    assert status == 200 and len(json.loads(body)['spans']) == 2
    status, body = _get(f'{srv.url}/trace?trace_id={ctx["t"]}'
                        '&format=chrome')
    chrome = json.loads(body)
    assert status == 200
    assert sum(1 for e in chrome['traceEvents'] if e.get('ph') == 'X') == 2
    assert _status(f'{srv.url}/trace?trace_id=0000')[0] == 404
    assert _status(f'{srv.url}/nope')[0] == 404
    assert reg.counter('ops.scrapes_total').value() >= 9
  finally:
    tracer.configure(sample=0, slow_ms=0.0, buffer=None)
    tracer.clear()
    srv.close()


def test_fleet_route_prom_json_and_503_with_dead_replica():
  _, pfs = _fleets()
  pfs.scrape()
  srv = OpsServer(registry=_ops_registry(), port=0, host='127.0.0.1')
  try:
    srv.attach_fleet(pfs)
    status, body = _get(f'{srv.url}/fleet')
    assert status == 200
    parsed = plive.parse_prometheus_text(body)
    assert body == pfs.prometheus_text()
    assert len({k.split('replica="')[1].split('"')[0]
                for k in parsed if 'replica="' in k}) == 3
    status, body = _get(f'{srv.url}/fleet?format=json')
    assert status == 200 and json.loads(body)['replicas_up'] == 3

    class Dead(pfed.ReplicaTarget):
      def scrape(self):
        raise OSError('connection refused')

    pfs.add_target(Dead('dead'))
    pfs.scrape()
    status, body = _status(f'{srv.url}/fleet?format=json')
    roll = json.loads(body)
    assert status == 503 and roll['ok'] is False
    assert 'OSError' in roll['replicas']['dead']['error']
    assert pfs._err_counters['dead'].value() == 1.0
  finally:
    srv.close()


def test_ops_scrape_drop_is_counted_and_isolated():
  reg = _ops_registry()
  srv = OpsServer(registry=reg, port=0, host='127.0.0.1')
  fs = pfed.FleetScraper(registry=plive.LiveRegistry(store=plive.Metrics()))
  fs.add_url('web', srv.url, timeout_s=TIMEOUT)
  chaos.install({'faults': [{'site': 'ops.scrape', 'action': 'drop',
                             'op': '/metrics', 'nth': 1}]})
  try:
    status, body = _status(f'{srv.url}/metrics')
    assert status == 503 and 'injected ops scrape drop' in body
    last = fs.scrape()                       # the second /metrics: served
    assert last['web']['ok'], last['web']['error']
    chaos.install({'faults': [{'site': 'ops.scrape', 'action': 'drop',
                               'op': '/metrics', 'nth': 1}]})
    last = fs.scrape()
    assert not last['web']['ok'] and '503' in last['web']['error']
    assert fs._err_counters['web'].value() == 1.0
    assert fs.fleet_json()['replicas_up'] == 0
  finally:
    fs.close()
    srv.close()


def test_stalled_scrape_never_blocks_the_executor():
  """A delayed scrape holds its own handler thread; requests keep
  resolving meanwhile."""
  eng = ServingEngine(_port_dataset(), FANOUTS, seed=SEED, buckets=BUCKETS,
                      device='cpu')
  fe = ServingFrontend(eng, auto_start=True, max_wait_ms=1.0,
                       default_deadline_ms=30000.0)
  srv = OpsServer(registry=_ops_registry(), port=0, host='127.0.0.1')
  chaos.install({'faults': [{'site': 'ops.scrape', 'action': 'delay',
                             'op': '/varz', 'nth': 1, 'secs': 1.5}]})
  out = {}
  t = threading.Thread(target=lambda: out.update(v=_get(f'{srv.url}/varz')))
  try:
    t.start()
    t0 = time.monotonic()
    for s in range(8):
      fe.submit([s]).result(TIMEOUT)
    served = time.monotonic() - t0
    t.join(TIMEOUT)
    assert out['v'][0] == 200
    assert served < 1.5, 'the executor waited for the stalled scrape'
  finally:
    srv.close()
    fe.shutdown()


def test_make_scraper_federates_two_local_replicas():
  reps = []
  for i in range(2):
    eng = ServingEngine(_port_dataset(), FANOUTS, seed=SEED,
                        buckets=BUCKETS, device='cpu')
    reps.append(LocalReplica(f'r{i}', ServingFrontend(
        eng, auto_start=True, max_wait_ms=1.0, default_deadline_ms=30000.0)))
  router = FleetRouter(reps, auto_start=False)
  host = plive.LiveRegistry(store=plive.Metrics(), strict=True)
  host.counter('serving.requests_total').inc(5)
  fs = router.make_scraper(registry=host)
  srv = OpsServer(registry=host, port=0, host='127.0.0.1')
  try:
    for s in range(6):
      router.infer([s], timeout=TIMEOUT)
    fs.scrape()
    srv.attach_fleet(fs)
    status, body = _get(f'{srv.url}/fleet')
    parsed = plive.parse_prometheus_text(body)
    assert status == 200
    assert {'r0', 'r1', 'self'} <= {
        k.split('replica="')[1].split('"')[0]
        for k in parsed if 'replica="' in k}
    assert parsed['glt_serving_requests_total{replica="self"}'] == 5.0
    served = sum(parsed[f'glt_serving_served_requests{{replica="r{i}"}}']
                 for i in range(2))
    assert served == 6.0
    assert fs.fleet_json()['replicas_up'] == 3
  finally:
    srv.close()
    fs.close()
    router.close(close_replicas=True)
