"""The live metrics plane: the port's `telemetry.live` and
`telemetry.histogram` against the JAX package's.

The same counters, gauges and histogram observations (with trace
exemplars), drawn from a numpy seed, go into a fresh JAX `LiveRegistry`
and a fresh port one: `prometheus_text` must be byte-equal and `varz`
equal with the wall clock patched to one value in both.  The strict
parser and the exemplar splitter give equal results (and equal errors)
on the same texts, the log2 bucket snapshots decode equally, and the
derived default gauges (`_wire_defaults`) render equally.  The port's
registry keeps its own contracts: strict names, torn-free histograms
under a concurrent scrape, a raising gauge dropping only its sample.
"""
import importlib
import threading
import time

import numpy as np
import pytest

from graphlearn_tpu.telemetry import recorder as jax_recorder
from graphlearn_tpu.utils.profiling import Metrics as JaxMetrics
from graphlearn_tpu_torch.telemetry import recorder

# the packages export the global registries under the modules' names
jhist = importlib.import_module('graphlearn_tpu.telemetry.histogram')
jlive = importlib.import_module('graphlearn_tpu.telemetry.live')
phist = importlib.import_module('graphlearn_tpu_torch.telemetry.histogram')
plive = importlib.import_module('graphlearn_tpu_torch.telemetry.live')


class _Clock:
  """A module's ``time`` with a fixed wall clock (exemplar and varz
  stamps), the monotonic clock untouched."""

  def __init__(self, t):
    self.t = t

  def time(self):
    return self.t

  def monotonic(self):
    return time.monotonic()


@pytest.fixture
def frozen(monkeypatch):
  for mod in (jlive, plive):
    monkeypatch.setattr(mod, 'time', _Clock(1_722_700_000.125))


def _pair(strict=True):
  return (jlive.LiveRegistry(store=JaxMetrics(), strict=strict),
          plive.LiveRegistry(store=plive.Metrics(), strict=strict))


def _drive(reg, seed):
  """One seeded sequence of registrations and observations."""
  rng = np.random.default_rng(seed)
  reg.counter('serving.requests_total').inc(int(rng.integers(1, 50)))
  reg.counter('serving.seeds_total').inc(float(rng.integers(1, 500)))
  for reason in ('queue_full', 'deadline'):
    reg.counter('serving.shed_total',
                labels={'reason': reason}).inc(int(rng.integers(0, 5)))
  reg.counter('serving.admitted_total').inc(int(rng.integers(50, 90)))
  reg.gauge('serving.queue_depth').set(float(rng.integers(0, 9)))
  depth = float(rng.random())
  reg.gauge('serving.coalesce_fill_ratio', fn=lambda: depth)
  reg.gauge('serving.in_flight', fn=lambda: None)     # drops its sample
  for bucket in (1, 4):
    h = reg.histogram('serving.request_latency', labels={'bucket': bucket})
    for i, secs in enumerate(rng.exponential(4e-3, 40)):
      h.observe(float(secs),
                exemplar=(f'{seed:04x}{i:012x}' if i % 7 == 0 else None))
  w = reg.histogram('serving.queue_wait')
  for secs in rng.exponential(1e-4, 25):
    w.observe(float(secs))
  w.observe(0.0)
  w.observe(500.0)                                   # the overflow bucket


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_prometheus_text_and_varz_equal_to_jax(seed, frozen):
  jreg, preg = _pair()
  _drive(jreg, seed)
  _drive(preg, seed)
  text = preg.prometheus_text()
  assert text == jreg.prometheus_text()
  assert 'trace_id="' in text and '# HELP glt_serving_queue_wait' in text
  jv, pv = jreg.varz(), preg.varz()
  assert pv['ts'] == jv['ts']
  assert pv['metrics'] == jv['metrics']


def test_undeclared_names_on_permissive_registries(frozen):
  jreg, preg = _pair(strict=False)
  for reg in (jreg, preg):
    reg.counter('custom.events_total', labels={'k': 'a"b\\c'}).inc(2)
    reg.gauge('custom.level').set(1e16)
    reg.histogram('custom.stage').observe(0.25, exemplar='ab')
  assert preg.prometheus_text() == jreg.prometheus_text()
  assert preg.snapshot() == jreg.snapshot()


TEXTS = [
    'ok_metric 1\nbroken{ 2\n',
    '# not a help line\n',
    '# HELP a b\n# TYPE a counter\na 1\na{x="1"} 2.5e3\n',
    'h_bucket{le="0.001"} 3 # {trace_id="ab12"} 0.0005 1722700000.125\n',
    'h_bucket{le="0.001"} 3 # {trace_id="ab12"} nope\n',
    'h_bucket{le="+Inf"} 3 # trailing comment\n',
    'x NaN\ny +Inf\nz -1e-3\n',
    'bad value\n',
    '\n\n  spaced 4  \n',
]


@pytest.mark.parametrize('text', TEXTS)
def test_parse_prometheus_text_equal_to_jax(text):
  def run(fn):
    try:
      return fn(text)
    except ValueError as e:
      return ('error', str(e))
  got = run(plive.parse_prometheus_text)
  want = run(jlive.parse_prometheus_text)
  assert repr(got) == repr(want)


@pytest.mark.parametrize('text', TEXTS)
def test_split_exemplar_equal_to_jax(text):
  for line in text.splitlines():
    assert plive.split_exemplar(line) == jlive.split_exemplar(line)


def test_parse_prometheus_text_rejects_malformed():
  with pytest.raises(ValueError, match='malformed sample'):
    plive.parse_prometheus_text('ok_metric 1\nbroken{ 2\n')
  with pytest.raises(ValueError, match='malformed comment'):
    plive.parse_prometheus_text('# not a help line\n')


def test_histogram_snapshot_equal_to_jax():
  rng = np.random.default_rng(3)
  secs = np.concatenate([rng.exponential(2e-3, 200), [0.0, 1e-7, 300.0]])
  jm, pm = JaxMetrics(), plive.Metrics()
  for s in secs:
    jhist.record('stage.a', float(s), registry=jm)
    phist.record('stage.a', float(s), registry=pm)
    jhist.record('stage.b', float(s) / 3, registry=jm)
    phist.record('stage.b', float(s) / 3, registry=pm)
  assert pm.snapshot() == jm.snapshot()
  got, want = phist.from_snapshot(pm.snapshot()), jhist.from_snapshot(
      jm.snapshot())
  assert sorted(got) == sorted(want)
  for kind in got:
    g, w = got[kind], want[kind]
    assert (g.buckets, g.count, g.secs) == (w.buckets, w.count, w.secs)
    for q in (0.5, 0.9, 0.99):
      assert g.quantile(q) == w.quantile(q)
  assert [phist.bucket_index(float(s)) for s in secs] == \
      [jhist.bucket_index(float(s)) for s in secs]


def test_derived_default_gauges_equal_to_jax(frozen):
  recorder.clear()
  jax_recorder.clear()
  jreg, preg = _pair()
  jlive._wire_defaults(jreg)
  plive._wire_defaults(preg)

  def samples(reg):
    # samples and TYPE lines; a HELP text is the port's own where the
    # port declared the name first
    return [ln for ln in reg.prometheus_text().splitlines()
            if not ln.startswith('# HELP')]

  assert samples(preg) == samples(jreg)
  rng = np.random.default_rng(4)
  ticks = {'cache.hits_total{scope=serving}': int(rng.integers(1, 99)),
           'cache.misses_total{scope=serving}': int(rng.integers(1, 99)),
           'cache.hits_total{scope=feature}': int(rng.integers(1, 99)),
           'dist.feature.lookups': 1000, 'dist.feature.cold_misses': 37,
           'dist.frontier.slots': 4096, 'dist.frontier.offered': 3000,
           'dist.frontier.dropped': 12, 'serving.shed_total{reason=deadline}':
           3, 'serving.admitted_total': 97}
  for reg in (jreg, preg):
    for k, v in ticks.items():
      reg._backing().inc(k, v)
  assert samples(preg) == samples(jreg)
  parsed = plive.parse_prometheus_text(preg.prometheus_text())
  assert parsed == jlive.parse_prometheus_text(jreg.prometheus_text())
  for fam in ('glt_cache_hit_rate', 'glt_cache_hbm_served_rate',
              'glt_exchange_padding_waste_pct', 'glt_serving_shed_rate',
              'glt_recorder_ring_dropped'):
    assert fam in parsed


def test_registry_strict_declared_names():
  reg = plive.LiveRegistry(store=plive.Metrics(), strict=True)
  with pytest.raises(ValueError, match='not declared'):
    reg.counter('rogue.metric_total')
  with pytest.raises(ValueError, match='snake.dot'):
    reg.counter('NotSnake')
  with pytest.raises(ValueError, match="declared as 'counter'"):
    reg.gauge('serving.requests_total')


def test_metric_names_extend_jax_declarations():
  """Every JAX declaration is in the port's vocabulary under the same
  kind; the names the port declared before keep their own text."""
  from graphlearn_tpu.telemetry.schema import METRIC_NAMES as jnames
  for name, doc in jnames.items():
    assert name in plive.METRIC_NAMES
    assert (plive.METRIC_NAMES[name].split(':', 1)[0]
            == doc.split(':', 1)[0])


def test_raising_gauge_drops_only_its_sample():
  reg = plive.LiveRegistry(store=plive.Metrics(), strict=True)
  reg.counter('serving.requests_total').inc(3)
  reg.gauge('serving.in_flight', fn=lambda: 1 / 0)
  parsed = plive.parse_prometheus_text(reg.prometheus_text())
  assert parsed['glt_serving_requests_total'] == 3
  assert 'glt_serving_in_flight' not in parsed


def test_concurrent_scrape_no_torn_histograms():
  """Every snapshot taken while writers hammer one histogram satisfies
  ``count == sum(buckets)`` (the single-lock ``inc_many``)."""
  reg = plive.LiveRegistry(store=plive.Metrics(), strict=True)
  h = reg.histogram('serving.request_latency')
  stop = threading.Event()

  def writer(seed):
    rng = np.random.default_rng(seed)
    while not stop.is_set():
      h.observe(float(rng.random()) * 1e-3)

  threads = [threading.Thread(target=writer, args=(i,), daemon=True)
             for i in range(4)]
  for t in threads:
    t.start()
  try:
    checked = 0
    deadline = time.monotonic() + 30.0
    while checked < 50 and time.monotonic() < deadline:
      for hist in phist.from_snapshot(reg._backing().snapshot()).values():
        assert sum(hist.buckets) == hist.count
        checked += 1
      plive.parse_prometheus_text(reg.prometheus_text())
  finally:
    stop.set()
    for t in threads:
      t.join(5)
  assert checked >= 50


def test_recorder_ring_overflow_matches_jax(tmp_path):
  """The recorder's bounded ring, drop count, one-shot overflow event
  and JSON-lines file sink, against the JAX recorder."""
  from graphlearn_tpu.telemetry.recorder import EventRecorder as JaxRec
  from graphlearn_tpu_torch.telemetry.recorder import EventRecorder
  recs = {'jax': JaxRec(max_events=4), 'port': EventRecorder(max_events=4)}
  out = {}
  for name, rec in recs.items():
    path = str(tmp_path / f'{name}.jsonl')
    rec.enable(path, max_file_events=5)
    for i in range(7):
      rec.emit('hop.padding', hop=i, fill=np.float32(0.5), arr=np.arange(2))
    kinds = [(e['kind'], e.get('hop')) for e in rec.events()]
    dumped = rec.dump(str(tmp_path / f'{name}.dump'))
    rec.disable()
    lines = open(path).read().splitlines()
    out[name] = (kinds, rec.stats(), rec.dropped_total, dumped, len(lines))
  assert out['port'] == out['jax']
  assert out['port'][1]['ring_dropped'] == 4
