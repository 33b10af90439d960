"""Time-series rings and post-mortem bundles: the port's
`telemetry.timeseries` and `telemetry.postmortem` against the JAX
package's.

The same gauge sequence and counter ticks, swept at the same injected
instants, give equal rings and ``:rate`` series (a rewinding counter
clamps to 0, a raising gauge drops only its own sample, the rings stay
bounded).  A bundle the port writes under ``GLT_POSTMORTEM_DIR`` (its
recorder ring, the live snapshot, health and the time-series rings)
loads in both packages and renders equal to JAX's `render_postmortem`.
"""
import importlib
import json
import os
import signal

import numpy as np
import pytest

from graphlearn_tpu.utils.profiling import Metrics as JaxMetrics

jts = importlib.import_module('graphlearn_tpu.telemetry.timeseries')
jlive = importlib.import_module('graphlearn_tpu.telemetry.live')
jpm = importlib.import_module('graphlearn_tpu.telemetry.postmortem')
jreport = importlib.import_module('graphlearn_tpu.telemetry.report')
pts = importlib.import_module('graphlearn_tpu_torch.telemetry.timeseries')
plive = importlib.import_module('graphlearn_tpu_torch.telemetry.live')
ppm = importlib.import_module('graphlearn_tpu_torch.telemetry.postmortem')
preport = importlib.import_module('graphlearn_tpu_torch.telemetry.report')
prec = importlib.import_module('graphlearn_tpu_torch.telemetry.recorder')


def _store(ts, live, metrics_cls, seq, **kw):
  reg = live.LiveRegistry(store=metrics_cls(), strict=True)
  state = {'depth': None}
  reg.gauge('serving.queue_depth', fn=lambda: state['depth'])
  reg.gauge('serving.in_flight', fn=lambda: 1 / 0)       # always drops
  c = reg.counter('serving.requests_total')
  h = reg.histogram('serving.queue_wait')
  store = ts.TimeSeriesStore(registry=reg, clock=lambda: 5000.0, **kw)
  for i, (depth, ticks) in enumerate(seq):
    state['depth'] = depth
    if ticks < 0:                       # a rewound counter
      reg._backing().inc('serving.requests_total', ticks)
    else:
      c.inc(ticks)
      for _ in range(ticks):
        h.observe(0.001)
    store.sample_once(now=1000.0 + 0.5 * i)
  return store


def _seq(seed, n=40):
  rng = np.random.default_rng(seed)
  out = []
  for i in range(n):
    depth = None if i % 9 == 4 else float(rng.integers(0, 50))
    ticks = int(rng.integers(0, 20))
    out.append((depth, -ticks if i == 17 else ticks))
  return out


@pytest.mark.parametrize('seed', [0, 1])
def test_rings_and_rates_equal_to_jax(seed):
  seq = _seq(seed)
  kw = dict(cadence_ms=500.0, retention_s=8.0)
  j = _store(jts, jlive, JaxMetrics, seq, **kw)
  p = _store(pts, plive, plive.Metrics, seq, **kw)
  got, want = p.query(), j.query()
  assert got == want
  assert p.query(names=['serving.requests_total'], window_s=3.0) == \
      j.query(names=['serving.requests_total'], window_s=3.0)
  rate = got['series']['serving.requests_total:rate']['points']
  assert len(rate) == 16                       # bounded: 8 s / 0.5 s
  assert min(v for _, v in rate) >= 0.0        # a rewind clamps to 0
  assert 'serving.in_flight' not in got['series']
  assert p.span_s() == j.span_s()


def test_global_store_lifecycle():
  pts.stop_global()
  assert pts.global_store() is None
  reg = plive.LiveRegistry(store=plive.Metrics(), strict=True)
  store = pts.ensure_global(registry=reg)
  try:
    assert pts.ensure_global() is store
    assert store.sample_once(now=1.0) >= 0
    assert reg.counter('timeseries.samples_total').value() >= 1
  finally:
    pts.stop_global()
  assert pts.global_store() is None


@pytest.fixture
def pm_dir(tmp_path, monkeypatch):
  monkeypatch.setenv('GLT_POSTMORTEM_DIR', str(tmp_path))
  ppm.reset()
  prec.recorder.enable()
  prec.recorder.clear()
  yield tmp_path
  prec.recorder.clear()
  prec.recorder.disable()
  ppm.reset()
  pts.stop_global()


class _Stall(RuntimeError):
  def __init__(self, msg):
    super().__init__(msg)
    self.scope = 'fused.dispatch'
    self.deadline = 2.5
    self.outstanding = [3, 4]


def test_bundle_rendered_equal_to_jax(pm_dir):
  from graphlearn_tpu_torch.telemetry import span
  rec = prec.recorder
  reg = plive.live
  store = pts.ensure_global()
  store.sample_once(now=100.0)
  plive.live.counter('serving.requests_total').inc(3)
  store.sample_once(now=101.0)
  for i in range(3):
    rec.emit('serving.request', seeds=1, bucket=2, coalesced=1, ok=True,
             latency_ms=1.0 + i)
  rec.emit('serving.shed', reason='deadline', seeds=1, queue_depth=0)
  with span('fused.epoch', scope='FusedEpoch'):
    with span('fused.dispatch', chunk=0):
      pass
    outer = span('feature.cold_overlay', steps=2)
    outer.__enter__()                  # still open at the dump
    path = ppm.dump('fused.stall', error=_Stall('no progress'),
                    extra={'chunk': 3})
    outer.__exit__(None, None, None)
  assert path and os.path.dirname(path) == str(pm_dir)
  assert ppm.dump('fused.stall') is None       # one-shot per reason
  bundle = ppm.load_bundle(path)
  assert bundle == jpm.load_bundle(path)
  assert bundle['error']['scope'] == 'fused.dispatch'
  assert bundle['error']['outstanding'] == '[3, 4]'
  assert 'serving.requests_total:rate' in bundle['timeseries']['series']
  assert any(e['kind'] == 'span.begin' for e in bundle['events'])
  text = preport.render_postmortem(bundle)
  assert text == jreport.render_postmortem(bundle)
  assert 'feature.cold_overlay' in text and 'no progress' in text
  assert reg.counter('postmortem.dumps_total').value() >= 1


def test_postmortem_disabled_without_dir(monkeypatch):
  monkeypatch.delenv('GLT_POSTMORTEM_DIR', raising=False)
  ppm.reset()
  assert not ppm.enabled()
  assert ppm.dump('x.y') is None
  assert ppm.install_signal_handlers() is False


def test_load_bundle_refuses_foreign_json(tmp_path):
  p = tmp_path / 'x.json'
  p.write_text(json.dumps({'schema': 'other'}))
  with pytest.raises(ValueError, match='not a post-mortem bundle'):
    ppm.load_bundle(str(p))


def test_error_block_equal_to_jax():
  err = _Stall('mesh stalled')
  assert ppm._error_block(err) == jpm._error_block(err)


def test_signal_handler_dumps_then_chains(pm_dir):
  """SIGUSR1 through the chained handler: a bundle, then the previous
  handler runs."""
  seen = []
  prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
  try:
    ppm._signals_installed = False
    assert ppm.install_signal_handlers(signums=(signal.SIGUSR1,))
    os.kill(os.getpid(), signal.SIGUSR1)
    assert seen == [signal.SIGUSR1]
    names = os.listdir(pm_dir)
    assert any('signal_sigusr1' in n for n in names)
  finally:
    signal.signal(signal.SIGUSR1, prev)
    ppm._signals_installed = False
