"""The port's `SloTracker` and `CapacityModel` against the JAX package's.

One sample stream under one fake clock goes through both trackers (and
both capacity models): every window's stats, every snapshot, every
gauge and every ``slo.burn`` event must be exactly equal — both are pure
Python over the same arithmetic, so the tolerance is zero.
"""
import numpy as np
import pytest

from graphlearn_tpu.telemetry import recorder as jax_recorder
from graphlearn_tpu.telemetry.live import LiveRegistry as JaxRegistry
from graphlearn_tpu.telemetry.memaccount import (CapacityModel as
                                                 JaxCapacityModel)
from graphlearn_tpu.telemetry.slo import SloTracker as JaxSloTracker
from graphlearn_tpu_torch.telemetry import recorder
from graphlearn_tpu_torch.telemetry.live import LiveRegistry
from graphlearn_tpu_torch.telemetry.memaccount import CapacityModel
from graphlearn_tpu_torch.telemetry.slo import (SLO_P99_ENV, SLO_QPS_ENV,
                                                SloTracker)


@pytest.fixture(autouse=True)
def _recording():
  recorder.enable()
  recorder.clear()
  jax_recorder.enable(None)
  jax_recorder.clear()
  yield
  recorder.clear()
  recorder.disable()
  jax_recorder.clear()
  jax_recorder.disable()


def _stream(seed=0, n=600):
  """(dt seconds, latency ms, ok) samples: a calm stretch, a burst of
  slow and failed requests, then calm again."""
  rng = np.random.default_rng(seed)
  out = []
  for i in range(n):
    slow = 200 <= i < 320
    lat = float(rng.gamma(2.0, 40.0 if slow else 8.0))
    ok = not (slow and rng.random() < 0.2)
    out.append((float(rng.exponential(0.02)), round(lat, 3), ok))
  return out


def _pair(now, **kw):
  clock = lambda: now[0]   # noqa: E731 — the shared fake clock
  return (SloTracker(registry=LiveRegistry(), clock=clock, **kw),
          JaxSloTracker(registry=JaxRegistry(), clock=clock, **kw))


def _burns(rec):
  return [{k: e[k] for k in ('window_secs', 'burn_rate', 'p99_ms',
                             'target_p99_ms', 'qps', 'count')}
          for e in rec.events('slo.burn')]


@pytest.mark.parametrize('kw', [
    dict(p99_target_ms=60.0, windows=(1.0, 3.0), budget=0.1),
    dict(p99_target_ms=25.0, qps_target=40.0, windows=(2.0, 5.0)),
    dict(p99_target_ms=0.0, windows=(1.0, 3.0)),
])
def test_tracker_matches_jax_on_one_stream(kw):
  now = [1000.0]
  port, ref = _pair(now, **kw)
  try:
    for i, (dt, lat, ok) in enumerate(_stream()):
      now[0] += dt
      port.observe(lat, ok=ok)
      ref.observe(lat, ok=ok)
      if i % 37 == 0:
        for w in port.windows:
          assert port.window_stats(w) == ref.window_stats(w)
        assert port.snapshot() == ref.snapshot()
    for w in port.windows:
      assert port._window_burn(w, now[0]) == ref._window_burn(w, now[0])
    now[0] += 0.5
    assert port.snapshot() == ref.snapshot()
    assert _burns(recorder) == _burns(jax_recorder)
    if kw['p99_target_ms'] > 0:
      assert _burns(recorder), 'the burst must trip a burn event'
  finally:
    port.close()
    ref.close()


def test_gauges_match_jax():
  now = [50.0]
  port_reg, jax_reg = LiveRegistry(), JaxRegistry()
  clock = lambda: now[0]   # noqa: E731
  kw = dict(p99_target_ms=30.0, qps_target=20.0, windows=(1.0, 3.0))
  port = SloTracker(registry=port_reg, clock=clock, **kw)
  ref = JaxSloTracker(registry=jax_reg, clock=clock, **kw)
  try:
    for dt, lat, ok in _stream(seed=3, n=200):
      now[0] += dt
      port.observe(lat, ok=ok)
      ref.observe(lat, ok=ok)
    now[0] += 0.05
    snap_p = {k: v for k, v in port_reg.snapshot().items()
              if k.startswith('serving.slo.')}
    snap_j = {k: v for k, v in jax_reg.snapshot().items()
              if k.startswith('serving.slo.')}
    assert snap_p and snap_p == snap_j
  finally:
    port.close()
    ref.close()


def test_capacity_model_matches_jax():
  now = [10.0]
  port_slo, jax_slo = _pair(now, p99_target_ms=50.0, windows=(1.0, 3.0))
  port_reg, jax_reg = LiveRegistry(), JaxRegistry()
  port = CapacityModel(slo=port_slo, registry=port_reg)
  ref = JaxCapacityModel(slo=jax_slo, registry=jax_reg)
  try:
    assert port.capacity_qps() is None and ref.capacity_qps() is None
    assert port._headroom() is None and ref._headroom() is None
    rng = np.random.default_rng(5)
    for _ in range(120):
      now[0] += float(rng.exponential(0.01))
      cap = int(rng.choice([1, 2, 4, 8, 16]))
      reqs = int(rng.integers(1, cap + 1))
      secs = float(rng.gamma(2.0, 0.002)) * (1 + cap / 8)
      port.observe(cap, reqs, secs)
      ref.observe(cap, reqs, secs)
      for _ in range(reqs):
        lat = float(rng.gamma(2.0, 10.0))
        port_slo.observe(lat)
        jax_slo.observe(lat)
      assert port.capacity_qps() == ref.capacity_qps()
    now[0] += 0.03
    assert port.snapshot() == ref.snapshot()
    assert port._headroom() == ref._headroom() is not None
    assert (port_reg.snapshot()['fleet.headroom_qps']
            == jax_reg.snapshot()['fleet.headroom_qps'])
    port.observe(4, 0, 1.0)                  # no riders: ignored
    port.observe(4, 2, -1.0)                 # negative time: ignored
    assert port.snapshot() == ref.snapshot()
  finally:
    port.close()
    ref.close()
    port_slo.close()
    jax_slo.close()
  assert 'fleet.headroom_qps' not in port_reg.snapshot()


def test_env_targets(monkeypatch):
  monkeypatch.setenv(SLO_P99_ENV, '75')
  monkeypatch.setenv(SLO_QPS_ENV, 'junk')
  t = SloTracker(registry=LiveRegistry())
  try:
    assert t.p99_target_ms == 75.0 and t.qps_target == 0.0
  finally:
    t.close()
