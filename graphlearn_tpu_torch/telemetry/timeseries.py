"""Time-series history over the live metric plane.

The port's copy of the JAX package's `telemetry/timeseries.py`.  The
live registry answers "what is the value NOW"; a controller (the
autoscaler) and an operator running a postmortem both need "what was it
over the last N minutes".  `TimeSeriesStore` is a
fixed-cadence sampler over every DECLARED live instrument:

  * **gauges** are evaluated exactly as a scrape would (a callback
    that raises or returns None drops that sample, never the sweep);
  * **counters** are converted to per-second RATES between
    consecutive sweeps (a cumulative total is useless to plot; a
    counter that rewinds — the fused rollback path — clamps to 0
    rather than recording a negative rate);
  * **histograms** are summarized per sweep as an observation rate
    (``<key>.hist:rate`` from the flat ``count`` key) — the full
    bucket vector stays a scrape-time artifact.

Samples land in bounded per-series ring buffers sized by
``retention / cadence`` (``GLT_TS_RETENTION_S`` / ``GLT_TS_CADENCE_MS``,
default 300 s at 1 s), so memory is fixed no matter how long the
process lives.  The store serves windowed queries (the `OpsServer`
``/timeseries`` JSON route) and attaches its rings to postmortem
bundles — a crash dump shows burn-rate / queue-depth / ingest-lag
leading INTO the incident, not just the final snapshot.

The sweep thread reads shared state only through the same surfaces a
scrape uses (`Metrics.snapshot`, gauge callbacks) — it must never
take a hot-path lock.  `SloTracker` gauges read through the tracker's
scrape memo and the admission queue-depth gauge is a lock-free
``len()`` read, so a 1 Hz (or much faster) cadence loop costs the
serving executor nothing (pinned by the concurrent observe+sample
test in ``tests/test_torch_timeseries.py``).
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

TS_CADENCE_ENV = 'GLT_TS_CADENCE_MS'
TS_RETENTION_ENV = 'GLT_TS_RETENTION_S'

DEFAULT_CADENCE_MS = 1000.0
DEFAULT_RETENTION_S = 300.0

QUERY_SCHEMA = 'glt.timeseries.v1'

#: flat-key suffix marking a counter-derived rate series
RATE_SUFFIX = ':rate'


def cadence_ms_from_env(default: float = DEFAULT_CADENCE_MS) -> float:
  try:
    return max(float(os.environ.get(TS_CADENCE_ENV, default)), 1.0)
  except ValueError:
    return default


def retention_s_from_env(default: float = DEFAULT_RETENTION_S) -> float:
  try:
    return max(float(os.environ.get(TS_RETENTION_ENV, default)), 1.0)
  except ValueError:
    return default


class _Ring:
  """One bounded series: parallel (ts, value) deques plus the raw
  cumulative count a rate series differentiates."""

  __slots__ = ('kind', 'points', 'last_raw')

  def __init__(self, kind: str, maxlen: int):
    self.kind = kind                  # 'gauge' | 'rate'
    self.points: 'collections.deque[Tuple[float, float]]' = \
        collections.deque(maxlen=maxlen)
    self.last_raw: Optional[float] = None


class TimeSeriesStore:
  """Fixed-cadence history sampler over one `LiveRegistry`.

  Args:
    registry: live registry to walk (None = the process-global one).
    cadence_ms: sweep period (None = ``GLT_TS_CADENCE_MS``).
    retention_s: ring span (None = ``GLT_TS_RETENTION_S``); ring
      length is ``ceil(retention / cadence)``.
    clock: wall-clock source stamped on samples (tests inject a fake
      and drive `sample_once` directly — the acceptance bundles need
      60 s of history without 60 s of wall time).
  """

  def __init__(self, registry=None, cadence_ms: Optional[float] = None,
               retention_s: Optional[float] = None, clock=time.time):
    if registry is None:
      from .live import live as registry
    self.registry = registry
    self.cadence_ms = (cadence_ms_from_env() if cadence_ms is None
                       else max(float(cadence_ms), 1.0))
    self.retention_s = (retention_s_from_env() if retention_s is None
                        else max(float(retention_s), 1.0))
    self._ring_len = max(
        2, int(-(-self.retention_s * 1000.0 // self.cadence_ms)))
    self._clock = clock
    self._lock = threading.Lock()
    self._rings: Dict[str, _Ring] = {}
    self._thread: Optional[threading.Thread] = None
    self._stop = threading.Event()
    self._m_samples = registry.counter('timeseries.samples_total')
    self._series_fn = self._series_count
    registry.gauge('timeseries.series', fn=self._series_fn)

  # -- sampling ------------------------------------------------------------
  def _series_count(self) -> float:
    with self._lock:
      return float(len(self._rings))

  def _ring(self, key: str, kind: str) -> _Ring:
    ring = self._rings.get(key)
    if ring is None:
      ring = self._rings[key] = _Ring(kind, self._ring_len)
    return ring

  def sample_once(self, now: Optional[float] = None) -> int:
    """One sweep over the registry's instruments; returns the number
    of points recorded.  Never raises: a broken gauge drops its own
    sample only (same contract as a scrape)."""
    from .histogram import HIST_SEP, KEY_PREFIX
    now = self._clock() if now is None else float(now)
    snap = self.registry._backing().snapshot()
    # gauges evaluate OUTSIDE the ring lock: a callback may read back
    # through the registry (the store's own series gauge does)
    entries: List[Tuple[str, str, float]] = []
    for kind, m in self.registry.instruments():
      if kind == 'counter':
        entries.append(('rate', m.key + RATE_SUFFIX,
                        float(snap.get(m.key, 0.0))))
      elif kind == 'gauge':
        v = m.value()
        if v is not None:
          entries.append(('gauge', m.key, float(v)))
      else:                           # histogram: observation rate
        entries.append(('rate', m.key + '.hist' + RATE_SUFFIX,
                        float(snap.get(
                            f'{KEY_PREFIX}{m.key}{HIST_SEP}count',
                            0.0))))
    recorded = 0
    with self._lock:
      for kind, key, v in entries:
        ring = self._ring(key, kind)
        if kind == 'rate':
          recorded += self._push_rate(ring, now, v)
        else:
          ring.points.append((now, v))
          recorded += 1
    self._m_samples.inc()
    return recorded

  @staticmethod
  def _push_rate(ring: _Ring, now: float, raw: float) -> int:
    prev = ring.last_raw
    prev_t = ring.points[-1][0] if ring.points else None
    ring.last_raw = raw
    if prev is None:
      # first observation anchors the delta; no rate yet
      ring.points.append((now, 0.0))
      return 0
    dt = now - (prev_t if prev_t is not None else now)
    rate = max(raw - prev, 0.0) / dt if dt > 0 else 0.0
    ring.points.append((now, round(rate, 6)))
    return 1

  # -- queries -------------------------------------------------------------
  def query(self, names: Optional[List[str]] = None,
            window_s: Optional[float] = None) -> dict:
    """Windowed JSON-able view: ``{schema, cadence_ms, retention_s,
    series: {key: {kind, points: [[ts, v], ...]}}}``.  ``names``
    filters by exact series key or dotted prefix — a counter NAME
    matches its derived ``:rate`` series, so callers ask for the
    instrument they know; ``window_s`` keeps only points newer than
    ``now - window_s``."""
    now = self._clock()
    horizon = None if window_s is None else now - float(window_s)
    with self._lock:
      items = [(k, r.kind, list(r.points))
               for k, r in sorted(self._rings.items())]
    series = {}
    for key, kind, points in items:
      if names is not None and not any(
          key == n or key.startswith(n + '.')
          or key.startswith(n + '{') or key.startswith(n + ':')
          for n in names):
        continue
      if horizon is not None:
        points = [p for p in points if p[0] >= horizon]
      if points:
        series[key] = {'kind': kind,
                       'points': [[round(t, 3), v] for t, v in points]}
    return {'schema': QUERY_SCHEMA, 'ts': round(now, 3),
            'cadence_ms': self.cadence_ms,
            'retention_s': self.retention_s, 'series': series}

  def span_s(self) -> float:
    """Seconds of history currently held (max over series)."""
    with self._lock:
      spans = [r.points[-1][0] - r.points[0][0]
               for r in self._rings.values() if len(r.points) >= 2]
    return max(spans) if spans else 0.0

  # -- lifecycle -----------------------------------------------------------
  def start(self) -> 'TimeSeriesStore':
    if self._thread is None:
      self._stop.clear()
      self._thread = threading.Thread(target=self._loop, daemon=True,
                                      name='glt-timeseries')
      self._thread.start()
    return self

  def _loop(self) -> None:
    period = self.cadence_ms / 1000.0
    while not self._stop.wait(period):
      try:
        self.sample_once()
      except Exception:               # noqa: BLE001 — the sweep must
        pass                          # outlive any one broken sweep

  def close(self) -> None:
    self._stop.set()
    t = self._thread
    if t is not None:
      t.join(2.0)
    self._thread = None
    self.registry.unregister_gauge('timeseries.series',
                                   fn=self._series_fn)


# -- process global ----------------------------------------------------------
_global: Optional[TimeSeriesStore] = None
_global_lock = threading.Lock()


def global_store() -> Optional[TimeSeriesStore]:
  return _global


def ensure_global(registry=None) -> TimeSeriesStore:
  """Start (or return) the process-global cadence sampler — called by
  `opsserver.maybe_start_from_env` so any process with an ops
  endpoint gets history for free, and by the postmortem path so a
  bundle can attach whatever rings exist."""
  global _global
  with _global_lock:
    if _global is None:
      _global = TimeSeriesStore(registry=registry).start()
    return _global


def stop_global() -> None:
  global _global
  with _global_lock:
    if _global is not None:
      _global.close()
      _global = None
