"""Serving SLO tracking: sliding-window percentiles and burn rate.

The port's copy of the JAX package's `telemetry/slo.py` (pure Python;
the same sample stream gives the same snapshots and burns).  A latency
SLO "99% of requests under ``T`` ms" carries an error budget of 1%; the
signal is the **burn rate** of a window::

    burn = (violating_requests / requests) / budget

``burn == 1`` spends the budget exactly.  Two windows (default 60 s and
300 s): the short one catches a fast burn early, the long one filters
blips.

`SloTracker` keeps a bounded deque of ``(mono, latency_ms, ok)``
samples, exports ``serving.slo.*`` gauges (evaluated at scrape time)
and emits a one-shot ``slo.burn`` recorder event when a window's burn
crosses 1.0 (re-armed when it recovers).

Targets: ``GLT_SERVING_SLO_P99_MS`` (latency; 0/unset tracks
percentiles but never burns) and ``GLT_SERVING_SLO_QPS`` (a throughput
floor, exported as ``serving.slo.qps_ratio``; never a burn trigger).
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, Optional, Tuple

SLO_P99_ENV = 'GLT_SERVING_SLO_P99_MS'
SLO_QPS_ENV = 'GLT_SERVING_SLO_QPS'

#: p99 SLO => 1% of requests may violate
DEFAULT_BUDGET = 0.01
DEFAULT_WINDOWS = (60.0, 300.0)

#: hard sample bound: past it the oldest samples age out early
_MAX_SAMPLES = 200_000

#: re-evaluate burn on the observe path at most this often
_EVAL_INTERVAL_S = 1.0


def slo_p99_ms_from_env() -> float:
  try:
    return max(float(os.environ.get(SLO_P99_ENV, 0.0)), 0.0)
  except ValueError:
    return 0.0


def slo_qps_from_env() -> float:
  try:
    return max(float(os.environ.get(SLO_QPS_ENV, 0.0)), 0.0)
  except ValueError:
    return 0.0


class SloTracker:
  """Sliding-window latency/throughput SLO state for one serving tier.

  Args:
    p99_target_ms: latency SLO (None = ``GLT_SERVING_SLO_P99_MS``;
      0 = no latency SLO — percentiles and qps still tracked).
    qps_target: throughput floor (None = ``GLT_SERVING_SLO_QPS``).
    windows: sliding windows in seconds (sorted; the first is "short").
    budget: allowed violating fraction (0.01 for a p99 SLO).
    registry: `LiveRegistry` to export gauges on (None = the global one).
    clock: monotonic time source (tests inject a fake).
  """

  def __init__(self, p99_target_ms: Optional[float] = None,
               qps_target: Optional[float] = None,
               windows: Tuple[float, ...] = DEFAULT_WINDOWS,
               budget: float = DEFAULT_BUDGET,
               registry=None, clock=time.monotonic):
    self.p99_target_ms = (slo_p99_ms_from_env()
                          if p99_target_ms is None
                          else max(float(p99_target_ms), 0.0))
    self.qps_target = (slo_qps_from_env() if qps_target is None
                       else max(float(qps_target), 0.0))
    self.windows = tuple(sorted(float(w) for w in windows))
    self.budget = float(budget)
    self._clock = clock
    self._lock = threading.Lock()
    self._samples: 'collections.deque[Tuple[float, float, bool]]' = \
        collections.deque(maxlen=_MAX_SAMPLES)
    #: per-window memo of (now, stats): one scrape reads several gauges
    self._stats_cache: Dict[float, Tuple[float, dict]] = {}
    self._started = clock()
    self._tripped: Dict[float, bool] = {w: False for w in self.windows}
    self._last_eval = -1e18
    if registry is None:
      from .live import live as registry
    self._registry = registry
    self._registered: list = []     # [(name, labels, fn)] for close()
    self._register_gauges(registry)

  def close(self) -> None:
    """Unregister this tracker's gauges (fn-identity guarded: a newer
    tracker's gauges survive)."""
    for name, labels, fn in self._registered:
      self._registry.unregister_gauge(name, labels, fn=fn)
    self._registered = []

  # -- feeding -------------------------------------------------------------
  def observe(self, latency_ms: float, ok: bool = True) -> None:
    """Record one resolved request (a failed request counts against the
    budget whatever its latency).  Burn evaluation is throttled to
    `_EVAL_INTERVAL_S`."""
    now = self._clock()
    with self._lock:
      self._samples.append((now, float(latency_ms), bool(ok)))
      horizon = now - self.windows[-1]
      while self._samples and self._samples[0][0] < horizon:
        self._samples.popleft()
      due = now - self._last_eval >= _EVAL_INTERVAL_S
      if due:
        self._last_eval = now
    if due and self.p99_target_ms > 0:
      self._evaluate_burn(now)

  # -- window math ---------------------------------------------------------
  def _window_samples(self, window: float, now: float):
    horizon = now - window
    with self._lock:
      return [s for s in self._samples if s[0] >= horizon]

  def window_stats(self, window: float,
                   now: Optional[float] = None) -> dict:
    """count / p50 / p99 (ms, over OK requests) / qps / violations /
    burn for one window.  ``qps`` divides by the elapsed time while the
    tracker is younger than the window.  An empty window, or a tracker
    without a target or budget, reads burn 0.0."""
    now = self._clock() if now is None else now
    samples = self._window_samples(window, now)
    span = max(min(window, now - self._started), 1e-9)
    ok_lats = sorted(lat for _, lat, ok in samples if ok)
    violations = sum(1 for _, lat, ok in samples
                     if not ok or (self.p99_target_ms > 0
                                   and lat > self.p99_target_ms))
    count = len(samples)
    burn = ((violations / count) / self.budget
            if count and self.p99_target_ms > 0 and self.budget > 0
            else 0.0)

    def q(p: float) -> float:
      if not ok_lats:
        return 0.0
      i = min(int(p * (len(ok_lats) - 1) + 0.5), len(ok_lats) - 1)
      return ok_lats[i]

    return {'window_secs': window, 'count': count,
            'p50_ms': round(q(0.5), 3), 'p99_ms': round(q(0.99), 3),
            'qps': round(len(ok_lats) / span, 3),
            'violations': violations, 'burn_rate': round(burn, 4)}

  def _window_burn(self, window: float, now: float
                   ) -> Tuple[int, float]:
    """(count, burn) for one window in one sort-free pass (the
    observe path must not pay a percentile sort)."""
    horizon = now - window
    count = violations = 0
    with self._lock:
      for t, lat, ok in reversed(self._samples):
        if t < horizon:
          break                      # the deque is time-ordered
        count += 1
        if not ok or lat > self.p99_target_ms:
          violations += 1
    burn = ((violations / count) / self.budget
            if count and self.budget > 0 else 0.0)
    return count, burn

  def _evaluate_burn(self, now: float) -> None:
    from .recorder import recorder
    for w in self.windows:
      count, burn = self._window_burn(w, now)
      burning = count > 0 and burn > 1.0
      if burning and not self._tripped[w]:
        self._tripped[w] = True
        st = self.window_stats(w, now)
        recorder.emit('slo.burn', window_secs=w,
                      burn_rate=st['burn_rate'], p99_ms=st['p99_ms'],
                      target_p99_ms=self.p99_target_ms,
                      qps=st['qps'], count=st['count'])
      elif not burning and self._tripped[w]:
        self._tripped[w] = False     # re-arm: the next incident logs

  def _cached_stats(self, window: float) -> dict:
    """`window_stats` memoized for 20 ms (one scrape burst reads several
    gauges); an entry from a clock that moved backwards is stale."""
    now = self._clock()
    entry = self._stats_cache.get(window)
    if entry is not None and 0 <= now - entry[0] < 0.02:
      return entry[1]
    st = self.window_stats(window, now)
    self._stats_cache[window] = (now, st)
    return st

  # -- export --------------------------------------------------------------
  def snapshot(self) -> dict:
    """Per-window stats and targets (the heartbeat block)."""
    return {'p99_target_ms': self.p99_target_ms,
            'qps_target': self.qps_target,
            'windows': [self._cached_stats(w) for w in self.windows]}

  def _register_gauges(self, registry) -> None:
    short = self.windows[0]

    def gauge(name, labels, fn):
      registry.gauge(name, labels=labels, fn=fn)
      self._registered.append((name, labels, fn))

    def stat(key: str):
      def read() -> Optional[float]:
        st = self._cached_stats(short)
        return float(st[key]) if st['count'] else None
      return read

    gauge('serving.slo.p50_ms', None, stat('p50_ms'))
    gauge('serving.slo.p99_ms', None, stat('p99_ms'))
    gauge('serving.slo.qps', None, stat('qps'))
    for w in self.windows:
      def burn(w=w) -> Optional[float]:
        st = self._cached_stats(w)
        if not st['count'] or self.p99_target_ms <= 0:
          return None
        return float(st['burn_rate'])
      gauge('serving.slo.burn_rate', {'window': f'{int(w)}s'}, burn)

    def qps_ratio() -> Optional[float]:
      if self.qps_target <= 0:
        return None
      st = self._cached_stats(short)
      return (round(st['qps'] / self.qps_target, 4)
              if st['count'] else None)
    gauge('serving.slo.qps_ratio', None, qps_ratio)
