"""In-process live metrics registry: counters, scrape-time gauges and
health providers.

The port's copy of the part of the JAX package's `telemetry/live.py`
that the port's slices call (`live.counter`, `live.gauge`,
`unregister_gauge`, `register_health` / `unregister_health`,
`healthz`, `snapshot`), with the names unchanged.  Counters write to
one process-wide `Metrics` store; gauges are zero-argument callbacks
evaluated at scrape time.  Every registered name must be declared in
`METRIC_NAMES`, so a typo fails at registration, not on a dashboard.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

#: the declared vocabulary: name -> '<kind>: <doc>'
METRIC_NAMES: Dict[str, str] = {
    'ingest.events_total':
        'counter: edge-insert events applied by IngestPipeline',
    'ingest.compactions_total':
        'counter: compacted-base snapshots published by IngestPipeline',
    'ingest.lag_events':
        'gauge: events appended to the WAL but not yet applied',
    'graph.version':
        'gauge: the newest published StreamingGraph version',
    'memory.tier_bytes':
        'gauge: bytes held by one memory tier (label tier=)',
    'memory.tier_peak_bytes':
        'gauge: high-watermark of memory.tier_bytes since registration',
    'snapshot.saves_total':
        'counter: SnapshotManager snapshots published',
    'snapshot.save_failures_total':
        'counter: SnapshotManager saves that failed and were absorbed',
    'snapshot.save_age_seconds':
        'gauge: seconds since the last published snapshot',
    'snapshot.restore_age_seconds':
        'gauge: seconds since the last snapshot restore',
    'postmortem.dumps_total':
        'counter: post-mortem bundles written',
    'dist.slack.transitions':
        'counter: AdaptiveSlack rung changes of the mesh exchange capacity',
    'dist.frontier.offered':
        'counter: valid frontier ids entering a mesh exchange',
    'dist.frontier.dropped':
        'counter: frontier ids past an owner\'s exchange capacity',
    'dist.frontier.slots':
        'counter: frontier exchange send slots (the padded width)',
    'dist.feature.offered':
        'counter: valid node ids entering the feature exchange',
    'dist.feature.dropped':
        'counter: node ids past an owner\'s feature exchange capacity',
    'dist.feature.slots':
        'counter: feature exchange send slots (the padded width)',
    'dist.feature.lookups':
        'counter: valid node slots read from a tiered mesh store',
    'dist.feature.cold_lookups':
        'counter: node slots past the hot tier (cold rows)',
    'dist.feature.cold_misses':
        'counter: cold rows gathered from host memory',
    'dist.feature.cache_hits':
        'counter: cold rows served by the on-card victim cache',
    'dist.feature.cache_admits':
        'counter: rows admitted to the victim cache',
    'dist.feature.cache_evicts':
        'counter: rows evicted from the victim cache',
    'cache.hits_total':
        'counter: cold rows served by a victim cache, by scope '
        '(feature|serving)',
    'cache.misses_total':
        'counter: cold rows filled from the host tier, by scope',
    'cache.admits_total':
        'counter: rows admitted into a victim cache, by scope',
    'cache.evicts_total':
        'counter: residents displaced by admissions, by scope',
    'serving.slo.p50_ms':
        'gauge: SloTracker short-window request latency p50 (ms)',
    'serving.slo.p99_ms':
        'gauge: SloTracker short-window request latency p99 (ms)',
    'serving.slo.qps':
        'gauge: SloTracker short-window completed-request rate',
    'serving.slo.qps_ratio':
        'gauge: short-window qps / GLT_SERVING_SLO_QPS (only with a '
        'target)',
    'serving.slo.burn_rate':
        'gauge: latency-SLO error-budget burn rate per sliding window '
        '(label window=)',
    'fleet.headroom_qps':
        'gauge: sustainable request rate minus carried short-window qps '
        '(CapacityModel)',
    'fleet.replicas':
        'gauge: FleetRouter replica count by state (label state=)',
    'fleet.redrives_total':
        'counter: in-flight requests redriven from a lost replica',
    'fleet.evictions_total':
        'counter: replicas evicted after consecutive heartbeat misses',
    'fleet.quarantines_total':
        'counter: replicas quarantined by the flap damper',
    'scale.replicas':
        'counter: ElasticController scaling actions (label dir=out|in)',
    'serving.swaps_total':
        'counter: hot model-swap attempts (label '
        'outcome=ok|rolled_back|aborted)',
    'aot.cache_hits_total':
        'counter: kernel libraries restored from GLT_AOT_CACHE_DIR',
    'aot.cache_misses_total':
        'counter: cache lookups that fell back to nvcc',
    'partition.adoptions_total':
        'counter: partition-ownership transfers executed '
        '(failover.adopt_shard: durable shard loaded, book version bumped, '
        'survivor serving the orphaned range)',
    'partition.book_version':
        "gauge: the PartitionBook's current published version (0 = "
        'identity ownership; each move bumps it and every reader re-fences '
        'at its next dispatch seam)',
    'partition.recovery_secs':
        'gauge: classification-to-first-served-batch wall time of the most '
        'recent partition adoption (shard load + lane upload + the batch)',
    'gns.range_hotness':
        'gauge: decayed visit mass share of one range from the GNS sketches '
        '(label partition=; only the K hottest ranges report)',
    'exchange.local_ids_total':
        'counter: exchange ids whose destination range the requester '
        'serves itself (the attribution diagonal, owner-aware)',
    'exchange.cross_ids_total':
        'counter: exchange ids routed to another partition\'s range',
    'partition.replicated_rows':
        'gauge: rows of the read-only replica cache each partition holds '
        '(0 = replication off)',
    'locality.edge_cut_frac':
        'gauge: fraction of edges crossing partitions under the most '
        'recent locality_partition run',
}


class Metrics:
  """Thread-safe counter store (the backing store of live counters)."""

  def __init__(self):
    self._lock = threading.Lock()
    self._counts: Dict[str, float] = {}

  def inc(self, name: str, value: float = 1.0) -> None:
    with self._lock:
      self._counts[name] = self._counts.get(name, 0) + value

  def snapshot(self) -> Dict[str, float]:
    with self._lock:
      return dict(self._counts)


#: process-global counter store
metrics = Metrics()


def flat_key(name: str, labels: Optional[Dict[str, object]] = None) -> str:
  """``name`` or ``name{k=v,...}`` with sorted label keys."""
  if not labels:
    return name
  inner = ','.join(f'{k}={labels[k]}' for k in sorted(labels))
  return f'{name}{{{inner}}}'


class Counter:
  """Monotone counter writing through to the backing `Metrics` store."""

  def __init__(self, store: Metrics, key: str):
    self._store = store
    self.key = key

  def inc(self, value: float = 1.0) -> None:
    self._store.inc(self.key, value)

  def value(self) -> float:
    return float(self._store.snapshot().get(self.key, 0.0))


class Gauge:
  """Point-in-time value from a callback evaluated at scrape time.  A
  callback that raises (or returns None) drops the sample from that
  scrape."""

  def __init__(self, key: str, fn: Callable[[], Optional[float]]):
    self.key = key
    self._fn = fn

  def value(self) -> Optional[float]:
    try:
      v = self._fn()
    except Exception:               # noqa: BLE001 — a scrape survives
      return None
    return None if v is None else float(v)


class LiveRegistry:
  """Thread-safe registry of declared live metrics + health providers,
  over the process-wide `metrics` store.  Registration is idempotent per
  ``(kind, name, labels)``; a gauge registered again takes the new
  callback (latest instance wins)."""

  def __init__(self):
    self._lock = threading.Lock()
    self._store = metrics
    self._instances: Dict[Tuple[str, str], object] = {}
    self._health: Dict[str, Callable[[], dict]] = {}

  @staticmethod
  def _check(kind: str, name: str) -> None:
    doc = METRIC_NAMES.get(name)
    if doc is None:
      raise ValueError(f'live metric {name!r} is not declared in '
                       'telemetry/live.py::METRIC_NAMES')
    if not doc.startswith(f'{kind}:'):
      raise ValueError(f'live metric {name!r} is declared as '
                       f'{doc.split(":", 1)[0]!r}, registered as {kind!r}')

  def counter(self, name: str,
              labels: Optional[Dict[str, object]] = None) -> Counter:
    self._check('counter', name)
    key = flat_key(name, labels)
    with self._lock:
      inst = self._instances.get(('counter', key))
      if inst is None:
        inst = self._instances[('counter', key)] = Counter(self._store, key)
      return inst

  def gauge(self, name: str, labels: Optional[Dict[str, object]] = None,
            *, fn: Callable[[], Optional[float]]) -> Gauge:
    self._check('gauge', name)
    key = flat_key(name, labels)
    with self._lock:
      inst = self._instances[('gauge', key)] = Gauge(key, fn)
      return inst

  def unregister_gauge(self, name: str,
                       labels: Optional[Dict[str, object]] = None,
                       fn: Optional[Callable] = None) -> bool:
    """Drop a gauge so its callback stops pinning its owner.  With
    ``fn``, only if the gauge still holds THAT callback (a stale
    owner's close must not evict its replacement)."""
    key = ('gauge', flat_key(name, labels))
    with self._lock:
      inst = self._instances.get(key)
      if inst is None or (fn is not None and inst._fn is not fn):
        return False
      del self._instances[key]
      return True

  def register_health(self, component: str, fn: Callable[[], dict]) -> None:
    with self._lock:
      self._health[component] = fn

  def unregister_health(self, component: str,
                        fn: Optional[Callable] = None) -> None:
    with self._lock:
      if fn is None or self._health.get(component) is fn:
        self._health.pop(component, None)

  def healthz(self) -> dict:
    """``ok`` is the AND of every provider's ``healthy`` flag; a
    provider that raises reports unhealthy with the error."""
    with self._lock:
      providers = list(self._health.items())
    components, ok = {}, True
    for name, fn in providers:
      try:
        block = dict(fn())
      except Exception as e:        # noqa: BLE001 — a scrape survives
        block = {'healthy': False, 'error': f'{type(e).__name__}: {e}'}
      block['healthy'] = bool(block.get('healthy', True))
      ok = ok and block['healthy']
      components[name] = block
    return {'ok': ok, 'pid': os.getpid(), 'ts': round(time.time(), 3),
            'components': components}

  def snapshot(self) -> Dict[str, float]:
    """Flat ``{key: value}``: every counter plus every evaluated gauge."""
    snap = self._store.snapshot()
    with self._lock:
      gauges = [m for (k, _), m in self._instances.items() if k == 'gauge']
    for g in gauges:
      v = g.value()
      if v is not None:
        snap[g.key] = v
    return snap


#: process-global live registry (names must be declared)
live = LiveRegistry()
