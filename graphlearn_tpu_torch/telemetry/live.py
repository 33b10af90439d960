"""In-process live metrics registry: the pull side of the ops plane.

The port's copy of the JAX package's `telemetry/live.py`, with the same
names and renderings.  One process-wide `Metrics` counter store backs
every counter and histogram, so the live scrape, the post-mortem bundle
and the bench artifact read one vocabulary:

  * **counters** write through to the backing store under their
    declared name (plus an optional ``{k=v}`` label suffix);
  * **histograms** reuse the log2 bucket layout of
    `telemetry.histogram` (flat ``span.<name>.hist.*`` keys, recorded
    through ``Metrics.inc_many`` so a concurrent scrape never sees a
    torn bucket/count pair); an observation may carry a trace id as the
    bucket's OpenMetrics exemplar;
  * **gauges** hold a stored float or a zero-argument callback
    evaluated at scrape time.

Every name registered on a strict registry (the process-global
:data:`live`) must appear in `METRIC_NAMES` with a ``'<type>: <doc>'``
value, so a typo fails at registration, not on a dashboard.
`prometheus_text` renders the text exposition (format 0.0.4),
`parse_prometheus_text` is its strict validator.
"""
from __future__ import annotations

import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from . import histogram as _hist

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
    'ops.scrapes_total':
        'counter: opsserver — HTTP requests answered by the ops '
        'endpoint (any of /metrics, /varz, /healthz)',
    'recorder.ring_dropped':
        'gauge: EventRecorder.stats()["ring_dropped"] — events lost to '
        'in-memory ring overflow (nonzero = the flight recorder is a '
        'sliding window, see the recorder.overflow event)',
    'serving.queue_depth':
        'gauge: AdmissionController.depth() at scrape time — requests '
        'waiting for the coalescing executor',
    'serving.in_flight':
        'gauge: requests inside the current coalesced dispatch '
        '(frontend executor state, read under its lock)',
    'serving.coalesce_fill_ratio':
        'gauge: seeds/bucket_capacity of the most recent coalesced '
        'dispatch — how much of the chosen bucket real traffic filled '
        '(low = padding-dominated dispatches)',
    'serving.requests_total':
        'counter: requests resolved OK by the serving executor',
    'serving.seeds_total':
        'counter: seeds served across all resolved requests',
    'serving.dispatches_total':
        'counter: coalesced device dispatches the executor ran',
    'serving.failed_total':
        'counter: requests resolved with an executor error (typed '
        'resolve — never a silent drop)',
    'serving.admitted_total':
        'counter: requests past admission into the bounded queue',
    'serving.shed_total':
        'counter: typed load-sheds, labeled by reason '
        '(queue_full|deadline|too_large|draining|shutdown)',
    'serving.shed_rate':
        'gauge: shed/(admitted+shed) over process lifetime — the '
        'overload signal the fleet scrape alarms on',
    'serving.request_latency':
        'histogram: end-to-end request latency (arrival→resolve, '
        'seconds; log2 buckets), labeled by serving bucket capacity',
    'cache.hit_rate':
        'gauge: hits/(hits+misses) summed across cache scopes — the '
        'live twin of the bench cache_hit_rate',
    'cache.hbm_served_rate':
        'gauge: 1 - cold_misses/lookups from the dist feature counters '
        '— total fraction of feature lookups served from HBM (hot tier '
        '+ victim cache)',
    'exchange.padding_waste_pct':
        'gauge: 100*(1 - sent/slots) over the frontier exchange '
        'counters — the live padding-waste number the scale envelope '
        'tracks offline',
    'fused.compile.hits':
        'counter: _uncached_jit dispatches served by a warm in-memory '
        'executable',
    'fused.compile.misses':
        'counter: _uncached_jit dispatches that paid an XLA compile '
        '(nonzero after warmup = a shape escaped bucketing)',
    'gns.bias_steps_total':
        'counter: compiled GNS-biased sampler steps built (node + link '
        'modes)',
    'gns.sketch_updates_total':
        'counter: cached-set bitmask refreshes (cache-ring version '
        'bumps reaching the sampling bias)',
    'rpc.retries':
        'counter: transport faults absorbed by the RPC resilience layer'
        ' (one per rpc.retry event)',
    'rpc.replay_cache_entries':
        'gauge: live entries across the RPC server replay cache '
        '(exactly-once occupancy; near the eviction caps = retries at '
        'risk of ReplayEvictedError)',
    'producer.restarts_total':
        'counter: sampling-worker restarts by the producer supervisor',
    'timeseries.samples_total':
        'counter: cadence-sampler sweeps completed by the '
        'TimeSeriesStore (one per GLT_TS_CADENCE_MS tick; a stalled '
        'counter here means the history rings have stopped filling)',
    'timeseries.series':
        'gauge: ring-buffered series currently held by the '
        'TimeSeriesStore (gauges plus counters-as-rates)',
    'fleet.scrapes_total':
        'counter: FleetScraper sweeps over the replica target set (one '
        'per GLT_FLEET_SCRAPE_MS tick or explicit scrape)',
    'fleet.scrape_errors_total':
        'counter: replica scrapes that failed (unreachable endpoint, '
        'malformed exposition), labeled by replica',
    'fleet.replicas_up':
        'gauge: replicas whose most recent scrape succeeded and whose '
        "/healthz rollup reported ok — the federation's own liveness "
        'view of the fleet',
    'serving.queue_wait':
        'histogram: per-request admission enqueue → coalesce pickup '
        'wait (seconds; log2 buckets) — overload diagnosis without '
        'inferring waits from shed diagnostics',
    'serving.traces_retained_total':
        'counter: request traces kept by the tail-retention verdict '
        '(slow/failed/sampled — telemetry.tracing; the /traces ring is '
        'bounded, this counts total captures)',
}


class Metrics:
  """Thread-safe counter store: the backing store of live counters and
  histograms (the JAX package keeps it in ``utils.profiling``)."""

  def __init__(self):
    self._lock = threading.Lock()
    self._counts: Dict[str, float] = {}

  def inc(self, name: str, value: float = 1.0) -> None:
    with self._lock:
      self._counts[name] = self._counts.get(name, 0) + value

  def inc_many(self, pairs) -> None:
    """Several increments under ONE lock acquisition, so a concurrent
    `snapshot` sees all of them or none: what keeps a histogram's
    bucket + count + secs triple tear-free under a live scrape."""
    with self._lock:
      for name, value in pairs:
        self._counts[name] = self._counts.get(name, 0) + value

  def snapshot(self) -> Dict[str, float]:
    with self._lock:
      return dict(self._counts)


#: process-global counter store
metrics = Metrics()


#: declared-name shape: lowercase snake segments joined by dots (at
#: least two segments — a bare word collides with ad-hoc counter keys)
_NAME_RE = re.compile(r'^[a-z][a-z0-9_]*(\.[a-z0-9_]+)+$')

_KINDS = ('counter', 'gauge', 'histogram')


def flat_key(name: str, labels: Optional[Dict[str, object]] = None
             ) -> str:
  """The backing-store key of a (name, labels) metric instance:
  ``name`` or ``name{k=v,...}`` with sorted label keys — stable, so
  `gather_metrics` sums the same instance across hosts."""
  if not labels:
    return name
  inner = ','.join(f'{k}={labels[k]}' for k in sorted(labels))
  return f'{name}{{{inner}}}'


def prom_name(name: str) -> str:
  """Prometheus-legal metric family name (dots are not; the ``glt_``
  prefix namespaces the exporter)."""
  return 'glt_' + re.sub(r'[^a-zA-Z0-9_]', '_', name)


def _prom_labels(labels: Optional[Dict[str, object]],
                 extra: Optional[List[Tuple[str, str]]] = None) -> str:
  items: List[Tuple[str, str]] = []
  if labels:
    items.extend((k, str(labels[k])) for k in sorted(labels))
  if extra:
    items.extend(extra)
  if not items:
    return ''
  def esc(v: str) -> str:
    return v.replace('\\', r'\\').replace('"', r'\"').replace('\n', r'\n')
  return '{' + ','.join(f'{k}="{esc(v)}"' for k, v in items) + '}'


def _fmt(v: float) -> str:
  """Prometheus sample value: integers without a trailing .0 (half
  the consumers are humans reading curl output)."""
  f = float(v)
  return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Metric:
  __slots__ = ('registry', 'name', 'labels', 'key')

  def __init__(self, registry: 'LiveRegistry', name: str,
               labels: Optional[Dict[str, object]]):
    self.registry = registry
    self.name = name
    self.labels = dict(labels) if labels else None
    self.key = flat_key(name, labels)


class Counter(_Metric):
  """Monotone counter writing through to the backing `Metrics` store
  (so the offline aggregation/report stack sees it for free)."""

  def inc(self, value: float = 1.0) -> None:
    self.registry._backing().inc(self.key, value)

  def value(self) -> float:
    return float(self.registry._backing().snapshot().get(self.key, 0.0))


class Gauge(_Metric):
  """Point-in-time value: either ``set()`` explicitly or backed by a
  zero-argument callback evaluated at scrape time.  A callback that
  raises (or returns None) simply drops the sample from that scrape —
  a broken gauge must never break the scrape."""

  __slots__ = ('_value', '_fn')

  def __init__(self, registry, name, labels,
               fn: Optional[Callable[[], Optional[float]]] = None):
    super().__init__(registry, name, labels)
    self._value: Optional[float] = None
    self._fn = fn

  def set(self, value: float) -> None:
    self._value = float(value)

  def set_fn(self, fn: Callable[[], Optional[float]]) -> None:
    self._fn = fn

  def value(self) -> Optional[float]:
    if self._fn is not None:
      try:
        v = self._fn()
      except Exception:             # noqa: BLE001 — scrape must survive
        return None
      return None if v is None else float(v)
    return self._value


class LiveHistogram(_Metric):
  """Log2 latency histogram in the shared flat encoding
  (``span.<key>.hist.*`` in the backing store — the exact layout
  `gather_metrics` merges and ``report --metrics-json`` decodes)."""

  def observe(self, secs: float,
              exemplar: Optional[str] = None) -> None:
    """Record one sample; with ``exemplar`` (a trace_id), remember it
    as the landing bucket's last exemplar — ``/metrics`` renders it
    in OpenMetrics exemplar syntax, the sanctioned trace_id channel
    (a trace_id LABEL would mint unbounded series)."""
    _hist.record(self.key, secs, registry=self.registry._backing())
    if exemplar is not None:
      self.registry._note_exemplar(self.key, _hist.bucket_index(secs),
                                   exemplar, secs)


class LiveRegistry:
  """Thread-safe registry of declared live metrics + health providers.

  Args:
    store: backing `Metrics` counter store (None = the process-global
      :data:`metrics`).
    strict: validate registered names against `METRIC_NAMES` (the
      process-global registry is strict; tests may build permissive
      private ones).

  Registration is idempotent per ``(kind, name, labels)``: the same
  call returns the same handle (a `gauge` re-registration with ``fn``
  replaces the callback — "latest instance wins" is the contract for
  per-object gauges like queue depth across frontend restarts).
  """

  def __init__(self, store=None, strict: bool = True):
    self._lock = threading.Lock()
    self._store = store
    self.strict = strict
    self._instances: Dict[Tuple[str, str], _Metric] = {}
    self._health: Dict[str, Callable[[], dict]] = {}
    #: (hist flat key, bucket index) -> (trace_id, value secs, ts) —
    #: last exemplar per bucket (bounded by buckets × instances)
    self._exemplars: Dict[Tuple[str, int],
                          Tuple[str, float, float]] = {}

  # -- backing store -------------------------------------------------------
  def _backing(self) -> Metrics:
    if self._store is None:
      self._store = metrics
    return self._store

  # -- registration --------------------------------------------------------
  def _check(self, kind: str, name: str) -> None:
    if not _NAME_RE.match(name):
      raise ValueError(
          f'live metric name {name!r} is not snake.dot '
          '(lowercase segments joined by dots)')
    if self.strict:
      doc = METRIC_NAMES.get(name)
      if doc is None:
        raise ValueError(
            f'live metric {name!r} is not declared in '
            "telemetry/live.py::METRIC_NAMES — add it with a "
            "'<type>: <doc>' value")
      if not doc.startswith(f'{kind}:'):
        raise ValueError(
            f'live metric {name!r} is declared as '
            f'{doc.split(":", 1)[0]!r} but registered as {kind!r}')

  def _get(self, kind: str, name: str,
           labels: Optional[Dict[str, object]], factory) -> _Metric:
    self._check(kind, name)
    key = (kind, flat_key(name, labels))
    with self._lock:
      inst = self._instances.get(key)
      if inst is None:
        inst = self._instances[key] = factory()
      return inst

  def counter(self, name: str,
              labels: Optional[Dict[str, object]] = None) -> Counter:
    return self._get('counter', name, labels,
                     lambda: Counter(self, name, labels))

  def gauge(self, name: str,
            labels: Optional[Dict[str, object]] = None,
            fn: Optional[Callable[[], Optional[float]]] = None) -> Gauge:
    g = self._get('gauge', name, labels,
                  lambda: Gauge(self, name, labels, fn))
    if fn is not None:
      g.set_fn(fn)
    return g

  def histogram(self, name: str,
                labels: Optional[Dict[str, object]] = None
                ) -> LiveHistogram:
    return self._get('histogram', name, labels,
                     lambda: LiveHistogram(self, name, labels))

  def _note_exemplar(self, hist_key: str, bucket: int,
                     trace_id: str, value_secs: float) -> None:
    with self._lock:
      self._exemplars[(hist_key, bucket)] = (
          str(trace_id), float(value_secs), time.time())

  def exemplar_of(self, hist_key: str, bucket: int
                  ) -> Optional[Tuple[str, float, float]]:
    """The (trace_id, value_secs, ts) exemplar last recorded in one
    histogram bucket, if any — `report.py` uses it to jump from a
    p99 bucket to a captured trace."""
    with self._lock:
      return self._exemplars.get((hist_key, bucket))

  def unregister_gauge(self, name: str,
                       labels: Optional[Dict[str, object]] = None,
                       fn: Optional[Callable] = None) -> bool:
    """Drop a gauge instance so its callback stops pinning the object
    graph behind it (a shut-down frontend's admission queue, an SLO
    tracker's sample window).  With ``fn``, removes only if the
    instance still holds THAT callback — under "latest instance
    wins", a stale owner's unregister must not evict its
    replacement's gauge."""
    key = ('gauge', flat_key(name, labels))
    with self._lock:
      inst = self._instances.get(key)
      if inst is None:
        return False
      if fn is not None and inst._fn is not fn:   # type: ignore[attr-defined]
        return False
      del self._instances[key]
      return True

  # -- health providers ----------------------------------------------------
  def register_health(self, component: str,
                      fn: Callable[[], dict]) -> None:
    """Attach a health callback (dict-returning; an optional
    ``healthy`` key, default True, feeds the overall ``ok``).  Same
    name replaces — latest component instance wins."""
    with self._lock:
      self._health[component] = fn

  def unregister_health(self, component: str,
                        fn: Optional[Callable] = None) -> None:
    """Remove a health provider.  With ``fn``, removes only if the
    component still holds THAT callback — same "latest instance
    wins" guard as `unregister_gauge` (an old frontend's shutdown
    must not evict its replacement's provider)."""
    with self._lock:
      if fn is None or self._health.get(component) is fn:
        self._health.pop(component, None)

  def healthz(self) -> dict:
    """Liveness + per-component health: ``ok`` is the AND of every
    provider's ``healthy`` flag (a provider that raises reports
    unhealthy with the error, and cannot break the endpoint)."""
    with self._lock:
      providers = list(self._health.items())
    components: Dict[str, dict] = {}
    ok = True
    for name, fn in providers:
      try:
        block = dict(fn())
      except Exception as e:        # noqa: BLE001 — scrape must survive
        block = {'healthy': False, 'error': f'{type(e).__name__}: {e}'}
      healthy = bool(block.get('healthy', True))
      block['healthy'] = healthy
      ok = ok and healthy
      components[name] = block
    return {'ok': ok, 'pid': os.getpid(), 'ts': round(time.time(), 3),
            'components': components}

  def instruments(self) -> List[Tuple[str, _Metric]]:
    """``[(kind, metric), ...]`` snapshot of every registered
    instance — the declared sampling surface the time-series cadence
    loop walks (counters become rates, gauges are evaluated; see
    `telemetry.timeseries`)."""
    with self._lock:
      return [(kind, m) for (kind, _), m in self._instances.items()]

  # -- renderings ----------------------------------------------------------
  def _gauge_items(self) -> List[Tuple[Gauge, float]]:
    with self._lock:
      gauges = [m for (k, _), m in self._instances.items()
                if k == 'gauge']
    out = []
    for g in gauges:
      v = g.value()
      if v is not None:
        out.append((g, v))
    return out

  def snapshot(self) -> Dict[str, float]:
    """Flat ``{key: value}`` view: the full backing counter store
    (histograms stay in their flat encoding) plus every evaluated
    gauge — what ``/varz`` serves and the post-mortem bundle saves."""
    snap = dict(self._backing().snapshot())
    for g, v in self._gauge_items():
      snap[g.key] = v
    return snap

  def varz(self) -> dict:
    from .recorder import recorder
    snap = self.snapshot()
    return {'ts': round(time.time(), 3), 'pid': os.getpid(),
            'metrics': {k: snap[k] for k in sorted(snap)},
            'recorder': recorder.stats()}

  def prometheus_text(self) -> str:
    """Prometheus text exposition (format 0.0.4) of every DECLARED
    metric with at least one registered instance.  Counters/gauges
    render as single samples; histograms as cumulative ``le`` buckets
    in seconds plus ``_sum``/``_count`` (the standard layout, decoded
    from the shared flat encoding)."""
    snap = self._backing().snapshot()
    with self._lock:
      by_family: Dict[Tuple[str, str], List[_Metric]] = {}
      for (kind, _), m in self._instances.items():
        by_family.setdefault((m.name, kind), []).append(m)
      exemplars = dict(self._exemplars)
    lines: List[str] = []
    for (name, kind) in sorted(by_family):
      doc = METRIC_NAMES.get(name, '')
      doc = doc.split(':', 1)[1].strip() if ':' in doc else doc
      fam = prom_name(name)
      if doc:
        lines.append(f'# HELP {fam} '
                     + doc.replace('\\', r'\\').replace('\n', ' '))
      lines.append(f'# TYPE {fam} '
                   + ('untyped' if kind not in _KINDS else kind))
      for m in sorted(by_family[(name, kind)], key=lambda m: m.key):
        if kind == 'counter':
          lines.append(f'{fam}{_prom_labels(m.labels)} '
                       f'{_fmt(snap.get(m.key, 0.0))}')
        elif kind == 'gauge':
          v = m.value()               # type: ignore[attr-defined]
          if v is not None:
            lines.append(f'{fam}{_prom_labels(m.labels)} {_fmt(v)}')
        else:                         # histogram
          base = f'{_hist.KEY_PREFIX}{m.key}{_hist.HIST_SEP}'
          run = 0.0
          for i in range(_hist.NUM_BUCKETS):
            run += float(snap.get(f'{base}b{i:02d}', 0.0))
            le = _hist.bucket_upper_edge_secs(i)
            line = (f'{fam}_bucket'
                    f'{_prom_labels(m.labels, [("le", repr(le))])} '
                    f'{_fmt(run)}')
            ex = exemplars.get((m.key, i))
            if ex is not None:
              # OpenMetrics exemplar: the bucket's last trace_id —
              # absent entirely when tracing never attached one, so
              # GLT_TRACE_SAMPLE=0 output is byte-identical
              tid, val, ts = ex
              line += (f' # {{trace_id="{tid}"}} {_fmt(val)} '
                       f'{round(ts, 3)}')
            lines.append(line)
          lines.append(f'{fam}_bucket'
                       f'{_prom_labels(m.labels, [("le", "+Inf")])} '
                       f'{_fmt(snap.get(base + "count", 0.0))}')
          lines.append(f'{fam}_sum{_prom_labels(m.labels)} '
                       f'{_fmt(snap.get(base + "secs", 0.0))}')
          lines.append(f'{fam}_count{_prom_labels(m.labels)} '
                       f'{_fmt(snap.get(base + "count", 0.0))}')
    return '\n'.join(lines) + '\n'


#: sample-line shape of the text exposition (family + optional labels
#: + float), shared by the validating parser below
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})?\s+'
    r'([+-]?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf|NaN))$')

#: OpenMetrics exemplar chunk (the part after ``# ``): a label set,
#: a value, an optional timestamp
_EXEMPLAR_RE = re.compile(
    r'^\{[^{}]*\}\s+[+-]?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf|NaN)'
    r'(?:\s+[0-9]+(?:\.[0-9]+)?)?$')


def split_exemplar(line: str) -> Tuple[str, Optional[str]]:
  """``(sample_part, exemplar_or_None)`` for one exposition line.
  Only a WELL-FORMED OpenMetrics exemplar suffix
  (``... # {trace_id="…"} value [ts]``) is split off; anything else
  is returned untouched so the strict sample regex still rejects it
  loudly.  Shared by `parse_prometheus_text` and the federation
  strict parser — without this, every exemplar-emitting replica
  would be quarantined as malformed."""
  idx = line.find(' # {')
  if idx < 0:
    return line, None
  chunk = line[idx + 3:].strip()
  if _EXEMPLAR_RE.match(chunk):
    return line[:idx].rstrip(), chunk
  return line, None


def parse_prometheus_text(text: str) -> Dict[str, float]:
  """Strictly parse a Prometheus text exposition into
  ``{sample_name_with_labels: value}``; raises ``ValueError`` on the
  first malformed line.  The acceptance validator for the ops
  endpoint (and the bench's mid-run scrape check) — deliberately
  small, not a Prometheus client.  OpenMetrics exemplar suffixes on
  bucket samples are accepted (and dropped — exemplars are trace
  pointers, not sample values)."""
  out: Dict[str, float] = {}
  for n, raw in enumerate(text.splitlines(), 1):
    line = raw.strip()
    if not line:
      continue
    if line.startswith('#'):
      if not (line.startswith('# HELP ') or line.startswith('# TYPE ')):
        raise ValueError(f'line {n}: malformed comment {raw!r}')
      continue
    line, _ = split_exemplar(line)
    m = _SAMPLE_RE.match(line)
    if m is None:
      raise ValueError(f'line {n}: malformed sample {raw!r}')
    out[m.group(1) + (m.group(2) or '')] = float(m.group(3))
  return out


# -- default vocabulary wiring ----------------------------------------------
def _rate(snap: Dict[str, float], num_keys, den_keys
          ) -> Optional[float]:
  num = sum(v for k, v in snap.items()
            if any(k == b or k.startswith(b + '{') for b in num_keys))
  den = sum(v for k, v in snap.items()
            if any(k == b or k.startswith(b + '{') for b in den_keys))
  return round(num / den, 6) if den else None


def _wire_defaults(reg: LiveRegistry) -> None:
  """Declare the standard vocabulary: counters whose tick sites
  already exist across the data plane (declaring exposes them on the
  scrape — the tick sites don't move), and the derived gauges the
  acceptance scrape promises (hit rates, padding waste, shed rate).
  One literal call per name, as in the JAX package."""
  reg.counter('dist.feature.lookups')
  reg.counter('dist.feature.cold_lookups')
  reg.counter('dist.feature.cold_misses')
  reg.counter('dist.feature.cache_hits')
  reg.counter('fused.compile.hits')
  reg.counter('fused.compile.misses')
  reg.counter('rpc.retries')
  reg.counter('producer.restarts_total')
  reg.counter('gns.bias_steps_total')
  reg.counter('gns.sketch_updates_total')
  reg.counter('snapshot.saves_total')
  reg.counter('snapshot.save_failures_total')
  reg.counter('postmortem.dumps_total')
  # cache.*_total register LABELED at their tick site
  # (data/cold_cache.py::emit_cache_events, per scope) — an
  # unlabeled twin here would render a permanently-zero sample
  # beside the real per-scope ones

  def _ring_dropped() -> float:
    from .recorder import recorder
    return float(recorder.stats()['ring_dropped'])

  def _cache_hit_rate() -> Optional[float]:
    snap = reg._backing().snapshot()
    return _rate(snap, ('cache.hits_total',),
                 ('cache.hits_total', 'cache.misses_total'))

  def _hbm_served_rate() -> Optional[float]:
    snap = reg._backing().snapshot()
    lookups = snap.get('dist.feature.lookups', 0.0)
    if not lookups:
      return None
    return round(
        1.0 - snap.get('dist.feature.cold_misses', 0.0) / lookups, 6)

  def _padding_waste() -> Optional[float]:
    snap = reg._backing().snapshot()
    slots = snap.get('dist.frontier.slots', 0.0)
    if not slots:
      return None
    sent = (snap.get('dist.frontier.offered', 0.0)
            - snap.get('dist.frontier.dropped', 0.0))
    return round(100.0 * (1.0 - sent / slots), 4)

  def _shed_rate() -> Optional[float]:
    snap = reg._backing().snapshot()
    return _rate(snap, ('serving.shed_total',),
                 ('serving.shed_total', 'serving.admitted_total'))

  reg.gauge('recorder.ring_dropped', fn=_ring_dropped)
  reg.gauge('cache.hit_rate', fn=_cache_hit_rate)
  reg.gauge('cache.hbm_served_rate', fn=_hbm_served_rate)
  reg.gauge('exchange.padding_waste_pct', fn=_padding_waste)
  reg.gauge('serving.shed_rate', fn=_shed_rate)


#: process-global live registry every subsystem registers with (the
#: one the ops endpoint serves); strict — names must be declared.
live = LiveRegistry(strict=True)
_wire_defaults(live)
