"""Fleet metrics federation — the scrape surface the SLO autoscaler
closes its loop on.

The port's copy of the JAX package's `telemetry/federation.py`.

One process's `OpsServer` answers for one replica.  `FleetScraper`
polls EVERY replica's exposition — remote ops endpoints over HTTP and
in-process `LocalReplica`s / private registries directly — and merges
the families into one federated view:

  * every replica's samples re-render under their original family
    names with a ``replica="<name>"`` label injected;
  * fleet-level aggregates ride beside them as ``glt_fleet_*``
    families: counters SUM across replicas, gauges take the fleet
    MAX (the alarming convention: the worst replica is the signal),
    and the log2 latency histograms QUANTILE-MERGE — bucket vectors
    sum across replicas and the merged p50/p99 export as gauges;
  * ``/healthz`` rolls up per replica: the fleet is ok iff every
    scrapeable replica is ok, and unreachable replicas are reported
    (not silently dropped — a dead replica IS the signal).

The merged exposition is what the `OpsServer` ``/fleet`` route serves
(``?format=json`` for the health rollup), and it stays strictly
parseable by `live.parse_prometheus_text` — the acceptance check the
fleet bench runs mid-traffic.

Each replica's exposition is rendered from ONE snapshot on the
replica side, so per-replica histogram bucket/count pairs are
tear-free in the merged view; the merge itself only ever reads the
scraped text (no live locks held across replicas).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from .live import parse_prometheus_text, split_exemplar

FLEET_SCRAPE_ENV = 'GLT_FLEET_SCRAPE_MS'
DEFAULT_SCRAPE_MS = 1000.0

FLEET_PREFIX = 'glt_fleet_'

_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_TYPE_RE = re.compile(r'^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) (\w+)$')
_HELP_RE = re.compile(r'^# HELP ([a-zA-Z_:][a-zA-Z0-9_:]*) (.*)$')


def scrape_ms_from_env(default: float = DEFAULT_SCRAPE_MS) -> float:
  try:
    return max(float(os.environ.get(FLEET_SCRAPE_ENV, default)), 10.0)
  except ValueError:
    return default


def _fmt(v: float) -> str:
  f = float(v)
  return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _render_labels(items: List[Tuple[str, str]]) -> str:
  if not items:
    return ''
  def esc(v: str) -> str:
    return v.replace('\\', r'\\').replace('"', r'\"').replace('\n', r'\n')
  return '{' + ','.join(f'{k}="{esc(v)}"' for k, v in items) + '}'


def parse_exposition(text: str) -> Dict[str, dict]:
  """Structured view of one strict text exposition:
  ``{family: {'type': t, 'help': h,
  'samples': [(sample_name, [(k, v), ...], value)]}}`` where
  ``sample_name`` keeps histogram suffixes (``_bucket``/``_sum``/
  ``_count``) and samples attach to the TYPE'd family they suffix.
  Validates with `parse_prometheus_text` first — malformed input
  raises before any partial structure escapes."""
  parse_prometheus_text(text)        # strict validation pass
  fams: Dict[str, dict] = {}
  order: List[str] = []

  def fam_for(sample_name: str) -> str:
    for suffix in ('_bucket', '_sum', '_count'):
      base = sample_name[:-len(suffix)] if sample_name.endswith(suffix) \
          else None
      if base and base in fams and fams[base]['type'] == 'histogram':
        return base
    return sample_name

  for raw in text.splitlines():
    line = raw.strip()
    if not line:
      continue
    th = _TYPE_RE.match(line)
    if th:
      fam = fams.setdefault(th.group(1),
                            {'type': 'untyped', 'help': '',
                             'samples': []})
      fam['type'] = th.group(2)
      if th.group(1) not in order:
        order.append(th.group(1))
      continue
    hh = _HELP_RE.match(line)
    if hh:
      fam = fams.setdefault(hh.group(1),
                            {'type': 'untyped', 'help': '',
                             'samples': []})
      fam['help'] = hh.group(2)
      if hh.group(1) not in order:
        order.append(hh.group(1))
      continue
    if line.startswith('#'):
      continue
    # an OpenMetrics exemplar suffix owns the line's LAST '}' — strip
    # it before the rpartition below, or the label body swallows it
    line, _ = split_exemplar(line)
    name, _, rest = line.partition('{') if '{' in line.split(' ', 1)[0] \
        else (line.split(' ', 1)[0], '', '')
    if rest:
      body, _, tail = rest.rpartition('}')
      labels = [(k, v) for k, v in _LABEL_RE.findall(body)]
      value = float(tail.strip())
    else:
      name, _, tail = line.partition(' ')
      labels = []
      value = float(tail.strip())
    base = fam_for(name)
    fam = fams.setdefault(base, {'type': 'untyped', 'help': '',
                                 'samples': []})
    if base not in order:
      order.append(base)
    fam['samples'].append((name, labels, value))
  return {k: fams[k] for k in order}


# -- replica targets ---------------------------------------------------------
class ReplicaTarget:
  """One scrapeable replica: ``scrape()`` returns
  ``(exposition_text, healthz_dict)`` or raises."""

  def __init__(self, name: str):
    self.name = name

  def scrape(self) -> Tuple[str, dict]:
    raise NotImplementedError


class RegistryTarget(ReplicaTarget):
  """In-process replica backed by a `LiveRegistry` (tests, and the
  scraping process's own registry federating as a member)."""

  def __init__(self, name: str, registry):
    super().__init__(name)
    self.registry = registry

  def scrape(self) -> Tuple[str, dict]:
    return self.registry.prometheus_text(), self.registry.healthz()


class HttpTarget(ReplicaTarget):
  """Remote replica scraped over its ops endpoint
  (``<url>/metrics`` + ``<url>/healthz``)."""

  def __init__(self, name: str, url: str, timeout_s: float = 2.0):
    super().__init__(name)
    self.url = url.rstrip('/')
    self.timeout_s = timeout_s

  def _get(self, route: str) -> Tuple[int, bytes]:
    req = urllib.request.Request(self.url + route)
    try:
      with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
        return resp.status, resp.read()
    except urllib.error.HTTPError as e:      # 503 healthz still has a body
      return e.code, e.read()

  def scrape(self) -> Tuple[str, dict]:
    status, body = self._get('/metrics')
    if status != 200:
      raise OSError(f'/metrics answered HTTP {status}')
    _, hbody = self._get('/healthz')
    try:
      health = json.loads(hbody.decode('utf-8'))
    except ValueError:
      health = {'ok': False, 'error': 'malformed /healthz body'}
    return body.decode('utf-8'), health


class LocalReplicaTarget(ReplicaTarget):
  """In-process `serving.router.LocalReplica`: its heartbeat's
  numeric leaves render as per-replica gauges (``glt_serving_*``
  families — the shared vocabulary, so they merge with remote
  replicas' real expositions)."""

  def __init__(self, name: str, replica):
    super().__init__(name)
    self.replica = replica

  def scrape(self) -> Tuple[str, dict]:
    hb = self.replica.heartbeat()    # raises when the replica is dead
    flat: Dict[str, float] = {}

    def walk(prefix: str, obj) -> None:
      if isinstance(obj, bool):
        return
      if isinstance(obj, (int, float)):
        flat[prefix] = float(obj)
      elif isinstance(obj, dict):
        for k in sorted(obj):
          walk(f'{prefix}_{k}' if prefix else str(k), obj[k])

    walk('', hb)
    lines = []
    for key in sorted(flat):
      fam = 'glt_' + re.sub(r'[^a-zA-Z0-9_]', '_', key)
      lines.append(f'# TYPE {fam} gauge')
      lines.append(f'{fam} {_fmt(flat[key])}')
    return ('\n'.join(lines) + '\n',
            {'ok': True, 'components': {'serving': {'healthy': True}}})


# -- histogram quantile merge ------------------------------------------------
def _merged_quantiles(bucket_groups: Dict[Tuple, Dict[float, float]]
                      ) -> List[Tuple[Tuple, float, float]]:
  """``[(labels_key, p50_secs, p99_secs)]`` from per-label-group
  cumulative ``le`` bucket vectors (already summed across replicas)."""
  out = []
  for labels_key, by_le in sorted(bucket_groups.items()):
    edges = sorted(le for le in by_le if le != float('inf'))
    total = max(by_le.values()) if by_le else 0.0
    if total <= 0:
      continue

    def q(p: float) -> float:
      rank = p * total
      for le in edges:
        if by_le[le] >= rank:
          return le
      return edges[-1] if edges else 0.0

    out.append((labels_key, q(0.5), q(0.99)))
  return out


class FleetScraper:
  """Polls a set of replica targets and serves the merged view.

  Args:
    targets: initial `ReplicaTarget`s (`add_registry` / `add_url` /
      `add_local_replica` append more).
    scrape_ms: poll cadence (None = ``GLT_FLEET_SCRAPE_MS``).
    registry: live registry for the scraper's own meta-metrics
      (None = the process-global one).
    clock: wall-clock for staleness stamps (tests inject).
  """

  def __init__(self, targets=(), scrape_ms: Optional[float] = None,
               registry=None, clock=time.time):
    if registry is None:
      from .live import live as registry
    self.registry = registry
    self.scrape_ms = (scrape_ms_from_env() if scrape_ms is None
                      else max(float(scrape_ms), 10.0))
    self._clock = clock
    self._lock = threading.Lock()
    self._targets: List[ReplicaTarget] = list(targets)
    #: name -> {'ok', 'text', 'health', 'error', 'ts'}
    self._last: Dict[str, dict] = {}
    self._thread: Optional[threading.Thread] = None
    self._stop = threading.Event()
    self._m_scrapes = registry.counter('fleet.scrapes_total')
    self._err_counters: Dict[str, object] = {}
    self._up_fn = self._replicas_up
    registry.gauge('fleet.replicas_up', fn=self._up_fn)

  # -- target management ---------------------------------------------------
  def add_target(self, target: ReplicaTarget) -> ReplicaTarget:
    with self._lock:
      self._targets.append(target)
    self._err_counters[target.name] = self.registry.counter(
        'fleet.scrape_errors_total', labels={'replica': target.name})
    return target

  def add_registry(self, name: str, registry) -> ReplicaTarget:
    return self.add_target(RegistryTarget(name, registry))

  def add_url(self, name: str, url: str,
              timeout_s: float = 2.0) -> ReplicaTarget:
    return self.add_target(HttpTarget(name, url, timeout_s))

  def add_local_replica(self, name: str, replica) -> ReplicaTarget:
    return self.add_target(LocalReplicaTarget(name, replica))

  # -- scraping ------------------------------------------------------------
  def _replicas_up(self) -> float:
    with self._lock:
      return float(sum(
          1 for st in self._last.values()
          if st['ok'] and st['health'].get('ok', False)))

  def scrape(self) -> Dict[str, dict]:
    """One sweep over every target; always completes (a failing
    replica records an error entry, never aborts the sweep)."""
    with self._lock:
      targets = list(self._targets)
    results: Dict[str, dict] = {}
    for t in targets:
      entry = {'ok': False, 'text': '', 'health': {},
               'error': None, 'ts': round(self._clock(), 3)}
      try:
        text, health = t.scrape()
        parse_prometheus_text(text)  # refuse malformed replicas loudly
        entry.update(ok=True, text=text, health=health)
      except Exception as e:          # noqa: BLE001 — a down replica
        entry['error'] = f'{type(e).__name__}: {e}'
        ctr = self._err_counters.get(t.name)
        if ctr is not None:
          ctr.inc()
      results[t.name] = entry
    with self._lock:
      self._last = results
    self._m_scrapes.inc()
    return results

  def _latest(self) -> Dict[str, dict]:
    with self._lock:
      last = dict(self._last)
    return last if last else self.scrape()

  # -- merged renderings ---------------------------------------------------
  def prometheus_text(self) -> str:
    """The federated exposition: per-replica samples under a
    ``replica=`` label plus ``glt_fleet_*`` aggregates."""
    last = self._latest()
    fam_meta: Dict[str, dict] = {}
    fam_order: List[str] = []
    #: family -> [(sample_name, labels, value, replica)]
    samples: Dict[str, List[Tuple[str, List, float, str]]] = {}
    for rname in sorted(last):
      st = last[rname]
      if not st['ok']:
        continue
      for fam, block in parse_exposition(st['text']).items():
        if fam not in fam_meta:
          fam_meta[fam] = {'type': block['type'], 'help': block['help']}
          fam_order.append(fam)
        for sname, labels, value in block['samples']:
          samples.setdefault(fam, []).append(
              (sname, labels, value, rname))

    lines: List[str] = []
    for fam in fam_order:
      meta = fam_meta[fam]
      if meta['help']:
        lines.append(f'# HELP {fam} {meta["help"]}')
      lines.append(f'# TYPE {fam} {meta["type"]}')
      for sname, labels, value, rname in samples.get(fam, ()):
        labeled = [(k, v) for k, v in labels] + [('replica', rname)]
        lines.append(f'{sname}{_render_labels(labeled)} {_fmt(value)}')
      lines.extend(self._aggregate_family(fam, meta,
                                          samples.get(fam, ())))
    return '\n'.join(lines) + '\n'

  def _aggregate_family(self, fam: str, meta: dict,
                        fam_samples) -> List[str]:
    agg_fam = FLEET_PREFIX + (fam[4:] if fam.startswith('glt_')
                              else fam)
    kind = meta['type']
    #: (sample_name, labels_key) -> merged value
    merged: Dict[Tuple[str, Tuple], float] = {}
    label_sets: Dict[Tuple[str, Tuple], List] = {}
    #: histogram quantile-merge state: labels_key -> {le: cum_count}
    buckets: Dict[Tuple, Dict[float, float]] = {}
    n_replicas = len({r for _, _, _, r in fam_samples})
    if not n_replicas:
      return []
    for sname, labels, value, _ in fam_samples:
      base_labels = [(k, v) for k, v in labels if k != 'replica']
      le = None
      if kind == 'histogram' and sname.endswith('_bucket'):
        le_items = [v for k, v in base_labels if k == 'le']
        base_labels = [(k, v) for k, v in base_labels if k != 'le']
        le = float(le_items[0]) if le_items else None
      lkey = tuple(base_labels)
      if le is not None:
        buckets.setdefault(lkey, {})
        buckets[lkey][le] = buckets[lkey].get(le, 0.0) + value
        skey = (sname, lkey + (('le', le_items[0]),))
        label_sets[skey] = base_labels + [('le', le_items[0])]
        merged[skey] = merged.get(skey, 0.0) + value
        continue
      skey = (sname, lkey)
      label_sets[skey] = base_labels
      if kind == 'gauge':
        merged[skey] = max(merged.get(skey, float('-inf')), value)
      else:                           # counter/untyped/_sum/_count: sum
        merged[skey] = merged.get(skey, 0.0) + value
    lines = [f'# HELP {agg_fam} fleet aggregate of {fam} over '
             f'{n_replicas} replicas '
             f'({"max" if kind == "gauge" else "sum"}'
             f'{"; quantile-merged" if kind == "histogram" else ""})',
             f'# TYPE {agg_fam} {kind}']
    for (sname, _), value in sorted(merged.items(),
                                    key=lambda kv: (kv[0][0],
                                                    str(kv[0][1]))):
      out_name = agg_fam + sname[len(fam):]
      labels = label_sets[(sname, _)]
      lines.append(f'{out_name}{_render_labels(labels)} {_fmt(value)}')
    if kind == 'histogram':
      for lkey, p50, p99 in _merged_quantiles(buckets):
        labels = list(lkey)
        lines.append(f'# TYPE {agg_fam}_p50_secs gauge')
        lines.append(f'{agg_fam}_p50_secs{_render_labels(labels)} '
                     f'{_fmt(p50)}')
        lines.append(f'# TYPE {agg_fam}_p99_secs gauge')
        lines.append(f'{agg_fam}_p99_secs{_render_labels(labels)} '
                     f'{_fmt(p99)}')
    return lines

  # -- fleet trace assembly -------------------------------------------------
  def fetch_trace(self, trace_id: str) -> List[dict]:
    """One request's spans from EVERY replica — the process-global
    tracer (in-process replicas all record there) plus each remote
    replica's ``/trace`` route — deduped by span_id and time-ordered.
    Unreachable replicas contribute nothing (the assembled tree is
    still served; a missing subtree IS the diagnostic)."""
    from .tracing import tracer
    spans: Dict[str, dict] = {
        s['span_id']: s for s in tracer.spans_of(trace_id)}
    with self._lock:
      targets = list(self._targets)
    for t in targets:
      if not isinstance(t, HttpTarget):
        continue                      # in-process: global tracer above
      try:
        status, body = t._get(f'/trace?trace_id={trace_id}')
        if status != 200:
          continue
        payload = json.loads(body.decode('utf-8'))
        for s in payload.get('spans', ()):
          if s.get('span_id'):
            spans.setdefault(s['span_id'], s)
      except Exception:               # noqa: BLE001 — a down replica
        continue
    return sorted(spans.values(),
                  key=lambda s: float(s.get('ts', 0.0)))

  def trace_chrome(self, trace_id: str) -> dict:
    """The assembled trace as a Chrome trace-event object (Perfetto-
    loadable; cross-process parent→child edges become flow arrows)."""
    from . import export
    from .tracing import spans_to_events
    return export.to_chrome_trace(
        spans_to_events(self.fetch_trace(trace_id)))

  def fleet_json(self) -> dict:
    """Healthz rollup: fleet ``ok`` is the AND over scrapeable
    replicas AND every replica being scrapeable."""
    last = self._latest()
    replicas = {}
    ok = bool(last)
    for name in sorted(last):
      st = last[name]
      r_ok = st['ok'] and bool(st['health'].get('ok', False))
      ok = ok and r_ok
      replicas[name] = {'ok': r_ok, 'error': st['error'],
                        'ts': st['ts'],
                        'health': st['health'] or None}
    return {'schema': 'glt.fleet.v1', 'ok': ok,
            'replicas_up': sum(1 for r in replicas.values() if r['ok']),
            'replicas': replicas,
            'scrape_ms': self.scrape_ms}

  # -- lifecycle -----------------------------------------------------------
  def start(self) -> 'FleetScraper':
    if self._thread is None:
      self._stop.clear()
      self._thread = threading.Thread(target=self._loop, daemon=True,
                                      name='glt-fleet-scraper')
      self._thread.start()
    return self

  def _loop(self) -> None:
    period = self.scrape_ms / 1000.0
    while not self._stop.wait(period):
      try:
        self.scrape()
      except Exception:               # noqa: BLE001 — keep polling
        pass

  def close(self) -> None:
    self._stop.set()
    t = self._thread
    if t is not None:
      t.join(2.0)
    self._thread = None
    self.registry.unregister_gauge('fleet.replicas_up', fn=self._up_fn)
