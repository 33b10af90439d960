"""Per-stage latency report CLI over flight-recorder traces.

``python -m graphlearn_tpu_torch.telemetry.report TRACE.jsonl`` prints a
per-stage (span-kind) latency table — count, total, mean, p50/p90/p99
from the log2 histograms, max — answering "where did the step time
go" without leaving the terminal:

    stage              count   total_s    mean_ms      p50      p90 ...
    batch                 16     0.842     52.6ms   64.0ms  128.0ms
    sample.exchange       16     0.512     32.0ms   32.0ms   65.5ms

Modes:
  * ``--diff OTHER.jsonl``: second trace as baseline; the table gains
    a ``Δmean%`` column per stage (positive = this trace is slower) —
    the two-trace regression hunt.  When BOTH files are ``/varz``
    JSON snapshots (``{'ts', 'metrics': {...}}``) the diff is a
    counter/gauge delta table instead — changed keys with Δ and
    per-second rate over the snapshots' wall-clock gap.
  * ``--attribution FILE``: render per-partition traffic attribution
    (`DistNeighborSampler.attribution_stats` JSON, a bench envelope
    row carrying an ``attribution`` block, or a records JSONL holding
    one): the P×P src-device → dst-range byte matrix, the locality
    summary, padding-waste-by-layout when the envelope's ``layouts``
    comparison rides along, and the top-K hot-range table.
  * ``--chrome OUT.json``: also write the Perfetto-loadable Chrome
    trace (`telemetry.export`).
  * ``--metrics-json FILE``: instead of a JSONL trace, read a
    `gather_metrics` aggregate dump (``{'aggregate': {...}}`` or the
    flat dict itself) and print the MERGED cross-host histograms —
    the ≥2-process mesh view.
  * ``--postmortem BUNDLE``: render a post-mortem bundle
    (`telemetry.postmortem`, ``GLT_POSTMORTEM_DIR``): spans still in
    flight at dump time, final-window event deltas, the resilience
    and serving tables over the captured ring, supervision state and
    the SLO gauges — the after-the-incident view of a process that
    can no longer be scraped.

Quantiles from ``--metrics-json`` are log2-bucket upper edges (a 2x
envelope); from a JSONL trace the same bucketing is applied to the raw
durations so the two views stay comparable.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Dict, List, Optional

from .export import load_events, span_durations, write_chrome_trace
from .histogram import Histogram, from_snapshot


def histograms_from_events(events: List[Dict]) -> Dict[str, Histogram]:
  """Per-kind histograms rebuilt from already-loaded trace events'
  span.end durations."""
  out: Dict[str, Histogram] = {}
  for kind, durs in span_durations(events).items():
    h = out.setdefault(kind, Histogram(kind))
    for d in durs:
      h.add(d)
  return out


def histograms_from_trace(path: str) -> Dict[str, Histogram]:
  """Per-kind histograms rebuilt from a JSONL trace's span.end
  durations."""
  return histograms_from_events(load_events(path))


def _fmt_secs(s: float) -> str:
  if s >= 1.0:
    return f'{s:.3f}s'
  if s >= 1e-3:
    return f'{s * 1e3:.1f}ms'
  return f'{s * 1e6:.0f}us'


def format_table(hists: Dict[str, Histogram],
                 baseline: Optional[Dict[str, Histogram]] = None
                 ) -> str:
  """Render the per-stage latency table (largest total time first).
  With ``baseline``, adds the Δmean% column (positive = slower)."""
  header = ['stage', 'count', 'total_s', 'mean', 'p50', 'p90', 'p99']
  if baseline is not None:
    header.append('Δmean%')
  rows: List[List[str]] = []
  for kind in sorted(hists, key=lambda k: -hists[k].secs):
    h = hists[kind]
    row = [kind, f'{int(h.count)}', f'{h.secs:.3f}',
           _fmt_secs(h.mean), _fmt_secs(h.quantile(0.5)),
           _fmt_secs(h.quantile(0.9)), _fmt_secs(h.quantile(0.99))]
    if baseline is not None:
      b = baseline.get(kind)
      if b is not None and b.count and b.mean > 0:
        row.append(f'{100.0 * (h.mean / b.mean - 1.0):+.1f}')
      else:
        row.append('new')
    rows.append(row)
  if baseline is not None:
    for kind in sorted(set(baseline) - set(hists)):
      rows.append([kind, '0', '0.000', '-', '-', '-', '-', 'gone'])
  widths = [max(len(header[i]), *(len(r[i]) for r in rows))
            if rows else len(header[i]) for i in range(len(header))]
  lines = ['  '.join(h.ljust(w) if i == 0 else h.rjust(w)
                     for i, (h, w) in enumerate(zip(header, widths)))]
  for r in rows:
    lines.append('  '.join(c.ljust(w) if i == 0 else c.rjust(w)
                           for i, (c, w) in enumerate(zip(r, widths))))
  return '\n'.join(lines)


#: resilience/durability event kinds the report CLI counts next to the
#: latency table (until now these were only visible
#: by grepping the raw JSONL).  kind -> the field used for the
#: per-bucket breakdown column ('' = none).
RESILIENCE_KINDS = (
    ('rpc.retry', 'op'),
    ('peer.lost', 'peer_kind'),
    ('fault.injected', 'site'),
    ('producer.restart', 'worker'),
    ('snapshot.save', 'ok'),
    ('snapshot.restore', 'dir'),
    ('mesh.stall', 'scope'),
    ('slo.burn', 'window_secs'),
    ('recorder.overflow', ''),
    ('postmortem.dump', 'reason'),
    # streaming ingestion: WAL replays, torn-tail
    # truncations, apply/compact faults and compactions read out of
    # the same table as the retries and restarts around them
    ('ingest.replay', 'restored'),
    ('ingest.wal_truncate', ''),
    ('ingest.fault', 'site'),
    ('ingest.compact', 'ok'),
)


def resilience_counts(events) -> List[List[str]]:
  """``[kind, count, breakdown]`` rows for every resilience kind
  present in the trace (absent kinds are omitted — a clean run prints
  no table at all)."""
  rows: List[List[str]] = []
  for kind, field in RESILIENCE_KINDS:
    evs = [e for e in events if e.get('kind') == kind]
    if not evs:
      continue
    breakdown = ''
    if field:
      by: Dict[str, int] = {}
      for e in evs:
        key = str(e.get(field))
        by[key] = by.get(key, 0) + 1
      breakdown = ', '.join(f'{k}={v}' for k, v in sorted(by.items()))
    rows.append([kind, str(len(evs)), breakdown])
  return rows


def format_resilience_table(events) -> str:
  """Render the resilience-event count table ('' when the trace holds
  none)."""
  rows = resilience_counts(events)
  if not rows:
    return ''
  header = ['event', 'count', 'breakdown']
  widths = [max(len(header[i]), *(len(r[i]) for r in rows))
            for i in range(3)]
  lines = ['  '.join(h.ljust(w) for h, w in zip(header, widths))]
  for r in rows:
    lines.append('  '.join(c.ljust(w) for c, w in zip(r, widths)))
  return '\n'.join(lines)


def nearest_rank(sorted_vals, p: float):
  """Nearest-rank quantile over PRE-SORTED values (``None`` on
  empty).  ONE definition shared by this report CLI and
  `benchmarks/bench_serving.py`, so the bench's regression-guarded
  p99 and the trace report's p99 can never silently diverge."""
  if not sorted_vals:
    return None
  i = min(int(p * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
  return sorted_vals[i]


def serving_percentiles(events) -> Dict[str, Dict]:
  """Per-bucket serving latency percentiles from ``serving.request``
  events (EXACT quantiles over the raw ``latency_ms`` values — the
  serving SLO numbers deserve better than the 2x log2 envelope), plus
  an ``all`` row and the shed counts by reason.  ``{}`` when the
  trace holds no serving traffic."""
  lat: Dict[str, List[float]] = {}
  for e in events:
    if e.get('kind') != 'serving.request' or not e.get('ok', True):
      continue
    v = e.get('latency_ms')
    if v is None:
      continue
    lat.setdefault(str(e.get('bucket', '?')), []).append(float(v))
    lat.setdefault('all', []).append(float(v))
  if not lat:
    return {}
  out: Dict[str, Dict] = {}
  for bucket, vals in lat.items():
    vals = sorted(vals)
    out[bucket] = {'count': len(vals),
                   'p50_ms': nearest_rank(vals, 0.5),
                   'p95_ms': nearest_rank(vals, 0.95),
                   'p99_ms': nearest_rank(vals, 0.99),
                   'max_ms': vals[-1]}
  shed: Dict[str, int] = {}
  for e in events:
    if e.get('kind') == 'serving.shed':
      r = str(e.get('reason'))
      shed[r] = shed.get(r, 0) + 1
  if shed:
    out['shed'] = shed
  return out


def format_serving_table(events) -> str:
  """Render the serving percentile table ('' when the trace holds no
  serving.request events)."""
  pct = serving_percentiles(events)
  if not pct:
    return ''
  shed = pct.pop('shed', {})
  header = ['bucket', 'count', 'p50_ms', 'p95_ms', 'p99_ms', 'max_ms']
  rows = []
  # 'all' first, then buckets in NUMERIC ladder order (keys are
  # stringified capacities — a lexicographic sort puts 16 before 2)
  for bucket in sorted(pct, key=lambda b: (b != 'all',
                                           int(b) if b.isdigit() else 0,
                                           b)):
    r = pct[bucket]
    rows.append([bucket, str(r['count']),
                 f"{r['p50_ms']:.2f}", f"{r['p95_ms']:.2f}",
                 f"{r['p99_ms']:.2f}", f"{r['max_ms']:.2f}"])
  widths = [max(len(header[i]), *(len(r[i]) for r in rows))
            for i in range(len(header))]
  lines = ['  '.join(h.ljust(w) if i == 0 else h.rjust(w)
                     for i, (h, w) in enumerate(zip(header, widths)))]
  for r in rows:
    lines.append('  '.join(c.ljust(w) if i == 0 else c.rjust(w)
                           for i, (c, w) in enumerate(zip(r, widths))))
  if shed:
    lines.append('shed: ' + ', '.join(f'{k}={v}'
                                      for k, v in sorted(shed.items())))
  return '\n'.join(lines)


def spans_in_flight(events: List[Dict],
                    at_mono: Optional[float] = None) -> List[Dict]:
  """Spans whose ``span.begin`` has no matching ``span.end`` in the
  event window — at a post-mortem dump, the operations still in
  flight when the process died (the first thing an operator asks).
  Returns ``[{name, span_id, pid, age_s}]`` oldest-first; ``age_s``
  needs ``at_mono`` (the bundle's dump-time monotonic clock)."""
  open_spans: Dict[tuple, Dict] = {}
  for e in events:
    sid = (e.get('pid'), e.get('span_id'))
    if e.get('kind') == 'span.begin':
      open_spans[sid] = e
    elif e.get('kind') == 'span.end':
      open_spans.pop(sid, None)
  out = []
  for (pid, sid), e in open_spans.items():
    row = {'name': e.get('name'), 'span_id': sid, 'pid': pid}
    if at_mono is not None and e.get('mono') is not None:
      row['age_s'] = round(at_mono - float(e['mono']), 3)
    out.append(row)
  out.sort(key=lambda r: -(r.get('age_s') or 0))
  return out


def final_window_counts(events: List[Dict], at_mono: float,
                        window_s: float = 60.0) -> List[List[str]]:
  """``[kind, last_window, total]`` rows — what ACCELERATED into the
  crash vs the whole ring (a kind whose count concentrates in the
  final window is the trajectory of the incident)."""
  total: Dict[str, int] = {}
  recent: Dict[str, int] = {}
  horizon = at_mono - window_s
  for e in events:
    k = str(e.get('kind'))
    total[k] = total.get(k, 0) + 1
    if float(e.get('mono') or 0.0) >= horizon:
      recent[k] = recent.get(k, 0) + 1
  return [[k, str(recent.get(k, 0)), str(total[k])]
          for k in sorted(total, key=lambda k: -recent.get(k, 0))]


def _kv_table(rows: List[List[str]], header: List[str]) -> str:
  if not rows:
    return ''
  widths = [max(len(header[i]), *(len(r[i]) for r in rows))
            for i in range(len(header))]
  lines = ['  '.join(h.ljust(w) if i == 0 else h.rjust(w)
                     for i, (h, w) in enumerate(zip(header, widths)))]
  for r in rows:
    lines.append('  '.join(c.ljust(w) if i == 0 else c.rjust(w)
                           for i, (c, w) in enumerate(zip(r, widths))))
  return '\n'.join(lines)


def format_serving_health(block: Dict) -> str:
  """Render a heartbeat/healthz serving block (queue, executor,
  per-bucket compile status, SLO windows) as indented lines."""
  lines = []
  for key in ('healthy', 'executor_alive', 'queue_depth', 'max_queue',
              'in_flight', 'admitted', 'served_requests',
              'dispatches', 'failed', 'max_wait_ms'):
    if key in block:
      lines.append(f'  {key}: {block[key]}')
  shed = block.get('shed')
  if isinstance(shed, dict):
    lines.append('  shed: ' + ', '.join(
        f'{k}={v}' for k, v in sorted(shed.items())))
  cs = block.get('compile_status') or {}
  if cs.get('buckets'):
    lines.append('  buckets: ' + ', '.join(
        f'{c}={"warm" if w else "COLD"}'
        for c, w in sorted(cs['buckets'].items(),
                           key=lambda kv: int(kv[0]))))
  slo = block.get('slo') or {}
  for w in slo.get('windows', []):
    lines.append(
        f"  slo[{int(w['window_secs'])}s]: count={w['count']} "
        f"p50={w['p50_ms']}ms p99={w['p99_ms']}ms qps={w['qps']} "
        f"burn={w['burn_rate']}"
        + (f" (target p99 {slo['p99_target_ms']}ms)"
           if slo.get('p99_target_ms') else ''))
  return '\n'.join(lines)


def load_varz_snapshot(path: str) -> Optional[Dict]:
  """Load ``path`` if it is a ``/varz`` JSON snapshot (a single JSON
  object with a ``metrics`` dict); None when it is anything else
  (e.g. a recorder JSONL trace)."""
  try:
    with open(path) as f:
      obj = json.load(f)
  except (OSError, ValueError):
    return None
  if isinstance(obj, dict) and isinstance(obj.get('metrics'), dict):
    return obj
  return None


def format_varz_diff(cur: Dict, base: Dict) -> str:
  """Two-``/varz``-snapshot delta table: every key whose value
  changed (plus appeared/removed keys), with Δ and Δ/s over the
  snapshots' wall-clock gap.  Flat-encoded histogram bucket keys are
  rolled up to their ``count``/``secs`` totals to keep the table
  readable."""
  from . import histogram as _hist
  cm, bm = dict(cur['metrics']), dict(base['metrics'])
  dt = float(cur.get('ts', 0)) - float(base.get('ts', 0))
  for snap in (cm, bm):
    for k in [k for k in snap if _hist.HIST_SEP in k]:
      tail = k.rsplit(_hist.HIST_SEP, 1)[1]
      if tail.startswith('b'):
        snap.pop(k)
  rows = []
  for key in sorted(set(cm) | set(bm)):
    b, c = bm.get(key), cm.get(key)
    if b == c:
      continue
    d = (float(c) - float(b)) if (b is not None and c is not None) \
        else None
    rows.append([key,
                 '-' if b is None else f'{float(b):g}',
                 '-' if c is None else f'{float(c):g}',
                 '-' if d is None else f'{d:+g}',
                 '-' if d is None or dt <= 0 else f'{d / dt:.3g}'])
  head = (f"# /varz diff: pid {base.get('pid')} @ {base.get('ts')} -> "
          f"pid {cur.get('pid')} @ {cur.get('ts')} "
          f"({dt:.1f}s apart)")
  if not rows:
    return head + '\n(no changed keys)'
  return head + '\n' + _kv_table(
      rows, ['key', 'baseline', 'current', 'Δ', 'Δ/s'])


def _fmt_bytes(n: float) -> str:
  for unit in ('B', 'KB', 'MB', 'GB'):
    if abs(n) < 1024 or unit == 'GB':
      return f'{n:.0f}{unit}' if unit == 'B' else f'{n:.1f}{unit}'
    n /= 1024.0
  return f'{n:.1f}GB'


def find_attribution(path: str):
  """Locate an attribution block in ``path``: the
  `attribution_stats` dict itself, an envelope row carrying
  ``attribution``, or a records JSONL holding such rows (the
  highest-P row wins).  Returns ``(stats, layouts_or_None)``."""
  def from_obj(obj):
    if not isinstance(obj, dict):
      return None
    if 'bytes_matrix' in obj:
      return obj, None
    att = obj.get('attribution')
    if isinstance(att, dict) and 'bytes_matrix' in att:
      return att, obj.get('layouts')
    return None
  try:
    with open(path) as f:
      found = from_obj(json.load(f))
    if found:
      return found
  except ValueError:
    pass
  best, best_p = None, -1
  with open(path) as f:
    for line in f:
      line = line.strip()
      if not line:
        continue
      try:
        hit = from_obj(json.loads(line))
      except ValueError:
        continue
      if hit and int(hit[0].get('num_parts', 0)) > best_p:
        best, best_p = hit, int(hit[0].get('num_parts', 0))
  if best is None:
    raise SystemExit(f'no attribution block found in {path!r} — '
                     'expected attribution_stats JSON, an envelope '
                     'row with "attribution", or a records JSONL')
  return best


def format_attribution(stats: Dict,
                       layouts: Optional[Dict] = None) -> str:
  """Render one attribution block: locality summary, the P×P
  src-device → dst-range byte matrix, the layout padding-waste
  comparison (when present), and the hot-range table."""
  p = int(stats.get('num_parts', 0))
  out = [f"# traffic attribution (P={p}, "
         f"feature_row_bytes={stats.get('feature_row_bytes')})"]
  out.append(
      f"  ids: local={stats.get('local_ids')} "
      f"cross={stats.get('cross_ids')} "
      f"cross_frac={stats.get('cross_partition_ids_frac')}")
  out.append(
      f"  bytes: total={_fmt_bytes(float(stats.get('total_bytes', 0)))} "
      f"cross={_fmt_bytes(float(stats.get('cross_partition_bytes', 0)))} "
      f"cross_frac={stats.get('cross_partition_bytes_frac')}")
  mat = stats.get('bytes_matrix') or []
  if mat:
    out.append('# bytes by (src device -> dst range); '
               'diagonal = partition-local')
    rows = [[f'src{i}'] + [_fmt_bytes(float(v)) for v in r]
            for i, r in enumerate(mat)]
    out.append(_kv_table(rows, ['', *(f'r{j}' for j in
                                      range(len(mat[0])))]))
  if layouts:
    out.append('# padding waste by exchange layout (same static '
               'slack, one epoch each)')
    lrows = [[name,
              f"{blk.get('padding_waste_pct', '-')}",
              f"{blk.get('drop_rate_pct', '-')}",
              f"{blk.get('frontier_slots', '-')}",
              f"{blk.get('frontier_offered', '-')}"]
             for name, blk in sorted(layouts.items())]
    out.append(_kv_table(lrows, ['layout', 'waste_pct', 'drop_pct',
                                 'slots', 'offered']))
  hot = stats.get('hot_ranges') or []
  if hot:
    out.append(f"# hot ranges (top-{stats.get('top_k')}, "
               f"source={stats.get('hotness_source')}, "
               f"coverage={stats.get('hot_range_coverage')})")
    hrows = [[f"r{h['partition']}", f"{100.0 * h['share']:.1f}%"]
             for h in hot]
    out.append(_kv_table(hrows, ['range', 'share']))
  return '\n'.join(out)


_SPARK = ' ._-=+*#%@'


def _sparkline(vals: List[float], width: int = 48) -> str:
  """Coarse ASCII sparkline (min-max normalized, downsampled to
  ``width`` columns) — enough to see a burn-rate ramp or a queue
  flood in a terminal post-mortem."""
  if not vals:
    return ''
  if len(vals) > width:
    step = len(vals) / width
    vals = [vals[int(i * step)] for i in range(width)]
  lo, hi = min(vals), max(vals)
  if hi <= lo:
    return _SPARK[1] * len(vals)
  scale = (len(_SPARK) - 1) / (hi - lo)
  return ''.join(_SPARK[int((v - lo) * scale)] for v in vals)


def format_timeseries(block: Dict) -> str:
  """Render a `TimeSeriesStore.query` block (as attached to
  post-mortem bundles): per-series span, last/min/max and a
  sparkline — the "what was trending when it died" view."""
  series = block.get('series') or {}
  if not series:
    return ''
  out = [f"# time-series rings ({block.get('cadence_ms')}ms cadence, "
         f"{block.get('retention_s')}s retention)"]
  for key in sorted(series):
    s = series[key]
    pts = s.get('points') or []
    if not pts:
      continue
    vals = [float(v) for _, v in pts]
    span = float(pts[-1][0]) - float(pts[0][0])
    out.append(f"  {key} [{s.get('kind')}] n={len(pts)} "
               f"span={span:.0f}s last={vals[-1]:g} "
               f"min={min(vals):g} max={max(vals):g}")
    out.append(f'    |{_sparkline(vals)}|')
  return '\n'.join(out)


def render_postmortem(bundle: Dict) -> str:
  """The ``--postmortem`` view of one bundle: what died, what was in
  flight, what accelerated into the final window, the resilience /
  serving tables over the captured ring, supervision state, and the
  SLO gauge values at dump time."""
  import datetime
  events = bundle.get('events', [])
  out: List[str] = []
  when = datetime.datetime.fromtimestamp(
      bundle.get('ts', 0)).isoformat(timespec='seconds')
  out.append(f"# post-mortem: {bundle.get('reason')} @ {when} "
             f"(pid {bundle.get('pid')}, {len(events)} ring events)")
  err = bundle.get('error')
  if err:
    detail = ', '.join(f'{k}={v}' for k, v in sorted(err.items())
                       if k not in ('type', 'message'))
    out.append(f"error: {err.get('type')}: {err.get('message')}"
               + (f'  [{detail}]' if detail else ''))
  if bundle.get('extra'):
    out.append('context: ' + ', '.join(
        f'{k}={v}' for k, v in sorted(bundle['extra'].items())))
  inflight = spans_in_flight(events, at_mono=bundle.get('mono'))
  out.append('# spans in flight at dump'
             + (' (none)' if not inflight else ''))
  for row in inflight[:20]:
    age = f" open {row['age_s']}s" if row.get('age_s') is not None \
        else ''
    out.append(f"  {row['name']}  pid={row['pid']}{age}")
  if bundle.get('mono') is not None and events:
    out.append('# event counts, final 60s window vs whole ring')
    out.append(_kv_table(
        final_window_counts(events, float(bundle['mono'])),
        ['kind', 'last_60s', 'total']))
  res = format_resilience_table(events)
  if res:
    out.append('# resilience events')
    out.append(res)
  srv = format_serving_table(events)
  if srv:
    out.append('# serving request latency percentiles')
    out.append(srv)
  health = bundle.get('health') or {}
  comps = health.get('components') or {}
  if comps:
    out.append(f"# health at dump (ok={health.get('ok')})")
    for name, block in sorted(comps.items()):
      out.append(f'{name}:')
      if name == 'serving':
        out.append(format_serving_health(block))
      else:
        for k, v in sorted(block.items()):
          if k == 'producers' and isinstance(v, dict):
            for pid, p in sorted(v.items()):
              out.append(f'  producer {pid}: ' + ', '.join(
                  f'{kk}={vv}' for kk, vv in sorted(p.items())))
          else:
            out.append(f'  {k}: {v}')
  metrics_snap = bundle.get('metrics') or {}
  slo_keys = sorted(k for k in metrics_snap
                    if k.startswith('serving.slo.'))
  if slo_keys:
    out.append('# SLO gauges at dump')
    for k in slo_keys:
      out.append(f'  {k}: {metrics_snap[k]}')
  # streaming ingestion block: the WAL/apply/version state
  # of a process that died mid-ingest — the first thing the operator
  # asks after an ingestion fault bundle
  ingest_keys = sorted(k for k in metrics_snap
                       if k.startswith('ingest.')
                       or k.startswith('graph.version'))
  if ingest_keys:
    out.append('# ingestion at dump')
    for k in ingest_keys:
      out.append(f'  {k}: {metrics_snap[k]}')
  ts_block = bundle.get('timeseries')
  if isinstance(ts_block, dict):
    ts = format_timeseries(ts_block)
    if ts:
      out.append(ts)
  elif bundle.get('timeseries_error'):
    out.append('note: time-series rings unavailable: '
               + str(bundle['timeseries_error']))
  hists = histograms_from_events(events)
  if hists:
    out.append('# per-stage span latencies (captured ring)')
    out.append(format_table(hists))
  rec = bundle.get('recorder') or {}
  if rec.get('ring_dropped'):
    out.append(f"note: the ring dropped {rec['ring_dropped']} "
               'event(s) before the dump — this window is partial '
               '(raise GLT_TELEMETRY_EVENTS)')
  return '\n'.join(out)


_BUCKET_RE = re.compile(
    r'^(?P<name>[A-Za-z_:][\w:]*)_bucket\{(?P<labels>[^}]*)\}\s')


def format_exemplars(text: str) -> str:
  """The p99→trace jump: for each histogram family in a
  saved ``/metrics`` exposition, the HIGHEST bucket carrying an
  OpenMetrics exemplar — its trace id is a retained trace of a
  request that LANDED in that bucket, fetchable at
  ``/trace?trace_id=<id>`` (``&format=chrome`` for Perfetto)."""
  from .live import split_exemplar
  best: Dict[str, tuple] = {}
  for line in text.splitlines():
    sample, ex = split_exemplar(line)
    if ex is None:
      continue
    m = _BUCKET_RE.match(sample.strip())
    if m is None:
      continue
    labels = m.group('labels')
    le_m = re.search(r'le="([^"]+)"', labels)
    le = le_m.group(1) if le_m else '+Inf'
    le_v = float('inf') if le == '+Inf' else float(le)
    tid_m = re.search(r'trace_id="([^"]+)"', ex)
    if tid_m is None:
      continue
    rest = ','.join(kv for kv in labels.split(',')
                    if not kv.startswith('le=') and kv)
    key = m.group('name') + (f'{{{rest}}}' if rest else '')
    if key not in best or le_v > best[key][0]:
      best[key] = (le_v, le, tid_m.group(1))
  if not best:
    return ''
  rows = [[key, le, tid, f'/trace?trace_id={tid}']
          for key, (_, le, tid) in sorted(best.items())]
  return _kv_table(rows, ['histogram', 'top bucket le',
                          'exemplar trace', 'fetch'])


def histograms_from_metrics_json(path: str) -> Dict[str, Histogram]:
  """Decode a `gather_metrics` dump (the ``aggregate`` dict, or the
  whole result object) into merged histograms."""
  with open(path) as f:
    obj = json.load(f)
  if isinstance(obj, dict) and isinstance(obj.get('aggregate'), dict):
    obj = obj['aggregate']
  return from_snapshot(obj)


def main(argv: Optional[List[str]] = None) -> int:
  ap = argparse.ArgumentParser(
      prog='python -m graphlearn_tpu_torch.telemetry.report',
      description='Per-stage latency report over a flight-recorder '
                  'trace (and optional trace diff / Chrome export).')
  ap.add_argument('trace', nargs='?',
                  help='recorder JSONL (GLT_TELEMETRY_JSONL output)')
  ap.add_argument('--diff', metavar='BASELINE_JSONL',
                  help='second trace to diff against (Δmean%% column)')
  ap.add_argument('--chrome', metavar='OUT_JSON',
                  help='also write a Perfetto-loadable Chrome trace')
  ap.add_argument('--metrics-json', metavar='FILE',
                  help='print merged histograms from a gather_metrics '
                       'aggregate dump instead of a JSONL trace')
  ap.add_argument('--postmortem', metavar='BUNDLE',
                  help='render a post-mortem bundle '
                       '(GLT_POSTMORTEM_DIR output): spans in flight '
                       'at dump, final-window event deltas, '
                       'resilience/serving tables, supervision state')
  ap.add_argument('--attribution', metavar='FILE',
                  help='render per-partition traffic attribution '
                       '(attribution_stats JSON, a bench envelope '
                       'row, or a records JSONL): P×P byte matrix, '
                       'padding-waste-by-layout, hot-range table')
  ap.add_argument('--exemplars', metavar='METRICS_TXT',
                  help='render the p99→trace jump table from a '
                       'saved /metrics exposition: per histogram, '
                       'the top exemplar-carrying bucket and its '
                       '/trace?trace_id= fetch')
  args = ap.parse_args(argv)
  if args.exemplars:
    with open(args.exemplars) as f:
      table = format_exemplars(f.read())
    print('# exemplar → trace jumps '
          f'({args.exemplars})')
    print(table if table else
          '(no exemplars in the exposition — tracing off, or no '
          'traced request has landed in any bucket yet)')
    return 0
  if args.postmortem:
    from .postmortem import load_bundle
    print(render_postmortem(load_bundle(args.postmortem)))
    return 0
  if args.attribution:
    stats, layouts = find_attribution(args.attribution)
    print(format_attribution(stats, layouts))
    return 0
  if not args.trace and not args.metrics_json:
    ap.error('need a TRACE.jsonl, --metrics-json FILE, '
             '--attribution FILE, or --postmortem BUNDLE')
  if args.metrics_json:
    hists = histograms_from_metrics_json(args.metrics_json)
    print(f'# merged cross-host histograms ({args.metrics_json})')
    print(format_table(hists))
    if not args.trace:
      if args.chrome or args.diff:
        ap.error('--chrome/--diff need a TRACE.jsonl positional '
                 'argument (a metrics aggregate has no events to '
                 'export or diff)')
      return 0
  if args.trace and args.diff:
    cur_varz = load_varz_snapshot(args.trace)
    base_varz = load_varz_snapshot(args.diff)
    if cur_varz is not None and base_varz is not None:
      print(format_varz_diff(cur_varz, base_varz))
      return 0
    if (cur_varz is None) != (base_varz is None):
      ap.error('--diff mixes a /varz JSON snapshot with a JSONL '
               'trace — both sides must be the same kind')
  events = load_events(args.trace)
  hists = histograms_from_events(events)
  base = histograms_from_trace(args.diff) if args.diff else None
  print(f'# per-stage span latencies ({args.trace})'
        + (f' vs {args.diff}' if args.diff else ''))
  if not hists:
    print('(no span.end events in trace — was the recorder on and '
          'the pipeline span-instrumented?)')
  else:
    print(format_table(hists, baseline=base))
  res = format_resilience_table(events)
  if res:
    print('# resilience events (retries, faults, snapshots, stalls)')
    print(res)
  srv = format_serving_table(events)
  if srv:
    print('# serving request latency percentiles (serving.request '
          'events; exact quantiles, not log2 buckets)')
    print(srv)
  if args.chrome:
    n = write_chrome_trace(args.trace, args.chrome)
    print(f'# wrote {n} trace events -> {args.chrome} '
          '(open in https://ui.perfetto.dev)')
  return 0


if __name__ == '__main__':
  sys.exit(main())
