"""Flight-recorder dump -> Chrome trace-event JSON (Perfetto-loadable).

A recorder JSONL (``GLT_TELEMETRY_JSONL`` or `EventRecorder.dump`) is
a flat event stream; this module turns it into the Chrome trace-event
format (the JSON array flavor) that https://ui.perfetto.dev and
``chrome://tracing`` open directly:

  * paired ``span.begin``/``span.end`` events (`telemetry.spans`)
    become COMPLETE ``"ph": "X"`` slices — name, ``ts``/``dur`` in
    microseconds on the monotonic timebase, ``pid``/``tid`` rows, and
    the span's trace/parent ids + extra fields under ``args`` (so
    Perfetto's query/flow UI can reconstruct the causal tree);
  * every other event kind becomes an INSTANT ``"ph": "i"`` marker on
    the same timeline (scope ``"t"``), so channel stalls and slack
    transitions line up against the spans that suffered them.

Unpaired begins (a crash mid-span, a recorder disable between begin
and end) are dropped rather than guessed at — the X-slice encoding
keeps every emitted slice begin/end balanced by construction.

The human-facing side of the same dump (per-stage latency tables,
trace diffs) lives in :mod:`.report`.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

SPAN_BEGIN = 'span.begin'
SPAN_END = 'span.end'


def load_events(path: str) -> List[Dict]:
  """Read a recorder JSONL dump; malformed lines (a kill mid-write on
  a shared file) are skipped, not fatal."""
  out = []
  with open(path) as f:
    for ln in f:
      ln = ln.strip()
      if not ln:
        continue
      try:
        out.append(json.loads(ln))
      except json.JSONDecodeError:
        continue
  return out


def _time_origins(events: List[Dict]):
  """Per-timebase zero points: `mono` events offset from the earliest
  mono, pre-`mono` events (an appended-to old dump) from the earliest
  wall ``ts`` — mixing the two bases against one origin would fling
  whichever group loses ~decades down the timeline."""
  monos = [float(e['mono']) for e in events if 'mono' in e]
  tss = [float(e['ts']) for e in events
         if 'mono' not in e and 'ts' in e]
  return (min(monos) if monos else 0.0, min(tss) if tss else 0.0)


def _event_us(ev: Dict, t0_mono: float, t0_ts: float) -> float:
  """Event time in microseconds on its own timebase's origin."""
  if 'mono' in ev:
    return (float(ev['mono']) - t0_mono) * 1e6
  return (float(ev.get('ts', 0.0)) - t0_ts) * 1e6


_META = ('kind', 'name', 'trace_id', 'span_id', 'parent_id', 'pid',
         'tid', 'ts', 'mono', 'dur')


def to_chrome_trace(events: List[Dict],
                    include_instants: bool = True) -> Dict:
  """Convert a recorder event list to a Chrome trace-event object
  (``{'traceEvents': [...], ...}``)."""
  if not events:
    return {'traceEvents': [], 'displayTimeUnit': 'ms'}
  t0_mono, t0_ts = _time_origins(events)
  begins: Dict[str, Dict] = {}
  out: List[Dict] = []
  for ev in events:
    kind = ev.get('kind')
    if kind == SPAN_BEGIN:
      sid = ev.get('span_id')
      if sid is not None:
        begins[sid] = ev
    elif kind == SPAN_END:
      b = begins.pop(ev.get('span_id'), None)
      if b is None:
        continue                      # unpaired end: drop
      dur_us = float(ev.get('dur', 0.0)) * 1e6
      args = {k: v for k, v in b.items() if k not in _META}
      args.update({k: v for k, v in ev.items() if k not in _META})
      args['trace_id'] = b.get('trace_id')
      args['parent_id'] = b.get('parent_id')
      args['span_id'] = b.get('span_id')
      out.append({
          'name': b.get('name', 'span'), 'ph': 'X', 'cat': 'span',
          'ts': round(_event_us(b, t0_mono, t0_ts), 3),
          'dur': round(max(dur_us, 0.0), 3),
          'pid': int(b.get('pid', 0)), 'tid': int(b.get('tid', 0)),
          'args': args,
      })
    elif include_instants:
      out.append({
          'name': kind or 'event', 'ph': 'i', 'cat': 'event', 's': 't',
          'ts': round(_event_us(ev, t0_mono, t0_ts), 3),
          'pid': int(ev.get('pid', 0)), 'tid': int(ev.get('tid', 0)),
          'args': {k: v for k, v in ev.items()
                   if k not in ('kind', 'ts', 'mono', 'pid', 'tid')},
      })
  # cross-process causality: a child slice whose parent slice lives
  # on a DIFFERENT pid gets a flow arrow (ph 's' at the parent, ph
  # 'f' binding to the end of the child's enclosing slice) — the RPC
  # edge Perfetto cannot infer from same-track nesting
  slices = {e['args'].get('span_id'): e for e in out
            if e.get('ph') == 'X' and e['args'].get('span_id')}
  flows: List[Dict] = []
  for sid, sl in slices.items():
    parent = slices.get(sl['args'].get('parent_id'))
    if parent is None or parent['pid'] == sl['pid']:
      continue
    flows.append({'name': 'rpc', 'ph': 's', 'cat': 'flow',
                  'id': str(sid), 'ts': parent['ts'],
                  'pid': parent['pid'], 'tid': parent['tid']})
    flows.append({'name': 'rpc', 'ph': 'f', 'bp': 'e', 'cat': 'flow',
                  'id': str(sid), 'ts': sl['ts'],
                  'pid': sl['pid'], 'tid': sl['tid']})
  out.extend(flows)
  out.sort(key=lambda e: e['ts'])
  return {'traceEvents': out, 'displayTimeUnit': 'ms'}


def write_chrome_trace(src_jsonl: str, dest_json: str,
                       include_instants: bool = True) -> int:
  """JSONL dump -> Chrome trace file; returns the trace-event count."""
  trace = to_chrome_trace(load_events(src_jsonl),
                          include_instants=include_instants)
  with open(dest_json, 'w') as f:
    json.dump(trace, f)
  return len(trace['traceEvents'])


def span_durations(events: List[Dict]) -> Dict[str, List[float]]:
  """Per-kind lists of span durations (seconds) from ``span.end``
  events — the raw material of the report tables."""
  out: Dict[str, List[float]] = {}
  for ev in events:
    if ev.get('kind') == SPAN_END and ev.get('dur') is not None:
      out.setdefault(ev.get('name', 'span'), []).append(
          float(ev['dur']))
  return out


def span_children(events: List[Dict]) -> Dict[Optional[str], List[str]]:
  """``{parent_span_id: [child_span_id, ...]}`` from begin events —
  the causal tree (roots under key None).  Begin lines missing a
  span_id (truncated shared-file writes) are skipped, matching
  `to_chrome_trace`."""
  out: Dict[Optional[str], List[str]] = {}
  for ev in events:
    if ev.get('kind') == SPAN_BEGIN and ev.get('span_id') is not None:
      out.setdefault(ev.get('parent_id'), []).append(ev['span_id'])
  return out
