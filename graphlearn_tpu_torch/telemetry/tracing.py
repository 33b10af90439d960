"""Request-scoped tail-sampled tracing — the serve plane's causality.

The port's copy of the JAX package's `telemetry/tracing.py`.

The span layer (`telemetry.spans`) answers "what did this PROCESS do"
— its context rides channel frames but dies at the serve RPC boundary,
and the frontend opens one ``serving.infer`` span per COALESCED run,
not per request.  This module adds the request axis (Dapper-style):

  * `Tracer.mint` creates a trace context at the FleetRouter — a tiny
    dict ``{'t': trace_id, 's': parent_span_id, 'k': sampled}`` that
    rides the serve RPC as a plain keyword argument (the same
    discipline as the channel ``'#SPAN'`` header), so every process a
    request crosses attributes its work to the same trace.
  * `Tracer.span` records one COMPLETED span (explicit start/duration
    — no context-vars, no clock mixing: callers time with
    ``time.monotonic()`` and hand over ``t0``/``dur``).  Spans buffer
    per trace until the request resolves.
  * `Tracer.resolve` applies TAIL-BASED retention: the finished
    request's spans are kept only when the request was slow
    (``GLT_TRACE_SLOW_MS``, default = the serving SLO p99), failed or
    shed, or head-sampled 1-in-N (``GLT_TRACE_SAMPLE``; the sampled
    bit is minted once and rides the context, so every process keeps
    the same traces).  Retained trees live in a bounded ring
    (``GLT_TRACE_BUFFER``) served at ``/traces`` + ``/trace?trace_id=``
    by the ops endpoint; `FleetScraper.fetch_trace` reassembles one
    request's spans across replicas into a Perfetto-loadable trace.

``GLT_TRACE_SAMPLE=0`` (the default) disables minting entirely:
`mint` returns None, every `span`/`resolve` on a None context is a
single falsy check, and the data plane is byte-identical.

Resolution is an idempotent MERGE: both the router (root span) and
the serving frontend (child spans) resolve the same trace_id — in an
in-process fleet they share this process-global tracer, so whichever
side resolves second appends its spans to the already-retained tree
instead of double-counting a retention.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional

TRACE_SAMPLE_ENV = 'GLT_TRACE_SAMPLE'
TRACE_SLOW_MS_ENV = 'GLT_TRACE_SLOW_MS'
TRACE_BUFFER_ENV = 'GLT_TRACE_BUFFER'

#: retained-trace ring size (completed trees kept for /trace fetches)
DEFAULT_BUFFER = 256

#: unresolved-trace bound: a trace whose resolve never arrives (a
#: crashed router mid-request) must not pin spans forever
_MAX_PENDING = 1024

#: per-trace span bound — a runaway instrumentation loop must not
#: grow one tree without limit
_MAX_SPANS = 512


def _env_int(name: str, default: int) -> int:
  try:
    return int(float(os.environ.get(name, '') or default))
  except ValueError:
    return default


def _env_float(name: str) -> Optional[float]:
  raw = os.environ.get(name)
  if raw is None or raw == '':
    return None
  try:
    return float(raw)
  except ValueError:
    return None


def _new_id() -> str:
  return os.urandom(8).hex()


def child_ctx(ctx: Optional[dict], span_id: str) -> Optional[dict]:
  """A context whose spans parent under ``span_id`` (same trace, same
  sampled bit)."""
  if not ctx:
    return None
  return {'t': ctx['t'], 's': span_id, 'k': ctx.get('k', 0)}


def spans_to_events(spans: List[dict]) -> List[dict]:
  """Expand completed span records into paired ``span.begin`` /
  ``span.end`` events — the encoding `telemetry.export.to_chrome_trace`
  already pairs into balanced ``ph:'X'`` slices."""
  events: List[dict] = []
  for s in spans:
    dur = float(s.get('dur', 0.0))
    # spans from DIFFERENT processes share no monotonic origin — the
    # events carry only wall-clock ts so the exporter aligns every
    # process on the one comparable timebase
    meta = {k: v for k, v in s.items() if k not in ('dur', 'mono')}
    begin = dict(meta)
    begin['kind'] = 'span.begin'
    end = dict(meta)
    end.update(kind='span.end', dur=dur,
               ts=float(s.get('ts', 0.0)) + dur)
    events.append(begin)
    events.append(end)
  return events


class Tracer:
  """Bounded per-process trace store with tail-based retention.

  Args:
    sample: head-sampling period N (1-in-N minted traces carry the
      keep bit; 0 = tracing OFF).  None = ``GLT_TRACE_SAMPLE``.
    slow_ms: latency threshold above which a resolved trace is
      retained regardless of sampling.  None = ``GLT_TRACE_SLOW_MS``,
      falling back to the serving SLO p99 (``GLT_SERVING_SLO_P99_MS``).
    buffer: retained-trace ring size.  None = ``GLT_TRACE_BUFFER``.
  """

  def __init__(self, sample: Optional[int] = None,
               slow_ms: Optional[float] = None,
               buffer: Optional[int] = None):
    self._lock = threading.Lock()
    self._pending: 'collections.OrderedDict[str, List[dict]]' = \
        collections.OrderedDict()
    self._retained: 'collections.OrderedDict[str, dict]' = \
        collections.OrderedDict()
    self._minted = 0
    self.configure(sample=sample, slow_ms=slow_ms, buffer=buffer)

  def configure(self, sample: Optional[int] = None,
                slow_ms: Optional[float] = None,
                buffer: Optional[int] = None) -> None:
    """(Re)apply knobs; None re-reads the environment — tests and the
    bench scripts flip sampling without rebuilding the global."""
    if sample is None:
      sample = _env_int(TRACE_SAMPLE_ENV, 0)
    if slow_ms is None:
      slow_ms = _env_float(TRACE_SLOW_MS_ENV)
      if slow_ms is None:
        from .slo import slo_p99_ms_from_env
        slow_ms = slo_p99_ms_from_env()
    if buffer is None:
      buffer = _env_int(TRACE_BUFFER_ENV, DEFAULT_BUFFER)
    self.sample = max(int(sample), 0)
    self.slow_ms = max(float(slow_ms), 0.0)
    self.buffer = max(int(buffer), 1)

  @property
  def enabled(self) -> bool:
    return self.sample > 0

  # -- recording -------------------------------------------------------------
  def mint(self) -> Optional[dict]:
    """New root context, or None when tracing is off.  The 1-in-N
    head-sample bit is decided HERE and rides the context — every
    process retains the same sampled traces."""
    if self.sample <= 0:
      return None
    with self._lock:
      self._minted += 1
      k = 1 if (self._minted - 1) % self.sample == 0 else 0
    tid = _new_id()
    return {'t': tid, 's': tid, 'k': k}

  def span(self, name: str, ctx: Optional[dict], *,
           span_id: Optional[str] = None,
           parent_id: Optional[str] = None,
           t0: Optional[float] = None, dur: float = 0.0,
           error: Optional[str] = None, **fields) -> Optional[str]:
    """Record one completed span under ``ctx``'s trace.  ``t0`` is the
    span's start on the monotonic clock (None = now - dur); wall-clock
    ``ts`` is derived from it so cross-process trees line up on the
    wall timebase.  Returns the span id (pre-mint one with
    ``span_id=`` to parent children under a span recorded later)."""
    if not ctx:
      return None
    now_mono = time.monotonic()
    if t0 is None:
      t0 = now_mono - dur
    sid = span_id or _new_id()
    parent = ctx['s'] if parent_id is None else parent_id
    if parent == sid:
      parent = None                  # self-parent = the trace root
    rec = {
        'kind': 'span', 'name': name, 'trace_id': ctx['t'],
        'span_id': sid, 'parent_id': parent,
        'pid': os.getpid(), 'tid': threading.get_ident(),
        # wall-clock START derived by rebasing the monotonic span
        # window — not a duration
        'ts': time.time() - (now_mono - t0), 'mono': float(t0),
        'dur': max(float(dur), 0.0),
    }
    if error is not None:
      rec['error'] = str(error)
    for k, v in fields.items():
      if v is not None:
        rec.setdefault(k, v)
    with self._lock:
      tid = ctx['t']
      entry = self._retained.get(tid)
      if entry is not None:
        # late span on an already-retained trace (the rpc wrapper
        # closing after the frontend resolved) — merge directly
        if len(entry['spans']) < _MAX_SPANS:
          entry['spans'].append(rec)
        return rec['span_id']
      spans = self._pending.get(tid)
      if spans is None:
        while len(self._pending) >= _MAX_PENDING:
          self._pending.popitem(last=False)
        spans = self._pending[tid] = []
      if len(spans) < _MAX_SPANS:
        spans.append(rec)
    return rec['span_id']

  def resolve(self, ctx: Optional[dict], outcome: str = 'ok',
              latency_ms: float = 0.0) -> bool:
    """Apply the tail-retention verdict to a finished request's trace;
    returns whether the trace is (now) retained.  Idempotent merge:
    resolving a trace that is already retained folds any newly-pending
    spans into the kept tree."""
    if not ctx:
      return False
    tid = ctx['t'] if isinstance(ctx, dict) else str(ctx)
    sampled = bool(ctx.get('k')) if isinstance(ctx, dict) else False
    keep = (outcome != 'ok' or sampled
            or (self.slow_ms > 0
                and float(latency_ms) >= self.slow_ms))
    fresh = False
    with self._lock:
      spans = self._pending.pop(tid, [])
      entry = self._retained.get(tid)
      if entry is not None:
        room = _MAX_SPANS - len(entry['spans'])
        entry['spans'].extend(spans[:max(room, 0)])
        if outcome != 'ok' and entry['outcome'] == 'ok':
          entry['outcome'] = outcome
        entry['latency_ms'] = max(entry['latency_ms'],
                                  round(float(latency_ms), 3))
        return True
      if not keep:
        return False
      self._retained[tid] = {
          'trace_id': tid, 'outcome': outcome,
          'latency_ms': round(float(latency_ms), 3),
          'sampled': int(sampled), 'ts': round(time.time(), 3),
          'spans': spans,
      }
      while len(self._retained) > self.buffer:
        self._retained.popitem(last=False)
      fresh = True
    if fresh:
      from .live import live
      live.counter('serving.traces_retained_total').inc()
    return True

  # -- serving the buffer ----------------------------------------------------
  def traces(self) -> List[dict]:
    """Retained-trace index, newest first (span COUNTS, not bodies —
    the ``/traces`` listing)."""
    with self._lock:
      entries = list(self._retained.values())
    return [{'trace_id': e['trace_id'], 'outcome': e['outcome'],
             'latency_ms': e['latency_ms'], 'sampled': e['sampled'],
             'ts': e['ts'], 'spans': len(e['spans'])}
            for e in reversed(entries)]

  def spans_of(self, trace_id: str) -> List[dict]:
    """This process's retained spans for one trace (copies)."""
    with self._lock:
      entry = self._retained.get(trace_id)
      return [dict(s) for s in entry['spans']] if entry else []

  def events_of(self, trace_id: str) -> List[dict]:
    return spans_to_events(self.spans_of(trace_id))

  def stats(self) -> dict:
    with self._lock:
      return {'sample': self.sample, 'slow_ms': self.slow_ms,
              'buffer': self.buffer, 'minted': self._minted,
              'pending': len(self._pending),
              'retained': len(self._retained)}

  def clear(self) -> None:
    with self._lock:
      self._pending.clear()
      self._retained.clear()
      self._minted = 0


#: process-global tracer every serve-plane participant records into
#: (the one the ops endpoint serves at /traces)
tracer = Tracer()
