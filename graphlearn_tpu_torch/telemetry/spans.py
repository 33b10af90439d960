"""Causal span layer over the flight recorder.

The port's copy of the JAX package's `telemetry/spans.py`.  The
recorder captures point events; answering "which stage of batch 1317
stalled — the exchange, the cold-tier drain, or the feature gather?"
needs *causally linked* spans with durations.  A span is a
``span.begin`` / ``span.end`` event pair sharing a ``span_id``, linked
into a tree by ``trace_id`` (the root's id) and ``parent_id``:

    {"kind": "span.begin", "name": "batch", "trace_id": "ab..",
     "span_id": "ab..", "parent_id": null, "pid": 71, "tid": 139.., ...}
    {"kind": "span.end",   "name": "batch", "span_id": "ab..",
     "dur": 0.0123, ...}

Durations come from the MONOTONIC clock (the recorder's ``mono``
field's timebase), so a wall-clock step/NTP slew mid-span cannot
produce negative or wild durations.  Each ``span.end`` also ticks the
per-kind log2 latency histogram (:mod:`.histogram`), which is what the
``telemetry.report`` CLI and the cross-host `gather_metrics` merge
read.

The ambient CURRENT span is a `contextvars.ContextVar`: ``span()``
blocks nest naturally per thread/task, and a fresh thread starts a
fresh trace (prefetch workers become their own roots).  For the
DISTRIBUTED pipeline the context crosses process boundaries as a tiny
uint8 tensor riding each `SampleMessage` under :data:`SPAN_KEY` — the
channels inject the sender's context on ``send`` and strip it on
``recv`` (`channel.base`), so a consumer can attribute its recv/collate
work to the producer's trace (``producer_trace`` / ``producer_span``
fields on the consumer's spans).

Cost when the recorder is OFF: one context-manager allocation and one
attribute check per ``span()`` block — safe for hot host paths.
"""
from __future__ import annotations

import contextvars
import json
import os
import time
from typing import NamedTuple, Optional

from .recorder import recorder

#: `SampleMessage` key carrying the serialized span context (uint8
#: JSON payload — every channel transport ships numpy arrays).
SPAN_KEY = '#SPAN'


class SpanContext(NamedTuple):
  """The propagated identity of an open span."""
  trace_id: str
  span_id: str


_CURRENT: contextvars.ContextVar[Optional[SpanContext]] = \
    contextvars.ContextVar('glt_span', default=None)


def _new_id() -> str:
  return os.urandom(8).hex()


def current() -> Optional[SpanContext]:
  """The ambient span context (None outside any span)."""
  return _CURRENT.get()


#: event fields the span machinery itself writes; a caller field with
#: one of these names is renamed ``<name>_`` instead of raising a
#: TypeError out of the hot path the moment telemetry gets enabled.
_RESERVED = frozenset(('kind', 'ts', 'mono', 'pid', 'tid', 'name',
                       'trace_id', 'span_id', 'parent_id', 'dur',
                       'error'))


class span:
  """Context manager / decorator: one timed, causally-linked span.

  >>> with span('batch', batch=7):
  ...   with span('sample.exchange'):    # child of 'batch'
  ...     dispatch()

  ``parent`` overrides the ambient parent (e.g. a `SpanContext`
  extracted from a channel message); extra keyword fields land on both
  the begin and end events (names colliding with the span machinery's
  own fields — `_RESERVED` — are suffixed with ``_``).  When the
  flight recorder is off the whole block is a no-op (one attribute
  check).  The yielded value is the span's `SpanContext` (None when
  disabled).
  """

  __slots__ = ('kind', 'fields', 'parent', 'ctx', '_token', '_t0')

  def __init__(self, kind: str, parent: Optional[SpanContext] = None,
               **fields):
    self.kind = kind
    self.fields = fields
    self.parent = parent
    self.ctx = None
    self._token = None
    self._t0 = 0.0

  def __enter__(self) -> Optional[SpanContext]:
    if self.ctx is not None:
      # re-entrant reuse of ONE instance would clobber _token and
      # leak the contextvar on exit, phantom-parenting every later
      # span on the thread; sequential reuse (ctx reset by __exit__)
      # stays fine
      raise RuntimeError(
          'span instance re-entered while open — construct a new '
          'span() for each nested block')
    if not recorder.enabled:
      return None
    # field normalization only on the enabled path — recorder-off cost
    # stays at the object allocation plus this one attribute check
    self.fields = {(k + '_' if k in _RESERVED else k): v
                   for k, v in self.fields.items()}
    parent = self.parent if self.parent is not None else _CURRENT.get()
    trace_id = parent.trace_id if parent else _new_id()
    sid = _new_id() if parent else trace_id   # root span id == trace id
    self.ctx = SpanContext(trace_id, sid)
    # pid/tid come from the recorder, which stamps them on EVERY event
    recorder.emit('span.begin', name=self.kind, trace_id=trace_id,
                  span_id=sid,
                  parent_id=parent.span_id if parent else None,
                  **self.fields)
    self._token = _CURRENT.set(self.ctx)
    # monotonic, not wall: durations must survive clock steps (the
    # recorder's `mono` field is the same timebase)
    self._t0 = time.monotonic()
    return self.ctx

  def __exit__(self, exc_type, exc, tb) -> bool:
    if self.ctx is None:
      return False
    dt = time.monotonic() - self._t0
    _CURRENT.reset(self._token)
    if recorder.enabled:
      # a disable() mid-span must keep the histogram and the trace's
      # span.end counts in agreement (both skip this span)
      from . import histogram
      histogram.record(self.kind, dt)
    recorder.emit('span.end', name=self.kind,
                  trace_id=self.ctx.trace_id, span_id=self.ctx.span_id,
                  parent_id=(self.parent.span_id if self.parent
                             else getattr(_CURRENT.get(), 'span_id',
                                          None)),
                  dur=round(dt, 6),
                  error=(exc_type.__name__ if exc_type else None),
                  **self.fields)
    self.ctx = None
    return False

  def __call__(self, fn):
    """Decorator form: ``@span('stage')``."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
      with type(self)(self.kind, parent=self.parent, **self.fields):
        return fn(*args, **kwargs)
    return wrapped


# -- cross-process propagation ---------------------------------------------

def inject(msg) -> None:
  """Attach the ambient span context to a `SampleMessage` in place
  (no-op when the recorder is off or no span is open).  The payload is
  a uint8 JSON tensor so every channel transport — pickle, shm
  tensor-map, socket RPC — carries it unchanged."""
  if not recorder.enabled:
    return
  ctx = _CURRENT.get()
  if ctx is None:
    return
  import numpy as np
  payload = json.dumps({'t': ctx.trace_id, 's': ctx.span_id})
  msg[SPAN_KEY] = np.frombuffer(payload.encode('utf-8'),
                                np.uint8).copy()


def extract(msg) -> Optional[SpanContext]:
  """Pop and decode the span context a producer injected into ``msg``
  (None when absent or malformed — a context must never break a
  batch)."""
  raw = msg.pop(SPAN_KEY, None) if hasattr(msg, 'pop') else None
  if raw is None:
    return None
  try:
    import numpy as np
    d = json.loads(bytes(bytearray(np.asarray(raw, np.uint8)))
                   .decode('utf-8'))
    return SpanContext(str(d['t']), str(d['s']))
  except Exception:             # noqa: BLE001 — degrade, never raise
    return None


def link_fields(ctx: Optional[SpanContext]) -> dict:
  """Cross-trace link fields for a span that CONSUMES another trace's
  message (the consumer's span stays in its own tree; the link records
  causality across the process boundary)."""
  if ctx is None:
    return {}
  return {'producer_trace': ctx.trace_id, 'producer_span': ctx.span_id}
