"""Bounded, thread-safe flight recorder.

The port's copy of the JAX package's `telemetry/recorder.py`, reduced to
what the port calls: a fixed-size in-memory ring of structured events
(the JSON-lines file sink is not ported).

Producers call ``recorder.emit('ingest.replay', records=3, ...)`` from
any thread; while recording is off (the default) ``emit`` is one
attribute check, so instrumentation can stay in hot host paths.  An
event is a dict::

    {"ts": 1722700000.123, "mono": 12345.678901, "pid": 71,
     "tid": 1393..., "kind": "ingest.replay", ...}

``ts`` is ``time.time()``, ``mono`` is ``time.monotonic()`` of the same
event; numpy and torch values are coerced to plain python.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

DEFAULT_MAX_EVENTS = 4096


def _jsonable(v: Any) -> Any:
  """Numpy / torch scalars and arrays to plain python; anything else
  that is not a plain value degrades to ``repr``."""
  if v is None or isinstance(v, (bool, int, float, str, list, tuple,
                                 dict)):
    return v
  try:
    if getattr(v, 'ndim', None) == 0:
      return v.item()
    if hasattr(v, 'tolist'):
      return v.tolist()
  except Exception:                 # noqa: BLE001 — best-effort coercion
    pass
  return repr(v)


def _safe_dumps(ev: Dict) -> str:
  """Serialize an event, degrading unserializable fields to ``repr``
  instead of raising."""
  try:
    return json.dumps(ev, default=repr)
  except (TypeError, ValueError):
    return json.dumps(
        {k: (v if isinstance(v, (str, int, float, bool, type(None)))
             else repr(v)) for k, v in ev.items()})


class EventRecorder:
  """Bounded thread-safe event ring (oldest events drop first)."""

  def __init__(self, max_events: int = DEFAULT_MAX_EVENTS):
    self._lock = threading.Lock()
    self._ring: collections.deque = collections.deque(
        maxlen=max(int(max_events), 1))
    self._ring_dropped = 0
    self.enabled = False

  def enable(self) -> 'EventRecorder':
    self.enabled = True
    return self

  def disable(self) -> None:
    self.enabled = False

  def emit(self, kind: str, **fields) -> None:
    """Record one event.  No-op (one attribute check) when disabled."""
    if not self.enabled:
      return
    ev = {'ts': round(time.time(), 6), 'mono': round(time.monotonic(), 6),
          'pid': os.getpid(), 'tid': threading.get_ident(), 'kind': kind}
    for k, v in fields.items():
      ev[k] = _jsonable(v)
    with self._lock:
      if len(self._ring) == self._ring.maxlen:
        self._ring_dropped += 1
      self._ring.append(ev)

  def events(self, kind: Optional[str] = None) -> List[Dict]:
    """Snapshot of the ring (newest last), optionally of one ``kind``."""
    with self._lock:
      evs = list(self._ring)
    return evs if kind is None else [e for e in evs if e['kind'] == kind]

  def clear(self) -> None:
    with self._lock:
      self._ring.clear()
      self._ring_dropped = 0

  def stats(self) -> Dict[str, int]:
    with self._lock:
      return {'ring_events': len(self._ring),
              'ring_capacity': self._ring.maxlen,
              'ring_dropped': self._ring_dropped}


#: process-global flight recorder all of the port's instrumentation
#: emits to.
recorder = EventRecorder()
