"""Bounded, thread-safe JSON-lines flight recorder.

The port's copy of the JAX package's `telemetry/recorder.py`.

One `EventRecorder` holds a fixed-size in-memory ring of structured
events and (optionally) appends each event as one JSON line to a file.
Both sides are BOUNDED: the ring by ``max_events`` and the file by
``max_file_events`` — a runaway emitter can never eat the host's RAM or
disk (the "flight recorder" contract: keep the most recent window, drop
the oldest).

Producers call ``recorder.emit('hop.padding', hop=1, fill=0.42, ...)``
from any thread; when recording is off (the default) ``emit`` is a
single attribute check, so instrumentation can stay in hot host paths.

Event wire form (one JSON object per line)::

    {"ts": 1722700000.123, "mono": 12345.678901, "pid": 71,
     "tid": 1393..., "kind": "hop.padding", "hop": 1, ...}

``ts`` is ``time.time()`` at emit — human-readable, but steppable by
NTP; ``mono`` is ``time.monotonic()`` on the same event, the timebase
span durations and trace timelines are computed from (machine-wide on
Linux, so events from cooperating processes on one host order
correctly).  Every other field comes from the emitter.  Values are
coerced to JSON-serializable form; anything that still can't serialize
(bytes, enums, device arrays) degrades to ``repr`` — an event is never
lost to one bad field.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

#: env var: a path here enables the global recorder at import time.
TELEMETRY_ENV = 'GLT_TELEMETRY_JSONL'
#: env var: override the in-memory ring size of the global recorder.
TELEMETRY_EVENTS_ENV = 'GLT_TELEMETRY_EVENTS'

DEFAULT_MAX_EVENTS = 4096
DEFAULT_MAX_FILE_EVENTS = 200_000


def _jsonable(v: Any) -> Any:
  """Coerce numpy / torch scalars to plain python for json.dumps; values
  still unserializable after coercion (bytes, enums, device handles)
  degrade to ``repr`` — ``emit`` runs inside hot paths and must never
  raise out of them, and a degraded field beats a lost event."""
  if v is None or isinstance(v, (bool, int, float, str)):
    return v
  item = getattr(v, 'item', None)
  if item is not None and getattr(v, 'ndim', 0) == 0:
    try:
      return item()
    except Exception:             # noqa: BLE001 — best-effort coercion
      pass
  tolist = getattr(v, 'tolist', None)
  if tolist is not None and not isinstance(v, bytes):
    try:
      return tolist()
    except Exception:             # noqa: BLE001
      pass
  if isinstance(v, (list, tuple, dict)):
    # containers pass through; any unserializable LEAF degrades at
    # dump time (`_safe_dumps`)
    return v
  return repr(v)


def _safe_dumps(ev: Dict) -> str:
  """Serialize an event, degrading rather than raising: default=repr
  covers unserializable leaf VALUES, and the fallback re-dump covers
  what default can't (non-string dict KEYS, circular references) by
  repr-ing whole offending fields — the never-lose-the-event
  contract."""
  try:
    return json.dumps(ev, default=repr)
  except (TypeError, ValueError):
    return json.dumps(
        {k: (v if isinstance(v, (str, int, float, bool, type(None)))
             else repr(v)) for k, v in ev.items()})


class EventRecorder:
  """Bounded thread-safe event ring with an optional JSONL file sink.

  Args:
    path: JSONL file to append events to (None = ring only).
    max_events: in-memory ring capacity (oldest events drop first).
    max_file_events: hard cap on lines written to ``path`` per enable;
      past it the file stops growing (the ring keeps recording).
  """

  def __init__(self, path: Optional[str] = None,
               max_events: int = DEFAULT_MAX_EVENTS,
               max_file_events: int = DEFAULT_MAX_FILE_EVENTS):
    self._lock = threading.Lock()
    self._ring: collections.deque = collections.deque(
        maxlen=max(int(max_events), 1))
    self._path: Optional[str] = None
    self._file = None
    self._file_events = 0
    self._max_file_events = int(max_file_events)
    self._dropped_file_events = 0
    self._ring_dropped = 0
    self._overflow_emitted = False
    self.enabled = False
    if path:
      self.enable(path)

  # -- lifecycle ----------------------------------------------------------
  def enable(self, path: Optional[str] = None,
             max_events: Optional[int] = None,
             max_file_events: Optional[int] = None) -> 'EventRecorder':
    """Turn recording on (optionally into a JSONL file).  Idempotent;
    re-enabling with a different path closes the previous file."""
    with self._lock:
      if max_events is not None:
        self._ring = collections.deque(self._ring,
                                       maxlen=max(int(max_events), 1))
      if max_file_events is not None:
        self._max_file_events = int(max_file_events)
      # reopen on a NEW path, and also on the SAME path when the sink
      # was closed by an emit-time I/O failure (ENOSPC): a re-enable
      # after the operator frees space must resume the file, not
      # silently stay ring-only behind a stale `path` property
      if path is not None and (path != self._path
                               or self._file is None):
        self._close_file_locked()
        self._path = path
        # line-buffered append: each event is one write, so concurrent
        # processes sharing a path interleave at line granularity
        self._file = open(path, 'a', buffering=1)
        self._file_events = 0
      self.enabled = True
    return self

  def disable(self) -> None:
    with self._lock:
      self.enabled = False
      self._close_file_locked()
      self._path = None

  def _close_file_locked(self) -> None:
    if self._file is not None:
      try:
        self._file.close()
      except OSError:
        pass
      self._file = None

  @property
  def path(self) -> Optional[str]:
    return self._path

  # -- emit / read --------------------------------------------------------
  def emit(self, kind: str, **fields) -> None:
    """Record one event.  No-op (one attribute check) when disabled."""
    if not self.enabled:
      return
    # `mono` (time.monotonic) rides next to wall-clock `ts` so span
    # durations and cross-event timelines survive NTP steps/slews;
    # pid/tid put every event on its real process/thread row when
    # several processes append to one JSONL (the Chrome-trace rows)
    ev = {'ts': round(time.time(), 6),
          'mono': round(time.monotonic(), 6),
          'pid': os.getpid(), 'tid': threading.get_ident(),
          'kind': kind}
    for k, v in fields.items():
      ev[k] = _jsonable(v)
    overflow = False
    with self._lock:
      if not self.enabled:        # raced a disable()
        return
      if len(self._ring) == self._ring.maxlen:
        # the deque drops its oldest event on this append — count it
        # (the "did my window silently shrink" question an operator
        # asks an incident ring) and flag the FIRST drop for the
        # one-shot overflow event below
        self._ring_dropped += 1
        if not self._overflow_emitted:
          self._overflow_emitted = True
          overflow = True
      self._ring.append(ev)
      if self._file is not None:
        if self._file_events < self._max_file_events:
          # serialization can't raise (`_safe_dumps` degrades bad
          # fields in place); only a real I/O failure closes the sink
          try:
            self._file.write(_safe_dumps(ev) + '\n')
            self._file_events += 1
          except OSError:
            self._close_file_locked()
        else:
          self._dropped_file_events += 1
    if overflow:
      # one-shot, OUTSIDE the lock (this is a recursive emit; the
      # `_overflow_emitted` flag is already set, so it cannot loop):
      # the event marks WHEN the ring started losing history — the
      # cumulative count lives in `stats()['ring_dropped']` and the
      # `recorder.ring_dropped` live gauge
      self.emit('recorder.overflow', ring_capacity=self._ring.maxlen)

  @property
  def dropped_total(self) -> int:
    """Events lost to in-memory ring overflow since construction or
    the last `clear` (a cleared ring is a fresh window — stale drop
    counts would make a later post-mortem claim a partial window it
    never had)."""
    with self._lock:
      return self._ring_dropped

  def events(self, kind: Optional[str] = None) -> List[Dict]:
    """Snapshot of the in-memory ring (newest last), optionally
    filtered by ``kind``."""
    with self._lock:
      evs = list(self._ring)
    if kind is None:
      return evs
    return [e for e in evs if e['kind'] == kind]

  def clear(self) -> None:
    """Empty the ring and reset the overflow window: drop count and
    the one-shot `recorder.overflow` latch re-arm (the next trace's
    first drop gets its marker again)."""
    with self._lock:
      self._ring.clear()
      self._ring_dropped = 0
      self._overflow_emitted = False

  def dump(self, path: str) -> int:
    """Write the current ring snapshot as JSONL; returns event count."""
    evs = self.events()
    with open(path, 'w') as f:
      for e in evs:
        f.write(_safe_dumps(e) + '\n')
    return len(evs)

  def stats(self) -> Dict[str, int]:
    with self._lock:
      return {'ring_events': len(self._ring),
              'ring_capacity': self._ring.maxlen,
              'ring_dropped': self._ring_dropped,
              'file_events': self._file_events,
              'dropped_file_events': self._dropped_file_events}


def _from_env() -> EventRecorder:
  path = os.environ.get(TELEMETRY_ENV) or None
  try:
    cap = int(os.environ.get(TELEMETRY_EVENTS_ENV, DEFAULT_MAX_EVENTS))
  except ValueError:
    # this runs at package import: a malformed env var must degrade to
    # the default, not take down every `import graphlearn_tpu_torch`
    cap = DEFAULT_MAX_EVENTS
  try:
    return EventRecorder(path=path, max_events=cap)
  except OSError:
    # unwritable JSONL path: degrade to RING-ONLY recording — the
    # user asked for telemetry, so the recorder must still be ON
    rec = EventRecorder(path=None, max_events=cap)
    return rec.enable() if path else rec


#: process-global flight recorder all library instrumentation emits to.
recorder = _from_env()
