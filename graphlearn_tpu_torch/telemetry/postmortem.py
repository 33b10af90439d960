"""Post-mortem flight-recorder bundles — the data plane's black box.

The port's copy of the JAX package's `telemetry/postmortem.py`.  A
serving-executor fault, an ingest fault, a failed scaling action or a
fatal signal leaves no artifact unless something was tee'ing the
recorder to a file; the operator's first question ("what was in
flight?") is unanswerable after the process dies.  With
``GLT_POSTMORTEM_DIR`` set, :func:`dump` writes one self-contained
timestamped JSON bundle at the moment of death:

  * the recorder's in-memory ring (the last ~4096 events — spans in
    flight, faults injected, the final drain windows),
  * a full live-metrics snapshot (counters + evaluated gauges),
  * the ``/healthz`` view (per-component supervision state),
  * the time-series rings when a `TimeSeriesStore` runs,
  * the error and caller-provided context.

``python -m graphlearn_tpu_torch.telemetry.report --postmortem <bundle>``
renders it: spans still open at dump time, event counts over the final
window, the resilience and serving tables, supervision state.

Dumps are one-shot per ``(directory, reason)`` and capped per process,
written atomically (tmp + rename), and NEVER raise into the dying code
path — a failed post-mortem must not mask the original error.
Everything is a no-op (one env read) when ``GLT_POSTMORTEM_DIR`` is
unset.
"""
from __future__ import annotations

import json
import os
import signal as _signal
import threading
import time
from typing import Any, Dict, Optional

POSTMORTEM_DIR_ENV = 'GLT_POSTMORTEM_DIR'

BUNDLE_SCHEMA = 'glt.postmortem.v1'

#: per-process cap across all reasons (a pathological fault storm must
#: not fill the disk with bundles)
_MAX_DUMPS = 16

_lock = threading.Lock()
_dumped: set = set()                 # {(directory, reason)}
_count = 0
_signals_installed = False


def postmortem_dir() -> Optional[str]:
  return os.environ.get(POSTMORTEM_DIR_ENV) or None


def enabled() -> bool:
  return postmortem_dir() is not None


def reset() -> None:
  """Forget one-shot state (tests re-point GLT_POSTMORTEM_DIR)."""
  global _count
  with _lock:
    _dumped.clear()
    _count = 0


def _error_block(error: BaseException) -> Dict[str, Any]:
  out: Dict[str, Any] = {'type': type(error).__name__,
                         'message': str(error)[:2000]}
  for attr in ('scope', 'healthy', 'deadline', 'peer', 'reason',
               'outstanding', 'received', 'expected'):
    v = getattr(error, attr, None)
    if v is not None:
      out[attr] = v if isinstance(v, (str, int, float, bool)) else repr(v)
  return out


def dump(reason: str, error: Optional[BaseException] = None,
         extra: Optional[dict] = None) -> Optional[str]:
  """Write one post-mortem bundle; returns its path (None when
  disabled, already dumped for this reason, or the write failed —
  never raises into the dying code path)."""
  directory = postmortem_dir()
  if directory is None:
    return None
  global _count
  with _lock:
    key = (directory, reason)
    if key in _dumped or _count >= _MAX_DUMPS:
      return None
    _dumped.add(key)
    _count += 1
  try:
    return _write_bundle(directory, reason, error, extra)
  except Exception:                 # noqa: BLE001 — a failed post-
    # mortem must never mask the original fault it documents
    return None


def _write_bundle(directory: str, reason: str,
                  error: Optional[BaseException],
                  extra: Optional[dict]) -> str:
  from .recorder import _safe_dumps, recorder
  # capture the ring BEFORE emitting postmortem.dump, so the bundle
  # holds only the history that led here (the dump event itself goes
  # to the live stream / any JSONL sink)
  events = recorder.events()
  rec_stats = recorder.stats()
  bundle: Dict[str, Any] = {
      'schema': BUNDLE_SCHEMA,
      'reason': reason,
      'ts': round(time.time(), 6),
      'mono': round(time.monotonic(), 6),
      'pid': os.getpid(),
  }
  if error is not None:
    bundle['error'] = _error_block(error)
  if extra:
    bundle['extra'] = extra
  try:
    from .live import live
    bundle['metrics'] = live.snapshot()
    bundle['health'] = live.healthz()
  except Exception as e:            # noqa: BLE001 — a broken gauge
    # callback must not cost the operator the event ring
    bundle['metrics_error'] = f'{type(e).__name__}: {e}'
  try:
    # the history rings: a crash dump shows burn-rate / queue depth /
    # ingest lag leading INTO the incident, not just the final sample
    from . import timeseries
    store = timeseries.global_store()
    if store is not None:
      bundle['timeseries'] = store.query()
  except Exception as e:            # noqa: BLE001 — same contract
    bundle['timeseries_error'] = f'{type(e).__name__}: {e}'
  bundle['recorder'] = rec_stats
  bundle['events'] = events
  os.makedirs(directory, exist_ok=True)
  stamp = time.strftime('%Y%m%dT%H%M%S', time.gmtime())
  name = (f'postmortem-{stamp}-{os.getpid()}-'
          f'{reason.replace(".", "_").replace("/", "_")}.json')
  path = os.path.join(directory, name)
  tmp = path + '.tmp'
  with open(tmp, 'w') as f:
    # event dicts already passed the recorder's jsonable coercion;
    # _safe_dumps degrades anything that still can't serialize
    f.write(_safe_dumps(bundle))
  os.replace(tmp, path)             # atomic publish: no torn bundles
  try:
    from .live import metrics
    metrics.inc('postmortem.dumps_total')
    recorder.emit('postmortem.dump', reason=reason, path=path,
                  events=len(events),
                  error=(f'{type(error).__name__}: {error}'[:200]
                         if error is not None else None))
  except Exception:                 # noqa: BLE001 — best-effort
    pass
  return path


def load_bundle(path: str) -> dict:
  """Read a bundle back (the report CLI's ``--postmortem`` input)."""
  with open(path) as f:
    obj = json.load(f)
  if obj.get('schema') != BUNDLE_SCHEMA:
    raise ValueError(
        f'{path} is not a post-mortem bundle (schema '
        f'{obj.get("schema")!r}, expected {BUNDLE_SCHEMA!r})')
  return obj


def install_signal_handlers(signums=(getattr(_signal, 'SIGTERM', None),)
                            ) -> bool:
  """Chain a dump-then-previous handler on fatal signals (the
  preemption path: SIGTERM from the scheduler).  Idempotent; only
  works from the main thread (callers off it get False, not a raise);
  a no-op unless ``GLT_POSTMORTEM_DIR`` is set."""
  global _signals_installed
  if not enabled():
    return False
  with _lock:
    if _signals_installed:
      return True
  handlers = {}

  def _make(prev, signum):
    def _handler(sig, frame):
      # dump on a HELPER thread with a bounded join, never inline:
      # the handler interrupts the main thread mid-bytecode, and if
      # that thread holds recorder._lock / Metrics._lock (emit runs
      # constantly), an inline dump would block on its own thread's
      # non-reentrant lock forever — the process would neither write
      # the bundle nor die.  Off-thread, a held lock merely costs
      # the bundle (join times out) and termination proceeds.
      reason = f'signal.{_signal.Signals(signum).name.lower()}'
      t = threading.Thread(target=dump, args=(reason,), daemon=True)
      t.start()
      t.join(10.0)
      if callable(prev):
        prev(sig, frame)
      elif prev is None or prev == _signal.SIG_DFL:
        # restore + re-raise so the process still dies with the
        # default disposition (exit code, core) the operator expects.
        # `None` = a handler installed OUTSIDE Python (embedded
        # interpreter / C launcher): we cannot chain to it, but
        # swallowing the signal would hang the preempted process —
        # default-and-die is the honest fallback.
        _signal.signal(signum, _signal.SIG_DFL)
        os.kill(os.getpid(), signum)
    return _handler

  try:
    for signum in signums:
      if signum is None:
        continue
      prev = _signal.getsignal(signum)
      handlers[signum] = prev
      _signal.signal(signum, _make(prev, signum))
  except ValueError:
    # not the main thread: signal.signal refuses before any handler
    # was replaced (it raises on the FIRST call), so nothing to undo
    return False
  with _lock:
    _signals_installed = True
  return True
