"""Post-mortem flight-recorder bundles.

The port's copy of `dump` from the JAX package's
`telemetry/postmortem.py`.  With ``GLT_POSTMORTEM_DIR`` set, `dump`
writes one timestamped JSON bundle: the recorder's ring, a live-metrics
snapshot, the ``healthz`` view, the error and the caller's context.
Dumps are one-shot per ``(directory, reason)``, capped per process,
written atomically (tmp + rename) and never raise into the dying code
path.  Without the env var `dump` is a no-op.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

POSTMORTEM_DIR_ENV = 'GLT_POSTMORTEM_DIR'

BUNDLE_SCHEMA = 'glt.postmortem.v1'

#: per-process cap across all reasons
_MAX_DUMPS = 16

_lock = threading.Lock()
_dumped: set = set()                 # {(directory, reason)}
_count = 0


def postmortem_dir() -> Optional[str]:
  return os.environ.get(POSTMORTEM_DIR_ENV) or None


def reset() -> None:
  """Forget the one-shot state (tests re-point GLT_POSTMORTEM_DIR)."""
  global _count
  with _lock:
    _dumped.clear()
    _count = 0


def dump(reason: str, error: Optional[BaseException] = None,
         extra: Optional[dict] = None) -> Optional[str]:
  """Write one bundle; returns its path, or None when disabled, already
  dumped for this reason, or the write failed."""
  directory = postmortem_dir()
  if directory is None:
    return None
  global _count
  with _lock:
    if (directory, reason) in _dumped or _count >= _MAX_DUMPS:
      return None
    _dumped.add((directory, reason))
    _count += 1
  try:
    return _write_bundle(directory, reason, error, extra)
  except Exception:                 # noqa: BLE001 — never mask the fault
    return None


def _write_bundle(directory: str, reason: str,
                  error: Optional[BaseException],
                  extra: Optional[dict]) -> str:
  from .live import live, metrics
  from .recorder import _safe_dumps, recorder
  bundle: Dict[str, Any] = {
      'schema': BUNDLE_SCHEMA, 'reason': reason,
      'ts': round(time.time(), 6), 'mono': round(time.monotonic(), 6),
      'pid': os.getpid()}
  if error is not None:
    bundle['error'] = {'type': type(error).__name__,
                       'message': str(error)[:2000]}
  if extra:
    bundle['extra'] = extra
  bundle['metrics'] = live.snapshot()
  bundle['health'] = live.healthz()
  bundle['recorder'] = recorder.stats()
  bundle['events'] = recorder.events()
  os.makedirs(directory, exist_ok=True)
  stamp = time.strftime('%Y%m%dT%H%M%S', time.gmtime())
  name = (f'postmortem-{stamp}-{os.getpid()}-'
          f'{reason.replace(".", "_").replace("/", "_")}.json')
  path = os.path.join(directory, name)
  with open(path + '.tmp', 'w') as f:
    f.write(_safe_dumps(bundle))
  os.replace(path + '.tmp', path)   # atomic publish: no torn bundles
  metrics.inc('postmortem.dumps_total')
  recorder.emit('postmortem.dump', reason=reason, path=path,
                events=len(bundle['events']))
  return path
