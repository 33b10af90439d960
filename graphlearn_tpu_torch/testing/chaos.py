"""Seeded, declarative fault injection.

The port's copy of the JAX package's `testing/chaos.py`, reduced to the
seams the port fires.  A *fault plan* is a list of
:class:`Fault` records naming a **site** (a seam the code calls into),
an **action**, and the ``nth`` matching arrival at that seam on which
it fires (counted per fault — deterministic under a fixed plan).  The
plan syntax is the JAX package's, so a plan written for one package
reads the same in the other.  Sites and actions:

  ``checkpoint.io``
      Inside `utils.checkpoint.Checkpointer.save`.  ``fail`` (the write
      dies before any byte lands), ``truncate`` (a partial tmp write,
      then death before the atomic publish).
  ``ingest.wal``
      Inside `streaming.wal.WriteAheadLog.append`.  ``fail`` (the
      append dies before any byte lands), ``truncate`` (half a record
      lands, then the process "dies"; the next open truncates the torn
      tail).
  ``ingest.apply``
      Inside `streaming.ingest.IngestPipeline`, between the durable WAL
      append and the in-memory commit.  ``kill`` raises
      :class:`ChaosKilledError` (logged but not applied; a restart
      replays it exactly once), ``delay`` sleeps ``secs``.
  ``ingest.compact``
      Inside `IngestPipeline.compact`, before the snapshot publishes.
      ``kill`` raises :class:`ChaosKilledError`.
  ``feature.cold_service``
      Inside `data.Feature.get`, on a lookup of a mixed table that
      needs the host cold tier (``op`` is ``'feature'``).  ``fail``
      raises :class:`InjectedFault`: the cold tier died under the
      batch.

Plans install programmatically (:func:`install`) or from the
``GLT_FAULT_PLAN`` env var.  JSON::

    {"faults": [{"site": "ingest.apply", "action": "kill", "nth": 3}]}

or the compact form ``site:action:nth[:key=val...]`` joined by ``;``.
Without a plan every seam is one module-attribute check.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

FAULT_PLAN_ENV = 'GLT_FAULT_PLAN'

_SITES = ('checkpoint.io', 'ingest.wal', 'ingest.apply', 'ingest.compact',
          'feature.cold_service')
_ACTIONS = ('delay', 'kill', 'fail', 'truncate')


class InjectedFault(RuntimeError):
  """A chaos ``fail``/``truncate`` fired: the real-world analog (disk
  error, a kill mid-write) raised mid-operation."""


class ChaosKilledError(RuntimeError):
  """A planned ``kill`` fired — the in-process stand-in for a process
  death.  The test must resume from durable state in a fresh object."""


@dataclass
class Fault:
  """One planned fault: fire ``count`` times starting at the ``nth``
  matching arrival (1-based) at ``site``."""
  site: str
  action: str
  nth: int = 1
  count: int = 1
  op: Optional[str] = None
  secs: float = 0.1               # delay duration
  _seen: int = field(default=0, repr=False, compare=False)

  def __post_init__(self):
    if self.site not in _SITES:
      raise ValueError(f'unknown fault site {self.site!r} '
                       f'(expected one of {_SITES})')
    if self.action not in _ACTIONS:
      raise ValueError(f'unknown fault action {self.action!r} '
                       f'(expected one of {_ACTIONS})')


class ChaosPlan:
  """A set of faults; arrival counting is per fault, under a lock."""

  def __init__(self, faults: List[Fault]):
    self.faults = list(faults)
    self._lock = threading.Lock()

  def on(self, site: str, **ctx) -> List[Fault]:
    """Record one arrival at ``site``; return the faults that fire."""
    fired = []
    with self._lock:
      for f in self.faults:
        if f.site != site or (f.op is not None and ctx.get('op') != f.op):
          continue
        f._seen += 1
        if f.nth <= f._seen < f.nth + f.count:
          fired.append(f)
    if fired:
      from ..telemetry.recorder import recorder
      for f in fired:
        recorder.emit('fault.injected', site=site, action=f.action,
                      nth=f.nth, arrival=f._seen, op=ctx.get('op'))
    return fired


def parse_plan(spec) -> ChaosPlan:
  """A plan from a dict / list / JSON string / compact string (a plan's
  ``seed`` is accepted and unused: no seam here draws at random)."""
  if isinstance(spec, ChaosPlan):
    return spec
  if isinstance(spec, str):
    s = spec.strip()
    if not s.startswith(('{', '[')):
      return ChaosPlan([_parse_compact(p) for p in s.split(';')
                        if p.strip()])
    spec = json.loads(s)
  if isinstance(spec, dict):
    spec = spec.get('faults', [])
  return ChaosPlan([f if isinstance(f, Fault) else Fault(**f)
                    for f in spec])


def _parse_compact(part: str) -> Fault:
  toks = part.strip().split(':')
  if len(toks) < 2:
    raise ValueError(f'bad compact fault {part!r}: need site:action')
  kw: Dict[str, Any] = {'site': toks[0], 'action': toks[1]}
  if len(toks) > 2 and toks[2]:
    kw['nth'] = int(toks[2])
  for tok in toks[3:]:
    if '=' not in tok:
      raise ValueError(f'bad compact fault field {tok!r} in {part!r}')
    k, v = tok.split('=', 1)
    kw[k] = int(v) if k in ('nth', 'count') else (
        float(v) if k == 'secs' else v)
  return Fault(**kw)


# -- process-global plan ----------------------------------------------------
_plan: Optional[ChaosPlan] = None
_env_checked = False
_install_lock = threading.Lock()


def install(spec) -> ChaosPlan:
  """Install ``spec`` as the process's active plan (replacing any)."""
  global _plan, _env_checked
  with _install_lock:
    _plan = parse_plan(spec)
    _env_checked = True
  return _plan


def uninstall() -> None:
  """Deactivate chaos for this process."""
  global _plan, _env_checked
  with _install_lock:
    _plan = None
    _env_checked = True


def active() -> Optional[ChaosPlan]:
  """The process's plan, lazily read from ``GLT_FAULT_PLAN``."""
  global _plan, _env_checked
  if _plan is None and not _env_checked:
    with _install_lock:
      if _plan is None and not _env_checked:
        _env_checked = True
        spec = os.environ.get(FAULT_PLAN_ENV)
        if spec:
          _plan = parse_plan(spec)
  return _plan


# -- seams ------------------------------------------------------------------
def on(site: str, **ctx) -> List[Fault]:
  """The generic seam: no-op (one global read) without a plan."""
  p = active()
  return p.on(site, **ctx) if p is not None else []


def ingest_wal_faults(op: str = 'append') -> List[str]:
  """WAL seam, once per append: ``fail`` raises `InjectedFault` before
  any byte is written; ``truncate`` is returned so the writer lands a
  partial record and then raises."""
  actions = [f.action for f in on('ingest.wal', op=op)]
  if 'fail' in actions:
    raise InjectedFault(f'injected WAL append failure (op {op!r})')
  return actions


def ingest_apply_check(seqno: int = 0) -> None:
  """Delta-apply seam, between the durable append and the commit:
  ``kill`` raises `ChaosKilledError`, ``delay`` sleeps in place."""
  for f in on('ingest.apply', seqno=int(seqno)):
    if f.action == 'delay':
      time.sleep(f.secs)
    elif f.action == 'kill':
      raise ChaosKilledError(f'injected ingest apply kill (seqno {seqno})')


def ingest_compact_check(seqno: int = 0) -> None:
  """Compaction seam, before the snapshot publishes: ``kill`` raises
  `ChaosKilledError`."""
  for f in on('ingest.compact', seqno=int(seqno)):
    if f.action == 'kill':
      raise ChaosKilledError(
          f'injected ingest compaction kill (seqno {seqno})')


def cold_service_check(scope: str = '') -> None:
  """Host cold-tier seam, once per lookup that needs the cold tier:
  ``fail`` raises `InjectedFault`."""
  for f in on('feature.cold_service', op=scope or None):
    if f.action == 'fail':
      raise InjectedFault(
          f'injected cold-tier service failure (scope {scope!r})')
