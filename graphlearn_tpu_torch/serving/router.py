"""Fleet router: replica failover with exactly-once request redrive.

The port's copy of the JAX package's `serving/router.py`.  The
`FleetRouter` spreads traffic over N replicas and makes replica loss,
overload and the hot-swap cutover invisible to callers:

  * **health-classified routing** — the router polls each replica's
    ``heartbeat()`` serving block and classifies it ``healthy`` /
    ``overloaded`` (deep queue or slow heartbeat: kept in rotation at
    reduced weight, since a slow replica still serves) / ``draining``
    (mid-hot-swap: skipped for new traffic, not evicted) / ``dead``
    (consecutive heartbeat misses: evicted).  A replica that comes back
    is re-admitted on its next good heartbeat, unless it flapped
    dead→healthy 3 times inside ``GLT_FLEET_FLAP_WINDOW_S``: then it is
    ``quarantined`` (weight 0) and re-admitted only after an
    exponential backoff.
  * **exactly-once redrive** — every routed request sits in an in-flight
    ledger until its future resolves.  When a replica is evicted, its
    unresolved requests are redriven onto a survivor at most once each
    (the ledger's ``redriven`` bit); a second loss resolves the future
    with a typed `distributed.resilience.FailoverExhausted`.  Nothing is
    silently dropped and nothing is double-answered.
  * **typed door decisions** — an ``AdmissionRejected`` with reason
    ``queue_full``, ``draining`` or ``shutdown`` makes the router try
    the next replica; only when every replica refuses does the
    rejection reach the caller.

Chaos site ``serving.replica`` (kill / delay / flap) drives the
kill-one-replica runs.  Knobs: ``GLT_FLEET_HEARTBEAT_MS``,
``GLT_FLEET_OVERLOAD_RATIO`` and ``GLT_FLEET_FLAP_WINDOW_S``.

Not ported: `RemoteReplica` (a replica behind the host runtime's RPC,
ROADMAP item 11), the federation scraper and the router's request-trace
spans (telemetry, ROADMAP item 13).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..distributed.resilience import FailoverExhausted, ReplicaLostError
from ..telemetry.live import live
from ..telemetry.recorder import recorder
from .admission import (AdmissionRejected, ServingFuture, _env_pos,
                        drain_retry_ms_from_env)

HEARTBEAT_ENV = 'GLT_FLEET_HEARTBEAT_MS'
OVERLOAD_ENV = 'GLT_FLEET_OVERLOAD_RATIO'
FLAP_WINDOW_ENV = 'GLT_FLEET_FLAP_WINDOW_S'

DEFAULT_HEARTBEAT_MS = 200.0
DEFAULT_OVERLOAD_RATIO = 0.8
DEFAULT_FLAP_WINDOW_S = 10.0

#: dead→healthy readmits inside the flap window before quarantine
_FLAP_QUARANTINE_COUNT = 3

#: replica states (the classification vocabulary of `check_replicas`)
REPLICA_STATES = ('healthy', 'overloaded', 'draining', 'quarantined',
                  'dead')

#: scheduling weight per state: healthy replicas are picked 4x as often
#: as overloaded ones; draining, quarantined and dead get no new traffic
_STATE_WEIGHT = {'healthy': 4, 'overloaded': 1, 'draining': 0,
                 'quarantined': 0, 'dead': 0}


def heartbeat_ms_from_env() -> float:
  return _env_pos(HEARTBEAT_ENV, DEFAULT_HEARTBEAT_MS, float)


def flap_window_s_from_env() -> float:
  return _env_pos(FLAP_WINDOW_ENV, DEFAULT_FLAP_WINDOW_S, float)


def overload_ratio_from_env() -> float:
  v = _env_pos(OVERLOAD_ENV, DEFAULT_OVERLOAD_RATIO, float)
  return v if v <= 1 else DEFAULT_OVERLOAD_RATIO


class LocalReplica:
  """In-process replica handle over a `ServingFrontend` (N engines in
  one process).  `kill` freezes the frontend's executor cold: its
  queued requests never resolve, the lost-process failure the router's
  redrive exists for (unlike `ServingFrontend.shutdown`, which resolves
  everything typed).  The ``serving.replica`` chaos seam fires on each
  ``submit`` and ``heartbeat``."""

  def __init__(self, name: str, frontend):
    self.name = name
    self.frontend = frontend
    self._dead = False
    self._flap_until = 0.0
    if not getattr(frontend, 'name', ''):
      frontend.name = name          # the executor's chaos seam targets it

  def _chaos(self, op: str) -> None:
    from ..testing import chaos
    for f in chaos.replica_faults(self.name, op):
      if f.action == 'kill':
        self.kill()
      elif f.action == 'flap':
        self._flap_until = time.monotonic() + f.secs

  def reachable(self) -> bool:
    return not self._dead and time.monotonic() >= self._flap_until

  def submit(self, seeds,
             deadline_ms: Optional[float] = None) -> ServingFuture:
    self._chaos('submit')
    if not self.reachable():
      raise ReplicaLostError(f'replica {self.name!r} is unreachable',
                             replica=self.name)
    return self.frontend.submit(seeds, deadline_ms)

  def heartbeat(self) -> Optional[dict]:
    self._chaos('heartbeat')
    if not self.reachable():
      return None
    return {'serving': self.frontend.stats()}

  def kill(self) -> None:
    # freeze, don't drain: nothing queued or taken resolves, as in a
    # killed process; its exporters go away too
    self._dead = True
    self.frontend._frozen = True
    self.frontend._closed = True
    self.frontend._unregister_observability()

  def close(self) -> None:
    if not self._dead:
      self.frontend.shutdown()


class RemoteReplica:
  """A replica behind the host runtime's serving RPC: not ported."""

  def __init__(self, *args, **kwargs):
    raise NotImplementedError(
        'RemoteReplica needs the host runtime (DistClient.serve), ROADMAP '
        'item 11; use LocalReplica')


class _LedgerEntry:
  """One routed, unresolved request."""

  __slots__ = ('rid', 'seeds', 'deadline_ms', 'replica', 'inner',
               'redriven', 'generation', 'error', 'error_at')

  def __init__(self, rid: int, seeds, deadline_ms, replica: str,
               inner: ServingFuture):
    self.rid = rid
    self.seeds = seeds
    self.deadline_ms = deadline_ms
    self.replica = replica
    self.inner = inner
    self.redriven = False
    self.generation = 0
    self.error: Optional[BaseException] = None
    self.error_at: Optional[float] = None

  def set_error(self, err: BaseException) -> None:
    self.error = err
    self.error_at = time.monotonic()

  def abandoned(self, now: float, grace_s: float) -> bool:
    """Resolved (inner done, or a terminal router error) but unconsumed
    for longer than ``grace_s``: the caller walked away."""
    done_at = self.error_at if self.error is not None \
        else self.inner.done_monotonic
    return done_at is not None and (now - done_at) > grace_s


class RouterFuture:
  """A routed request's pending result.  `result` follows the ledger: a
  redrive mid-wait moves the wait to the new replica's future; a
  terminal router decision (`FailoverExhausted`) raises typed.
  ``done_monotonic`` is the inner future's resolve stamp, captured at
  `result` (which consumes the ledger entry)."""

  __slots__ = ('_router', '_rid', 'done_monotonic')

  def __init__(self, router: 'FleetRouter', rid: int):
    self._router = router
    self._rid = rid
    self.done_monotonic: Optional[float] = None

  def done(self) -> bool:
    entry = self._router._entry(self._rid)
    return entry is None or entry.error is not None or entry.inner.done()

  def result(self, timeout: Optional[float] = None):
    deadline = time.monotonic() + (timeout if timeout is not None
                                   else 3600.0)
    while True:
      entry = self._router._entry(self._rid)
      if entry is None:
        raise RuntimeError('router future already consumed (or swept as '
                           'abandoned after '
                           f'{self._router.abandon_grace_s:.0f}s '
                           'unconsumed)')
      if entry.error is not None:
        self._router._finish(self._rid, 'error')
        raise entry.error
      remaining = deadline - time.monotonic()
      if remaining <= 0:
        raise TimeoutError('fleet request still in flight')
      try:
        # short slices: a redrive re-points entry.inner while we wait
        res = entry.inner.result(min(0.05, remaining))
      except TimeoutError:
        continue
      except AdmissionRejected:
        self._router._finish(self._rid, 'shed')
        raise
      except BaseException:
        self._router._finish(self._rid, 'error')
        raise
      self.done_monotonic = (entry.inner.done_monotonic
                             or time.monotonic())
      self._router._finish(self._rid, 'ok')
      return res


class FleetRouter:
  """Health-routed fan-in over N replica handles (see the module doc).

  Args:
    replicas: handles with ``name`` / ``submit`` / ``heartbeat`` /
      ``close`` (`LocalReplica`).
    heartbeat_ms: monitor cadence (else ``GLT_FLEET_HEARTBEAT_MS``).
    overload_ratio: queue_depth/max_queue at or above which a replica is
      overloaded (else ``GLT_FLEET_OVERLOAD_RATIO``).
    slow_ms: a heartbeat slower than this classifies the replica
      overloaded (alive but struggling: reduced weight, not evicted).
    dead_after: consecutive heartbeat misses before eviction.
    abandon_grace_s: resolved but uncollected ledger entries older than
      this are swept.
    flap_window_s: sliding window of the flap damper (else
      ``GLT_FLEET_FLAP_WINDOW_S``).
    quarantine_backoff_s: base of the exponential re-admit backoff
      (doubles per quarantine of the same replica).
    auto_start: run the heartbeat monitor thread.  Tests pass False
      and pump `check_replicas`.
  """

  def __init__(self, replicas: List, heartbeat_ms: Optional[float] = None,
               overload_ratio: Optional[float] = None,
               slow_ms: float = 250.0, dead_after: int = 2,
               abandon_grace_s: float = 300.0,
               flap_window_s: Optional[float] = None,
               quarantine_backoff_s: float = 1.0,
               auto_start: bool = True):
    if not replicas:
      raise ValueError('FleetRouter needs at least one replica')
    self._lock = threading.Lock()
    #: name -> {'handle', 'state', 'misses', 'hb', 'hb_ms', 'readmits',
    #: 'quarantines', 'quarantine_until'}: the routing truth
    self._replicas: Dict[str, dict] = {  # guarded-by: self._lock
        r.name: self._new_entry(r) for r in replicas}
    if len(self._replicas) != len(replicas):
      raise ValueError('replica names must be unique')
    #: the exactly-once redrive ledger: rid -> entry, pruned on resolve
    self._ledger: Dict[int, _LedgerEntry] = {}  # guarded-by: self._lock
    self._next_rid = 0              # guarded-by: self._lock
    self._rr = 0                    # guarded-by: self._lock
    self._cycle: List[str] = []     # guarded-by: self._lock
    self.heartbeat_ms = (heartbeat_ms if heartbeat_ms is not None
                         else heartbeat_ms_from_env())
    self.overload_ratio = (overload_ratio if overload_ratio is not None
                           else overload_ratio_from_env())
    self.slow_ms = float(slow_ms)
    self.dead_after = int(dead_after)
    self.abandon_grace_s = float(abandon_grace_s)
    self.swept = 0                  # guarded-by: self._lock
    #: submitted == resolved ok + shed + error + in the ledger
    self.submitted = 0              # guarded-by: self._lock
    self.resolved = {'ok': 0, 'shed': 0, 'error': 0}  # guarded-by: _lock
    self.redriven = 0               # guarded-by: self._lock
    self.evictions = 0              # guarded-by: self._lock
    self.quarantines = 0            # guarded-by: self._lock
    self.flap_window_s = (flap_window_s if flap_window_s is not None
                          else flap_window_s_from_env())
    self.quarantine_backoff_s = float(quarantine_backoff_s)
    self._rebuild_cycle_locked()
    self._closed = False
    self._monitor: Optional[threading.Thread] = None
    self._m_redrives = live.counter('fleet.redrives_total')
    self._m_evictions = live.counter('fleet.evictions_total')
    self._m_quarantines = live.counter('fleet.quarantines_total')
    self._gauge_regs = []
    for st in REPLICA_STATES:
      fn = self._state_count_fn(st)
      live.gauge('fleet.replicas', labels={'state': st}, fn=fn)
      self._gauge_regs.append(('fleet.replicas', {'state': st}, fn))
    self._health_fn = self._health
    live.register_health('fleet', self._health_fn)
    if auto_start:
      self.start()

  # -- lifecycle ------------------------------------------------------------
  def start(self) -> None:
    if self._monitor is not None:
      return
    self._monitor = threading.Thread(target=self._monitor_loop,
                                     daemon=True, name='glt-fleet-monitor')
    self._monitor.start()

  def close(self, close_replicas: bool = False) -> None:
    self._closed = True
    t = self._monitor
    if t is not None:
      t.join(self.heartbeat_ms / 1e3 + 5.0)
    self._monitor = None
    live.unregister_health('fleet', fn=self._health_fn)
    for name, labels, fn in self._gauge_regs:
      live.unregister_gauge(name, labels, fn=fn)
    if close_replicas:
      with self._lock:
        handles = [e['handle'] for e in self._replicas.values()]
      for h in handles:
        h.close()

  @staticmethod
  def _new_entry(handle) -> dict:
    return {'handle': handle, 'state': 'healthy', 'misses': 0,
            'hb': None, 'hb_ms': None, 'readmits': [],
            'quarantines': 0, 'quarantine_until': 0.0}

  # -- elastic membership ---------------------------------------------------
  def add_replica(self, handle) -> None:
    """Admit a new replica into rotation at full weight (the elastic
    scale-out seam: the caller verified it first)."""
    with self._lock:
      if handle.name in self._replicas:
        raise ValueError(f'replica {handle.name!r} already registered')
      self._replicas[handle.name] = self._new_entry(handle)
      self._rebuild_cycle_locked()

  def remove_replica(self, name: str):
    """Retire a replica from rotation (elastic scale-in), redriving
    anything still stranded in its lane (a quiesced drain leaves
    nothing).  Returns the handle (the caller owns its shutdown), None
    if unknown."""
    with self._lock:
      ent = self._replicas.pop(name, None)
      if ent is None:
        return None
      self._rebuild_cycle_locked()
      stranded = [e for e in self._ledger.values()
                  if e.replica == name and e.error is None
                  and not e.inner.done()]
    moved = sum(1 for entry in stranded if self._redrive(entry, lost=name))
    recorder.emit('serving.failover', replica=name, event='retire',
                  state='removed', redriven=moved)
    return ent['handle']

  def _monitor_loop(self) -> None:
    while not self._closed:
      try:
        self.check_replicas()
      except Exception:             # noqa: BLE001 — the monitor must
        # outlive any single bad heartbeat
        pass
      time.sleep(self.heartbeat_ms / 1e3)

  # -- routing --------------------------------------------------------------
  def _rebuild_cycle_locked(self) -> None:
    cycle: List[str] = []
    for name, ent in self._replicas.items():
      cycle.extend([name] * _STATE_WEIGHT[ent['state']])
    self._cycle = cycle

  def _pick_order(self) -> List[str]:
    """Routing candidates, weighted round robin: the rotation pointer
    spreads consecutive requests."""
    with self._lock:
      cycle = self._cycle
      if not cycle:
        return []
      start = self._rr % len(cycle)
      self._rr += 1
      rotated = cycle[start:] + cycle[:start]
    seen, order = set(), []
    for name in rotated:
      if name not in seen:
        seen.add(name)
        order.append(name)
    return order

  def submit(self, seeds,
             deadline_ms: Optional[float] = None) -> RouterFuture:
    """Route one request onto a replica; returns its `RouterFuture`.
    Door rejections another replica could absorb reroute; a replica
    that errors at the door is counted a miss and skipped.  Raises the
    last typed rejection (or `FailoverExhausted`) only when every
    replica refused."""
    last_err: Optional[BaseException] = None
    for name in self._pick_order():
      with self._lock:
        ent = self._replicas.get(name)
        handle = ent['handle'] if ent else None
      if handle is None:
        continue
      try:
        inner = handle.submit(seeds, deadline_ms)
      except AdmissionRejected as e:
        if e.reason in ('queue_full', 'draining', 'shutdown'):
          last_err = e
          continue                   # reroutable door rejection
        raise
      except ValueError:
        raise                        # a malformed request: the client's
        # error, charged to no replica
      except Exception as e:        # noqa: BLE001 — door failure: a miss
        last_err = e
        self._note_miss(name)
        continue
      with self._lock:
        rid = self._next_rid
        self._next_rid += 1
        entry = _LedgerEntry(rid, np.asarray(seeds), deadline_ms, name,
                             inner)
        self._ledger[rid] = entry
        self.submitted += 1
        # the submit/evict race: an eviction between handle.submit and
        # this insert missed the entry, so redrive it here
        ent = self._replicas.get(name)
        evicted_in_window = ent is None or ent['state'] == 'dead'
      if evicted_in_window and not inner.done():
        self._redrive(entry, lost=name)
      return RouterFuture(self, rid)
    if isinstance(last_err, AdmissionRejected):
      raise last_err
    states = self.replica_states()
    if (any(s == 'draining' for s in states.values())
        and not any(s in ('healthy', 'overloaded')
                    for s in states.values())):
      # every live replica is mid-cutover: the draining arm with its
      # retry hint, not a fleet-wide outage
      hint = drain_retry_ms_from_env()
      raise AdmissionRejected(
          'every live replica is draining for a hot swap — retry after '
          f'~{hint:.0f}ms', reason='draining',
          retry_after_ms=hint) from last_err
    raise FailoverExhausted(
        f'no replica accepted the request (states: {states})'
        ) from last_err

  def infer(self, seeds, deadline_ms: Optional[float] = None,
            timeout: float = 30.0):
    """Blocking submit + wait."""
    return self.submit(seeds, deadline_ms).result(timeout)

  # -- ledger ---------------------------------------------------------------
  def _entry(self, rid: int) -> Optional[_LedgerEntry]:
    with self._lock:
      return self._ledger.get(rid)

  def _finish(self, rid: int, outcome: str) -> None:
    with self._lock:
      if self._ledger.pop(rid, None) is not None:
        self.resolved[outcome] += 1

  # -- health classification ------------------------------------------------
  def _note_miss(self, name: str) -> None:
    with self._lock:
      ent = self._replicas.get(name)
      if ent is None:
        return
      ent['misses'] += 1
      evict = ent['misses'] >= self.dead_after and ent['state'] != 'dead'
    if evict:
      self._evict(name)

  def _classify_locked(self, hb: dict, hb_ms: float) -> str:
    serving = (hb or {}).get('serving') or {}
    if serving.get('draining'):
      return 'draining'
    if hb_ms > self.slow_ms:
      return 'overloaded'           # alive but slow: reduced weight
    depth, max_q = serving.get('queue_depth'), serving.get('max_queue')
    if depth is not None and max_q and depth / max_q >= self.overload_ratio:
      return 'overloaded'
    return 'healthy'

  def check_replicas(self) -> Dict[str, str]:
    """One monitor pass: heartbeat every replica, reclassify, evict the
    dead (redriving their in-flight requests), re-admit returned
    flappers, sweep abandoned ledger entries.  Returns the state map."""
    with self._lock:
      names = list(self._replicas)
    for name in names:
      with self._lock:
        ent = self._replicas.get(name)
        handle = ent['handle'] if ent else None
      if handle is None:
        continue
      t0 = time.monotonic()
      try:
        hb = handle.heartbeat()
      except Exception:             # noqa: BLE001 — unreachable
        hb = None
      hb_ms = 1e3 * (time.monotonic() - t0)
      if hb is None or (hb.get('serving') or {}).get('closed'):
        # a cleanly shut-down frontend still answers (queue 0, not
        # draining): a miss, so it leaves rotation
        self._note_miss(name)
        continue
      now = time.monotonic()
      quarantined = readmitted = False
      with self._lock:
        ent = self._replicas.get(name)
        if ent is None:
          continue
        ent['misses'] = 0
        ent['hb'] = hb
        ent['hb_ms'] = round(hb_ms, 3)
        was = ent['state']
        if was == 'quarantined' and now < ent['quarantine_until']:
          continue                   # backoff running: no free readmit
        ent['state'] = self._classify_locked(hb, hb_ms)
        readmitted = was in ('dead', 'quarantined')
        if readmitted and was == 'dead':
          # flap damping: the readmit history is not cleared on
          # quarantine, so a replica that flaps again right after
          # re-admission re-quarantines at a doubled backoff
          ent['readmits'] = [t for t in ent['readmits']
                             if now - t <= self.flap_window_s]
          ent['readmits'].append(now)
          if len(ent['readmits']) >= _FLAP_QUARANTINE_COUNT:
            ent['state'] = 'quarantined'
            ent['quarantines'] += 1
            ent['quarantine_until'] = now + self.quarantine_backoff_s \
                * (2 ** (ent['quarantines'] - 1))
            self.quarantines += 1
            quarantined, readmitted = True, False
        state = ent['state']
        self._rebuild_cycle_locked()
      if quarantined:
        self._m_quarantines.inc()
        recorder.emit('serving.failover', replica=name,
                      event='quarantine', state='quarantined', redriven=0)
      elif readmitted:
        recorder.emit('serving.failover', replica=name, event='readmit',
                      state=state, redriven=0)
    now = time.monotonic()
    with self._lock:
      for rid in [rid for rid, e in self._ledger.items()
                  if e.abandoned(now, self.abandon_grace_s)]:
        del self._ledger[rid]
        self.swept += 1
    return self.replica_states()

  def replica_states(self) -> Dict[str, str]:
    with self._lock:
      return {n: e['state'] for n, e in self._replicas.items()}

  def heartbeats(self) -> Dict[str, dict]:
    """Per-replica state and last heartbeat ``serving`` block: the
    `ElasticController`'s signal feed."""
    with self._lock:
      return {n: {'state': e['state'],
                  'serving': (e['hb'] or {}).get('serving')}
              for n, e in self._replicas.items()}

  def get_replica(self, name: str):
    """The named replica's handle (None if unknown)."""
    with self._lock:
      ent = self._replicas.get(name)
      return ent['handle'] if ent else None

  # -- failover -------------------------------------------------------------
  def _evict(self, name: str) -> None:
    """Take a replica past the dead threshold out of rotation and
    redrive its unresolved in-flight requests, each at most once."""
    with self._lock:
      ent = self._replicas.get(name)
      if ent is None or ent['state'] == 'dead':
        return
      ent['state'] = 'dead'
      self.evictions += 1
      self._rebuild_cycle_locked()
      stranded = [e for e in self._ledger.values()
                  if e.replica == name and e.error is None
                  and not e.inner.done()]
    self._m_evictions.inc()
    moved = sum(1 for entry in stranded if self._redrive(entry, lost=name))
    recorder.emit('serving.failover', replica=name, event='evict',
                  state='dead', redriven=moved)

  def _redrive(self, entry: _LedgerEntry, lost: str) -> bool:
    """Move one stranded request to a survivor (exactly once)."""
    if entry.redriven:
      entry.set_error(FailoverExhausted(
          f'request {entry.rid} lost its second replica ({lost!r}) after '
          'one redrive — giving up typed', replica=lost, redriven=True))
      recorder.emit('serving.failover', replica=lost, event='exhausted',
                    state='dead', redriven=0)
      return False
    for name in self._pick_order():
      if name == lost:
        continue
      with self._lock:
        ent = self._replicas.get(name)
        handle = ent['handle'] if ent else None
      if handle is None:
        continue
      try:
        inner = handle.submit(entry.seeds, entry.deadline_ms)
      except Exception:             # noqa: BLE001 — try the next one
        continue
      with self._lock:
        entry.redriven = True
        entry.replica = name
        entry.generation += 1
        entry.inner = inner
        self.redriven += 1
        # the survivor may have been evicted between its submit and
        # this update: its eviction missed the entry, so the second
        # loss resolves typed below
        ent = self._replicas.get(name)
        lost_again = ent is not None and ent['state'] == 'dead'
      self._m_redrives.inc()
      recorder.emit('serving.failover', replica=lost, event='redrive',
                    state='dead', redriven=1)
      if lost_again and not inner.done():
        self._redrive(entry, lost=name)
      return True
    err = FailoverExhausted(
        f'request {entry.rid}: no survivor accepted the redrive from '
        f'{lost!r}', replica=lost, redriven=False)
    err.__cause__ = ReplicaLostError(
        f'replica {lost!r} evicted with request {entry.rid} in flight',
        replica=lost)
    entry.set_error(err)
    recorder.emit('serving.failover', replica=lost, event='exhausted',
                  state='dead', redriven=0)
    return False

  # -- observability --------------------------------------------------------
  def _state_count_fn(self, state: str):
    def count() -> int:
      with self._lock:
        return sum(1 for e in self._replicas.values()
                   if e['state'] == state)
    return count

  def stats(self) -> dict:
    with self._lock:
      return {
          'replicas': {n: {'state': e['state'], 'misses': e['misses'],
                           'hb_ms': e['hb_ms']}
                       for n, e in self._replicas.items()},
          'submitted': self.submitted,
          'resolved': dict(self.resolved),
          'in_flight': len(self._ledger),
          'swept': self.swept,
          'redriven': self.redriven,
          'evictions': self.evictions,
          'quarantined': self.quarantines,
      }

  def make_scraper(self, *args, **kwargs):
    """The federation scraper: not ported (telemetry, ROADMAP item 13)."""
    raise NotImplementedError('FleetRouter.make_scraper needs the '
                              'telemetry federation, ROADMAP item 13')

  def _health(self) -> dict:
    """The ``healthz`` fleet component: healthy while any replica can
    take traffic; each replica's state and last heartbeat block."""
    with self._lock:
      replicas = {}
      any_up = False
      for n, e in self._replicas.items():
        serving = (e['hb'] or {}).get('serving') or {}
        replicas[n] = {'state': e['state'], 'misses': e['misses'],
                       'hb_ms': e['hb_ms'],
                       'model_version': serving.get('model_version'),
                       'queue_depth': serving.get('queue_depth'),
                       'slo': serving.get('slo')}
        any_up = any_up or e['state'] in ('healthy', 'overloaded')
      return {'healthy': any_up, 'replicas': replicas,
              'in_flight': len(self._ledger),
              'redriven': self.redriven, 'evictions': self.evictions}
