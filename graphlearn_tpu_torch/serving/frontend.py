"""Request coalescing + executor loop over the bucketed engine.

Producers ``submit`` single-seed or few-seed requests through the
`AdmissionController`; ONE executor thread drains the bounded queue in
coalesced runs — FIFO requests packed until the largest bucket fills or
``GLT_SERVING_MAX_WAIT_MS`` has passed since the run's first arrival —
dispatches each run through the engine, and de-multiplexes per-request
slices back onto the waiting futures.  Per-seed sampling determinism
(`serving.engine`) makes each slice byte-identical to serving the
request alone.  A failed dispatch resolves every rider's future with
the error; nothing is dropped.

The executor holds `_dispatch_gate` across each coalesced run: a hot
model swap (`swap_model`, `serving.swap.hot_swap`) acquires it to sit
between runs, so no run straddles a version change.  Each resolved
request feeds the frontend's `telemetry.slo.SloTracker` and each
dispatch its `telemetry.memaccount.CapacityModel`; `stats` is the
heartbeat block a fleet router reads.  A frozen frontend
(`serving.router.LocalReplica.kill`) stops cold: a taken run is lost
unresolved, as a killed process's would be.
"""
from __future__ import annotations

import os
import threading
import time
import traceback
from typing import List, Optional

import numpy as np

from ..telemetry import postmortem
from ..telemetry.live import live
from ..telemetry.memaccount import CapacityModel
from ..telemetry.slo import SloTracker
from .admission import AdmissionController, AdmissionRejected, Request
from .engine import ServingEngine, ServingResult

MAX_WAIT_ENV = 'GLT_SERVING_MAX_WAIT_MS'
DEFAULT_MAX_WAIT_MS = 2.0


def max_wait_ms_from_env() -> float:
  raw = os.environ.get(MAX_WAIT_ENV)
  if raw is None:
    return DEFAULT_MAX_WAIT_MS
  try:
    return max(float(raw), 0.0)
  except ValueError:
    return DEFAULT_MAX_WAIT_MS


class ServingFrontend:
  """Admission + coalescing + execution.

  Args:
    engine: a `ServingEngine` (warmed by `start` when not yet warm).
    max_wait_ms: coalescing window (else ``GLT_SERVING_MAX_WAIT_MS``).
    max_queue / default_deadline_ms: admission bounds (else the
      ``GLT_SERVING_QUEUE_DEPTH`` / ``GLT_SERVING_DEADLINE_MS``
      defaults).
    auto_start: start the executor thread now.  Tests pass ``False``
      and pump deterministically with `pump_once`.
    name: the fleet identity (set by `router.LocalReplica` when empty);
      it rides the executor's ``serving.request`` chaos seam.
  """

  def __init__(self, engine: ServingEngine,
               max_wait_ms: Optional[float] = None,
               max_queue: Optional[int] = None,
               default_deadline_ms: Optional[float] = None,
               auto_start: bool = True, warmup: bool = True,
               name: str = ''):
    self.engine = engine
    self.name = name
    self.max_wait_s = (max_wait_ms if max_wait_ms is not None
                       else max_wait_ms_from_env()) / 1e3
    self.admission = AdmissionController(
        max_queue=max_queue, default_deadline_ms=default_deadline_ms,
        max_request_seeds=engine.max_request_seeds())
    self._closed = False
    #: set by `LocalReplica.kill`: the executor stops cold, a taken run
    #: is dropped unresolved (the fleet router redrives it)
    self._frozen = False
    self._thread: Optional[threading.Thread] = None
    self._lock = threading.Lock()
    #: held by the executor across each coalesced run; `hot_swap`
    #: acquires it to quiesce BETWEEN runs
    self._dispatch_gate = threading.Lock()
    #: serializes whole hot_swap attempts
    self._swap_lock = threading.Lock()
    self.in_flight = 0          # guarded-by: self._lock
    self.served_requests = 0    # guarded-by: self._lock
    self.served_seeds = 0       # guarded-by: self._lock
    self.dispatches = 0         # guarded-by: self._lock
    self.failed = 0             # guarded-by: self._lock
    #: the SLO window (targets from GLT_SERVING_SLO_P99_MS / _QPS) and
    #: the per-bucket serve-cost model behind ``fleet.headroom_qps``
    self.slo = SloTracker(registry=live)
    self.capacity = CapacityModel(slo=self.slo, registry=live)
    # sheds that fail callers (queue_full, deadline) burn the budget;
    # draining and shutdown sheds are intentional and do not
    self.admission.slo_feed = self._slo_shed_feed
    self._health_fn = self._health  # pinned: unregister compares by identity
    live.register_health('serving', self._health_fn)
    if auto_start:
      self.start(warmup=warmup)

  # -- lifecycle ------------------------------------------------------------
  def start(self, warmup: bool = True) -> None:
    if self._thread is not None:
      return
    if warmup and not all(self.engine.warm.values()):
      self.engine.warmup()
    self._thread = threading.Thread(target=self._loop, daemon=True,
                                    name='glt-serving-executor')
    self._thread.start()

  def shutdown(self, timeout: float = 10.0) -> None:
    """Stop the executor; every queued request resolves with a typed
    shutdown rejection (never silently lost)."""
    self._closed = True
    self.admission.close()
    t = self._thread
    if t is not None:
      t.join(timeout)
    self._thread = None
    self._unregister_observability()

  def _unregister_observability(self) -> None:
    """Drop this frontend's live-registry callbacks (health, SLO and
    headroom gauges): on shutdown and on a simulated kill."""
    live.unregister_health('serving', fn=self._health_fn)
    self.capacity.close()
    self.slo.close()

  # -- producer side --------------------------------------------------------
  def submit(self, seeds, deadline_ms: Optional[float] = None):
    """Admit one request; returns its `ServingFuture`.  Raises
    `AdmissionRejected` at the door when the queue is at bound, and
    `ValueError` for a malformed request — empty, or seed ids outside
    ``[0, num_nodes)``: the gathers clamp out-of-range ids, so without
    this check a bogus id would come back as a plausible answer for the
    wrong node."""
    seeds = np.asarray(seeds, np.int64).reshape(-1)
    if seeds.size == 0:
      raise ValueError('a serving request needs at least one seed')
    if seeds.min() < 0 or seeds.max() >= self.engine.num_nodes:
      bad = seeds[(seeds < 0) | (seeds >= self.engine.num_nodes)]
      raise ValueError(
          f'seed id(s) {bad[:8].tolist()} outside [0, '
          f'{self.engine.num_nodes}) — refused (a clamped gather '
          'would silently answer for a different node)')
    return self.admission.submit(seeds, deadline_ms).future

  def infer(self, seeds, deadline_ms: Optional[float] = None,
            timeout: Optional[float] = None) -> ServingResult:
    """Blocking submit + wait (the in-process client).  The wait
    outlives the deadline by a grace window: a request picked before
    its deadline still completes."""
    dl = (deadline_ms if deadline_ms is not None
          else self.admission.default_deadline_ms)
    fut = self.submit(seeds, deadline_ms)
    return fut.result(timeout if timeout is not None
                      else dl / 1e3 + 30.0)

  # -- executor side --------------------------------------------------------
  def _loop(self) -> None:
    while not self._closed and not self._frozen:
      try:
        self.pump_once()
      except Exception:             # noqa: BLE001 — pump_once resolves
        # per-request errors onto futures; anything escaping here is a
        # harness bug: report it and keep serving, since a dead loop
        # would hang every later caller
        if self._closed:
          return
        traceback.print_exc()

  def pump_once(self, block: bool = True) -> int:
    """Drain ONE coalesced run end to end; returns requests served
    (0 = nothing to do / everything shed).  ``block=False`` returns 0
    at once on an empty queue."""
    run = self.admission.take(self.engine.max_request_seeds(),
                              self.max_wait_s, block=block)
    if self._frozen:
      return 0                      # a killed replica: the run is lost
    if not run:
      return 0
    with self._lock:
      self.in_flight = len(run)
    try:
      with self._dispatch_gate:     # the hot-swap quiesce point
        return self._execute(run)
    finally:
      with self._lock:
        self.in_flight = 0

  def _execute(self, run: List[Request]) -> int:
    from ..testing import chaos
    sizes = [len(r.seeds) for r in run]
    total = sum(sizes)
    cap = self.engine.bucket_for(total)
    now = time.monotonic()
    try:
      chaos.serving_request_check('dispatch', replica=self.name)
      batch = self.engine.infer(
          np.concatenate([r.seeds for r in run]), cap=cap)
    except Exception as e:          # noqa: BLE001 — every rider of the
      # failed dispatch gets the error, typed as raised
      with self._lock:
        self.failed += len(run)
      for req in run:
        req.future.set_error(e)
        self.slo.observe(req.waited_ms(), ok=False)
      if not isinstance(e, AdmissionRejected):
        postmortem.dump('serving.executor_fault', error=e,
                        extra={'bucket': cap, 'requests': len(run)})
      return 0
    off = 0
    for req, k in zip(run, sizes):
      lat = req.waited_ms()
      req.future.set_result(batch.slice(off, off + k))
      off += k
      self.slo.observe(lat, ok=True)
    self.capacity.observe(cap, len(run), time.monotonic() - now)
    with self._lock:
      self.served_requests += len(run)
      self.served_seeds += total
      self.dispatches += 1
    return len(run)

  # -- model lifecycle ------------------------------------------------------
  def swap_model(self, params, version: Optional[int] = None,
                 **kwargs) -> dict:
    """Drain-free hot model swap (`serving.swap.hot_swap`): quiesce
    between coalesced runs, parity-check the candidate against the
    offline reference, commit or roll back — zero dropped requests."""
    from .swap import hot_swap
    return hot_swap(self, params, version=version, **kwargs)

  def _slo_shed_feed(self, reason: str, waited_ms: float) -> None:
    self.slo.observe(waited_ms, ok=False)

  def quiesced(self) -> bool:
    """No queued work and no in-flight coalesced run: the drain point a
    planned retirement waits for after flipping the door to draining."""
    return (self.admission.depth() == 0
            and self._in_flight_snapshot() == 0)

  # -- observability --------------------------------------------------------
  def _in_flight_snapshot(self) -> int:
    with self._lock:
      return self.in_flight

  def stats(self) -> dict:
    """The heartbeat serving block: queue depth, in-flight run size,
    served/failed/shed counters, draining and closed flags, the
    engine's compile status and model version, headroom and the SLO
    windows."""
    with self._lock:
      out = {'in_flight': self.in_flight,
             'served_requests': self.served_requests,
             'served_seeds': self.served_seeds,
             'dispatches': self.dispatches,
             'failed': self.failed}
    out.update(self.admission.stats())
    out['closed'] = self._closed
    out['compile_status'] = self.engine.compile_status()
    out['model_version'] = self.engine.model_version
    out['max_wait_ms'] = round(self.max_wait_s * 1e3, 3)
    hr = self.capacity._headroom()
    if hr is not None:
      out['headroom_qps'] = hr
    out['slo'] = self.slo.snapshot()
    return out

  def _health(self) -> dict:
    """The ``healthz`` serving component: the heartbeat block and a
    ``healthy`` verdict — unhealthy once closed or when a started
    executor thread has died.  A draining tier is healthy: its sheds
    are intentional."""
    out = self.stats()
    alive = self._thread is not None and self._thread.is_alive()
    out['executor_alive'] = alive
    out['healthy'] = not self._closed and not (self._thread is not None
                                               and not alive)
    return out
