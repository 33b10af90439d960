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
heartbeat block a fleet router reads.  The live plane gets the request,
seed, dispatch and failure counters, the queue-depth, in-flight and
fill-ratio gauges, the ``serving.queue_wait`` and per-bucket
``serving.request_latency`` histograms (an observation carries its
request's trace id as the bucket's exemplar), and a traced request
records its ``serving.queue_wait``, ``serving.dispatch_slice``,
``serving.sample_collect`` and ``serving.cold_fill`` spans
(`telemetry.tracing`) before its future resolves.  A frozen frontend
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
from ..telemetry.recorder import recorder
from ..telemetry.slo import SloTracker
from ..telemetry.spans import span
from ..telemetry.tracing import tracer
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
    # live plane: handles resolved once (a tick is a dict increment);
    # gauges are evaluated at scrape time, and the latest frontend's
    # gauges win
    self._m_requests = live.counter('serving.requests_total')
    self._m_seeds = live.counter('serving.seeds_total')
    self._m_dispatches = live.counter('serving.dispatches_total')
    self._m_failed = live.counter('serving.failed_total')
    #: the fill ratio is read through a callback, so a dead tier stops
    #: exporting its last dispatch's fill
    self._last_fill: Optional[float] = None
    _depth_fn = self.admission.depth
    _in_flight_fn = self._in_flight_snapshot
    _fill_fn = self._fill_snapshot
    live.gauge('serving.queue_depth', fn=_depth_fn)
    live.gauge('serving.in_flight', fn=_in_flight_fn)
    live.gauge('serving.coalesce_fill_ratio', fn=_fill_fn)
    self._gauge_regs = [('serving.queue_depth', _depth_fn),
                        ('serving.in_flight', _in_flight_fn),
                        ('serving.coalesce_fill_ratio', _fill_fn)]
    self._lat_hists: dict = {}
    self._m_queue_wait = live.histogram('serving.queue_wait')
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
    from ..telemetry import opsserver
    opsserver.maybe_start_from_env()
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
    """Drop this frontend's live-registry callbacks (health, serving,
    SLO and headroom gauges): on shutdown and on a simulated kill."""
    live.unregister_health('serving', fn=self._health_fn)
    for gname, gfn in self._gauge_regs:
      live.unregister_gauge(gname, fn=gfn)
    self.capacity.close()
    self.slo.close()

  # -- producer side --------------------------------------------------------
  def submit(self, seeds, deadline_ms: Optional[float] = None,
             trace: Optional[dict] = None):
    """Admit one request; returns its `ServingFuture`.  Raises
    `AdmissionRejected` at the door when the queue is at bound, and
    `ValueError` for a malformed request — empty, or seed ids outside
    ``[0, num_nodes)``: the gathers clamp out-of-range ids, so without
    this check a bogus id would come back as a plausible answer for the
    wrong node.  ``trace`` is the request-trace context a router minted:
    it rides the queued request so the executor records this request's
    spans."""
    seeds = np.asarray(seeds, np.int64).reshape(-1)
    if seeds.size == 0:
      raise ValueError('a serving request needs at least one seed')
    if seeds.min() < 0 or seeds.max() >= self.engine.num_nodes:
      bad = seeds[(seeds < 0) | (seeds >= self.engine.num_nodes)]
      raise ValueError(
          f'seed id(s) {bad[:8].tolist()} outside [0, '
          f'{self.engine.num_nodes}) — refused (a clamped gather '
          'would silently answer for a different node)')
    return self.admission.submit(seeds, deadline_ms, trace=trace).future

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
    recorder.emit('serving.coalesce', requests=len(run), seeds=total,
                  bucket=cap,
                  waited_ms=round(1e3 * (now - run[0].arrived), 3))
    for req in run:
      # admission enqueue -> coalesce pickup: the histogram always, a
      # span only for a traced request
      wait_s = max(now - req.arrived, 0.0)
      self._m_queue_wait.observe(wait_s)
      if req.trace is not None:
        tracer.span('serving.queue_wait', req.trace, t0=req.arrived,
                    dur=wait_s)
    try:
      chaos.serving_request_check('dispatch', replica=self.name)
      with span('serving.infer', bucket=cap, requests=len(run),
                seeds=total):
        batch = self.engine.infer(
            np.concatenate([r.seeds for r in run]), cap=cap)
    except Exception as e:          # noqa: BLE001 — every rider of the
      # failed dispatch gets the error, typed as raised
      with self._lock:
        self.failed += len(run)
      self._m_failed.inc(len(run))
      for req in run:
        lat = req.waited_ms()
        if req.trace is not None:
          tracer.span('serving.dispatch_slice', req.trace, t0=now,
                      dur=time.monotonic() - now, bucket=cap,
                      requests=len(run),
                      error=f'{type(e).__name__}: {e}'[:160])
          tracer.resolve(req.trace, outcome='error', latency_ms=lat)
        req.future.set_error(e)
        self.slo.observe(lat, ok=False)
        recorder.emit('serving.request', seeds=len(req.seeds),
                      bucket=cap, coalesced=len(run), ok=False,
                      latency_ms=round(lat, 3),
                      error=f'{type(e).__name__}: {e}'[:160])
      if not isinstance(e, AdmissionRejected):
        postmortem.dump('serving.executor_fault', error=e,
                        extra={'bucket': cap, 'requests': len(run)})
      return 0
    off = 0
    self._last_fill = round(total / cap, 4) if cap else 0.0
    cold = self.engine.last_cold_fill
    coll = self.engine.last_collect
    hist = self._lat_hists.get(cap)
    if hist is None:
      hist = self._lat_hists[cap] = live.histogram(
          'serving.request_latency', labels={'bucket': cap})
    for req, k in zip(run, sizes):
      lat = req.waited_ms()
      if req.trace is not None:
        # recorded and resolved BEFORE the future fires: a caller that
        # wakes finds this request's spans already retained
        end = time.monotonic()
        sid = tracer.span('serving.dispatch_slice', req.trace,
                          t0=now, dur=end - now, bucket=cap,
                          requests=len(run))
        if coll is not None and coll[0] >= now:
          # the engine's sampling collect inside THIS dispatch
          tracer.span('serving.sample_collect', req.trace,
                      parent_id=sid, t0=coll[0], dur=coll[1])
        if cold is not None and cold[0] >= now:
          # the engine's tiered cold fill inside THIS dispatch
          tracer.span('serving.cold_fill', req.trace, parent_id=sid,
                      t0=cold[0], dur=cold[1])
        tracer.resolve(req.trace, outcome='ok', latency_ms=lat)
      req.future.set_result(batch.slice(off, off + k))
      off += k
      # the trace id lands as this bucket's OpenMetrics exemplar
      hist.observe(lat / 1e3,
                   exemplar=(req.trace['t'] if req.trace is not None
                             else None))
      self.slo.observe(lat, ok=True)
      recorder.emit('serving.request', seeds=k, bucket=cap,
                    coalesced=len(run), ok=True,
                    latency_ms=round(lat, 3))
    self.capacity.observe(cap, len(run), time.monotonic() - now)
    with self._lock:
      self.served_requests += len(run)
      self.served_seeds += total
      self.dispatches += 1
    self._m_requests.inc(len(run))
    self._m_seeds.inc(total)
    self._m_dispatches.inc()
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

  def _fill_snapshot(self) -> Optional[float]:
    return self._last_fill

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
