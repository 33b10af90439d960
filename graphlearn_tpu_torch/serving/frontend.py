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
"""
from __future__ import annotations

import os
import threading
import traceback
from typing import List, Optional

import numpy as np

from .admission import AdmissionController, Request
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
  """

  def __init__(self, engine: ServingEngine,
               max_wait_ms: Optional[float] = None,
               max_queue: Optional[int] = None,
               default_deadline_ms: Optional[float] = None,
               auto_start: bool = True, warmup: bool = True):
    self.engine = engine
    self.max_wait_s = (max_wait_ms if max_wait_ms is not None
                       else max_wait_ms_from_env()) / 1e3
    self.admission = AdmissionController(
        max_queue=max_queue, default_deadline_ms=default_deadline_ms,
        max_request_seeds=engine.max_request_seeds())
    self._closed = False
    self._thread: Optional[threading.Thread] = None
    self._lock = threading.Lock()
    self.in_flight = 0          # guarded-by: self._lock
    self.served_requests = 0    # guarded-by: self._lock
    self.served_seeds = 0       # guarded-by: self._lock
    self.dispatches = 0         # guarded-by: self._lock
    self.failed = 0             # guarded-by: self._lock
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
    while not self._closed:
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
    if not run:
      return 0
    with self._lock:
      self.in_flight = len(run)
    try:
      return self._execute(run)
    finally:
      with self._lock:
        self.in_flight = 0

  def _execute(self, run: List[Request]) -> int:
    sizes = [len(r.seeds) for r in run]
    total = sum(sizes)
    cap = self.engine.bucket_for(total)
    try:
      batch = self.engine.infer(
          np.concatenate([r.seeds for r in run]), cap=cap)
    except Exception as e:          # noqa: BLE001 — every rider of the
      # failed dispatch gets the error, typed as raised
      with self._lock:
        self.failed += len(run)
      for req in run:
        req.future.set_error(e)
      return 0
    off = 0
    for req, k in zip(run, sizes):
      req.future.set_result(batch.slice(off, off + k))
      off += k
    with self._lock:
      self.served_requests += len(run)
      self.served_seeds += total
      self.dispatches += 1
    return len(run)

  # -- observability --------------------------------------------------------
  def stats(self) -> dict:
    """Queue depth, in-flight run size, served/failed/shed counters and
    per-bucket warm status."""
    with self._lock:
      out = {'in_flight': self.in_flight,
             'served_requests': self.served_requests,
             'served_seeds': self.served_seeds,
             'dispatches': self.dispatches,
             'failed': self.failed}
    out.update(self.admission.stats())
    out['closed'] = self._closed
    out['warm'] = {str(c): bool(w) for c, w in self.engine.warm.items()}
    out['max_wait_ms'] = round(self.max_wait_s * 1e3, 3)
    return out
