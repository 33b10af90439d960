"""Admission control for the online serving plane.

An inference tier that accepts everything collapses under overload, so
the controller keeps it bounded:

  * **bounded queue** — at most ``GLT_SERVING_QUEUE_DEPTH`` requests
    wait; an arrival past the bound is refused at the door with a typed
    :class:`AdmissionRejected` carrying queue-depth diagnostics;
  * **per-request deadlines** — a request still queued when its
    deadline (default ``GLT_SERVING_DEADLINE_MS``) passes is shed with
    the same typed error, never silently dropped: every future resolves;
  * **typed load-shedding** — each refusal carries a ``reason``
    (``queue_full`` / ``deadline`` / ``too_large`` / ``draining`` /
    ``shutdown``) so callers can tell a shed from a crash.

Counts of admitted and shed requests are kept for `stats`.
Import-light: threading, time and collections only.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import List, Optional

QUEUE_DEPTH_ENV = 'GLT_SERVING_QUEUE_DEPTH'
DEADLINE_ENV = 'GLT_SERVING_DEADLINE_MS'
DRAIN_RETRY_ENV = 'GLT_SERVING_DRAIN_RETRY_MS'

DEFAULT_QUEUE_DEPTH = 256
DEFAULT_DEADLINE_MS = 200.0
DEFAULT_DRAIN_RETRY_MS = 50.0


def _env_pos(name: str, default, cast):
  raw = os.environ.get(name)
  if raw is None:
    return default
  try:
    v = cast(raw)
    return v if v > 0 else default
  except ValueError:
    return default


def queue_depth_from_env() -> int:
  return _env_pos(QUEUE_DEPTH_ENV, DEFAULT_QUEUE_DEPTH, int)


def deadline_ms_from_env() -> float:
  return _env_pos(DEADLINE_ENV, DEFAULT_DEADLINE_MS, float)


def drain_retry_ms_from_env() -> float:
  return _env_pos(DRAIN_RETRY_ENV, DEFAULT_DRAIN_RETRY_MS, float)


class AdmissionRejected(RuntimeError):
  """A request the serving tier refused or shed — a load signal, not a
  crash.  ``reason`` is one of ``queue_full``, ``deadline``,
  ``too_large``, ``draining`` (retry after ``retry_after_ms``) or
  ``shutdown``; ``queue_depth``/``limit``/``waited_ms`` carry the
  controller state at refusal time."""

  def __init__(self, msg: str, *, reason: str = '',
               queue_depth: Optional[int] = None,
               limit: Optional[int] = None,
               waited_ms: Optional[float] = None,
               retry_after_ms: Optional[float] = None):
    super().__init__(msg)
    self.reason = reason
    self.queue_depth = queue_depth
    self.limit = limit
    self.waited_ms = waited_ms
    self.retry_after_ms = retry_after_ms


class ServingFuture:
  """One request's pending result: resolves exactly once, with a value
  or an error; ``result`` re-raises the error."""

  __slots__ = ('_done', '_value', '_error', 'done_monotonic')

  def __init__(self):
    self._done = threading.Event()
    self._value = None
    self._error: Optional[BaseException] = None
    self.done_monotonic: Optional[float] = None

  def set_result(self, value) -> None:
    self._value = value
    self.done_monotonic = time.monotonic()
    self._done.set()

  def set_error(self, err: BaseException) -> None:
    self._error = err
    self.done_monotonic = time.monotonic()
    self._done.set()

  def done(self) -> bool:
    return self._done.is_set()

  def result(self, timeout: Optional[float] = None):
    if not self._done.wait(timeout):
      raise TimeoutError('serving request still in flight')
    if self._error is not None:
      raise self._error
    return self._value


class Request:
  """One admitted request: ``seeds``, absolute ``deadline`` (monotonic
  seconds), arrival time and the future its caller waits on."""

  __slots__ = ('seeds', 'arrived', 'deadline', 'future')

  def __init__(self, seeds, deadline_s: float):
    self.seeds = seeds
    self.arrived = time.monotonic()
    self.deadline = self.arrived + deadline_s
    self.future = ServingFuture()

  def expired(self, now: Optional[float] = None) -> bool:
    return (now if now is not None else time.monotonic()) > self.deadline

  def waited_ms(self, now: Optional[float] = None) -> float:
    now = now if now is not None else time.monotonic()
    return 1e3 * (now - self.arrived)


class AdmissionController:
  """The bounded FIFO between request producers and the coalescing
  executor loop: ``submit`` admits or raises `AdmissionRejected`;
  ``take`` hands the executor a FIFO run of requests whose seed count
  fits the largest bucket, shedding expired ones on the way."""

  def __init__(self, max_queue: Optional[int] = None,
               default_deadline_ms: Optional[float] = None,
               max_request_seeds: Optional[int] = None):
    self.max_queue = int(max_queue if max_queue is not None
                         else queue_depth_from_env())
    self.default_deadline_ms = float(
        default_deadline_ms if default_deadline_ms is not None
        else deadline_ms_from_env())
    self.max_request_seeds = max_request_seeds
    self._q: 'collections.deque[Request]' = collections.deque()
    self._lock = threading.Lock()
    self._arrived = threading.Condition(self._lock)
    self._closed = False
    #: drain depth, not a boolean: overlapping drain windows must not
    #: let the first one's exit reopen admission
    self._draining = 0              # guarded-by: self._lock
    self.drain_retry_after_ms = drain_retry_ms_from_env()
    #: optional SLO feed, ``slo_feed(reason, waited_ms)``, called for the
    #: sheds that burn latency budget (``queue_full``, ``deadline``: the
    #: tier failing its callers); intentional sheds (``draining``,
    #: ``shutdown``, ``too_large``) do not burn it
    self.slo_feed = None
    self.admitted = 0
    self.shed = {'queue_full': 0, 'deadline': 0, 'too_large': 0,
                 'shutdown': 0, 'draining': 0}

  # -- producer side --------------------------------------------------------
  def submit(self, seeds, deadline_ms: Optional[float] = None) -> Request:
    """Admit one request or raise typed.  ``deadline_ms`` overrides the
    default budget."""
    n = len(seeds)
    dl = float(deadline_ms if deadline_ms is not None
               else self.default_deadline_ms)
    with self._lock:
      if self._closed:
        self.shed['shutdown'] += 1
        raise AdmissionRejected('serving tier is shutting down',
                                reason='shutdown')
      if self._draining:
        self.shed['draining'] += 1
        raise AdmissionRejected(
            'serving tier is draining — retry after '
            f'~{self.drain_retry_after_ms:.0f}ms',
            reason='draining', queue_depth=len(self._q),
            retry_after_ms=self.drain_retry_after_ms)
      if (self.max_request_seeds is not None
          and n > self.max_request_seeds):
        self.shed['too_large'] += 1
        raise AdmissionRejected(
            f'request carries {n} seeds; the largest serving bucket '
            f'holds {self.max_request_seeds} — split the request or '
            'widen GLT_SERVING_BUCKETS',
            reason='too_large', limit=self.max_request_seeds,
            queue_depth=len(self._q))
      if len(self._q) >= self.max_queue:
        self.shed['queue_full'] += 1
        if self.slo_feed is not None:
          self.slo_feed('queue_full', 0.0)
        raise AdmissionRejected(
            f'serving queue at capacity ({len(self._q)}/'
            f'{self.max_queue} requests waiting) — overload; retry '
            'with backoff or raise GLT_SERVING_QUEUE_DEPTH',
            reason='queue_full', queue_depth=len(self._q),
            limit=self.max_queue)
      req = Request(seeds, dl / 1e3)
      self._q.append(req)
      self.admitted += 1
      self._arrived.notify_all()
    return req

  # -- executor side --------------------------------------------------------
  def _shed_expired_locked(self, now: float) -> None:
    kept: 'collections.deque[Request]' = collections.deque()
    for req in self._q:
      if req.expired(now):
        self.shed['deadline'] += 1
        waited = req.waited_ms(now)
        if self.slo_feed is not None:
          self.slo_feed('deadline', waited)
        req.future.set_error(AdmissionRejected(
            f'deadline passed after {waited:.1f}ms in queue '
            '(executor saturated — shed, not silently dropped)',
            reason='deadline', waited_ms=waited,
            queue_depth=len(self._q)))
      else:
        kept.append(req)
    self._q = kept

  def take(self, max_seeds: int, max_wait_s: float,
           poll_s: float = 0.005, block: bool = True) -> List[Request]:
    """A FIFO run of requests whose total seed count fits
    ``max_seeds``.  The run closes when the budget fills or
    ``max_wait_s`` has passed since its first request arrived.
    ``block=False`` returns ``[]`` at once on an empty queue; ``[]``
    after `close`."""
    poll_s = max(poll_s, 1e-3)     # a zero poll would busy-spin
    with self._lock:
      while True:
        self._shed_expired_locked(time.monotonic())
        if self._closed:
          return []
        if self._q:
          break
        if not block:
          return []
        self._arrived.wait(timeout=0.1)
      wait_until = self._q[0].arrived + max_wait_s
      # hold the lock only across queue scans: waiting for stragglers
      # must not block producers out of submit
      while True:
        total = 0
        full = False
        for req in self._q:
          total += len(req.seeds)
          if total >= max_seeds:
            full = True
            break
        now = time.monotonic()
        if full or now >= wait_until or self._closed:
          break
        self._arrived.wait(timeout=min(poll_s,
                                       max(wait_until - now, 1e-4)))
        self._shed_expired_locked(time.monotonic())
        if not self._q:
          return []
      self._shed_expired_locked(time.monotonic())
      run: List[Request] = []
      total = 0
      while self._q and total + len(self._q[0].seeds) <= max_seeds:
        req = self._q.popleft()
        run.append(req)
        total += len(req.seeds)
      if not run and self._q:
        # the head alone exceeds max_seeds: admission should have
        # refused it, but never deadlock on it
        req = self._q.popleft()
        self.shed['too_large'] += 1
        req.future.set_error(AdmissionRejected(
            f'request with {len(req.seeds)} seeds exceeds the '
            f'largest bucket ({max_seeds})', reason='too_large',
            limit=max_seeds))
      return run

  def depth(self) -> int:
    return len(self._q)             # len() of a deque is atomic

  def set_draining(self, on: bool) -> None:
    """Enter/leave a drain window: while on, new arrivals are refused
    ``reason='draining'``; queued requests stay queued.  Reference
    counted — admission reopens when the last window closes."""
    with self._lock:
      self._draining = max(self._draining + (1 if on else -1), 0)
      if not self._draining:
        self._arrived.notify_all()

  def draining(self) -> bool:
    with self._lock:
      return self._draining > 0

  def stats(self) -> dict:
    with self._lock:
      return {'queue_depth': len(self._q),
              'max_queue': self.max_queue,
              'admitted': self.admitted,
              'draining': self._draining > 0,
              'shed': dict(self.shed)}

  def close(self) -> None:
    """Resolve every queued request with a typed shutdown rejection."""
    with self._lock:
      self._closed = True
      while self._q:
        req = self._q.popleft()
        self.shed['shutdown'] += 1
        req.future.set_error(AdmissionRejected(
            'serving tier shut down before dispatch',
            reason='shutdown'))
      self._arrived.notify_all()
