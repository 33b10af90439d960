"""Resilience policy for the host runtime: the JAX package's
`distributed/resilience.py` up to its stall watchdog.

The socket RPC (`distributed/rpc.py`) keeps its failure policy here:

  * :class:`RetryPolicy` — deadline + capped exponential backoff with
    *seeded* jitter, so a retry schedule is reproducible under test
    (the chaos harness asserts exact retry counts);
  * a typed error hierarchy on top of ``RpcError``:
    :class:`RetryExhausted` (the peer may still be alive — the policy
    deadline ran out), :class:`PeerLostError` (a liveness probe said
    the peer is gone, or a worker pool is irrecoverable) and
    :class:`ReplayEvictedError`;
  * the serving fleet's typed failover errors `ReplicaLostError` and
    `FailoverExhausted`;
  * :func:`degraded_ok` — the ``GLT_DEGRADED_OK=1`` opt-in that turns
    irrecoverable loss into a finished-but-flagged epoch instead of a
    raise.

Still to port (slice 25): the stall watchdog — `MeshStallError`,
`run_with_deadline` and ``GLT_DISPATCH_DEADLINE``.

Env knobs (all optional; `RetryPolicy.from_env` reads them once per
policy object, so tests can monkeypatch freely):

  * ``GLT_RPC_TIMEOUT`` — per-request socket timeout, seconds (30).
  * ``GLT_RPC_DEADLINE`` — total retry budget per logical request,
    seconds (120).
  * ``GLT_RPC_BACKOFF_BASE`` / ``GLT_RPC_BACKOFF_CAP`` — first and
    max backoff delay, seconds (0.05 / 2.0).
  * ``GLT_RPC_RETRY_SEED`` — jitter RNG seed (0).
  * ``GLT_DEGRADED_OK`` — 1 = finish epochs on surviving peers.
  * ``GLT_MAX_WORKER_RESTARTS`` — producer worker restart budget (3).
  * ``GLT_FETCH_DEADLINE`` — a server's patience with a silent but
    alive producer pool, seconds (600).
"""
from __future__ import annotations

import os
import random
from dataclasses import dataclass, field
from typing import Iterator, Optional

from .rpc import RpcError

TIMEOUT_ENV = 'GLT_RPC_TIMEOUT'
DEADLINE_ENV = 'GLT_RPC_DEADLINE'
BACKOFF_BASE_ENV = 'GLT_RPC_BACKOFF_BASE'
BACKOFF_CAP_ENV = 'GLT_RPC_BACKOFF_CAP'
RETRY_SEED_ENV = 'GLT_RPC_RETRY_SEED'
DEGRADED_ENV = 'GLT_DEGRADED_OK'
RESTARTS_ENV = 'GLT_MAX_WORKER_RESTARTS'
FETCH_DEADLINE_ENV = 'GLT_FETCH_DEADLINE'


class RetryExhausted(RpcError):
  """The retry deadline ran out.  The peer answered a liveness probe
  (or was never probed) — it may be slow, not dead; the caller decides
  whether that distinction matters."""


class PeerLostError(RpcError):
  """A peer is gone for good: the liveness probe failed after the
  retry deadline, or a producer worker pool exhausted its restart
  budget.  Carries enough diagnostics to act on from the log alone."""

  def __init__(self, msg: str, *, peer=None, received=None,
               expected=None, outstanding=None):
    super().__init__(msg)
    self.peer = peer
    self.received = received
    self.expected = expected
    self.outstanding = outstanding


class ReplayEvictedError(RpcError):
  """A retried request's replay-cache entry was pruned before the
  retry arrived: re-executing would break exactly-once (the fetch
  handler pops a message), so the server answers this typed error
  instead.  Under normal budgets a retry lands well inside the
  replay horizon — seeing this means the cache was under pressure
  (raise `REPLAY_ENTRIES_PER_CLIENT` or lower the prefetch fan-out)."""


class ReplicaLostError(RuntimeError):
  """A serving replica is gone (chaos-killed, crashed, or partitioned
  past the fleet router's eviction threshold).  Raised by replica
  handles on submit-to-a-dead-replica, and carried as the cause when
  the `FleetRouter` redrives that replica's in-flight requests onto a
  survivor.  ``replica`` names the lost handle."""

  def __init__(self, msg: str, *, replica=None):
    super().__init__(msg)
    self.replica = replica


class FailoverExhausted(RuntimeError):
  """The fleet router could not place (or re-place) a request: no
  healthy replica remained, or the request's one redrive was already
  spent when its second replica died too.  The request's future
  resolves with THIS — typed, never a silent drop — so the caller can
  tell a fleet-wide outage from a per-request shed."""

  def __init__(self, msg: str, *, replica=None, redriven: bool = False):
    super().__init__(msg)
    self.replica = replica
    self.redriven = redriven


def _env_float(name: str, default: float) -> float:
  try:
    return float(os.environ.get(name, default))
  except ValueError:
    return default


def _env_int(name: str, default: int) -> int:
  try:
    return int(os.environ.get(name, default))
  except ValueError:
    return default


def degraded_ok() -> bool:
  """``GLT_DEGRADED_OK=1``: finish the epoch on surviving peers (the
  loss flagged in telemetry) instead of raising `PeerLostError`."""
  return os.environ.get(DEGRADED_ENV, '') == '1'


def max_worker_restarts() -> int:
  return _env_int(RESTARTS_ENV, 3)


def fetch_deadline() -> float:
  """How long a server's fetch handler waits for a message from an
  ALIVE producer pool before declaring it stalled
  (``GLT_FETCH_DEADLINE``, default 600s).  Deliberately independent of
  — and much larger than — the RPC retry deadline: producing one batch
  slowly is normal; a pool silent for ten minutes is stuck."""
  return _env_float(FETCH_DEADLINE_ENV, 600.0)


@dataclass
class RetryPolicy:
  """Deadline-bounded capped exponential backoff with seeded jitter.

  Attributes:
    request_timeout: per-attempt socket timeout, seconds.
    deadline: total budget across attempts for ONE logical request —
      once exceeded, the next failure raises instead of retrying.
    base_delay / max_delay: backoff ladder ``base * 2**k`` capped at
      ``max_delay``.
    jitter: fraction of each delay drawn uniformly at random and
      ADDED (0.5 = up to +50%); the RNG is seeded, so two policies
      built with the same seed produce identical schedules — the
      determinism the chaos tests pin.
    seed: jitter RNG seed.
  """
  request_timeout: float = 30.0
  deadline: float = 120.0
  base_delay: float = 0.05
  max_delay: float = 2.0
  jitter: float = 0.5
  seed: int = 0
  _rng: random.Random = field(init=False, repr=False, compare=False,
                              default=None)

  def __post_init__(self):
    self._rng = random.Random(self.seed)

  @classmethod
  def from_env(cls, **overrides) -> 'RetryPolicy':
    kw = dict(
        request_timeout=_env_float(TIMEOUT_ENV, 30.0),
        deadline=_env_float(DEADLINE_ENV, 120.0),
        base_delay=_env_float(BACKOFF_BASE_ENV, 0.05),
        max_delay=_env_float(BACKOFF_CAP_ENV, 2.0),
        seed=_env_int(RETRY_SEED_ENV, 0))
    kw.update(overrides)
    return cls(**kw)

  def delay(self, attempt: int) -> float:
    """Backoff before retry number ``attempt`` (0-based): capped
    exponential plus seeded jitter."""
    d = min(self.base_delay * (2.0 ** attempt), self.max_delay)
    if self.jitter > 0:
      d += d * self.jitter * self._rng.random()
    return d

  def delays(self) -> Iterator[float]:
    """The full (unbounded) jittered schedule; callers stop at the
    deadline."""
    attempt = 0
    while True:
      yield self.delay(attempt)
      attempt += 1


#: policy used when callers pass none — one object per process so the
#: jitter stream is continuous, rebuilt lazily so tests that set env
#: knobs before first use see them.
_default: Optional[RetryPolicy] = None


def default_policy() -> RetryPolicy:
  global _default
  if _default is None:
    _default = RetryPolicy.from_env()
  return _default


def reset_default_policy() -> None:
  """Drop the cached process-default policy (tests re-knob the env)."""
  global _default
  _default = None
