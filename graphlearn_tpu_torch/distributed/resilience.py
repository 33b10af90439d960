"""Typed failover errors of the serving fleet and the degraded-completion
knob of the mesh.

The port's copy of `ReplicaLostError`, `FailoverExhausted` and
`degraded_ok` from the JAX package's `distributed/resilience.py`; the
rest of that module (the RPC retry layer, the stall watchdog) belongs to
the host runtime, ROADMAP item 11.
"""
from __future__ import annotations

import os

DEGRADED_ENV = 'GLT_DEGRADED_OK'


def degraded_ok() -> bool:
  """``GLT_DEGRADED_OK=1``: a mesh epoch that lost a partition owner and
  cannot adopt its shard finishes on the surviving ranges (the loss
  flagged in the flight recorder) instead of raising."""
  return os.environ.get(DEGRADED_ENV, '') == '1'


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
  resolves with this, typed, never a silent drop."""

  def __init__(self, msg: str, *, replica=None, redriven: bool = False):
    super().__init__(msg)
    self.replica = replica
    self.redriven = redriven
