"""Pull-based prefetching channel for server-fed loaders.

Reference `channel/remote_channel.py:23-85`: the client keeps
``prefetch_size`` async fetches in flight against a sampling server's
message buffer and hands results to the trainer in order.  Here the
fetch is any callable (the `DistClient` binds it to a socket RPC); a
small thread pool keeps the pipeline full — the asyncio/torch-future
machinery of the reference collapses to ``concurrent.futures``.

Epoch hygiene: messages carry an ``'#EPOCH'`` stamp.  If the consumer
abandons an epoch early, leftover messages (including ones already in
flight) surface on the next epoch and are *discarded by stamp* rather
than delivered as training data; each discard issues a replacement
fetch, so accounting stays exact.

Failure hygiene (the resilience layer): messages also carry a
``'#SEQ'`` batch-identity stamp.  A supervisor that restarted a dead
sampling worker replays its unacknowledged batches; replays the
original DID deliver surface here as duplicate seqs and are discarded
without being counted — the epoch finishes with exactly the expected
number of UNIQUE batches, no lost and no duplicated work.  And
:meth:`recv_timeout` waits on the in-flight future with a real
deadline, so `DistLoader`'s poll-and-supervise loop works against the
remote channel instead of blocking forever in ``.result()`` on a dead
peer (the timed-out fetch stays in flight; a *failed* fetch is dropped
and transparently resubmitted by the next fill).
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import time
from typing import Callable, Optional

import numpy as np

from .base import ChannelBase, SampleMessage

EPOCH_KEY = '#EPOCH'
SEQ_KEY = '#SEQ'
SRC_KEY = '#SRC'


class RemoteReceivingChannel(ChannelBase):
  """Prefetch ``num_expected`` messages per epoch from ``fetch_fn``.

  Args:
    fetch_fn: blocking callable returning one `SampleMessage`.
    num_expected: messages per epoch (loader's batch count).
    prefetch_size: in-flight fetches (reference default 4,
      `dist_options.py:202-258`).
  """

  def __init__(self, fetch_fn: Callable[[], SampleMessage],
               num_expected: int, prefetch_size: int = 4):
    self._fetch = fetch_fn
    # source-routed replacements: when a discard frees a fetch slot,
    # the real undelivered message sits in the DISCARDED message's
    # server buffer — a fetch_fn that takes a ``src`` hint lets the
    # replacement go there instead of round-robin (a fetch to a server
    # that owes nothing blocks out its whole fetch deadline)
    try:
      import inspect
      self._src_aware = 'src' in inspect.signature(fetch_fn).parameters
    except (TypeError, ValueError):
      self._src_aware = False
    self._num_expected = num_expected
    self._prefetch = max(1, prefetch_size)
    self._pool = cf.ThreadPoolExecutor(max_workers=self._prefetch)
    self._pending: collections.deque = collections.deque()
    self._received = 0
    self._epoch = -1
    self._seen_seqs: set = set()
    self.duplicates_discarded = 0    # run-total, for tests/telemetry

  def _replace_discarded(self, msg) -> None:
    """A discarded message (stale epoch or replay duplicate) consumed
    one fetch; re-issue it against the same source so accounting stays
    exact AND placed where the owed message actually is."""
    src = msg.get(SRC_KEY)
    if self._src_aware and src is not None:
      self._pending.append(
          self._pool.submit(self._fetch, int(np.asarray(src))))
    # else: _fill() tops the pipeline back up on the next call

  def reset(self, num_expected: Optional[int] = None,
            epoch: Optional[int] = None) -> None:
    """Start a new epoch.  In-flight fetches are kept — their results
    are filtered by epoch stamp when they surface."""
    if num_expected is not None:
      self._num_expected = num_expected
    self._epoch = self._epoch + 1 if epoch is None else epoch
    self._received = 0
    self._seen_seqs = set()

  def reduce_expected(self, k: int) -> None:
    """Degraded mode: ``k`` of this epoch's messages are known lost
    for good (a dead peer past its deadline) — stop waiting for them."""
    self._num_expected = max(self._received,
                             self._num_expected - int(k))

  def _fill(self) -> None:
    want = min(self._prefetch, self._num_expected - self._received)
    while len(self._pending) < want:
      self._pending.append(self._pool.submit(self._fetch))

  def send(self, msg: SampleMessage) -> None:
    raise RuntimeError('RemoteReceivingChannel is receive-only')

  def _recv(self, timeout: Optional[float]) -> Optional[SampleMessage]:
    if self._received >= self._num_expected:
      raise StopIteration
    deadline = (None if timeout is None
                else time.monotonic() + timeout)
    while True:
      if self._received >= self._num_expected:
        raise StopIteration        # dedup/degrade closed the epoch
      self._fill()
      if not self._pending:
        self._pending.append(self._pool.submit(self._fetch))
      head = self._pending[0]
      remaining = (None if deadline is None
                   else deadline - time.monotonic())
      if remaining is not None and remaining <= 0:
        return None
      done, _ = cf.wait([head], timeout=remaining)
      if not done:
        # clean timeout: the fetch STAYS in flight (no lost message,
        # no resubmit storm) — the caller runs its liveness checks
        # and polls again
        return None
      self._pending.popleft()
      # a FAILED fetch propagates (fetch_fn already retried under its
      # policy; what escapes is RetryExhausted / PeerLostError) — the
      # message it owed is still owed, and the next _fill() resubmits
      msg = head.result()
      stamp = msg.get(EPOCH_KEY)
      if stamp is not None and int(np.asarray(stamp)) != self._epoch:
        # stale message from an abandoned epoch; refetch from the
        # same source
        self._replace_discarded(msg)
        continue
      seq = msg.get(SEQ_KEY)
      if seq is not None:
        # identity = (source, seq): independent producers (one per
        # server in a fanout plan) each number their seqs from 0
        src = msg.get(SRC_KEY)
        key = (int(np.asarray(src)) if src is not None else 0,
               int(np.asarray(seq)))
        if key in self._seen_seqs:
          # replayed batch whose original got through: discard, don't
          # count — the source-routed replacement keeps accounting
          # exact
          self.duplicates_discarded += 1
          self._replace_discarded(msg)
          continue
        self._seen_seqs.add(key)
      self._received += 1
      # strip + park the producer's span context (telemetry.spans) —
      # it crossed the server RPC as an ordinary '#SPAN' tensor
      return self._park_span(msg)

  def recv(self) -> SampleMessage:
    return self._recv(None)

  def recv_timeout(self, timeout: float):
    """Timed receive (``None`` on timeout) — the deadline applies to
    the WAIT, while the underlying fetch keeps running; see the module
    docstring for why a timeout never loses a message."""
    return self._recv(timeout)

  def empty(self) -> bool:
    return not self._pending

  def close(self) -> None:
    self._pool.shutdown(wait=False, cancel_futures=True)
