"""Channel contract (the JAX package's `channel/base.py`).

A ``SampleMessage`` is a flat ``Dict[str, np.ndarray]`` — the
process-portable form of one sampled mini-batch: numpy, never torch, so
no tensor (and no CUDA context) crosses a process.  Key conventions
(mirroring `distributed/dist_neighbor_sampler.py:600-673`):

  * ``'#IS_HETERO'``: uint8 scalar flag.
  * ``'#META.<name>'``: loader metadata entries.
  * homo: ``ids / rows / cols / eids / nfeats / nlabels / batch ...``
  * hetero: ``'<type>.ids'``, ``'<src>__<rel>__<dst>.rows'``, ...
"""
from __future__ import annotations

import abc
import time
from typing import Dict

import numpy as np

SampleMessage = Dict[str, np.ndarray]

#: a send/recv that blocks longer than this counts as a ring STALL —
#: the producer outran the consumer (send) or starved it (recv).
STALL_SECS = 0.01


class ChannelTelemetry:
  """Ring occupancy/stall instrumentation shared by the channels.

  Concrete channels wrap their blocking queue ops in :meth:`_timed`:
  every call ticks ``channel.<op>.calls`` in the metrics registry;
  calls that blocked past `STALL_SECS` tick ``channel.<op>.stalls`` /
  ``.stall_secs`` and emit a ``channel.stall`` flight-recorder event
  carrying the ring occupancy when the transport exposes one
  (`_occupancy`; -1 = unknown).  Cheap when the recorder is off: two
  perf_counter reads and two counter ticks per message.

  Span propagation (`telemetry.spans`): :meth:`_send_traced` injects
  the sender's ambient span context into the message (a uint8 tensor
  under ``'#SPAN'`` — every transport ships it like any other array);
  :meth:`_recv_traced` strips it and parks it at
  :attr:`last_span_context`, so a consumer can causally link its
  recv/collate spans to the producer's trace.  Both are single
  attribute checks when the recorder is off.
  """

  #: span context of the most recently received message (None when the
  #: producer ran recorder-off or predates span propagation).
  last_span_context = None

  def _occupancy(self) -> int:
    """Messages currently queued; -1 when the transport can't say."""
    return -1

  def _timed(self, op: str, fn, *args):
    from ..telemetry.recorder import recorder
    from ..utils.profiling import metrics
    t0 = time.perf_counter()
    out = fn(*args)
    dt = time.perf_counter() - t0
    metrics.inc(f'channel.{op}.calls')
    if dt > STALL_SECS:
      metrics.inc(f'channel.{op}.stalls')
      metrics.inc(f'channel.{op}.stall_secs', dt)
      recorder.emit('channel.stall', op=op, secs=round(dt, 6),
                    occupancy=self._occupancy(),
                    channel=type(self).__name__)
    return out

  def _send_traced(self, op: str, fn, msg):
    from ..telemetry import spans
    spans.inject(msg)
    try:
      return self._timed(op, fn, msg)
    except ValueError:
      if spans.SPAN_KEY not in msg:
        raise
      # the context tensor pushed a message that fit before past a
      # fixed transport budget (shm slot size): drop the LINK, never
      # the message — enabling telemetry must not fail sends that
      # succeed with it off
      msg.pop(spans.SPAN_KEY, None)
      return self._timed(op, fn, msg)

  def _park_span(self, msg):
    """THE strip-and-park contract (one definition for every receive
    path: blocking recv, timed recv, remote prefetch): pop the
    message's '#SPAN' context and expose it at `last_span_context`."""
    if msg is not None:
      from ..telemetry import spans
      self.last_span_context = spans.extract(msg)
    return msg

  def _recv_traced(self, op: str, fn, *args):
    return self._park_span(self._timed(op, fn, *args))


class ChannelBase(ChannelTelemetry, abc.ABC):
  """Abstract producer->consumer sample-message queue."""

  @abc.abstractmethod
  def send(self, msg: SampleMessage) -> None:
    """Enqueue one message (blocks when full)."""

  @abc.abstractmethod
  def recv(self) -> SampleMessage:
    """Dequeue one message (blocks when empty)."""

  def recv_timeout(self, timeout: float):
    """Dequeue with a deadline; ``None`` when nothing arrived in time.
    The liveness-watchdog primitive: every consumer poll loop
    (`DistLoader._recv_current_epoch`) interleaves timed waits with
    peer/worker supervision, so a dead producer surfaces as an error
    instead of a hang.  Implementations must strip-and-park the span
    context exactly like :meth:`recv`."""
    raise NotImplementedError(
        f'{type(self).__name__} has no timed receive')

  def empty(self) -> bool:
    raise NotImplementedError

  def close(self) -> None:
    pass
