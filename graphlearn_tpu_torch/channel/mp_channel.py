"""multiprocessing.Queue channel (the JAX package's `channel/mp_channel.py`).

Slower than `ShmChannel` (pickle per message) but size-unbounded and
dependency-free; the debugging/fallback transport.
"""
from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod

from .base import ChannelBase, SampleMessage


class MpChannel(ChannelBase):

  def __init__(self, maxsize: int = 0):
    self._q = mp.get_context('spawn').Queue(maxsize)

  def send(self, msg: SampleMessage) -> None:
    # carries the sender's ambient span context (telemetry.spans)
    self._send_traced('send', self._q.put, msg)

  def recv(self) -> SampleMessage:
    return self._recv_traced('recv', self._q.get)

  def recv_timeout(self, timeout: float):
    """Timed dequeue (``None`` on timeout) — same watchdog contract as
    `ShmChannel.recv_timeout`."""
    try:
      return self._park_span(self._q.get(timeout=timeout))
    except queue_mod.Empty:
      return None

  def _occupancy(self) -> int:
    try:
      return int(self._q.qsize())
    except (NotImplementedError, OSError):
      return -1

  def empty(self) -> bool:
    return self._q.empty()

  def close(self) -> None:
    self._q.close()
