"""Cross-process shared-memory channel.

Wraps the native SysV-shm MPMC ring queue (``csrc/host/shm_queue.cc``,
the JAX package's `channel/shm_channel.py`).  Messages are tensor-map
serialized in C (``csrc/host/tensor_map.cc``) — no pickle on the hot
path.  The channel is
picklable by shmid so producer subprocesses attach to the same segment
(reference `py_export.cc:132-140` pickles `SampleQueue` the same way).
"""
from __future__ import annotations

from ..native import ShmQueue
from .base import ChannelBase, SampleMessage


UNITS = {'KB': 2**10, 'MB': 2**20, 'GB': 2**30, 'TB': 2**40,
         'K': 2**10, 'M': 2**20, 'G': 2**30, 'T': 2**40, 'B': 1}


def parse_size(size) -> int:
  """``'512MB'`` / ``'4GB'`` / ``1024`` -> bytes (the JAX package's
  `utils/units.py`)."""
  if isinstance(size, (int, float)):
    return int(size)
  s = size.strip().upper().replace(' ', '')
  for unit in ('KB', 'MB', 'GB', 'TB', 'K', 'M', 'G', 'T', 'B'):
    if s.endswith(unit):
      return int(float(s[:-len(unit)]) * UNITS[unit])
  return int(float(s))


class ShmChannel(ChannelBase):
  """Fixed-capacity shm ring of sample messages.

  Args:
    capacity: max queued messages (reference ``ShmChannel(capacity,...)``,
      `channel/shm_channel.py:24-60`).
    shm_size: total shared-memory budget in bytes, or a string like
      ``'64MB'``; per-slot size = shm_size / capacity.
  """

  def __init__(self, capacity: int = 64, shm_size='64MB'):
    shm_bytes = parse_size(shm_size)
    slot = max(int(shm_bytes) // max(capacity, 1), 4096)
    self._q = ShmQueue(num_slots=capacity, slot_bytes=slot)

  def send(self, msg: SampleMessage) -> None:
    # carries the sender's ambient span context (telemetry.spans) —
    # the '#SPAN' uint8 tensor rides the C tensor-map like any array
    self._send_traced('send', self._q.put, msg)

  def recv(self) -> SampleMessage:
    return self._recv_traced('recv', self._q.get)

  def _occupancy(self) -> int:
    try:
      return int(self._q.qsize())
    except Exception:             # noqa: BLE001 — native probe only
      return -1

  def recv_timeout(self, timeout: float):
    """Dequeue with a timeout; ``None`` when nothing arrived — the
    hook liveness watchdogs need (blocking fast path preserved).
    Strips the producer's span context like :meth:`recv` does."""
    return self._park_span(self._q.get_timed(timeout))

  def recv_bytes(self) -> bytes:
    """Dequeue one message still in tensor-map wire form — lets the
    server forward it over RPC without a parse/re-serialize round trip."""
    return self._q.get_bytes()

  def recv_bytes_timeout(self, timeout: float):
    """Timed `recv_bytes` (``None`` on timeout) — the server's fetch
    handler polls with this so a dead producer pool surfaces as an
    RPC error to the client instead of a forever-blocked request."""
    return self._q.get_bytes_timed(timeout)

  def empty(self) -> bool:
    return self._q.empty()

  @property
  def slot_bytes(self) -> int:
    """The largest message one slot holds (``shm_size / capacity``)."""
    return int(self._q.slot_bytes)

  @property
  def capacity(self) -> int:
    return int(self._q.num_slots)

  def occupancy(self) -> int:
    """Messages queued right now."""
    return self._occupancy()

  def pin_memory(self) -> None:
    """A no-op, as in the JAX package: the collate copies each batch to
    the card from pageable host memory."""

  def close(self) -> None:
    self._q.close()

  def __reduce__(self):
    return (_attach, (self._q,))


def _attach(q):
  ch = ShmChannel.__new__(ShmChannel)
  ch._q = q
  return ch
