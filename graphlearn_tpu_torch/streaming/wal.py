"""Checksummed, seqno-stamped write-ahead log for edge-insert events.

The durability half of streaming ingest, copied from the JAX package's
`streaming/wal.py` with the SAME on-disk format: a log written by
either package replays in the other.  Every edge-insert batch is
appended here BEFORE it touches the in-memory delta-CSR, so a crash
between "the client was told ok" and "the published graph holds the
edge" is recoverable by replay:

  * **atomic append** — one record is one ``write()`` of a fully
    assembled buffer followed by flush+fsync; a record is either
    wholly in the file or detectably torn at the tail.
  * **torn-tail detection** — every record carries a CRC32 of its
    payload and a length; :meth:`WriteAheadLog.open` scans the file
    and TRUNCATES back to the last whole record when the tail is
    short or fails its checksum (the kill-mid-append carcass), so a
    restarted process replays exactly the whole-record prefix — no
    half-applied event batch, ever (``ingest.wal_truncate`` event).
  * **replay idempotent by seqno** — records are stamped with a
    monotone sequence number; recovery replays only records with
    ``seqno > applied_seqno`` (the compacted base's watermark), so a
    crash between a compaction snapshot and the WAL reset can never
    double-apply.

Record layout (little-endian)::

    [u32 crc32(payload)] [u64 seqno] [u32 nbytes] [payload]
    payload := [u32 count] [src int64*count] [dst int64*count]

File header: the 8-byte magic ``GLTWAL01``, then a u64 **base seqno**
(the highest seqno ever dropped by a compaction reset, so seqnos stay
globally monotone across resets) and a u64 **base events** (the events
those dropped records held, so the lifetime event count survives).
A foreign or header-torn file is refused loudly, not replayed as empty.

Chaos site ``ingest.wal`` (`testing.chaos`): ``fail`` raises before
any byte lands; ``truncate`` writes a partial record and raises — the
torn tail the next open must absorb.

Env knob: ``GLT_INGEST_WAL_DIR`` — the log directory (the ingest
pipeline also keeps its compacted-base snapshots under it).
"""
from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

WAL_DIR_ENV = 'GLT_INGEST_WAL_DIR'

_MAGIC = b'GLTWAL01'
_BASE = struct.Struct('<QQ')          # base seqno, base events —
# the sequence position and cumulative event count covered by records
# a compaction reset dropped (both survive resets, keeping seqnos and
# the lifetime event count globally monotone)
_HEAD_LEN = len(_MAGIC) + _BASE.size
_HDR = struct.Struct('<IQI')          # crc32(payload), seqno, nbytes


def wal_dir_from_env() -> Optional[str]:
  return os.environ.get(WAL_DIR_ENV) or None


def _fsync_dir(path: Path) -> None:
  """fsync a DIRECTORY so a just-created/renamed entry survives power
  loss (file-content fsync alone does not pin the dir entry)."""
  try:
    fd = os.open(path, os.O_RDONLY)
  except OSError:          # platform without dir-open support
    return
  try:
    os.fsync(fd)
  finally:
    os.close(fd)


class WalCorruptionError(RuntimeError):
  """The log is unreadable beyond recovery (bad magic / a foreign
  file) — torn TAILS are absorbed by truncation, a bad HEAD is not."""


@dataclass(frozen=True)
class WalRecord:
  """One replayable edge-insert batch."""
  seqno: int
  src: np.ndarray
  dst: np.ndarray

  @property
  def count(self) -> int:
    return int(self.src.shape[0])


def _encode_payload(src: np.ndarray, dst: np.ndarray) -> bytes:
  src = np.ascontiguousarray(src, np.int64)
  dst = np.ascontiguousarray(dst, np.int64)
  if src.shape != dst.shape or src.ndim != 1:
    raise ValueError(
        f'src/dst must be equal-length 1-D arrays, got {src.shape} '
        f'vs {dst.shape}')
  return (struct.pack('<I', len(src)) + src.tobytes() + dst.tobytes())


def _decode_payload(payload: bytes) -> tuple:
  (count,) = struct.unpack_from('<I', payload, 0)
  need = 4 + 16 * count
  if len(payload) != need:
    raise ValueError(f'payload holds {len(payload)} bytes, '
                     f'count={count} needs {need}')
  src = np.frombuffer(payload, np.int64, count, offset=4).copy()
  dst = np.frombuffer(payload, np.int64, count, offset=4 + 8 * count
                      ).copy()
  return src, dst


class WriteAheadLog:
  """One durable, replayable event log under ``directory/wal.log``.

  :meth:`open` (called by the constructor) performs the recovery
  scan: validate the header, walk the records, truncate a torn tail,
  and position the append cursor + next seqno after the last whole
  record.  All mutating state is guarded by one lock: appenders may
  race a scraper reading the counters.
  """

  def __init__(self, directory: Optional[str] = None):
    import threading
    directory = directory or wal_dir_from_env()
    if directory is None:
      raise ValueError('WriteAheadLog needs a directory (argument or '
                       f'{WAL_DIR_ENV})')
    self.directory = Path(directory)
    self.directory.mkdir(parents=True, exist_ok=True)
    self.path = self.directory / 'wal.log'
    self._lock = threading.Lock()
    self._file = None          # guarded-by: self._lock — persistent
    # append handle (one open per recovery scan, not per record)
    self._last_seqno = 0       # guarded-by: self._lock
    self._total_events = 0     # guarded-by: self._lock
    self._base_events = 0      # guarded-by: self._lock
    self._end_offset = 0       # guarded-by: self._lock
    self._truncations = 0      # guarded-by: self._lock
    self.open()
    # memory accounting: the durable bill is the cursor position (valid
    # bytes), not the file size — a torn tail is not retained state
    from ..telemetry.memaccount import register_tier
    register_tier('wal', lambda: int(self._end_offset))

  # -- recovery scan --------------------------------------------------------
  def open(self) -> None:
    """Scan the log, absorb a torn tail, position the cursor.  Safe
    to call again (a re-open re-derives the counters from disk)."""
    with self._lock:
      self._open_locked()

  def _open_locked(self) -> None:
    if self._file is not None:
      self._file.close()
      self._file = None
    if not self.path.exists():
      with open(self.path, 'wb') as f:
        f.write(_MAGIC + _BASE.pack(0, 0))
        f.flush()
        os.fsync(f.fileno())
      # pin the new dir entry: an acked append must survive power loss
      _fsync_dir(self.directory)
      self._file = open(self.path, 'r+b')
      self._last_seqno = 0
      self._total_events = 0
      self._base_events = 0
      self._end_offset = _HEAD_LEN
      return
    blob = self.path.read_bytes()
    if len(blob) < _HEAD_LEN or blob[:len(_MAGIC)] != _MAGIC:
      raise WalCorruptionError(
          f'{self.path} does not start with the WAL header — '
          'refusing to replay a foreign or header-torn file')
    base, base_events = _BASE.unpack_from(blob, len(_MAGIC))
    off = _HEAD_LEN
    last_seqno = int(base)
    self._base_events = int(base_events)
    events = 0
    good_end = off
    torn = False
    while off < len(blob):
      if off + _HDR.size > len(blob):
        torn = True
        break
      crc, seqno, nbytes = _HDR.unpack_from(blob, off)
      payload = blob[off + _HDR.size: off + _HDR.size + nbytes]
      if len(payload) != nbytes or zlib.crc32(payload) != crc:
        torn = True
        break
      try:
        src, _dst = _decode_payload(payload)
      except ValueError:
        torn = True
        break
      last_seqno = seqno
      events += len(src)
      off += _HDR.size + nbytes
      good_end = off
    self._file = open(self.path, 'r+b')
    if torn:
      dropped = len(blob) - good_end
      self._file.truncate(good_end)
      self._file.flush()
      os.fsync(self._file.fileno())
      self._truncations += 1
      from ..telemetry.recorder import recorder
      recorder.emit('ingest.wal_truncate', path=str(self.path),
                    offset=int(good_end), dropped_bytes=int(dropped),
                    last_seqno=int(last_seqno))
    self._last_seqno = last_seqno
    self._total_events = events
    self._end_offset = good_end

  # -- write side -----------------------------------------------------------
  def append(self, src, dst) -> int:
    """Durably append one edge-insert batch; returns its seqno.

    The record is assembled fully in memory and lands in ONE write +
    flush(+fsync) at the scanned end offset — appending after a
    recovered torn tail overwrites the carcass bytes, never splices
    into them.  Chaos ``ingest.wal``: ``fail`` raises with the log
    untouched; ``truncate`` lands HALF the record then raises (the
    kill-mid-append the next open truncates away).
    """
    from ..testing import chaos
    payload = _encode_payload(np.asarray(src), np.asarray(dst))
    actions = chaos.ingest_wal_faults('append')
    with self._lock:
      seqno = self._last_seqno + 1
      rec = _HDR.pack(zlib.crc32(payload), seqno, len(payload)) \
          + payload
      torn = 'truncate' in actions
      f = self._file
      f.seek(self._end_offset)
      f.write(rec[:max(len(rec) // 2, 1)] if torn else rec)
      f.flush()
      os.fsync(f.fileno())
      if torn:
        raise chaos.InjectedFault(
            f'injected torn WAL append (seqno {seqno}: half a record '
            'on disk, process dies before the rest)')
      self._last_seqno = seqno
      self._total_events += len(np.asarray(src))
      self._end_offset += len(rec)
      return seqno

  def reset_to(self, seqno: int) -> None:
    """Drop every record with ``seqno <= watermark`` (the compaction
    epilogue: those events are durably inside the compacted base).
    The watermark is baked into the new header as the base seqno, so
    later appends continue the global sequence instead of reusing
    numbers the snapshot already covers.  Atomic: survivors are
    rewritten to a tmp file and renamed over the log — a kill
    mid-reset leaves the OLD log, whose extra records the seqno
    watermark makes harmless on replay."""
    seqno = int(seqno)
    keep = [rec for rec in self.replay() if rec.seqno > seqno]
    with self._lock:
      lifetime = self._base_events + self._total_events
    base_events = lifetime - sum(rec.count for rec in keep)
    tmp = self.path.with_suffix('.log.tmp')
    with open(tmp, 'wb') as f:
      f.write(_MAGIC + _BASE.pack(seqno, base_events))
      for rec in keep:
        payload = _encode_payload(rec.src, rec.dst)
        f.write(_HDR.pack(zlib.crc32(payload), rec.seqno,
                          len(payload)) + payload)
      f.flush()
      os.fsync(f.fileno())
    os.replace(tmp, self.path)
    _fsync_dir(self.directory)     # pin the rename itself
    with self._lock:
      self._open_locked()

  def close(self) -> None:
    """Release the persistent append handle (the log stays valid on
    disk; a later :meth:`open` re-acquires it)."""
    with self._lock:
      if self._file is not None:
        self._file.close()
        self._file = None

  # -- read side ------------------------------------------------------------
  def replay(self, after_seqno: int = 0) -> Iterator[WalRecord]:
    """Yield whole records with ``seqno > after_seqno`` in log order.
    Reads the scanned prefix only — a tail appended mid-iteration by
    another thread is the NEXT replay's business."""
    with self._lock:
      end = self._end_offset
    blob = self.path.read_bytes()[:end]
    off = _HEAD_LEN
    while off + _HDR.size <= len(blob):
      crc, seqno, nbytes = _HDR.unpack_from(blob, off)
      payload = blob[off + _HDR.size: off + _HDR.size + nbytes]
      if len(payload) != nbytes or zlib.crc32(payload) != crc:
        break                       # scanned end moved under us
      off += _HDR.size + nbytes
      if seqno <= after_seqno:
        continue
      src, dst = _decode_payload(payload)
      yield WalRecord(seqno=int(seqno), src=src, dst=dst)

  # -- counters -------------------------------------------------------------
  @property
  def last_seqno(self) -> int:
    with self._lock:
      return self._last_seqno

  @property
  def total_events(self) -> int:
    """Events across every whole record currently in the log."""
    with self._lock:
      return self._total_events

  @property
  def lifetime_events(self) -> int:
    """Events ever durably appended to this log, compaction resets
    included (the monotone appended-side of the lag gauge)."""
    with self._lock:
      return self._base_events + self._total_events

  @property
  def truncations(self) -> int:
    """Torn tails absorbed by this process's opens."""
    with self._lock:
      return self._truncations

  def stats(self) -> dict:
    with self._lock:
      return {'last_seqno': self._last_seqno,
              'total_events': self._total_events,
              'lifetime_events': self._base_events + self._total_events,
              'bytes': self._end_offset,
              'truncations': self._truncations}
