"""Crash-consistent ingestion pipeline: WAL -> delta-CSR -> publish.

The orchestration layer of streaming ingest, ported from the JAX
package's `streaming/ingest.py`.  One :class:`IngestPipeline` owns one
:class:`~.wal.WriteAheadLog`, one :class:`~.delta.StreamingGraph` and
one compaction snapshot store (`utils.checkpoint.SnapshotManager`),
and guarantees:

  * **exactly-once** — an edge-insert batch is durably logged BEFORE
    it is applied; recovery restores the newest compacted base and
    replays only WAL records past its ``applied_seqno`` watermark.
    Kill the process at any of the chaos seams (``ingest.wal``,
    ``ingest.apply``, ``ingest.compact``), restart, and the recovered
    graph is byte-identical to a fault-free run over the same event
    sequence — no edge lost, none applied twice (pinned by
    ``tests/test_streaming.py``).
  * **compaction** — every ``GLT_INGEST_COMPACT_EVERY`` applied
    batches the current base is snapshotted (atomic tmp+rename via
    the Checkpointer) with its seqno watermark, and the WAL is reset
    to the surviving suffix — recovery time stays bounded by the
    compaction cadence, not the stream's lifetime.
  * **observability** — live metrics (``ingest.events_total``,
    ``ingest.lag_events``, ``graph.version``,
    ``ingest.compactions_total``), an ``ingestion`` healthz component
    (unhealthy when the apply lag exceeds ``GLT_INGEST_MAX_LAG``),
    and a post-mortem bundle on ingestion faults — the same black-box
    story every other subsystem carries.

Env knobs: ``GLT_INGEST_WAL_DIR`` (log + snapshot root),
``GLT_INGEST_COMPACT_EVERY`` (applied batches between compactions,
default 64; 0 disables), ``GLT_INGEST_MAX_LAG`` (healthz lag bound in
EVENTS, default 100000).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np

from .delta import StreamingGraph
from .wal import WriteAheadLog, wal_dir_from_env

COMPACT_EVERY_ENV = 'GLT_INGEST_COMPACT_EVERY'
MAX_LAG_ENV = 'GLT_INGEST_MAX_LAG'

DEFAULT_COMPACT_EVERY = 64
DEFAULT_MAX_LAG = 100_000


def _env_int(env: str, default: int) -> int:
  try:
    return int(os.environ.get(env, default))
  except ValueError:
    return default


def compact_every_from_env(default: int = DEFAULT_COMPACT_EVERY) -> int:
  return max(_env_int(COMPACT_EVERY_ENV, default), 0)


def max_lag_from_env(default: int = DEFAULT_MAX_LAG) -> int:
  return max(_env_int(MAX_LAG_ENV, default), 1)


class IngestPipeline:
  """Durable, observable edge-insert ingestion over one stream.

  Args:
    stream: the `StreamingGraph` to mutate (its published views are
      what samplers/serving pin).
    wal_dir: log + snapshot root (default ``GLT_INGEST_WAL_DIR``).
    compact_every: applied batches between compactions (default
      ``GLT_INGEST_COMPACT_EVERY``; 0 = never compact).
    max_lag: healthz bound on appended-but-unapplied EVENTS (default
      ``GLT_INGEST_MAX_LAG``).
    recover: replay the WAL tail over the newest compacted base at
      construction (the restart path; pass False to inspect state
      before replaying).
    shard_refresh: optional callable run after each durable
      compaction (a hook for stores that snapshot the compacted
      topology); its failures are recorded and absorbed.
  """

  def __init__(self, stream: StreamingGraph,
               wal_dir: Optional[str] = None,
               compact_every: Optional[int] = None,
               max_lag: Optional[int] = None,
               recover: bool = True,
               shard_refresh=None):
    from ..utils.checkpoint import SnapshotManager
    wal_dir = wal_dir or wal_dir_from_env()
    if wal_dir is None:
      raise ValueError('IngestPipeline needs a WAL directory '
                       '(argument or GLT_INGEST_WAL_DIR)')
    self.stream = stream
    self.wal = WriteAheadLog(wal_dir)
    self.compact_every = (compact_every if compact_every is not None
                          else compact_every_from_env())
    self.max_lag = (int(max_lag) if max_lag is not None
                    else max_lag_from_env())
    self._shard_refresh = shard_refresh
    self._snap = SnapshotManager(
        os.path.join(str(wal_dir), 'base'), every=1)
    # one writer at a time: ingest/compact/recover hold this across
    # the whole append->apply(->compact) sequence, so WAL seqno order
    # == apply (event) order — the property that makes a restart's
    # seqno-ordered replay byte-identical to the live graph.
    # Reentrant: ingest() calls compact() while holding it.
    self._writer_lock = threading.RLock()
    self._lock = threading.Lock()
    self._applied_seqno = 0      # guarded-by: self._lock
    self._applied_events = 0     # guarded-by: self._lock
    self._applies_since_compact = 0  # guarded-by: self._lock
    self._compactions = 0        # guarded-by: self._lock
    self._last_fault = None      # guarded-by: self._lock
    self._closed = False
    from ..telemetry.live import live
    self._events_ctr = live.counter('ingest.events_total')
    self._compact_ctr = live.counter('ingest.compactions_total')
    self._gauge_fns = (self._lag_events, self._graph_version)
    live.gauge('ingest.lag_events', fn=self._gauge_fns[0])
    live.gauge('graph.version', fn=self._gauge_fns[1])
    self._health_fn = self.health
    live.register_health('ingestion', self._health_fn)
    if recover:
      self.recover()

  # -- gauges / health -------------------------------------------------------
  def _lag_events(self) -> float:
    """Appended-but-unapplied events: both sides are LIFETIME-
    monotone (the WAL header carries the event count its compaction
    resets dropped), so the gauge survives compactions and restarts."""
    return float(max(self.wal.lifetime_events - self.applied_events,
                     0))

  def _graph_version(self) -> float:
    return float(self.stream.version)

  @property
  def applied_seqno(self) -> int:
    with self._lock:
      return self._applied_seqno

  @property
  def applied_events(self) -> int:
    with self._lock:
      return self._applied_events

  def health(self) -> dict:
    """The ``ingestion`` healthz component: seqnos, lag, version,
    compactions, the last absorbed fault.  Unhealthy when the apply
    lag exceeds ``max_lag`` (ingestion fell behind the log — the
    freshness contract is broken) or a fault was recorded since the
    last clean apply."""
    lag = int(self._lag_events())
    with self._lock:
      fault = self._last_fault
      applied_seqno = self._applied_seqno
      applied_events = self._applied_events
      compactions = self._compactions
    block = {
        'healthy': lag <= self.max_lag and fault is None,
        'wal_seqno': self.wal.last_seqno,
        'applied_seqno': applied_seqno,
        'lag_events': lag,
        'max_lag': self.max_lag,
        'applied_events': applied_events,
        'graph_version': self.stream.version,
        'num_edges': self.stream.num_edges,
        'compactions': compactions,
        'wal_truncations': self.wal.truncations,
    }
    if fault is not None:
      block['last_fault'] = fault
    return block

  def close(self) -> None:
    """Unregister this pipeline's live-registry callbacks (a torn-down
    pipeline's gauges must not keep exporting, or keep the stream
    alive, for the process's lifetime)."""
    from ..telemetry.live import live
    if self._closed:
      return
    self._closed = True
    live.unregister_gauge('ingest.lag_events', fn=self._gauge_fns[0])
    live.unregister_gauge('graph.version', fn=self._gauge_fns[1])
    live.unregister_health('ingestion', fn=self._health_fn)
    self.wal.close()
    self._snap.close()

  # -- ingest ---------------------------------------------------------------
  def ingest(self, src, dst) -> int:
    """Durably log + apply + publish one edge-insert batch; returns
    the batch's WAL seqno.  Ordering is the crash-consistency
    contract: the WAL append lands FIRST (a crash after it replays
    the batch on restart), the delta merge commits RCU-style second
    (a crash between the two is the ``ingest.apply`` chaos case), a
    due compaction runs last.  Faults dump a post-mortem bundle and
    re-raise typed."""
    src = np.asarray(src, np.int64).reshape(-1)
    dst = np.asarray(dst, np.int64).reshape(-1)
    with self._writer_lock:
      seqno = self.wal.append(src, dst)     # durability first
      try:
        self._apply(seqno, src, dst)
      except Exception as e:                # noqa: BLE001 — typed
        self._record_fault('apply', e)      # re-raise below
        raise
      if self.compact_every > 0:
        with self._lock:
          due = self._applies_since_compact >= self.compact_every
        if due:
          self.compact()
      return seqno

  def _apply(self, seqno: int, src, dst) -> None:
    from ..testing import chaos
    chaos.ingest_apply_check(seqno)
    self.stream.apply_events(src, dst)
    with self._lock:
      self._applied_seqno = seqno
      self._applied_events += len(src)
      self._applies_since_compact += 1
      self._last_fault = None
    self._events_ctr.inc(len(src))

  def _record_fault(self, site: str, error: BaseException) -> None:
    from ..telemetry import postmortem
    from ..telemetry.recorder import recorder
    with self._lock:
      self._last_fault = f'{site}: {type(error).__name__}: {error}'
    recorder.emit('ingest.fault', site=site,
                  error=f'{type(error).__name__}: {error}'[:200])
    postmortem.dump(f'ingest.{site}', error,
                    extra={'wal_seqno': self.wal.last_seqno,
                           'applied_seqno': self.applied_seqno,
                           'graph_version': self.stream.version})

  # -- compaction -----------------------------------------------------------
  def compact(self) -> bool:
    """Snapshot the current base + seqno watermark (atomic publish),
    then reset the WAL to the surviving suffix.  A kill mid-compaction
    (chaos ``ingest.compact``) leaves the previous snapshot + the full
    WAL — replay over them reproduces the identical graph.  A FAILED
    snapshot write is absorbed (SnapshotManager contract): the WAL
    keeps the whole history, nothing is lost."""
    from ..telemetry.recorder import recorder
    from ..testing import chaos
    t0 = time.perf_counter()
    with self._writer_lock:
      with self._lock:
        watermark = self._applied_seqno
        applied_events = self._applied_events
      try:
        chaos.ingest_compact_check(watermark)
      except Exception as e:                # noqa: BLE001 — typed
        self._record_fault('compact', e)
        raise
      ok = self._snap.save(
          plane={'graph': self.stream.state_dict()},
          progress={'applied_seqno': np.int64(watermark),
                    'applied_events': np.int64(applied_events)})
      if ok:
        self.wal.reset_to(watermark)
      with self._lock:
        self._applies_since_compact = 0
        if ok:
          self._compactions += 1
      if ok and self._shard_refresh is not None:
        # still under the writer lock: the hook must see the exact
        # compacted state, not a concurrently advancing one
        try:
          self._shard_refresh()
        except Exception as e:            # noqa: BLE001 — absorbed
          self._record_fault('shard_refresh', e)
    if ok:
      self._compact_ctr.inc()
    recorder.emit('ingest.compact', ok=bool(ok),
                  seqno=int(watermark), events=int(applied_events),
                  secs=round(time.perf_counter() - t0, 4))
    return bool(ok)

  # -- recovery -------------------------------------------------------------
  def recover(self) -> dict:
    """Restore the newest compacted base (if any), then replay the
    WAL tail past its watermark — idempotent by seqno, so running it
    on a fresh directory, after a clean shutdown, or after any chaos
    kill all land on the same graph.  Returns ``{'restored',
    'replayed_records', 'replayed_events', 'skipped_records',
    'applied_seqno'}`` and emits one ``ingest.replay`` event."""
    from ..telemetry.recorder import recorder
    t0 = time.perf_counter()
    restored = False
    snap = self._snap.restore_latest()
    with self._writer_lock:
      if snap is not None:
        # the stream is RESET to the snapshot base, so replay from
        # the snapshot watermark reconstructs everything durably
        # logged — correct even on a live pipeline that was ahead
        self.stream.load_state_dict(snap['plane']['graph'])
        watermark = int(np.asarray(snap['progress']['applied_seqno']))
        events = int(np.asarray(snap['progress']['applied_events']))
        restored = True
      else:
        # no base to reset to: the stream keeps what this process
        # already applied, so replay must start at the IN-MEMORY
        # watermark — from 0 it would re-apply every logged batch
        # (recover() on a live pipeline must be a no-op)
        with self._lock:
          watermark = self._applied_seqno
          events = self._applied_events
      replayed = replayed_events = skipped = 0
      for rec in self.wal.replay():
        if rec.seqno <= watermark:
          skipped += 1
          continue
        self._apply(rec.seqno, rec.src, rec.dst)
        watermark = rec.seqno
        replayed += 1
        replayed_events += rec.count
      with self._lock:
        self._applied_seqno = watermark
        self._applied_events = events + replayed_events
        self._last_fault = None
    out = {'restored': restored, 'replayed_records': replayed,
           'replayed_events': replayed_events,
           'skipped_records': skipped, 'applied_seqno': watermark,
           'secs': round(time.perf_counter() - t0, 4)}
    recorder.emit('ingest.replay', **out)
    return out

  def stats(self) -> dict:
    with self._lock:
      return {'applied_seqno': self._applied_seqno,
              'applied_events': self._applied_events,
              'compactions': self._compactions,
              'graph_version': self.stream.version,
              'wal': self.wal.stats()}
