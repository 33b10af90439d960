"""Streaming graph ingest: WAL-backed delta-CSR with version-fenced,
RCU-published graph views — serving while the graph itself moves.

  * `wal` — checksummed, seqno-stamped write-ahead log (atomic append,
    torn-tail truncation, idempotent replay; the JAX package's on-disk
    format);
  * `delta` — delta segments merged into new immutable `GraphView`
    versions (the dirty rows through the rank kernel of
    `ops.delta_merge`); `StreamingGraph.pin` gives a reader one view
    per dispatch;
  * `ingest` — the crash-consistent pipeline (log -> apply -> publish
    -> compact) with live metrics, healthz and post-mortem coverage.

Knobs: ``GLT_INGEST_WAL_DIR``, ``GLT_INGEST_COMPACT_EVERY``,
``GLT_INGEST_MAX_LAG``.
"""
from .delta import DeltaSegment, GraphView, StreamingGraph, merge_delta_csr
from .ingest import IngestPipeline, compact_every_from_env, max_lag_from_env
from .wal import WalCorruptionError, WalRecord, WriteAheadLog, wal_dir_from_env

__all__ = [
    'DeltaSegment', 'GraphView', 'StreamingGraph', 'merge_delta_csr',
    'IngestPipeline', 'compact_every_from_env', 'max_lag_from_env',
    'WalCorruptionError', 'WalRecord', 'WriteAheadLog',
    'wal_dir_from_env',
]
