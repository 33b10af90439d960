"""Partition failover: durable shards and ownership adoption (the JAX
package's `parallel/failover.py`).

Each partition's CSR, feature and label shard is durably re-loadable
(`ShardStore`: one ``shard{p}.npz`` a partition, every publish an atomic
tmp -> rename), written when a sampler is built with ``GLT_SHARD_DIR``
set.  When supervision classifies an owner dead (the chaos
``partition.owner`` site), a survivor adopts the orphaned range:

  1. `adopt_shard` loads the durable shard under ``GLT_ADOPT_TIMEOUT_S``
     (missing: `NoDurableShardError`, and the caller falls back to
     ``GLT_DEGRADED_OK``), validates it against the dataset's frozen
     widths and parks it on ``dataset.adopted_shards``;
  2. the book version bumps (`PartitionBook.adopt`);
  3. each sampler fences at its next dispatch: the adopted range's lane
     reads the payload, put on the card, instead of the dead owner's
     shard, and the epoch goes on with every batch byte-identical to the
     fault-free run.

The port's shards are card tensors: a payload is their host numpy copy,
byte-equal to the JAX package's payload of the same dataset.
"""
from __future__ import annotations

import json
import os
import threading
import time
import zlib
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .partition_book import AdoptionRefusedError, PartitionBook

SHARD_DIR_ENV = 'GLT_SHARD_DIR'
ADOPT_TIMEOUT_ENV = 'GLT_ADOPT_TIMEOUT_S'

#: the adoption budget (seconds): one shard's load and validation
DEFAULT_ADOPT_TIMEOUT_S = 120.0


class PartitionLostError(RuntimeError):
  """A partition owner was classified dead mid-epoch."""

  def __init__(self, msg: str, partition: Optional[int] = None):
    super().__init__(msg)
    self.partition = partition


class NoDurableShardError(RuntimeError):
  """Adoption was asked for but no durable copy of the orphaned
  partition exists: the ladder falls back to degraded completion
  (``GLT_DEGRADED_OK``) or raises."""


def _host(a) -> np.ndarray:
  return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def dataset_fingerprint(ds) -> int:
  """A cheap content fingerprint of a `DistDataset`: a CRC over a strided
  sample (at most ~64K entries) of the stacked indices, each partition's
  edge count and the bounds — the JAX package's bytes, so both packages
  fingerprint one graph alike.  A regenerated dataset of the same shape
  must not be served another graph's durable shards."""
  g = ds.graph
  flat = g.indices.reshape(-1)
  stride = max(1, flat.numel() // 65536)
  h = zlib.crc32(np.ascontiguousarray(_host(flat[::stride])).tobytes())
  h = zlib.crc32(np.ascontiguousarray(_host(g.indptr[:, -1])).tobytes(), h)
  h = zlib.crc32(np.ascontiguousarray(
      np.asarray(g.bounds, np.int64)).tobytes(), h)
  return int(h)


def adopt_timeout_s() -> float:
  try:
    return float(os.environ.get(ADOPT_TIMEOUT_ENV, DEFAULT_ADOPT_TIMEOUT_S))
  except ValueError:
    return DEFAULT_ADOPT_TIMEOUT_S


def shard_dir_from_env() -> Optional[str]:
  return os.environ.get(SHARD_DIR_ENV) or None


class ShardStore:
  """Durable per-partition shard snapshots: ``shard{p}.npz`` a partition
  and a ``SHARDS.json`` meta (partition count, widths, fingerprint).
  Every publish is atomic (tmp -> fsync -> rename): a kill mid-write
  leaves the previous shard, never a torn file."""

  def __init__(self, root):
    self.root = Path(root)
    self.root.mkdir(parents=True, exist_ok=True)

  def _shard_path(self, p: int) -> Path:
    return self.root / f'shard{int(p)}.npz'

  def _meta_path(self) -> Path:
    return self.root / 'SHARDS.json'

  def _publish(self, path: Path, write_fn) -> None:
    tmp = path.with_name(path.name + '.tmp')
    with open(tmp, 'wb') as f:
      write_fn(f)
      f.flush()
      os.fsync(f.fileno())
    os.replace(tmp, path)

  def save_shard(self, p: int, payload: Dict[str, np.ndarray]) -> None:
    arrays = {k: _host(v) for k, v in payload.items() if v is not None}
    self._publish(self._shard_path(p), lambda f: np.savez(f, **arrays))

  def save_meta(self, meta: Dict) -> None:
    data = json.dumps(meta, sort_keys=True).encode()
    self._publish(self._meta_path(), lambda f: f.write(data))

  def meta(self) -> Optional[Dict]:
    try:
      with open(self._meta_path()) as f:
        return json.load(f)
    except (OSError, ValueError):
      return None

  def load_shard(self, p: int) -> Dict[str, np.ndarray]:
    path = self._shard_path(p)
    if not path.exists():
      raise NoDurableShardError(
          f'no durable shard for partition {int(p)} under {self.root} — '
          'adoption unavailable; the documented fallback is '
          'GLT_DEGRADED_OK=1 (reduced completion)')
    with np.load(path, allow_pickle=False) as z:
      return {k: z[k] for k in z.files}

  def partitions(self):
    return sorted(int(f.stem[len('shard'):])
                  for f in self.root.glob('shard*.npz'))

  def write_dataset_shards(self, ds) -> int:
    """One durable shard a partition of a `DistDataset` and the meta;
    returns the shards written."""
    p = ds.graph.num_partitions
    for r in range(p):
      self.save_shard(r, shard_payload(ds, r))
    self.save_meta(dataset_meta(ds))
    return p

  def refresh_cb(self, ds):
    """A hook that rewrites the durable shards from the dataset's
    CURRENT stacks (the JAX package wires it to ingest's compaction
    seam; the port's mesh takes no stream yet, so callers run it
    themselves)."""
    def _refresh() -> None:
      self.write_dataset_shards(ds)
    return _refresh


def shard_payload(ds, r: int) -> Dict[str, np.ndarray]:
  """Range ``r``'s durable payload from the dataset's current stacks, as
  host numpy: ``indptr``, ``indices``, ``eids``, and where the dataset
  has them ``fshard`` + ``hot_count`` (+ ``cold``, the range's host-tier
  rows), ``lshard`` and ``efshard``.  Shared by the bulk write and the
  planned handoff's snapshot, so both write one shape."""
  g = ds.graph
  r = int(r)
  nf = ds.node_features
  bounds = np.asarray(g.bounds, np.int64)
  payload = {'indptr': _host(g.indptr[r]), 'indices': _host(g.indices[r]),
             'eids': _host(g.edge_ids[r])}
  if nf is not None:
    payload['fshard'] = _host(nf.shards[r])
    payload['hot_count'] = np.asarray([nf.hot_counts[r]], np.int64)
    if nf.cold_host is not None:
      payload['cold'] = _host(nf.cold_host[bounds[r]:bounds[r + 1]])
  if ds.node_labels is not None:
    payload['lshard'] = _host(ds.node_labels[r])
  if ds.edge_features is not None:
    payload['efshard'] = _host(ds.edge_features.shards[r])
  return payload


def dataset_meta(ds) -> Dict:
  """The store's meta record for a dataset: what `validate_shard_payload`
  checks a loaded shard against."""
  g = ds.graph
  return {'num_parts': int(g.num_partitions), 'num_nodes': int(g.num_nodes),
          'node_width': int(g.indptr.shape[1]),
          'edge_width': int(g.indices.shape[1]),
          'fingerprint': dataset_fingerprint(ds)}


def validate_shard_payload(ds, store: ShardStore,
                           payload: Dict[str, np.ndarray]
                           ) -> Dict[str, np.ndarray]:
  """Check the store's meta against the dataset's frozen shape, then
  widen the CSR rows to the dataset's stack widths.  Raises
  `AdoptionRefusedError` on a mismatch; returns the widened payload."""
  book: PartitionBook = ds.partition_book
  meta = store.meta() or {}
  if meta.get('num_parts') not in (None, book.num_partitions):
    raise AdoptionRefusedError(
        f"shard store {store.root} was written for {meta.get('num_parts')} "
        f'partitions, this dataset has {book.num_partitions}')
  g = ds.graph
  if meta.get('num_nodes') not in (None, int(g.num_nodes)):
    raise AdoptionRefusedError(
        f"shard store {store.root} was written for {meta.get('num_nodes')} "
        f'nodes, this dataset has {int(g.num_nodes)}')
  if meta.get('node_width') not in (None, int(g.indptr.shape[1])):
    raise AdoptionRefusedError(
        f"shard store {store.root} node width {meta.get('node_width')} != "
        f'dataset {int(g.indptr.shape[1])} (different bounds — not this '
        'graph)')
  if int(meta.get('edge_width') or 0) > int(g.indices.shape[1]):
    raise AdoptionRefusedError(
        f"shard store {store.root} edge width {meta.get('edge_width')} "
        f"exceeds the dataset's {int(g.indices.shape[1])} — truncation "
        'would corrupt the adopted CSR')
  indptr = np.asarray(payload['indptr'])
  payload['indptr'] = _pad_to(indptr, g.indptr.shape[1], int(indptr[-1]))
  payload['indices'] = _pad_to(np.asarray(payload['indices']),
                               g.indices.shape[1], -1)
  payload['eids'] = _pad_to(np.asarray(payload['eids']),
                            g.edge_ids.shape[1], -1)
  return payload


def _load_with_deadline(store: ShardStore, lost: int,
                        timeout_s: float) -> Dict[str, np.ndarray]:
  """`ShardStore.load_shard` on a worker thread under the adoption
  budget: a wedged store fails the adoption typed (the stuck daemon
  thread is abandoned) instead of wedging recovery."""
  box: Dict = {}

  def _run():
    try:
      box['payload'] = store.load_shard(lost)
    except BaseException as e:        # noqa: BLE001 — re-raised below
      box['err'] = e

  t = threading.Thread(target=_run, daemon=True,
                       name=f'glt-adopt-load-p{int(lost)}')
  t.start()
  t.join(max(timeout_s, 0.001))
  if t.is_alive():
    raise AdoptionRefusedError(
        f'adoption of partition {int(lost)} exceeded GLT_ADOPT_TIMEOUT_S='
        f'{adopt_timeout_s():g}s loading the durable shard (wedged '
        'store?)')
  if 'err' in box:
    raise box['err']
  return box['payload']


def _pad_to(arr: np.ndarray, width: int, fill) -> np.ndarray:
  """Widen (or cut) a loaded shard row to the dataset's stack width."""
  if arr.shape[0] >= width:
    return arr[:width] if arr.shape[0] > width else arr
  out = np.full((width,) + arr.shape[1:], fill, arr.dtype)
  out[:arr.shape[0]] = arr
  return out


def adopt_shard(ds, store: Optional[ShardStore], lost: int,
                survivor: Optional[int] = None) -> Dict:
  """One ownership transfer: load the durable shard, validate it, park it
  on ``ds.adopted_shards``, bump the book.  Returns ``survivor``,
  ``version`` and ``load_secs``.  Raises `NoDurableShardError` or
  `AdoptionRefusedError` without changing anything."""
  from ..telemetry.live import live
  from ..telemetry.recorder import recorder
  if store is None:
    d = shard_dir_from_env()
    if d is None:
      raise NoDurableShardError(
          'no shard store configured (GLT_SHARD_DIR unset) — adoption '
          'unavailable; GLT_DEGRADED_OK=1 is the documented fallback')
    store = ShardStore(d)
  book: PartitionBook = ds.partition_book
  lost = int(lost)
  t0 = time.monotonic()
  deadline = t0 + adopt_timeout_s()
  if survivor is None:
    survivor = book.pick_survivor(lost)
  payload = _load_with_deadline(store, lost, deadline - time.monotonic())
  payload = validate_shard_payload(ds, store, payload)
  if time.monotonic() > deadline:
    raise AdoptionRefusedError(
        f'adoption of partition {lost} exceeded GLT_ADOPT_TIMEOUT_S='
        f'{adopt_timeout_s():g}s while loading the durable shard')
  view = book.adopt(lost, int(survivor))
  ds.adopted_shards[lost] = payload
  secs = time.monotonic() - t0
  live.counter('partition.adoptions_total').inc()
  recorder.emit('partition.adopt', partition=lost, survivor=int(survivor),
                version=view.version, secs=round(secs, 6))
  return {'survivor': int(survivor), 'version': view.version,
          'load_secs': secs}
