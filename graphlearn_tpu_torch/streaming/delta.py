"""Delta-CSR segments and RCU-published graph versions.

The mutation half of streaming ingest.  Every static structure the
serving path holds (the sampler's CSR, the engine's pinned graph)
assumes the CSR it was handed never changes.  This module makes change
safe by never changing anything a reader holds:

  * **delta segments** — each applied edge-insert batch is one
    :class:`DeltaSegment`;
  * **merge** — :func:`merge_delta_csr` (the host reference, a per-row
    stable sort of the dirty rows) and
    `ops.delta_merge.merge_delta_csr_device` (the dirty rows merged by
    the rank kernel) fold a segment into the base CSR; both give arrays
    byte-identical to `utils.topo.coo_to_csr` over the full
    event-ordered edge list, so a quiesced streamed graph is
    indistinguishable from the same graph loaded statically;
  * **RCU publish** — each merge lands as a NEW immutable
    :class:`GraphView` behind a monotonically increasing version;
    readers :meth:`StreamingGraph.pin` one view for a whole dispatch,
    writers replace the reference and never mutate a published view.

**Device twins.**  A view carries ``indptr_dev`` (int64, the dtype the
port's sampler takes) and ``indices_dev`` (int32, padded to a power-of-
two capacity that ``reserve_edges`` floors, tail zero-filled).  The
padded tail is never read: every kernel bounds its reads by
``indptr``.  So ``indices_dev.numel()`` is the CAPACITY; the edge count
is the host arrays' (`GraphView.num_edges`).  A view's twins are copied
in full, and the copy has completed, before the view is published: the
serving thread may read them on its next dispatch.

A stream on CUDA merges through the rank kernel or raises; a stream on
the CPU merges through the kernel's plain version.  There is no knob
and no fallback between them.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.delta_merge import merge_delta_csr_device
from ..utils import (coo_to_csr, next_power_of_two, ptr2ind,
                     resolve_device)


@dataclass(frozen=True)
class DeltaSegment:
  """One applied edge-insert batch.  ``eids`` are the global event
  positions — the consecutive ids `data.topology.CSRTopo` fabricates,
  so streamed and static edge identity agree."""
  src: np.ndarray
  dst: np.ndarray
  eids: np.ndarray

  @property
  def count(self) -> int:
    return int(self.src.shape[0])


def merge_delta_csr(indptr: np.ndarray, indices: np.ndarray,
                    eids: np.ndarray, seg: DeltaSegment
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Fold one delta segment into a sorted CSR on the host (the
  reference the device merge is held to).

  Byte-identity contract: the result equals
  ``coo_to_csr(base_coo ++ segment_coo)`` — the base edges keep their
  within-row order, segment edges append in event order, and each
  DIRTY row is re-sorted by column with a STABLE sort, so duplicate
  columns tie-break by event order.  Clean rows move by one vectorized
  shift; the per-row loop runs only over the segment's distinct
  source rows.
  """
  num_nodes = len(indptr) - 1
  src = np.asarray(seg.src, np.int64)
  if src.size and (src.min() < 0 or src.max() >= num_nodes):
    raise ValueError(
        f'delta source ids out of range for num_nodes={num_nodes}')
  add = np.bincount(src, minlength=num_nodes).astype(np.int64)
  new_indptr = np.zeros(num_nodes + 1, np.int64)
  np.cumsum(np.diff(indptr) + add, out=new_indptr[1:])
  e_new = int(new_indptr[-1])
  new_indices = np.empty(e_new, indices.dtype)
  new_eids = np.empty(e_new, eids.dtype)
  if len(indices):
    pos = np.arange(len(indices)) + (new_indptr[:-1] - indptr[:-1]
                                     )[ptr2ind(indptr)]
    new_indices[pos] = indices
    new_eids[pos] = eids
  # segment edges at each dirty row's tail, in event order
  order = np.argsort(src, kind='stable')
  tail_base = new_indptr[src[order]] + np.diff(indptr)[src[order]]
  tail_off = np.arange(len(src)) - np.concatenate(
      [[0], np.cumsum(add)])[src[order]]
  tail_pos = tail_base + tail_off
  new_indices[tail_pos] = np.asarray(seg.dst)[order].astype(
      new_indices.dtype)
  new_eids[tail_pos] = np.asarray(seg.eids)[order].astype(new_eids.dtype)
  for r in np.unique(src):
    lo, hi = int(new_indptr[r]), int(new_indptr[r + 1])
    sl = new_indices[lo:hi]
    perm = np.argsort(sl, kind='stable')
    new_indices[lo:hi] = sl[perm]
    new_eids[lo:hi] = new_eids[lo:hi][perm]
  return new_indptr, new_indices, new_eids


@dataclass(frozen=True)
class GraphView:
  """One immutable published graph version.

  ``indptr`` / ``indices`` / ``edge_ids`` are host arrays trimmed to
  the real edge count; ``indptr_dev`` (int64) / ``indices_dev`` (int32,
  power-of-two padded) are the device twins.  A reader pins ONE view
  per dispatch; everything it touches through the view is frozen."""
  version: int
  indptr: np.ndarray
  indices: np.ndarray
  edge_ids: np.ndarray
  indptr_dev: torch.Tensor = field(repr=False)
  indices_dev: torch.Tensor = field(repr=False)

  @property
  def num_nodes(self) -> int:
    return len(self.indptr) - 1

  @property
  def num_edges(self) -> int:
    return int(self.indices.shape[0])


class StreamingGraph:
  """A mutable graph publishing immutable `GraphView` versions.

  Writers: :meth:`apply_events` merges one delta segment and publishes
  the result as version ``N+1`` (the previous view stays valid for
  whoever pinned it).  Readers: :meth:`pin` returns the current view —
  one attribute read of an immutable object, from any thread, no lock.

  Args:
    indptr/indices/edge_ids: the base CSR (canonical sorted form — build
      through `coo_to_csr` first); ``edge_ids`` default to positions.
    num_nodes: the fixed node universe (edge inserts only).
    reserve_edges: floor for the padded device-indices capacity; size
      it to the expected growth so steady ingest publishes at ONE
      capacity.
    device: where the device twins live and the merge ranks run
      (default ``'cuda'``; raises without CUDA).
  """

  def __init__(self, indptr, indices, edge_ids=None,
               num_nodes: Optional[int] = None, reserve_edges: int = 0,
               device='cuda'):
    self.device = resolve_device(device)
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices)
    if num_nodes is not None and len(indptr) - 1 != int(num_nodes):
      raise ValueError(f'indptr implies {len(indptr) - 1} nodes, '
                       f'num_nodes={num_nodes} was given')
    if edge_ids is None:
      edge_ids = np.arange(len(indices), dtype=np.int64)
    self._lock = threading.Lock()
    self._edge_cap = next_power_of_two(
        max(int(reserve_edges), len(indices), 1))
    self._num_events = len(indices)          # guarded-by: self._lock
    self._view: GraphView = self._build_view(
        1, indptr, indices, np.asarray(edge_ids, np.int64))
    from ..telemetry.memaccount import register_tier

    def _stream_bytes():
      v = self._view
      return (v.indptr.nbytes + v.indices.nbytes + v.edge_ids.nbytes
              + v.indptr_dev.numel() * v.indptr_dev.element_size()
              + v.indices_dev.numel() * v.indices_dev.element_size())

    register_tier('streaming', _stream_bytes)

  def _build_view(self, version: int, indptr, indices, eids) -> GraphView:
    """A view with its device twins, fully copied before it returns."""
    if len(indices) > self._edge_cap:
      self._edge_cap = next_power_of_two(len(indices))
    dev = self.device
    indices_dev = torch.zeros(self._edge_cap, dtype=torch.int32,
                              device=dev)
    indices_dev[:len(indices)].copy_(torch.from_numpy(
        np.ascontiguousarray(indices, np.int32)))
    indptr_dev = torch.from_numpy(np.ascontiguousarray(indptr)).to(dev)
    if dev.type == 'cuda':
      # the publish is one reference assignment that a serving thread
      # on another stream may read at once: the copies must have landed
      torch.cuda.current_stream(dev).synchronize()
    return GraphView(version=version, indptr=indptr,
                     indices=np.asarray(indices),
                     edge_ids=np.asarray(eids, np.int64),
                     indptr_dev=indptr_dev, indices_dev=indices_dev)

  # -- read side (lock-free) -------------------------------------------------
  def pin(self) -> GraphView:
    """The current published view.  Immutable — hold it for the whole
    dispatch and every read is from exactly one version."""
    return self._view

  @property
  def version(self) -> int:
    return self._view.version

  @property
  def num_nodes(self) -> int:
    return self._view.num_nodes

  @property
  def num_edges(self) -> int:
    return self._view.num_edges

  @property
  def edge_capacity(self) -> int:
    """The padded device-indices capacity (it grows only by doubling,
    when an edge count passes it)."""
    return self._edge_cap

  # -- write side ------------------------------------------------------------
  def apply_events(self, src, dst) -> GraphView:
    """Merge one edge-insert batch and publish it as the next version.
    The merge builds entirely NEW arrays; the swap is one reference
    assignment under the writer lock — a concurrent reader holds either
    the old complete view or the new complete view.  Emits one
    ``stream.publish`` event with the phases' host wall milliseconds."""
    from ..telemetry.recorder import recorder
    src = np.asarray(src, np.int64).reshape(-1)
    dst = np.asarray(dst, np.int64).reshape(-1)
    if src.shape != dst.shape:
      raise ValueError(f'src/dst lengths differ: {src.shape} vs '
                       f'{dst.shape}')
    if dst.size and (dst.min() < 0 or dst.max() >= self.num_nodes):
      # src is range-checked by the merge (it indexes indptr); an
      # out-of-range dst would publish cleanly and read garbage later
      raise ValueError(f'delta destination ids out of range for '
                       f'num_nodes={self.num_nodes}')
    with self._lock:
      t0 = time.perf_counter()
      prev = self._view
      seg = DeltaSegment(src=src, dst=dst, eids=np.arange(
          self._num_events, self._num_events + len(src), dtype=np.int64))
      timings = {}
      new_indptr, new_indices, new_eids = merge_delta_csr_device(
          prev.indptr, prev.indices, prev.edge_ids, seg,
          indices_dev=prev.indices_dev,
          device=self.device, timings=timings)
      t1 = time.perf_counter()
      view = self._build_view(prev.version + 1, new_indptr, new_indices,
                              new_eids)
      t2 = time.perf_counter()
      self._num_events += len(src)
      self._view = view
    recorder.emit('stream.publish', version=view.version,
                  events=seg.count, edges=view.num_edges,
                  capacity=self._edge_cap,
                  shift_ms=timings['shift'] * 1e3,
                  ranks_ms=timings['ranks'] * 1e3,
                  scatter_ms=timings['scatter'] * 1e3,
                  copy_ms=(t2 - t1) * 1e3, total_ms=(t2 - t0) * 1e3)
    return view

  # -- DataPlaneState (utils.checkpoint): the compacted base ----------------
  def state_dict(self) -> dict:
    with self._lock:
      view = self._view
      num_events = self._num_events
      cap = self._edge_cap
    return {'indptr': view.indptr, 'indices': view.indices,
            'edge_ids': view.edge_ids, 'version': np.int64(view.version),
            'num_events': np.int64(num_events), 'edge_cap': np.int64(cap)}

  def load_state_dict(self, state: dict) -> None:
    with self._lock:
      self._edge_cap = max(self._edge_cap,
                           int(np.asarray(state['edge_cap'])))
      self._num_events = int(np.asarray(state['num_events']))
      self._view = self._build_view(
          int(np.asarray(state['version'])),
          np.asarray(state['indptr'], np.int64),
          np.asarray(state['indices']),
          np.asarray(state['edge_ids'], np.int64))

  @classmethod
  def from_coo(cls, rows, cols, num_nodes: Optional[int] = None,
               reserve_edges: int = 0, device='cuda') -> 'StreamingGraph':
    """Build from a COO edge list through the SAME canonicalization as
    `data.topology.CSRTopo` (`coo_to_csr`, consecutive edge ids) — the
    static-load twin of a stream that ingested the same edges."""
    indptr, indices, eids = coo_to_csr(np.asarray(rows), np.asarray(cols),
                                       num_nodes)
    return cls(indptr, indices, eids, reserve_edges=reserve_edges,
               device=device)
