"""POSIX-shm-backed numpy arrays for non-fork producer workers.

The JAX package's `distributed/shm_arrays.py`.  A ``fork`` after the
trainer has initialised CUDA (or started any runtime thread) is unsafe:
the child can inherit held locks and deadlock.  The default start
method is ``forkserver``: workers descend from a clean server process
with no CUDA context, and the dataset crosses the boundary through
POSIX shared memory — ONE copy at producer init, zero copies per
worker, instead of pickling the arrays into every child.

`share_dataset` converts a `HostDataset` / `HostHeteroDataset` into a
picklable `SharedDatasetHandle` plus the parent-side segments (close +
unlink them at shutdown); `SharedDatasetHandle.materialize` rebuilds
the dataset in a worker as zero-copy views over the attached segments.
"""
from __future__ import annotations

from multiprocessing import shared_memory
from typing import List, Optional, Tuple

import numpy as np

from .host_dataset import HostDataset, HostHeteroDataset


class SharedArrayHandle:
  """Picklable (name, shape, dtype) recipe for an shm-backed array."""

  def __init__(self, name: str, shape, dtype):
    self.name = name
    self.shape = tuple(shape)
    self.dtype = np.dtype(dtype)

  def attach(self) -> Tuple[np.ndarray, shared_memory.SharedMemory]:
    """Zero-copy view; caller must keep the returned segment alive for
    the array's lifetime."""
    shm = shared_memory.SharedMemory(name=self.name)
    arr = np.ndarray(self.shape, self.dtype, buffer=shm.buf)
    return arr, shm


def to_shared(arr: Optional[np.ndarray]):
  """Copy ``arr`` into a fresh shm segment.  Returns
  ``(handle, segment)`` (both None for a None array)."""
  if arr is None:
    return None, None
  arr = np.ascontiguousarray(arr)
  shm = shared_memory.SharedMemory(create=True, size=max(arr.nbytes, 1))
  view = np.ndarray(arr.shape, arr.dtype, buffer=shm.buf)
  view[...] = arr
  return SharedArrayHandle(shm.name, arr.shape, arr.dtype), shm


class SharedDatasetHandle:
  """Picklable reconstruction recipe for a host dataset in shm."""

  def __init__(self, kind: str, fields: dict, meta: dict):
    self.kind = kind              # 'homo' | 'hetero'
    self.fields = fields          # name -> handle | {key -> handle}
    self.meta = meta              # non-array fields

  def materialize(self):
    """Rebuild the dataset from shm.  Returns ``(dataset, segments)``;
    the worker must hold ``segments`` as long as the dataset lives."""
    segs: List[shared_memory.SharedMemory] = []

    def get(h):
      if h is None:
        return None
      arr, shm = h.attach()
      segs.append(shm)
      return arr

    if self.kind == 'homo':
      ds = HostDataset(
          get(self.fields['indptr']), get(self.fields['indices']),
          edge_ids=get(self.fields['edge_ids']),
          node_features=get(self.fields['node_features']),
          node_labels=get(self.fields['node_labels']),
          edge_features=get(self.fields['edge_features']))
      # shard identity survives the boundary so workers can build the
      # cross-server sampler (`host_dist_sampler.py`)
      ds.node_pb = get(self.fields.get('node_pb'))
      ds.partition_idx = self.meta.get('partition_idx')
      return ds, segs
    csr = {et: (get(ip), get(ix), get(ei))
           for et, (ip, ix, ei) in self.fields['csr'].items()}
    ds = HostHeteroDataset(
        csr, self.meta['num_nodes'],
        node_features={nt: get(h)
                       for nt, h in self.fields['node_features'].items()},
        node_labels={nt: get(h)
                     for nt, h in self.fields['node_labels'].items()},
        edge_features={et: get(h)
                       for et, h in self.fields['edge_features'].items()})
    pb = self.fields.get('node_pb')
    ds.node_pb = ({nt: get(h) for nt, h in pb.items()}
                  if pb is not None else None)
    ds.partition_idx = self.meta.get('partition_idx')
    return ds, segs


def share_dataset(ds):
  """``(SharedDatasetHandle, parent_segments)`` for a host dataset."""
  segs: List[shared_memory.SharedMemory] = []

  def put(arr):
    h, s = to_shared(arr)
    if s is not None:
      segs.append(s)
    return h

  if isinstance(ds, HostHeteroDataset):
    pb = getattr(ds, 'node_pb', None)
    fields = {
        'csr': {et: tuple(put(a) for a in csr)
                for et, csr in ds.csr.items()},
        'node_features': {nt: put(a)
                          for nt, a in ds.node_features.items()},
        'node_labels': {nt: put(a) for nt, a in ds.node_labels.items()},
        'edge_features': {et: put(a)
                          for et, a in ds.edge_features.items()},
        'node_pb': ({nt: put(a) for nt, a in pb.items()}
                    if pb is not None else None),
    }
    meta = {'num_nodes': dict(ds.num_nodes),
            'partition_idx': getattr(ds, 'partition_idx', None)}
    return SharedDatasetHandle('hetero', fields, meta), segs
  fields = {
      'indptr': put(ds.indptr), 'indices': put(ds.indices),
      'edge_ids': put(ds.edge_ids),
      'node_features': put(ds.node_features),
      'node_labels': put(ds.node_labels),
      'edge_features': put(ds.edge_features),
      'node_pb': put(getattr(ds, 'node_pb', None)),
  }
  meta = {'partition_idx': getattr(ds, 'partition_idx', None)}
  return SharedDatasetHandle('homo', fields, meta), segs


def release(segs) -> None:
  """Parent-side cleanup: close + unlink every segment."""
  for s in segs or ():
    try:
      s.close()
      s.unlink()
    except Exception:
      pass
