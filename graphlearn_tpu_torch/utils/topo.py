"""Topology conversions (COO <-> CSR) on the host, in numpy.

Byte-equal to the JAX package's `utils/topo.py`: CSR rows are sorted by
``(row, col)`` with a stable lexsort, so columns ascend within a row and
``edge_ids`` carry the original COO positions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def coo_to_csr(
    rows: np.ndarray,
    cols: np.ndarray,
    num_nodes: Optional[int] = None,
    edge_ids: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Sort a COO edge list into CSR.

  Returns ``(indptr[num_nodes+1], indices[E], edge_ids[E])``; without
  ``edge_ids`` the original COO positions are used.
  """
  rows = np.asarray(rows)
  cols = np.asarray(cols)
  max_row = int(rows.max(initial=-1))
  if num_nodes is None:
    num_nodes = int(max(max_row, cols.max(initial=-1))) + 1
  elif max_row >= num_nodes:
    # rows index indptr; columns may exceed the row count (bipartite)
    raise ValueError(
        f'source node id {max_row} out of range for num_nodes={num_nodes}')
  if len(rows) and int(min(rows.min(), cols.min())) < 0:
    raise ValueError('edge endpoint ids must be non-negative')
  if edge_ids is None:
    edge_ids = np.arange(len(rows), dtype=np.int64)
  else:
    edge_ids = np.asarray(edge_ids)
  perm = np.lexsort((cols, rows))
  sorted_rows = rows[perm]
  indices = cols[perm]
  edge_ids = edge_ids[perm]
  counts = np.bincount(sorted_rows, minlength=num_nodes)
  indptr = np.zeros(num_nodes + 1, dtype=np.int64)
  np.cumsum(counts, out=indptr[1:])
  return indptr, indices, edge_ids


def ptr2ind(indptr: np.ndarray) -> np.ndarray:
  """Expand a CSR ptr array into per-edge row ids."""
  indptr = np.asarray(indptr)
  n = len(indptr) - 1
  return np.repeat(np.arange(n, dtype=indptr.dtype), np.diff(indptr))


def csr_to_coo(indptr, indices) -> Tuple[np.ndarray, np.ndarray]:
  return ptr2ind(indptr), np.asarray(indices)
