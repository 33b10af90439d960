"""CSR topology container (host numpy arrays).

Accepts a COO edge list, CSR or CSC and canonicalizes to CSR with
columns ascending within each row — byte-equal to the JAX package's
`CSRTopo` built from the same input.  The device handle is
:class:`~graphlearn_tpu_torch.data.graph.Graph`.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from ..utils import convert_to_array, coo_to_csr, csr_to_coo


class CSRTopo:
  """Canonical topology in CSR form (host numpy arrays).

  Args:
    edge_index: ``(rows, cols)`` pair or ``[2, E]`` array when
      ``layout='COO'``; ``(indptr, indices)`` when ``layout`` is
      ``'CSR'``/``'CSC'``.
    edge_ids: optional per-edge global ids; consecutive ints when absent.
    layout: one of ``'COO' | 'CSR' | 'CSC'``.
    num_nodes: optional node-count override (ids may exceed max seen).
  """

  def __init__(
      self,
      edge_index: Union[np.ndarray, Tuple[np.ndarray, np.ndarray]],
      edge_ids: Optional[np.ndarray] = None,
      layout: str = 'COO',
      num_nodes: Optional[int] = None,
  ):
    layout = layout.upper()
    if layout == 'COO':
      edge_index = convert_to_array(edge_index)
      rows, cols = np.asarray(edge_index[0]), np.asarray(edge_index[1])
      self._indptr, self._indices, self._edge_ids = coo_to_csr(
          rows, cols, num_nodes, edge_ids)
    elif layout in ('CSR', 'CSC'):
      indptr, indices = edge_index
      indptr = np.asarray(convert_to_array(indptr), dtype=np.int64)
      indices = np.asarray(convert_to_array(indices))
      if edge_ids is None:
        edge_ids = np.arange(len(indices), dtype=np.int64)
      edge_ids = np.asarray(convert_to_array(edge_ids))
      rows, cols = csr_to_coo(indptr, indices)
      if layout == 'CSC':
        # transpose into CSR; the node count must survive trailing
        # isolated nodes, and source ids may exceed the destination count
        n = max(num_nodes or 0, len(indptr) - 1,
                int(indices.max(initial=-1)) + 1)
        rows, cols = cols, rows
      else:
        # re-sort columns within rows: user CSR is not guaranteed sorted
        n = max(num_nodes or 0, len(indptr) - 1)
      self._indptr, self._indices, self._edge_ids = coo_to_csr(
          rows, cols, n, edge_ids)
    else:
      raise ValueError(f'Unsupported layout {layout!r}')
    self._indices = self._indices.astype(np.int32, copy=False)

  @property
  def indptr(self) -> np.ndarray:
    return self._indptr

  @property
  def indices(self) -> np.ndarray:
    return self._indices

  @property
  def edge_ids(self) -> np.ndarray:
    return self._edge_ids

  @property
  def num_nodes(self) -> int:
    return len(self._indptr) - 1

  @property
  def num_edges(self) -> int:
    return len(self._indices)

  @property
  def degrees(self) -> np.ndarray:
    return np.diff(self._indptr)

  def __repr__(self):
    return (f'CSRTopo(num_nodes={self.num_nodes}, '
            f'num_edges={self.num_edges})')
