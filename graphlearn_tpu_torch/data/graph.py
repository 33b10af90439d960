"""Device-resident graph handle: CSR ``indptr`` (int64) and ``indices``
(int32) as torch tensors on one device.

Unlike the JAX package, ``indptr`` stays int64 at every size (edge
positions never narrow); sampled ids are int32 either way.  A graph
over a streaming view (`from_view`) holds the view's padded
``indices``: its edge count is the view's, not ``indices.numel()``.

``edge_ids`` (int32, one per CSR position: the edge's id in the input,
e.g. its COO index) go to the device on first use, as the JAX package
puts them there with ``with_edge_ids``: only a sampler asked for edge
ids reads them, so a graph that never emits edge ids never holds them
on the card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import resolve_device
from .topology import CSRTopo


class Graph:
  """Topology ready for device sampling.

  Args:
    csr_topo: canonical host CSR (`CSRTopo`).
    device: where ``indptr``/``indices`` live (default ``'cuda'``).
  """

  def __init__(self, csr_topo: Optional[CSRTopo], device='cuda'):
    dev = resolve_device(device)
    self.csr_topo = csr_topo
    self._num_edges: Optional[int] = None
    self._max_degree: Optional[int] = None
    self._edge_ids: Optional[torch.Tensor] = None
    if csr_topo is not None:
      self.indptr = torch.from_numpy(
          np.asarray(csr_topo.indptr, np.int64)).to(dev)
      self.indices = torch.from_numpy(
          np.asarray(csr_topo.indices, np.int32)).to(dev)

  @classmethod
  def from_tensors(cls, indptr: torch.Tensor, indices: torch.Tensor,
                   device='cuda', edge_ids=None) -> 'Graph':
    """Wrap CSR tensors that are already canonical (columns sorted
    within rows) — e.g. a graph generated on the card — without a host
    round trip.  Dtypes become int64/int32 on ``device``; ``edge_ids``
    (optional, one per CSR position) int32 on ``device``."""
    dev = resolve_device(device)
    g = cls(None, device=dev)
    g.indptr = indptr.to(dev, torch.int64).contiguous()
    g.indices = indices.to(dev, torch.int32).contiguous()
    if edge_ids is not None:
      g._edge_ids = _edge_id_tensor(edge_ids, g.indices.numel(), dev)
    return g

  @classmethod
  def from_view(cls, view) -> 'Graph':
    """A graph over a `streaming.GraphView`'s device twins (int64
    ``indptr``, power-of-two padded int32 ``indices``), shared with the
    view — the counterpart of the JAX package's
    `Graph.from_device_arrays`."""
    g = cls(None, device=view.indptr_dev.device)
    g.indptr = view.indptr_dev
    g.indices = view.indices_dev
    g._num_edges = view.num_edges
    return g

  @property
  def device(self) -> torch.device:
    return self.indptr.device

  @property
  def edge_ids(self) -> Optional[torch.Tensor]:
    """``[E]`` int32 edge ids on the graph's device: the host
    topology's, uploaded on first use, or those given to
    `from_tensors`; None when there are none (a sampler then emits CSR
    positions, as the JAX package does)."""
    if self._edge_ids is None and self.csr_topo is not None:
      self._edge_ids = _edge_id_tensor(self.csr_topo.edge_ids,
                                       self.csr_topo.num_edges, self.device)
    return self._edge_ids

  @property
  def num_nodes(self) -> int:
    return self.indptr.numel() - 1

  @property
  def num_edges(self) -> int:
    if self._num_edges is not None:
      return self._num_edges
    return self.indices.numel()

  @property
  def max_degree(self) -> int:
    """The largest row length: from the host topology when there is
    one, else one reduction and one scalar pull on the device, cached
    (never call it inside a CUDA graph capture)."""
    if self._max_degree is None:
      if self.csr_topo is not None:
        self._max_degree = int(self.csr_topo.degrees.max(initial=0))
      elif self.num_nodes == 0:
        self._max_degree = 0
      else:
        self._max_degree = int((self.indptr[1:] - self.indptr[:-1]).max())
    return self._max_degree

  def max_index(self) -> int:
    """The largest column id (-1 for no edge): from the host topology
    when there is one, else one reduction on the device."""
    if self.csr_topo is not None:
      return int(np.asarray(self.csr_topo.indices).max(initial=-1))
    if self.num_edges == 0:
      return -1
    return int(self.indices[:self.num_edges].max())

  def __repr__(self):
    return (f'Graph(num_nodes={self.num_nodes}, num_edges={self.num_edges}, '
            f'device={str(self.device)!r})')


def _edge_id_tensor(edge_ids, num_edges: int, device) -> torch.Tensor:
  """``[E]`` int32 ids on ``device``; ids past int32 raise (the
  sampled ids are int32, as in the JAX package)."""
  t = (edge_ids if isinstance(edge_ids, torch.Tensor)
       else torch.from_numpy(np.ascontiguousarray(edge_ids)))
  if t.shape != (num_edges,):
    raise ValueError(f'edge_ids must hold one id per edge ({num_edges}), '
                     f'got {tuple(t.shape)}')
  if t.dtype != torch.int32:
    if t.numel() and (int(t.max()) > torch.iinfo(torch.int32).max
                      or int(t.min()) < 0):
      raise ValueError('edge ids must lie in [0, 2**31)')
    t = t.to(torch.int32)
  return t.to(device).contiguous()
