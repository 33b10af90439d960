"""Device-resident graph handle: CSR ``indptr`` (int64) and ``indices``
(int32) as torch tensors on one device.

Unlike the JAX package, ``indptr`` stays int64 at every size (edge
positions never narrow); sampled ids are int32 either way.
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
    if csr_topo is not None:
      self.indptr = torch.from_numpy(
          np.asarray(csr_topo.indptr, np.int64)).to(dev)
      self.indices = torch.from_numpy(
          np.asarray(csr_topo.indices, np.int32)).to(dev)

  @classmethod
  def from_tensors(cls, indptr: torch.Tensor, indices: torch.Tensor,
                   device='cuda') -> 'Graph':
    """Wrap CSR tensors that are already canonical (columns sorted
    within rows) — e.g. a graph generated on the card — without a host
    round trip.  Dtypes become int64/int32 on ``device``."""
    dev = resolve_device(device)
    g = cls(None, device=dev)
    g.indptr = indptr.to(dev, torch.int64).contiguous()
    g.indices = indices.to(dev, torch.int32).contiguous()
    return g

  @property
  def device(self) -> torch.device:
    return self.indptr.device

  @property
  def num_nodes(self) -> int:
    return self.indptr.numel() - 1

  @property
  def num_edges(self) -> int:
    return self.indices.numel()

  def __repr__(self):
    return (f'Graph(num_nodes={self.num_nodes}, num_edges={self.num_edges}, '
            f'device={str(self.device)!r})')
