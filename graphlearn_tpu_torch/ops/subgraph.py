"""Induced subgraphs on the device (the JAX package's `ops/subgraph.py`):
every edge among a node set, relabelled to the set's local ids.  Each
node contributes a static window of ``max_degree`` neighbor slots
(longer rows truncated, the rest masked); membership in the set is a
stable sort of the set and a left binary search of every window entry,
mapped back to local ids through the sort's permutation.  The
``[M, max_degree]`` window is the op's one intermediate.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.padding import INVALID_ID

_INT32_MAX = torch.iinfo(torch.int32).max


class SubGraphResult(NamedTuple):
  """An induced subgraph, static shapes.

  Attributes:
    nodes: ``[M]`` global node ids as given (-1 padded).
    rows / cols: ``[M * max_degree]`` int32 local COO, -1 where masked.
    eids: ``[M * max_degree]`` edge ids (CSR positions, or
      ``edge_ids`` at them) or None.
    edge_mask: ``[M * max_degree]`` validity.
  """
  nodes: torch.Tensor
  rows: torch.Tensor
  cols: torch.Tensor
  eids: Optional[torch.Tensor]
  edge_mask: torch.Tensor


def induced_subgraph(indptr: torch.Tensor, indices: torch.Tensor,
                     nodes: torch.Tensor, *, max_degree: int,
                     edge_ids: Optional[torch.Tensor] = None,
                     with_edge_ids: bool = False) -> SubGraphResult:
  """Every edge among ``nodes`` (``[M]`` unique int32 ids, -1 padded;
  ``nodes[i]`` has local id ``i``).  Rows with more than ``max_degree``
  neighbors are truncated: pass at least the graph's maximum degree
  (`data.Graph.max_degree`) for an exact result.  With
  ``with_edge_ids`` each edge also carries its CSR position, or
  ``edge_ids`` at that position."""
  num_edges = indices.shape[0]
  m, d = nodes.shape[0], int(max_degree)
  dev = nodes.device
  valid_node = nodes >= 0
  n = torch.where(valid_node, nodes, 0).long()
  start = indptr[n]
  deg = torch.where(valid_node, (indptr[n + 1] - start).to(torch.int32), 0)

  wslot = torch.arange(d, dtype=torch.int32, device=dev)
  in_deg = wslot[None, :] < deg[:, None]                   # [M, D]
  pos = (start[:, None] + wslot[None, :]).clamp(0, max(num_edges - 1, 0))
  nbr = (indices[pos] if num_edges
         else torch.full(pos.shape, INVALID_ID, dtype=torch.int32,
                         device=dev))
  win = torch.where(in_deg, nbr.to(torch.int32), INVALID_ID).reshape(-1)

  keyed = torch.where(valid_node, nodes.to(torch.int32), _INT32_MAX)
  order = torch.argsort(keyed, stable=True)
  sorted_nodes = keyed[order]
  loc = torch.searchsorted(sorted_nodes, win).clamp(0, m - 1)
  hit = (sorted_nodes[loc] == win) & (win >= 0)
  col_local = torch.where(hit, order[loc].to(torch.int32), INVALID_ID)

  row_local = torch.arange(m, dtype=torch.int32, device=dev)[:, None] \
      .expand(m, d).reshape(-1)
  edge_mask = hit & in_deg.reshape(-1)
  rows = torch.where(edge_mask, row_local, INVALID_ID)
  cols = torch.where(edge_mask, col_local, INVALID_ID)
  eids = None
  if with_edge_ids:
    flat = pos.reshape(-1)
    if edge_ids is None:
      ids = flat.to(torch.int32 if num_edges < _INT32_MAX else torch.int64)
    else:
      ids = edge_ids[flat]
    eids = torch.where(edge_mask, ids, INVALID_ID)
  return SubGraphResult(nodes=nodes, rows=rows, cols=cols, eids=eids,
                        edge_mask=edge_mask)
