"""Capacity-bounded, order-preserving unique and relabel (the inducer).

The JAX package's `ops/unique.py` in plain PyTorch, byte-equal to it:
static output capacities, ``INVALID_ID`` padding, the *first occurrence
order* of ids preserved (seeds keep local indices ``0..B-1``, new nodes
are appended in arrival order), and on overflow the latest-appearing
ids dropped.  Every sort is stable (`torch.argsort(..., stable=True)`,
as `jnp.argsort` is by default); an inverse permutation is a scatter
rather than a second argsort, which gives the same values.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.padding import INVALID_ID


class UniqueResult(NamedTuple):
  """``values [capacity]`` unique ids in first-occurrence order
  (``fill_value`` padded), ``inverse [n]`` int32 local index of each
  input (-1 for invalid inputs or overflow), ``count`` int32 scalar
  (clamped to capacity)."""
  values: torch.Tensor
  inverse: torch.Tensor
  count: torch.Tensor


class InducerState(NamedTuple):
  """The node table accumulated across hops: ``nodes [capacity]`` in
  insertion order (padded) and the int32 scalar ``count``."""
  nodes: torch.Tensor
  count: torch.Tensor


def _inverse_perm(p: torch.Tensor) -> torch.Tensor:
  out = torch.empty_like(p)
  out[p] = torch.arange(p.numel(), dtype=p.dtype, device=p.device)
  return out


def unique_stable(x: torch.Tensor, capacity: int,
                  fill_value: int = INVALID_ID,
                  valid: Optional[torch.Tensor] = None) -> UniqueResult:
  """Order-preserving unique with a static output capacity (see the
  JAX function for the algorithm: stable sort, segment heads ranked by
  first position, each element's rank through a running max)."""
  n = x.shape[0]
  dev = x.device
  if n == 0:
    return UniqueResult(
        values=torch.full((capacity,), fill_value, dtype=x.dtype,
                          device=dev),
        inverse=torch.zeros(0, dtype=torch.int32, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev))
  valid = (x != fill_value) if valid is None else valid & (x != fill_value)
  big = torch.iinfo(x.dtype).max
  xv = torch.where(valid, x, big)
  order = torch.argsort(xv, stable=True)
  xs = xv[order]
  real = xs != big
  head = torch.ones_like(real)
  head[1:] = xs[1:] != xs[:-1]
  head &= real
  count = torch.clamp(head.sum(), max=capacity).to(torch.int32)
  pos = torch.arange(n, dtype=torch.int64, device=dev)
  first_pos = torch.where(head, order, torch.iinfo(torch.int32).max)
  rank_to_sorted = torch.argsort(first_pos, stable=True)
  vals_by_rank = xs[rank_to_sorted]
  slot = torch.arange(capacity, dtype=torch.int64, device=dev)
  values = torch.where(slot < count, vals_by_rank[slot.clamp(max=n - 1)],
                       torch.full_like(slot, fill_value)).to(x.dtype)
  head_pos = torch.cummax(torch.where(head, pos, -1), dim=0).values
  sorted_to_rank = _inverse_perm(rank_to_sorted)
  inv_sorted = torch.where(real & (head_pos >= 0),
                           sorted_to_rank[head_pos.clamp(0, n - 1)], -1)
  inv_sorted = torch.where(inv_sorted < capacity, inv_sorted, -1)
  inverse = inv_sorted[_inverse_perm(order)].to(torch.int32)
  return UniqueResult(values=values, inverse=inverse, count=count)


def init_node(seeds: torch.Tensor, capacity: int
              ) -> Tuple[InducerState, torch.Tensor]:
  """Seed the node table (deduplicated, order kept); returns the state
  and the seeds' local indices."""
  res = unique_stable(seeds, capacity)
  return InducerState(nodes=res.values, count=res.count), res.inverse


def induce_next(state: InducerState, src_local: torch.Tensor,
                nbrs: torch.Tensor, nbr_mask: torch.Tensor):
  """Insert one hop's sampled neighbors into the node table.

  Args:
    src_local: ``[F]`` local index of each frontier row (-1 invalid).
    nbrs / nbr_mask: ``[F, k]`` sampled global ids and their validity.
  Returns ``(new_state, rows, cols, frontier_start)``: ``rows`` is the
  ``[F*k]`` neighbor local index and ``cols`` the source local index
  (the transposed emission for message passing), -1 where invalid;
  ``frontier_start`` is the previous count.
  """
  capacity = state.nodes.shape[0]
  f, k = nbrs.shape
  dev = nbrs.device
  flat_mask = nbr_mask.reshape(-1)
  combined = torch.cat([state.nodes, nbrs.reshape(-1).to(state.nodes.dtype)])
  valid = torch.cat([torch.arange(capacity, device=dev) < state.count,
                     flat_mask])
  res = unique_stable(combined, capacity, valid=valid)
  nbr_local = res.inverse[capacity:]
  src_flat = src_local.to(torch.int32)[:, None].expand(f, k).reshape(-1)
  edge_valid = flat_mask & (src_flat >= 0) & (nbr_local >= 0)
  rows = torch.where(edge_valid, nbr_local, -1)
  cols = torch.where(edge_valid, src_flat, -1)
  return (InducerState(nodes=res.values, count=res.count), rows, cols,
          state.count)
