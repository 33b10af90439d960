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

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

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
  """The inverse of each permutation along the last dimension."""
  out = torch.empty_like(p)
  return out.scatter_(-1, p, torch.arange(p.shape[-1], dtype=p.dtype,
                                          device=p.device).expand_as(p))


def unique_stable(x: torch.Tensor, capacity: int,
                  fill_value: int = INVALID_ID,
                  valid: Optional[torch.Tensor] = None) -> UniqueResult:
  """Order-preserving unique with a static output capacity (see the
  JAX function for the algorithm: stable sort, segment heads ranked by
  first position, each element's rank through a running max).  ``x``
  is ``[n]``, or ``[R, n]`` for ``R`` independent rows at once (each row
  gives exactly what it gives alone; ``count`` is then ``[R]``)."""
  n = x.shape[-1]
  lead = tuple(x.shape[:-1])
  dev = x.device
  if n == 0:
    return UniqueResult(
        values=torch.full(lead + (capacity,), fill_value, dtype=x.dtype,
                          device=dev),
        inverse=torch.zeros(lead + (0,), dtype=torch.int32, device=dev),
        count=torch.zeros(lead, dtype=torch.int32, device=dev))
  valid = (x != fill_value) if valid is None else valid & (x != fill_value)
  big = torch.iinfo(x.dtype).max
  xv = torch.where(valid, x, big)
  order = torch.argsort(xv, dim=-1, stable=True)
  xs = torch.gather(xv, -1, order)
  real = xs != big
  head = torch.ones_like(real)
  head[..., 1:] = xs[..., 1:] != xs[..., :-1]
  head &= real
  count = torch.clamp(head.sum(-1), max=capacity).to(torch.int32)
  pos = torch.arange(n, dtype=torch.int64, device=dev)
  first_pos = torch.where(head, order, torch.iinfo(torch.int32).max)
  rank_to_sorted = torch.argsort(first_pos, dim=-1, stable=True)
  vals_by_rank = torch.gather(xs, -1, rank_to_sorted)
  slot = torch.arange(capacity, dtype=torch.int64, device=dev)
  picked = torch.gather(vals_by_rank, -1,
                        slot.clamp(max=n - 1).expand(lead + (capacity,)))
  values = torch.where(slot < count[..., None], picked,
                       torch.full_like(slot, fill_value)).to(x.dtype)
  head_pos = torch.cummax(torch.where(head, pos, -1), dim=-1).values
  sorted_to_rank = _inverse_perm(rank_to_sorted)
  inv_sorted = torch.where(
      real & (head_pos >= 0),
      torch.gather(sorted_to_rank, -1, head_pos.clamp(0, n - 1)), -1)
  inv_sorted = torch.where(inv_sorted < capacity, inv_sorted, -1)
  inverse = torch.gather(inv_sorted, -1, _inverse_perm(order)).to(
      torch.int32)
  return UniqueResult(values=values, inverse=inverse, count=count)


def init_node(seeds: torch.Tensor, capacity: int
              ) -> Tuple[InducerState, torch.Tensor]:
  """Seed the node table (deduplicated, order kept); returns the state
  and the seeds' local indices.  ``[R, B]`` seeds seed ``R`` tables."""
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
  ``frontier_start`` is the previous count.  Every argument may carry a
  leading ``[R]`` axis (``R`` tables, ``[R, cap]`` nodes and ``[R]``
  counts), each row inserted as it is alone.
  """
  capacity = state.nodes.shape[-1]
  f, k = nbrs.shape[-2:]
  lead = tuple(nbrs.shape[:-2])
  dev = nbrs.device
  flat_mask = nbr_mask.reshape(lead + (f * k,))
  combined = torch.cat([state.nodes,
                        nbrs.reshape(lead + (f * k,)).to(state.nodes.dtype)],
                       dim=-1)
  valid = torch.cat([torch.arange(capacity, device=dev)
                     < state.count[..., None], flat_mask], dim=-1)
  res = unique_stable(combined, capacity, valid=valid)
  nbr_local = res.inverse[..., capacity:]
  src_flat = src_local.to(torch.int32)[..., None].expand(
      lead + (f, k)).reshape(lead + (f * k,))
  edge_valid = flat_mask & (src_flat >= 0) & (nbr_local >= 0)
  rows = torch.where(edge_valid, nbr_local, -1)
  cols = torch.where(edge_valid, src_flat, -1)
  return (InducerState(nodes=res.values, count=res.count), rows, cols,
          state.count)


#: ``one_hop(hop, frontier [P, F] int32, k) -> (nbrs [P, F, k], mask [P,
#: F, k])``
OneHop = Callable[[int, torch.Tensor, int], Tuple[torch.Tensor, torch.Tensor]]


def _pad_table(state: InducerState, cap: int) -> InducerState:
  nodes = state.nodes
  extra = torch.full(tuple(nodes.shape[:-1]) + (cap - nodes.shape[-1],),
                     INVALID_ID, dtype=nodes.dtype, device=nodes.device)
  return InducerState(nodes=torch.cat([nodes, extra], dim=-1),
                      count=state.count)


def _frontier(state: InducerState, start, f_cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Frontier slots ``[start, start + f_cap)`` of the node table: their
  global ids and local indices, -1 past the count.  Stacked tables
  (``[R, cap]`` nodes) take a ``[R]`` tensor ``start`` (or an int) and
  give ``[R, f_cap]``."""
  cap = state.nodes.shape[-1]
  ar = torch.arange(f_cap, dtype=torch.int32, device=state.nodes.device)
  slots = start[..., None] + ar if isinstance(start, torch.Tensor) else (
      start + ar)
  if state.nodes.ndim > 1:
    slots = slots.expand(tuple(state.nodes.shape[:-1]) + (f_cap,))
  valid = slots < state.count[..., None]
  ids = torch.where(valid, torch.gather(state.nodes, -1,
                                        slots.clamp(0, cap - 1).long()),
                    INVALID_ID)
  return ids, torch.where(valid, slots, -1)


def expand_hops(seeds: torch.Tensor, fanouts: Sequence[int], node_cap: int,
                one_hop: OneHop, grow: bool = False
                ) -> Tuple[InducerState, torch.Tensor, List[torch.Tensor],
                           List[torch.Tensor], torch.Tensor]:
  """The multi-hop node-table advance shared by the single-card and the
  mesh samplers, for ``P`` seed vectors in lockstep (``seeds`` is ``[P,
  B]``; the single-card sampler passes ``P = 1``): per hop, ``one_hop``
  samples the stacked ``[P, F]`` frontiers of the nodes the previous
  hop appended (the seeds at hop 0) — every partition's frontier is
  known before any of them is sampled, as a mesh exchange needs — and
  `induce_next` appends every partition's new neighbors to its table
  (all ``P`` tables in one call, each as it would be alone).

  With ``grow`` the table starts at ``min(B, node_cap)`` slots and grows
  by the hop's ``F * k`` per hop (the JAX single-card sampler, whose
  insertions sort only the current capacity); without, it holds
  ``node_cap`` from the start (the JAX mesh sampler).  Either way it
  ends at ``node_cap``.

  Returns ``(state, seed_local, rows per hop, cols per hop,
  num_sampled_nodes)``, stacked: ``state.nodes [P, node_cap]``,
  ``state.count [P]``, ``seed_local [P, B]``, ``rows``/``cols`` ``[P,
  F * k]`` per hop, ``num_sampled_nodes [P, hops + 1]`` int32.
  """
  b = seeds.shape[1]
  state, seed_local = init_node(seeds, min(b, node_cap) if grow
                                else node_cap)
  f_cap = b
  front_ids, front_local = _frontier(state, 0, f_cap)
  rows_acc, cols_acc = [], []
  counts = [state.count]
  for hop, k in enumerate(fanouts):
    k = int(k)
    nbrs, mask = one_hop(hop, front_ids, k)
    new_cap = min(state.nodes.shape[-1] + f_cap * k, node_cap)
    if grow and new_cap > state.nodes.shape[-1]:
      state = _pad_table(state, new_cap)
    state, rows, cols, prev = induce_next(state, front_local, nbrs, mask)
    rows_acc.append(rows)
    cols_acc.append(cols)
    counts.append(state.count)
    f_cap *= k
    front_ids, front_local = _frontier(state, prev, f_cap)
  if state.nodes.shape[-1] < node_cap:
    state = _pad_table(state, node_cap)
  cum = torch.stack(counts, dim=1)
  nsn = torch.cat([cum[:, :1], cum[:, 1:] - cum[:, :-1]], dim=1).to(
      torch.int32)
  return state, seed_local, rows_acc, cols_acc, nsn
