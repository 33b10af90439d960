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


#: ``one_hop(hop, frontier [P, F] int32, k) -> (nbrs [P, F, k], mask [P,
#: F, k])``
OneHop = Callable[[int, torch.Tensor, int], Tuple[torch.Tensor, torch.Tensor]]


def _pad_table(state: InducerState, cap: int) -> InducerState:
  extra = torch.full((cap - state.nodes.shape[0],), INVALID_ID,
                     dtype=state.nodes.dtype, device=state.nodes.device)
  return InducerState(nodes=torch.cat([state.nodes, extra]),
                      count=state.count)


def _frontier(state: InducerState, start, f_cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Frontier slots ``[start, start + f_cap)`` of the node table: their
  global ids and local indices, -1 past the count."""
  cap = state.nodes.shape[0]
  slots = start + torch.arange(f_cap, dtype=torch.int32,
                               device=state.nodes.device)
  valid = slots < state.count
  ids = torch.where(valid, state.nodes[slots.clamp(0, cap - 1).long()],
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
  `induce_next` appends each partition's new neighbors to its table.

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
  init = [init_node(s, min(b, node_cap) if grow else node_cap)
          for s in seeds]
  states = [st for st, _ in init]
  f_cap = b
  fronts = [_frontier(st, 0, f_cap) for st in states]
  rows_acc, cols_acc = [], []
  counts = [torch.stack([st.count for st in states])]
  for hop, k in enumerate(fanouts):
    k = int(k)
    nbrs, mask = one_hop(hop, torch.stack([fr for fr, _ in fronts]), k)
    rows_h, cols_h, prev = [], [], []
    for p, st in enumerate(states):
      new_cap = min(st.nodes.shape[0] + f_cap * k, node_cap)
      if grow and new_cap > st.nodes.shape[0]:
        st = _pad_table(st, new_cap)
      states[p], rows, cols, prev_cnt = induce_next(st, fronts[p][1],
                                                    nbrs[p], mask[p])
      rows_h.append(rows)
      cols_h.append(cols)
      prev.append(prev_cnt)
    rows_acc.append(torch.stack(rows_h))
    cols_acc.append(torch.stack(cols_h))
    counts.append(torch.stack([st.count for st in states]))
    f_cap *= k
    fronts = [_frontier(st, c, f_cap) for st, c in zip(states, prev)]
  states = [_pad_table(st, node_cap) if st.nodes.shape[0] < node_cap
            else st for st in states]
  cum = torch.stack(counts, dim=1)
  nsn = torch.cat([cum[:, :1], cum[:, 1:] - cum[:, :-1]], dim=1).to(
      torch.int32)
  state = InducerState(nodes=torch.stack([st.nodes for st in states]),
                       count=torch.stack([st.count for st in states]))
  return (state, torch.stack([sl for _, sl in init]), rows_acc, cols_acc,
          nsn)
