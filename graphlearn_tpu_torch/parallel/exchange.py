"""The dense bucketed exchange of the mesh data plane: the JAX package's
`bucket_by_owner` (`parallel/dist_sampler.py:79-122`), dense
`capacity_spec` and `plan_exchange` (`parallel/exchange.py`).

Ids are bucketed by owner into a ``[P, C]`` send buffer, shipped to
their owners with the mesh's all-to-all, answered there, and the
replies stitched back into request order.  ``C`` is the per-destination
capacity: ids past it are dropped (their ``slot_j`` is -1) and counted.
The collective is a method of the mesh (`parallel.dp.Mesh`); on one
card it is the identity.  The compact, hierarchical and ragged layouts
are not ported.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..utils.padding import INVALID_ID, round_up

#: per-destination capacity floor of the dense layout
MIN_EXCHANGE_CAP = 64


def capacity_spec(n: int, num_parts: int, slack: Optional[float],
                  floor: int = MIN_EXCHANGE_CAP) -> Optional[int]:
  """The dense per-destination capacity of one ``n``-id exchange:
  ``round_up(min(n, max(ceil(n / P * slack), floor)), 8)``; None
  (exact: width ``n``) when ``slack`` is None."""
  if slack is None:
    return None
  lam = int(n) / int(num_parts) * float(slack)
  return int(round_up(min(int(n), max(int(math.ceil(lam)), int(floor))), 8))


def bucket_by_owner(ids: torch.Tensor, owner: torch.Tensor, num_parts: int,
                    capacity: Optional[int] = None):
  """Pack ids into per-owner rows of a ``[P, C]`` send buffer.

  Returns ``(send, slot_p, slot_j)``: input position ``i`` landed at
  ``send[slot_p[i], slot_j[i]]``; ``slot_j`` is -1 for invalid ids and
  for ids past their owner's capacity (dropped).  Invalid ids sort
  after every owner, so they never take a slot.
  """
  f = ids.shape[0]
  dev = ids.device
  cap = f if capacity is None else min(int(capacity), f)
  valid = ids >= 0
  owner = torch.where(valid, owner.to(torch.int64), num_parts)
  perm = torch.argsort(owner, stable=True)
  owner_s = owner[perm]
  ids_s = ids[perm]
  counts = torch.bincount(owner_s, minlength=num_parts + 1)
  offsets = torch.cumsum(counts, 0) - counts
  rank = torch.arange(f, dtype=torch.int64, device=dev) - offsets[owner_s]
  fits = (rank < cap) & (owner_s < num_parts)
  # non-fitting entries land in the extra row `num_parts`, cut below
  send = torch.full((num_parts + 1, max(cap, 1)), INVALID_ID,
                    dtype=ids.dtype, device=dev)
  send[torch.where(fits, owner_s, num_parts),
       torch.where(fits, rank, 0)] = ids_s
  send = send[:num_parts, :cap]
  slot_p = torch.zeros(f, dtype=torch.int64, device=dev)
  slot_p[perm] = torch.where(owner_s < num_parts, owner_s, 0)
  slot_j = torch.full((f,), -1, dtype=torch.int64, device=dev)
  slot_j[perm] = torch.where(fits, rank, -1)
  return send, slot_p, slot_j


class DensePlan:
  """One ``[P, C]`` request exchange and its reply path.

  Attributes:
    recv: ``[P_src * C]`` ids this card must answer (-1 padded).
    kept / delivered: ``[F]`` which requests found a slot.
    requester_of_recv: ``[P_src * C]`` int32 source card of each recv
      row (the per-requester GNS mask's row).
    stats: int64 ``[3]`` (offered, dropped, slots) on the device.
  """

  def __init__(self, ids: torch.Tensor, owner_fn: Callable, num_parts: int,
               mesh, capacity: Optional[int] = None):
    send, self.slot_p, self.slot_j = bucket_by_owner(
        ids, owner_fn(ids), num_parts, capacity)
    self.mesh = mesh
    self.num_parts = num_parts
    self.cap = send.shape[1]
    self.recv = mesh.all_to_all(send).reshape(-1)
    self.kept = self.slot_j >= 0
    self.delivered = self.kept
    self.requester_of_recv = torch.arange(
        num_parts, dtype=torch.int32,
        device=ids.device).repeat_interleave(self.cap)
    valid = ids >= 0
    self.stats = torch.stack([
        valid.sum(), (valid & ~self.kept).sum(),
        torch.tensor(num_parts * self.cap, device=ids.device)])

  def reply(self, values: torch.Tensor, fill=0) -> torch.Tensor:
    """``[P_src * C, ...]`` owner-side values -> ``[F, ...]`` in request
    order; requests that found no slot get ``fill``."""
    v = values.reshape((self.num_parts, self.cap) + tuple(values.shape[1:]))
    back = self.mesh.all_to_all(v)
    out = back[self.slot_p, torch.where(self.kept, self.slot_j, 0)]
    kept = self.kept.reshape(self.kept.shape + (1,) * (out.ndim - 1))
    return torch.where(kept, out, torch.full((), fill, dtype=out.dtype,
                                             device=out.device))


def plan_exchange(ids: torch.Tensor, owner_fn: Callable, num_parts: int,
                  mesh, capacity: Optional[int] = None) -> DensePlan:
  """The exchange plan for one ``[F]`` request vector (-1 padded) at
  per-destination ``capacity`` (None = exact)."""
  return DensePlan(ids, owner_fn, num_parts, mesh, capacity)
