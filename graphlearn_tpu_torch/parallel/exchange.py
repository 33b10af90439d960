"""The dense bucketed exchange of the mesh data plane: the JAX package's
`bucket_by_owner` (`parallel/dist_sampler.py:79-122`), dense
`capacity_spec` and `plan_exchange` (`parallel/exchange.py:200-285,
420-490`), for every partition of the mesh at once.

Each partition buckets its ids by owner into a ``[P, C]`` send buffer;
the stacked ``[P_src, P_dst, C]`` buffers cross the mesh in one
all-to-all (`parallel.dp.Mesh.all_to_all`), each owner answers its
receive buffer, and the replies cross back and are stitched into each
partition's request order.  ``C`` is the per-destination capacity: ids
past it are dropped (their ``slot_j`` is -1) and counted.  The compact,
hierarchical and ragged layouts are not ported.
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


def bucket_stacked(ids: torch.Tensor, owner: torch.Tensor, num_parts: int,
                   capacity: Optional[int] = None,
                   payload: Optional[torch.Tensor] = None):
  """`bucket_by_owner` for ``R`` id vectors at once: ``ids`` and
  ``owner`` are ``[R, F]``; returns ``send [R, P, C]``, ``slot_p [R,
  F]`` and ``slot_j [R, F]``, row ``r`` exactly what `bucket_by_owner`
  gives for ``ids[r]`` (one stable sort on ``(r, owner)`` keeps each
  row's arrival order within an owner).  With a ``[R, F]`` ``payload``
  a fourth ``[R, P, C]`` buffer carries ``payload[r, i]`` in the slot of
  ``ids[r, i]`` (-1 in empty slots), as JAX's `bucket_with_payload`."""
  r, f = ids.shape
  dev = ids.device
  cap = f if capacity is None else min(int(capacity), f)
  width = num_parts + 1            # owners, then the invalid ids' bucket
  owner = torch.where(ids >= 0, owner.to(torch.int64), num_parts)
  key = (owner + width * torch.arange(r, dtype=torch.int64,
                                      device=dev)[:, None]).reshape(-1)
  perm = torch.argsort(key, stable=True)
  key_s = key[perm]
  ids_s = ids.reshape(-1)[perm]
  # a scatter, not `bincount`, whose output size needs a device sync
  counts = torch.zeros(r * width, dtype=torch.int64, device=dev)
  counts.scatter_add_(0, key_s, torch.ones_like(key_s))
  offsets = torch.cumsum(counts, 0) - counts
  rank = torch.arange(r * f, dtype=torch.int64, device=dev) - offsets[key_s]
  row_s = key_s // width
  owner_s = key_s % width
  fits = (rank < cap) & (owner_s < num_parts)
  # non-fitting entries land in the extra column `num_parts`, cut below
  send = torch.full((r, width, max(cap, 1)), INVALID_ID, dtype=ids.dtype,
                    device=dev)
  col_s = torch.where(fits, owner_s, num_parts)
  rank_s = torch.where(fits, rank, 0)
  send[row_s, col_s, rank_s] = ids_s
  send = send[:, :num_parts, :cap]
  slot_p = torch.zeros(r * f, dtype=torch.int64, device=dev)
  slot_p[perm] = torch.where(owner_s < num_parts, owner_s, 0)
  slot_j = torch.full((r * f,), -1, dtype=torch.int64, device=dev)
  slot_j[perm] = torch.where(fits, rank, -1)
  out = (send, slot_p.reshape(r, f), slot_j.reshape(r, f))
  if payload is None:
    return out
  send_pl = torch.full((r, width, max(cap, 1)), INVALID_ID,
                       dtype=payload.dtype, device=dev)
  send_pl[row_s, col_s, rank_s] = payload.reshape(-1)[perm]
  return out + (send_pl[:, :num_parts, :cap],)


def bucket_by_owner(ids: torch.Tensor, owner: torch.Tensor, num_parts: int,
                    capacity: Optional[int] = None):
  """Pack ids into per-owner rows of a ``[P, C]`` send buffer.

  Returns ``(send, slot_p, slot_j)``: input position ``i`` landed at
  ``send[slot_p[i], slot_j[i]]``; ``slot_j`` is -1 for invalid ids and
  for ids past their owner's capacity (dropped).  Invalid ids sort
  after every owner, so they never take a slot.
  """
  send, slot_p, slot_j = bucket_stacked(ids[None], owner[None], num_parts,
                                        capacity)
  return send[0], slot_p[0], slot_j[0]


class DensePlan:
  """The ``[P, P, C]`` request exchange of every partition and its reply
  path.

  Attributes:
    recv: ``[P_owner, P_src * C]`` ids each owner must answer (-1
      padded), each owner's row in JAX's ``[P_src, C]`` order.
    kept / delivered: ``[P, F]`` which requests found a slot.
    slot_p / slot_j: ``[P, F]`` where each request sits in its
      partition's send buffer.
    requester_of_recv: ``[P_src * C]`` int32 source partition of each
      receive row (the per-requester GNS mask's row; the same for every
      owner).
    recv_payload: ``[P_owner, P_src * C]`` the payload beside each
      received id (with ``payload``; the ids and the payload cross in
      one all-to-all of ``[P, P, 2, C]``).
    stats: int64 ``[P, 3]`` (offered, dropped, slots) per partition.
  """

  def __init__(self, ids: torch.Tensor, owner_fn: Callable, num_parts: int,
               mesh, capacity: Optional[int] = None,
               payload: Optional[torch.Tensor] = None):
    if ids.ndim != 2 or ids.shape[0] != num_parts:
      raise ValueError(f'the plan takes [{num_parts}, F] ids, got '
                       f'{tuple(ids.shape)}')
    send, self.slot_p, self.slot_j, *send_pl = bucket_stacked(
        ids, owner_fn(ids), num_parts, capacity,
        payload=None if payload is None else payload.to(ids.dtype))
    self.mesh = mesh
    self.num_parts = num_parts
    self.cap = send.shape[2]
    self.recv_payload = None
    if payload is None:
      self.recv = mesh.all_to_all(send).reshape(num_parts, -1)
    else:
      both = mesh.all_to_all(torch.stack([send, send_pl[0]], dim=2))
      self.recv = both[:, :, 0].reshape(num_parts, -1)
      self.recv_payload = both[:, :, 1].reshape(num_parts, -1)
    self.kept = self.slot_j >= 0
    self.delivered = self.kept
    self.requester_of_recv = torch.arange(
        num_parts, dtype=torch.int32,
        device=ids.device).repeat_interleave(self.cap)
    valid = ids >= 0
    self.stats = torch.stack([
        valid.sum(1), (valid & ~self.kept).sum(1),
        torch.full((num_parts,), num_parts * self.cap, dtype=torch.int64,
                   device=ids.device)], dim=1)

  def stitch(self, back: torch.Tensor, fill=0) -> torch.Tensor:
    """Requester-side ``[P_req, P_owner, C, ...]`` replies -> ``[P, F,
    ...]`` in request order; requests that found no slot get ``fill``."""
    r = torch.arange(self.num_parts, device=back.device)[:, None]
    out = back[r, self.slot_p, torch.where(self.kept, self.slot_j, 0)]
    kept = self.kept.reshape(self.kept.shape + (1,) * (out.ndim - 2))
    return torch.where(kept, out, torch.full((), fill, dtype=out.dtype,
                                             device=out.device))

  def reply(self, values: torch.Tensor, fill=0) -> torch.Tensor:
    """Owner-side ``[P_owner, P_src * C, ...]`` values -> ``[P, F, ...]``
    in each partition's request order (the reply all-to-all, then the
    stitch)."""
    v = values.reshape((self.num_parts, self.num_parts, self.cap)
                       + tuple(values.shape[2:]))
    return self.stitch(self.mesh.all_to_all(v), fill)


def plan_exchange(ids: torch.Tensor, owner_fn: Callable, num_parts: int,
                  mesh, capacity: Optional[int] = None,
                  payload: Optional[torch.Tensor] = None) -> DensePlan:
  """The exchange plan for the ``[P, F]`` request vectors of every
  partition (-1 padded) at per-destination ``capacity`` (None =
  exact), with an optional ``[P, F]`` ``payload`` riding beside the
  ids."""
  return DensePlan(ids, owner_fn, num_parts, mesh, capacity, payload)
