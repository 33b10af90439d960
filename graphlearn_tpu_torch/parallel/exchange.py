"""The bucketed exchange of the mesh data plane and its layouts: the JAX
package's `bucket_by_owner` (`parallel/dist_sampler.py:79-122`) and
`parallel/exchange.py` (`resolve_layout`, `mesh_factors`,
`ExchangeSpec`, `capacity_spec`, `dest_histogram`, `EwmaCapacityModel`,
the dense, compact and hierarchical plans and `plan_exchange`), for
every partition of the mesh at once.

Each partition buckets its ids by owner; the stacked buffers cross the
mesh (`parallel.dp.Mesh.all_to_all`, a transpose on one card), each
owner answers its receive buffer, and the replies cross back and are
stitched into each partition's request order.  The layouts:

``dense``
    A ``[P, C]`` send buffer per partition, ``C = max(ceil(n / P *
    slack), MIN_EXCHANGE_CAP)``: the floor is paid P times.
``compact``
    A tight per-destination base (``ceil(n / P * slack)``, no floor)
    plus one shared overflow pool of ``V`` slots a partition: the ids
    past their owner's base ride the pool, which every owner reads
    whole (the all-gather is a ``[P, V]`` stack) and answers for the
    ids it owns.  An owner's receive buffer is ``[P * C + P * V]``: the
    base, then every partition's pool, ids it does not own included
    (the samplers mask them out; their answers are never read).  A share
    below `POOL_ONLY_MAX_SHARE` drops the base: the whole request rides
    the pool.
``hier``
    Two stages over a ``[rows, cols]`` factoring of the mesh: stage 1
    routes each id to its owner's column within its mesh row, stage 2
    to its owner's row within that column; each stage is an all-to-all
    within its groups.  Stage-2 drops come back as a delivered bit.

``'ragged'`` needs `jax.lax.ragged_all_to_all` in the JAX package; the
port has no such collective, so it resolves to ``'compact'`` as JAX's
does without it.  ``None``/``'auto'`` reads ``GLT_EXCHANGE_LAYOUT``,
then picks dense below `AUTO_COMPACT_MIN_PARTS` partitions and compact
at or above.  Every plan carries the telemetry triple per partition
(offered, dropped, slots); hier counts an id once per stage it enters.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..utils.padding import INVALID_ID, round_up

#: per-destination capacity floor of the dense layout
MIN_EXCHANGE_CAP = 64

#: hierarchical per-stage bucket floor
MIN_STAGE_CAP = 16

#: smallest compact overflow pool
MIN_POOL = 32

#: the compact pool as a fraction of the request width
#: (``GLT_EXCHANGE_POOL_FRAC`` overrides, read per call)
POOL_FRAC = 0.25

#: below this per-destination share the compact base is dropped
POOL_ONLY_MAX_SHARE = 2.0

#: ``'auto'`` switches dense -> compact at this mesh size
AUTO_COMPACT_MIN_PARTS = 16

#: hier needs a non-trivial factoring
HIER_MIN_PARTS = 4

LAYOUTS = ('dense', 'compact', 'hier', 'ragged')

#: the port has no ragged all-to-all: 'ragged' resolves to 'compact'
HAVE_RAGGED = False

_ENV_LAYOUT = 'GLT_EXCHANGE_LAYOUT'
_ENV_EWMA = 'GLT_EXCHANGE_EWMA'


def _env_float(name: str, default: float) -> float:
  try:
    return float(os.environ.get(name, default))
  except ValueError:
    return default


def _pool_frac() -> float:
  return _env_float('GLT_EXCHANGE_POOL_FRAC', POOL_FRAC)


def resolve_layout(layout: Optional[str], num_parts: int) -> str:
  """The layout that runs for a requested one: ``None``/``'auto'``
  consults ``GLT_EXCHANGE_LAYOUT``, then dense below
  `AUTO_COMPACT_MIN_PARTS` partitions and compact at or above;
  ``'ragged'`` runs compact; ``'hier'`` runs dense below
  `HIER_MIN_PARTS` and compact at a prime ``P``."""
  name = layout or 'auto'
  if name == 'auto':
    name = os.environ.get(_ENV_LAYOUT, '') or 'auto'
  if name == 'auto':
    name = 'compact' if num_parts >= AUTO_COMPACT_MIN_PARTS else 'dense'
  if name not in LAYOUTS:
    raise ValueError(f'unknown exchange layout {name!r}; expected one of '
                     f"{LAYOUTS + ('auto',)}")
  if name == 'ragged' and not HAVE_RAGGED:
    name = 'compact'
  if name == 'hier':
    if num_parts < HIER_MIN_PARTS:
      name = 'dense'
    elif mesh_factors(num_parts)[1] < 2:
      name = 'compact'
  return name


def mesh_factors(num_parts: int) -> Tuple[int, int]:
  """``(rows, cols)``, ``rows * cols == P``, both as close to sqrt(P) as
  the factorization allows (rows >= cols)."""
  c = max(int(math.isqrt(num_parts)), 1)
  while num_parts % c:
    c -= 1
  return num_parts // c, c


@dataclasses.dataclass(frozen=True)
class ExchangeSpec:
  """The capacities of one bucketed exchange."""
  layout: str
  num_parts: int
  #: per-destination width: the dense cap, or the compact base (0 =
  #: pool only)
  capacity: int = 0
  #: the compact overflow pool's width
  pool: int = 0
  #: hier's mesh factoring and per-stage bucket widths
  rows: int = 0
  cols: int = 0
  stage_caps: Tuple[int, int] = (0, 0)

  @property
  def slots(self) -> int:
    """The send-buffer footprint of one partition (the ``slots``
    counter)."""
    if self.layout == 'hier':
      return self.cols * self.stage_caps[0] + self.rows * self.stage_caps[1]
    if self.layout == 'compact':
      return self.num_parts * self.capacity + self.pool
    return self.num_parts * self.capacity


def capacity_spec(n: int, num_parts: int, slack: Optional[float],
                  layout: Optional[str] = None,
                  floor: int = MIN_EXCHANGE_CAP,
                  dest_cap: Optional[int] = None,
                  traffic_cap: Optional[int] = None
                  ) -> Optional[ExchangeSpec]:
  """The capacities of one ``n``-id exchange under ``layout``
  (`resolve_layout`); None (exact: the dense width ``n``) when
  ``slack`` is None.  ``dest_cap`` / ``traffic_cap`` are the
  `EwmaCapacityModel`'s measured busiest-destination and per-partition
  wire counts: the first replaces the balanced share ``n / P`` (not
  under hier), the second sizes the compact pool."""
  if slack is None:
    return None
  n, num_parts = int(n), int(num_parts)
  name = resolve_layout(layout, num_parts)
  lam = n / num_parts * float(slack)
  if dest_cap is not None and name != 'hier':
    lam = min(n, int(dest_cap)) * float(slack)
  if name == 'hier':
    rows, cols = mesh_factors(num_parts)
    lam1, lam2 = n / cols, n / rows
    c1 = int(math.ceil(lam1 * float(slack))) + max(
        MIN_STAGE_CAP, int(math.ceil(lam1 / 4)))
    c2 = int(math.ceil(lam2 * float(slack) * 1.5)) + max(
        MIN_STAGE_CAP, int(math.ceil(lam2 / 4)))
    return ExchangeSpec('hier', num_parts, rows=rows, cols=cols,
                        stage_caps=(int(round_up(min(c1, n), 4)),
                                    int(round_up(min(c2, n), 4))))
  dense = ExchangeSpec('dense', num_parts, capacity=int(round_up(
      min(n, max(int(math.ceil(lam)), int(floor))), 8)))
  if name == 'dense':
    return dense
  if lam < POOL_ONLY_MAX_SHARE:
    return ExchangeSpec('compact', num_parts, capacity=0,
                        pool=int(round_up(max(n, 1), 8)))
  wire = n if traffic_cap is None else min(n, int(traffic_cap))
  pool = int(round_up(min(n, max(MIN_POOL, int(math.ceil(
      wire * _pool_frac())))), 8))
  compact = ExchangeSpec('compact', num_parts,
                         capacity=min(int(math.ceil(lam)), n), pool=pool)
  # the pool only pays where the dense floor binds
  return compact if compact.slots < dense.slots else dense


def dest_histogram(ids: torch.Tensor, owner_fn: Callable, num_parts: int,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
  """``[P_src, P]`` int64: each partition's count of valid ids (``[P_src,
  F]``) by destination ``owner_fn`` (the RANGE owner, so a column keeps
  meaning "range r" under a moved book): its row of the src -> dst
  attribution matrix."""
  if valid is None:
    valid = ids >= 0
  r = ids.shape[0]
  owner = torch.where(valid, owner_fn(torch.where(valid, ids, 0)).long(),
                      num_parts).clamp(0, num_parts)
  out = torch.zeros((r, num_parts + 1), dtype=torch.int64, device=ids.device)
  out.scatter_add_(1, owner, torch.ones_like(owner))
  return out[:, :num_parts]


def ewma_enabled(flag=None) -> bool:
  """``GLT_EXCHANGE_EWMA=1`` turns on measured capacity sizing."""
  if flag is not None:
    return bool(flag)
  return os.environ.get(_ENV_EWMA, '').lower() in ('1', 'true', 'on')


def _quantize_pow2(x: float) -> int:
  """The next power of two at or above ``x`` (at least 1)."""
  v = max(int(math.ceil(x)), 1)
  return int(1 << (v - 1).bit_length())


class EwmaCapacityModel:
  """An EWMA of measured exchange demand -> power-of-two capacity caps.

  Fed each channel's (``'frontier'`` / ``'feature'``) ``[P, P]``
  attribution delta at an epoch end: the busiest (src, dst) cell per
  step is the per-destination demand, the busiest src row per step the
  wire traffic.  Both are averaged (``GLT_EXCHANGE_EWMA_ALPHA``), padded
  by ``GLT_EXCHANGE_EWMA_HEADROOM`` and rounded up to a power of two.
  """

  CHANNELS = ('frontier', 'feature')

  def __init__(self, num_parts: int, alpha: Optional[float] = None,
               headroom: Optional[float] = None):
    self.num_parts = int(num_parts)
    self.alpha = (_env_float('GLT_EXCHANGE_EWMA_ALPHA', 0.5)
                  if alpha is None else float(alpha))
    self.headroom = (_env_float('GLT_EXCHANGE_EWMA_HEADROOM', 1.3)
                     if headroom is None else float(headroom))
    self._dest: dict = {}
    self._traffic: dict = {}
    self._caps: dict = {}

  def _quantized(self, c: str) -> Tuple[int, int]:
    return (_quantize_pow2(self._dest[c] * self.headroom),
            _quantize_pow2(self._traffic[c] * self.headroom))

  def observe(self, channel: str, matrix_delta, steps: int) -> bool:
    """Fold one epoch's ``[P, P]`` delta (``steps`` dispatches); True
    when the quantized caps moved."""
    if steps <= 0:
      return False
    m = np.asarray(matrix_delta, np.float64)
    if m.size == 0 or m.sum() <= 0:
      return False
    dest = float(m.max()) / steps
    traffic = float(m.sum(axis=1).max()) / steps
    a = self.alpha
    self._dest[channel] = (a * dest + (1 - a) * self._dest[channel]
                           if channel in self._dest else dest)
    self._traffic[channel] = (a * traffic + (1 - a) * self._traffic[channel]
                              if channel in self._traffic else traffic)
    caps = self._quantized(channel)
    changed = self._caps.get(channel) != caps
    self._caps[channel] = caps
    return changed

  def caps(self, channel: str):
    """``(dest_cap, traffic_cap)``, ``(None, None)`` before the first
    observation."""
    return self._caps.get(channel, (None, None))

  def state_dict(self) -> dict:
    return {f'{c}_{k}': float(d[c])
            for k, d in (('dest', self._dest), ('traffic', self._traffic))
            for c in d}

  def load_state_dict(self, state: dict) -> None:
    for key, val in state.items():
      c, k = key.rsplit('_', 1)
      (self._dest if k == 'dest' else self._traffic)[c] = float(
          np.asarray(val))
    for c in set(self._dest) & set(self._traffic):
      self._caps[c] = self._quantized(c)


def bucket_stacked(ids: torch.Tensor, owner: torch.Tensor, num_parts: int,
                   capacity: Optional[int] = None,
                   payload: Optional[torch.Tensor] = None,
                   with_rank: bool = False):
  """`bucket_by_owner` for ``R`` id vectors at once: ``ids`` and
  ``owner`` are ``[R, F]``; returns ``send [R, P, C]``, ``slot_p [R,
  F]`` and ``slot_j [R, F]``, row ``r`` exactly what `bucket_by_owner`
  gives for ``ids[r]`` (one stable sort on ``(r, owner)`` keeps each
  row's arrival order within an owner).  With a ``[R, F]`` ``payload``
  a fourth ``[R, P, C]`` buffer carries ``payload[r, i]`` in the slot of
  ``ids[r, i]`` (-1 in empty slots), as JAX's `bucket_with_payload`.
  ``with_rank`` appends the sort itself, ``(perm, owner_s, rank)``, each
  ``[R * F]`` in sorted order (the compact pool's input)."""
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
  if payload is not None:
    send_pl = torch.full((r, width, max(cap, 1)), INVALID_ID,
                         dtype=payload.dtype, device=dev)
    send_pl[row_s, col_s, rank_s] = payload.reshape(-1)[perm]
    out = out + (send_pl[:, :num_parts, :cap],)
  if with_rank:
    out = out + ((perm, owner_s, rank),)
  return out


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


def _bcast(mask: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
  """A ``[P, F]`` mask over the trailing dims of ``[P, F, ...]``."""
  return mask.reshape(mask.shape + (1,) * (values.ndim - mask.ndim))


def _fill_like(out: torch.Tensor, fill) -> torch.Tensor:
  return torch.full((), fill, dtype=out.dtype, device=out.device)


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

  layout = 'dense'

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
    return torch.where(_bcast(self.kept, out), out, _fill_like(out, fill))

  def reply(self, values: torch.Tensor, fill=0) -> torch.Tensor:
    """Owner-side ``[P_owner, P_src * C, ...]`` values -> ``[P, F, ...]``
    in each partition's request order (the reply all-to-all, then the
    stitch)."""
    v = values.reshape((self.num_parts, self.num_parts, self.cap)
                       + tuple(values.shape[2:]))
    return self.stitch(self.mesh.all_to_all(v), fill)


class CompactPlan:
  """The compact layout (the JAX package's `_CompactPlan`): a ``[P, C]``
  base (``C`` may be 0) plus a ``[V]`` overflow pool per partition.

  The ids of each partition sort stably by owner; an id whose rank
  within its owner is below ``C`` takes a base slot, the rest take pool
  slots in that sorted order while the pool lasts.  Every owner's
  receive buffer is its ``[P_src * C]`` base rows, then the whole ``[P,
  V]`` pool stack (the all-gather); the reply selects each pool id's
  answer from its owner.  Attributes as `DensePlan`'s (no ``slot_p`` /
  ``slot_j``)."""

  layout = 'compact'

  def __init__(self, ids: torch.Tensor, owner_fn: Callable, num_parts: int,
               mesh, spec: ExchangeSpec,
               payload: Optional[torch.Tensor] = None):
    p, (r, f) = num_parts, ids.shape
    if r != p:
      raise ValueError(f'the plan takes [{p}, F] ids, got {tuple(ids.shape)}')
    cap, v = int(spec.capacity), int(spec.pool)
    dev = ids.device
    self.mesh, self.num_parts, self.cap, self.pool = mesh, p, cap, v
    pl = None if payload is None else payload.to(ids.dtype)
    owner = owner_fn(ids)
    send, _, slot_j, *rest = bucket_stacked(ids, owner, p, cap, payload=pl,
                                            with_rank=True)
    perm, owner_s, rank = rest[-1]
    real = owner_s < p
    want_pool = (real & (rank >= cap)).reshape(p, f)
    pool_rank = torch.cumsum(want_pool.to(torch.int64), 1) - 1
    in_pool = want_pool & (pool_rank < v)
    row = torch.arange(p, device=dev)[:, None].expand(p, f)

    def scatter_pool(vals):
      buf = torch.full((p, v + 1), INVALID_ID, dtype=vals.dtype, device=dev)
      buf[row, torch.where(in_pool, pool_rank, v)] = vals.reshape(
          -1)[perm].reshape(p, f)
      return buf[:, :v]
    pool_all = scatter_pool(ids)               # [P_src, V], every owner's
    base = [send] + ([rest[0]] if pl is not None else [])
    if cap > 0:
      base_recv = [mesh.all_to_all(b).reshape(p, -1) for b in base]
    else:
      base_recv = [ids.new_empty((p, 0)) for _ in base]
    self.recv = torch.cat([base_recv[0],
                           pool_all.reshape(1, -1).expand(p, -1)], 1)
    self.recv_payload = None
    if pl is not None:
      self.recv_payload = torch.cat(
          [base_recv[1], scatter_pool(pl).reshape(1, -1).expand(p, -1)], 1)
    src = torch.arange(p, dtype=torch.int32, device=dev)
    self.requester_of_recv = torch.cat([src.repeat_interleave(cap),
                                        src.repeat_interleave(v)])
    # back to request order
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=dev)
    inv = inv.reshape(p, f) - torch.arange(p, device=dev)[:, None] * f
    self._owner = torch.where(real, owner_s, 0).reshape(p, f).gather(1, inv)
    self._slot_j = slot_j
    self._pool_slot = torch.where(in_pool, pool_rank, -1).gather(1, inv)
    self.kept = (self._slot_j >= 0) | (self._pool_slot >= 0)
    self.delivered = self.kept
    valid = ids >= 0
    self.stats = torch.stack([
        valid.sum(1), (valid & ~self.kept).sum(1),
        torch.full((p,), p * cap + v, dtype=torch.int64, device=dev)], 1)

  def reply(self, values: torch.Tensor, fill=0) -> torch.Tensor:
    """Owner-side ``[P_owner, P * C + P * V, ...]`` values -> ``[P, F,
    ...]`` in request order."""
    p, cap, v = self.num_parts, self.cap, self.pool
    trail = tuple(values.shape[2:])
    rr = torch.arange(p, device=values.device)[:, None]
    # row o of a partition's pool reply is owner o's answers for its pool
    pool_back = self.mesh.all_to_all(
        values[:, p * cap:].reshape((p, p, v) + trail))
    out = pool_back[rr, self._owner, self._pool_slot.clamp(min=0)]
    out = torch.where(_bcast(self._pool_slot >= 0, out), out,
                      _fill_like(out, fill))
    if cap > 0:
      base_back = self.mesh.all_to_all(
          values[:, :p * cap].reshape((p, p, cap) + trail))
      ob = base_back[rr, self._owner, self._slot_j.clamp(min=0)]
      out = torch.where(_bcast(self._slot_j >= 0, ob), ob, out)
    return out


@functools.lru_cache(maxsize=64)
def _group_index(rows: int, cols: int, by_row: bool, device):
  """``(src [P, G], pos [P])``: the receive map of an all-to-all within
  the mesh rows (``by_row``) or columns of a ``[rows, cols]`` factoring
  — partition ``d`` receives its slot ``j`` from ``src[d, j]``, which
  sent it from its bucket ``pos[d]``."""
  grid = np.arange(rows * cols).reshape(rows, cols)
  groups = grid if by_row else grid.T
  src = np.zeros((rows * cols, groups.shape[1]), np.int64)
  pos = np.zeros(rows * cols, np.int64)
  for g in groups:
    src[g] = g
    pos[g] = np.arange(len(g))
  return (torch.from_numpy(src).to(device), torch.from_numpy(pos).to(device))


class _SubExchange:
  """One bucketed all-to-all over ``nbuckets`` destinations within the
  mesh groups ``(rows, cols, by_row)`` (hier's stage; the JAX package's
  `_SubExchange`)."""

  def __init__(self, ids, owner, nbuckets: int, capacity: int, groups,
               payload=None):
    p = ids.shape[0]
    send, self.slot_p, self.slot_j, *send_pl = bucket_stacked(
        ids, owner, nbuckets, capacity, payload=payload)
    self.cap = send.shape[2]
    self.nbuckets = nbuckets
    self._src, self._pos = _group_index(*groups, ids.device)
    self.recv = self._a2a(send).reshape(p, -1)
    self.recv_payload = (self._a2a(send_pl[0]).reshape(p, -1)
                         if payload is not None else None)
    self.kept = self.slot_j >= 0
    valid = ids >= 0
    self.offered = valid.sum(1)
    self.dropped = (valid & ~self.kept).sum(1)

  def _a2a(self, x: torch.Tensor) -> torch.Tensor:
    """``[P, G, C, ...]`` sends -> ``[P, G, C, ...]`` receives."""
    return x[self._src, self._pos[:, None]]

  def reply(self, values: torch.Tensor, fill) -> torch.Tensor:
    p = values.shape[0]
    trail = tuple(values.shape[2:])
    back = self._a2a(values.reshape((p, self.nbuckets, self.cap) + trail))
    rr = torch.arange(p, device=values.device)[:, None]
    out = back[rr, self.slot_p, self.slot_j.clamp(min=0)]
    return torch.where(_bcast(self.kept, out), out, _fill_like(out, fill))


class HierPlan:
  """The two-stage layout (the JAX package's `_HierPlan`): stage 1
  within mesh rows buckets by owner column (capacity ``c1``), stage 2
  within mesh columns by owner row (``c2``); the intermediate recomputes
  owners from the ids.  The owner's receive buffer is ``[rows * c2]``.
  Stage-2 drops cross back through stage 1 as a delivered bit.  No
  ``requester_of_recv``: the stage-2 rows no longer know their source."""

  layout = 'hier'
  requester_of_recv = None

  def __init__(self, ids: torch.Tensor, owner_fn: Callable, num_parts: int,
               mesh, spec: ExchangeSpec,
               payload: Optional[torch.Tensor] = None):
    rows, cols = spec.rows, spec.cols
    c1, c2 = spec.stage_caps
    self.mesh, self.num_parts = mesh, num_parts
    owner = owner_fn(ids).to(torch.int64)
    pl = None if payload is None else payload.to(ids.dtype)
    st1 = _SubExchange(ids, owner % cols, cols, c1, (rows, cols, True),
                       payload=pl)
    owner1 = owner_fn(st1.recv).to(torch.int64)
    st2 = _SubExchange(st1.recv, owner1 // cols, rows, c2,
                       (rows, cols, False),
                       payload=st1.recv_payload)
    self.recv = st2.recv
    self.recv_payload = st2.recv_payload
    self._st1, self._st2 = st1, st2
    self.kept = st1.kept
    bits = st1.reply(st2.kept.to(torch.int8), fill=0)
    self.delivered = st1.kept & (bits > 0)
    self.stats = torch.stack([
        st1.offered + st2.offered, st1.dropped + st2.dropped,
        torch.full((num_parts,), cols * c1 + rows * c2, dtype=torch.int64,
                   device=ids.device)], 1)

  def reply(self, values: torch.Tensor, fill=0) -> torch.Tensor:
    out = self._st1.reply(self._st2.reply(values, fill), fill)
    return torch.where(_bcast(self.delivered, out), out,
                       _fill_like(out, fill))


def plan_exchange(ids: torch.Tensor, owner_fn: Callable, num_parts: int,
                  mesh, capacity=None,
                  payload: Optional[torch.Tensor] = None):
  """The exchange plan for the ``[P, F]`` request vectors of every
  partition (-1 padded) with an optional ``[P, F]`` ``payload`` riding
  beside the ids.  ``capacity``: None (exact dense), a dense
  per-destination int, or an `ExchangeSpec` (`capacity_spec`)."""
  if isinstance(capacity, ExchangeSpec):
    if capacity.layout == 'compact':
      return CompactPlan(ids, owner_fn, num_parts, mesh, capacity, payload)
    if capacity.layout == 'hier':
      return HierPlan(ids, owner_fn, num_parts, mesh, capacity, payload)
    capacity = capacity.capacity
  return DensePlan(ids, owner_fn, num_parts, mesh, capacity, payload)
