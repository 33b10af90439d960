"""Versioned, transferable partition ownership: the routing authority of
the mesh (the JAX package's `parallel/partition_book.py`).

Nodes are relabelled so range ``r`` is the contiguous id span
``[bounds[r], bounds[r+1])``; the ranges never move (every feature
shard, seed split and hot/cold placement was built against them).
``owners[r]`` names the mesh position serving range ``r``.  At version
0 the book is the identity (``owners[r] == r``) and every reader runs
exactly the pre-book path.  `PartitionBook.adopt` (a crash: the
survivor serves an orphaned range from its durable shard) and
`PartitionBook.transfer` (a planned handoff) move one range, bump the
version and publish a new immutable `BookView`; readers pin one view a
dispatch and fence at their dispatch seam.

**Lanes.**  After a move one position serves several ranges: range
``r`` routes to the virtual destination ``owners[r] * S +
lane_of_range[r]`` (``S`` lanes a position; lane 0 is the position's
own range, a moved range takes the next lane).  Requests still bucket
per RANGE: capacity, positions and the draw key (``owner=r``) are the
range's, so a lane's receive buffer and its samples are bit-identical
to what the range's original owner had, and an adopted epoch's batches
equal the fault-free run's.

This module is the only place the ownership rules are written down: the
range ``searchsorted`` and the mod-strided edge-feature rule (edge ``e``
in row ``e // P`` of shard ``e % P``, `dist_data.build_dist_edge_feature`).
"""
from __future__ import annotations

import functools
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch


class AdoptionRefusedError(RuntimeError):
  """An ownership move that must not proceed: the range is already
  served off-owner (a second move would fork the routing authority), the
  survivor is itself dead, or it already carries a moved lane (one moved
  shard a position)."""


class BookView(NamedTuple):
  """One immutable published snapshot of the book."""
  version: int
  bounds: np.ndarray          # [P+1] frozen ownership ranges
  owners: np.ndarray          # [P] mesh position serving each range
  lane_of_range: np.ndarray   # [P] lane of each range at its owner
  slot_ranges: np.ndarray     # [P, S] range served by (position, lane), -1
  num_lanes: int

  @property
  def num_partitions(self) -> int:
    return len(self.bounds) - 1

  @property
  def is_identity(self) -> bool:
    return self.version == 0

  def spec(self) -> Optional['BookSpec']:
    """The hashable routing tables; None for the identity book, whose
    readers run the pre-book path."""
    if self.is_identity:
      return None
    return BookSpec(
        version=int(self.version), num_parts=self.num_partitions,
        num_lanes=int(self.num_lanes),
        owners=tuple(int(o) for o in self.owners),
        lane_of_range=tuple(int(x) for x in self.lane_of_range),
        slot_ranges=tuple(tuple(int(x) for x in row)
                          for row in self.slot_ranges))


class BookSpec(NamedTuple):
  """The static routing tables of a book (`BookView.spec` for a moved
  one, `identity_spec` for version 0)."""
  version: int
  num_parts: int
  num_lanes: int
  owners: Tuple[int, ...]
  lane_of_range: Tuple[int, ...]
  slot_ranges: Tuple[Tuple[int, ...], ...]

  @property
  def is_identity(self) -> bool:
    return self.owners == tuple(range(self.num_parts))


def identity_spec(num_parts: int) -> BookSpec:
  """The identity book's routing tables: one lane a position, range
  ``r`` served by position ``r``."""
  p = int(num_parts)
  return BookSpec(version=0, num_parts=p, num_lanes=1,
                  owners=tuple(range(p)), lane_of_range=(0,) * p,
                  slot_ranges=tuple((r,) for r in range(p)))


class PartitionBook:
  """Monotone-versioned range -> owner table over frozen contiguous
  ranges.  Mutations run under a lock and publish a fresh `BookView`;
  `view` is one attribute read, never a torn table."""

  def __init__(self, bounds: np.ndarray):
    bounds = np.asarray(bounds, np.int64)
    assert bounds.ndim == 1 and len(bounds) >= 2
    p = len(bounds) - 1
    self._lock = threading.Lock()
    self._version = 0                              # guarded-by: _lock
    self._owners = np.arange(p, dtype=np.int32)    # guarded-by: _lock
    #: one record per crash adoption              guarded-by: _lock
    self._adoptions: List[Dict] = []
    #: one record per planned handoff cutover      guarded-by: _lock
    self._transfers: List[Dict] = []
    self._bounds = bounds
    self._published = self._build_view_locked()

  def _build_view_locked(self) -> BookView:
    """The view of the guarded tables: each position's own range in lane
    0, moved ranges after it in range order."""
    p = len(self._bounds) - 1
    per_dev: List[List[int]] = [[] for _ in range(p)]
    lane = np.zeros(p, np.int32)
    for r in range(p):
      if int(self._owners[r]) == r:
        lane[r] = len(per_dev[r])
        per_dev[r].append(r)
    for r in range(p):
      o = int(self._owners[r])
      if o != r:
        lane[r] = len(per_dev[o])
        per_dev[o].append(r)
    s = max((len(d) for d in per_dev), default=1) or 1
    slots = np.full((p, s), -1, np.int32)
    for d in range(p):
      for j, r in enumerate(per_dev[d]):
        slots[d, j] = r
    return BookView(version=self._version, bounds=self._bounds,
                    owners=self._owners.copy(), lane_of_range=lane,
                    slot_ranges=slots, num_lanes=s)

  def view(self) -> BookView:
    """Pin the current published view."""
    return self._published

  @property
  def version(self) -> int:
    return self._published.version

  @property
  def bounds(self) -> np.ndarray:
    return self._bounds

  @property
  def num_partitions(self) -> int:
    return len(self._bounds) - 1

  def adoptions(self) -> List[Dict]:
    with self._lock:
      return [dict(a) for a in self._adoptions]

  def transfers(self) -> List[Dict]:
    """The planned-handoff ledger (one record a `transfer` cutover)."""
    with self._lock:
      return [dict(t) for t in self._transfers]

  def _publish(self) -> BookView:
    """Bump the version and publish (``_lock`` held)."""
    self._version += 1
    self._published = self._build_view_locked()
    return self._published

  @staticmethod
  def _announce(view: BookView, **fields) -> None:
    from ..telemetry.live import live
    from ..telemetry.recorder import recorder
    version = float(view.version)
    live.gauge('partition.book_version', fn=lambda: version)
    recorder.emit('partition.book_version', version=view.version,
                  num_lanes=view.num_lanes, **fields)

  def adopt(self, lost: int, survivor: int) -> BookView:
    """Move range ``lost`` to position ``survivor`` (a crash adoption);
    bump the version and publish.  A refusal (`AdoptionRefusedError`)
    leaves the book unchanged."""
    p = self.num_partitions
    lost, survivor = int(lost), int(survivor)
    if not 0 <= lost < p or not 0 <= survivor < p:
      raise AdoptionRefusedError(
          f'partition out of range: lost={lost} survivor={survivor} '
          f'(P={p})')
    if lost == survivor:
      raise AdoptionRefusedError(f'partition {lost} cannot adopt itself')
    with self._lock:
      if int(self._owners[lost]) != lost:
        raise AdoptionRefusedError(
            f'partition {lost} is already adopted (owner '
            f'{int(self._owners[lost])}, version {self._version}) — '
            'a second adoption would fork the routing authority')
      if int(self._owners[survivor]) != survivor:
        raise AdoptionRefusedError(
            f'survivor {survivor} is itself dead (owned by '
            f'{int(self._owners[survivor])})')
      if int(np.sum(self._owners == survivor)) > 1:
        raise AdoptionRefusedError(
            f'survivor {survivor} already carries an adopted shard '
            '(one adopted lane per survivor in v1) — pick another')
      self._owners[lost] = survivor
      view = self._publish()
      self._adoptions.append({'lost': lost, 'survivor': survivor,
                              'version': view.version})
    self._announce(view, lost=lost, survivor=survivor)
    return view

  def transfer(self, rng: int, frm: int, to: int) -> BookView:
    """Move range ``rng`` from its current owner ``frm`` to ``to`` in ONE
    version bump (a planned handoff's cutover, `parallel.handoff`).  The
    same lane rules as `adopt`, recorded in the separate ``transfers``
    ledger.  A refusal leaves the book unchanged."""
    p = self.num_partitions
    rng, frm, to = int(rng), int(frm), int(to)
    if not 0 <= rng < p or not 0 <= to < p:
      raise AdoptionRefusedError(
          f'partition out of range: rng={rng} to={to} (P={p})')
    if to == frm:
      raise AdoptionRefusedError(
          f'handoff of partition {rng} from {frm} to itself')
    with self._lock:
      if int(self._owners[rng]) != frm:
        raise AdoptionRefusedError(
            f'stale handoff source: range {rng} is owned by '
            f'{int(self._owners[rng])}, not {frm} (version '
            f'{self._version}) — refusing a cutover that would fork '
            'the routing authority')
      if int(self._owners[rng]) != rng:
        raise AdoptionRefusedError(
            f'range {rng} is already served off-owner (by {frm}) — '
            'one moved lane per range in v1; restore identity first')
      if int(self._owners[to]) != to:
        raise AdoptionRefusedError(
            f'destination {to} is itself dead (owned by '
            f'{int(self._owners[to])})')
      if int(np.sum(self._owners == to)) > 1:
        raise AdoptionRefusedError(
            f'destination {to} already carries an extra lane '
            '(one moved shard per device in v1) — pick another')
      self._owners[rng] = to
      view = self._publish()
      self._transfers.append({'range': rng, 'frm': frm, 'to': to,
                              'version': view.version})
    self._announce(view, lost=rng, survivor=to, planned=True)
    return view

  def live_partitions(self) -> np.ndarray:
    """Positions still serving their own range (eligible survivors)."""
    v = self.view()
    return np.nonzero(np.asarray(
        [int(v.owners[r]) == r for r in range(v.num_partitions)]))[0]

  def pick_survivor(self, lost: int) -> int:
    """The lowest-indexed live position serving only its own range."""
    v = self.view()
    counts = np.bincount(np.asarray(v.owners), minlength=v.num_partitions)
    for d in sorted(range(v.num_partitions),
                    key=lambda d: (int(counts[d]), d)):
      if d == int(lost):
        continue
      if int(v.owners[d]) == d and int(counts[d]) == 1:
        return d
    raise AdoptionRefusedError(
        f'no eligible survivor for partition {lost}: every live '
        'device already carries an adopted shard')


# -- ownership arithmetic (device and host forms) ----------------------------

def range_of(bounds: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
  """Device form: id -> range index (``searchsorted(side='right') -
  1``), int32; ``bounds`` an int64 tensor on the ids' device."""
  return (torch.searchsorted(bounds, ids.to(bounds.dtype), right=True)
          - 1).to(torch.int32)


def range_of_host(bounds, ids, num_parts: Optional[int] = None
                  ) -> np.ndarray:
  """Host form of `range_of`, clipped to valid ranges."""
  p = int(num_parts) if num_parts is not None else len(bounds) - 1
  return np.clip(np.searchsorted(bounds, np.asarray(ids), side='right') - 1,
                 0, p - 1).astype(np.int32)


def range_owner_fn(bounds: torch.Tensor):
  """The identity book's owner function of the hop and gather exchanges:
  owner == range."""
  def owner_fn(v):
    return range_of(bounds, v)
  return owner_fn


@functools.lru_cache(maxsize=32)
def _lane_tables(spec: BookSpec, device):
  """``owners`` and ``lane_of_range`` as int32 tensors on ``device``, and
  ``S``; uploaded once a (spec, device)."""
  owners = torch.tensor(spec.owners, dtype=torch.int32, device=device)
  lanes = torch.tensor(spec.lane_of_range, dtype=torch.int32, device=device)
  return owners, lanes, int(spec.num_lanes)


def book_owner_fn(bounds: torch.Tensor, spec: BookSpec):
  """A book's VIRTUAL owner function: range ``r`` routes to
  ``owners[r] * S + lane_of_range[r]`` (the range itself at the
  identity book)."""
  if spec.is_identity:
    return range_owner_fn(bounds)
  owners, lanes, s = _lane_tables(spec, bounds.device)

  def owner_fn(v):
    r = range_of(bounds, v).clamp(0, spec.num_parts - 1).long()
    return owners[r] * s + lanes[r]
  return owner_fn


def edge_owner_fn(num_parts: int):
  """The owner function of mod-sharded edge-feature tables: owner =
  ``eid % P``."""
  def owner_fn(v):
    return (v % num_parts).to(torch.int32)
  return owner_fn


def edge_book_owner_fn(num_parts: int, spec: BookSpec):
  """A book's virtual owner function of mod-sharded tables (`edge_owner_fn`
  at the identity book)."""
  if spec.is_identity:
    return edge_owner_fn(num_parts)

  def owner_fn(v):
    owners, lanes, s = _lane_tables(spec, v.device)
    r = (v % num_parts).long()
    return owners[r] * s + lanes[r]
  return owner_fn


def edge_local_rows(ids: torch.Tensor, num_parts: int) -> torch.Tensor:
  """The local row of mod-sharded tables: ``eid // P``."""
  return ids // num_parts


def edge_owner_host(ids, num_parts: int) -> np.ndarray:
  return (np.asarray(ids) % int(num_parts)).astype(np.int32)


def edge_local_rows_host(ids, num_parts: int) -> np.ndarray:
  return np.asarray(ids) // int(num_parts)


def hot_split_host(bounds, hot_counts, ids, valid=None):
  """The host-side hot/cold placement read: ``(rng, local, cold)`` —
  each id's range, its row within the range, and whether that row is
  past the range's hot count (served from the host tier).  Placement
  keys on the RANGE: a move changes the server, never the split."""
  ids = np.asarray(ids)
  if valid is None:
    valid = ids >= 0
  hot_counts = np.asarray(hot_counts)
  rng = range_of_host(bounds, ids, num_parts=len(hot_counts))
  local = np.where(valid, ids - np.asarray(bounds)[rng], 0)
  cold = valid & (local >= hot_counts[rng])
  return rng, local, cold
