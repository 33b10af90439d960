"""Device victim caches over the cold tier's feature rows and the
pinned-host cold block (the JAX package's `data/cold_cache.py`).

The policy lives on the host and is the JAX package's, copied: a CLOCK
(second-chance) ring over id tags, admissions ranked by a decayed visit
sketch (`ops.gns.DecayedSketch`), a bounded eviction wave.  The rows
live on the card: a hit is served by a device gather, an admission
copies rows that are already on the card (the corrected miss rows of
the batch) — cached bytes never return to the host.  Two flavors: the
single-card `DeviceColdCache` (a ``[C, D]`` ring, behind `data.Feature`)
and the mesh's `MeshColdCache` (``[P, C, D]``, whose residents are the
dynamic half of the GNS cached set).

`PinnedColdBuffer` keeps a tiered store's cold block in page-locked host
memory, where the cold-gather kernel (`ops.cold_gather`) reads the miss
rows straight into the card's batch.
"""
from __future__ import annotations

import os
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.cold_gather import cold_gather, host_register, host_unregister
from ..ops.gns import DecayedSketch
from ..telemetry.live import live
from ..telemetry.memaccount import register_tier
from ..telemetry.recorder import recorder
from ..utils.device import resolve_device

#: 'auto' budget: this fraction of the (per-partition max) cold rows
DEFAULT_BUDGET_FRACTION = 0.15
#: evicting admissions per wave, as a fraction of the capacity
ADMIT_WAVE_FRACTION = 0.25

_ENV_ROWS = 'GLT_COLD_CACHE_ROWS'


def resolve_cache_rows(spec, cold_rows: int) -> int:
  """int = rows per partition (0 disables); None/'auto' = ``GLT_COLD_CACHE_
  ROWS`` when set, else `DEFAULT_BUDGET_FRACTION` of ``cold_rows``."""
  if spec in (None, 'auto'):
    env = os.environ.get(_ENV_ROWS)
    if env is not None:
      try:
        return max(int(env), 0)
      except ValueError:
        pass
    if cold_rows <= 0:
      return 0
    return int(np.ceil(cold_rows * DEFAULT_BUDGET_FRACTION))
  return max(int(spec), 0)


class ClockShardCache:
  """CLOCK second-chance id -> slot policy for ONE partition's cache (host
  metadata only: tags, reference bits, the hand, the visit sketch)."""

  def __init__(self, capacity: int, bounds=None):
    self.capacity = int(capacity)
    self.ids = np.full(self.capacity, -1, np.int64)
    self.ref = np.zeros(self.capacity, np.uint8)
    self.hand = 0
    # with the book's bounds the sketch keeps the per-range mass too
    self.sketch = DecayedSketch(bounds=bounds)
    #: bumped on every committed admission wave (the GNS mask refresh
    #: rebuilds only when it moved)
    self.version = 0
    self._sorted_ids = np.empty(0, np.int64)
    self._sorted_slots = np.empty(0, np.int32)

  @property
  def size(self) -> int:
    return len(self._sorted_ids)

  def _rebuild(self) -> None:
    occ = np.nonzero(self.ids >= 0)[0]
    order = np.argsort(self.ids[occ], kind='stable')
    self._sorted_ids = self.ids[occ][order]
    self._sorted_slots = occ[order].astype(np.int32)

  def lookup(self, ids: np.ndarray, active: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """``(hit, slot)`` for an id array; ``active`` masks which entries
    take part.  Hits set the second-chance bit."""
    ids = np.asarray(ids, np.int64)
    hit = np.zeros(ids.shape, bool)
    slot = np.zeros(ids.shape, np.int32)
    if self.size == 0:
      return hit, slot
    if active is not None:
      sel = np.nonzero(active)
      sub = ids[sel]
      pos = np.clip(np.searchsorted(self._sorted_ids, sub), 0,
                    self.size - 1)
      h = self._sorted_ids[pos] == sub
      s = self._sorted_slots[pos]
      hit[sel] = h
      slot[sel] = np.where(h, s, 0)
      if h.any():
        self.ref[s[h]] = 1
      return hit, slot
    pos = np.clip(np.searchsorted(self._sorted_ids, ids), 0, self.size - 1)
    hit = self._sorted_ids[pos] == ids
    slot = np.where(hit, self._sorted_slots[pos], 0).astype(np.int32)
    if hit.any():
      self.ref[slot[hit]] = 1
    return hit, slot

  def plan_admissions(self, cand_ids: np.ndarray,
                      cand_counts: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Assign ring slots to unique, non-resident candidates ranked by
    sketch score (free slots first, then one batched CLOCK sweep of at
    most an `ADMIT_WAVE_FRACTION` wave).  Returns ``(admitted_ids,
    slots, evicted)``; call `commit` once the rows are written."""
    cand_ids = np.asarray(cand_ids, np.int64)
    if cand_ids.size == 0 or self.capacity == 0:
      return (np.empty(0, np.int64), np.empty(0, np.int32), 0)
    if cand_counts is None:
      cand_counts = np.ones(len(cand_ids), np.int64)
    self.sketch.update(cand_ids, cand_counts)
    order = np.lexsort((cand_ids, -self.sketch.score(cand_ids)))
    n_free = int(np.count_nonzero(self.ids < 0))
    wave = max(int(self.capacity * ADMIT_WAVE_FRACTION), 1)
    cand = cand_ids[order][:min(self.capacity, n_free + wave)]
    free = np.nonzero(self.ids < 0)[0]
    n_free = min(len(free), len(cand))
    slots = [free[:n_free].astype(np.int32)]
    need = len(cand) - n_free
    evicted = 0
    if need > 0:
      sweep = (self.hand + np.arange(self.capacity)) % self.capacity
      occ = self.ids[sweep] >= 0
      fresh = self.ref[sweep] == 0
      clear = occ & fresh
      cand_pos = np.nonzero(clear)[0]
      if len(cand_pos) >= need:
        stop = cand_pos[need - 1]
        victims = sweep[cand_pos[:need]]
        self.ref[sweep[:stop + 1]] = 0
        self.hand = (int(sweep[stop]) + 1) % self.capacity
      else:
        victims = np.concatenate([sweep[clear],
                                  sweep[occ & ~fresh]])[:need]
        self.ref[:] = 0
        if len(victims):
          self.hand = (int(victims[-1]) + 1) % self.capacity
      evicted = len(victims)
      if evicted:
        slots.append(victims.astype(np.int32))
    out_slots = np.concatenate(slots)
    return cand[:len(out_slots)], out_slots, evicted

  def commit(self, ids: np.ndarray, slots: np.ndarray) -> None:
    if not len(ids):
      return                        # an empty wave changes nothing
    self.ids[slots] = ids
    self.ref[slots] = 0
    self.version += 1
    self._rebuild()

  def resident_ids(self) -> np.ndarray:
    """The current residents, sorted."""
    return self._sorted_ids

  # -- DataPlaneState: the ring, the hand and the visit sketch ------------
  def state_dict(self) -> dict:
    return {'ids': self.ids.copy(), 'ref': self.ref.copy(),
            'hand': self.hand, 'sketch': self.sketch.state_dict()}

  def load_state_dict(self, state: dict) -> None:
    ids = np.asarray(state['ids'], np.int64)
    if ids.shape != self.ids.shape:
      raise ValueError(
          f'cold-cache snapshot capacity {ids.shape[0]} does not match '
          f'this cache ({self.capacity}); resume with the same '
          f'{_ENV_ROWS} the snapshot was taken under')
    self.ids = ids
    self.ref = np.asarray(state['ref'], np.uint8).copy()
    self.hand = int(np.asarray(state['hand']))
    if 'sketch' in state:
      self.sketch.load_state_dict(state['sketch'])
    self.version += 1
    self._rebuild()


class CacheStats:
  """Flat counters of one cache."""

  __slots__ = ('hits', 'misses', 'admits', 'evicts')

  def __init__(self):
    self.hits = self.misses = self.admits = self.evicts = 0

  def snapshot(self) -> dict:
    return {'hits': self.hits, 'misses': self.misses,
            'admits': self.admits, 'evicts': self.evicts}


def emit_cache_events(scope: str, hits: int, misses: int, admits: int,
                      evicts: int) -> None:
  """One lookup's cache counts: always into the live counters
  ``cache.{hits,misses,admits,evicts}_total{scope=}``, and as
  ``cache.hit`` / ``cache.miss`` / ``cache.admit`` / ``cache.evict``
  events when the recorder is on (zero counts are skipped)."""
  counts = (('hit', 'hits', hits), ('miss', 'misses', misses),
            ('admit', 'admits', admits), ('evict', 'evicts', evicts))
  for _, plural, n in counts:
    if n:
      live.counter(f'cache.{plural}_total',
                   labels={'scope': scope}).inc(float(n))
  if recorder.enabled:
    for kind, _, n in counts:
      if n:
        recorder.emit(f'cache.{kind}', scope=scope, count=int(n))


def _weak_bytes(owner, attr: str):
  """A memaccount callback that reads ``owner.<attr>``'s bytes without
  keeping the owner alive (None once it is gone)."""
  ref = weakref.ref(owner)

  def fn():
    o = ref()
    if o is None:
      return None
    t = getattr(o, attr)
    return t.numel() * t.element_size()
  return fn


class DeviceColdCache:
  """Single-card victim cache: a `MeshColdCache` of one partition (one
  `ClockShardCache` policy over a ``[C, D]`` row ring on ``device``),
  with its `CacheStats`.  Keys are the caller's (the `data.Feature` uses
  storage rows, so the cache composes with any ``id2index``).  Owns the
  ``cold_cache`` memory tier."""

  def __init__(self, capacity: int, dim: int, dtype, device='cuda'):
    self._mesh = MeshColdCache(capacity, dim, dtype, 1, device)
    self.stats = CacheStats()
    register_tier('cold_cache', _weak_bytes(self, 'rows'))

  @property
  def capacity(self) -> int:
    return self._mesh.capacity

  @property
  def policy(self) -> ClockShardCache:
    return self._mesh.shards[0]

  @property
  def rows(self) -> torch.Tensor:
    """The ``[max(C, 1), D]`` row ring."""
    return self._mesh.rows[0]

  def lookup(self, ids: np.ndarray,
             active: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(hit, slot)`` over ``ids`` where ``active``; ticks the hit
    count."""
    hit, slot = self._mesh.lookup(np.asarray(ids)[None], active[None])
    self.stats.hits += int(hit.sum())
    return hit[0], slot[0]

  def serve_hits(self, x: torch.Tensor, hit: np.ndarray,
                 slot: np.ndarray) -> torch.Tensor:
    """``x[i] = rows[slot[i]]`` where ``hit``, in place on ``x`` (a
    fresh batch tensor), by one device gather."""
    self._mesh.serve(x[None], hit[None], slot[None])
    return x

  def admit(self, x: torch.Tensor, ids: np.ndarray,
            miss: np.ndarray) -> Tuple[int, int]:
    """Admit this batch's (corrected, on-card) miss rows: the miss
    multiset deduplicated and ranked by the policy, the winners copied
    from ``x`` into their slots.  Returns ``(admits, evicts)``."""
    self.stats.misses += int(miss.sum())
    plans = self._mesh.plan_admissions(np.asarray(ids)[None], miss[None])
    admits, evicts = self._mesh.commit_admissions(x[None], plans)
    self.stats.admits += admits
    self.stats.evicts += evicts
    return admits, evicts

  # -- DataPlaneState: the policy and the row ring ------------------------
  def state_dict(self) -> dict:
    return {'policy': self.policy.state_dict(), 'rows': self.rows.cpu()}

  def load_state_dict(self, state: dict) -> None:
    self.policy.load_state_dict(state['policy'])     # checks capacity
    self.rows.copy_(torch.as_tensor(state['rows']).to(self.rows.dtype))


class PinnedColdBuffer:
  """A tiered store's cold rows ``[Nc, D]`` in host memory, cast to the
  store's dtype once, here.  For a CUDA ``device`` the block is a private
  copy page-locked in place (`ops.cold_gather.host_register`: exactly its
  bytes — a `pin_memory` copy would round 784 MB up to 1 GiB) and mapped
  for the card, which reads the miss rows through the cold-gather
  kernel; `close` unregisters it.  For the CPU it is the rows as given
  (cast where asked).  Owns the ``pinned_host`` memory tier."""

  def __init__(self, rows, dim: int, dtype: Optional[torch.dtype] = None,
               device='cuda'):
    dev = resolve_device(device)
    src = rows if isinstance(rows, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(rows))
    if src.ndim != 2 or src.shape[1] != int(dim):
      raise ValueError(f'expected a [rows, {dim}] cold block, got '
                       f'{tuple(src.shape)}')
    dtype = src.dtype if dtype is None else dtype
    self._registered = False
    if dev.type == 'cuda':
      self.rows = torch.empty(tuple(src.shape), dtype=dtype)
      self.rows.copy_(src)
      host_register(self.rows)
      self._registered = True
    else:
      self.rows = src.to(dtype).contiguous()
    self.device = dev
    register_tier('pinned_host', _weak_bytes(self, 'rows'))

  def gather(self, out: torch.Tensor, pos: torch.Tensor,
             rel: torch.Tensor) -> torch.Tensor:
    """``out[pos[i]] = rows[rel[i]]`` in place (`ops.cold_gather`)."""
    return cold_gather(out, self.rows, pos, rel)

  def close(self) -> None:
    """Unregister the page-locked block (idempotent)."""
    if self._registered:
      self._registered = False
      host_unregister(self.rows)

  def __del__(self):
    try:
      self.close()
    except Exception:              # noqa: BLE001 — interpreter teardown
      pass


class MeshColdCache:
  """Per-partition victim caches: ``P`` `ClockShardCache` policies over a
  ``[P, C, D]`` row tensor on ``device``.  Each partition caches the cold
  rows it requested; the host calls take the ``[P, node_cap]`` id and
  mask tables the cold overlay already holds."""

  def __init__(self, capacity: int, dim: int, dtype, num_local: int = 1,
               device='cuda', bounds=None):
    device = resolve_device(device)
    self.capacity = int(capacity)
    self.shards = [ClockShardCache(capacity, bounds=bounds)
                   for _ in range(num_local)]
    self.rows = torch.zeros((num_local, max(self.capacity, 1), int(dim)),
                            dtype=dtype, device=device)
    self._hotness_fns = ()
    if bounds is not None:
      # the sketches' range mass: the top-K gns.range_hotness gauges
      from ..ops.gns import register_hotness_gauges
      self._hotness_fns = register_hotness_gauges(
          lambda: [sh.sketch for sh in self.shards],
          max(len(np.asarray(bounds)) - 1, 1))

  @property
  def version(self) -> int:
    """Sum of the shard versions: moves iff any residency changed."""
    return sum(sh.version for sh in self.shards)

  def lookup(self, ids_l: np.ndarray, active: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
    """``(hit [P, cap], slot [P, cap])`` over the stacked id table."""
    hit = np.zeros(ids_l.shape, bool)
    slot = np.zeros(ids_l.shape, np.int32)
    for j, sh in enumerate(self.shards):
      hit[j], slot[j] = sh.lookup(ids_l[j], active[j])
    return hit, slot

  def serve(self, x: torch.Tensor, hit: np.ndarray,
            slot: np.ndarray) -> torch.Tensor:
    """``x[p, i] = rows[p, slot[p, i]]`` where ``hit`` — in place on
    ``x`` (a fresh per-batch tensor), by a device gather."""
    if not hit.any():
      return x
    p_idx, i_idx = np.nonzero(hit)
    ds = torch.from_numpy(np.stack([
        p_idx * x.shape[1] + i_idx,
        p_idx * self.rows.shape[1] + slot[p_idx, i_idx]])).to(x.device)
    x.view(-1, x.shape[-1]).index_copy_(
        0, ds[0], self.rows.view(-1, self.rows.shape[-1]).index_select(
            0, ds[1]))
    return x

  def plan_admissions(self, ids_l: np.ndarray, miss: np.ndarray):
    """Per shard ``(admitted ids, slots, source positions in the node
    table, evicted)`` for the batch's miss rows."""
    plans = []
    for j, sh in enumerate(self.shards):
      m = miss[j]
      if not m.any() or self.capacity == 0:
        plans.append((np.empty(0, np.int64), np.empty(0, np.int32),
                      np.empty(0, np.int32), 0))
        continue
      uniq, first, counts = np.unique(ids_l[j][m], return_index=True,
                                      return_counts=True)
      adm, slots, ev = sh.plan_admissions(uniq, counts)
      # each admitted id's first position among the miss rows
      src = np.nonzero(m)[0][first[np.searchsorted(uniq, adm)]]
      plans.append((adm, slots, src.astype(np.int32), ev))
    return plans

  def commit_admissions(self, x: torch.Tensor, plans) -> Tuple[int, int]:
    """Copy the planned rows from ``x`` (already corrected on the card)
    into their slots and commit the tags.  Returns ``(admits,
    evicts)``."""
    admits = evicts = 0
    src_all, dst_all = [], []
    for j, (adm, slots, src, ev) in enumerate(plans):
      src_all.append(j * x.shape[1] + src.astype(np.int64))
      dst_all.append(j * self.rows.shape[1] + slots.astype(np.int64))
      admits += len(adm)
      evicts += ev
    if admits:
      sd = torch.from_numpy(np.stack([np.concatenate(src_all),
                                      np.concatenate(dst_all)])).to(x.device)
      self.rows.view(-1, self.rows.shape[-1]).index_copy_(
          0, sd[1], x.view(-1, x.shape[-1]).index_select(0, sd[0]))
    for sh, (adm, slots, _src, _ev) in zip(self.shards, plans):
      sh.commit(adm, slots)
    return admits, evicts

  # -- DataPlaneState: every shard's policy and the row rings --------------
  def state_dict(self) -> dict:
    """The JAX package's layout: ``{'shards': [policy state, ...],
    'rows': [P, C, D]}``."""
    return {'shards': [sh.state_dict() for sh in self.shards],
            'rows': self.rows.cpu().numpy()}

  def load_state_dict(self, state: dict) -> None:
    shards = state['shards']
    if len(shards) != len(self.shards):
      raise ValueError(f'cold-cache snapshot has {len(shards)} shards, this '
                       f'mesh cache holds {len(self.shards)}')
    for sh, st in zip(self.shards, shards):
      sh.load_state_dict(st)                 # checks the capacity
    self.rows.copy_(torch.as_tensor(np.asarray(state['rows'])).to(
        self.rows.dtype))
