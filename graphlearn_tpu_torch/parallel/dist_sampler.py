"""Mesh neighbor sampling with feature collection over a tiered store,
and its loader (the JAX package's `parallel/dist_sampler.py`: the node
path of `_dist_one_hop`, `dist_gather_multi`, `dist_gather`,
`_expand_and_collect`, `overlay_cold_host`, `AdaptiveSlack`,
`DistNeighborSampler`, `DistNeighborLoader`).

The mesh's ``P`` partitions share one card (`parallel.dp.Mesh`); every
per-partition tensor is stacked on a leading ``[P]`` axis, and the
partitions advance in lockstep, as the JAX package's SPMD program runs
its devices.  Per batch, `DistNeighborSampler._dispatch_nodes`
enqueues on the card (its uploads from pageable host memory wait for
the stream; nothing else does):

  hop h:  every partition buckets its frontier by owner -> one
          all-to-all of the stacked buffers -> each owner samples its
          receive buffer from its CSR (the GNS kernel with ``gns=True``,
          the uniform kernel otherwise; one launch per owner) -> reply
          -> `induce_next` per partition;
  rows:   one exchange gathers features (hot tier only: rows past the
          owner's hot count come back zero) and labels, each owner's
          read by the row gather kernel.

`_finish_nodes` then does the host half for a tiered store: the cold
overlay over the stacked ``[P, node_cap]`` table (victim-cache hits
served on the card, the misses gathered from host memory into a pinned
staging buffer and copied in, the corrected misses admitted to each
partition's cache); `DistNeighborSampler.overlay_secs` sums its parts'
host seconds.  The loader dispatches batch ``k+1`` before it
finishes batch ``k`` (``GLT_COLD_PREFETCH=0`` selects the sequential
order); batches are the same either way, except that the GNS mask of
batch ``k+1`` is read at dispatch, before batch ``k``'s admissions — as
in JAX.  ``prefetch=N`` runs both halves on a worker thread with its own
CUDA stream (`loader.prefetch`), ``N`` batches ahead of the trainer.

Random numbers come from a ``draws`` provider, ``draws(step, hop, rows,
k, w, gns, owner=o) -> (u [rows, k], v [rows, k])`` for the GNS sampler
or ``(u [rows, k], gumbel [rows, w])`` for the uniform one, where
``step`` counts dispatches from 1, ``owner`` is the partition that
samples the rows and row ``j`` belongs to the ``j``-th row of that
owner's receive buffer in ascending seed order.  The default
(`TorchDraws`) is a `torch.Generator` on the sampler's device seeded
from ``(seed, step, hop[, owner])``; the parity tests replay the JAX
package's keys instead.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..data.cold_cache import MeshColdCache, resolve_cache_rows
from ..loader.node_loader import SeedBatcher
from ..loader.prefetch import PrefetchingLoader
from ..loader.transform import Batch
from ..ops.draws import TorchDraws
from ..ops.fused_sample import sample_one_hop_fused, sample_one_hop_gns_fused
from ..ops.gather_rows import gather_rows
from ..ops.gns import (cached_set_bits, dedup_requester_bits, gns_enabled,
                       resolve_boost)
from ..ops.neighbor import default_window
from ..ops.unique import expand_hops
from ..telemetry.aggregate import exchange_summary
from ..telemetry.live import live
from ..telemetry.recorder import recorder
from ..utils.padding import INVALID_ID, max_sampled_nodes, round_up
from .dist_data import DistDataset
from .dp import Mesh, make_mesh
from .exchange import capacity_spec, plan_exchange
from .partition_book import hot_split_host, range_owner_fn

#: per-destination exchange capacity for shuffled seeds, as a multiple
#: of the balanced share (frontier / P)
DEFAULT_EXCHANGE_SLACK = 2.0

#: the exchange counters (offered = valid ids entering an exchange,
#: dropped = valid ids past an owner's capacity, slots = send width)
EXCHANGE_STAT_NAMES = (
    'frontier.offered', 'frontier.dropped', 'frontier.slots',
    'feature.offered', 'feature.dropped', 'feature.slots')

#: the host's cold-tier counters (``dist.feature.<name>``)
COLD_STAT_NAMES = ('lookups', 'cold_lookups', 'cold_misses', 'cache_hits',
                   'cache_admits', 'cache_evicts')

#: the cold overlay's parts, as `DistNeighborSampler.overlay_secs` sums
#: them: the node table's copy to the host (it waits for the stream),
#: `hot_split_host`, the cache lookup and serve, the host gather and its
#: copy to the card, and the admission planning and commit
OVERLAY_PARTS = ('d2h', 'hot_split', 'cache_serve', 'host_gather',
                 'admission')

Draws = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def int64_on(a, device) -> torch.Tensor:
  """``a`` (the ``[P + 1]`` ownership bounds, the ``[P]`` hot counts)
  as an int64 tensor on ``device``."""
  if isinstance(a, torch.Tensor):
    return a.to(device=device, dtype=torch.int64)
  return torch.from_numpy(np.asarray(a, np.int64)).to(device)


def resolve_exchange_slack(exchange_slack, shuffle: bool):
  """``'auto'``: `DEFAULT_EXCHANGE_SLACK` for shuffled seeds, exact
  (None) for sequential ones.  ``'adaptive'`` passes through (the
  loader attaches an `AdaptiveSlack`); it needs shuffled seeds, since a
  sequential seed range can land wholly on one owner."""
  if isinstance(exchange_slack, str):
    if exchange_slack == 'adaptive':
      if not shuffle:
        raise ValueError(
            "exchange_slack='adaptive' needs shuffle=True: sequential "
            'seed ranges can land entirely on one owner, where any cap '
            'silently drops most of a batch')
      return 'adaptive'
    if exchange_slack != 'auto':
      raise ValueError(f'unknown exchange_slack {exchange_slack!r}')
    return DEFAULT_EXCHANGE_SLACK if shuffle else None
  return exchange_slack


def _dist_one_hop(mesh: Mesh, indptr, indices, bounds_t, frontier, k: int,
                  draws: Draws, step: int, hop: int,
                  capacity: Optional[int], gns_bits=None,
                  gns_boost: Optional[float] = None):
  """One hop for every partition's ``[P, F]`` frontier: exchange, each
  owner samples its receive rows (in ascending id order) from its CSR,
  reply.  Returns ``(nbrs, mask, weights, stats)`` stacked ``[P, F,
  k]`` (``weights`` None without GNS) and the ``[3]`` exchange
  counters summed over the partitions."""
  plan = plan_exchange(frontier, range_owner_fn(bounds_t), mesh.size,
                       mesh, capacity)
  local = torch.where(plan.recv >= 0, plan.recv - bounds_t[:-1, None],
                      INVALID_ID).to(torch.int32)
  rows = local.shape[1]
  w = default_window(k)
  res = []
  for o in range(mesh.size):
    if gns_bits is not None:
      u, v = draws(step, hop, rows, k, w, True, owner=o)
      res.append(sample_one_hop_gns_fused(
          indptr[o], indices[o], local[o], k, u, v, gns_bits, gns_boost,
          req=plan.requester_of_recv, window=w, sort_locality=True))
    else:
      u, g = draws(step, hop, rows, k, w, False, owner=o)
      res.append(sample_one_hop_fused(indptr[o], indices[o], local[o], k,
                                      u, g, sort_locality=True))
  nbrs = plan.reply(torch.stack([r.nbrs for r in res]), fill=INVALID_ID)
  mask = plan.reply(torch.stack([r.mask for r in res]), fill=False)
  weights = (plan.reply(torch.stack([r.weights for r in res]), fill=0.0)
             if gns_bits is not None else None)
  return nbrs, mask, weights, plan.stats.sum(0)


def dist_gather_multi(mesh: Mesh, shards, bounds, ids,
                      capacity: Optional[int] = None, hot_counts=None):
  """Row gather from several range-sharded tables sharing one exchange,
  for every partition's ``[P, F]`` ids: ``out_t[p, i] =
  table_t[ids[p, i]]`` (zero rows for invalid or undelivered ids).
  ``shards`` are stacked ``[P, rows, ...]`` tables; with
  ``hot_counts`` (``[P]``) the FIRST is the hot tier: rows at or past
  the owner's hot count come back zero (the cold overlay fills them).
  Each owner's read is the row gather kernel (a ``[P, rows]`` table is
  read as ``[rows, 1]``).  Returns ``(outs, stats)``, ``stats`` the
  ``[3]`` counters summed over the partitions."""
  bounds_t = int64_on(bounds, ids.device)
  plan = plan_exchange(ids, range_owner_fn(bounds_t), mesh.size, mesh,
                       capacity)
  valid = plan.recv >= 0
  local = torch.where(valid, plan.recv - bounds_t[:-1, None], 0)
  ok = (ids >= 0) & plan.delivered
  hot = (None if hot_counts is None
         else int64_on(hot_counts, ids.device)[:, None])
  outs = []
  for t, shard in enumerate(shards):
    row_valid = valid if t or hot is None else valid & (local < hot)
    idx = torch.where(row_valid, local, INVALID_ID)
    rows = torch.stack([
        gather_rows(shard[o] if shard.ndim == 3 else shard[o][:, None],
                    idx[o]) for o in range(mesh.size)])
    out = plan.reply(rows, fill=0)
    out = torch.where(ok[..., None], out, torch.zeros((), dtype=out.dtype,
                                                      device=out.device))
    outs.append(out if shard.ndim == 3 else out[..., 0])
  return tuple(outs), plan.stats.sum(0)


def dist_gather(mesh: Mesh, shard, bounds, ids,
                capacity: Optional[int] = None) -> torch.Tensor:
  """One table's `dist_gather_multi`: ``[P, F]`` ids -> ``[P, F, ...]``
  rows."""
  (out,), _ = dist_gather_multi(mesh, (shard,), bounds, ids, capacity)
  return out


def overlay_cold_host(x: torch.Tensor, nodes_host: np.ndarray, cold_host,
                      cold_mask: np.ndarray, staging=None) -> int:
  """Fill the node-table rows marked in ``cold_mask`` from the host
  tier, in place on ``x`` (a fresh per-batch tensor): a host gather
  into a compact buffer (``staging``, pinned, when given), one copy to
  the card, one device scatter of the rows.  Returns the number of rows
  served."""
  n_cold = int(cold_mask.sum())
  if n_cold == 0:
    return 0
  flat = np.nonzero(cold_mask.reshape(-1))[0]
  ids = torch.from_numpy(nodes_host.reshape(-1)[flat])
  if staging is not None:
    buf = staging.take(n_cold, cold_host.shape[1], cold_host.dtype)
    torch.index_select(cold_host, 0, ids, out=buf)
    rows = buf.to(x.device, non_blocking=True)
    staging.record()
  else:
    rows = torch.index_select(cold_host, 0, ids).to(x.device)
  pos = torch.from_numpy(flat).to(x.device)
  x.view(-1, x.shape[-1]).index_copy_(0, pos, rows)
  return n_cold


class PinnedStaging:
  """A reusable pinned host buffer for the cold rows of one batch, grown
  by powers of two; a reuse waits for the previous copy out of it."""

  def __init__(self):
    self._buf = None
    self._event = None

  def take(self, n: int, dim: int, dtype) -> torch.Tensor:
    if self._event is not None:
      self._event.synchronize()
    rows = 1 << max(int(n) - 1, 0).bit_length()
    if (self._buf is None or self._buf.shape[0] < rows
        or self._buf.shape[1] != dim or self._buf.dtype != dtype):
      self._buf = torch.empty((rows, dim), dtype=dtype, pin_memory=True)
    return self._buf[:n]

  def record(self) -> None:
    """Mark the copy out of the buffer, on the current stream (a
    prefetch worker's own stream inside the worker)."""
    self._event = torch.cuda.Event()
    self._event.record(torch.cuda.current_stream())


#: `AdaptiveSlack` ladder, tightest first (None = exact).  The sub-1.25
#: rungs only bite where the dense layout's `MIN_EXCHANGE_CAP` floor
#: does not dominate the caps.
SLACK_LADDER = (0.75, 1.0, 1.25, 1.5, 2.0, 3.0, None)

#: tightest rung the ladder may reach by default (``GLT_SLACK_FLOOR``
#: overrides): the step to 0.75 undercuts the balanced share.
DEFAULT_SLACK_FLOOR = 1.0

#: per-epoch drop rate above which the controller widens
ADAPTIVE_DROP_TOLERANCE = 1e-3


class AdaptiveSlack:
  """Epoch-level exchange-capacity tuner over `SLACK_LADDER` (the JAX
  package's, dense layout).

  It starts at ``start`` (a rung, default `DEFAULT_EXCHANGE_SLACK`); its
  floor is ``floor`` when given, else ``GLT_SLACK_FLOOR`` (default
  `DEFAULT_SLACK_FLOOR`), rounded up to a rung.  A drop-free epoch
  tightens one rung, an epoch that dropped more than
  `ADAPTIVE_DROP_TOLERANCE` of its offered ids widens one rung, and the
  first tighten -> widen reversal pins the setting.  A drop-free epoch
  at the floor pins there (``pin_reason='floor'``); drops at the floor
  still widen.  Each change sets the sampler's ``exchange_slack``, ticks
  the ``dist.slack.transitions`` counter and records a
  ``slack.transition`` event (``slack.pinned`` on a pin).
  """

  #: every loss channel the shared slack caps gate
  OFFER_KEYS = ('dist.frontier.offered', 'dist.feature.offered')
  DROP_KEYS = ('dist.frontier.dropped', 'dist.feature.dropped')

  def __init__(self, sampler: 'DistNeighborSampler',
               start: float = DEFAULT_EXCHANGE_SLACK,
               floor: Optional[float] = None):
    self.sampler = sampler
    if floor is None:
      try:
        floor = float(os.environ.get('GLT_SLACK_FLOOR',
                                     DEFAULT_SLACK_FLOOR))
      except ValueError:
        floor = DEFAULT_SLACK_FLOOR
    finite = [s for s in SLACK_LADDER if s is not None]
    self._min_idx = min(
        (i for i, s in enumerate(SLACK_LADDER)
         if s is not None and s >= floor - 1e-9),
        default=len(finite) - 1)
    self.floor = SLACK_LADDER[self._min_idx]
    self._idx = SLACK_LADDER.index(start)
    self._pinned = False
    self._pin_reason = ''
    self._tightened_from = None
    self._last = {}
    self._transitions = live.counter('dist.slack.transitions')
    sampler.exchange_slack = SLACK_LADDER[self._idx]

  @property
  def slack(self):
    return SLACK_LADDER[self._idx]

  def _set(self, idx: int, reason: str = '', drop_rate: float = 0.0,
           pin_reason: str = '') -> None:
    if idx == self._idx:
      return
    frm = SLACK_LADDER[self._idx]
    self._idx = idx
    self.sampler.exchange_slack = SLACK_LADDER[idx]
    self._transitions.inc()
    recorder.emit('slack.transition', from_slack=frm,
                  to_slack=SLACK_LADDER[idx], reason=reason,
                  drop_rate=round(float(drop_rate), 6),
                  pin_reason=pin_reason)

  def _pin(self, reason: str, rate: float) -> None:
    self._pinned = True
    self._pin_reason = reason
    recorder.emit('slack.pinned', slack=SLACK_LADDER[self._idx],
                  drop_rate=round(float(rate), 6), pin_reason=reason)

  def on_epoch_end(self) -> None:
    """Read the epoch's exchange counters and retune."""
    st = self.sampler.exchange_stats()
    offered = sum(st[k] - self._last.get(k, 0) for k in self.OFFER_KEYS)
    dropped = sum(st[k] - self._last.get(k, 0) for k in self.DROP_KEYS)
    self._last = {k: st[k] for k in self.OFFER_KEYS + self.DROP_KEYS}
    if offered <= 0:
      return
    rate = dropped / offered
    tol = ADAPTIVE_DROP_TOLERANCE
    if self._pinned and (self._pin_reason != 'floor' or rate <= tol):
      # a reversal pin is final; a floor pin only stops tightening
      return
    if rate > tol:
      wider = min(self._idx + 1, len(SLACK_LADDER) - 1)
      pin = (self._tightened_from is not None
             and wider >= self._tightened_from)
      self._set(wider, reason='drops', drop_rate=rate,
                pin_reason='reversal' if pin else '')
      if pin:
        self._pin('reversal', rate)
      else:
        self._pinned = False
    elif self._idx > self._min_idx:
      self._tightened_from = self._idx
      self._set(self._idx - 1, reason='drop_free', drop_rate=rate)
    elif not self._pinned:
      self._pin('floor', rate)


class DistNeighborSampler:
  """Mesh sampler with feature and label collection.

  Args:
    dataset: `DistDataset` on ``device``.
    num_neighbors: per-hop fanouts.
    mesh: a `Mesh` of the dataset's partitions (default: all of them on
      ``device``).
    seed: seeds the default draws provider.
    exchange_slack: per-destination capacity multiplier (None = exact).
    cold_cache_rows: victim-cache rows per partition (tiered stores).
    gns: cache-aware sampling (``GLT_GNS`` when None); only meaningful
      on a tiered store, off otherwise.
    draws: the draws provider (module docstring).
  """

  def __init__(self, dataset: DistDataset, num_neighbors,
               mesh: Optional[Mesh] = None, collect_features: bool = True,
               seed: int = 0, exchange_slack: Optional[float] = None,
               cold_cache_rows='auto', gns=None,
               draws: Optional[Draws] = None, device='cuda'):
    self.mesh = mesh if mesh is not None else make_mesh(
        dataset.num_partitions, device=device)
    self.device = self.mesh.device
    if dataset.device != self.device:
      raise ValueError(f'the dataset lives on {dataset.device}, the mesh '
                       f'on {self.device}')
    if self.mesh.size != dataset.num_partitions:
      raise ValueError(f'mesh of {self.mesh.size} partitions for '
                       f'{dataset.num_partitions} partitions')
    self.ds = dataset
    self.fanouts = tuple(int(k) for k in num_neighbors)
    self.num_parts = dataset.num_partitions
    self.collect_features = (collect_features
                             and dataset.node_features is not None)
    self.collect_labels = dataset.node_labels is not None
    self.tiered = (self.collect_features
                   and dataset.node_features.is_tiered)
    self._cold_cache_spec = cold_cache_rows
    self._cold_cache = None
    self._cold_cache_built = False
    self.gns = bool(gns_enabled(gns) and self.tiered)
    self.gns_boost = resolve_boost() if self.gns else None
    self._gns_bits = None
    self._gns_hot_bits = None
    self._gns_ver = -1
    self.exchange_slack = exchange_slack
    self.draws = draws if draws is not None else TorchDraws(seed,
                                                            self.device)
    self._step_cnt = 0
    self._bounds_t = int64_on(dataset.graph.bounds, self.device)
    self._hot_t = (int64_on(dataset.node_features.hot_counts,
                                 self.device) if self.tiered else None)
    self._staging = PinnedStaging() if self.device.type == 'cuda' else None
    # exchange counters: a device accumulator drained into host totals
    # by `exchange_stats`, under the lock (a drain may race a dispatch)
    self._stats_lock = threading.Lock()
    self._stats_acc = torch.zeros(len(EXCHANGE_STAT_NAMES),
                                  dtype=torch.int64, device=self.device)
    self._stats_total = np.zeros(len(EXCHANGE_STAT_NAMES), np.int64)
    self._feat_lookups = self._cold_lookups = self._cold_misses = 0
    self._cache_hits = self._cache_admits = self._cache_evicts = 0
    self._cold_reported = (0,) * len(COLD_STAT_NAMES)
    #: host seconds of the cold overlay by part (`OVERLAY_PARTS`), summed
    #: since construction; a caller resets it to read a window
    self.overlay_secs = dict.fromkeys(OVERLAY_PARTS, 0.0)

  def node_capacity(self, batch_size: int) -> int:
    cap = max_sampled_nodes(batch_size, self.fanouts)
    cap = min(cap, batch_size + self.ds.graph.num_nodes)
    return round_up(cap, 8)

  def sample_from_nodes(self, seeds_stacked: np.ndarray) -> dict:
    """``[P, B]`` per-partition seed batches (relabelled ids, -1 padded)
    -> the stacked batch pieces."""
    return self._finish_nodes(self._dispatch_nodes(seeds_stacked))

  def _dispatch_nodes(self, seeds_stacked: np.ndarray) -> dict:
    """Sample and collect one stacked batch on the card, every
    partition hop by hop in lockstep, without the cold overlay."""
    b = seeds_stacked.shape[1]
    self._step_cnt += 1
    step = self._step_cnt
    seeds = torch.from_numpy(np.asarray(seeds_stacked, np.int32)).to(
        self.device)
    bits = self._gns_arrays() if self.gns else None
    g = self.ds.graph
    node_cap = self.node_capacity(b)
    hws = []
    fr_stats = torch.zeros(3, dtype=torch.int64, device=self.device)

    def one_hop(h, frontier, k):
      cap = capacity_spec(frontier.shape[1], self.num_parts,
                          self.exchange_slack)
      nbrs, mask, hw, hstats = _dist_one_hop(
          self.mesh, g.indptr, g.indices, self._bounds_t, frontier, k,
          self.draws, step, h, cap, gns_bits=bits,
          gns_boost=self.gns_boost)
      fr_stats.add_(hstats)
      hws.append(hw)
      return nbrs, mask

    state, seed_local, rows_acc, cols_acc, nsn = expand_hops(
        seeds, self.fanouts, node_cap, one_hop)
    out = dict(node=state.nodes, node_count=state.count,
               row=torch.cat(rows_acc, dim=1),
               col=torch.cat(cols_acc, dim=1), seed_local=seed_local,
               x=None, y=None, num_sampled_nodes=nsn, batch=seeds)
    if self.gns:
      # induce_next flattens [F, k] row-major: the weights line up with
      # the edge list; masked and dropped edges carry 0
      out['edge_weight'] = torch.cat(
          [torch.where(rows >= 0, hw.reshape(rows.shape), 0.0)
           for rows, hw in zip(rows_acc, hws)], dim=1)
    ft_stats = torch.zeros(3, dtype=torch.int64, device=self.device)
    tables = []
    if self.collect_features:
      tables.append(self.ds.node_features.shards)
    if self.collect_labels:
      tables.append(self.ds.node_labels)
    if tables:
      got, ft_stats = dist_gather_multi(
          self.mesh, tables, self._bounds_t, state.nodes,
          capacity=capacity_spec(node_cap, self.num_parts,
                                 self.exchange_slack),
          hot_counts=self._hot_t if self.collect_features else None)
      got = list(got)
      if self.collect_features:
        out['x'] = got.pop(0)
      if self.collect_labels:
        out['y'] = got.pop(0)
    with self._stats_lock:
      self._stats_acc += torch.cat([fr_stats, ft_stats])
    return out

  def _finish_nodes(self, out: dict) -> dict:
    """The host half of a dispatched batch: the cold overlay (nothing
    for a store wholly on the card)."""
    if self.tiered and out['x'] is not None:
      out['x'] = self._overlay_cold(out['x'], out['node'])
    return out

  def _ensure_cold_cache(self) -> Optional[MeshColdCache]:
    if self._cold_cache_built:
      return self._cold_cache
    self._cold_cache_built = True
    if not self.tiered:
      return None
    nf = self.ds.node_features
    counts = np.diff(self.ds.graph.bounds)
    cold_rows = int(np.maximum(counts - nf.hot_counts, 0).max(initial=0))
    cap = resolve_cache_rows(self._cold_cache_spec, cold_rows)
    if cap > 0:
      self._cold_cache = MeshColdCache(cap, nf.feature_dim,
                                       nf.shards.dtype, self.num_parts,
                                       self.device)
    return self._cold_cache

  def _gns_arrays(self):
    """The per-requester cached-set bitmask ``(table [T, N/8] uint8,
    row_index [P+1] int32)`` on the card, rebuilt only when the cold
    cache's residency moved (its version)."""
    cache = self._ensure_cold_cache()
    ver = cache.version if cache is not None else 0
    if self._gns_bits is None or ver != self._gns_ver:
      n = self.ds.graph.num_nodes
      nf = self.ds.node_features
      if self._gns_hot_bits is None:
        self._gns_hot_bits = cached_set_bits(n, self.ds.graph.bounds,
                                             nf.hot_counts,
                                             np.empty(0, np.int64))
      residents = {}
      if cache is not None:
        residents = {j: sh.resident_ids()
                     for j, sh in enumerate(cache.shards)}
      table, row_index = dedup_requester_bits(
          n, self.ds.graph.bounds, nf.hot_counts, residents,
          base_bits=self._gns_hot_bits)
      self._gns_bits = (torch.from_numpy(table).to(self.device),
                        torch.from_numpy(row_index).to(self.device))
      self._gns_ver = ver
    return self._gns_bits

  def _overlay_cold(self, x: torch.Tensor, nodes: torch.Tensor
                    ) -> torch.Tensor:
    """Victim-cache hits served on the card, the misses from the host
    tier, then the corrected misses admitted to the cache."""
    nf = self.ds.node_features
    g = self.ds.graph
    cache = self._ensure_cold_cache()
    hits = admits = evicts = 0
    secs = self.overlay_secs
    t0 = time.perf_counter()
    nodes_l = nodes.cpu().numpy().astype(np.int64)
    t1 = time.perf_counter()
    valid = nodes_l >= 0
    _rng, _local, cold = hot_split_host(g.bounds, nf.hot_counts, nodes_l,
                                        valid)
    t2 = time.perf_counter()
    lookups, cold_n = int(valid.sum()), int(cold.sum())
    miss = cold
    if cache is not None:
      hit, slot = cache.lookup(nodes_l, cold)
      hits = int(hit.sum())
      x = cache.serve(x, hit, slot)
      miss = cold & ~hit
    t3 = time.perf_counter()
    served = overlay_cold_host(x, nodes_l, nf.cold_host, miss,
                               staging=self._staging)
    t4 = time.perf_counter()
    if cache is not None and miss.any():
      admits, evicts = cache.commit_admissions(
          x, cache.plan_admissions(nodes_l, miss))
    t5 = time.perf_counter()
    for part, dt in zip(OVERLAY_PARTS, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                        t5 - t4)):
      secs[part] += dt
    self._feat_lookups += lookups
    self._cold_lookups += cold_n
    self._cold_misses += served
    self._cache_hits += hits
    self._cache_admits += admits
    self._cache_evicts += evicts
    return x

  def exchange_stats(self, tick_metrics: bool = True) -> dict:
    """Cumulative exchange and cold-tier counters since construction,
    summed over the partitions (one device sync): ``dist.frontier.*``,
    ``dist.feature.*`` and the hit rates.

    The drain runs under a lock.  With ``tick_metrics`` it ticks the
    live counters of the same names (`telemetry.live`) by the exchange
    counters' deltas since the previous drain and the cold-tier
    counters' since the previous ticking drain (the JAX package's
    rule), and records one ``dist.exchange`` event when the exchange
    counters moved and one ``dist.cold_tier`` event when cold lookups
    did, with the JAX package's fields.  The JAX package's ``dist.feature.cold_hit_rate``
    alias of ``cache_hit_rate`` is not carried, nor is its
    ``dist.negative.lost`` (the port's mesh loader samples no negative
    pairs).
    """
    with self._stats_lock:
      acc = self._stats_acc
      self._stats_acc = torch.zeros_like(acc)
      delta = acc.cpu().numpy().astype(np.int64)
      self._stats_total += delta
      totals = self._stats_total.copy()
      cold_now = (self._feat_lookups, self._cold_lookups,
                  self._cold_misses, self._cache_hits, self._cache_admits,
                  self._cache_evicts)
      cold_delta = (0,) * len(COLD_STAT_NAMES)
      if tick_metrics:
        cold_delta = tuple(n - p for n, p in zip(cold_now,
                                                 self._cold_reported))
        self._cold_reported = cold_now
    out = {f'dist.{n}': int(v) for n, v in zip(EXCHANGE_STAT_NAMES, totals)}
    for n, v in zip(COLD_STAT_NAMES, cold_now):
      out[f'dist.feature.{n}'] = v
    lookups, cold, misses = cold_now[:3]
    out['dist.feature.hot_hit_rate'] = (1.0 - cold / lookups if lookups
                                        else 1.0)
    out['dist.feature.cache_hit_rate'] = (1.0 - misses / cold if cold
                                          else 0.0)
    if tick_metrics:
      self._tick(delta, cold_delta)
    return out

  @staticmethod
  def _tick(delta: np.ndarray, cold_delta: tuple) -> None:
    for n, d in zip(EXCHANGE_STAT_NAMES, delta):
      if d:
        live.counter(f'dist.{n}').inc(float(d))
    for n, d in zip(COLD_STAT_NAMES, cold_delta):
      if d > 0:
        live.counter(f'dist.feature.{n}').inc(float(d))
    if delta.any():
      recorder.emit('dist.exchange',
                    **{n.replace('.', '_'): int(d)
                       for n, d in zip(EXCHANGE_STAT_NAMES, delta)})
    if cold_delta[1] > 0:
      recorder.emit('dist.cold_tier', lookups=int(cold_delta[0]),
                    cold_lookups=int(cold_delta[1]),
                    misses=int(cold_delta[2]),
                    cache_hits=int(cold_delta[3]),
                    hit_rate=round(1.0 - cold_delta[2] / cold_delta[1], 6))

  def cluster_exchange_stats(self) -> dict:
    """`exchange_stats` plus ``num_hosts`` and the derived padding-waste
    and drop-rate keys (`telemetry.aggregate.exchange_summary`).  The
    port's mesh runs in one process, so the cluster is this host."""
    st = dict(self.exchange_stats())
    st['num_hosts'] = 1
    st.update(exchange_summary(st))
    return st


class DistNeighborLoader(PrefetchingLoader):
  """Mesh loader: splits the (relabelled) seeds across the partitions
  and yields stacked `Batch`es (leading axis = partition) for
  `make_dp_supervised_step`.

  ``input_space='old'`` maps the seeds through ``dataset.old2new``.
  ``exchange_slack='adaptive'`` starts at 2.0 and retunes the exchange
  capacity (`AdaptiveSlack`) when a new epoch starts after the first.
  For a tiered store batch ``k+1`` is dispatched before batch ``k``'s
  cold overlay runs (``GLT_COLD_PREFETCH=0``: one batch at a time).
  ``prefetch=N`` produces batches on a worker thread with its own CUDA
  stream, ``N`` ahead of the consumer (`loader.prefetch`); batches are
  the same as without it.  Each ``iter()`` starts a new epoch.
  """

  def __init__(self, dataset: DistDataset, num_neighbors, input_nodes,
               batch_size: int = 1, shuffle: bool = False,
               drop_last: bool = False, mesh: Optional[Mesh] = None,
               collect_features: bool = True, seed: int = 0,
               input_space: str = 'old', exchange_slack='auto',
               prefetch: int = 0, cold_cache_rows='auto', gns=None,
               draws: Optional[Draws] = None, device='cuda'):
    self.prefetch = int(prefetch)
    slack = resolve_exchange_slack(exchange_slack, shuffle)
    self.sampler = DistNeighborSampler(
        dataset, num_neighbors, mesh=mesh,
        collect_features=collect_features, seed=seed,
        exchange_slack=(DEFAULT_EXCHANGE_SLACK if slack == 'adaptive'
                        else slack),
        cold_cache_rows=cold_cache_rows, gns=gns, draws=draws,
        device=device)
    self._prefetch_device = self.sampler.device
    self._adaptive = (AdaptiveSlack(self.sampler)
                      if slack == 'adaptive' else None)
    self._epoch_count = 0
    self._cold_pipeline = (self.sampler.tiered and os.environ.get(
        'GLT_COLD_PREFETCH', '1') != '0')
    self.ds = dataset
    seeds = np.asarray(input_nodes).reshape(-1)
    if input_space == 'old' and dataset.old2new is not None:
      seeds = dataset.old2new[seeds]
    self.num_parts = dataset.num_partitions
    self.batch_size = int(batch_size)
    self._batcher = SeedBatcher(seeds, self.batch_size * self.num_parts,
                                shuffle, drop_last, seed)

  def __len__(self) -> int:
    return len(self._batcher)

  def _dispatch_flat(self, flat: np.ndarray) -> dict:
    return self.sampler._dispatch_nodes(
        flat.reshape(self.num_parts, self.batch_size))

  def _produce(self, seed_iter) -> Batch:
    if self._cold_pipeline:
      out = self._pipelined(self._pipeline_acquire(seed_iter), seed_iter,
                            self._dispatch_flat, self.sampler._finish_nodes)
    else:
      out = self.sampler.sample_from_nodes(
          next(seed_iter).reshape(self.num_parts, self.batch_size))
    md = {'seed_local': out['seed_local']}
    if 'edge_weight' in out:
      md['edge_weight'] = out['edge_weight']
    return Batch(x=out['x'], y=out['y'],
                 edge_index=torch.stack([out['row'], out['col']], dim=1),
                 node=out['node'], node_mask=out['node'] >= 0,
                 edge_mask=out['row'] >= 0, batch=out['batch'],
                 batch_size=self.batch_size,
                 num_sampled_nodes=out['num_sampled_nodes'], metadata=md)
