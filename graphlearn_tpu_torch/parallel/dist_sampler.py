"""Mesh neighbor sampling with feature collection over a tiered store,
and its loader (the JAX package's `parallel/dist_sampler.py`: the node
path of `_dist_one_hop`, `dist_gather_multi`, `_expand_and_collect`,
`overlay_cold_host`, `DistNeighborSampler`, `DistNeighborLoader`).

Per batch, `DistNeighborSampler._dispatch_nodes` enqueues on the card
(its uploads from pageable host memory wait for the stream; nothing
else does):

  hop h:  bucket the frontier by owner -> all-to-all -> sample the
          owned CSR rows (the GNS kernel with ``gns=True``, the uniform
          kernel otherwise) -> reply -> `induce_next`;
  rows:   one exchange gathers features (hot tier only: rows past the
          owner's hot count come back zero) and labels by the row
          gather kernel.

`_finish_nodes` then does the host half for a tiered store: the cold
overlay (victim-cache hits served on the card, the misses gathered
from host memory into a pinned staging buffer and copied in, the
corrected misses admitted to the cache).  The loader dispatches batch
``k+1`` before it finishes batch ``k`` (``GLT_COLD_PREFETCH=0`` selects
the sequential order); batches are the same either way, except that
the GNS mask of batch ``k+1`` is read at dispatch, before batch ``k``'s
admissions — as in JAX.

Random numbers come from a ``draws`` provider, ``draws(step, hop, rows,
k, w, gns) -> (u [rows, k], v [rows, k])`` for the GNS sampler or
``(u [rows, k], gumbel [rows, w])`` for the uniform one, where ``step``
counts dispatches from 1 and row ``j`` belongs to the ``j``-th row of
the owner's receive buffer in ascending seed order.  The default
(`TorchDraws`) is a `torch.Generator` on the sampler's device seeded
from ``(seed, step, hop)``; the parity tests replay the JAX package's
keys instead.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..data.cold_cache import MeshColdCache, resolve_cache_rows
from ..loader.node_loader import SeedBatcher
from ..loader.transform import Batch
from ..ops.draws import TorchDraws
from ..ops.fused_sample import sample_one_hop_fused, sample_one_hop_gns_fused
from ..ops.gather_rows import gather_rows
from ..ops.gns import (cached_set_bits, dedup_requester_bits, gns_enabled,
                       resolve_boost)
from ..ops.neighbor import default_window
from ..ops.unique import expand_hops
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

Draws = Callable[[int, int, int, int, int, bool],
                 Tuple[torch.Tensor, torch.Tensor]]


def resolve_exchange_slack(exchange_slack, shuffle: bool):
  """``'auto'``: `DEFAULT_EXCHANGE_SLACK` for shuffled seeds, exact
  (None) for sequential ones."""
  if isinstance(exchange_slack, str):
    if exchange_slack != 'auto':
      raise ValueError(f'unknown exchange_slack {exchange_slack!r} (the '
                       "adaptive controller is not ported)")
    return DEFAULT_EXCHANGE_SLACK if shuffle else None
  return exchange_slack


def _dist_one_hop(mesh: Mesh, indptr, indices, bounds_t, my_start: int,
                  frontier, k: int, draws: Draws, step: int, hop: int,
                  num_parts: int, capacity: Optional[int],
                  gns_bits=None, gns_boost: Optional[float] = None):
  """One hop for this card's frontier: exchange, sample the owned rows
  (in ascending id order), reply.  Returns ``(nbrs, mask, weights,
  stats)``; ``weights`` is None without GNS."""
  plan = plan_exchange(frontier, range_owner_fn(bounds_t), num_parts,
                       mesh, capacity)
  flat = plan.recv
  local = torch.where(flat >= 0, flat - my_start, INVALID_ID).to(
      torch.int32)
  rows = local.shape[0]
  w = default_window(k)
  if gns_bits is not None:
    u, v = draws(step, hop, rows, k, w, True)
    res = sample_one_hop_gns_fused(indptr, indices, local, k, u, v,
                                   gns_bits, gns_boost,
                                   req=plan.requester_of_recv, window=w,
                                   sort_locality=True)
  else:
    u, g = draws(step, hop, rows, k, w, False)
    res = sample_one_hop_fused(indptr, indices, local, k, u, g,
                               sort_locality=True)
  nbrs = plan.reply(res.nbrs, fill=INVALID_ID)
  mask = plan.reply(res.mask, fill=False)
  weights = (plan.reply(res.weights, fill=0.0)
             if res.weights is not None else None)
  return nbrs, mask, weights, plan.stats


def dist_gather_multi(mesh: Mesh, shard_locs, bounds_t, my_start: int,
                      ids, num_parts: int,
                      capacity: Optional[int] = None,
                      hot_count: Optional[int] = None):
  """Row gather from several range-sharded tables sharing one exchange:
  ``out_t[i] = table_t[ids[i]]`` (zero rows for invalid or undelivered
  ids).  With ``hot_count`` the FIRST table is the hot tier: rows at or
  past the owner's hot count come back zero (the cold overlay fills
  them).  The owner's read is the row gather kernel; a 1-D table is
  read as ``[rows, 1]``.  Returns ``(outs, stats)``."""
  plan = plan_exchange(ids, range_owner_fn(bounds_t), num_parts, mesh,
                       capacity)
  flat = plan.recv
  valid = flat >= 0
  local = torch.where(valid, flat - my_start, 0)
  ok = (ids >= 0) & plan.delivered
  outs = []
  for t, shard in enumerate(shard_locs):
    row_valid = valid
    if t == 0 and hot_count is not None:
      row_valid = valid & (local < hot_count)
    table = shard if shard.ndim == 2 else shard[:, None]
    rows = gather_rows(table, torch.where(row_valid, local, INVALID_ID))
    out = plan.reply(rows, fill=0)
    out = torch.where(ok[:, None], out, torch.zeros((), dtype=out.dtype,
                                                    device=out.device))
    outs.append(out if shard.ndim == 2 else out[:, 0])
  return tuple(outs), plan.stats


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
    self._event = torch.cuda.Event()
    self._event.record()


class DistNeighborSampler:
  """Mesh sampler with feature and label collection.

  Args:
    dataset: `DistDataset` on ``device``.
    num_neighbors: per-hop fanouts.
    mesh: a `Mesh` (default: one card on ``device``).
    seed: seeds the default draws provider.
    exchange_slack: per-destination capacity multiplier (None = exact).
    cold_cache_rows: victim-cache rows per card (tiered stores).
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
      raise ValueError(f'mesh of {self.mesh.size} cards for '
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
    self._bounds_t = torch.from_numpy(dataset.graph.bounds).to(self.device)
    self._staging = PinnedStaging() if self.device.type == 'cuda' else None
    self._stats_acc = torch.zeros(len(EXCHANGE_STAT_NAMES),
                                  dtype=torch.int64, device=self.device)
    self._feat_lookups = self._cold_lookups = self._cold_misses = 0
    self._cache_hits = self._cache_admits = self._cache_evicts = 0

  def node_capacity(self, batch_size: int) -> int:
    cap = max_sampled_nodes(batch_size, self.fanouts)
    cap = min(cap, batch_size + self.ds.graph.num_nodes)
    return round_up(cap, 8)

  def sample_from_nodes(self, seeds_stacked: np.ndarray) -> dict:
    """``[P, B]`` per-card seed batches (relabelled ids, -1 padded) ->
    the stacked batch pieces."""
    return self._finish_nodes(self._dispatch_nodes(seeds_stacked))

  def _dispatch_nodes(self, seeds_stacked: np.ndarray) -> dict:
    """Sample and collect one stacked batch on the card, without the
    cold overlay."""
    b = seeds_stacked.shape[1]
    self._step_cnt += 1
    seeds = torch.from_numpy(np.asarray(seeds_stacked, np.int32)).to(
        self.device)
    bits = self._gns_arrays() if self.gns else None
    outs = [self._expand_and_collect(p, seeds[p], b, bits)
            for p in range(self.mesh.size)]
    out = {key: (torch.stack([o[key] for o in outs])
                 if outs[0][key] is not None else None)
           for key in outs[0] if key != 'stats'}
    self._stats_acc += sum(o['stats'] for o in outs)
    out['batch'] = seeds
    if not self.gns:
      out.pop('edge_weight')
    return out

  def _expand_and_collect(self, p: int, seeds: torch.Tensor, b: int,
                          bits) -> dict:
    """Card ``p``'s multi-hop expansion and row collection."""
    g = self.ds.graph
    node_cap = self.node_capacity(b)
    dev = self.device
    my_start = int(g.bounds[p])
    indptr, indices = g.indptr[p], g.indices[p]
    hws = []
    fr_stats = torch.zeros(3, dtype=torch.int64, device=dev)

    def one_hop(h, frontier, k):
      cap = capacity_spec(frontier.shape[0], self.num_parts,
                          self.exchange_slack)
      nbrs, mask, hw, hstats = _dist_one_hop(
          self.mesh, indptr, indices, self._bounds_t, my_start, frontier,
          k, self.draws, self._step_cnt, h, self.num_parts, cap,
          gns_bits=bits, gns_boost=self.gns_boost)
      fr_stats.add_(hstats)
      hws.append(hw)
      return nbrs, mask

    state, seed_local, rows_acc, cols_acc, nsn = expand_hops(
        seeds, self.fanouts, node_cap, one_hop)
    # induce_next flattens [F, k] row-major: the weights line up with
    # the edge list; masked and dropped edges carry 0
    ew_acc = [torch.where(rows >= 0, hw.reshape(-1), 0.0)
              for rows, hw in zip(rows_acc, hws) if hw is not None]
    x = y = None
    ft_stats = torch.zeros(3, dtype=torch.int64, device=dev)
    tables = []
    if self.collect_features:
      tables.append(self.ds.node_features.shards[p])
    if self.collect_labels:
      tables.append(self.ds.node_labels[p])
    if tables:
      hot = (int(self.ds.node_features.hot_counts[p])
             if self.collect_features and self.tiered else None)
      got, ft_stats = dist_gather_multi(
          self.mesh, tables, self._bounds_t, my_start, state.nodes,
          self.num_parts,
          capacity=capacity_spec(node_cap, self.num_parts,
                                 self.exchange_slack),
          hot_count=hot)
      got = list(got)
      if self.collect_features:
        x = got.pop(0)
      if self.collect_labels:
        y = got.pop(0)
    stats = torch.cat([fr_stats, ft_stats])
    return dict(node=state.nodes, node_count=state.count,
                row=torch.cat(rows_acc), col=torch.cat(cols_acc),
                seed_local=seed_local, x=x, y=y, num_sampled_nodes=nsn,
                edge_weight=torch.cat(ew_acc) if ew_acc else None,
                stats=stats)

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
    nodes_l = nodes.cpu().numpy().astype(np.int64)
    valid = nodes_l >= 0
    _rng, _local, cold = hot_split_host(g.bounds, nf.hot_counts, nodes_l,
                                        valid)
    lookups, cold_n = int(valid.sum()), int(cold.sum())
    miss = cold
    if cache is not None:
      hit, slot = cache.lookup(nodes_l, cold)
      hits = int(hit.sum())
      x = cache.serve(x, hit, slot)
      miss = cold & ~hit
    served = overlay_cold_host(x, nodes_l, nf.cold_host, miss,
                               staging=self._staging)
    if cache is not None and miss.any():
      admits, evicts = cache.commit_admissions(
          x, cache.plan_admissions(nodes_l, miss))
    self._feat_lookups += lookups
    self._cold_lookups += cold_n
    self._cold_misses += served
    self._cache_hits += hits
    self._cache_admits += admits
    self._cache_evicts += evicts
    return x

  def exchange_stats(self) -> dict:
    """Cumulative exchange and cold-tier counters (one device sync):
    ``dist.frontier.*``, ``dist.feature.*`` and the hit rates."""
    totals = self._stats_acc.cpu().numpy()
    out = {f'dist.{n}': int(v) for n, v in zip(EXCHANGE_STAT_NAMES, totals)}
    lookups, cold = self._feat_lookups, self._cold_lookups
    out['dist.feature.lookups'] = lookups
    out['dist.feature.cold_lookups'] = cold
    out['dist.feature.cold_misses'] = self._cold_misses
    out['dist.feature.cache_hits'] = self._cache_hits
    out['dist.feature.cache_admits'] = self._cache_admits
    out['dist.feature.cache_evicts'] = self._cache_evicts
    out['dist.feature.hot_hit_rate'] = (1.0 - cold / lookups
                                        if lookups else 1.0)
    out['dist.feature.cache_hit_rate'] = (
        1.0 - self._cold_misses / cold if cold else 0.0)
    return out


class DistNeighborLoader:
  """Mesh loader: splits the (relabelled) seeds across the mesh and
  yields stacked `Batch`es (leading axis = card) for
  `make_dp_supervised_step`.

  ``input_space='old'`` maps the seeds through ``dataset.old2new``.
  For a tiered store batch ``k+1`` is dispatched before batch ``k``'s
  cold overlay runs (``GLT_COLD_PREFETCH=0``: one batch at a time).
  Each ``iter()`` starts a new epoch.
  """

  def __init__(self, dataset: DistDataset, num_neighbors, input_nodes,
               batch_size: int = 1, shuffle: bool = False,
               drop_last: bool = False, mesh: Optional[Mesh] = None,
               collect_features: bool = True, seed: int = 0,
               input_space: str = 'old', exchange_slack='auto',
               cold_cache_rows='auto', gns=None,
               draws: Optional[Draws] = None, device='cuda'):
    self.sampler = DistNeighborSampler(
        dataset, num_neighbors, mesh=mesh,
        collect_features=collect_features, seed=seed,
        exchange_slack=resolve_exchange_slack(exchange_slack, shuffle),
        cold_cache_rows=cold_cache_rows, gns=gns, draws=draws,
        device=device)
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
    self._pending = self._pending_src = None

  def __len__(self) -> int:
    return len(self._batcher)

  def __iter__(self):
    seed_iter = iter(self._batcher)
    while True:
      try:
        yield self._produce(seed_iter)
      except StopIteration:
        return

  def _dispatch_flat(self, flat: np.ndarray) -> dict:
    return self.sampler._dispatch_nodes(
        flat.reshape(self.num_parts, self.batch_size))

  def _pipeline_acquire(self, seed_iter):
    """Batch k's in-flight handle (dispatched during batch k-1), or at
    epoch start its raw seeds; StopIteration at epoch end."""
    if self._pending_src is not seed_iter:
      self._pending, self._pending_src = None, seed_iter
    cur, self._pending = self._pending, None
    if cur is None:
      return None, next(seed_iter)
    return cur, None

  def _produce(self, seed_iter) -> Batch:
    if self._cold_pipeline:
      cur, flat = self._pipeline_acquire(seed_iter)
      if cur is None:
        cur = self._dispatch_flat(flat)
      try:
        self._pending = self._dispatch_flat(next(seed_iter))
      except StopIteration:
        pass
      out = self.sampler._finish_nodes(cur)
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
