"""Sharded graph, tiered feature store and mod-sharded edge features (the
JAX package's `parallel/dist_data.py:33-87,155-165,351-398,455-527,
598-661,755-851`).

Nodes are relabelled to contiguous ownership ranges (``bounds [P+1]``),
hottest first within each range; each partition holds the CSR of its own
nodes' out-edges (columns stay global ids) and its feature shard.  A
``split_ratio < 1`` store is tiered: each shard holds only its first
``ceil(split_ratio * rows)`` rows on the card (the hot tier), and the
whole relabelled table stays in host memory (the cold tier, pinned when
the store lives on a card).

The relabel is host numpy, as in JAX; the per-edge work (remap, CSR
sort) runs in torch on the store's device.  The CSR sort is a stable
sort on ``row * N + col``, which orders edges exactly as the JAX
package's ``np.lexsort((cols, rows))``.  Edge features are indexed by
GLOBAL edge id (the input edge order, which the relabel keeps) and
mod-sharded: shard ``p`` row ``r`` holds edge ``r * P + p``
(`build_dist_edge_feature`).  The placement is the seeded round-robin
(``'range'``), the locality greedy (`locality.locality_partition`), an
explicit ``node_pb`` or a callable; ``replica_frac > 0`` adds the
read-only replica cache of the hottest remote rows
(`build_replica_cache`).  No partition directory.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .partition_book import PartitionBook, range_of


class DistGraph:
  """Stacked per-partition local CSRs and the ownership bounds.

  Attributes:
    indptr: ``[P, max_local_nodes + 1]`` int64 (on the store's device).
    indices: ``[P, max_local_edges]`` int32 GLOBAL neighbor ids, -1 pad.
    edge_ids: ``[P, max_local_edges]`` int64 global edge ids, -1 pad.
    bounds: ``[P + 1]`` int64 numpy ownership ranges.
  """

  def __init__(self, indptr, indices, edge_ids, bounds):
    self.indptr = indptr
    self.indices = indices
    self.edge_ids = edge_ids
    self.bounds = np.asarray(bounds, dtype=np.int64)

  @property
  def num_partitions(self) -> int:
    return len(self.bounds) - 1

  @property
  def num_nodes(self) -> int:
    return int(self.bounds[-1])


def relabel_by_partition(node_pb: np.ndarray, num_parts: int,
                         hotness: Optional[np.ndarray] = None):
  """Sort nodes by (partition[, -hotness], old id); returns ``(old2new,
  counts, bounds)``."""
  node_pb = np.asarray(node_pb)
  num_nodes = len(node_pb)
  if hotness is not None:
    hot = np.asarray(hotness)
    if hot.dtype.kind == 'u':
      hot = hot.astype(np.int64)
    order = np.lexsort((np.arange(num_nodes), -hot, node_pb))
  else:
    order = np.argsort(node_pb, kind='stable')
  old2new = np.empty(num_nodes, dtype=np.int64)
  old2new[order] = np.arange(num_nodes)
  counts = np.bincount(node_pb, minlength=num_parts)
  bounds = np.concatenate([[0], np.cumsum(counts)])
  return old2new, counts, bounds


def hot_count(counts, split_ratio: float) -> np.ndarray:
  """Hot rows per partition at ``split_ratio``: ``ceil(counts *
  split_ratio)``."""
  return np.ceil(np.asarray(counts) * float(split_ratio)).astype(np.int64)


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
  t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
  return t.to(device=device, dtype=dtype)


def build_dist_graph(rows, cols, node_pb: np.ndarray, num_nodes: int,
                     num_parts: Optional[int] = None,
                     hotness: Optional[np.ndarray] = None,
                     device='cuda'):
  """Relabel and shard a COO graph by a node partition book.  Returns
  ``(DistGraph, old2new)``; ``rows``/``cols`` may be numpy arrays or
  torch tensors on any device."""
  device = resolve_device(device)
  node_pb = np.asarray(node_pb)
  if num_parts is None:
    num_parts = int(node_pb.max()) + 1 if node_pb.size else 1
  old2new, _, bounds = relabel_by_partition(node_pb, num_parts, hotness)
  o2n = torch.from_numpy(old2new).to(device)
  graph = stack_partition_csr(o2n[_as_tensor(rows, device, torch.int64)],
                              o2n[_as_tensor(cols, device, torch.int64)],
                              bounds, int(num_nodes), device)
  return graph, old2new


def stack_partition_csr(rows_new: torch.Tensor, cols_new: torch.Tensor,
                        bounds: np.ndarray, num_cols: int, device,
                        edge_ids=None) -> DistGraph:
  """Stacked per-partition CSRs of relabelled COO edges: each edge lives
  on its ROW's owner (the range of ``bounds`` holding it) at the local
  row ``row - bounds[owner]``; columns stay global ids (below
  ``num_cols``).  Edge ids are ``edge_ids`` (``[E]``, the caller's
  global ids) or the input order.  Each CSR is a stable sort on ``row *
  num_cols + col``, the order of the JAX package's ``np.lexsort((cols,
  rows))``."""
  num_parts = len(bounds) - 1
  counts = np.diff(bounds)
  bounds_t = torch.from_numpy(np.asarray(bounds, np.int64)).to(device)
  owner = range_of(bounds_t, rows_new).long().clamp(0, max(num_parts - 1, 0))
  edge_ids = (torch.arange(rows_new.shape[0], dtype=torch.int64,
                           device=device) if edge_ids is None
              else _as_tensor(edge_ids, device, torch.int64))
  max_nodes = int(counts.max()) if num_parts else 0
  max_edges = max(int(torch.bincount(owner, minlength=num_parts).max())
                  if owner.numel() else 0, 1)
  indptr_s = torch.zeros((num_parts, max_nodes + 1), dtype=torch.int64,
                         device=device)
  indices_s = torch.full((num_parts, max_edges), -1, dtype=torch.int32,
                         device=device)
  eids_s = torch.full((num_parts, max_edges), -1, dtype=torch.int64,
                      device=device)
  n = max(int(num_cols), 1)
  for p in range(num_parts):
    sel = owner == p
    local = rows_new[sel] - int(bounds[p])
    c = cols_new[sel]
    perm = torch.sort(local * n + c, stable=True).indices
    e = perm.shape[0]
    deg = torch.bincount(local, minlength=int(counts[p]))
    indptr_s[p, 1:len(deg) + 1] = torch.cumsum(deg, 0)
    indptr_s[p, len(deg) + 1:] = e
    indices_s[p, :e] = c[perm].to(torch.int32)
    eids_s[p, :e] = edge_ids[sel][perm]
  return DistGraph(indptr_s, indices_s, eids_s, bounds)


class DistFeature:
  """Stacked per-partition feature shards with an optional host tier.

  Attributes:
    shards: ``[P, hot_max, D]`` rows on the card (row ``r`` of shard
      ``p`` is global id ``bounds[p] + r``).
    bounds: ``[P + 1]`` numpy.
    hot_counts: ``[P]`` int32: id ``g`` is served from the card iff
      ``g - bounds[owner] < hot_counts[owner]``.
    cold_host: ``[N, D]`` host table by relabelled id (pinned when the
      shards are on a card), or None for a store wholly on the card.
    mod_sharded: True for strided ownership (owner ``id % P``, row ``id
      // P``: `build_dist_edge_feature`), False for the ranges of
      ``bounds``.
    cache_ids: ``[P, C]`` int32 sorted relabelled ids of the remote rows
      partition ``p`` holds a copy of (`CACHE_PAD_ID` padded), on the
      shards' device, or None.
    cache_rows: ``[P, C, D]`` those rows.
    cache_local: the cache is the replica set: its rows count as local
      (masked out of the feature exchange and overlaid).
  """

  def __init__(self, shards, bounds, hot_counts=None, cold_host=None,
               mod_sharded: bool = False, cache_ids=None, cache_rows=None,
               cache_local: bool = False):
    self.shards = shards
    self.bounds = np.asarray(bounds, dtype=np.int64)
    self.hot_counts = (np.asarray(hot_counts, np.int32)
                       if hot_counts is not None
                       else np.diff(self.bounds).astype(np.int32))
    self.cold_host = cold_host
    self.mod_sharded = bool(mod_sharded)
    self.cache_ids = cache_ids
    self.cache_rows = cache_rows
    self.cache_local = bool(cache_local)

  @property
  def feature_dim(self) -> int:
    return self.shards.shape[-1]

  @property
  def has_cache(self) -> bool:
    return self.cache_ids is not None and self.cache_ids.shape[1] > 0

  @property
  def is_tiered(self) -> bool:
    return self.cold_host is not None


def build_dist_feature(feats, old2new: np.ndarray, bounds: np.ndarray,
                       split_ratio: float = 1.0,
                       device='cuda') -> DistFeature:
  """Shard a ``[N, D]`` (or ``[N]``) table by the relabelled ranges;
  ``split_ratio < 1`` builds the tiered store.  The rows are picked on
  the table's own device (a table already on the card never crosses
  the host link, except into a tiered store's host tier)."""
  device = resolve_device(device)
  feats = feats if isinstance(feats, torch.Tensor) else torch.from_numpy(
      np.asarray(feats))
  if feats.ndim == 1:
    feats = feats[:, None]
  num_parts = len(bounds) - 1
  counts = np.diff(bounds)
  split_ratio = float(split_ratio)
  if not 0.0 <= split_ratio <= 1.0:
    raise ValueError(f'split_ratio must be in [0, 1], got {split_ratio}')
  tiered = split_ratio < 1.0
  hot_counts = (hot_count(counts, split_ratio) if tiered
                else counts.astype(np.int64))
  hot_max = int(hot_counts.max()) if num_parts else 0
  if tiered:
    hot_max = max(hot_max, 1)
  # the relabelled table's row i is feats[new2old[i]]
  new2old = torch.from_numpy(np.argsort(old2new)).to(feats.device)
  shards = torch.zeros((num_parts, hot_max, feats.shape[1]),
                       dtype=feats.dtype, device=device)
  for p in range(num_parts):
    lo, h = int(bounds[p]), int(hot_counts[p])
    shards[p, :h] = feats.index_select(0, new2old[lo:lo + h]).to(device)
  cold = None
  if tiered:
    cold = torch.empty(feats.shape, dtype=feats.dtype,
                       pin_memory=device.type == 'cuda')
    cold.copy_(feats.index_select(0, new2old))
  return DistFeature(shards, bounds, hot_counts=hot_counts, cold_host=cold)


#: the replica cache's padding id (sorts after every real id)
CACHE_PAD_ID = np.iinfo(np.int32).max


def build_replica_cache(feats, old2new: np.ndarray, bounds: np.ndarray,
                        hotness_new: np.ndarray, frac: float,
                        device='cuda'):
  """The read-only replica cache (the JAX package's
  `build_replica_cache`): each partition holds the ``ceil(frac * N)``
  hottest rows it does NOT own, ranked by ``hotness_new`` (relabelled
  id space, ties by id).  ``feats`` is the ``[N, D]`` (or ``[N]``) table
  in the original id space (numpy or a tensor on any device).  Returns
  ``(cache_ids [P, C] int32 sorted, CACHE_PAD_ID padded, cache_rows [P,
  C, D])`` on ``device``, or ``(None, None)`` at a zero budget; sets the
  ``partition.replicated_rows`` gauge."""
  device = resolve_device(device)
  bounds = np.asarray(bounds, np.int64)
  num_parts = len(bounds) - 1
  n = int(bounds[-1])
  c = int(np.ceil(float(frac) * n))
  if c <= 0 or n == 0:
    return None, None
  feats = feats if isinstance(feats, torch.Tensor) else torch.from_numpy(
      np.asarray(feats))
  if feats.ndim == 1:
    feats = feats[:, None]
  order = np.argsort(-np.asarray(hotness_new, np.float64), kind='stable')
  new2old = torch.from_numpy(np.argsort(old2new)).to(feats.device)
  ids = np.full((num_parts, c), CACHE_PAD_ID, np.int32)
  rows = torch.zeros((num_parts, c, feats.shape[1]), dtype=feats.dtype,
                     device=device)
  for p in range(num_parts):
    remote = np.sort(order[(order < bounds[p]) | (order >= bounds[p + 1])][:c])
    ids[p, :len(remote)] = remote
    rows[p, :len(remote)] = feats.index_select(
        0, new2old[torch.from_numpy(remote).to(feats.device)]).to(device)
  from ..telemetry.live import live
  live.gauge('partition.replicated_rows', fn=lambda: float(c))
  return torch.from_numpy(ids).to(device), rows


def replica_budget_frac(replica_frac=None) -> float:
  """The replication budget: the argument, else
  ``GLT_LOCALITY_REPLICA_FRAC`` (the fraction of all nodes each partition
  copies; 0, the default, builds no cache)."""
  if replica_frac is not None:
    return float(replica_frac)
  try:
    return float(os.environ.get('GLT_LOCALITY_REPLICA_FRAC', 0.0))
  except ValueError:
    return 0.0


def build_dist_edge_feature(efeats, num_parts: int,
                            device='cuda') -> DistFeature:
  """Mod-shard an ``[E, De]`` (or ``[E]``) edge-feature table indexed by
  GLOBAL edge id: shard ``p`` row ``r`` holds edge ``r * P + p``.

  A node's out-edges have consecutive ids in the usual COO order, so
  range shards would send one seed's whole edge set to one owner and
  overflow a capacity-bound gather; strided ownership spreads every run
  of ids evenly over the owners.  ``efeats`` may be a numpy array or a
  tensor on any device.
  """
  device = resolve_device(device)
  efeats = efeats if isinstance(efeats, torch.Tensor) else torch.from_numpy(
      np.asarray(efeats))
  if efeats.ndim == 1:
    efeats = efeats[:, None]
  e = efeats.shape[0]
  rows_max = max(-(-e // num_parts), 1)
  shards = torch.zeros((num_parts, rows_max, efeats.shape[1]),
                       dtype=efeats.dtype, device=device)
  for p in range(num_parts):
    own = efeats[p::num_parts]
    shards[p, :own.shape[0]] = own.to(device)
  return DistFeature(shards, np.arange(num_parts + 1, dtype=np.int64),
                     mod_sharded=True)


class DistDataset:
  """The sharded dataset: `DistGraph`, the node feature store, node
  labels ``[P, max_nodes]`` (on the device), the mod-sharded edge
  features (`build_dist_edge_feature`, or None) and the relabel
  (``old2new`` / ``new2old``, numpy).

  Failover state, shared by every sampler over the dataset: the
  `partition_book` (made on first use), ``adopted_shards`` (the durable
  payloads `failover.adopt_shard` and `handoff.handoff` parked, by range,
  host numpy; `adopted_lane` puts one on the card) and
  ``degraded_partitions`` (ranges written off under
  ``GLT_DEGRADED_OK``)."""

  def __init__(self, graph: DistGraph, node_features=None,
               node_labels=None, old2new=None, device='cuda',
               edge_features: Optional[DistFeature] = None):
    self.graph = graph
    self.node_features = node_features
    self.node_labels = node_labels
    self.device = resolve_device(device)
    if edge_features is not None and not (
        edge_features.mod_sharded
        and edge_features.shards.shape[0] == graph.num_partitions
        and edge_features.shards.device == self.device):
      raise ValueError(f'edge_features must be a mod-sharded table of '
                       f'{graph.num_partitions} shards on {self.device}')
    self.edge_features = edge_features
    self.old2new = old2new
    self.new2old = np.argsort(old2new) if old2new is not None else None
    #: what placed the nodes (`from_full_graph`; None: built directly)
    self.partitioner = None
    self._partition_book = None
    self.adopted_shards = {}
    self._adopted_device = {}   # range -> (payload, its tensors on the card)
    self.degraded_partitions = set()

  @property
  def num_partitions(self) -> int:
    return self.graph.num_partitions

  @property
  def partition_book(self) -> PartitionBook:
    """The routing authority: one `PartitionBook` a dataset, shared by
    every sampler, loader and epoch over it, so a move one reader sees
    every reader sees at its next fence."""
    if self._partition_book is None:
      self._partition_book = PartitionBook(self.graph.bounds)
    return self._partition_book

  def adopted_lane(self, r: int) -> dict:
    """Range ``r``'s parked payload (``adopted_shards[r]``) as tensors on
    the dataset's device, uploaded once a payload and shared by every
    sampler over the dataset; edge ids as int32 (the kernels' edge-id
    arm).  A payload that left ``adopted_shards`` leaves the card too."""
    for k in [k for k, (pl, _) in self._adopted_device.items()
              if self.adopted_shards.get(k) is not pl]:
      del self._adopted_device[k]
    payload = self.adopted_shards[r]
    hit = self._adopted_device.get(r)
    if hit is not None:
      return hit[1]
    out = {}
    for key, a in payload.items():
      if key in ('hot_count', 'cold'):
        continue
      t = torch.from_numpy(np.ascontiguousarray(a))
      if key == 'eids':
        top = int(t.max()) if t.numel() else -1
        if top >= (1 << 31) - 1:
          raise ValueError(f'{top + 1} edges: the global edge ids do not '
                           'fit the int32 ids the samplers write')
        t = t.to(torch.int32)
      out[key] = t.to(self.device)
    self._adopted_device[r] = (payload, out)
    return out

  def drop_adopted(self, r: int) -> None:
    """Unpark range ``r``'s payload, on the host and on the card."""
    self.adopted_shards.pop(r, None)
    self._adopted_device.pop(r, None)

  @classmethod
  def from_full_graph(cls, num_parts: int, rows, cols, node_feat=None,
                      node_label=None, num_nodes: Optional[int] = None,
                      node_pb: Optional[np.ndarray] = None, seed: int = 0,
                      split_ratio: float = 1.0,
                      hotness: Optional[np.ndarray] = None,
                      edge_feat=None, device='cuda', partitioner=None,
                      replica_frac: Optional[float] = None
                      ) -> 'DistDataset':
    """In-memory partition and shard onto ``device``.

    Without ``node_pb`` the ``partitioner`` (`locality.
    resolve_partitioner`: the argument, else ``GLT_PARTITIONER``) places
    the nodes: ``'range'`` (default) is the JAX package's seeded
    round-robin over a random permutation; ``'locality'`` the streaming
    greedy `locality.locality_partition` (weighted by ``hotness``, an
    array or a `DecayedSketch`, default in-degree; on a CUDA device its
    compiled host copy runs); an array is a ``node_pb``; a callable is
    called as ``partitioner(rows, cols, num_nodes, num_parts)``.
    ``ds.partitioner`` names what placed them (``'explicit'`` for a
    ``node_pb``).  ``split_ratio < 1`` tiers the feature store;
    ``hotness`` defaults to in-degree then, so the card keeps the most
    gathered rows.  ``replica_frac > 0`` (else
    ``GLT_LOCALITY_REPLICA_FRAC``) builds the replica cache
    (`build_replica_cache`, ranked by ``hotness``, else in-degree).
    ``edge_feat`` is the ``[E, De]`` table by input edge order,
    mod-sharded by `build_dist_edge_feature`, or such a `DistFeature`
    already built (two stores of one graph share it).
    """
    from .locality import locality_partition, resolve_partitioner
    device = resolve_device(device)
    cols_t = cols if isinstance(cols, torch.Tensor) else torch.from_numpy(
        np.asarray(cols))
    rows_t = rows if isinstance(rows, torch.Tensor) else torch.from_numpy(
        np.asarray(rows))
    if num_nodes is None:
      num_nodes = int(max(int(rows_t.max()) if rows_t.numel() else -1,
                          int(cols_t.max()) if cols_t.numel() else -1)) + 1
    n = int(num_nodes)
    if hotness is not None and hasattr(hotness, 'score'):
      hotness = hotness.score(np.arange(n))
    in_degree = lambda: torch.bincount(  # noqa: E731
        cols_t.long(), minlength=n).cpu().numpy()
    identity = 'explicit'
    if node_pb is None:
      part = resolve_partitioner(partitioner)
      if isinstance(part, str) and part == 'range':
        identity = 'range'
        rng = np.random.default_rng(seed)
        node_pb = np.empty(n, dtype=np.int32)
        perm = rng.permutation(n)
        for p in range(num_parts):
          node_pb[perm[p::num_parts]] = p
      elif isinstance(part, str):
        identity = 'locality'
        if hotness is None:
          hotness = in_degree()
        greedy = None
        if device.type == 'cuda':
          from .locality import compiled_greedy as greedy
        node_pb, _ = locality_partition(
            rows_t.cpu().numpy(), cols_t.cpu().numpy(), n, num_parts,
            seed=seed, hotness=hotness, greedy=greedy)
      elif callable(part):
        identity = 'custom'
        node_pb = np.asarray(part(rows_t.cpu().numpy(), cols_t.cpu().numpy(),
                                  n, num_parts))
      else:
        identity = 'custom'
        node_pb = part
    if split_ratio < 1.0 and hotness is None:
      hotness = in_degree()
    g, old2new = build_dist_graph(rows_t, cols_t, node_pb, n,
                                  num_parts=num_parts, hotness=hotness,
                                  device=device)
    nf = (build_dist_feature(node_feat, old2new, g.bounds,
                             split_ratio=split_ratio, device=device)
          if node_feat is not None else None)
    rep = replica_budget_frac(replica_frac)
    if nf is not None and rep > 0:
      rank = np.asarray(hotness) if hotness is not None else in_degree()
      rank_new = np.empty(n, np.float64)
      rank_new[old2new] = rank
      cids, crows = build_replica_cache(node_feat, old2new, g.bounds,
                                        rank_new, rep, device=device)
      if cids is not None:
        nf.cache_ids, nf.cache_rows, nf.cache_local = cids, crows, True
    nl = None
    if node_label is not None:
      nl = build_dist_feature(node_label, old2new, g.bounds,
                              device=device).shards[..., 0]
    ef = edge_feat
    if ef is not None and not isinstance(ef, DistFeature):
      ef = build_dist_edge_feature(ef, num_parts, device=device)
    ds = cls(g, nf, nl, old2new, device=device, edge_features=ef)
    ds.partitioner = identity
    return ds
