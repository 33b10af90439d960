"""The heterogeneous mesh engine: per-type sharded stores, the mesh's
heterogeneous multi-hop sampler, its node and link loaders (the JAX
package's `parallel/dist_hetero.py:51-202,364-1098`).

Layout (`DistHeteroDataset`): every node type is relabelled to
contiguous ownership ranges of its own (``bounds[nt]``, hottest first
within a range for a tiered store) and its feature and label tables are
sharded by them; every edge type ``(s, rel, d)`` keeps its edges on the
owner of the SOURCE node, as stacked per-partition CSRs whose rows are
local ``s`` ids and whose columns stay GLOBAL relabelled ``d`` ids, so
a sampled neighbor enters ``d``'s node table with no translation.

Engine (`DistHeteroNeighborSampler`): the single-card heterogeneous
multi-hop loop (`sampler.hetero_neighbor_sampler`) with every one-hop
replaced by the mesh's exchange (`dist_sampler._dist_one_hop`: bucket
each partition's frontier by owner, all-to-all, every owner samples its
receive buffer with the uniform sampler kernel, reply), for all ``P``
partitions in lockstep on one card.  Per hop each node type's frontier
is the window of its table the previous hop appended; a type whose
planned frontier is empty at a hop takes no part in it.  Then each
node type's features, and then each labelled type's labels, come in
exchanges of their own (`dist_gather_multi`, the row gather kernel at
every owner), as in JAX.  A tiered type's rows past its owners' hot
counts come back zero and are filled from the host tier after the
batch (`overlay_cold_host`); every such row counts as a cold lookup
and a miss (the heterogeneous engine has no victim cache, as in JAX).
With ``with_edge`` each owner also returns its slots' global edge ids
(the edge type's ``edge_ids``, the sampler kernel's edge-id arm), and
each sampled edge type with a mod-sharded feature table gathers its
rows in one more exchange.

Link batches (`sample_from_edges`) first draw each partition's strict
negatives over the seed edge type's sharded CSR (`dist_sample_negative`,
rows in the source type, columns in the destination type), then expand
the endpoints as seeds of their types (one list, sources first, when
both endpoints have the same type).

Random numbers come from a ``draws(step, hop, rows, k, w, gns, owner=o,
etype=ei)`` provider (`dist_sampler`'s, with ``ei`` the edge type's
index among the sampler's sorted edge types); the default is
`ops.draws.TorchDraws`; the negatives come from ``draws.negatives(step,
stream, trials, r, high, part=p)``, as on the homogeneous mesh.  The
parity tests replay JAX's keys, ``fold_in(fold_in(fold_in(fold_in(
key(seed), step), hop), ei), o)``.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..loader.node_loader import SeedBatcher
from ..loader.prefetch import PrefetchingLoader
from ..loader.transform import HeteroBatch
from ..ops.draws import TorchDraws
from ..ops.unique import _frontier, induce_next, init_node
from ..sampler.base import NegativeSampling
from ..sampler.hetero_neighbor_sampler import (_plan_capacities,
                                               normalize_fanouts)
from ..typing import EdgeType, NodeType, reverse_edge_type
from ..utils.device import resolve_device
from ..utils.padding import INVALID_ID
from ..utils.tensor import PinnedStaging
from ..data.cold_cache import emit_cache_events
from .dist_data import (DistFeature, build_dist_edge_feature,
                        build_dist_feature, relabel_by_partition,
                        stack_partition_csr)
from .dist_sampler import (DEFAULT_EXCHANGE_SLACK, NEG_TRIALS,
                           OVERLAY_PARTS, AdaptiveSlack, Draws,
                           ExchangeTelemetry, _dist_one_hop,
                           binary_num_negatives, dist_gather_multi,
                           dist_sample_negative, int64_on,
                           overlay_cold_host, pack_link_seeds, packed_rows,
                           resolve_exchange_slack)
from .dp import Mesh, make_mesh
from .partition_book import hot_split_host


def _not_ported(what: str, item: str):
  return NotImplementedError(f'{what} is not ported to the heterogeneous '
                             f'mesh engine yet (ROADMAP {item})')


def _as_long(a, device) -> torch.Tensor:
  t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
  return t.to(device=device, dtype=torch.int64)


class DistHeteroDataset:
  """The per-type sharded heterogeneous store.

  Attributes:
    graphs: ``{EdgeType: DistGraph}`` (its bounds are the SOURCE type's).
    bounds: ``{NodeType: [P + 1]}`` numpy ownership ranges.
    node_features: ``{NodeType: DistFeature}``.
    node_labels: ``{NodeType: [P, rows_max]}`` tensors.
    edge_features: ``{EdgeType: DistFeature}`` mod-sharded over the edge
      type's GLOBAL edge ids (owner ``eid % P``,
      `build_dist_edge_feature`).
    old2new / new2old: ``{NodeType: [N_nt]}`` numpy id maps.
    device: where the shards live.
  """

  def __init__(self, graphs, bounds, node_features=None, node_labels=None,
               old2new=None, device='cuda', host_parts=None,
               edge_features=None):
    if host_parts is not None:
      raise _not_ported('host_parts (a process holding some partitions)',
                        'slice catalogue item 11')
    self.graphs = dict(graphs)
    self.bounds = {nt: np.asarray(b, np.int64) for nt, b in bounds.items()}
    self.node_features: Dict[NodeType, DistFeature] = dict(
        node_features or {})
    self.node_labels = dict(node_labels or {})
    self.edge_features: Dict[EdgeType, DistFeature] = {
        tuple(et): f for et, f in (edge_features or {}).items()}
    self.old2new = dict(old2new or {})
    self.new2old = {nt: np.argsort(m) for nt, m in self.old2new.items()}
    self.device = resolve_device(device)

  @property
  def num_partitions(self) -> int:
    return len(next(iter(self.bounds.values()))) - 1

  @property
  def etypes(self) -> Tuple[EdgeType, ...]:
    return tuple(sorted(self.graphs.keys()))

  @property
  def ntypes(self) -> Tuple[NodeType, ...]:
    return tuple(sorted(self.bounds.keys()))

  def num_nodes_dict(self) -> Dict[NodeType, int]:
    return {nt: int(b[-1]) for nt, b in self.bounds.items()}

  @classmethod
  def from_full_graph(cls, num_parts: int, edge_index_dict,
                      node_feat_dict=None, node_label_dict=None,
                      num_nodes_dict=None, node_pb_dict=None,
                      seed: int = 0, edge_feat_dict=None,
                      edge_ids_dict=None, split_ratio: float = 1.0,
                      partitioner=None,
                      device='cuda') -> 'DistHeteroDataset':
    """In-memory partition and shard onto ``device``.

    Each node type without a ``node_pb_dict`` entry is placed by the
    seeded round-robin over a random permutation, the types drawn in
    sorted order from ONE ``default_rng(seed)`` (as JAX draws them).
    ``split_ratio < 1`` tiers every node type's feature store; a type's
    hotness is its in-degree summed over every edge type landing on it.
    ``edge_ids_dict`` keeps each edge type's caller-global edge ids (its
    ``edge_feat_dict`` rows are indexed by them; default: the input
    order), and each ``edge_feat_dict`` table is mod-sharded
    (`build_dist_edge_feature`).  Edge endpoints, features and labels may
    be numpy arrays or tensors on any device; a table already on the
    card is sharded there.

    ``partitioner`` (else ``GLT_PARTITIONER``): ``'locality'`` runs
    `locality.locality_partition` once over the disjoint union of every
    node type (each type's ids offset by the types before it in sorted
    order) and splits the assignment back per type, so the balance cap
    holds on the union; ``'range'`` (default) is the round-robin above.
    A ``node_pb_dict`` entry wins for its type."""
    from .locality import locality_partition, resolve_partitioner
    device = resolve_device(device)
    node_feat_dict = node_feat_dict or {}
    node_label_dict = node_label_dict or {}
    num_nodes_dict = dict(num_nodes_dict or {})
    edges = {tuple(et): (_as_long(r, device), _as_long(c, device))
             for et, (r, c) in edge_index_dict.items()}
    ntypes = sorted({t for (s, _, d) in edges for t in (s, d)}
                    | set(node_feat_dict) | set(num_nodes_dict))
    for (s, _, d), (rows, cols) in edges.items():
      num_nodes_dict[s] = max(num_nodes_dict.get(s, 0),
                              int(rows.max()) + 1 if rows.numel() else 0)
      num_nodes_dict[d] = max(num_nodes_dict.get(d, 0),
                              int(cols.max()) + 1 if cols.numel() else 0)
    for nt, f in node_feat_dict.items():
      num_nodes_dict[nt] = max(num_nodes_dict.get(nt, 0), len(f))

    hotness = {}
    if split_ratio < 1.0:
      hotness = {nt: torch.zeros(num_nodes_dict[nt], dtype=torch.int64,
                                 device=device) for nt in ntypes}
      for (s, _, d), (rows, cols) in edges.items():
        hotness[d] += torch.bincount(cols, minlength=num_nodes_dict[d])
      hotness = {nt: h.cpu().numpy() for nt, h in hotness.items()}

    rng = np.random.default_rng(seed)
    node_pb_dict = dict(node_pb_dict or {})
    missing = [nt for nt in ntypes if nt not in node_pb_dict]
    kind = resolve_partitioner(partitioner)
    if missing and isinstance(kind, str) and kind == 'locality':
      off, tot = {}, 0
      for nt in ntypes:
        off[nt] = tot
        tot += num_nodes_dict[nt]
      g_rows = [off[s] + r.cpu().numpy() for (s, _, d), (r, c)
                in edges.items()]
      g_cols = [off[d] + c.cpu().numpy() for (s, _, d), (r, c)
                in edges.items()]
      joint, _ = locality_partition(
          np.concatenate(g_rows) if g_rows else np.empty(0, np.int64),
          np.concatenate(g_cols) if g_cols else np.empty(0, np.int64),
          tot, num_parts, seed=seed)
      for nt in missing:
        node_pb_dict[nt] = joint[off[nt]:off[nt] + num_nodes_dict[nt]].copy()
    old2new, bounds = {}, {}
    for nt in ntypes:
      n = num_nodes_dict[nt]
      pb = node_pb_dict.get(nt)
      if pb is None:
        pb = np.empty(n, dtype=np.int32)
        perm = rng.permutation(n)
        for p in range(num_parts):
          pb[perm[p::num_parts]] = p
      old2new[nt], _, bounds[nt] = relabel_by_partition(
          np.asarray(pb), num_parts, hotness.get(nt))

    o2n = {nt: torch.from_numpy(m).to(device) for nt, m in old2new.items()}
    graphs = {}
    for et, (rows, cols) in edges.items():
      s, _, d = et
      # rows in the source type's ranges, columns global destination ids
      graphs[et] = stack_partition_csr(
          o2n[s][rows], o2n[d][cols], bounds[s], num_nodes_dict[d], device,
          edge_ids=(edge_ids_dict or {}).get(et))
    del edges, o2n
    feats = {nt: build_dist_feature(f, old2new[nt], bounds[nt],
                                    split_ratio=split_ratio, device=device)
             for nt, f in node_feat_dict.items()}
    labels = {nt: build_dist_feature(lab, old2new[nt], bounds[nt],
                                     device=device).shards[..., 0]
              for nt, lab in node_label_dict.items()}
    efeats = {tuple(et): build_dist_edge_feature(f, num_parts,
                                                 device=device)
              for et, f in (edge_feat_dict or {}).items()}
    return cls(graphs, bounds, feats, labels, old2new, device=device,
               edge_features=efeats)

  @classmethod
  def from_partition_dir(cls, *args, **kwargs):
    raise _not_ported('from_partition_dir (the host runtime\'s partition '
                      'layouts)', 'slice catalogue item 11')


class DistHeteroNeighborSampler(ExchangeTelemetry):
  """The mesh's heterogeneous multi-hop sampler with per-type feature
  and label collection (the module docstring), and its link arm
  (`sample_from_edges`).

  Args:
    dataset: `DistHeteroDataset` on ``device``.
    num_neighbors: per-hop fanouts, one list for every edge type or
      ``{EdgeType: list}`` (edge types left out take no part).
    mesh: a `Mesh` of the dataset's partitions (default: all of them on
      ``device``).
    with_edge: also return each sampled edge's global id (``edge`` by
      reversed edge type) and, with ``collect_features``, the row of
      every sampled edge type whose table the dataset holds (``ef``).
    collect_features: gather every featured type's rows.
    seed: seeds the default draws provider.
    exchange_slack: per-destination capacity multiplier (None = exact).
    draws: the draws provider (module docstring).
    exchange_layout: the exchange layout (`exchange.resolve_layout`).
  """

  def __init__(self, dataset: DistHeteroDataset, num_neighbors,
               mesh: Optional[Mesh] = None, with_edge: bool = False,
               collect_features: bool = True, seed: int = 0,
               exchange_slack: Optional[float] = None,
               draws: Optional[Draws] = None, device='cuda',
               exchange_layout: Optional[str] = None):
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
    self.etypes, self.fanouts, self.num_hops = normalize_fanouts(
        dataset.etypes, num_neighbors)
    self.num_parts = dataset.num_partitions
    self.collect_features = bool(collect_features)
    self.with_edge = bool(with_edge)
    self.exchange_slack = exchange_slack
    self.exchange_layout = exchange_layout or 'auto'
    self.draws = draws if draws is not None else TorchDraws(seed,
                                                            self.device)
    self._step_cnt = 0
    self._bounds_t = {nt: int64_on(b, self.device)
                      for nt, b in dataset.bounds.items()}
    feat_nts = sorted(dataset.node_features) if self.collect_features else []
    self._feat_nts = tuple(feat_nts)
    self._label_nts = tuple(sorted(dataset.node_labels))
    # only sampled edge types gather edge rows
    self._efeat_ets = (tuple(sorted(et for et in dataset.edge_features
                                    if et in self.etypes))
                       if self.collect_features and self.with_edge else ())
    self._eids = {}
    self._hot_t = {nt: int64_on(dataset.node_features[nt].hot_counts,
                                self.device)
                   for nt in feat_nts if dataset.node_features[nt].is_tiered}
    self._staging = {nt: (PinnedStaging() if self.device.type == 'cuda'
                          else None) for nt in self._hot_t}
    self._init_stats(self.device)
    #: host seconds of the cold overlay by part (`OVERLAY_PARTS`; the
    #: heterogeneous engine has no cache, so ``cache_serve`` and
    #: ``admission`` stay 0), summed since construction
    self.overlay_secs = dict.fromkeys(OVERLAY_PARTS, 0.0)

  @property
  def tiered(self) -> bool:
    return bool(self._hot_t)

  def _edge_ids(self, et: EdgeType) -> torch.Tensor:
    """Edge type ``et``'s shard edge ids as one ``[P, E_max]`` int32
    copy (the sampler kernel's edge-id arm reads int32), made once."""
    if et not in self._eids:
      eids = self.ds.graphs[et].edge_ids
      top = int(eids.max()) if eids.numel() else -1
      if top >= (1 << 31) - 1:
        raise ValueError(f'{et}: {top + 1} edges do not fit the int32 '
                         'ids the samplers write')
      self._eids[et] = eids.to(torch.int32).contiguous()
    return self._eids[et]

  def sample_from_nodes(self, input_type: NodeType,
                        seeds_stacked: np.ndarray) -> dict:
    """``[P, B]`` per-partition seeds of ``input_type`` (relabelled ids,
    -1 padded) -> the stacked batch pieces: ``node`` / ``node_count`` /
    ``x`` / ``y`` / ``num_sampled_nodes`` by type, ``row`` / ``col`` /
    ``edge`` / ``ef`` by REVERSED edge type, ``seed_local``, ``batch``
    and ``input_type``."""
    self._step_cnt += 1
    seeds = torch.from_numpy(np.asarray(seeds_stacked, np.int32)).to(
        self.device)
    out, seed_local, stats = self._expand_collect(
        {input_type: seeds}, self.draws, self._step_cnt)
    self._accumulate_stats(stats)
    out.update(seed_local=seed_local[input_type], batch=seeds,
               input_type=input_type)
    if self.tiered:
      self._overlay_cold_types(out)
    return out

  def _expand_collect(self, seed_sets: Dict[NodeType, torch.Tensor],
                      draws: Draws, step: int):
    """Expand every seed type's ``[P, n]`` seeds hop by hop and collect
    the rows: ``(pieces, seed_local by type, the [6] counters)``."""
    parts = next(iter(seed_sets.values())).shape[0]
    num_nodes = self.ds.num_nodes_dict()
    ntypes, table_cap, frontier_caps, _ = _plan_capacities(
        self.etypes, self.fanouts,
        {nt: v.shape[1] for nt, v in seed_sets.items()}, self.num_hops,
        num_nodes)
    dev = self.device
    # every partition's tables advance together: [P, cap] nodes, [P] counts
    states, seed_local = {}, {}
    for nt in ntypes:
      if nt in seed_sets:
        states[nt], seed_local[nt] = init_node(seed_sets[nt], table_cap[nt])
      else:
        states[nt] = init_node(torch.full((parts, 1), INVALID_ID,
                                          dtype=torch.int32, device=dev),
                               table_cap[nt])[0]
    fr_start = dict.fromkeys(ntypes, 0)
    rows_acc = {et: [] for et in self.etypes}
    cols_acc = {et: [] for et in self.etypes}
    eids_acc = {et: [] for et in self.etypes}
    counts = {nt: [states[nt].count] for nt in ntypes}
    fr_stats = torch.zeros(3, dtype=torch.int64, device=dev)
    for h in range(self.num_hops):
      # each type's frontier is the window the previous hop appended
      hop_start = {nt: states[nt].count for nt in ntypes}
      frontiers = {nt: _frontier(states[nt], fr_start[nt],
                                 frontier_caps[h][nt])
                   for nt in ntypes if frontier_caps[h].get(nt, 0) > 0}
      for ei, et in enumerate(self.etypes):
        s, _, d = et
        fan = self.fanouts[et]
        k = fan[h] if h < len(fan) else 0
        if k <= 0 or s not in frontiers:
          continue
        fr_nodes, fr_local = frontiers[s]
        g = self.ds.graphs[et]
        cap = self._channel_cap(fr_nodes.shape[1])
        nbrs, mask, he, _, hstats = _dist_one_hop(
            self.mesh, g.indptr, g.indices, self._bounds_t[s], fr_nodes,
            int(k), draws, step, h, cap, etype=ei,
            eids_loc=self._edge_ids(et) if self.with_edge else None)
        fr_stats.add_(hstats)
        states[d], rows, cols, _ = induce_next(states[d], fr_local, nbrs,
                                               mask)
        rows_acc[et].append(rows)
        cols_acc[et].append(cols)
        if self.with_edge:
          # induce_next flattens [F, k] row-major, as the ids
          eids_acc[et].append(torch.where(rows >= 0, he.reshape(rows.shape),
                                          INVALID_ID))
      for nt in ntypes:
        fr_start[nt] = hop_start[nt]
        counts[nt].append(states[nt].count)

    node = {nt: states[nt].nodes for nt in ntypes}
    nsn = {}
    for nt in ntypes:
      cum = torch.stack(counts[nt], dim=1)
      nsn[nt] = torch.cat([cum[:, :1], cum[:, 1:] - cum[:, :-1]],
                          dim=1).to(torch.int32)
    ft_stats = torch.zeros(3, dtype=torch.int64, device=dev)
    x, y, ef = {}, {}, {}
    for nt in self._feat_nts:
      nf = self.ds.node_features[nt]
      (x[nt],), gstats = dist_gather_multi(
          self.mesh, (nf.shards,), self._bounds_t[nt], node[nt],
          capacity=self._channel_cap(table_cap[nt]),
          hot_counts=self._hot_t.get(nt))
      ft_stats += gstats
    for nt in self._label_nts:
      (y[nt],), gstats = dist_gather_multi(
          self.mesh, (self.ds.node_labels[nt],), self._bounds_t[nt],
          node[nt], capacity=self._channel_cap(table_cap[nt]))
      ft_stats += gstats
    rev = {et: reverse_edge_type(et) for et in self.etypes if rows_acc[et]}
    for et in self._efeat_ets:
      if not eids_acc[et]:
        continue
      f = self.ds.edge_features[et]
      all_eids = torch.cat(eids_acc[et], dim=1)
      (ef[rev[et]],), gstats = dist_gather_multi(
          self.mesh, (f.shards,), f.bounds, all_eids,
          capacity=self._channel_cap(all_eids.shape[1]),
          shard_mode='mod' if f.mod_sharded else 'range')
      ft_stats += gstats
    pieces = dict(
        node=node,
        node_count={nt: states[nt].count for nt in ntypes},
        row={rev[et]: torch.cat(rows_acc[et], dim=1) for et in rev},
        col={rev[et]: torch.cat(cols_acc[et], dim=1) for et in rev},
        edge={rev[et]: torch.cat(eids_acc[et], dim=1) for et in rev
              if self.with_edge},
        x=x, y=y, ef=ef, num_sampled_nodes=nsn)
    return pieces, seed_local, torch.cat([fr_stats, ft_stats])

  def sample_from_edges(self, input_type: EdgeType,
                        pairs_stacked: np.ndarray,
                        neg_sampling=None) -> dict:
    """``[P, B, 2|3]`` per-partition (src, dst[, label]) seed edges of
    ``input_type`` (each endpoint in its type's relabelled space, -1
    padded) -> `sample_from_nodes`' pieces with the link ``metadata``.
    Strict negatives come from `dist_sample_negative` over the edge
    type's sharded CSR (rows in the source type, columns in the
    destination type)."""
    ns = NegativeSampling.cast(neg_sampling)
    self._step_cnt += 1
    pairs = torch.from_numpy(np.asarray(pairs_stacked, np.int32)).to(
        self.device)
    out = self._sample_link(tuple(input_type), pairs,
                            ns.mode if ns is not None else None,
                            float(ns.amount) if ns is not None else 1.0,
                            self.draws, self._step_cnt)
    if self.tiered:
      self._overlay_cold_types(out)
    return out

  def _sample_link(self, et: EdgeType, pairs: torch.Tensor,
                   mode: Optional[str], amount: float, draws: Draws,
                   step: int) -> dict:
    s_t, _, d_t = et
    parts, b = pairs.shape[:2]
    nn = (binary_num_negatives(b, amount) if mode == 'binary'
          else b * int(np.ceil(amount)) if mode == 'triplet' else 0)
    num_nodes = self.ds.num_nodes_dict()
    g = self.ds.graphs[et]
    src, dst = pairs[..., 0], pairs[..., 1]
    neg_ok = None
    neg_kw = dict(capacity=self._channel_cap(nn * NEG_TRIALS))
    if mode == 'binary':
      nrows, ncols, neg_ok = dist_sample_negative(
          self.mesh, g.indptr, g.indices, self._bounds_t[s_t],
          num_nodes[s_t], num_nodes[d_t], nn, draws, step, **neg_kw)
      src_seeds = torch.cat([src, nrows], 1)
      dst_seeds = torch.cat([dst, ncols], 1)
    elif mode == 'triplet':
      fixed = torch.where(src >= 0, src, 0).repeat_interleave(nn // b, 1)
      _, negs, neg_ok = dist_sample_negative(
          self.mesh, g.indptr, g.indices, self._bounds_t[s_t],
          num_nodes[s_t], num_nodes[d_t], nn, draws, step,
          rows_fixed=fixed, **neg_kw)
      src_seeds, dst_seeds = src, torch.cat([dst, negs], 1)
    else:
      src_seeds, dst_seeds = src, dst

    def clean(v):
      return torch.where(v >= 0, v, INVALID_ID).to(torch.int32)
    if s_t == d_t:
      seed_sets = {s_t: clean(torch.cat([src_seeds, dst_seeds], 1))}
    else:
      seed_sets = {s_t: clean(src_seeds), d_t: clean(dst_seeds)}
    out, sl, stats = self._expand_collect(seed_sets, draws, step)
    if neg_ok is not None:                  # dist.negative.lost
      stats = torch.cat([stats, (~neg_ok).sum().reshape(1)])
    self._accumulate_stats(stats)
    if s_t == d_t:
      n_src = b + nn if mode == 'binary' else b
      sl_s, sl_d = sl[s_t][:, :n_src], sl[s_t][:, n_src:]
    else:
      sl_s, sl_d = sl[s_t], sl[d_t]
    pair_valid = (src >= 0) & (dst >= 0)
    lab = pairs[..., 2] if pairs.shape[2] > 2 else torch.ones_like(src)
    pos_label = torch.where(pair_valid, lab, 0).to(torch.int32)
    md = {'seed_local': sl}
    if mode == 'binary':
      quota = torch.ceil(pair_valid.sum(1, keepdim=True).to(torch.float32)
                         * torch.tensor(amount, dtype=torch.float32,
                                        device=pairs.device)).to(torch.int32)
      keep = neg_ok & (torch.arange(nn, device=pairs.device)[None, :]
                       < quota)
      md.update(edge_label_index=torch.stack([sl_s, sl_d], 1),
                edge_label=torch.cat([pos_label, torch.zeros(
                    (parts, nn), dtype=torch.int32, device=pairs.device)],
                    1),
                edge_label_mask=torch.cat([pair_valid, keep], 1))
    elif mode == 'triplet':
      dn = torch.where(neg_ok, sl_d[:, b:], INVALID_ID).reshape(
          parts, b, nn // b)
      md.update(src_index=sl_s[:, :b], dst_pos_index=sl_d[:, :b],
                dst_neg_index=dn, pair_mask=sl_s[:, :b] >= 0)
    else:
      md.update(edge_label_index=torch.stack([sl_s, sl_d], 1),
                edge_label=pos_label, edge_label_mask=pair_valid)
    out.update(metadata=md, batch=src, input_type=et)
    return out

  def _overlay_cold_types(self, out: dict) -> None:
    """Fill every tiered type's cold rows from its host tier, in place
    on ``out['x']``: the tiered types' node tables come to the host in
    one copy, then one `overlay_cold_host` a type."""
    secs = self.overlay_secs
    tiered = [nt for nt in self._hot_t if nt in out['x']]
    t0 = time.perf_counter()
    flat = torch.cat([out['node'][nt].reshape(-1) for nt in tiered]).cpu()
    nodes_h = dict(zip(tiered, torch.split(
        flat, [out['node'][nt].numel() for nt in tiered])))
    t1 = time.perf_counter()
    split_s = gather_s = 0.0
    for nt in tiered:
      ta = time.perf_counter()
      nf = self.ds.node_features[nt]
      nodes_l = nodes_h[nt].numpy().astype(np.int64).reshape(
          out['node'][nt].shape)
      valid = nodes_l >= 0
      _rng, _local, cold = hot_split_host(self.ds.bounds[nt], nf.hot_counts,
                                          nodes_l, valid)
      tb = time.perf_counter()
      served = overlay_cold_host(out['x'][nt], nodes_l, nf.cold_host, cold,
                                 staging=self._staging[nt])
      tc = time.perf_counter()
      split_s += tb - ta
      gather_s += tc - tb
      with self._stats_lock:
        self._feat_lookups += int(valid.sum())
        self._cold_lookups += served
        self._cold_misses += served
      emit_cache_events('hetero', 0, served, 0, 0)
    secs['d2h'] += t1 - t0
    secs['hot_split'] += split_s
    secs['host_gather'] += gather_s


class DistHeteroNeighborLoader(PrefetchingLoader):
  """Mesh loader of heterogeneous node batches: splits the seeds of one
  node type across the partitions and yields stacked `HeteroBatch`es
  (every tensor with a leading partition axis; ``edge_index_dict`` by
  reversed edge type ``[P, 2, E]``, ``edge_mask_dict``,
  ``node_mask_dict``, ``batch_dict``) for a data-parallel step over
  `parallel.dp.local_piece`.

  With ``with_edge`` a batch also carries each sampled edge's global id
  (``metadata['edge_dict']``) and the rows of the edge types the dataset
  has features for (``edge_attr_dict``), both by reversed edge type.

  Args:
    input_nodes: ``(NodeType, seeds)``; ``input_space='old'`` maps the
      seeds through the dataset's ``old2new``.
    exchange_slack: ``'auto'`` (2.0 for shuffled seeds, exact for
      sequential ones), ``'adaptive'`` (`AdaptiveSlack`, retuned between
      epochs) or a number / None.
    prefetch: batches produced ahead on a worker thread with its own
      CUDA stream (`loader.prefetch`); batches are the same as without.
    Others as `DistHeteroNeighborSampler`.
  """

  def __init__(self, dataset: DistHeteroDataset, num_neighbors,
               input_nodes, batch_size: int = 1, shuffle: bool = False,
               drop_last: bool = False, mesh: Optional[Mesh] = None,
               with_edge: bool = False, collect_features: bool = True,
               seed: int = 0, input_space: str = 'old',
               exchange_slack='auto', prefetch: int = 0,
               draws: Optional[Draws] = None, device='cuda',
               exchange_layout: Optional[str] = None):
    self.prefetch = int(prefetch)
    input_type, seeds = input_nodes
    self.input_type = input_type
    slack = resolve_exchange_slack(exchange_slack, shuffle)
    self.sampler = DistHeteroNeighborSampler(
        dataset, num_neighbors, mesh=mesh, with_edge=with_edge,
        collect_features=collect_features, seed=seed,
        exchange_slack=(DEFAULT_EXCHANGE_SLACK if slack == 'adaptive'
                        else slack), draws=draws, device=device,
        exchange_layout=exchange_layout)
    self._prefetch_device = self.sampler.device
    self._adaptive = (AdaptiveSlack(self.sampler)
                      if slack == 'adaptive' else None)
    self._epoch_count = 0
    self.ds = dataset
    seeds = np.asarray(seeds).reshape(-1)
    if input_space == 'old' and input_type in dataset.old2new:
      seeds = dataset.old2new[input_type][seeds]
    self.num_parts = dataset.num_partitions
    self.batch_size = int(batch_size)
    self._batcher = SeedBatcher(seeds, self.batch_size * self.num_parts,
                                shuffle, drop_last, seed)

  def __len__(self) -> int:
    return len(self._batcher)

  def _produce(self, seed_iter) -> HeteroBatch:
    flat = next(seed_iter)
    out = self.sampler.sample_from_nodes(
        self.input_type, flat.reshape(self.num_parts, self.batch_size))
    md = {'seed_local': out['seed_local'], 'input_type': self.input_type}
    return _hetero_batch(out, md, {self.input_type: out['batch']},
                         self.batch_size)


def _hetero_batch(out: dict, md: dict, batch_dict: dict,
                  batch_size: int) -> HeteroBatch:
  """A sampler's stacked pieces as a `HeteroBatch`; the global edge ids,
  when sampled, go under ``metadata['edge_dict']`` by reversed edge
  type, as in JAX."""
  if out['edge']:
    md['edge_dict'] = out['edge']
  return HeteroBatch(
      x_dict=out['x'], y_dict=out['y'],
      edge_index_dict={et: torch.stack([out['row'][et], out['col'][et]],
                                       dim=1) for et in out['row']},
      edge_attr_dict=dict(out['ef']), node_dict=out['node'],
      node_mask_dict={nt: v >= 0 for nt, v in out['node'].items()},
      edge_mask_dict={et: r >= 0 for et, r in out['row'].items()},
      batch_dict=batch_dict, batch_size=batch_size, metadata=md)


class DistHeteroLinkNeighborLoader(PrefetchingLoader):
  """Mesh loader of heterogeneous link batches (the JAX package's
  `DistHeteroLinkNeighborLoader`): splits one edge type's seed edges
  across the partitions, draws each partition's strict negatives over
  that edge type's sharded graph and yields stacked `HeteroBatch`es
  with the link metadata (``seed_local`` by node type, then binary
  ``edge_label_index`` / ``edge_label`` / ``edge_label_mask``, triplet
  ``src_index`` / ``dst_pos_index`` / ``dst_neg_index`` /
  ``pair_mask``, or the positives alone), ``input_type`` and, with
  ``with_edge``, ``edge_dict``.

  Args:
    edge_label_index: ``(edge_type, (rows, cols))`` seed edges, each
      endpoint in its node type's id space (``input_space='old'`` maps
      them through the dataset's ``old2new``).
    edge_label: optional integer labels (binary mode shifts them up by
      one).
    neg_sampling: None, ``'binary'`` or ``('triplet', amount)``.
    Others as `DistHeteroNeighborLoader`; a padded tail batch keeps
    ``ceil(valid pairs * amount)`` binary negatives.
  """

  def __init__(self, dataset: DistHeteroDataset, num_neighbors,
               edge_label_index, edge_label=None, neg_sampling=None,
               batch_size: int = 1, shuffle: bool = False,
               drop_last: bool = False, mesh: Optional[Mesh] = None,
               with_edge: bool = False, collect_features: bool = True,
               seed: int = 0, input_space: str = 'old',
               exchange_slack='auto', prefetch: int = 0,
               draws: Optional[Draws] = None, device='cuda',
               exchange_layout: Optional[str] = None):
    self.prefetch = int(prefetch)
    input_type, pairs = edge_label_index
    self.input_type = tuple(input_type)
    self.neg_sampling = NegativeSampling.cast(neg_sampling)
    slack = resolve_exchange_slack(exchange_slack, shuffle)
    self.sampler = DistHeteroNeighborSampler(
        dataset, num_neighbors, mesh=mesh, with_edge=with_edge,
        collect_features=collect_features, seed=seed,
        exchange_slack=(DEFAULT_EXCHANGE_SLACK if slack == 'adaptive'
                        else slack), draws=draws, device=device,
        exchange_layout=exchange_layout)
    self._prefetch_device = self.sampler.device
    self._adaptive = (AdaptiveSlack(self.sampler)
                      if slack == 'adaptive' else None)
    self._epoch_count = 0
    self.ds = dataset
    mode = self.neg_sampling.mode if self.neg_sampling is not None else None
    rows, cols, columns = pack_link_seeds(pairs, edge_label, mode)
    s_t, _, d_t = self.input_type
    if input_space == 'old':
      if s_t in dataset.old2new:
        columns[0] = dataset.old2new[s_t][rows]
      if d_t in dataset.old2new:
        columns[1] = dataset.old2new[d_t][cols]
    self.pairs = np.stack(columns, axis=1)
    self.num_parts = dataset.num_partitions
    self.batch_size = int(batch_size)
    # the batcher splits row indices of the packed seed table (-1 padded,
    # so a padded tail row is -1 in every column, as JAX pads the table)
    self._batcher = SeedBatcher(np.arange(len(self.pairs)),
                                self.batch_size * self.num_parts, shuffle,
                                drop_last, seed)

  def __len__(self) -> int:
    return len(self._batcher)

  def _produce(self, seed_iter) -> HeteroBatch:
    rows = packed_rows(self.pairs, next(seed_iter))
    out = self.sampler.sample_from_edges(
        self.input_type, rows.reshape(self.num_parts, self.batch_size, -1),
        neg_sampling=self.neg_sampling)
    md = dict(out['metadata'], input_type=self.input_type)
    return _hetero_batch(out, md, {self.input_type[0]: out['batch']},
                         self.batch_size)
