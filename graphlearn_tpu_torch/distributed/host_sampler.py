"""Host (CPU) multi-hop neighbor sampling -> flat SampleMessage.

The JAX package's `distributed/host_sampler.py`: the engine that runs
inside sampling subprocesses — the role the reference's
`DistNeighborSampler._sample_from_nodes` + `_colloate_fn` play in its
sampling workers (`distributed/dist_neighbor_sampler.py:
255-324,600-673`), built on the native CPU ops
(``csrc/host/cpu_ops.cc``, ``csrc/host/inducer.cc``).  Feature/label
collation happens here, in the producer, so the trainer process only
deserializes, pads and copies to the card.  A batch's messages are
byte-equal to the JAX package's for the same batch seed.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..channel.base import SampleMessage
from ..typing import as_str, reverse_edge_type
from .host_dataset import HostDataset, HostHeteroDataset


def shard_out_edges(ds, nodes: np.ndarray, with_edge: bool):
  """ALL out-edges of ``nodes`` on a host CSR in one vectorized pass (a
  per-node loop would dominate the producer hot path at SEAL closure
  sizes): returns ``(src_pos, nbrs, eids | None)``, ``src_pos``
  indexing into ``nodes``."""
  starts = ds.indptr[nodes]
  degs = ds.indptr[nodes + 1] - starts
  total = int(degs.sum())
  # flat positions of every node's out-edges in `indices`
  off = np.repeat(np.cumsum(degs) - degs, degs)
  flat = (np.arange(total) - off
          + np.repeat(starts, degs)) if total else np.empty(0, np.int64)
  src_pos = np.repeat(np.arange(len(nodes), dtype=np.int64), degs)
  eids = (ds.edge_ids[flat] if (with_edge and ds.edge_ids is not None)
          else None)
  return src_pos, ds.indices[flat], eids


def sorted_cols(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
  """Within-row-sorted column view of an (unsorted) CSR, enabling
  vectorized membership tests."""
  rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
  order = np.lexsort((indices, rows))
  return indices[order]


def edges_exist(indptr: np.ndarray, sindices: np.ndarray,
                rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
  """Vectorized (row, col) membership via per-row binary search on the
  sorted view — one pass, no per-source Python loops."""
  e = len(sindices)
  if e == 0:
    return np.zeros(len(rows), bool)
  lo = indptr[rows].copy()
  hi0 = indptr[rows + 1]
  hi = hi0.copy()
  for _ in range(max(int(e), 1).bit_length()):
    active = lo < hi
    mid = (lo + hi) // 2
    v = sindices[np.clip(mid, 0, max(e - 1, 0))]
    go = v < cols
    lo = np.where(active & go, mid + 1, lo)
    hi = np.where(active & ~go, mid, hi)
  at = np.clip(lo, 0, e - 1)
  return (lo < hi0) & (sindices[at] == cols)


def strict_negative_pairs(indptr, sindices, num_src: int, num_dst: int,
                          count: int, seed: int, trials: int = 5):
  """``count`` (row, col) pairs avoiding existing edges — the
  reference's strict+padding negative sampler
  (`random_negative_sampler.cu:96-120`) as trials-stacked draws with
  batched rejection; slots where every trial collides keep the last
  draw (non-strict padding).  Bipartite-aware: rows from ``num_src``,
  cols from ``num_dst``.  Returns ``(rows, cols, ok)`` — ``ok`` False
  marks exhausted-trials slots whose pair may be a REAL edge; callers
  must mask those out of the negative label set (mirroring the mesh
  engine's ``neg_ok`` contract in `parallel.dist_sampler.
  dist_sample_negative`)."""
  rng = np.random.default_rng(seed)
  rows = rng.integers(0, num_src, (trials, count))
  cols = rng.integers(0, num_dst, (trials, count))
  exists = edges_exist(indptr, sindices, rows.reshape(-1),
                       cols.reshape(-1)).reshape(trials, count)
  ok = ~exists
  any_ok = ok.any(axis=0)
  pick = np.where(any_ok, np.argmax(ok, axis=0), trials - 1)
  ar = np.arange(count)
  return rows[pick, ar], cols[pick, ar], any_ok


def strict_negative_dsts(indptr, sindices, src: np.ndarray, num_dst: int,
                         amount: int, seed: int, trials: int = 5):
  """Per-source strict negative destinations ``[len(src), amount]``
  (triplet mode), vectorized like :func:`strict_negative_pairs`.
  Returns ``(dsts, ok)`` — ``ok[i, j]`` False marks exhausted-trials
  slots (possible real edges) the caller must invalidate."""
  rng = np.random.default_rng(seed)
  m = len(src) * amount
  cand = rng.integers(0, num_dst, (trials, m))
  srcr = np.tile(np.repeat(src, amount), (trials, 1))
  exists = edges_exist(indptr, sindices, srcr.reshape(-1),
                       cand.reshape(-1)).reshape(trials, m)
  ok = ~exists
  any_ok = ok.any(axis=0)
  pick = np.where(any_ok, np.argmax(ok, axis=0), trials - 1)
  return (cand[pick, np.arange(m)].reshape(len(src), amount),
          any_ok.reshape(len(src), amount))


class HostNeighborSampler:
  """Multi-hop uniform sampler over a `HostDataset`.

  Args:
    dataset: host CSR + features.
    num_neighbors: per-hop fanouts.
    with_edge: emit global edge ids.
    collect_features: gather ``nfeats``/``nlabels`` rows into messages.
    seed: base PRNG seed (per-batch streams derive from it).
  """

  def __init__(self, dataset: HostDataset, num_neighbors: Sequence[int],
               with_edge: bool = False, collect_features: bool = True,
               seed: int = 0):
    if getattr(dataset, 'node_pb', None) is not None and \
        type(self) is HostNeighborSampler:
      raise ValueError(
          'HostDataset is a partition shard (node_pb is set): a '
          'local-only sampler would silently under-sample remote '
          'neighborhoods and zero-fill remote features.  Use the mesh '
          'engine (graphlearn_tpu_torch.parallel) or load the FULL '
          'graph via HostDataset.from_dataset; the cross-server host '
          'sampler comes in port slice 25.')
    self.ds = dataset
    self.fanouts = [int(k) for k in num_neighbors]
    self.with_edge = with_edge
    self.collect_features = collect_features
    self._seed = int(seed)
    self._batch_idx = 0

  def _next_batch_seed(self, batch_seed: Optional[int]) -> int:
    if batch_seed is None:
      batch_seed = self._seed + self._batch_idx
      self._batch_idx += 1
    return batch_seed

  # -- overridable data-access hooks (a partition-aware subclass
  # reroutes these through peer RPC fan-out) ----------------------------
  def _begin_batch(self) -> None:
    """Per-batch reset hook (dist subclass clears its eid caches)."""

  def _one_hop(self, frontier: np.ndarray, k: int, hop_seed: int):
    """Sample ``k`` neighbors of each frontier id; returns
    ``(nbrs [n,k], mask [n,k], eids [n,k] | None)``."""
    return native.sample_one_hop(
        self.ds.indptr, self.ds.indices, frontier, k, seed=hop_seed,
        edge_ids=self.ds.edge_ids, with_edge_ids=self.with_edge)

  def _gather_node_features(self, ids: np.ndarray) -> np.ndarray:
    return self.ds.node_features[ids]

  def _gather_node_labels(self, ids: np.ndarray) -> np.ndarray:
    return self.ds.node_labels[ids]

  def _gather_edge_features(self, eids: np.ndarray) -> np.ndarray:
    return self.ds.edge_features[eids]

  def _closure_out_edges(self, nodes: np.ndarray):
    """ALL out-edges of ``nodes`` (the induced-subgraph scan source);
    see :func:`shard_out_edges`."""
    return shard_out_edges(self.ds, nodes, self.with_edge)

  @property
  def _has_node_features(self) -> bool:
    return self.ds.node_features is not None

  @property
  def _has_node_labels(self) -> bool:
    return self.ds.node_labels is not None

  @property
  def _has_edge_features(self) -> bool:
    return self.ds.edge_features is not None

  def _expand(self, seeds: np.ndarray, batch_seed: int):
    """Multi-hop expansion shared by node/link/subgraph modes; returns
    ``(inducer, seed_local, rows, cols, eids, num_sampled)``."""
    self._begin_batch()
    ind = native.CpuInducer(capacity_hint=max(len(seeds) * 4, 64))
    seed_local = ind.init_nodes(seeds)
    frontier = ind.all_nodes()
    rows_acc, cols_acc, eids_acc = [], [], []
    num_sampled = [ind.num_nodes]
    for h, k in enumerate(self.fanouts):
      nbrs, mask, eids = self._one_hop(frontier, k,
                                       batch_seed * 1000003 + h)
      before = ind.num_nodes
      new_nodes, rl, cl = ind.induce_next(frontier, nbrs, mask)
      keep = rl.reshape(-1) >= 0
      rows_acc.append(rl.reshape(-1)[keep])
      cols_acc.append(cl.reshape(-1)[keep])
      if self.with_edge:
        eids_acc.append(eids.reshape(-1)[keep])
      num_sampled.append(ind.num_nodes - before)
      frontier = new_nodes
      if len(frontier) == 0:
        break
    rows = (np.concatenate(rows_acc) if rows_acc else np.empty(0, np.int32))
    cols = (np.concatenate(cols_acc) if cols_acc else np.empty(0, np.int32))
    eids = (np.concatenate(eids_acc) if (self.with_edge and eids_acc)
            else None)
    return ind, seed_local, rows, cols, eids, num_sampled

  def _finish(self, seeds, ind, seed_local, rows, cols, eids,
              num_sampled) -> SampleMessage:
    nodes = ind.all_nodes()
    msg: SampleMessage = {
        '#IS_HETERO': np.uint8(0),
        'ids': nodes,
        'rows': rows,
        'cols': cols,
        'batch': np.ascontiguousarray(seeds, np.int64),
        'seed_local': seed_local,
        'num_sampled_nodes': np.asarray(num_sampled, np.int32),
    }
    if eids is not None:
      msg['eids'] = eids
      if self.collect_features and self._has_edge_features:
        # per-edge feature rows by global eid — the reference's efeats
        # collation (`dist_neighbor_sampler.py:600-673`)
        msg['efeats'] = np.ascontiguousarray(
            self._gather_edge_features(eids))
    if self.collect_features and self._has_node_features:
      msg['nfeats'] = np.ascontiguousarray(
          self._gather_node_features(nodes))
    if self._has_node_labels:
      msg['nlabels'] = np.ascontiguousarray(
          self._gather_node_labels(nodes))
    return msg

  def sample_from_nodes(self, seeds: np.ndarray,
                        batch_seed: Optional[int] = None) -> SampleMessage:
    """One ragged mini-batch message for ``seeds``."""
    seeds = np.ascontiguousarray(seeds, np.int64)
    batch_seed = self._next_batch_seed(batch_seed)
    out = self._expand(seeds, batch_seed)
    return self._finish(seeds, *out)

  # -- link mode (reference `DistNeighborSampler._sample_from_edges`,
  # `dist_neighbor_sampler.py:327-453`) -----------------------------------
  def sample_from_edges(self, src: np.ndarray, dst: np.ndarray,
                        label: Optional[np.ndarray] = None,
                        neg_mode: Optional[str] = None,
                        neg_amount: float = 1.0,
                        batch_seed: Optional[int] = None) -> SampleMessage:
    """Link-prediction message: endpoints + negatives expanded, with
    PyG link-label metadata under ``#META.*`` keys."""
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    b = len(src)
    batch_seed = self._next_batch_seed(batch_seed)
    neg_ok = None
    if neg_mode == 'binary':
      from .dist_options import binary_num_negatives
      num_neg = binary_num_negatives(b, neg_amount)
      # padding=False: the native sampler returns only strict-verified
      # pairs; self-pad the exhausted slots with masked dummies so the
      # batch keeps its static width while possible real edges stay
      # out of the negative label set (the mesh engine's neg_ok
      # contract)
      srows, scols = native.negative_sample(
          self.ds.indptr, self.ds.indices, num_neg, strict=True,
          padding=False, seed=batch_seed * 31 + 7)
      cnt = len(srows)
      nrows = np.zeros(num_neg, np.int64)
      ncols = np.zeros(num_neg, np.int64)
      nrows[:cnt] = srows
      ncols[:cnt] = scols
      neg_ok = np.arange(num_neg) < cnt
      seeds = np.concatenate([src, dst, nrows, ncols])
    elif neg_mode == 'triplet':
      amount = int(np.ceil(neg_amount))
      neg_dst, neg_ok = self._triplet_neg(src, amount, batch_seed)
      seeds = np.concatenate([src, dst, neg_dst.reshape(-1)])
    else:
      seeds = np.concatenate([src, dst])
    msg = self._finish(seeds, *self._expand(seeds, batch_seed))
    sl = msg['seed_local']
    pos_label = (np.ascontiguousarray(label, np.int64)
                 if label is not None else np.ones(b, np.int64))
    if neg_mode == 'binary':
      msg['#META.edge_label_index'] = np.stack([
          np.concatenate([sl[:b], sl[2 * b:2 * b + num_neg]]),
          np.concatenate([sl[b:2 * b], sl[2 * b + num_neg:]]),
      ]).astype(np.int64)
      msg['#META.edge_label'] = np.concatenate(
          [pos_label, np.zeros(num_neg, np.int64)])
      msg['#META.edge_label_mask'] = np.concatenate(
          [np.ones(b, bool), neg_ok])
    elif neg_mode == 'triplet':
      amount = int(np.ceil(neg_amount))
      msg['#META.src_index'] = sl[:b]
      msg['#META.dst_pos_index'] = sl[b:2 * b]
      msg['#META.dst_neg_index'] = np.where(
          neg_ok, sl[2 * b:].reshape(b, amount), -1)
    else:
      msg['#META.edge_label_index'] = np.stack(
          [sl[:b], sl[b:2 * b]]).astype(np.int64)
      msg['#META.edge_label'] = pos_label
    return msg

  def _sorted_csr(self):
    """Lazily cached within-row-sorted column view (the native CSR is
    unsorted)."""
    if not hasattr(self, '_sorted_indices'):
      self._sorted_indices = sorted_cols(self.ds.indptr, self.ds.indices)
    return self._sorted_indices

  def _triplet_neg(self, src: np.ndarray, amount: int, batch_seed: int,
                   trials: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    return strict_negative_dsts(self.ds.indptr, self._sorted_csr(), src,
                                self.ds.num_nodes, amount, batch_seed,
                                trials)

  # -- subgraph mode (reference `DistNeighborSampler._subgraph`,
  # `dist_neighbor_sampler.py:456-516`) -----------------------------------
  def sample_subgraph(self, seeds: np.ndarray,
                      batch_seed: Optional[int] = None) -> SampleMessage:
    """Multi-hop closure, then ALL edges among the collected nodes
    (relabeled local COO) — the SEAL enclosing-subgraph message."""
    seeds = np.ascontiguousarray(seeds, np.int64)
    batch_seed = self._next_batch_seed(batch_seed)
    ind, seed_local, _r, _c, _e, num_sampled = self._expand(
        seeds, batch_seed)
    nodes = ind.all_nodes()
    # membership + relabel over the closure set, one vectorized pass
    order = np.argsort(nodes)
    snodes = nodes[order]
    src_l, nb, flat_eids = self._closure_out_edges(nodes)
    pos = np.clip(np.searchsorted(snodes, nb), 0, max(len(snodes) - 1, 0))
    keep = (snodes[pos] == nb) if len(snodes) else np.zeros(0, bool)
    rows = src_l[keep]
    cols = order[pos[keep]]
    eids = flat_eids[keep] if flat_eids is not None else None
    msg = self._finish(seeds, ind, seed_local, rows, cols, eids,
                       num_sampled)
    msg['#META.mapping'] = seed_local
    return msg


class HostHeteroNeighborSampler:
  """Heterogeneous multi-hop sampler over a `HostHeteroDataset`.

  The host-runtime twin of the device hetero engine
  (`sampler/hetero_neighbor_sampler.py`) and the role
  the reference's hetero `DistNeighborSampler` path plays inside
  sampling workers (`distributed/dist_neighbor_sampler.py:192-253` +
  hetero `_colloate_fn` keys `f'{type}.x'`, `:600-673`).  Semantics
  match the device engine: per-node-type dedup tables, per-edge-type
  per-hop fanouts, edges emitted under the REVERSED edge type with
  transposed (neighbor -> seed) direction.

  Message layout (flat, shm-serializable): ``'#IS_HETERO'=1``;
  per node type ``'{nt}.ids' / '{nt}.nfeats' / '{nt}.nlabels' /
  '{nt}.num_sampled' / '{nt}.seed_local'`` (seeded types only); per
  emitted reversed edge type ``'{as_str(et)}.rows' / '.cols' /
  '.eids'``; plus ``'batch'`` and link-label ``'#META.*'`` keys.
  """

  def __init__(self, dataset: HostHeteroDataset, num_neighbors,
               with_edge: bool = False, collect_features: bool = True,
               seed: int = 0):
    if getattr(dataset, 'node_pb', None) is not None:
      raise ValueError(
          'HostHeteroDataset is a partition shard (node_pb is set): a '
          'local-only sampler would silently under-sample remote '
          'neighborhoods.  Use the mesh engine '
          '(graphlearn_tpu_torch.parallel.DistHeteroNeighborSampler) or '
          'load the FULL graph via HostHeteroDataset.from_dataset.')
    from ..sampler.hetero_neighbor_sampler import normalize_fanouts
    self.ds = dataset
    self.etypes, self.fanouts, self.num_hops = normalize_fanouts(
        dataset.edge_types, num_neighbors)
    self.with_edge = with_edge
    self.collect_features = collect_features
    self._seed = int(seed)
    self._batch_idx = 0
    self._sorted = {}        # etype -> within-row-sorted column view

  def _next_batch_seed(self, batch_seed: Optional[int]) -> int:
    if batch_seed is None:
      batch_seed = self._seed + self._batch_idx
      self._batch_idx += 1
    return batch_seed

  def _sorted_for(self, etype):
    if etype not in self._sorted:
      indptr, indices, _ = self.ds.csr[etype]
      self._sorted[etype] = sorted_cols(indptr, indices)
    return self._sorted[etype]

  def _expand(self, seeds_by_type, batch_seed: int):
    """Per-type multi-hop expansion; returns
    ``(states, seed_locals, rows/cols/eids per etype, num_sampled)``."""
    ntypes = self.ds.node_types
    states = {nt: native.CpuInducer(
        capacity_hint=max(sum(len(v) for v in seeds_by_type.values()) * 4,
                          64)) for nt in ntypes}
    seed_locals = {}
    frontier = {}
    for nt, g in seeds_by_type.items():
      seed_locals[nt] = states[nt].init_nodes(g)
      n = states[nt].num_nodes
      frontier[nt] = (states[nt].all_nodes(),
                      np.arange(n, dtype=np.int32))
    num_sampled = {nt: [states[nt].num_nodes] for nt in ntypes}
    rows_acc = {et: [] for et in self.etypes}
    cols_acc = {et: [] for et in self.etypes}
    eids_acc = {et: [] for et in self.etypes}
    for h in range(self.num_hops):
      start = {nt: states[nt].num_nodes for nt in ntypes}
      for ei, et in enumerate(self.etypes):
        s, _, d = et
        fan = self.fanouts[et]
        k = fan[h] if h < len(fan) else 0
        fr = frontier.get(s)
        if k <= 0 or fr is None or len(fr[0]) == 0:
          continue
        indptr, indices, edge_ids = self.ds.csr[et]
        nbrs, mask, eids = native.sample_one_hop(
            indptr, indices, fr[0], int(k),
            seed=(batch_seed * 1000003 + h) * 131 + ei,
            edge_ids=edge_ids, with_edge_ids=self.with_edge)
        _, rl, cl = states[d].induce_from(fr[1], nbrs, mask)
        keep = rl.reshape(-1) >= 0
        rows_acc[et].append(rl.reshape(-1)[keep])
        cols_acc[et].append(cl.reshape(-1)[keep])
        if self.with_edge:
          eids_acc[et].append(eids.reshape(-1)[keep])
      # hop-h frontier of each type = nodes first discovered this hop,
      # deduplicated across ALL edge types by the shared table
      frontier = {}
      for nt in ntypes:
        end = states[nt].num_nodes
        num_sampled[nt].append(end - start[nt])
        if end > start[nt]:
          frontier[nt] = (states[nt].nodes_since(start[nt]),
                          np.arange(start[nt], end, dtype=np.int32))
    return states, seed_locals, rows_acc, cols_acc, eids_acc, num_sampled

  def _finish(self, states, seed_locals, rows_acc, cols_acc, eids_acc,
              num_sampled) -> SampleMessage:
    msg: SampleMessage = {'#IS_HETERO': np.uint8(1)}
    for nt in self.ds.node_types:
      ids = states[nt].all_nodes()
      msg[f'{nt}.ids'] = ids
      msg[f'{nt}.num_sampled'] = np.asarray(num_sampled[nt], np.int32)
      if nt in seed_locals:
        msg[f'{nt}.seed_local'] = seed_locals[nt]
      if self.collect_features and nt in self.ds.node_features:
        msg[f'{nt}.nfeats'] = np.ascontiguousarray(
            self.ds.node_features[nt][ids])
      if nt in self.ds.node_labels:
        msg[f'{nt}.nlabels'] = np.ascontiguousarray(
            self.ds.node_labels[nt][ids])
    for et in self.etypes:
      if not rows_acc[et]:
        continue
      key = as_str(reverse_edge_type(et))
      msg[f'{key}.rows'] = np.concatenate(rows_acc[et])
      msg[f'{key}.cols'] = np.concatenate(cols_acc[et])
      if self.with_edge and eids_acc[et]:
        eids = np.concatenate(eids_acc[et])
        msg[f'{key}.eids'] = eids
        if (self.collect_features
            and tuple(et) in self.ds.edge_features):
          msg[f'{key}.efeats'] = np.ascontiguousarray(
              self.ds.edge_features[tuple(et)][eids])
    return msg

  def sample_from_nodes(self, input_type: str, seeds: np.ndarray,
                        batch_seed: Optional[int] = None) -> SampleMessage:
    """One ragged hetero mini-batch message for ``input_type`` seeds."""
    seeds = np.ascontiguousarray(seeds, np.int64)
    batch_seed = self._next_batch_seed(batch_seed)
    msg = self._finish(*self._expand({input_type: seeds}, batch_seed))
    msg['batch'] = seeds
    return msg

  def sample_from_edges(self, input_type, src: np.ndarray,
                        dst: np.ndarray,
                        label: Optional[np.ndarray] = None,
                        neg_mode: Optional[str] = None,
                        neg_amount: float = 1.0,
                        batch_seed: Optional[int] = None) -> SampleMessage:
    """Hetero link-prediction message: ``input_type`` is the seed edge
    type; endpoints + negatives expand from their own node types."""
    s, _, d = tuple(input_type)
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    b = len(src)
    batch_seed = self._next_batch_seed(batch_seed)
    neg_ok = None
    if neg_mode == 'binary':
      from .dist_options import binary_num_negatives
      indptr, _, _ = self.ds.csr[tuple(input_type)]
      sind = self._sorted_for(tuple(input_type))
      num_neg = binary_num_negatives(b, neg_amount)
      nrows, ncols, neg_ok = strict_negative_pairs(
          indptr, sind, self.ds.num_nodes[s], self.ds.num_nodes[d],
          num_neg, seed=batch_seed * 31 + 7)
      src_seeds = np.concatenate([src, nrows])
      dst_seeds = np.concatenate([dst, ncols])
    elif neg_mode == 'triplet':
      amount = int(np.ceil(neg_amount))
      indptr, _, _ = self.ds.csr[tuple(input_type)]
      sind = self._sorted_for(tuple(input_type))
      negs, neg_ok = strict_negative_dsts(indptr, sind, src,
                                          self.ds.num_nodes[d], amount,
                                          seed=batch_seed * 31 + 7)
      src_seeds = src
      dst_seeds = np.concatenate([dst, negs.reshape(-1)])
    else:
      src_seeds, dst_seeds = src, dst
    if s == d:
      seeds_by_type = {s: np.concatenate([src_seeds, dst_seeds])}
    else:
      seeds_by_type = {s: src_seeds, d: dst_seeds}
    out = self._expand(seeds_by_type, batch_seed)
    msg = self._finish(*out)
    seed_locals = out[1]
    if s == d:
      all_local = seed_locals[s]
      sl_s = all_local[:len(src_seeds)]
      sl_d = all_local[len(src_seeds):]
    else:
      sl_s, sl_d = seed_locals[s], seed_locals[d]
    msg['batch'] = src
    pos_label = (np.ascontiguousarray(label, np.int64)
                 if label is not None else np.ones(b, np.int64))
    if neg_mode == 'binary':
      msg['#META.edge_label_index'] = np.stack(
          [sl_s, sl_d]).astype(np.int64)
      msg['#META.edge_label'] = np.concatenate(
          [pos_label, np.zeros(len(sl_s) - b, np.int64)])
      msg['#META.edge_label_mask'] = np.concatenate(
          [np.ones(b, bool), neg_ok])
    elif neg_mode == 'triplet':
      amount = int(np.ceil(neg_amount))
      msg['#META.src_index'] = sl_s[:b]
      msg['#META.dst_pos_index'] = sl_d[:b]
      msg['#META.dst_neg_index'] = np.where(
          neg_ok, sl_d[b:].reshape(b, amount), -1)
    else:
      msg['#META.edge_label_index'] = np.stack(
          [sl_s, sl_d]).astype(np.int64)
      msg['#META.edge_label'] = pos_label
    return msg
