"""Mesh neighbor sampling with feature collection over a tiered store,
its link engine and their loaders (the JAX package's
`parallel/dist_sampler.py`: `_dist_one_hop`, `dist_gather_multi`,
`dist_gather`, `dist_edge_exists`, `dist_sample_negative`,
`_expand_and_collect`, `overlay_cold_host`, `AdaptiveSlack`,
`DistNeighborSampler`, `DistNeighborLoader`, `DistLinkNeighborSampler`,
`DistLinkNeighborLoader`, the induced-subgraph step,
`resolve_hop_chunk`, `DistSubGraphSampler`, `DistSubGraphLoader`, the
walk step and `DistRandomWalker`, the book-routed exchange and
failover seams: `_BookPlan` and the samplers' supervision and fence, and
the exchange layouts' routing, the traffic attribution, `cache_overlay`
and `capacity_retune`).

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
          -> `induce_next` (every partition's table at once); with
          ``with_edge`` each owner also writes its slots' GLOBAL edge
          ids (``edge_ids[pos]`` of its shard, the kernels' edge-id
          arm), which ride the reply;
  edges:  with edge features, one exchange gathers every sampled edge's
          row from the mod-sharded table (owner ``eid % P``, row ``eid
          // P``), each owner's read by the row gather kernel;
  rows:   one exchange gathers features (hot tier only: rows past the
          owner's hot count come back zero) and labels, each owner's
          read by the row gather kernel.

The subgraph sampler expands its seeds as above (without edge ids), then
takes ONE full-window hop over its closure, chunk by chunk: each owner
answers its receive rows with every out-neighbor in CSR order.  With
``max_degree`` at least the shards' true max degree (the default) that
hop is exact: the CSR window gather kernel reads each row's
``max_degree`` slots from ``indptr[row]`` and the slots past the row's
degree are masked (no draw is taken; the JAX package's sampler returns
the same window whatever its draws, since ``deg <= k``).  A smaller
``max_degree`` truncates: the hop samples ``k = max_degree`` through the
uniform sampler kernel at ``draws(step, chunk, ...)``, as JAX keys
chunk ``ci`` with the key of expansion hop ``ci``.  Each partition then
keeps the window entries that are members of its own closure (a sort
and a binary search) and relabels them to local ids.  The walker takes
one hop of fanout 1 a walk step, at ``draws(step, t, ...)``.

The link sampler first draws each partition's strict negatives: ``5``
candidate pairs a slot, one existence exchange for all of them (each
pair travels to its row's owner, which searches its CSR; a pair past an
owner's capacity answers "exists"), the first non-edge kept, and a slot
whose every candidate is an edge keeps its last and is masked out of the
labels (``dist.negative.lost`` counts them).  The positive endpoints and
the negatives then expand as node seeds.

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
The link loader dispatches and finishes the same way.

Ownership is the dataset's `PartitionBook`.  Every dispatch (node, link,
subgraph, walk) first runs owner supervision (the ``partition.owner``
chaos seam: a dead owner's range is adopted from its durable shard under
``GLT_SHARD_DIR``, else written off under ``GLT_DEGRADED_OK``, else a
typed `failover.PartitionLostError`), then the book fence
(`DistNeighborSampler.maybe_refresh_book`), before the draw cursor
advances.  At the identity book an exchange is the plan of the
sampler's layout (``exchange_layout``; dense below 16 partitions,
compact from 16: `exchange.resolve_layout`); the dense one is
`_BookPlan` with one lane a position, the compact and hier ones
`_LayoutPlan`.  Under a moved book every exchange is a `_BookPlan` over
the pinned view, whatever the layout (JAX's rule; the compact and hier
budgets flatten to a per-range capacity): ids bucket to (position, lane)
virtual destinations at the per-range capacity, and each lane samples
its range's rows from its range's sources (`BookLanes`: the live stacks,
or a moved range's payload put on the card once,
`DistDataset.adopted_lane`) at ``draws(..., owner=r)`` — the range, not
the position — so an adopted epoch's batches equal the fault-free run's
under the dense layout.  The kernels are launched once a range a hop
either way.

Each dispatch also counts its traffic by destination RANGE (the
``[P, 2P + 1]`` attribution: frontier ids, feature ids, locally served
feature ids; `ExchangeTelemetry.attribution_matrices`), which the EWMA
capacity model (``GLT_EXCHANGE_EWMA=1``, `capacity_retune` at each epoch
end) and `locality.rebalance_plan` read.  With a replica cache
(`DistDataset.from_full_graph(replica_frac=)`) the replicated rows, and
on an untiered store at the identity book a partition's own rows, skip
the feature exchange and are read from the replica or the shard
(`cache_overlay`).

Random numbers come from a ``draws`` provider, ``draws(step, hop, rows,
k, w, gns, owner=o) -> (u [rows, k], v [rows, k])`` for the GNS sampler
or ``(u [rows, k], gumbel [rows, w])`` for the uniform one, where
``step`` counts dispatches from 1, ``owner`` is the partition that
samples the rows and row ``j`` belongs to the ``j``-th row of that
owner's receive buffer in ascending seed order.  The default
(`TorchDraws`) is a `torch.Generator` on the sampler's device seeded
from ``(seed, step, hop[, owner])``; the parity tests replay the JAX
package's keys instead.  The link sampler's negatives come from the same
provider, ``draws.negatives(step, stream, trials, r, high, part=p)``:
``[trials, r]`` int32 candidates in ``[0, high)`` for partition ``p``,
stream 0 the rows and stream 1 the columns.
"""
from __future__ import annotations

import functools
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
from ..ops.fused_sample import (MAX_WINDOW, sample_one_hop_fused,
                                sample_one_hop_gns_fused)
from ..ops.gather_rows import gather_rows
from ..ops.gns import (cached_set_bits, dedup_requester_bits,
                       fallback_req_index, gns_enabled, resolve_boost)
from ..ops.negative import edge_in_csr, first_non_edge
from ..ops.neighbor import default_window
from ..sampler.base import NegativeSampling
from ..ops.unique import expand_hops
from ..ops.window_gather import csr_window_gather
from ..telemetry.aggregate import exchange_summary
from ..telemetry.live import live
from ..telemetry.recorder import recorder
from ..testing import chaos
from ..utils.padding import INVALID_ID, max_sampled_nodes, round_up
from ..utils.tensor import PinnedStaging
from .dist_data import DistDataset
from .dp import Mesh, make_mesh
from .exchange import (MIN_EXCHANGE_CAP, DensePlan, EwmaCapacityModel,
                       ExchangeSpec, bucket_stacked, capacity_spec,
                       dest_histogram, ewma_enabled, plan_exchange,
                       resolve_layout)
from .partition_book import (BookSpec, book_owner_fn, edge_book_owner_fn,
                             edge_local_rows, edge_owner_fn, hot_split_host,
                             identity_spec, range_owner_fn)

#: per-destination exchange capacity for shuffled seeds, as a multiple
#: of the balanced share (frontier / P)
DEFAULT_EXCHANGE_SLACK = 2.0

#: the exchange counters (offered = valid ids entering an exchange,
#: dropped = valid ids past an owner's capacity, slots = send width;
#: negative.lost = strict-negative slots whose every trial was an edge)
EXCHANGE_STAT_NAMES = (
    'frontier.offered', 'frontier.dropped', 'frontier.slots',
    'feature.offered', 'feature.dropped', 'feature.slots',
    'negative.lost')

#: candidate pairs a strict-negative slot draws
NEG_TRIALS = 5

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


class BookLanes:
  """The sources the exchange's lanes read, by range: ``stacks`` (key ->
  ``() -> [P, ...]`` stacked tensor) give range ``r`` its row ``r``, and
  a range whose shard was adopted or handed off reads its payload on the
  card (``adopted``: range -> key -> tensor, `DistDataset.adopted_lane`).
  ``spec`` is the pinned view's `BookSpec`; `identity` is the identity
  book's over given tables."""

  def __init__(self, spec: BookSpec, stacks: dict, adopted=None):
    self.spec = spec
    self._stacks = stacks
    self._adopted = adopted or {}

  @classmethod
  def identity(cls, num_parts: int, tables: dict) -> 'BookLanes':
    """The identity book over ``tables`` (key -> stacked tensor)."""
    return cls(identity_spec(num_parts),
               {k: (lambda t=t: t) for k, t in tables.items()})

  def get(self, key, r: int) -> torch.Tensor:
    moved = self._adopted.get(r)
    if moved is not None and key in moved:
      return moved[key]
    return self._stacks[key]()[r]


@functools.lru_cache(maxsize=32)
def _lane_ranges(spec: BookSpec, device) -> torch.Tensor:
  """``[P * S]`` int64: the range each (position, lane) row serves (0 for
  an unassigned lane, which nothing routes to)."""
  return torch.tensor([max(r, 0) for row in spec.slot_ranges for r in row],
                      dtype=torch.int64, device=device)


class _BookPlan(DensePlan):
  """The book's exchange (the JAX package's `_BookPlan`): ids bucket to
  the ``P * S`` virtual destinations ``owners[r] * S + lane[r]`` at the
  PER-RANGE capacity, cross as one ``[P_src, P, S * C]`` all-to-all, and
  each (position, lane)'s receive buffer comes out exactly as the range's
  original owner would have received it.  At the identity book (``S =
  1``, range ``r`` at position ``r``) this is the plain dense exchange.

  Attributes beyond `DensePlan`'s: ``recv_lanes`` ``[P * S, P_src *
  C]`` (row ``d * S + j`` is position ``d``'s lane ``j``),
  ``recv_payload_lanes`` beside it, ``lane_range`` (`_lane_ranges`) and
  ``lanes``: ``(row, range)`` of every assigned lane in range order.
  """

  def __init__(self, ids: torch.Tensor, bounds_t: torch.Tensor,
               spec: BookSpec, mesh, capacity: Optional[int] = None,
               payload: Optional[torch.Tensor] = None,
               owner_mode: str = 'range'):
    p, s = int(spec.num_parts), int(spec.num_lanes)
    if ids.ndim != 2 or ids.shape[0] != p:
      raise ValueError(f'the plan takes [{p}, F] ids, got '
                       f'{tuple(ids.shape)}')
    if isinstance(capacity, ExchangeSpec):
      # the per-range capacity of a layout's plan: the dense cap as is;
      # the compact and hier budgets flattened to slots / P, floored
      capacity = (capacity.capacity if capacity.layout == 'dense' else
                  max(round_up(-(-capacity.slots // p), 8), MIN_EXCHANGE_CAP))
    owner = (edge_book_owner_fn(p, spec) if owner_mode == 'mod'
             else book_owner_fn(bounds_t, spec))(ids)
    send, self.slot_p, self.slot_j, *send_pl = bucket_stacked(
        ids, owner, p * s, capacity,
        payload=None if payload is None else payload.to(ids.dtype))
    cap = send.shape[2]
    self.mesh, self.num_parts, self.cap, self._lanes = mesh, p, cap, s

    def lanes_of(x):               # [P_dev, P_src, S * C] -> [P*S, P_src*C]
      return x.reshape(p, p, s, cap).transpose(1, 2).reshape(p * s, p * cap)
    self.recv_payload_lanes = None
    if payload is None:
      self.recv_lanes = lanes_of(mesh.all_to_all(send.reshape(p, p, s * cap)))
    else:
      both = mesh.all_to_all(torch.stack(
          [send.reshape(p, p, s * cap), send_pl[0].reshape(p, p, s * cap)],
          dim=2))
      self.recv_lanes = lanes_of(both[:, :, 0])
      self.recv_payload_lanes = lanes_of(both[:, :, 1])
    self.owned = self.recv_lanes >= 0
    self.kept = self.slot_j >= 0
    self.delivered = self.kept
    self.requester_of_recv = torch.arange(
        p, dtype=torch.int32, device=ids.device).repeat_interleave(cap)
    valid = ids >= 0
    self.stats = torch.stack([
        valid.sum(1), (valid & ~self.kept).sum(1),
        torch.full((p,), p * s * cap, dtype=torch.int64, device=ids.device)],
        dim=1)
    self.lane_range = _lane_ranges(spec, ids.device)
    self.lanes = sorted(((d * s + j, r) for d in range(p) for j in range(s)
                         if (r := spec.slot_ranges[d][j]) >= 0),
                        key=lambda x: x[1])

  def local(self, bounds_t: torch.Tensor, fill) -> torch.Tensor:
    """Every lane's receive ids as its range's local rows (``fill`` where
    empty or not the lane's), ``[P * S, R]``."""
    base = bounds_t[self.lane_range][:, None]
    return torch.where(self.owned, self.recv_lanes - base, fill)

  def stack(self, by_row: dict, fill) -> torch.Tensor:
    """Per-lane values ``{row: [P_src * C, ...]}`` -> ``[P * S, P_src * C,
    ...]``, unassigned lanes filled (nothing routes to them)."""
    t = next(iter(by_row.values()))
    return torch.stack([by_row[i] if i in by_row else torch.full_like(t, fill)
                        for i in range(self.num_parts * self._lanes)])

  def reply(self, values: torch.Tensor, fill=0) -> torch.Tensor:
    """Lane-side ``[P * S, P_src * C, ...]`` values -> ``[P, F, ...]`` in
    each partition's request order."""
    p, s, cap = self.num_parts, self._lanes, self.cap
    trail = tuple(values.shape[2:])
    v = values.reshape((p, s, p, cap) + trail).transpose(1, 2)
    back = self.mesh.all_to_all(v.reshape((p, p, s * cap) + trail))
    return self.stitch(back.reshape((p, p * s, cap) + trail), fill)


class _LayoutPlan(_BookPlan):
  """The identity book's exchange under the compact or hier layout
  (`exchange.plan_exchange`) behind `_BookPlan`'s lane interface: one
  lane a partition, serving its own range.  A compact owner's receive
  buffer also holds every other partition's pool ids: ``owned`` masks
  them out of its local rows (their answers are never read)."""

  def __init__(self, ids: torch.Tensor, bounds_t: torch.Tensor, mesh,
               spec: ExchangeSpec, payload: Optional[torch.Tensor] = None,
               owner_mode: str = 'range'):
    p = mesh.size
    owner_fn = (edge_owner_fn(p) if owner_mode == 'mod'
                else range_owner_fn(bounds_t))
    plan = plan_exchange(ids, owner_fn, p, mesh, spec, payload)
    self._plan, self.mesh, self.num_parts, self._lanes = plan, mesh, p, 1
    self.recv_lanes = plan.recv
    self.recv_payload_lanes = plan.recv_payload
    self.kept, self.delivered = plan.kept, plan.delivered
    self.requester_of_recv = plan.requester_of_recv
    self.stats = plan.stats
    self.lane_range = torch.arange(p, device=ids.device)
    self.lanes = [(d, d) for d in range(p)]
    r = self.recv_lanes
    mine = (torch.remainder(r, p) == self.lane_range[:, None]
            if owner_mode == 'mod' else
            (r >= bounds_t[:-1, None]) & (r < bounds_t[1:, None]))
    self.owned = (r >= 0) & mine

  def reply(self, values: torch.Tensor, fill=0) -> torch.Tensor:
    return self._plan.reply(values, fill)


def _make_plan(ids: torch.Tensor, bounds_t: torch.Tensor, spec: BookSpec,
               mesh, capacity=None, payload: Optional[torch.Tensor] = None,
               owner_mode: str = 'range') -> _BookPlan:
  """The exchange of one request: the layout's plan at the identity book
  (`_LayoutPlan`; dense is `_BookPlan` itself), `_BookPlan` at a moved
  book whatever the layout, as the JAX package routes them."""
  if (spec.is_identity and isinstance(capacity, ExchangeSpec)
      and capacity.layout != 'dense'):
    return _LayoutPlan(ids, bounds_t, mesh, capacity, payload, owner_mode)
  return _BookPlan(ids, bounds_t, spec, mesh, capacity, payload, owner_mode)


def _slack_cap(n: int, num_parts: int, exchange_slack,
               exchange_layout: Optional[str] = None, caps=None):
  """The capacity plan of one ``n``-id exchange under the sampler's slack
  and layout (None = exact); ``caps``: the `EwmaCapacityModel`'s
  ``(dest_cap, traffic_cap)`` for the channel (None: uniform shares)."""
  d, t = caps if caps is not None else (None, None)
  return capacity_spec(n, num_parts, exchange_slack, layout=exchange_layout,
                       dest_cap=d, traffic_cap=t)


def _dist_one_hop(mesh: Mesh, indptr, indices, bounds_t, frontier, k: int,
                  draws: Draws, step: int, hop: int,
                  capacity: Optional[int], gns_bits=None,
                  gns_boost: Optional[float] = None,
                  sort_locality: bool = True, eids_loc=None,
                  etype: Optional[int] = None,
                  book: Optional[BookLanes] = None):
  """One hop for every partition's ``[P, F]`` frontier: exchange, each
  range's rows sampled (in ascending id order with ``sort_locality``,
  else in arrival order) from its CSR, reply.  With ``eids_loc`` (the
  ``[P, E_max]`` int32 global edge ids of the shards) each range also
  returns its slots' ids, ``eids_loc[r][pos]``.  A heterogeneous hop
  passes its edge type's index ``etype`` on to the draws
  (``draws(..., owner=r, etype=etype)``); without it the draws are
  called as before.  The exchange routes per (position, lane) of
  ``book`` (a pinned view's `BookLanes`; None: the identity book over
  ``indptr``, ``indices`` and ``eids_loc``), and each lane samples its
  RANGE's rows from the range's sources at ``draws(..., owner=r)``, so
  its samples equal the range's original owner's: one kernel launch a
  range.
  Returns ``(nbrs, mask, eids, weights, stats)``, the first four stacked
  ``[P, F, k]`` (``eids`` None without ``eids_loc``, -1 where masked or
  undelivered; ``weights`` None without GNS) and the ``[3]`` exchange
  counters summed over the partitions."""
  with_edge = eids_loc is not None
  if book is None:
    book = BookLanes.identity(mesh.size, {'indptr': indptr,
                                          'indices': indices,
                                          'eids': eids_loc})
  plan = _make_plan(frontier, bounds_t, book.spec, mesh, capacity)
  local = plan.local(bounds_t, INVALID_ID).to(torch.int32)
  rows = local.shape[1]
  w = default_window(k)
  req = plan.requester_of_recv
  if gns_bits is not None and req is None:
    # hier's stage-2 rows have no requester: the hot-split-only row
    req = torch.full((rows,), fallback_req_index(gns_bits),
                     dtype=torch.int32, device=frontier.device)
  et = {} if etype is None else {'etype': etype}
  res = {}
  for row, r in plan.lanes:
    edge = (dict(edge_ids=book.get('eids', r), with_edge_ids=True)
            if with_edge else {})
    indptr_r, indices_r = book.get('indptr', r), book.get('indices', r)
    if gns_bits is not None:
      u, v = draws(step, hop, rows, k, w, True, owner=r, **et)
      res[row] = sample_one_hop_gns_fused(
          indptr_r, indices_r, local[row], k, u, v, gns_bits, gns_boost,
          req=req, window=w, sort_locality=sort_locality,
          **edge)
    else:
      u, g = draws(step, hop, rows, k, w, False, owner=r, **et)
      res[row] = sample_one_hop_fused(indptr_r, indices_r, local[row], k, u,
                                      g, sort_locality=sort_locality, **edge)

  def reply(field, fill):
    return plan.reply(plan.stack({i: getattr(x, field)
                                  for i, x in res.items()}, fill), fill)
  return (reply('nbrs', INVALID_ID), reply('mask', False),
          reply('eids', INVALID_ID) if with_edge else None,
          reply('weights', 0.0) if gns_bits is not None else None,
          plan.stats.sum(0))


def _dist_window_hop(mesh: Mesh, indptr, indices, bounds_t, frontier,
                     width: int, capacity: Optional[int], eids_loc=None,
                     book: Optional[BookLanes] = None):
  """The exact full-window hop for every partition's ``[P, F]``
  frontier: exchange, each range answers its receive rows with their
  first ``width`` CSR slots (the window gather kernel from ``indptr[row]``,
  a second call over ``eids_loc`` for the edge ids), the slots at or
  past a row's degree masked, reply.  Exact when no row's degree passes
  ``width``; no draw is taken.  Returns ``(nbrs, mask, eids, stats)``,
  the first three ``[P, F, width]`` (``eids`` None without
  ``eids_loc``) and the ``[3]`` exchange counters.  ``book``: as
  `_dist_one_hop`."""
  with_edge = eids_loc is not None
  if book is None:
    book = BookLanes.identity(mesh.size, {'indptr': indptr,
                                          'indices': indices,
                                          'eids': eids_loc})
  plan = _make_plan(frontier, bounds_t, book.spec, mesh, capacity)
  ok = plan.owned
  local = plan.local(bounds_t, 0)
  lane = torch.arange(width, dtype=torch.int64, device=frontier.device)
  starts, mask = {}, {}
  for row, r in plan.lanes:
    indptr_r = book.get('indptr', r)
    starts[row] = indptr_r[local[row]]
    deg = torch.where(ok[row], indptr_r[local[row] + 1] - starts[row], 0)
    mask[row] = lane[None, :] < deg[:, None]

  def windows(key):
    win = {row: torch.where(mask[row], csr_window_gather(
        book.get(key, r), starts[row], width), INVALID_ID)
           for row, r in plan.lanes}
    return plan.reply(plan.stack(win, INVALID_ID), fill=INVALID_ID)
  out_n = windows('indices')
  out_e = windows('eids') if with_edge else None
  out_m = plan.reply(plan.stack(mask, False), fill=False)
  return out_n, out_m, out_e, plan.stats.sum(0)


def dist_gather_multi(mesh: Mesh, shards, bounds, ids,
                      capacity: Optional[int] = None, hot_counts=None,
                      shard_mode: str = 'range',
                      book: Optional[BookLanes] = None, book_keys=()):
  """Row gather from several sharded tables sharing one exchange, for
  every partition's ``[P, F]`` ids: ``out_t[p, i] = table_t[ids[p, i]]``
  (zero rows for invalid or undelivered ids).  ``shards`` are stacked
  ``[P, rows, ...]`` tables, owned by the ranges of ``bounds``
  (``shard_mode='range'``) or by ``id % P`` at row ``id // P``
  (``'mod'``: the edge-feature tables of `build_dist_edge_feature`);
  with ``hot_counts`` (``[P]``) the FIRST is the hot tier: rows at or
  past the RANGE's hot count come back zero (the cold overlay fills
  them; placement never moves).  Each range's read is the row gather
  kernel (a ``[P, rows]`` table is read as ``[rows, 1]``).  Returns
  ``(outs, stats)``, ``stats`` the ``[3]`` counters summed over the
  partitions.  Under a pinned view's `BookLanes` (``book``) table ``t``
  is read, lane by lane, from the book's source ``book_keys[t]``; None
  is the identity book over ``shards``."""
  if shard_mode not in ('range', 'mod'):
    raise ValueError(f'unknown shard_mode {shard_mode!r}')
  p = mesh.size
  if book is None:
    book, book_keys = BookLanes.identity(p, dict(enumerate(shards))), \
        range(len(shards))
  bounds_t = int64_on(bounds, ids.device)
  plan = _make_plan(ids, bounds_t, book.spec, mesh, capacity,
                    owner_mode=shard_mode)
  valid = plan.owned
  local = (torch.where(valid, edge_local_rows(plan.recv_lanes, p), 0)
           if shard_mode == 'mod' else plan.local(bounds_t, 0))
  ok = (ids >= 0) & plan.delivered
  hot = (None if hot_counts is None else
         int64_on(hot_counts, ids.device)[plan.lane_range][:, None])
  outs = []
  for t, (key, shard) in enumerate(zip(book_keys, shards)):
    row_valid = valid if t or hot is None else valid & (local < hot)
    idx = torch.where(row_valid, local, INVALID_ID)
    rows = {}
    for row, r in plan.lanes:
      table = book.get(key, r)
      rows[row] = gather_rows(table if shard.ndim == 3 else table[:, None],
                              idx[row])
    out = plan.reply(plan.stack(rows, 0), fill=0)
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


def dist_edge_exists(mesh: Mesh, indptr, indices, bounds_t, rows, cols,
                     capacity: Optional[int] = None,
                     book: Optional[BookLanes] = None) -> torch.Tensor:
  """Is ``(rows[p, i], cols[p, i])`` an edge of the global graph, for
  every partition's ``[P, F]`` pairs?  Each pair travels to its row's
  range beside its column (one exchange each way), which answers with
  `ops.negative.edge_in_csr` over its CSR.  A pair past a range's
  ``capacity`` answers True ("exists"), so it is never kept as a strict
  negative.  ``book``: as `_dist_one_hop`."""
  if book is None:
    book = BookLanes.identity(mesh.size, {'indptr': indptr,
                                          'indices': indices})
  plan = _make_plan(rows, bounds_t, book.spec, mesh, capacity, payload=cols)
  local = plan.local(bounds_t, INVALID_ID)
  ex = {row: edge_in_csr(book.get('indptr', r), book.get('indices', r),
                         local[row], plan.recv_payload_lanes[row])
        for row, r in plan.lanes}
  return plan.reply(plan.stack(ex, True), fill=True)


def dist_sample_negative(mesh: Mesh, indptr, indices, bounds_t,
                         num_rows: int, num_cols: int, req_num: int,
                         draws, step: int, trials: int = NEG_TRIALS,
                         capacity: Optional[int] = None,
                         rows_fixed: Optional[torch.Tensor] = None,
                         book: Optional[BookLanes] = None):
  """``req_num`` strict negative pairs a partition over the sharded
  graph: ``trials`` candidate pairs a slot from ``draws.negatives(step,
  stream, trials, req_num, high, part=p)`` (stream 0 rows in ``[0,
  num_rows)``, stream 1 columns in ``[0, num_cols)``), ONE existence
  exchange for all trials, each slot's first non-edge.  Returns ``(rows,
  cols, ok)``, each ``[P, req_num]``: ``ok`` is False where every trial
  was an edge (the slot keeps the last trial's pair, which may be an
  edge; consumers mask it out).  ``rows_fixed`` (``[P, req_num]``) pins
  each slot's row (triplet mode's negatives of a source).  ``book``: as
  `dist_edge_exists`."""
  parts = mesh.size
  if rows_fixed is None:
    rows = torch.stack([draws.negatives(step, 0, trials, req_num, num_rows,
                                        part=p) for p in range(parts)])
  else:
    rows = rows_fixed[:, None, :].expand(parts, trials, req_num)
  cols = torch.stack([draws.negatives(step, 1, trials, req_num, num_cols,
                                      part=p) for p in range(parts)])
  rows = rows.to(torch.int32)
  exists = dist_edge_exists(
      mesh, indptr, indices, bounds_t, rows.reshape(parts, -1),
      cols.reshape(parts, -1), capacity, book=book).reshape(parts, trials,
                                                            req_num)
  pick = torch.stack([first_non_edge(e) for e in exists])[:, None, :]
  ok = (~exists).any(dim=1)
  return (rows.gather(1, pick)[:, 0], cols.gather(1, pick)[:, 0], ok)


def cache_overlay(x: torch.Tensor, hit: torch.Tensor, rows: torch.Tensor,
                  table: torch.Tensor) -> torch.Tensor:
  """``x[p, i] = table[p, rows[p, i]]`` where ``hit[p, i]`` (the JAX
  package's `cache_overlay`: a partition's replica rows, or its own
  shard's rows, over the exchanged ones), each partition's read by the
  row gather kernel."""
  got = torch.stack([gather_rows(table[q], torch.where(hit[q], rows[q], -1))
                     for q in range(x.shape[0])])
  return torch.where(hit[..., None], got, x)


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
  package's); the one slack sizes every capacity of the sampler's
  layout.

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
  DROP_KEYS = ('dist.frontier.dropped', 'dist.feature.dropped',
               'dist.negative.lost')

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
    if resolve_layout(self.sampler.exchange_layout,
                      self.sampler.num_parts) == 'hier':
      # hier counts an id once a stage in 'offered': the same per-id
      # loss reads up to half the rate
      tol = ADAPTIVE_DROP_TOLERANCE / 2
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

  # -- the ladder's position (JAX's `DataPlaneState` fields) ---------------
  def state_dict(self) -> dict:
    """The rung index, the pin and its reason, and the rung the last
    tighten came from (-1 for none).  The counter baselines are not
    kept: they refer to this process's cumulative counters, so
    `load_state_dict` takes them afresh from the sampler."""
    return {'idx': self._idx, 'pinned': int(self._pinned),
            'pin_reason': self._pin_reason,
            'tightened_from': (-1 if self._tightened_from is None
                               else int(self._tightened_from))}

  def load_state_dict(self, state: dict) -> None:
    idx = int(np.asarray(state['idx']))
    if idx != self._idx:
      self._set(idx, reason='restore')
    self._pinned = bool(int(np.asarray(state['pinned'])))
    self._pin_reason = str(np.asarray(state['pin_reason']))
    tf = int(np.asarray(state['tightened_from']))
    self._tightened_from = None if tf < 0 else tf
    st = self.sampler.exchange_stats()
    self._last = {k: st[k] for k in self.OFFER_KEYS + self.DROP_KEYS}


class ExchangeTelemetry:
  """The mesh samplers' exchange and cold-tier counters (the JAX
  package's `ExchangeTelemetry`): a device accumulator of the
  `EXCHANGE_STAT_NAMES` counters, drained into host totals by
  `exchange_stats` under a lock (a drain may race a dispatch on a
  prefetch worker), and the host's `COLD_STAT_NAMES` counters."""

  def _init_stats(self, device) -> None:
    self._stats_lock = threading.Lock()
    self._stats_acc = torch.zeros(len(EXCHANGE_STAT_NAMES),
                                  dtype=torch.int64, device=device)
    self._stats_total = np.zeros(len(EXCHANGE_STAT_NAMES), np.int64)
    self._feat_lookups = self._cold_lookups = self._cold_misses = 0
    self._cache_hits = self._cache_admits = self._cache_evicts = 0
    self._cold_reported = (0,) * len(COLD_STAT_NAMES)
    # the src -> dst range attribution: a [P, 2P + 1] device accumulator
    # (frontier ids by destination range, feature ids by destination
    # range, the ids served without the exchange), drained with the
    # counters into host totals
    self._attr_acc = None
    self._attr_total: Optional[np.ndarray] = None
    self._attr_reported = (0, 0)

  def _accumulate_stats(self, stats: torch.Tensor) -> None:
    """Fold the first ``len(stats)`` exchange counters
    (`EXCHANGE_STAT_NAMES`) into the device accumulator `exchange_stats`
    drains."""
    with self._stats_lock:
      self._stats_acc[:stats.shape[0]] += stats

  def _accumulate_attr(self, frontier: torch.Tensor,
                       feature: Optional[torch.Tensor] = None,
                       served: Optional[torch.Tensor] = None) -> None:
    """Fold one dispatch's ``[P, P]`` frontier and feature destination
    histograms (`exchange.dest_histogram`) and ``[P]`` locally served
    feature ids into the attribution accumulator."""
    p = frontier.shape[0]
    z = torch.zeros((p, p), dtype=torch.int64, device=frontier.device)
    tail = torch.cat([frontier, z if feature is None else feature,
                      (torch.zeros((p, 1), dtype=torch.int64,
                                   device=frontier.device)
                       if served is None else served.reshape(p, 1))], 1)
    with self._stats_lock:
      self._attr_acc = tail if self._attr_acc is None \
          else self._attr_acc + tail

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
    did, with the JAX package's fields.  The JAX package's
    ``dist.feature.cold_hit_rate`` alias of ``cache_hit_rate`` is not
    carried.
    """
    with self._stats_lock:
      acc = self._stats_acc
      self._stats_acc = torch.zeros_like(acc)
      delta = acc.cpu().numpy().astype(np.int64)
      self._stats_total += delta
      attr, self._attr_acc = self._attr_acc, None
      if attr is not None:
        a = attr.cpu().numpy().astype(np.int64)
        if self._attr_total is None or self._attr_total.shape != a.shape:
          self._attr_total = np.zeros_like(a)
        self._attr_total += a
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

  # -- traffic attribution (the JAX package's `ExchangeTelemetry`) ---------
  def _stats_state(self) -> np.ndarray:
    """The cumulative counters as one int64 vector: the exchange totals,
    the cold-tier counters, then the flattened ``[P, 2P + 1]``
    attribution matrix (absent before any dispatch)."""
    self.exchange_stats(tick_metrics=False)
    with self._stats_lock:
      cold = (self._feat_lookups, self._cold_lookups, self._cold_misses,
              self._cache_hits, self._cache_admits, self._cache_evicts)
      parts = [self._stats_total, np.asarray(cold, np.int64)]
      if self._attr_total is not None:
        parts.append(self._attr_total.reshape(-1))
      return np.concatenate(parts)

  def _load_stats_state(self, packed) -> None:
    """Restore `_stats_state`; a vector from before the attribution tail
    (13 counters) restores the counters and restarts the matrix cold."""
    arr = np.asarray(packed, np.int64)
    n = len(EXCHANGE_STAT_NAMES)
    with self._stats_lock:
      self._stats_acc = torch.zeros_like(self._stats_acc)
      self._attr_acc = None
      self._stats_total = arr[:n].copy()
      (self._feat_lookups, self._cold_lookups, self._cold_misses,
       self._cache_hits, self._cache_admits,
       self._cache_evicts) = (int(v) for v in arr[n:n + 6])
      tail = arr[n + 6:]
      self._attr_total = (tail.reshape(-1, 2 * self.num_parts + 1).copy()
                          if tail.size else None)
      # the ticked watermark never passes the rewound counters
      self._cold_reported = tuple(min(r, int(v)) for r, v in zip(
          self._cold_reported, arr[n:n + 6]))

  def attribution_matrices(self) -> Tuple[np.ndarray, np.ndarray]:
    """``(frontier, feature)``: two ``[P, P]`` int64 id counts, row = the
    requesting partition, column = the destination RANGE (so a column
    keeps meaning "range r" under a moved book).  Drains the device
    accumulator."""
    self.exchange_stats(tick_metrics=False)
    with self._stats_lock:
      tot = self._attr_total
      if tot is None:
        z = np.zeros((self.num_parts, self.num_parts), np.int64)
        return z, z.copy()
      p = tot.shape[1] // 2
      return tot[:, :p].copy(), tot[:, p:2 * p].copy()

  def replica_hits(self) -> int:
    """Feature lookups served without the exchange: replica hits and the
    owner bypass's own rows (0 without a replica cache)."""
    self.exchange_stats(tick_metrics=False)
    with self._stats_lock:
      tot = self._attr_total
      return 0 if tot is None else int(tot[:, -1].sum())

  def attribution_stats(self, top_k: Optional[int] = None,
                        feature_row_bytes: Optional[int] = None,
                        tick_metrics: bool = True) -> dict:
    """The traffic rollup (the JAX package's `attribution_stats`):
    frontier ids weigh 4 B, feature ids one feature row.  A cell is local
    when the book routes its range to its row's partition (the diagonal
    at the identity book); locally served feature ids count as local.
    ``hot_ranges`` prefers the GNS sketches' range mass
    (``hotness_source: 'gns_sketch'``), else the matrices' column mass.
    With ``tick_metrics`` the ``exchange.local_ids_total`` and
    ``exchange.cross_ids_total`` counters tick by their deltas."""
    fr, ft = self.attribution_matrices()
    p = int(fr.shape[0])
    if feature_row_bytes is None:
      feature_row_bytes = 4
      nf = self.ds.node_features
      if nf is not None:
        feature_row_bytes = int(nf.shards.shape[-1]) * int(
            nf.shards.element_size())
    ids = fr + ft
    bytes_m = fr * 4 + ft * int(feature_row_bytes)
    owners = np.asarray(self.book.view().owners)
    local_mask = owners[None, :] == np.arange(p)[:, None]
    rep = self.replica_hits()
    total_ids = int(ids.sum()) + rep
    local_ids = int(ids[local_mask].sum()) + rep
    cross_ids = total_ids - local_ids
    rep_bytes = rep * int(feature_row_bytes)
    total_bytes = int(bytes_m.sum()) + rep_bytes
    cross_bytes = total_bytes - (int(bytes_m[local_mask].sum()) + rep_bytes)
    mass, source = None, 'exchange'
    cache = getattr(self, '_cold_cache', None)
    if cache is not None and cache.shards:
      ms = [sh.sketch.range_mass for sh in cache.shards
            if sh.sketch.range_mass is not None]
      if ms:
        agg = np.sum(ms, axis=0)
        if float(agg.sum()) > 0 and len(agg) == p:
          mass, source = agg.astype(np.float64), 'gns_sketch'
    if mass is None:
      mass = ids.sum(axis=0).astype(np.float64)
    total_mass = float(mass.sum())
    k = min(max(1, p // 4) if top_k is None else max(int(top_k), 1),
            max(p, 1))
    hot, coverage = [], 0.0
    if p and total_mass > 0:
      order = np.argsort(-mass, kind='stable')[:k]
      hot = [{'partition': int(r),
              'share': round(float(mass[r] / total_mass), 6)}
             for r in order]
      coverage = round(float(mass[order].sum() / total_mass), 6)
    if tick_metrics:
      d_local = max(local_ids - self._attr_reported[0], 0)
      d_cross = max(cross_ids - self._attr_reported[1], 0)
      self._attr_reported = (local_ids, cross_ids)
      if d_local:
        live.counter('exchange.local_ids_total').inc(d_local)
      if d_cross:
        live.counter('exchange.cross_ids_total').inc(d_cross)
    return {
        'num_parts': p,
        'feature_row_bytes': int(feature_row_bytes),
        'frontier_ids': fr.tolist(),
        'feature_ids': ft.tolist(),
        'bytes_matrix': bytes_m.tolist(),
        'local_ids': local_ids,
        'locally_served_ids': rep,
        'cross_ids': cross_ids,
        'cross_partition_ids_frac': (round(cross_ids / total_ids, 6)
                                     if total_ids else 0.0),
        'total_bytes': total_bytes,
        'cross_partition_bytes': cross_bytes,
        'cross_partition_bytes_frac': (round(cross_bytes / total_bytes, 6)
                                       if total_bytes else 0.0),
        'hotness_source': source,
        'top_k': k if p else 0,
        'hot_ranges': hot,
        'hot_range_coverage': coverage,
    }

  def _ewma_caps(self):
    """Per-channel ``(dest_cap, traffic_cap)``, or None while the EWMA
    model is off or has observed nothing (uniform shares)."""
    m = getattr(self, '_ewma_model', None)
    if m is None:
      return None
    caps = {c: m.caps(c) for c in m.CHANNELS}
    return caps if any(v != (None, None) for v in caps.values()) else None

  def _channel_cap(self, n: int, channel: Optional[str] = None):
    """`_slack_cap` of an ``n``-id exchange under this sampler's slack,
    layout and (for ``channel`` ``'frontier'`` / ``'feature'``) EWMA
    caps."""
    caps = self._ewma_caps()
    return _slack_cap(n, self.num_parts, self.exchange_slack,
                      self.exchange_layout,
                      caps.get(channel) if caps and channel else None)

  def capacity_retune(self) -> bool:
    """The epoch-end seam of the EWMA capacity model
    (``GLT_EXCHANGE_EWMA=1``): feed it the attribution deltas since the
    last retune; True (and an ``exchange.retune`` event) when a quantized
    cap moved, which the next dispatch's capacity plans read."""
    m = getattr(self, '_ewma_model', None)
    if m is None:
      return False
    steps = int(self._step_cnt)
    d_steps = steps - self._ewma_last_steps
    if d_steps <= 0:
      return False
    fr, ft = self.attribution_matrices()
    last = self._ewma_last
    d_fr = fr - last[0] if last is not None else fr
    d_ft = ft - last[1] if last is not None else ft
    self._ewma_last = (fr, ft)
    self._ewma_last_steps = steps
    changed = m.observe('frontier', d_fr, d_steps)
    changed = m.observe('feature', d_ft, d_steps) or changed
    if changed:
      caps = {c: m.caps(c) for c in m.CHANNELS}
      recorder.emit('exchange.retune', steps=d_steps,
                    frontier_dest_cap=caps['frontier'][0],
                    frontier_traffic_cap=caps['frontier'][1],
                    feature_dest_cap=caps['feature'][0],
                    feature_traffic_cap=caps['feature'][1])
    return changed

  def cluster_exchange_stats(self) -> dict:
    """`exchange_stats` plus ``num_hosts`` and the derived padding-waste
    and drop-rate keys (`telemetry.aggregate.exchange_summary`).  The
    port's mesh runs in one process, so the cluster is this host."""
    st = dict(self.exchange_stats())
    st['num_hosts'] = 1
    st.update(exchange_summary(st))
    return st


class DistNeighborSampler(ExchangeTelemetry):
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
    with_edge: also return each sampled edge's global id (``edge``) and,
      when the dataset has edge features and ``collect_features``, its
      row (``edge_attr``).
    draws: the draws provider (module docstring).
    exchange_layout: the exchange layout (`exchange.resolve_layout`;
      None / ``'auto'``: dense below 16 partitions, compact from 16).
  """

  def __init__(self, dataset: DistDataset, num_neighbors,
               mesh: Optional[Mesh] = None, collect_features: bool = True,
               seed: int = 0, exchange_slack: Optional[float] = None,
               cold_cache_rows='auto', gns=None,
               draws: Optional[Draws] = None, device='cuda',
               with_edge: bool = False,
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
    self.fanouts = tuple(int(k) for k in num_neighbors)
    self.num_parts = dataset.num_partitions
    self.collect_features = (collect_features
                             and dataset.node_features is not None)
    self.collect_labels = dataset.node_labels is not None
    self.with_edge = bool(with_edge)
    self.collect_edge_features = (collect_features and self.with_edge
                                  and dataset.edge_features is not None)
    self._eids = None
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
    self._gns_inflight = None
    self.exchange_slack = exchange_slack
    self.exchange_layout = exchange_layout or 'auto'
    # the replica cache (`DistDataset.from_full_graph(replica_frac=)`):
    # its rows are exact copies of remote rows, so with ``cache_local``
    # the feature gather masks them out of the exchange and overlays
    # them; a gather that carries labels too keeps the full exchange
    nf = dataset.node_features
    self.with_cache = self.collect_features and nf.has_cache
    self.cache_local = bool(self.with_cache and nf.cache_local
                            and not self.collect_labels)
    # the EWMA capacity model (``GLT_EXCHANGE_EWMA=1``), fed at each
    # epoch end (`capacity_retune`)
    self._ewma_model = (EwmaCapacityModel(self.num_parts)
                        if ewma_enabled() else None)
    self._ewma_last = None
    self._ewma_last_steps = 0
    self.draws = draws if draws is not None else TorchDraws(seed,
                                                            self.device)
    self._step_cnt = 0
    self._bounds_t = int64_on(dataset.graph.bounds, self.device)
    self._hot_t = (int64_on(dataset.node_features.hot_counts,
                                 self.device) if self.tiered else None)
    self._staging = PinnedStaging() if self.device.type == 'cuda' else None
    self._init_stats(self.device)
    #: host seconds of the cold overlay by part (`OVERLAY_PARTS`), summed
    #: since construction; a caller resets it to read a window
    self.overlay_secs = dict.fromkeys(OVERLAY_PARTS, 0.0)
    #: the routing authority, shared with every reader of the dataset;
    #: the sampler pins one view a dispatch (`maybe_refresh_book`) and its
    #: lanes' sources (None while the book is the identity)
    self.book = dataset.partition_book
    self._book_view = None
    self._book_lanes: Optional[BookLanes] = None
    self._degraded_partitions = dataset.degraded_partitions
    self._degraded_seen = len(self._degraded_partitions)
    self._adopt_pending_t0 = None
    self._shard_store = None
    # the load-time durable copy: with GLT_SHARD_DIR set the shards are
    # written now, so an owner lost later adopts from this copy
    self._resolve_shard_store()

  def node_capacity(self, batch_size: int) -> int:
    cap = max_sampled_nodes(batch_size, self.fanouts)
    cap = min(cap, batch_size + self.ds.graph.num_nodes)
    return round_up(cap, 8)

  def _edge_ids(self) -> torch.Tensor:
    """The shards' global edge ids as one ``[P, E_max]`` int32 copy (the
    kernels' edge-id arm reads int32), made once."""
    if self._eids is None:
      eids = self.ds.graph.edge_ids
      top = int(eids.max()) if eids.numel() else -1
      if top >= (1 << 31) - 1:
        raise ValueError(f'{top + 1} edges: the global edge ids do not fit '
                         'the int32 ids the samplers write')
      self._eids = eids.to(torch.int32).contiguous()
    return self._eids

  def sample_from_nodes(self, seeds_stacked: np.ndarray) -> dict:
    """``[P, B]`` per-partition seed batches (relabelled ids, -1 padded)
    -> the stacked batch pieces."""
    return self._finish_nodes(self._dispatch_nodes(seeds_stacked))

  def _dispatch_nodes(self, seeds_stacked: np.ndarray) -> dict:
    """Sample and collect one stacked batch on the card, every
    partition hop by hop in lockstep, without the cold overlay.  Owner
    supervision and the book fence run before the draw cursor advances
    (a recovered dispatch draws as the fault-free one did)."""
    self._fence()
    self._step_cnt += 1
    seeds = torch.from_numpy(np.asarray(seeds_stacked, np.int32)).to(
        self.device)
    out = self._sample_collect(seeds, self.draws, self._step_cnt)
    self._complete_recovery()
    return out

  # -- partition failover ---------------------------------------------------
  def _fence(self) -> None:
    """The dispatch seam: owner supervision, then the book fence."""
    self._partition_supervision()
    self.maybe_refresh_book()

  def _resolve_shard_store(self):
    """The durable `failover.ShardStore` under ``GLT_SHARD_DIR`` (None:
    failover off).  Its first resolution writes the dataset's shards
    unless the store already holds this graph's (by shape and
    fingerprint); once a dataset."""
    if self._shard_store is not None:
      return self._shard_store
    from .failover import ShardStore, dataset_fingerprint, shard_dir_from_env
    d = shard_dir_from_env()
    if d is None:
      return None
    store = ShardStore(d)
    g = self.ds.graph
    if not getattr(self.ds, '_shards_written', False):
      meta = store.meta()
      stale = (meta is None
               or meta.get('num_parts') != self.num_parts
               or meta.get('num_nodes') != int(g.num_nodes)
               or meta.get('node_width') != int(g.indptr.shape[1])
               or int(meta.get('edge_width', 0)) > int(g.indices.shape[1])
               or meta.get('fingerprint') not in
               (None, dataset_fingerprint(self.ds)))
      if stale:
        store.write_dataset_shards(self.ds)
    self.ds._shards_written = True
    self._shard_store = store
    return store

  def _partition_supervision(self) -> None:
    """The ``partition.owner`` chaos seam at every dispatch: a kill
    classifies that owner dead and runs the recovery ladder — adopt (a
    durable shard exists), else degraded (``GLT_DEGRADED_OK=1``), else a
    typed `PartitionLostError`.  After an adoption the same dispatch
    proceeds."""
    from .failover import PartitionLostError
    try:
      chaos.partition_owner_check(step=self._step_cnt + 1)
    except PartitionLostError as e:
      self._on_partition_lost(e)

  def _on_partition_lost(self, err) -> None:
    """One owner classified dead: the fallback ladder."""
    from ..distributed.resilience import degraded_ok
    from .failover import NoDurableShardError, adopt_shard
    from .partition_book import AdoptionRefusedError
    p = int(err.partition or 0)
    if p in self._degraded_partitions:
      return                          # already written off
    if int(self.book.view().owners[p]) != p:
      return                          # already adopted: the reader fences
    t0 = time.monotonic()
    try:
      info = adopt_shard(self.ds, self._resolve_shard_store(), p)
    except (NoDurableShardError, AdoptionRefusedError) as e:
      if not degraded_ok():
        raise type(err)(
            f'partition {p} lost and adoption is unavailable ({e}); set '
            'GLT_SHARD_DIR for elastic failover or GLT_DEGRADED_OK=1 for '
            'reduced completion', partition=p) from e
      self._enter_degraded(p)
      return
    self._adopt_pending_t0 = (t0, p, info['survivor'])
    recorder.emit('peer.lost', peer=p, peer_kind='partition',
                  degraded=False, adopted=True, survivor=info['survivor'])

  def _enter_degraded(self, p: int) -> None:
    """The ``GLT_DEGRADED_OK`` fallback: the orphaned range's CSR row and
    feature shard are emptied in place (its expansions vanish from the
    epoch and its nodes read zero rows), flagged ``peer.lost
    degraded=True``."""
    self._degraded_partitions.add(p)
    g = self.ds.graph
    g.indptr[p] = 0
    g.indices[p] = -1
    g.edge_ids[p] = -1
    nf = self.ds.node_features
    if nf is not None:
      nf.shards[p] = 0
      if nf.cold_host is not None:
        b = np.asarray(g.bounds, np.int64)
        nf.cold_host[b[p]:b[p + 1]] = 0
    recorder.emit('peer.lost', peer=p, peer_kind='partition', degraded=True,
                  adopted=False)
    self.maybe_refresh_book()

  def _complete_recovery(self) -> None:
    """The first dispatch after an adoption closes the recovery clock
    (classification -> dispatched batch) into the
    ``partition.recovery_secs`` gauge and a ``partition.adopt`` event of
    phase ``recovered``."""
    pending = self._adopt_pending_t0
    if pending is None:
      return
    t0, p, survivor = pending
    self._adopt_pending_t0 = None
    secs = time.monotonic() - t0
    live.gauge('partition.recovery_secs', fn=lambda: secs)
    recorder.emit('partition.adopt', partition=p, survivor=survivor,
                  version=self.book.version, phase='recovered',
                  secs=round(secs, 6))

  def maybe_refresh_book(self) -> int:
    """The book fence: when the shared `PartitionBook` published a newer
    view (or a range was written off), pin it, rebuild the lanes'
    sources (`book_lanes`) and invalidate what derives from the
    placement (the GNS bitmask, the int32 edge-id copy).  Readers hold
    one view a dispatch; a move mid-dispatch is seen at the next one."""
    ver = self.book.version
    ndeg = len(self._degraded_partitions)
    view = self._book_view
    if view is not None and view.version == ver and \
        ndeg == self._degraded_seen:
      return ver
    if ndeg != self._degraded_seen:
      self._eids = None
    self._book_view = view = self.book.view()
    self._degraded_seen = ndeg
    self._book_lanes = self.book_lanes(view)
    self._gns_ver = -1
    return ver

  @property
  def book_spec(self) -> Optional[BookSpec]:
    """The pinned view's routing tables (None: the identity book)."""
    if self._book_view is None:
      self.maybe_refresh_book()
    return self._book_view.spec()

  def book_lanes(self, view) -> Optional[BookLanes]:
    """The sources of a moved ``view``'s lanes: the live stacks, and
    the adopted ranges' payloads on the card (`DistDataset.adopted_lane`);
    None for the identity book (each exchange reads the tables it is
    given)."""
    spec = view.spec()
    if spec is None:
      return None
    ds = self.ds
    stacks = {'indptr': lambda: ds.graph.indptr,
              'indices': lambda: ds.graph.indices, 'eids': self._edge_ids}
    if ds.node_features is not None:
      stacks['fshard'] = lambda: ds.node_features.shards
    if ds.node_labels is not None:
      stacks['lshard'] = lambda: ds.node_labels
    if ds.edge_features is not None:
      stacks['efshard'] = lambda: ds.edge_features.shards
    moved = {r: ds.adopted_lane(r) for r in range(spec.num_parts)
             if spec.owners[r] != r}
    return BookLanes(spec, stacks, moved)

  def _sample_collect(self, seeds: torch.Tensor, draws: Draws,
                      step: int, with_edge: Optional[bool] = None) -> dict:
    """`_dispatch_nodes` for ``[P, B]`` int32 seeds on the card, drawing
    from ``draws`` at ``step`` (the fused mesh epochs pass their own);
    ``with_edge=False`` expands without edge ids whatever the sampler's
    flag (the subgraph sampler's closure)."""
    b = seeds.shape[1]
    bits = self._gns_arrays() if self.gns else None
    book = self._book_lanes
    g = self.ds.graph
    with_edge = self.with_edge if with_edge is None else with_edge
    eids = self._edge_ids() if with_edge else None
    node_cap = self.node_capacity(b)
    hws, hes = [], []
    fr_stats = torch.zeros(3, dtype=torch.int64, device=self.device)
    p = self.num_parts
    range_owner = range_owner_fn(self._bounds_t)
    attr_fr = torch.zeros((p, p), dtype=torch.int64, device=self.device)
    attr_ft = torch.zeros_like(attr_fr)

    def one_hop(h, frontier, k):
      attr_fr.add_(dest_histogram(frontier, range_owner, p))
      nbrs, mask, he, hw, hstats = _dist_one_hop(
          self.mesh, g.indptr, g.indices, self._bounds_t, frontier, k,
          draws, step, h, self._channel_cap(frontier.shape[1], 'frontier'),
          gns_bits=bits, gns_boost=self.gns_boost, eids_loc=eids, book=book)
      fr_stats.add_(hstats)
      hws.append(hw)
      hes.append(he)
      return nbrs, mask

    state, seed_local, rows_acc, cols_acc, nsn = expand_hops(
        seeds, self.fanouts, node_cap, one_hop)
    out = dict(node=state.nodes, node_count=state.count,
               row=torch.cat(rows_acc, dim=1),
               col=torch.cat(cols_acc, dim=1), seed_local=seed_local,
               x=None, y=None, edge=None, ef=None, num_sampled_nodes=nsn,
               batch=seeds)
    # induce_next flattens [F, k] row-major: the edge ids and weights
    # line up with the edge list; masked and dropped edges carry -1 / 0
    if with_edge:
      out['edge'] = torch.cat(
          [torch.where(rows >= 0, he.reshape(rows.shape), INVALID_ID)
           for rows, he in zip(rows_acc, hes)], dim=1)
    if self.gns:
      out['edge_weight'] = torch.cat(
          [torch.where(rows >= 0, hw.reshape(rows.shape), 0.0)
           for rows, hw in zip(rows_acc, hws)], dim=1)
    ft_stats = torch.zeros(3, dtype=torch.int64, device=self.device)
    if self.collect_edge_features and with_edge:
      ef = self.ds.edge_features
      (out['ef'],), estats = dist_gather_multi(
          self.mesh, (ef.shards,), ef.bounds, out['edge'],
          capacity=self._channel_cap(out['edge'].shape[1], 'feature'),
          shard_mode='mod', book=book, book_keys=('efshard',))
      ft_stats += estats
      attr_ft.add_(dest_histogram(out['edge'], edge_owner_fn(p), p))
    tables, keys = [], []
    if self.collect_features:
      tables.append(self.ds.node_features.shards)
      keys.append('fshard')
    if self.collect_labels:
      tables.append(self.ds.node_labels)
      keys.append('lshard')
    served = None
    if tables:
      nodes = state.nodes
      node_valid = (torch.arange(node_cap, device=self.device)[None, :]
                    < state.count.reshape(p, 1))
      gather_ids, own = nodes, None
      if self.with_cache:
        cids = self.ds.node_features.cache_ids
        pos = torch.searchsorted(cids, nodes.to(cids.dtype)).clamp(
            0, cids.shape[1] - 1)
        hit = (cids.gather(1, pos) == nodes) & (nodes >= 0)
      if self.cache_local:
        # replica rows are local: masked out of the exchange, overlaid
        # below and counted as served.  On a store wholly on the card at
        # the identity book a partition's own rows skip the exchange too
        local_hit = hit & node_valid
        if not self.tiered and book is None:
          lo = self._bounds_t[:-1, None]
          own = (nodes >= lo) & (nodes < self._bounds_t[1:, None]) \
              & node_valid
          local_hit = local_hit | own
        gather_ids = torch.where(local_hit, INVALID_ID, nodes)
        served = local_hit.sum(1)
      got, gstats = dist_gather_multi(
          self.mesh, tables, self._bounds_t, gather_ids,
          capacity=self._channel_cap(node_cap, 'feature'),
          hot_counts=self._hot_t if self.collect_features else None,
          book=book, book_keys=keys)
      ft_stats += gstats
      attr_ft.add_(dest_histogram(gather_ids, range_owner, p,
                                  valid=node_valid & (gather_ids >= 0)))
      got = list(got)
      if self.collect_features:
        x = got.pop(0)
        if self.with_cache:
          x = cache_overlay(x, hit, pos, self.ds.node_features.cache_rows)
        if own is not None:
          x = cache_overlay(x, own, nodes - lo, self.ds.node_features.shards)
        out['x'] = x
      if self.collect_labels:
        out['y'] = got.pop(0)
    self._accumulate_stats(torch.cat([fr_stats, ft_stats]))
    self._accumulate_attr(attr_fr, attr_ft, served)
    return out

  # -- DataPlaneState (`utils.checkpoint`) -----------------------------------
  def data_plane_state(self, inflight: bool = False) -> dict:
    """The draw cursor ``step_cnt`` (the draws are keyed by it, so
    restoring it makes resumed batches byte-identical), the attribution
    matrices (``attribution``, ``[P, 2P + 1]``) and, on a tiered store,
    the cold cache's policies and rows.  ``inflight``: a batch was
    dispatched ahead and is lost with the process; with GNS on, the
    cached-set bits it sampled with are kept (``gns_inflight``), so its
    re-dispatch samples as it did (the cache has moved on since).  That
    leaf is the port's alone: the JAX package's state has none, and its
    own resume of a GNS loader differs from its uninterrupted epoch from
    the re-dispatched batch on."""
    state = {'step_cnt': self._step_cnt}
    cache = self._ensure_cold_cache()
    if cache is not None:
      state['cache'] = cache.state_dict()
    if inflight and self.gns and self._gns_bits is not None:
      state['gns_inflight'] = [t.cpu().numpy() for t in self._gns_bits]
    self.exchange_stats(tick_metrics=False)
    if self._attr_total is not None:
      state['attribution'] = self._attr_total.copy()
    return state

  def load_data_plane_state(self, state: dict) -> None:
    """Restore `data_plane_state`.  The attribution matrices restore with
    it; a state from before attribution restarts them at zero."""
    self._step_cnt = int(np.asarray(state['step_cnt']))
    self.exchange_stats(tick_metrics=False)
    with self._stats_lock:
      attr = state.get('attribution')
      self._attr_total = (None if attr is None else
                          np.asarray(attr, np.int64).copy())
    if 'cache' in state:
      cache = self._ensure_cold_cache()
      if cache is not None:
        cache.load_state_dict(state['cache'])
    self._gns_inflight = None
    if 'gns_inflight' in state and self.gns:
      self._gns_inflight = tuple(torch.from_numpy(np.asarray(a)).to(
          self.device) for a in state['gns_inflight'])

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
                                       self.device,
                                       bounds=self.ds.graph.bounds)
    return self._cold_cache

  def _gns_arrays(self):
    """The per-requester cached-set bitmask ``(table [T, N/8] uint8,
    row_index [P+1] int32)`` on the card, rebuilt only when the cold
    cache's residency moved (its version)."""
    if self._gns_inflight is not None:
      # the re-dispatch of a batch lost in flight (`load_data_plane_state`)
      bits, self._gns_inflight = self._gns_inflight, None
      self._gns_bits, self._gns_ver = bits, -1
      return bits
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
    # the host cold tier can die mid-epoch: a planned 'fail' lands here,
    # before any host gather
    chaos.cold_service_check('dist')
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

class _ResumableEpochMixin:
  """Mid-epoch snapshots and resume for the mesh loaders (the JAX
  package's `_ResumableEpochMixin`; the DataPlaneState protocol of
  `utils.checkpoint`, loader-shaped).

  `state_dict` captures the epoch's cursor: the batcher's RNG (the
  interrupted epoch's permutation is re-drawn on resume, not stored),
  the batches handed out, the draw cursor those batches reached, the
  cold cache and the `AdaptiveSlack` ladder.  `load_state_dict` then
  `resume_epoch` continue the epoch in a fresh loader with
  byte-identical remaining batches: the same permutation and the same
  draws (``step_cnt`` is the handed-out batches' cursor, so the batch a
  tiered store dispatched ahead, lost with the process, is re-dispatched
  at its own step; with GNS it samples with the cached-set bits it had).
  A loader with a live prefetch worker refuses to snapshot: the worker
  runs ahead of the trainer.  Iterating the returned epoch hands out the
  remaining batches; ``iter(loader)`` afterwards starts the next epoch
  where an uninterrupted run would.
  """

  _consumed = 0
  _resume_consumed = None

  def _start_epoch(self, seed_iter):
    self._epoch_start_steps = self.sampler._step_cnt
    self._consumed = 0
    return super()._start_epoch(seed_iter)

  def state_dict(self) -> dict:
    if getattr(self, '_active_prefetch', None) is not None:
      raise ValueError(
          'mid-epoch snapshots need a synchronous epoch (prefetch=0): a '
          'prefetch worker produces ahead of the trainer, so the cursor '
          'would count batches the trainer never saw')
    c = int(self._consumed)
    start = getattr(self, '_epoch_start_steps', self.sampler._step_cnt)
    sampler = self.sampler.data_plane_state(
        inflight=getattr(self, '_pending', None) is not None)
    sampler['step_cnt'] = start + c
    out = {'batcher': self._batcher.state_dict(), 'consumed': c,
           'epoch_count': int(getattr(self, '_epoch_count', 0)),
           'sampler': sampler}
    if self._adaptive is not None:
      out['slack'] = self._adaptive.state_dict()
    return out

  def load_state_dict(self, state: dict) -> None:
    self._batcher.load_state_dict(state['batcher'], mid_epoch=True)
    self.sampler.load_data_plane_state(state['sampler'])
    if self._adaptive is not None and 'slack' in state:
      self._adaptive.load_state_dict(state['slack'])
    self._epoch_count = int(np.asarray(state.get('epoch_count', 0)))
    self._resume_consumed = int(np.asarray(state['consumed']))

  def resume_epoch(self):
    """The interrupted epoch's remaining batches (after
    `load_state_dict`)."""
    consumed = self._resume_consumed
    if consumed is None:
      raise ValueError('resume_epoch() needs load_state_dict() first')
    self._resume_consumed = None
    it = iter(self._batcher)         # re-draws the interrupted epoch
    for _ in range(consumed):
      next(it)                       # what the trainer already has
    # set before the epoch starts: a prefetch worker counts from here
    self._consumed = consumed
    self._epoch_start_steps = self.sampler._step_cnt - consumed
    return PrefetchingLoader._start_epoch(self, it)


class DistNeighborLoader(_ResumableEpochMixin, PrefetchingLoader):
  """Mesh loader: splits the (relabelled) seeds across the partitions
  and yields stacked `Batch`es (leading axis = partition) for
  `make_dp_supervised_step`.

  ``input_space='old'`` maps the seeds through ``dataset.old2new``.
  ``exchange_slack='adaptive'`` starts at 2.0 and retunes the exchange
  capacity (`AdaptiveSlack`) when a new epoch starts after the first, as
  does the EWMA capacity model under ``GLT_EXCHANGE_EWMA=1``
  (`capacity_retune`).  ``exchange_layout`` picks the exchange layout
  (`exchange.resolve_layout`).
  For a tiered store batch ``k+1`` is dispatched before batch ``k``'s
  cold overlay runs (``GLT_COLD_PREFETCH=0``: one batch at a time).
  ``prefetch=N`` produces batches on a worker thread with its own CUDA
  stream, ``N`` ahead of the consumer (`loader.prefetch`); batches are
  the same as without it.  ``with_edge=True`` adds each sampled edge's
  global id (``edge``, -1 where masked) and, over a dataset with edge
  features, its row (``edge_attr``, zero where masked).  Each ``iter()``
  starts a new epoch.
  """

  def __init__(self, dataset: DistDataset, num_neighbors, input_nodes,
               batch_size: int = 1, shuffle: bool = False,
               drop_last: bool = False, mesh: Optional[Mesh] = None,
               collect_features: bool = True, seed: int = 0,
               input_space: str = 'old', exchange_slack='auto',
               prefetch: int = 0, cold_cache_rows='auto', gns=None,
               draws: Optional[Draws] = None, device='cuda',
               with_edge: bool = False,
               exchange_layout: Optional[str] = None):
    self.prefetch = int(prefetch)
    slack = resolve_exchange_slack(exchange_slack, shuffle)
    self.sampler = self._make_sampler(
        dataset, num_neighbors, mesh=mesh,
        collect_features=collect_features, seed=seed,
        exchange_slack=(DEFAULT_EXCHANGE_SLACK if slack == 'adaptive'
                        else slack),
        cold_cache_rows=cold_cache_rows, gns=gns, draws=draws,
        device=device, with_edge=with_edge, exchange_layout=exchange_layout)
    self._prefetch_device = self.sampler.device
    self._adaptive = (AdaptiveSlack(self.sampler)
                      if slack == 'adaptive' else None)
    self._epoch_count = 0
    self._cold_pipeline = (self.sampler.tiered and os.environ.get(
        'GLT_COLD_PREFETCH', '1') != '0')
    self.ds = dataset
    self.num_parts = dataset.num_partitions
    self.batch_size = int(batch_size)
    self._batcher = SeedBatcher(self._batch_items(input_nodes, input_space),
                                self.batch_size * self.num_parts,
                                shuffle, drop_last, seed)

  def _make_sampler(self, dataset, num_neighbors, **kwargs):
    return DistNeighborSampler(dataset, num_neighbors, **kwargs)

  def _batch_items(self, input_nodes, input_space: str) -> np.ndarray:
    """What the batcher splits: the relabelled seeds."""
    seeds = np.asarray(input_nodes).reshape(-1)
    if input_space == 'old' and self.ds.old2new is not None:
      seeds = self.ds.old2new[seeds]
    return seeds

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
    self._consumed += 1
    return _stacked_batch(out, md, self.batch_size)


def _stacked_batch(out: dict, metadata: dict, batch_size: int) -> Batch:
  """A sampler's stacked output as the `Batch` the DP steps take."""
  return Batch(x=out['x'], y=out['y'],
               edge_index=torch.stack([out['row'], out['col']], dim=1),
               edge_attr=out['ef'], node=out['node'],
               node_mask=out['node'] >= 0, edge_mask=out['row'] >= 0,
               edge=out['edge'], batch=out['batch'], batch_size=batch_size,
               num_sampled_nodes=out['num_sampled_nodes'],
               metadata=metadata)


def binary_num_negatives(batch: int, amount: float) -> int:
  """Binary-mode negatives a ``batch``-edge seed slice draws:
  ``ceil(batch * amount)`` (one definition for the sampler, the
  capacity plan and the labels)."""
  return int(np.ceil(batch * amount))


def pack_link_seeds(edge_label_index, edge_label,
                    neg_mode: Optional[str]):
  """``(rows, cols, columns)``: the seed edges' endpoints as int64 and
  the columns of the packed ``[E, 2|3]`` seed table — the endpoints,
  then the integer labels if any (binary mode shifts them up by one, so
  0 means "sampled negative")."""
  if isinstance(edge_label_index, (tuple, list)):
    rows, cols = edge_label_index
  else:
    ei = np.asarray(edge_label_index)
    rows, cols = ei[0], ei[1]
  rows = np.asarray(rows, np.int64)
  cols = np.asarray(cols, np.int64)
  columns = [rows, cols]
  if edge_label is not None:
    lab = np.asarray(edge_label)
    if not np.issubdtype(lab.dtype, np.integer):
      raise ValueError('the mesh link loader carries integer edge labels '
                       'in its packed seed table')
    lab = lab.astype(np.int64)
    if neg_mode == 'binary':
      lab = lab + 1
    columns.append(lab)
  return rows, cols, columns


def pack_link_seeds_relabeled(edge_label_index, edge_label,
                              neg_mode: Optional[str], dataset,
                              input_space: str) -> np.ndarray:
  """`pack_link_seeds` with the endpoints mapped through
  ``dataset.old2new`` when ``input_space='old'``: the packed ``[E, 2|3]``
  seed table."""
  rows, cols, columns = pack_link_seeds(edge_label_index, edge_label,
                                        neg_mode)
  if input_space == 'old' and dataset.old2new is not None:
    columns[0] = dataset.old2new[rows]
    columns[1] = dataset.old2new[cols]
  return np.stack(columns, axis=1)


def packed_rows(pairs: np.ndarray, idx: np.ndarray) -> np.ndarray:
  """Rows ``idx`` (any shape, -1 padded) of a packed ``[E, 2|3]`` seed
  table: ``idx.shape + (2|3,)``, a padded row -1 in every column (as
  JAX's batcher pads the packed table)."""
  rows = pairs[np.where(idx >= 0, idx, 0)]
  return np.where(idx[..., None] >= 0, rows, INVALID_ID)


def link_step_metadata(neg_mode: Optional[str], seed_local, eli=None,
                       elab=None, elab_mask=None, src_idx=None,
                       dst_pos=None, dst_neg=None) -> dict:
  """A link step's label outputs as the metadata dict
  `models.train.link_loss_from_metadata` reads: ``src_index`` /
  ``dst_pos_index`` / ``dst_neg_index`` / ``pair_mask`` for triplet
  mode, ``edge_label_index`` / ``edge_label`` / ``edge_label_mask``
  otherwise, beside ``seed_local``."""
  md = {'seed_local': seed_local}
  if neg_mode == 'triplet':
    md.update(src_index=src_idx, dst_pos_index=dst_pos,
              dst_neg_index=dst_neg, pair_mask=src_idx >= 0)
  else:
    md.update(edge_label_index=eli, edge_label=elab,
              edge_label_mask=elab_mask)
  return md


class DistLinkNeighborSampler(DistNeighborSampler):
  """Mesh link sampler: every partition's seed edges, strict negatives
  against the GLOBAL sharded graph (`dist_sample_negative`), and the
  endpoint expansion and collection of `DistNeighborSampler`.

  Args:
    neg_sampling: None, ``'binary'`` or ``('triplet', amount)`` (a
      `sampler.NegativeSampling` or what it casts from).
    Others as `DistNeighborSampler`.
  """

  def __init__(self, dataset: DistDataset, num_neighbors,
               neg_sampling=None, **kwargs):
    super().__init__(dataset, num_neighbors, **kwargs)
    ns = NegativeSampling.cast(neg_sampling)
    self.neg_mode = ns.mode if ns is not None else None
    self.neg_amount = float(ns.amount) if ns is not None else 1.0

  def _expansion_seeds(self, b: int) -> Tuple[int, int]:
    """``(expansion seeds, negatives)`` of a ``b``-edge partition
    batch."""
    if self.neg_mode == 'binary':
      nn = binary_num_negatives(b, self.neg_amount)
      return 2 * b + 2 * nn, nn
    if self.neg_mode == 'triplet':
      amount = int(np.ceil(self.neg_amount))
      return 2 * b + b * amount, b * amount
    return 2 * b, 0

  def sample_from_edges(self, pairs_stacked: np.ndarray) -> dict:
    """``[P, B, 2|3]`` per-partition (src, dst[, label]) seed edges
    (relabelled ids, -1 padded) -> the stacked batch pieces with the
    link ``metadata``."""
    return self._finish_nodes(self._dispatch_edges(pairs_stacked))

  def _dispatch_edges(self, pairs_stacked: np.ndarray) -> dict:
    """`_dispatch_nodes`' link twin: negatives, expansion and collection
    on the card, without the cold overlay."""
    self._fence()
    self._step_cnt += 1
    pairs = torch.from_numpy(np.asarray(pairs_stacked, np.int32)).to(
        self.device)
    out = self._sample_link(pairs, self.draws, self._step_cnt)
    self._complete_recovery()
    return out

  def _sample_link(self, pairs: torch.Tensor, draws: Draws,
                   step: int) -> dict:
    p, b = pairs.shape[:2]
    g = self.ds.graph
    src, dst = pairs[..., 0], pairs[..., 1]
    _, nn = self._expansion_seeds(b)
    n = g.num_nodes
    cap = self._channel_cap(nn * NEG_TRIALS)
    neg_ok = None
    if self.neg_mode == 'binary':
      nrows, ncols, neg_ok = dist_sample_negative(
          self.mesh, g.indptr, g.indices, self._bounds_t, n, n, nn, draws,
          step, capacity=cap, book=self._book_lanes)
      seeds = torch.cat([src, dst, nrows, ncols], dim=1)
    elif self.neg_mode == 'triplet':
      amount = nn // b
      fixed = torch.where(src >= 0, src, 0).repeat_interleave(amount, dim=1)
      _, negs, neg_ok = dist_sample_negative(
          self.mesh, g.indptr, g.indices, self._bounds_t, n, n, nn, draws,
          step, capacity=cap, rows_fixed=fixed, book=self._book_lanes)
      seeds = torch.cat([src, dst, negs], dim=1)
    else:
      seeds = torch.cat([src, dst], dim=1)
    seeds = torch.where(seeds >= 0, seeds, INVALID_ID).to(torch.int32)
    out = self._sample_collect(seeds, draws, step)
    sl = out['seed_local']
    dev = pairs.device
    pair_valid = (src >= 0) & (dst >= 0)
    lab = pairs[..., 2] if pairs.shape[2] > 2 else torch.ones_like(src)
    pos_label = torch.where(pair_valid, lab, 0).to(torch.int32)
    if self.neg_mode == 'binary':
      eli = torch.stack([torch.cat([sl[:, :b], sl[:, 2 * b:2 * b + nn]], 1),
                         torch.cat([sl[:, b:2 * b], sl[:, 2 * b + nn:]], 1)],
                        dim=1)
      elab = torch.cat([pos_label, torch.zeros((p, nn), dtype=torch.int32,
                                               device=dev)], dim=1)
      # an exhausted slot may be a real edge, and a padded tail batch
      # keeps ceil(valid pairs * amount) negatives (f32, as JAX)
      quota = torch.ceil(pair_valid.sum(1).to(torch.float32)
                         * torch.tensor(self.neg_amount,
                                        dtype=torch.float32,
                                        device=dev)).to(torch.int32)
      keep = neg_ok & (torch.arange(nn, device=dev)[None, :]
                       < quota[:, None])
      md = link_step_metadata(self.neg_mode, sl, eli, elab,
                              torch.cat([pair_valid, keep], dim=1))
    elif self.neg_mode == 'triplet':
      dn = torch.where(neg_ok, sl[:, 2 * b:], INVALID_ID).reshape(
          p, b, nn // b)
      md = link_step_metadata(self.neg_mode, sl, src_idx=sl[:, :b],
                              dst_pos=sl[:, b:2 * b], dst_neg=dn)
    else:
      md = link_step_metadata(self.neg_mode, sl,
                              torch.stack([sl[:, :b], sl[:, b:2 * b]], 1),
                              pos_label, pair_valid)
    if neg_ok is not None:
      lost = torch.zeros(len(EXCHANGE_STAT_NAMES), dtype=torch.int64,
                         device=dev)
      lost[6] = (~neg_ok).sum()
      self._accumulate_stats(lost)
    if 'edge_weight' in out:
      md['edge_weight'] = out['edge_weight']
    out['metadata'] = md
    out['batch'] = pairs[..., 0]
    return out


class DistLinkNeighborLoader(DistNeighborLoader):
  """Mesh link loader: splits the seed edges across the partitions,
  draws each partition's strict negatives over the whole graph, and
  yields stacked `Batch`es with link-label metadata for
  `make_dp_unsupervised_step`.

  Args:
    edge_label_index: ``[2, E]`` (or ``(rows, cols)``) seed edges.
    edge_label: optional integer labels (binary mode shifts them up by
      one).
    neg_sampling: None, ``'binary'`` or ``('triplet', amount)``.
    input_space: ``'old'`` maps the endpoints through
      ``dataset.old2new``.
    Others as `DistNeighborLoader`; a padded tail batch keeps
    ``ceil(valid pairs * amount)`` binary negatives.
  """

  def __init__(self, dataset: DistDataset, num_neighbors, edge_label_index,
               edge_label=None, neg_sampling=None, batch_size: int = 1,
               shuffle: bool = False, drop_last: bool = False,
               mesh: Optional[Mesh] = None, with_edge: bool = False,
               **kwargs):
    self._edge_label, self._neg_sampling = edge_label, neg_sampling
    super().__init__(dataset, num_neighbors, edge_label_index,
                     batch_size=batch_size, shuffle=shuffle,
                     drop_last=drop_last, mesh=mesh, with_edge=with_edge,
                     **kwargs)

  def _make_sampler(self, dataset, num_neighbors, **kwargs):
    return DistLinkNeighborSampler(dataset, num_neighbors,
                                   neg_sampling=self._neg_sampling, **kwargs)

  def _batch_items(self, edge_label_index, input_space: str) -> np.ndarray:
    """Row indices of the packed seed table (-1 padded by the batcher, so
    a padded tail row is -1 in every column, as JAX's batcher pads the
    packed table)."""
    self.pairs = pack_link_seeds_relabeled(
        edge_label_index, self._edge_label, self.sampler.neg_mode, self.ds,
        input_space)
    return np.arange(len(self.pairs))

  def _pairs_of(self, idx: np.ndarray) -> np.ndarray:
    return packed_rows(self.pairs, idx).reshape(self.num_parts,
                                                self.batch_size, -1)

  def _dispatch_flat(self, flat: np.ndarray) -> dict:
    return self.sampler._dispatch_edges(self._pairs_of(flat))

  def _produce(self, seed_iter) -> Batch:
    if self._cold_pipeline:
      out = self._pipelined(self._pipeline_acquire(seed_iter), seed_iter,
                            self._dispatch_flat, self.sampler._finish_nodes)
    else:
      out = self.sampler.sample_from_edges(self._pairs_of(next(seed_iter)))
    self._consumed += 1
    return _stacked_batch(out, out['metadata'], self.batch_size)


#: `hop_chunk='auto'` chunks the full-window hop once one reply buffer
#: (``node_cap * max_degree`` int32 a destination) would pass this many
#: elements
SUBGRAPH_WINDOW_BUDGET = 1 << 24


def resolve_hop_chunk(hop_chunk, node_cap: int,
                      max_degree: int) -> Optional[int]:
  """The subgraph samplers' ``'auto'``: None (one exchange of the whole
  closure) while ``node_cap * max_degree`` stays within
  `SUBGRAPH_WINDOW_BUDGET`, else the closure nodes a chunk that keep
  ``chunk * max_degree`` within it (rounded down to 8, at least
  `MIN_EXCHANGE_CAP`).  Results are exact either way."""
  if isinstance(hop_chunk, str):
    if hop_chunk != 'auto':
      raise ValueError(f'unknown hop_chunk {hop_chunk!r}')
    if node_cap * max_degree <= SUBGRAPH_WINDOW_BUDGET:
      return None
    return max(SUBGRAPH_WINDOW_BUDGET // max_degree // 8 * 8,
               MIN_EXCHANGE_CAP)
  return hop_chunk


class DistSubGraphSampler(DistNeighborSampler):
  """Mesh induced-subgraph sampler: the multi-hop closure of the seeds,
  one full-window hop over it and each partition's membership test and
  relabel against its own closure (the module docstring).

  Args:
    max_degree: the window a closure node contributes; None = the
      shards' true max degree (exact: the window gather kernel answers
      the hop).  A smaller width truncates through the uniform sampler
      kernel, whose window ``default_window(max_degree)`` must stay
      within its 256-slot cap (ValueError otherwise).
    hop_chunk: closure nodes a full-window exchange (``[P, chunk,
      max_degree]`` replies); ``'auto'`` (`resolve_hop_chunk`) or None
      (one exchange of the whole closure).
    Others as `DistNeighborSampler`; GNS is always off (induced
      subgraphs are exact by contract).
  """

  def __init__(self, dataset: DistDataset, num_neighbors,
               max_degree: Optional[int] = None, hop_chunk='auto',
               **kwargs):
    super().__init__(dataset, num_neighbors, **kwargs)
    self.gns = False
    self.gns_boost = None
    g = dataset.graph
    true_max = int((g.indptr[:, 1:] - g.indptr[:, :-1]).max()) if (
        g.indptr.shape[1] > 1) else 0
    if max_degree is None:
      max_degree = true_max
    self.max_degree = max(int(max_degree), 1)
    self.hop_chunk = hop_chunk
    #: the full-window hop's arm, fixed here: the window gather kernel
    #: when no row is truncated, else the uniform sampler kernel
    self.exact_window = self.max_degree >= true_max
    w = default_window(self.max_degree)
    if not self.exact_window and w > MAX_WINDOW:
      raise ValueError(
          f'max_degree={self.max_degree} truncates rows (the true max '
          f'degree is {true_max}) through the sampler kernel, whose window '
          f'{w} passes its {MAX_WINDOW}-slot cap: pass max_degree=None '
          f'for the exact window, or at most {MAX_WINDOW // 8}')

  def sample_subgraph(self, seeds_stacked: np.ndarray) -> dict:
    """``[P, B]`` per-partition seeds (relabelled ids, -1 padded) -> the
    stacked induced-subgraph pieces: edges in (source, destination)
    order as local ids, ``seed_local`` (the ``mapping``), ``x``/``y``
    of the closure and ``edge`` (global ids, with ``with_edge``)."""
    self._fence()
    self._step_cnt += 1
    seeds = torch.from_numpy(np.asarray(seeds_stacked, np.int32)).to(
        self.device)
    out = self._sample_subgraph(seeds, self.draws, self._step_cnt)
    self._complete_recovery()
    return self._finish_nodes(out)

  def _sample_subgraph(self, seeds: torch.Tensor, draws: Draws,
                       step: int) -> dict:
    out = self._sample_collect(seeds, draws, step, with_edge=False)
    g = self.ds.graph
    nodes = out['node']
    parts, node_cap = nodes.shape
    d = self.max_degree
    chunk = node_cap
    hc = resolve_hop_chunk(self.hop_chunk, node_cap, d)
    if hc is not None:
      chunk = min(max(int(hc), 1), node_cap)
    n_chunks = -(-node_cap // chunk)
    pad = n_chunks * chunk - node_cap
    nodes_pad = (torch.cat([nodes, torch.full((parts, pad), INVALID_ID,
                                              dtype=nodes.dtype,
                                              device=nodes.device)], 1)
                 if pad else nodes)
    eids_loc = self._edge_ids() if self.with_edge else None
    cap = self._channel_cap(chunk)
    nb, mk, ei = [], [], []
    stats = torch.zeros(3, dtype=torch.int64, device=self.device)
    range_owner = range_owner_fn(self._bounds_t)
    attr = torch.zeros((parts, parts), dtype=torch.int64, device=self.device)
    for ci in range(n_chunks):
      fr = nodes_pad[:, ci * chunk:(ci + 1) * chunk]
      # the full-window hop is frontier traffic too
      attr += dest_histogram(fr, range_owner, parts)
      if self.exact_window:
        n_, m_, e_, st = _dist_window_hop(self.mesh, g.indptr, g.indices,
                                          self._bounds_t, fr, d, cap,
                                          eids_loc=eids_loc,
                                          book=self._book_lanes)
      else:
        # JAX keys chunk ci as expansion hop ci: fold_in(step key, ci)
        n_, m_, e_, _, st = _dist_one_hop(
            self.mesh, g.indptr, g.indices, self._bounds_t, fr, d, draws,
            step, ci, cap, eids_loc=eids_loc, book=self._book_lanes)
      stats += st
      nb.append(n_)
      mk.append(m_)
      ei.append(e_)
    self._accumulate_stats(stats)
    self._accumulate_attr(attr)
    nbrs = torch.cat(nb, 1)[:, :node_cap].reshape(parts, -1)
    mask = torch.cat(mk, 1)[:, :node_cap].reshape(parts, -1)
    # membership in each partition's own closure, relabelled to local ids
    keyed = torch.where(nodes >= 0, nodes, torch.iinfo(torch.int32).max)
    order = torch.argsort(keyed, dim=1, stable=True)
    sorted_nodes = keyed.gather(1, order)
    loc = torch.searchsorted(sorted_nodes, nbrs.contiguous()).clamp(
        0, node_cap - 1)
    hit = (sorted_nodes.gather(1, loc) == nbrs) & (nbrs >= 0) & mask
    out['col'] = torch.where(hit, order.gather(1, loc),
                             INVALID_ID).to(torch.int32)
    row = torch.arange(node_cap, dtype=torch.int32,
                       device=nodes.device).repeat_interleave(d)
    out['row'] = torch.where(hit, row[None, :], INVALID_ID)
    out['edge'] = (torch.where(hit, torch.cat(ei, 1)[:, :node_cap].reshape(
        parts, -1), INVALID_ID) if self.with_edge else None)
    return out


class DistSubGraphLoader(PrefetchingLoader):
  """Mesh induced-subgraph loader (the JAX package's
  `DistSubGraphLoader`): splits the seeds across the partitions and
  yields stacked `Batch`es with ``metadata['mapping']`` (= ``seed_local``)
  locating each seed in its partition's node table, the SEAL contract.

  ``exchange_slack='auto'`` is exact whether or not the seeds are
  shuffled: a closure node dropped at a capacity cap would lose its
  whole window and corrupt the subgraph.  ``'adaptive'`` raises; a
  number opts into a cap.  ``hop_chunk`` bounds the full-window
  exchange instead.  Others as `DistSubGraphSampler` and
  `DistNeighborLoader`.
  """

  def __init__(self, dataset: DistDataset, num_neighbors, input_nodes,
               batch_size: int = 1, shuffle: bool = False,
               drop_last: bool = False, mesh: Optional[Mesh] = None,
               with_edge: bool = False, collect_features: bool = True,
               max_degree: Optional[int] = None, seed: int = 0,
               input_space: str = 'old', exchange_slack='auto',
               hop_chunk='auto', prefetch: int = 0,
               draws: Optional[Draws] = None, device='cuda',
               exchange_layout: Optional[str] = None):
    if exchange_slack == 'adaptive':
      raise ValueError(
          "exchange_slack='adaptive' is not supported for induced "
          'subgraphs: any capacity drop corrupts SEAL/DRNL labels, so '
          'the loader stays exact (hop_chunk bounds the exchange '
          'instead)')
    if exchange_slack == 'auto':
      exchange_slack = None
    self.prefetch = int(prefetch)
    self.sampler = DistSubGraphSampler(
        dataset, num_neighbors, max_degree=max_degree, hop_chunk=hop_chunk,
        mesh=mesh, with_edge=with_edge, collect_features=collect_features,
        seed=seed, exchange_slack=resolve_exchange_slack(exchange_slack,
                                                         shuffle),
        draws=draws, device=device, exchange_layout=exchange_layout)
    self._prefetch_device = self.sampler.device
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

  def _produce(self, seed_iter) -> Batch:
    out = self.sampler.sample_subgraph(
        next(seed_iter).reshape(self.num_parts, self.batch_size))
    return Batch(x=out['x'], y=out['y'],
                 edge_index=torch.stack([out['row'], out['col']], dim=1),
                 node=out['node'], node_mask=out['node'] >= 0,
                 edge_mask=out['row'] >= 0, edge=out['edge'],
                 batch=out['batch'], batch_size=self.batch_size,
                 num_sampled_nodes=out['num_sampled_nodes'],
                 metadata={'seed_local': out['seed_local'],
                           'mapping': out['seed_local']})


class DistRandomWalker(DistNeighborSampler):
  """Mesh uniform random walks (DeepWalk corpora over the sharded
  graph): each walk step is one hop of fanout 1 through the owners'
  uniform sampler kernel.  A node without out-edges ends its walk (-1
  from then on), as does a -1 start.

  Args:
    dataset: `DistDataset` on ``device``.
    walk_length: steps a walk (``walk`` returns ``[P, B, L + 1]``).
    exchange_slack: exact by default (None or ``'auto'``): a dropped id
      truncates the rest of its walk; a number opts into a cap;
      ``'adaptive'`` raises.
    Others as `DistNeighborSampler` (no features, labels or edges).
  """

  def __init__(self, dataset: DistDataset, walk_length: int,
               exchange_slack=None, **kwargs):
    if exchange_slack == 'adaptive':
      raise ValueError(
          "exchange_slack='adaptive' is not supported for random "
          'walks: a dropped frontier id truncates the whole walk '
          'remainder, so the walker stays exact (pass a float to opt '
          'into a cap where partition balance is known)')
    super().__init__(dataset, [], collect_features=False, with_edge=False,
                     exchange_slack=resolve_exchange_slack(exchange_slack,
                                                           False),
                     **kwargs)
    self.walk_length = int(walk_length)

  def walk(self, starts_stacked: np.ndarray) -> torch.Tensor:
    """``[P, B]`` per-partition start nodes (relabelled ids, -1 padded)
    -> ``[P, B, walk_length + 1]`` int32 walks, the start in column
    0."""
    self._fence()
    self._step_cnt += 1
    cur = torch.from_numpy(np.asarray(starts_stacked, np.int32)).to(
        self.device)
    g = self.ds.graph
    path = [cur]
    stats = torch.zeros(3, dtype=torch.int64, device=self.device)
    p = self.num_parts
    range_owner = range_owner_fn(self._bounds_t)
    attr = torch.zeros((p, p), dtype=torch.int64, device=self.device)
    for t in range(self.walk_length):
      attr += dest_histogram(cur, range_owner, p)
      nbrs, mask, _, _, st = _dist_one_hop(
          self.mesh, g.indptr, g.indices, self._bounds_t, cur, 1,
          self.draws, self._step_cnt, t, self._channel_cap(cur.shape[1]),
          book=self._book_lanes)
      stats += st
      cur = torch.where(mask[..., 0], nbrs[..., 0], INVALID_ID)
      path.append(cur)
    self._complete_recovery()
    self._accumulate_stats(stats)
    self._accumulate_attr(attr)
    return torch.stack(path, dim=2)
