"""Heterogeneous multi-hop neighbor sampling on one card (the JAX
package's `sampler/hetero_neighbor_sampler.py:40-384`): node seeds, and
seed edges of one edge type with binary or triplet negatives (link
prediction).

Each stored edge type ``(src, rel, dst)`` is sampled from the frontier
of ``src`` nodes with that edge type's per-hop fanout, through the
one-hop sampler kernel (`ops.fused_sample.sample_one_hop_fused`, rows
in ascending seed order), and the neighbors found are inserted into the
``dst`` type's node table (`ops.unique.induce_next`).  Per hop the edge
types run in sorted order, so a type reached by two edge types in one
hop is induced twice, in that order.  A type's hop-``h`` frontier is
the window of its table that hop ``h - 1`` appended.  Every table holds
its planned capacity (`_plan_capacities`) from the start.  Sampled
edges are emitted under the REVERSED edge type (`typing.
reverse_edge_type`), ``row`` on the neighbor's side and ``col`` on the
seed's, so messages flow from the discovered nodes to the seeds.  With
``with_edge`` the kernel also emits each sampled edge's id (the edge
type's graph ``edge_ids``, or CSR positions), kept where the inserted
edge is valid and emitted under the same reversed type.

Random numbers come from a ``draws(step, hop, rows, k, w, etype=ei)``
provider: ``step`` counts `sample_from_nodes` calls from 1, ``ei`` is
the edge type's index among the sorted edge types, ``rows`` the
source type's frontier capacity at that hop, and draw row ``j`` belongs
to the ``j``-th frontier row in ascending seed order.  The default is
`ops.draws.TorchDraws`; the parity tests replay the JAX sampler's keys,
``fold_in(fold_in(fold_in(key(seed), step), hop), ei)`` split into the
uniform and the Gumbel stream.  A link sample takes two steps, as in the
homogeneous sampler: its negatives draw at the first, from a
``neg_draws(step, stream, trials, r, high)`` provider (`ops.negative`'s
streams; ``high`` the destination type's node count for the columns),
its hops at the second.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch

from ..data.graph import Graph
from ..ops.draws import TorchDraws
from ..ops.fused_sample import sample_one_hop_fused
from ..ops.neighbor import default_window
from ..ops.unique import _frontier, induce_next, init_node
from ..typing import EdgeType, NodeType, reverse_edge_type
from ..utils.device import resolve_device
from ..utils.padding import INVALID_ID, round_up
from .base import (BaseSampler, EdgeSamplerInput, HeteroSamplerOutput,
                   NegativeSampling, NodeSamplerInput)
from .neighbor_sampler import NegDraws, _as_labels, as_ids, link_negatives

#: ``draws(hop, rows, k, w, etype=ei) -> (u [rows, k], gumbel [rows, w])``
#: for one sampling call (the step already bound)
HopDraws = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def normalize_fanouts(etypes: Tuple[EdgeType, ...], num_neighbors):
  """``num_neighbors`` (one list for every edge type, or ``{EdgeType:
  list}``) -> ``(etypes, fanouts, num_hops)``; edge types a dict leaves
  out take no part."""
  if isinstance(num_neighbors, dict):
    fanouts = {et: tuple(int(k) for k in num_neighbors[et])
               for et in etypes if et in num_neighbors}
    etypes = tuple(et for et in etypes if et in fanouts)
  else:
    fan = tuple(int(k) for k in num_neighbors)
    fanouts = {et: fan for et in etypes}
  num_hops = max((len(f) for f in fanouts.values()), default=0)
  return etypes, fanouts, num_hops


def _plan_capacities(etypes: Sequence[EdgeType],
                     fanouts: Dict[EdgeType, Tuple[int, ...]],
                     input_sizes: Dict[NodeType, int], num_hops: int,
                     num_nodes: Dict[NodeType, int]):
  """The static shapes of one sample: ``(ntypes, table capacity by
  type, frontier capacity by type for each hop, edge capacity by edge
  type for each hop)``.  ``input_sizes`` gives the seed count of each
  seeded type."""
  ntypes = sorted({t for (s, _, d) in etypes for t in (s, d)}
                  | set(input_sizes))
  frontier = {nt: int(input_sizes.get(nt, 0)) for nt in ntypes}
  frontier_caps = [dict(frontier)]
  table_cap = {nt: frontier[nt] for nt in ntypes}
  edge_caps: List[Dict[EdgeType, int]] = []
  for h in range(num_hops):
    add = {nt: 0 for nt in ntypes}
    ecap: Dict[EdgeType, int] = {}
    for et in etypes:
      s, _, d = et
      k = fanouts[et][h] if h < len(fanouts[et]) else 0
      if k <= 0 or frontier[s] == 0:
        continue
      ecap[et] = frontier[s] * k
      add[d] += frontier[s] * k
    frontier = {nt: min(add[nt], num_nodes.get(nt, add[nt]))
                for nt in ntypes}
    frontier_caps.append(dict(frontier))
    for nt in ntypes:
      table_cap[nt] = min(table_cap[nt] + add[nt],
                          input_sizes.get(nt, 0)
                          + num_nodes.get(nt, 1 << 60))
    edge_caps.append(ecap)
  table_cap = {nt: round_up(max(c, 1), 8) for nt, c in table_cap.items()}
  return ntypes, table_cap, frontier_caps, edge_caps


class HeteroPlan(NamedTuple):
  """The static configuration of `_hetero_multihop`: sorted edge types,
  their fanouts, the hop count and the capacities of
  `_plan_capacities`."""
  etypes: Tuple[EdgeType, ...]
  fanouts: Dict[EdgeType, Tuple[int, ...]]
  num_hops: int
  table_caps: Dict[NodeType, int]
  frontier_caps: List[Dict[NodeType, int]]


def _hetero_multihop(graphs: Dict[EdgeType, Graph],
                     seeds_by_type: Dict[NodeType, torch.Tensor],
                     plan: HeteroPlan, draws: HopDraws,
                     with_edge: bool = False):
  """One heterogeneous multi-hop sample (the module docstring).

  Returns ``(node, node_count, row, col, edge_mask, seed_locals,
  num_sampled_nodes, edge)``: per-type tables and counts, per-(reversed)
  edge-type COO and validity, the seeded types' local indices, the
  per-type new-node counts a hop and the per-(reversed) edge-type edge
  ids (None without ``with_edge``)."""
  caps = plan.table_caps
  states, seed_locals = {}, {}
  dev = next(iter(seeds_by_type.values())).device
  for nt in caps:
    if nt in seeds_by_type:
      states[nt], seed_locals[nt] = init_node(seeds_by_type[nt], caps[nt])
    else:
      states[nt] = init_node(torch.full((1,), INVALID_ID, dtype=torch.int32,
                                        device=dev), caps[nt])[0]
  fr_start = {nt: 0 for nt in caps}
  rows_acc = {et: [] for et in plan.etypes}
  cols_acc = {et: [] for et in plan.etypes}
  eids_acc = {et: [] for et in plan.etypes}
  nsn = {nt: [states[nt].count] for nt in caps}
  for h in range(plan.num_hops):
    # the frontiers are the nodes the previous hop appended
    hop_start = {nt: states[nt].count for nt in caps}
    frontiers = {}
    for nt in caps:
      fcap = plan.frontier_caps[h].get(nt, 0)
      if fcap > 0:
        frontiers[nt] = _frontier(states[nt], fr_start[nt], fcap)
    for ei, et in enumerate(plan.etypes):
      s, _, d = et
      fan = plan.fanouts[et]
      k = fan[h] if h < len(fan) else 0
      if k <= 0 or s not in frontiers:
        continue
      fr_nodes, fr_local = frontiers[s]
      u, gumbel = draws(h, fr_nodes.shape[0], k, default_window(k),
                        etype=ei)
      g = graphs[et]
      res = sample_one_hop_fused(
          g.indptr, g.indices, fr_nodes, k, u, gumbel, sort_locality=True,
          edge_ids=g.edge_ids if with_edge else None,
          with_edge_ids=with_edge)
      states[d], rows, cols, _ = induce_next(states[d], fr_local, res.nbrs,
                                             res.mask)
      rows_acc[et].append(rows)
      cols_acc[et].append(cols)
      if with_edge:
        eids_acc[et].append(torch.where(rows >= 0, res.eids.reshape(-1),
                                        INVALID_ID))
    for nt in caps:
      fr_start[nt] = hop_start[nt]
      nsn[nt].append(states[nt].count)
  row_out, col_out, eid_out, emask_out = {}, {}, {}, {}
  for et in plan.etypes:
    if not rows_acc[et]:
      continue
    rev = reverse_edge_type(et)
    row_out[rev] = torch.cat(rows_acc[et])
    col_out[rev] = torch.cat(cols_acc[et])
    emask_out[rev] = row_out[rev] >= 0
    if with_edge:
      eid_out[rev] = torch.cat(eids_acc[et])
  num_sampled = {}
  for nt, v in nsn.items():
    cum = torch.stack(v)
    num_sampled[nt] = torch.cat([cum[:1], cum[1:] - cum[:-1]]).to(
        torch.int32)
  return ({nt: st.nodes for nt, st in states.items()},
          {nt: st.count for nt, st in states.items()}, row_out, col_out,
          emask_out, seed_locals, num_sampled,
          eid_out if with_edge else None)


class HeteroNeighborSampler(BaseSampler):
  """Uniform heterogeneous multi-hop sampler over a dict of graphs.

  Args:
    graphs: ``{EdgeType: Graph}`` (sampling runs ``src`` -> ``dst``),
      all on ``device``.
    num_neighbors: per-hop fanouts, one list for every edge type or
      ``{EdgeType: list}`` (edge types left out take no part).
    device: where the sampler runs (default ``'cuda'``).
    with_edge: emit the sampled edges' ids (``edge``, by reversed edge
      type).
    num_nodes: node counts by type (e.g. `Dataset.num_nodes_dict`), for
      tighter capacities and the negatives' id space; merged with what
      the topologies show.
    seed: seeds the default draws providers.
    draws / neg_draws: the ``draws(step, hop, rows, k, w, etype=ei)``
      and the negative-candidate providers (module docstring).
  """

  def __init__(self, graphs: Dict[EdgeType, Graph], num_neighbors,
               device='cuda', with_edge: bool = False,
               num_nodes: Optional[Dict[NodeType, int]] = None,
               seed: int = 0, draws: Optional[Callable] = None,
               neg_draws: Optional[NegDraws] = None):
    self.device = resolve_device(device)
    self.with_edge = bool(with_edge)
    self.graphs = dict(graphs)
    for et, g in self.graphs.items():
      if g.device != self.device:
        raise ValueError(f'the graph of {et} lives on {g.device}, the '
                         f'sampler on {self.device}')
    self.etypes, self.fanouts, self.num_hops = normalize_fanouts(
        tuple(sorted(self.graphs)), num_neighbors)
    self._num_nodes = dict(num_nodes or {})
    for (s, _, d), g in self.graphs.items():
      self._num_nodes[s] = max(self._num_nodes.get(s, 0), g.num_nodes)
      self._num_nodes[d] = max(self._num_nodes.get(d, 0),
                               g.max_index() + 1)
    default = TorchDraws(seed, self.device)
    self.draws = draws if draws is not None else default
    self.neg_draws = neg_draws if neg_draws is not None else default.negatives
    self._step = 0

  def plan(self, input_sizes: Dict[NodeType, int]) -> HeteroPlan:
    """The static plan of a sample seeded with ``input_sizes`` ids by
    type."""
    _, table_cap, frontier_caps, _ = _plan_capacities(
        self.etypes, self.fanouts, input_sizes, self.num_hops,
        self._num_nodes)
    return HeteroPlan(etypes=self.etypes, fanouts=self.fanouts,
                      num_hops=self.num_hops,
                      table_caps=table_cap, frontier_caps=frontier_caps)

  def sample_from_nodes(self, inputs: NodeSamplerInput,
                        **kwargs) -> HeteroSamplerOutput:
    """Sample the multi-hop neighborhood of ``inputs.node`` (``[B]`` ids
    of type ``inputs.input_type``, -1 padded).  Enqueues on the card and
    returns without synchronising."""
    input_type = inputs.input_type
    if input_type is None:
      raise ValueError('heterogeneous sampling needs inputs.input_type')
    seeds = self._ids(inputs.node)
    (node, node_count, row, col, emask, seed_locals, nsn,
     eid) = self._run({input_type: seeds})
    return HeteroSamplerOutput(
        node=node, node_count=node_count, row=row, col=col, edge=eid,
        edge_mask=emask, batch={input_type: seeds}, num_sampled_nodes=nsn,
        edge_types=[reverse_edge_type(et) for et in self.etypes],
        metadata={'seed_local': seed_locals[input_type],
                  'input_type': input_type})

  def _ids(self, ids) -> torch.Tensor:
    return as_ids(ids, self.device)

  def _run(self, seeds_by_type: Dict[NodeType, torch.Tensor]):
    """One step: the multi-hop sample from per-type seed sets."""
    self._step += 1
    step = self._step

    def draws(hop, rows, k, w, etype):
      return self.draws(step, hop, rows, k, w, etype=etype)
    plan = self.plan({nt: s.shape[0] for nt, s in seeds_by_type.items()})
    return _hetero_multihop(self.graphs, seeds_by_type, plan, draws,
                            self.with_edge)

  def sample_from_edges(self, inputs: EdgeSamplerInput,
                        neg_sampling: Optional[NegativeSampling] = None,
                        **kwargs) -> HeteroSamplerOutput:
    """Sample around seed edges of one edge type (``inputs.input_type``,
    ``[B]`` endpoints, (-1, -1) padded) and their negatives
    (``neg_sampling``, else ``inputs.neg_sampling``), drawn in the
    destination type's id space.  Each endpoint seeds its own type's
    table (one table, sources first, when the types coincide).  The
    metadata's ``edge_label_index[0]`` indexes the source type's table
    and ``[1]`` the destination type's (binary, or no negatives);
    triplet negatives give ``src_index``, ``dst_pos_index``,
    ``dst_neg_index`` and ``pair_mask``.  ``seed_local`` is by type and
    covers the positive endpoints, as ``batch``.  Takes two steps
    (module docstring)."""
    et = inputs.input_type
    if et is None or tuple(et) not in self.graphs:
      raise ValueError(f'heterogeneous link sampling needs input_type, an '
                       f'edge type of the graph; got {et!r}')
    et = tuple(et)
    s_t, _, d_t = et
    neg = NegativeSampling.cast(neg_sampling) or inputs.neg_sampling
    src, dst = self._ids(inputs.row), self._ids(inputs.col)
    b = src.shape[0]
    pair_valid = (src >= 0) & (dst >= 0)
    g = self.graphs[et]
    self._step += 1
    step = self._step

    def candidates(stream, trials, r, high):
      return self.neg_draws(step, stream, trials, r, high)
    negs = link_negatives(g.indptr, g.indices, src, neg, candidates,
                          num_cols=self._num_nodes[d_t])
    if neg is not None and neg.is_binary():
      src_seeds = torch.cat([src, negs[0]])
      dst_seeds = torch.cat([dst, negs[1]])
    else:
      src_seeds = src
      dst_seeds = torch.cat([dst] + negs)
    if s_t == d_t:
      seeds_by_type = {s_t: torch.cat([src_seeds, dst_seeds])}
    else:
      seeds_by_type = {s_t: src_seeds, d_t: dst_seeds}
    (node, node_count, row, col, emask, seed_locals, nsn,
     eid) = self._run(seeds_by_type)
    if s_t == d_t:
      ns = src_seeds.shape[0]
      sl_src, sl_dst = seed_locals[s_t][:ns], seed_locals[s_t][ns:]
    else:
      sl_src, sl_dst = seed_locals[s_t], seed_locals[d_t]
    num_neg = dst_seeds.shape[0] - b
    if neg is not None and neg.is_triplet():
      metadata = {'src_index': sl_src, 'dst_pos_index': sl_dst[:b],
                  'dst_neg_index': sl_dst[b:].reshape(b, -1),
                  'pair_mask': pair_valid}
    else:
      label = _as_labels(inputs.label, self.device)
      if label is None:
        label = torch.ones(b, dtype=torch.int32, device=self.device)
      metadata = {
          'edge_label_index': torch.stack([sl_src, sl_dst]),
          'edge_label': torch.cat([label, label.new_zeros(num_neg)]),
          'edge_label_mask': torch.cat([pair_valid, torch.ones(
              num_neg, dtype=torch.bool, device=self.device)])}
    metadata['input_type'] = et
    if s_t == d_t:
      batch = {s_t: torch.cat([src, dst])}
      metadata['seed_local'] = {s_t: torch.cat([sl_src[:b], sl_dst[:b]])}
    else:
      batch = {s_t: src, d_t: dst}
      metadata['seed_local'] = {s_t: sl_src[:b], d_t: sl_dst[:b]}
    return HeteroSamplerOutput(
        node=node, node_count=node_count, row=row, col=col, edge=eid,
        edge_mask=emask, batch=batch, num_sampled_nodes=nsn,
        edge_types=[reverse_edge_type(e) for e in self.etypes],
        metadata=metadata)

  def subgraph(self, inputs, **kwargs):
    raise NotImplementedError('heterogeneous induced-subgraph sampling is '
                              'not ported (the JAX package has none '
                              'either): item 8 of the ROADMAP\'s slice '
                              'catalogue')
