"""Heterogeneous multi-hop neighbor sampling on one card (the JAX
package's `sampler/hetero_neighbor_sampler.py:40-277`, node seeds).

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
seed's, so messages flow from the discovered nodes to the seeds.

Random numbers come from a ``draws(step, hop, rows, k, w, etype=ei)``
provider: ``step`` counts `sample_from_nodes` calls from 1, ``ei`` is
the edge type's index among the sorted edge types, ``rows`` the
source type's frontier capacity at that hop, and draw row ``j`` belongs
to the ``j``-th frontier row in ascending seed order.  The default is
`ops.draws.TorchDraws`; the parity tests replay the JAX sampler's keys,
``fold_in(fold_in(fold_in(key(seed), step), hop), ei)`` split into the
uniform and the Gumbel stream.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from ..data.graph import Graph
from ..ops.draws import TorchDraws
from ..ops.fused_sample import sample_one_hop_fused
from ..ops.neighbor import default_window
from ..ops.unique import _frontier, induce_next, init_node
from ..typing import EdgeType, NodeType, reverse_edge_type
from ..utils.device import resolve_device
from ..utils.padding import INVALID_ID, round_up
from .base import BaseSampler, HeteroSamplerOutput, NodeSamplerInput

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
                     plan: HeteroPlan, draws: HopDraws):
  """One heterogeneous multi-hop sample (the module docstring).

  Returns ``(node, node_count, row, col, edge_mask, seed_locals,
  num_sampled_nodes)``: per-type tables and counts, per-(reversed)
  edge-type COO and validity, the seeded types' local indices and the
  per-type new-node counts a hop."""
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
      res = sample_one_hop_fused(g.indptr, g.indices, fr_nodes, k, u,
                                 gumbel, sort_locality=True)
      states[d], rows, cols, _ = induce_next(states[d], fr_local, res.nbrs,
                                             res.mask)
      rows_acc[et].append(rows)
      cols_acc[et].append(cols)
    for nt in caps:
      fr_start[nt] = hop_start[nt]
      nsn[nt].append(states[nt].count)
  row_out, col_out, emask_out = {}, {}, {}
  for et in plan.etypes:
    if not rows_acc[et]:
      continue
    rev = reverse_edge_type(et)
    row_out[rev] = torch.cat(rows_acc[et])
    col_out[rev] = torch.cat(cols_acc[et])
    emask_out[rev] = row_out[rev] >= 0
  num_sampled = {}
  for nt, v in nsn.items():
    cum = torch.stack(v)
    num_sampled[nt] = torch.cat([cum[:1], cum[1:] - cum[:-1]]).to(
        torch.int32)
  return ({nt: st.nodes for nt, st in states.items()},
          {nt: st.count for nt, st in states.items()}, row_out, col_out,
          emask_out, seed_locals, num_sampled)


class HeteroNeighborSampler(BaseSampler):
  """Uniform heterogeneous multi-hop sampler over a dict of graphs.

  Args:
    graphs: ``{EdgeType: Graph}`` (sampling runs ``src`` -> ``dst``),
      all on ``device``.
    num_neighbors: per-hop fanouts, one list for every edge type or
      ``{EdgeType: list}`` (edge types left out take no part).
    device: where the sampler runs (default ``'cuda'``).
    with_edge: sampled edge ids — not ported (slice 7).
    num_nodes: node counts by type (e.g. `Dataset.num_nodes_dict`), for
      tighter capacities; merged with what the topologies show.
    seed: seeds the default draws provider.
    draws: the ``draws(step, hop, rows, k, w, etype=ei)`` provider
      (module docstring).
  """

  def __init__(self, graphs: Dict[EdgeType, Graph], num_neighbors,
               device='cuda', with_edge: bool = False,
               num_nodes: Optional[Dict[NodeType, int]] = None,
               seed: int = 0, draws: Optional[Callable] = None):
    self.device = resolve_device(device)
    if with_edge:
      raise NotImplementedError('with_edge (sampled edge ids) is not '
                                'ported yet: it is slice 7 of the ROADMAP')
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
    self.draws = draws if draws is not None else TorchDraws(seed,
                                                            self.device)
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
    node = inputs.node
    if isinstance(node, torch.Tensor):
      seeds = node.to(self.device, torch.int32)
    else:
      seeds = torch.from_numpy(np.asarray(node, dtype=np.int32)).to(
          self.device)
    self._step += 1
    step = self._step

    def draws(hop, rows, k, w, etype):
      return self.draws(step, hop, rows, k, w, etype=etype)
    (node, node_count, row, col, emask, seed_locals,
     nsn) = _hetero_multihop(self.graphs, {input_type: seeds},
                             self.plan({input_type: seeds.shape[0]}), draws)
    return HeteroSamplerOutput(
        node=node, node_count=node_count, row=row, col=col,
        edge_mask=emask, batch={input_type: seeds}, num_sampled_nodes=nsn,
        edge_types=[reverse_edge_type(et) for et in self.etypes],
        metadata={'seed_local': seed_locals[input_type],
                  'input_type': input_type})

  def sample_from_edges(self, inputs, **kwargs):
    raise NotImplementedError('heterogeneous link sampling is not ported '
                              'yet: it is slice 7 of the ROADMAP')

  def subgraph(self, inputs, **kwargs):
    raise NotImplementedError('induced-subgraph sampling is not ported '
                              'yet: it is slice 7 of the ROADMAP')
