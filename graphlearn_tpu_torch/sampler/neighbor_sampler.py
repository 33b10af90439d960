"""Uniform multi-hop neighbor sampling on one card (the JAX package's
`sampler/neighbor_sampler.py:44-161,164-370`, homogeneous): node seeds,
seed edges with binary or triplet negatives (link prediction), and the
induced subgraph of a closure (SEAL).

Per hop, `_multihop_sample` samples the frontier of newly discovered
nodes with the one-hop sampler kernel (`ops.fused_sample.
sample_one_hop_fused`, rows in ascending seed order) and inserts the
neighbors into the node table (`ops.unique.expand_hops`, shared with
the mesh sampler).  The node table grows hop by hop, as in JAX: each
hop's insertion sorts the current capacity plus the hop's ``F * k`` new
slots, not the final bound, and the table is padded to ``node_cap`` at
the end.

With ``with_edge`` each hop's kernel also emits the sampled edges' ids
(the graph's ``edge_ids`` at the slots' CSR positions, or the
positions; `ops.fused_sample`), kept where the inserted edge is valid:
``SamplerOutput.edge`` lines up with ``row``/``col``.  The draws do not
change with it.

Random numbers come from a ``draws(step, hop, rows, k, w) -> (u [rows,
k], gumbel [rows, w])`` provider, where ``step`` counts the sampler's
steps from 1, ``rows`` is the hop's frontier width (``B``, ``B*k_1``,
...) and draw row ``j`` belongs to the ``j``-th frontier row in
ascending seed order (invalid rows last).  A link sample takes two
steps, as JAX takes two keys: its negatives draw at the first (from a
``neg_draws(step, stream, trials, r, high) -> [trials, r]`` int32
provider, `ops.negative`'s streams), its hops at the second.  The
defaults are `ops.draws.TorchDraws` on the sampler's device; the parity
tests replay the JAX sampler's keys: ``key = fold_in(key(seed),
step)``, hop ``i`` ``fold_in(key, i)``, split into the uniform and the
Gumbel stream; a binary link step's key ``split`` into the row and the
column candidates, a triplet step's key whole for the destinations.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.graph import Graph
from ..ops.draws import TorchDraws
from ..ops.fused_sample import sample_one_hop_fused
from ..ops.negative import Candidates, sample_negative, triplet_negatives
from ..ops.neighbor import default_window
from ..ops.subgraph import induced_subgraph
from ..ops.unique import InducerState, expand_hops
from ..utils.device import resolve_device
from ..utils.padding import INVALID_ID, max_sampled_nodes, round_up
from .base import (BaseSampler, EdgeSamplerInput, NegativeSampling,
                   NodeSamplerInput, SamplerOutput)

Draws = Callable[[int, int, int, int, int], Tuple[torch.Tensor, torch.Tensor]]
#: ``neg_draws(step, stream, trials, r, high) -> [trials, r]`` int32
NegDraws = Callable[[int, int, int, int, int], torch.Tensor]


def _multihop_sample(indptr: torch.Tensor, indices: torch.Tensor,
                     seeds: torch.Tensor, fanouts: Sequence[int],
                     node_cap: int, draws: Draws, step: int,
                     edge_ids: Optional[torch.Tensor] = None,
                     with_edge: bool = False) -> SamplerOutput:
  """One multi-hop sample of ``[B]`` int32 seeds (-1 padded); with
  ``with_edge`` the output's ``edge`` holds each valid edge's id."""
  eids_acc = []

  def one_hop(hop, frontier, k):
    u, gumbel = draws(step, hop, frontier.shape[1], k, default_window(k))
    res = sample_one_hop_fused(indptr, indices, frontier[0], k, u, gumbel,
                               sort_locality=True, edge_ids=edge_ids,
                               with_edge_ids=with_edge)
    if with_edge:
      eids_acc.append(res.eids.reshape(-1))
    return res.nbrs[None], res.mask[None]

  state, seed_local, rows_acc, cols_acc, nsn = expand_hops(
      seeds[None], fanouts, node_cap, one_hop, grow=True)
  state = InducerState(nodes=state.nodes[0], count=state.count[0])
  seed_local, nsn = seed_local[0], nsn[0]
  rows_acc = [r[0] for r in rows_acc]
  cols_acc = [c[0] for c in cols_acc]
  empty = torch.zeros(0, dtype=torch.int32, device=seeds.device)
  row = torch.cat(rows_acc) if rows_acc else empty
  col = torch.cat(cols_acc) if cols_acc else empty
  nse = (torch.stack([(r >= 0).sum() for r in rows_acc]).to(torch.int32)
         if rows_acc else empty)
  edge = None
  if with_edge:
    edge = (torch.cat([torch.where(r >= 0, e, INVALID_ID)
                       for r, e in zip(rows_acc, eids_acc)])
            if rows_acc else empty)
  return SamplerOutput(node=state.nodes, node_count=state.count, row=row,
                       col=col, edge=edge, edge_mask=row >= 0, batch=seeds,
                       num_sampled_nodes=nsn, num_sampled_edges=nse,
                       metadata={'seed_local': seed_local})


def link_negatives(indptr: torch.Tensor, indices: torch.Tensor,
                   src: torch.Tensor, neg: Optional[NegativeSampling],
                   candidates: Candidates,
                   num_cols: Optional[int] = None) -> list:
  """A link batch's negative seeds: with binary negatives ``[rows,
  cols]`` of ``ceil(amount * B)`` strict non-edges, with triplet ones
  ``[dst]``, ``ceil(amount)`` destinations per source flattened, else
  ``[]``.  Columns and destinations are drawn in ``[0, num_cols)``
  (default N; a bipartite edge type's destination type)."""
  if neg is None:
    return []
  if neg.is_binary():
    res = sample_negative(indptr, indices, neg.sample_size(src.shape[0]),
                          candidates, strict=True, padding=True,
                          num_cols=num_cols)
    return [res.rows, res.cols]
  return [triplet_negatives(indptr, indices, src, candidates,
                            int(np.ceil(float(neg.amount))),
                            num_nodes=num_cols).reshape(-1)]


def link_seeds(indptr: torch.Tensor, indices: torch.Tensor,
               src: torch.Tensor, dst: torch.Tensor,
               neg: Optional[NegativeSampling],
               candidates: Candidates) -> torch.Tensor:
  """The seeds of a link batch: ``[src, dst]``, then with binary
  negatives ``ceil(amount * B)`` strict non-edge rows and their columns,
  with triplet negatives ``ceil(amount)`` destinations per source."""
  return torch.cat([src, dst] + link_negatives(indptr, indices, src, neg,
                                               candidates))


def link_metadata(seed_local: torch.Tensor, src: torch.Tensor,
                  dst: torch.Tensor, label: Optional[torch.Tensor],
                  neg: Optional[NegativeSampling]) -> dict:
  """A link batch's label indices from its seeds' local ids (the order
  of `link_seeds`): without negatives or with binary ones
  ``edge_label_index [2, B + negatives]``, ``edge_label`` (the given
  labels, or ones, then zeros for the negatives) and
  ``edge_label_mask`` (the positive pairs' validity, then true); with
  triplet ones ``src_index``, ``dst_pos_index``, ``dst_neg_index [B,
  amount]`` and ``pair_mask``; always ``seed_local``."""
  b = src.shape[0]
  sl = seed_local
  pair_valid = (src >= 0) & (dst >= 0)
  if neg is not None and neg.is_triplet():
    return {'src_index': sl[:b], 'dst_pos_index': sl[b:2 * b],
            'dst_neg_index': sl[2 * b:].reshape(b, -1),
            'pair_mask': pair_valid, 'seed_local': sl}
  if label is None:
    label = torch.ones(b, dtype=torch.int32, device=src.device)
  nn = (sl.shape[0] - 2 * b) // 2
  return {
      'edge_label_index': torch.stack([
          torch.cat([sl[:b], sl[2 * b:2 * b + nn]]),
          torch.cat([sl[b:2 * b], sl[2 * b + nn:]])]),
      'edge_label': torch.cat([label, label.new_zeros(nn)]),
      'edge_label_mask': torch.cat([pair_valid, torch.ones(
          nn, dtype=torch.bool, device=src.device)]),
      'seed_local': sl}


def as_ids(ids, device) -> torch.Tensor:
  """Seed ids (a tensor or anything numpy takes) as int32 on
  ``device``."""
  if isinstance(ids, torch.Tensor):
    return ids.to(device, torch.int32)
  return torch.from_numpy(np.asarray(ids, dtype=np.int32)).to(device)


def _as_labels(label, device) -> Optional[torch.Tensor]:
  """Edge labels on ``device`` in the JAX package's dtypes (64-bit
  integers and floats narrowed to 32 bits)."""
  if label is None:
    return None
  t = label if isinstance(label, torch.Tensor) else torch.from_numpy(
      np.asarray(label))
  if t.dtype == torch.int64:
    t = t.to(torch.int32)
  elif t.dtype == torch.float64:
    t = t.to(torch.float32)
  return t.to(device)


class NeighborSampler(BaseSampler):
  """Uniform multi-hop neighbor sampler over a `data.Graph`.

  Args:
    graph: the graph, on ``device``.
    num_neighbors: per-hop fanouts, e.g. ``[15, 10, 5]``.
    device: where the sampler runs (default ``'cuda'``); must be the
      graph's device.
    with_edge: emit the sampled edges' global ids (``edge``): the
      graph's ``edge_ids``, or CSR positions where it has none.
    seed: seeds the default draws providers.
    draws / neg_draws: the hop and the negative-candidate draws
      providers (module docstring).
  """

  def __init__(self, graph: Graph, num_neighbors: Sequence[int],
               device='cuda', with_edge: bool = False, seed: int = 0,
               draws: Optional[Draws] = None,
               neg_draws: Optional[NegDraws] = None):
    self.device = resolve_device(device)
    if graph.device != self.device:
      raise ValueError(f'the graph lives on {graph.device}, the sampler '
                       f'on {self.device}')
    self.graph = graph
    self.with_edge = bool(with_edge)
    self.num_neighbors = tuple(int(k) for k in num_neighbors)
    default = TorchDraws(seed, self.device)
    self.draws = draws if draws is not None else default
    self.neg_draws = neg_draws if neg_draws is not None else default.negatives
    self._step = 0

  def node_capacity(self, batch_size: int) -> int:
    cap = max_sampled_nodes(batch_size, self.num_neighbors)
    cap = min(cap, batch_size + self.graph.num_nodes)
    return round_up(cap, 8)

  def _ids(self, ids) -> torch.Tensor:
    return as_ids(ids, self.device)

  def _closure(self, seeds: torch.Tensor, with_edge: bool) -> SamplerOutput:
    self._step += 1
    return _multihop_sample(self.graph.indptr, self.graph.indices, seeds,
                            self.num_neighbors,
                            self.node_capacity(seeds.shape[0]), self.draws,
                            self._step,
                            self.graph.edge_ids if with_edge else None,
                            with_edge)

  def sample_from_nodes(self, inputs: NodeSamplerInput,
                        **kwargs) -> SamplerOutput:
    """Sample the multi-hop neighborhood of ``inputs.node`` (``[B]``
    ids, -1 padded).  Enqueues on the card and returns without
    synchronising."""
    return self._closure(self._ids(inputs.node), self.with_edge)

  def sample_from_edges(self, inputs: EdgeSamplerInput,
                        neg_sampling: Optional[NegativeSampling] = None,
                        **kwargs) -> SamplerOutput:
    """Sample around seed edges (``[B]`` endpoints, (-1, -1) padded) and
    their negatives (``neg_sampling``, else ``inputs.neg_sampling``):
    the seeds of `link_seeds` through `sample_from_nodes`, the metadata
    of `link_metadata`.  Takes two steps (module docstring)."""
    if inputs.input_type is not None:
      raise ValueError('seed edges of an edge type need a '
                       'HeteroNeighborSampler over a heterogeneous graph')
    neg = NegativeSampling.cast(neg_sampling) or inputs.neg_sampling
    src, dst = self._ids(inputs.row), self._ids(inputs.col)
    self._step += 1
    step = self._step

    def candidates(stream, trials, r, high):
      return self.neg_draws(step, stream, trials, r, high)
    seeds = link_seeds(self.graph.indptr, self.graph.indices, src, dst, neg,
                       candidates)
    out = self._closure(seeds, self.with_edge)
    out.metadata = link_metadata(out.metadata['seed_local'], src, dst,
                                 _as_labels(inputs.label, self.device), neg)
    return out

  def subgraph(self, inputs: NodeSamplerInput,
               max_degree: Optional[int] = None, **kwargs) -> SamplerOutput:
    """The multi-hop closure of ``inputs.node``, then every edge among
    the closure's nodes (`ops.subgraph.induced_subgraph`), for SEAL's
    enclosing subgraphs.  ``max_degree`` caps each node's neighbor
    window (default the graph's maximum degree: exact); the metadata's
    ``mapping`` is the seeds' local ids.  The closure samples without
    edge ids, as in JAX; with ``with_edge`` the induced edges carry
    theirs."""
    seeds = self._ids(inputs.node)
    out = self._closure(seeds, False)
    max_deg = max(int(max_degree) if max_degree else self.graph.max_degree,
                  1)
    sub = induced_subgraph(self.graph.indptr, self.graph.indices, out.node,
                           max_degree=max_deg,
                           edge_ids=(self.graph.edge_ids if self.with_edge
                                     else None),
                           with_edge_ids=self.with_edge)
    sl = out.metadata['seed_local']
    return SamplerOutput(node=out.node, node_count=out.node_count,
                         row=sub.rows, col=sub.cols, edge=sub.eids,
                         edge_mask=sub.edge_mask,
                         batch=seeds, num_sampled_nodes=out.num_sampled_nodes,
                         metadata={'seed_local': sl, 'mapping': sl})

  def sample_prob(self, seed_ids, num_nodes=None):
    raise NotImplementedError('sample_prob (the frequency partitioner\'s '
                              'visit probability) is not ported yet: it '
                              'is slice 11 of the ROADMAP')
