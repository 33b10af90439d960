"""Uniform multi-hop neighbor sampling on one card (the JAX package's
`sampler/neighbor_sampler.py:44-142,164-247`, homogeneous node path).

Per hop, `_multihop_sample` samples the frontier of newly discovered
nodes with the one-hop sampler kernel (`ops.fused_sample.
sample_one_hop_fused`, rows in ascending seed order) and inserts the
neighbors into the node table (`ops.unique.expand_hops`, shared with
the mesh sampler).  The node table grows hop by hop, as in JAX: each
hop's insertion sorts the current capacity plus the hop's ``F * k`` new
slots, not the final bound, and the table is padded to ``node_cap`` at
the end.

Random numbers come from a ``draws(step, hop, rows, k, w) -> (u [rows,
k], gumbel [rows, w])`` provider, where ``step`` counts
`sample_from_nodes` calls from 1, ``rows`` is the hop's frontier width
(``B``, ``B*k_1``, ...) and draw row ``j`` belongs to the ``j``-th
frontier row in ascending seed order (invalid rows last).  The default
is `ops.draws.TorchDraws` on the sampler's device; the parity tests
replay the JAX sampler's keys: ``key = fold_in(key(seed), step)``, hop
``i`` ``fold_in(key, i)``, split into the uniform and the Gumbel
stream.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.graph import Graph
from ..ops.draws import TorchDraws
from ..ops.fused_sample import sample_one_hop_fused
from ..ops.neighbor import default_window
from ..ops.unique import InducerState, expand_hops
from ..utils.device import resolve_device
from ..utils.padding import max_sampled_nodes, round_up
from .base import BaseSampler, NodeSamplerInput, SamplerOutput

Draws = Callable[[int, int, int, int, int], Tuple[torch.Tensor, torch.Tensor]]


def _multihop_sample(indptr: torch.Tensor, indices: torch.Tensor,
                     seeds: torch.Tensor, fanouts: Sequence[int],
                     node_cap: int, draws: Draws, step: int
                     ) -> SamplerOutput:
  """One multi-hop sample of ``[B]`` int32 seeds (-1 padded)."""
  def one_hop(hop, frontier, k):
    u, gumbel = draws(step, hop, frontier.shape[1], k, default_window(k))
    res = sample_one_hop_fused(indptr, indices, frontier[0], k, u, gumbel,
                               sort_locality=True)
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
  return SamplerOutput(node=state.nodes, node_count=state.count, row=row,
                       col=col, edge_mask=row >= 0, batch=seeds,
                       num_sampled_nodes=nsn, num_sampled_edges=nse,
                       metadata={'seed_local': seed_local})


class NeighborSampler(BaseSampler):
  """Uniform multi-hop neighbor sampler over a `data.Graph`.

  Args:
    graph: the graph, on ``device``.
    num_neighbors: per-hop fanouts, e.g. ``[15, 10, 5]``.
    device: where the sampler runs (default ``'cuda'``); must be the
      graph's device.
    with_edge: global edge ids on sampled edges — not ported (slice 7).
    seed: seeds the default draws provider.
    draws: the draws provider (module docstring).
  """

  def __init__(self, graph: Graph, num_neighbors: Sequence[int],
               device='cuda', with_edge: bool = False, seed: int = 0,
               draws: Optional[Draws] = None):
    self.device = resolve_device(device)
    if graph.device != self.device:
      raise ValueError(f'the graph lives on {graph.device}, the sampler '
                       f'on {self.device}')
    if with_edge:
      raise NotImplementedError('with_edge (sampled edge ids) is not '
                                'ported yet: it is slice 7 of the ROADMAP')
    self.graph = graph
    self.num_neighbors = tuple(int(k) for k in num_neighbors)
    self.draws = draws if draws is not None else TorchDraws(seed,
                                                            self.device)
    self._step = 0

  def node_capacity(self, batch_size: int) -> int:
    cap = max_sampled_nodes(batch_size, self.num_neighbors)
    cap = min(cap, batch_size + self.graph.num_nodes)
    return round_up(cap, 8)

  def sample_from_nodes(self, inputs: NodeSamplerInput,
                        **kwargs) -> SamplerOutput:
    """Sample the multi-hop neighborhood of ``inputs.node`` (``[B]``
    ids, -1 padded).  Enqueues on the card and returns without
    synchronising."""
    node = inputs.node
    if isinstance(node, torch.Tensor):
      seeds = node.to(self.device, torch.int32)
    else:
      seeds = torch.from_numpy(np.asarray(node, dtype=np.int32)).to(
          self.device)
    self._step += 1
    return _multihop_sample(self.graph.indptr, self.graph.indices, seeds,
                            self.num_neighbors,
                            self.node_capacity(seeds.shape[0]), self.draws,
                            self._step)

  def sample_from_edges(self, inputs, **kwargs):
    raise NotImplementedError('link sampling is not ported yet: it is '
                              'slice 7 of the ROADMAP')

  def subgraph(self, inputs, **kwargs):
    raise NotImplementedError('induced-subgraph sampling is not ported '
                              'yet: it is slice 7 of the ROADMAP')

  def sample_prob(self, seed_ids, num_nodes=None):
    raise NotImplementedError('sample_prob (the frequency partitioner\'s '
                              'visit probability) is not ported yet: it '
                              'is slice 11 of the ROADMAP')
