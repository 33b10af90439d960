"""`SubGraphLoader` (the JAX package's `loader/subgraph_loader.py`): for
each seed batch the multi-hop closure, then every edge among its nodes
(`sampler.NeighborSampler.subgraph`), with ``mapping`` — the seeds'
local ids — in the batch metadata: SEAL's enclosing subgraphs
(BASELINE config 3)."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from ..sampler.base import NodeSamplerInput
from ..sampler.neighbor_sampler import NeighborSampler
from .node_loader import NodeLoader
from .transform import Batch


class SubGraphLoader(NodeLoader):
  """Induced subgraphs around seed batches.

  Example (one link's enclosing subgraph a batch)::

      loader = SubGraphLoader(ds, [8], pairs.reshape(-1), batch_size=2)
      for batch in loader:
        u, v = batch.metadata['mapping']

  Args:
    data: a homogeneous `data.Dataset` on ``device``.
    num_neighbors: per-hop fanouts bounding the closure.
    input_nodes: seed ids.
    with_edge: the induced edges' ids (``Batch.edge``) and, where the
      dataset has edge features, their rows (``edge_attr``).
    max_degree: a cap on each node's neighbor window in the induced-edge
      scan (default the graph's maximum degree: exact).
    draws: the sampler's draws provider (`sampler.neighbor_sampler`).
    device: where sampling runs (default ``'cuda'``).
    The rest as `NodeLoader`.
  """

  def __init__(self, data, num_neighbors: Sequence[int], input_nodes,
               batch_size: int = 1, shuffle: bool = False,
               drop_last: bool = False, with_edge: bool = False,
               max_degree: Optional[int] = None, seed: Optional[int] = None,
               draws: Optional[Callable] = None, device='cuda',
               prefetch: int = 0):
    if data.is_hetero:
      raise ValueError('SubGraphLoader needs a homogeneous Dataset')
    sampler = NeighborSampler(data.get_graph(), num_neighbors, device=device,
                              with_edge=with_edge, seed=seed or 0,
                              draws=draws)
    super().__init__(data, sampler, input_nodes, batch_size=batch_size,
                     shuffle=shuffle, drop_last=drop_last, seed=seed,
                     prefetch=prefetch)
    self.max_degree = max_degree

  def _produce(self, seed_iter) -> Batch:
    return self._collate_fn(self.sampler.subgraph(
        NodeSamplerInput(node=next(seed_iter)), max_degree=self.max_degree))
