"""`NeighborLoader`: a `NodeLoader` over a `sampler.NeighborSampler`, or
a `sampler.HeteroNeighborSampler` on a heterogeneous dataset (the JAX
package's `loader/neighbor_loader.py:15-49`) — the per-batch training
paths of BASELINE configs 1 and 4."""
from __future__ import annotations

from typing import Callable, Optional

from ..sampler.hetero_neighbor_sampler import HeteroNeighborSampler
from ..sampler.neighbor_sampler import NeighborSampler
from .node_loader import NodeLoader


class NeighborLoader(NodeLoader):
  """Multi-hop uniform neighbor-sampling loader.

  Example::

      loader = NeighborLoader(ds, [15, 10, 5], train_idx,
                              batch_size=1024, shuffle=True, seed=0)
      step = make_supervised_step(model, optimizer, 1024)
      for batch in loader:
        loss, correct = step(batch)

  On a heterogeneous dataset::

      loader = NeighborLoader(ds, [4, 4], ('paper', train_idx),
                              batch_size=256, shuffle=True, seed=0)
      for batch in loader:        # HeteroBatch
        logits = model(batch.x_dict, batch.edge_index_dict,
                       batch.edge_mask_dict)

  Args:
    data: a `data.Dataset` on ``device``.
    num_neighbors: per-hop fanouts (heterogeneous: one list for every
      edge type, or ``{EdgeType: list}``).
    input_nodes: seed ids (or a boolean mask); ``(node_type, ids)`` on
      a heterogeneous dataset.
    with_edge: emit the sampled edges' ids (``Batch.edge``) and, where
      the dataset has edge features, their rows (``edge_attr``; on a
      heterogeneous dataset ``edge_attr_dict`` by emitted edge type).
    seed: seeds the shuffle and the default draws provider.
    draws: the sampler's draws provider (`sampler.neighbor_sampler`,
      `sampler.hetero_neighbor_sampler`).
    device: where sampling runs (default ``'cuda'``): the dataset's
      device.
    prefetch: batches prepared ahead on a worker thread (`NodeLoader`).
  """

  def __init__(self, data, num_neighbors, input_nodes, batch_size: int = 1,
               shuffle: bool = False, drop_last: bool = False,
               with_edge: bool = False, seed: Optional[int] = None,
               draws: Optional[Callable] = None, device='cuda',
               prefetch: int = 0):
    if data.is_hetero:
      sampler = HeteroNeighborSampler(
          data.get_graph(), num_neighbors, device=device,
          with_edge=with_edge, num_nodes=data.num_nodes_dict(),
          seed=seed or 0, draws=draws)
    else:
      sampler = NeighborSampler(data.get_graph(), num_neighbors,
                                device=device, with_edge=with_edge,
                                seed=seed or 0, draws=draws)
    super().__init__(data, sampler, input_nodes, batch_size=batch_size,
                     shuffle=shuffle, drop_last=drop_last, seed=seed,
                     prefetch=prefetch)
