"""`NeighborLoader`: a `NodeLoader` over a `sampler.NeighborSampler`
(the JAX package's `loader/neighbor_loader.py:15-49`, homogeneous) —
the per-batch training path of BASELINE config 1."""
from __future__ import annotations

from typing import Optional

from ..sampler.neighbor_sampler import Draws, NeighborSampler
from .node_loader import NodeLoader


class NeighborLoader(NodeLoader):
  """Multi-hop uniform neighbor-sampling loader.

  Example::

      loader = NeighborLoader(ds, [15, 10, 5], train_idx,
                              batch_size=1024, shuffle=True, seed=0)
      step = make_supervised_step(model, optimizer, 1024)
      for batch in loader:
        loss, correct = step(batch)

  Args:
    data: a homogeneous `data.Dataset` on ``device``.
    num_neighbors: per-hop fanouts.
    input_nodes: seed ids (or a boolean mask).
    seed: seeds the shuffle and the default draws provider.
    draws: the sampler's draws provider (`sampler.neighbor_sampler`).
    device: where sampling runs (default ``'cuda'``): the dataset's
      device.
  """

  def __init__(self, data, num_neighbors, input_nodes, batch_size: int = 1,
               shuffle: bool = False, drop_last: bool = False,
               with_edge: bool = False, seed: Optional[int] = None,
               draws: Optional[Draws] = None, device='cuda'):
    sampler = NeighborSampler(data.get_graph(), num_neighbors,
                              device=device, with_edge=with_edge,
                              seed=seed or 0, draws=draws)
    super().__init__(data, sampler, input_nodes, batch_size=batch_size,
                     shuffle=shuffle, drop_last=drop_last, seed=seed)
