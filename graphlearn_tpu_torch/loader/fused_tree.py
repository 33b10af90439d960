"""Tree-layout multi-hop expansion, shared by serving and training, and
the tree-layout training epoch `FusedTreeEpoch` (the JAX package's
`loader/fused_tree.py:64-260`).

A tree step keeps the sampler's native layout end to end: per hop one
sampler launch expands the level frontier to ``[F_t, k]`` windows (no
dedup, no sort), each level's features come from one row-gather
launch, and `models.TreeSAGE` aggregates by reshape and masked mean.

`FusedTreeEpoch` runs on the fused epochs' driver (`loader.fused`): the
schedule and draw coordinates of the JAX package's epochs, and on a
card one captured CUDA graph per step kind, replayed every step.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..models.tree import tree_level_sizes
from ..ops.fused_sample import sample_one_hop_fused
from ..ops.neighbor import default_window
from .fused import EpochDraws, _SupervisedEpoch
from .transform import _gather_labels

#: ``draws(t, k, w) -> (u [F_t, k], gumbel [F_t, w])`` for the hop-``t``
#: frontier of ``F_t`` rows
Draws = Callable[[int, int, int], Tuple[torch.Tensor, torch.Tensor]]


def expand_tree_levels(indptr: torch.Tensor, indices: torch.Tensor,
                       seeds: torch.Tensor, fanouts: Sequence[int],
                       draws: Draws
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
  """``[B]`` seeds -> per-level ``(levels, masks)``: ``levels[t]`` is
  ``[B * k_1 ... k_t]`` int32 node ids (INVALID_ID where masked), each
  parent's ``k_{t+1}`` children contiguous — the layout
  `models.tree.TreeSAGE` consumes.  One sampler launch per hop, with
  the window ``default_window(k)``."""
  levels, masks = [seeds], [seeds >= 0]
  frontier = seeds
  for t, k in enumerate(fanouts):
    u, gumbel = draws(t, int(k), default_window(k))
    nxt = sample_one_hop_fused(indptr, indices, frontier, int(k), u,
                               gumbel).nbrs.reshape(-1)
    levels.append(nxt)
    masks.append(nxt >= 0)
    frontier = nxt
  return levels, masks


class FusedTreeEpoch(_SupervisedEpoch):
  """Tree-layout supervised epochs.

  Example::

      model = TreeSAGE(100, 256, 47, num_layers=3).to('cuda')
      opt = torch.optim.Adam(model.parameters(), lr=3e-3,
                             capturable=True)
      fused = FusedTreeEpoch(ds, [15, 10, 5], train_idx, model, opt,
                             batch_size=1024, seed=0)
      for _ in range(epochs):
        stats = fused.run()
      acc = fused.evaluate(test_idx)

  Args:
    data: a `data.Dataset` on ``device`` with node features and labels.
    num_neighbors: per-hop fanouts; ``len == model.num_layers``.
    input_nodes: seed ids (or a boolean mask).
    model: a `models.TreeSAGE` (or a module with its ``(xs, masks) ->
      [B, C]`` signature) on ``device``; trained in place.
    optimizer: a `torch.optim.Optimizer` over the model's parameters;
      on a card built with ``capturable=True`` (else ValueError).
    batch_size / shuffle / drop_last / seed: epoch controls.
    max_steps_per_program: the chunk length of the draw schedule
      (`loader.fused`); None keeps the epoch one chunk.
    remat: recompute the model's forward in the backward; `evaluate`
      runs without it.
    draws: the ``draws(epoch, chunk, step, hop, rows, k, w)`` provider;
      default `ops.draws.CounterDraws` on ``device``.
    device: where training runs (default ``'cuda'``).
  """

  _owner = 'FusedTreeEpoch'

  def __init__(self, data, num_neighbors: Sequence[int], input_nodes,
               model, optimizer: torch.optim.Optimizer, batch_size: int,
               shuffle: bool = True, drop_last: bool = False,
               seed: Optional[int] = None,
               max_steps_per_program: Optional[int] = None,
               remat: bool = False, draws: Optional[EpochDraws] = None,
               device='cuda'):
    self.fanouts = tuple(int(k) for k in num_neighbors)
    if getattr(model, 'num_layers', len(self.fanouts)) != len(self.fanouts):
      raise ValueError(
          f'model.num_layers={model.num_layers} must equal '
          f'len(num_neighbors)={len(self.fanouts)}')
    self._init_driver(data, input_nodes, model, optimizer, batch_size,
                      shuffle, drop_last, seed, max_steps_per_program,
                      draws, remat, device)
    self._sizes = tree_level_sizes(self.batch_size, self.fanouts)

  def _sample(self, seeds: torch.Tensor, draws):
    return expand_tree_levels(
        self._graph.indptr, self._graph.indices, seeds, self.fanouts,
        lambda t, k, w: draws(t, self._sizes[t], k, w))

  def _gather(self, sample, seeds: torch.Tensor):
    """Each level's features (one row-gather launch per level) and the
    seeds' labels."""
    levels, masks = sample
    xs = [self._feat.get(lvl) for lvl in levels]
    return (xs, masks), _gather_labels(self._labels, seeds)
