"""Tree-layout multi-hop expansion, shared by serving (this slice) and
the tree-layout training epoch (a later slice)."""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from ..ops.fused_sample import sample_one_hop_fused
from ..ops.neighbor import default_window

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
