"""`RandomNegativeSampler` (the JAX package's
`sampler/negative_sampler.py`): random non-edges of a graph as a ``[2,
req_num]`` edge index, through `ops.negative.sample_negative`."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..data.graph import Graph
from ..ops.draws import TorchDraws
from ..ops.negative import sample_negative
from ..utils.device import resolve_device


class RandomNegativeSampler:
  """Draw random non-edges of ``graph``.

  Args:
    graph: the graph, on ``device``.
    seed: seeds the default candidates provider.
    device: where sampling runs (default ``'cuda'``); the graph's.
    neg_draws: ``neg_draws(step, stream, trials, r, high) -> [trials,
      r]`` int32 candidates (`sampler.neighbor_sampler`); ``step``
      counts `sample` calls from 1.  Default `ops.draws.TorchDraws`.
  """

  def __init__(self, graph: Graph, seed: int = 0, device='cuda',
               neg_draws: Optional[Callable] = None):
    self.device = resolve_device(device)
    if graph.device != self.device:
      raise ValueError(f'the graph lives on {graph.device}, the sampler '
                       f'on {self.device}')
    self.graph = graph
    self.neg_draws = (neg_draws if neg_draws is not None
                      else TorchDraws(seed, self.device).negatives)
    self._step = 0

  def sample(self, req_num: int, trials_num: int = 5,
             padding: bool = True) -> torch.Tensor:
    """``[2, req_num]`` int32 pairs, each the first of ``trials_num``
    candidates that is not an edge; with ``padding`` the output is full
    (a slot with no non-edge keeps its last candidate), without it such
    slots hold -1."""
    self._step += 1
    step = self._step

    def candidates(stream, trials, r, high):
      return self.neg_draws(step, stream, trials, r, high)
    res = sample_negative(self.graph.indptr, self.graph.indices,
                          int(req_num), candidates, trials=int(trials_num),
                          strict=True, padding=padding)
    return torch.stack([res.rows, res.cols])
