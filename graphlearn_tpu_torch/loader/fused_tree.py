"""Tree-layout multi-hop expansion, shared by serving and training, and
the tree-layout training epoch `FusedTreeEpoch` (the JAX package's
`loader/fused_tree.py:64-260`).

A tree step keeps the sampler's native layout end to end: per hop one
sampler launch expands the level frontier to ``[F_t, k]`` windows (no
dedup, no sort), each level's features come from one row-gather
launch, and `models.TreeSAGE` aggregates by reshape and masked mean.

`FusedTreeEpoch` also carries the host driver of the JAX package's
supervised fused epochs (`loader/fused.py:465-683`,
`_SupervisedScanEpoch`'s `_chunks`, `run` and `evaluate`).  JAX runs
each chunk of an epoch as one `lax.scan` program; the port runs the same
steps as an eager loop on the card (CUDA-graph capture is later work).
What carries over exactly is the schedule: the host shuffle, the split
into chunks of ``max_steps_per_program`` steps whose tail is padded with
-1 seeds, and the draw coordinates of each step, ``draws(epoch, chunk,
step, hop, rows, k, w)``:

  * ``epoch`` counts `run` calls from 1; `evaluate` draws at epoch 0
    (JAX keys evaluation in its own fold domain, ``fold_in(fold_in(
    key(seed), 0), 1)``, and training at ``fold_in(key(seed), epoch)``);
  * ``chunk`` is the chunk's first step, or None when the epoch is one
    chunk (JAX then keys the steps from the epoch key itself);
  * ``step`` is the step's index within its chunk and ``hop`` the hop.

A fully padded step is skipped: no forward, no optimizer step, so
Adam's moments and step count do not move (JAX guards its scan body
the same way).  Nothing in `run` synchronises with the card; the
returned `EpochStats` does when read.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.train import _correct, supervised_loss
from ..models.tree import tree_level_sizes
from ..ops.draws import TorchDraws
from ..ops.fused_sample import sample_one_hop_fused
from ..ops.neighbor import default_window
from ..utils.device import resolve_device
from .fused import EpochStats
from .node_loader import SeedBatcher
from .transform import _gather_labels

#: ``draws(t, k, w) -> (u [F_t, k], gumbel [F_t, w])`` for the hop-``t``
#: frontier of ``F_t`` rows
Draws = Callable[[int, int, int], Tuple[torch.Tensor, torch.Tensor]]

#: ``draws(epoch, chunk, step, hop, rows, k, w) -> (u [rows, k],
#: gumbel [rows, w])``
EpochDraws = Callable[[int, Optional[int], int, int, int, int, int],
                      Tuple[torch.Tensor, torch.Tensor]]


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


class FusedTreeEpoch:
  """Tree-layout supervised epochs.

  Example::

      model = TreeSAGE(100, 256, 47, num_layers=3).to('cuda')
      opt = torch.optim.Adam(model.parameters(), lr=3e-3)
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
    optimizer: a `torch.optim.Optimizer` over the model's parameters.
    batch_size / shuffle / drop_last / seed: epoch controls.
    max_steps_per_program: the chunk length of the draw schedule
      (module docstring); None keeps the epoch one chunk.
    draws: the ``draws(epoch, chunk, step, hop, rows, k, w)`` provider;
      default `ops.draws.TorchDraws` on ``device``.
    device: where training runs (default ``'cuda'``).
  """

  def __init__(self, data, num_neighbors: Sequence[int], input_nodes,
               model, optimizer: torch.optim.Optimizer, batch_size: int,
               shuffle: bool = True, drop_last: bool = False,
               seed: Optional[int] = None,
               max_steps_per_program: Optional[int] = None,
               draws: Optional[EpochDraws] = None, device='cuda'):
    self.device = resolve_device(device)
    graph = data.get_graph()
    if graph.device != self.device:
      raise ValueError(f'the graph lives on {graph.device}, the epoch on '
                       f'{self.device}')
    if data.node_features is None:
      raise ValueError('FusedTreeEpoch needs node features on the card')
    labels = data.get_node_label_device()
    if labels is None:
      raise ValueError('FusedTreeEpoch needs node labels')
    self.fanouts = tuple(int(k) for k in num_neighbors)
    if getattr(model, 'num_layers', len(self.fanouts)) != len(self.fanouts):
      raise ValueError(
          f'model.num_layers={model.num_layers} must equal '
          f'len(num_neighbors)={len(self.fanouts)}')
    self.data = data
    self.model = model
    self.optimizer = optimizer
    self.batch_size = int(batch_size)
    self._graph = graph
    self._feat = data.node_features
    self._labels = labels
    self._sizes = tree_level_sizes(self.batch_size, self.fanouts)
    input_nodes = np.asarray(input_nodes)
    if input_nodes.dtype == np.bool_:
      input_nodes = np.nonzero(input_nodes)[0]
    self._batcher = SeedBatcher(input_nodes, self.batch_size, shuffle,
                                drop_last, seed)
    self._chunk = (int(max_steps_per_program)
                   if max_steps_per_program else None)
    if draws is None:
      default = TorchDraws(seed or 0, self.device)

      def draws(epoch, chunk, step, hop, rows, k, w):
        return default.draw((epoch, chunk or 0, step, hop), rows, k, w)
    self.draws = draws
    self._epoch_idx = 0

  def __len__(self) -> int:
    return len(self._batcher)

  def _chunks(self, seeds: np.ndarray
              ) -> Iterator[Tuple[int, np.ndarray]]:
    """``(chunk offset, [chunk, B] piece)``, the tail piece padded with
    -1 rows."""
    s = seeds.shape[0]
    chunk = self._chunk or s
    for c0 in range(0, s, chunk):
      part = seeds[c0:c0 + chunk]
      real = part.shape[0]
      if real < chunk:
        pad = np.full((chunk - real,) + seeds.shape[1:], -1, seeds.dtype)
        part = np.concatenate([part, pad])
      yield c0, part

  def _steps(self, seeds: np.ndarray, epoch: int):
    """``(seeds_i, draws_i)`` for every step of every chunk that holds
    a valid seed: ``seeds_i`` on the card (the epoch's seeds go up in
    one copy), ``draws_i(hop, rows, k, w)`` the step's draws."""
    parts = list(self._chunks(seeds))
    dev_all = torch.from_numpy(np.stack([p for _, p in parts])).to(
        self.device)
    for j, (c0, part) in enumerate(parts):
      chunk = None if len(parts) == 1 else c0
      for i in range(part.shape[0]):
        if not (part[i] >= 0).any():
          continue

        def draws(hop, rows, k, w, chunk=chunk, i=i):
          return self.draws(epoch, chunk, i, hop, rows, k, w)
        yield dev_all[j, i], draws

  def run(self) -> EpochStats:
    """One training epoch; returns its lazy `EpochStats`."""
    seeds = np.stack(list(self._batcher))
    self._epoch_idx += 1
    steps = [self._train_step(s, draws)
             for s, draws in self._steps(seeds, self._epoch_idx)]
    losses, correct, valid = (torch.stack(t) for t in zip(*steps))
    return EpochStats(losses, correct.sum(), valid.sum())

  def evaluate(self, input_nodes) -> float:
    """Accuracy over ``input_nodes`` (e.g. the test split)."""
    ids = np.asarray(input_nodes)
    if ids.dtype == np.bool_:
      ids = np.nonzero(ids)[0]
    if ids.size == 0:
      raise ValueError('evaluate() got an empty split')
    seeds = np.stack(list(SeedBatcher(ids, self.batch_size, shuffle=False)))
    counts = [self._eval_step(s, draws)
              for s, draws in self._steps(seeds, 0)]
    correct, total = (int(torch.stack(t).sum()) for t in zip(*counts))
    return correct / max(total, 1)

  def _expand(self, seeds: torch.Tensor, draws):
    """One step's levels, their features (one row-gather launch per
    level) and the seeds' labels."""
    levels, masks = expand_tree_levels(
        self._graph.indptr, self._graph.indices, seeds, self.fanouts,
        lambda t, k, w: draws(t, self._sizes[t], k, w))
    xs = [self._feat.get(lvl) for lvl in levels]
    return xs, masks, _gather_labels(self._labels, seeds)

  def _train_step(self, seeds: torch.Tensor, draws):
    xs, masks, y = self._expand(seeds, draws)
    self.model.train()
    self.optimizer.zero_grad(set_to_none=True)
    logits = self.model(xs, masks)
    loss = supervised_loss(logits, y, seeds, self.batch_size)
    loss.backward()
    self.optimizer.step()
    return (loss.detach(), _correct(logits, y, seeds, self.batch_size),
            (seeds >= 0).sum())

  @torch.no_grad()
  def _eval_step(self, seeds: torch.Tensor, draws):
    xs, masks, y = self._expand(seeds, draws)
    self.model.eval()
    logits = self.model(xs, masks)
    return _correct(logits, y, seeds, self.batch_size), (seeds >= 0).sum()
