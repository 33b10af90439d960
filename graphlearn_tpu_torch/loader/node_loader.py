"""Node-wise loading (the JAX package's `loader/node_loader.py`).

`SeedBatcher` is the host-side seed iterator: shuffle with numpy's
`default_rng(seed)`, slice, and pad the tail batch to the static batch
size with -1, so a seeded run visits seeds in the JAX package's order.
`NodeLoader` runs a sampler on each seed batch and collates the result
(`loader.transform.collate`) into a `Batch`; with ``prefetch=N`` a
worker thread prepares the next batches (`loader.prefetch`)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..sampler.base import BaseSampler, NodeSamplerInput
from ..utils.padding import INVALID_ID
from .prefetch import PrefetchingLoader
from .transform import Batch, collate


class SeedBatcher:
  """Iterate ``[N]`` seed ids in (optionally shuffled) batches of
  ``batch_size`` int32 ids; each ``iter()`` is a new epoch with its own
  order."""

  def __init__(self, seeds, batch_size: int, shuffle: bool = False,
               drop_last: bool = False, seed: Optional[int] = None):
    self.seeds = np.asarray(seeds).reshape(-1)
    self.batch_size = int(batch_size)
    self.shuffle = shuffle
    self.drop_last = drop_last
    self._rng = np.random.default_rng(seed)

  def __len__(self) -> int:
    n = len(self.seeds)
    if self.drop_last:
      return n // self.batch_size
    return -(-n // self.batch_size)

  def __iter__(self):
    n = len(self.seeds)
    order = self._rng.permutation(n) if self.shuffle else np.arange(n)
    return self._epoch(order)

  def _epoch(self, order: np.ndarray):
    n = len(self.seeds)
    for pos in range(0, n, self.batch_size):
      end = pos + self.batch_size
      if end > n and self.drop_last:
        return
      batch = self.seeds[order[pos:end]].astype(np.int32)
      if len(batch) < self.batch_size:
        out = np.full(self.batch_size, INVALID_ID, np.int32)
        out[:len(batch)] = batch
        batch = out
      yield batch


class NodeLoader(PrefetchingLoader):
  """Seeds -> sampler -> collate.

  Args:
    data: the `data.Dataset` (graph, features, labels).
    sampler: a `sampler.BaseSampler` with ``sample_from_nodes``.
    input_nodes: ``[N]`` seed ids or a boolean mask (e.g. the train
      split).
    batch_size / shuffle / drop_last / seed: epoch iteration.
    prefetch: batches a worker thread prepares ahead, on its own CUDA
      stream on the card (0 = off; 2 = double buffering, which hides a
      tiered store's per-batch host step behind the training step).

  Each ``iter()`` starts a new epoch.  A batch's work is enqueued on
  the card; nothing here synchronises.
  """

  def __init__(self, data, sampler: BaseSampler, input_nodes,
               batch_size: int = 1, shuffle: bool = False,
               drop_last: bool = False, seed: Optional[int] = None,
               prefetch: int = 0):
    self.prefetch = int(prefetch)
    self.data = data
    self.sampler = sampler
    self._prefetch_device = getattr(sampler, 'device', None)
    input_nodes = np.asarray(input_nodes)
    if input_nodes.dtype == np.bool_:
      input_nodes = np.nonzero(input_nodes)[0]
    self._batcher = SeedBatcher(input_nodes, batch_size, shuffle, drop_last,
                                seed)
    self.batch_size = int(batch_size)

  def __len__(self) -> int:
    return len(self._batcher)

  def _produce(self, seed_iter) -> Batch:
    seeds = next(seed_iter)
    return self._collate_fn(self.sampler.sample_from_nodes(
        NodeSamplerInput(node=seeds)))

  def _collate_fn(self, out) -> Batch:
    return collate(self.data, out)
