"""`SeedBatcher`: the host-side seed iterator of the node loaders (the
JAX package's `loader/node_loader.py:24`): shuffle with numpy's
`default_rng(seed)`, slice, and pad the tail batch to the static batch
size with -1, so a seeded run visits seeds in the JAX package's order."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.padding import INVALID_ID


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
