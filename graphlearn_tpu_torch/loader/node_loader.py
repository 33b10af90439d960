"""Node-wise loading (the JAX package's `loader/node_loader.py`).

`SeedBatcher` is the host-side seed iterator: shuffle with numpy's
`default_rng(seed)`, slice, and pad the tail batch to the static batch
size with -1, so a seeded run visits seeds in the JAX package's order.
Its `state_dict` is laid out as JAX's, so either package's batcher
state loads into the other's.
`NodeLoader` runs a sampler on each seed batch and collates the result
(`loader.transform.collate`) into a `Batch` (a `HeteroBatch` on a
heterogeneous graph); with ``prefetch=N`` a
worker thread prepares the next batches (`loader.prefetch`)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..sampler.base import BaseSampler, NodeSamplerInput
from ..utils.checkpoint import pack_rng_state, restore_rng_state
from ..utils.padding import INVALID_ID
from .prefetch import PrefetchingLoader
from .transform import collate


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
    self.epochs_started = 0
    self._epoch_start_rng = None   # the packed RNG state at the last iter()

  def __len__(self) -> int:
    n = len(self.seeds)
    if self.drop_last:
      return n // self.batch_size
    return -(-n // self.batch_size)

  def __iter__(self):
    # the state BEFORE this epoch's draw: a mid-epoch resume re-draws
    # the interrupted epoch's permutation from it
    self._epoch_start_rng = pack_rng_state(self._rng)
    self.epochs_started += 1
    n = len(self.seeds)
    order = self._rng.permutation(n) if self.shuffle else np.arange(n)
    return self._epoch(order)

  # -- DataPlaneState (`utils.checkpoint`) -----------------------------------
  def state_dict(self) -> dict:
    """``rng``: the current stream (an epoch-boundary resume point);
    ``epoch_rng``: the stream at the last epoch's start (a mid-epoch
    resume re-draws that epoch's permutation); ``epochs_started``."""
    now = pack_rng_state(self._rng)
    return {'rng': now,
            'epoch_rng': (self._epoch_start_rng
                          if self._epoch_start_rng is not None else now),
            'epochs_started': self.epochs_started}

  def load_state_dict(self, state: dict, mid_epoch: bool = False) -> None:
    """``mid_epoch=True`` rewinds the RNG to the interrupted epoch's start
    (the next ``iter()`` re-draws its permutation) and takes that epoch
    back off ``epochs_started``; False resumes at the epoch boundary."""
    self.epochs_started = int(np.asarray(state['epochs_started']))
    if mid_epoch:
      restore_rng_state(self._rng, state['epoch_rng'])
      self.epochs_started = max(self.epochs_started - 1, 0)
    else:
      restore_rng_state(self._rng, state['rng'])

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
      split); on a heterogeneous graph ``(node_type, ids)``.
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
    self.input_type = None
    if isinstance(input_nodes, tuple) and isinstance(input_nodes[0], str):
      self.input_type, input_nodes = input_nodes
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
        NodeSamplerInput(node=seeds, input_type=self.input_type)))

  def _collate_fn(self, out):
    return collate(self.data, out)
