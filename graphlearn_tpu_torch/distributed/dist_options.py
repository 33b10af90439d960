"""Loader deployment options (the JAX package's `distributed/dist_options.py`;
reference `distributed/dist_options.py:26-265`).

Three modes, same trio as the reference:

  * **Collocated** — sampling runs synchronously in the training
    process (`_BasicDistSamplingWorkerOptions` + `Collocated…`, `:119`).
  * **Mp** — a pool of sampling subprocesses per trainer feeding a
    `ShmChannel` (`MpDistSamplingWorkerOptions`, `:145-199`).
  * **Remote** — sampling runs on dedicated server hosts; the trainer
    pulls over sockets (`RemoteDistSamplingWorkerOptions`, `:202-258`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Union

import numpy as np


def binary_num_negatives(batch: int, amount: float) -> int:
  """Binary-mode negative count for a ``batch``-edge seed slice — the
  ONE definition shared by the sampler, the capacity plan and the
  metadata collation (a rounding mismatch between them undersizes
  static buffers; it happened once)."""
  return int(np.ceil(batch * amount))


@dataclass
class HostSamplingConfig:
  """What the producers sample per seed batch (reference
  ``SamplingConfig``, `sampler/base.py:334-346`: the NODE/LINK/SUBGRAPH
  dispatch carried into sampling workers).

  Attributes:
    sampling_type: ``'node'`` (seed ids), ``'link'`` (seed edge pairs,
      optional third label column), or ``'subgraph'`` (induced
      enclosing subgraphs).
    neg_mode / neg_amount: link-mode negative sampling spec.
    input_type: hetero seed type — a node type (node mode) or an edge
      type 3-tuple (link mode); None for homogeneous datasets.
    peer_addrs: partitioned deployments only — ``[(host, port), ...]``
      of every partition's `PartitionService` (index = partition):
      producers fed a SHARD dataset build a cross-server
      `HostDistNeighborSampler` fanning each hop/feature lookup out to
      these peers (reference `_sample_one_hop` remote path,
      `dist_neighbor_sampler.py:542-598`).  None + full dataset =
      plain local sampler; None + shard dataset = refused.
  """
  sampling_type: str = 'node'
  neg_mode: Optional[str] = None       # 'binary' | 'triplet'
  neg_amount: float = 1.0
  input_type: Union[str, tuple, None] = None
  peer_addrs: Optional[tuple] = None

  def expansion_seeds(self, batch_size: int) -> int:
    """EXACT number of node seeds entering multi-hop expansion for a
    full seed batch — matches ``HostNeighborSampler``'s seed
    construction via :func:`binary_num_negatives`."""
    b = int(batch_size)
    if self.sampling_type != 'link':
      return b
    if self.neg_mode == 'binary':
      return 2 * b + 2 * binary_num_negatives(b, self.neg_amount)
    if self.neg_mode == 'triplet':
      return 2 * b + b * int(np.ceil(self.neg_amount))
    return 2 * b

  def label_cap(self, batch_size: int) -> int:
    """Static width of ``edge_label_index`` / ``edge_label``."""
    b = int(batch_size)
    if self.neg_mode == 'binary':
      return b + binary_num_negatives(b, self.neg_amount)
    return b

  def hetero_input_sizes(self, batch_size: int) -> dict:
    """Per-node-type seed counts entering hetero multi-hop expansion —
    the ``input_sizes`` of the capacity plan.  Node mode seeds one
    type; link mode seeds the input edge type's two endpoint types
    (merged when the relation is type-homophilous)."""
    b = int(batch_size)
    if self.sampling_type != 'link':
      assert isinstance(self.input_type, str), (
          'hetero node sampling needs a node-type input_type')
      return {self.input_type: b}
    s, _, d = self.input_type
    if self.neg_mode == 'binary':
      nn = binary_num_negatives(b, self.neg_amount)
      src_n, dst_n = b + nn, b + nn
    elif self.neg_mode == 'triplet':
      src_n, dst_n = b, b + b * int(np.ceil(self.neg_amount))
    else:
      src_n, dst_n = b, b
    if s == d:
      return {s: src_n + dst_n}
    return {s: src_n, d: dst_n}


@dataclass
class CollocatedDistSamplingWorkerOptions:
  """Sample in-process, synchronously."""
  use_native: bool = False       # accepted for parity: always the host sampler
  collect_features: bool = True


@dataclass
class MpDistSamplingWorkerOptions:
  """Spawn ``num_workers`` sampling subprocesses feeding a shm channel.

  Reference defaults: channel 64MB/worker, capacity scaled by pending
  batches (`dist_options.py:145-199`).
  """
  num_workers: int = 2
  worker_concurrency: int = 4           # pending batches per worker
  channel_capacity: Optional[int] = None  # default 4 * num_workers * conc
  channel_size: Union[int, str, None] = None  # default 64MB * num_workers
  collect_features: bool = True
  pin_memory: bool = False              # accepted for API parity; no-op
  #: 'forkserver' (default): workers descend from a clean, unthreaded
  #: server process with no CUDA context; the dataset is staged into
  #: POSIX shm once and attached zero-copy per worker
  #: (`shm_arrays.share_dataset`).  'fork' is opt-in zero-copy CoW —
  #: SAFE ONLY IF the parent has not initialised CUDA and is
  #: effectively single-threaded at Process.start() time: a fork can
  #: inherit runtime locks mid-operation (undebuggable child deadlocks;
  #: the CPython DeprecationWarning), and CUDA cannot be used in a
  #: forked child at all.  'spawn' also works (slower startup, shm
  #: staging as forkserver).
  mp_start_method: str = 'forkserver'

  def resolved_capacity(self) -> int:
    return (self.channel_capacity if self.channel_capacity is not None
            else 4 * self.num_workers * self.worker_concurrency)

  def resolved_size(self):
    if self.channel_size is not None:
      return self.channel_size
    return 64 * 1024 * 1024 * self.num_workers


@dataclass
class RemoteDistSamplingWorkerOptions:
  """Pull batches from sampling servers.

  Reference `dist_options.py:202-258`: server ranks, per-server buffer,
  client prefetch depth.
  """
  server_rank: Union[int, List[int], None] = None
  num_workers: int = 2
  worker_concurrency: int = 4
  buffer_capacity: int = 64
  buffer_size: Union[int, str] = '64MB'
  prefetch_size: int = 4
  collect_features: bool = True
  worker_key: str = ''
