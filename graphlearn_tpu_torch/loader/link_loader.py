"""Link-prediction loaders (the JAX package's `loader/link_loader.py`):
iterate seed edges, sample around their endpoints and their negatives
(`sampler.NeighborSampler.sample_from_edges`), and collate batches whose
metadata carries the link labels.

As in JAX, binary negatives with user labels shift the labels up by
one, so 0 means "sampled negative", on valid pair slots only (a padded
slot keeps 0); the metadata names are PyG's (``edge_label_index`` /
``edge_label`` for binary, ``src_index`` / ``dst_pos_index`` /
``dst_neg_index`` for triplet) plus the padding masks.  On a
heterogeneous dataset the seed edges are of one edge type,
``(edge_type, (rows, cols))``, sampled by `sampler.HeteroNeighborSampler`
into a `HeteroBatch`.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from ..sampler.base import BaseSampler, EdgeSamplerInput, NegativeSampling
from ..sampler.hetero_neighbor_sampler import HeteroNeighborSampler
from ..sampler.neighbor_sampler import NeighborSampler
from ..utils.padding import INVALID_ID
from .node_loader import SeedBatcher
from .prefetch import PrefetchingLoader
from .transform import Batch, collate


def as_edge_pairs(edge_label_index):
  """``(edge_type, rows, cols)`` from a ``(rows, cols)`` pair or a
  ``[2, E]`` array (edge type None), or a heterogeneous ``(edge_type,
  (rows, cols))``."""
  etype = None
  if (isinstance(edge_label_index, tuple)
      and isinstance(edge_label_index[0], tuple)
      and len(edge_label_index[0]) == 3):
    etype, edge_label_index = edge_label_index
  if isinstance(edge_label_index, (tuple, list)):
    rows, cols = edge_label_index
    return etype, rows, cols
  ei = np.asarray(edge_label_index)
  return etype, ei[0], ei[1]


def shift_binary_labels(rows, cols, labels):
  """The binary +1 label shift on the valid pair slots (0 elsewhere)."""
  return np.where((rows >= 0) & (cols >= 0), labels + 1, 0)


class EdgeSeedBatcher:
  """Batches of ``(rows, cols, labels)`` seed edges (int32 ids, the tail
  padded with -1 and label 0), shuffled by `SeedBatcher`'s numpy
  order."""

  def __init__(self, rows, cols, labels=None, batch_size: int = 1,
               shuffle: bool = False, drop_last: bool = False,
               seed: Optional[int] = None):
    self.rows = np.asarray(rows).reshape(-1)
    self.cols = np.asarray(cols).reshape(-1)
    if len(self.rows) != len(self.cols):
      raise ValueError(f'{len(self.rows)} rows but {len(self.cols)} cols')
    self.labels = None if labels is None else np.asarray(labels).reshape(-1)
    self._idx = SeedBatcher(np.arange(len(self.rows)), batch_size, shuffle,
                            drop_last, seed)

  def __len__(self):
    return len(self._idx)

  def __iter__(self):
    for idx in self._idx:
      valid = idx >= 0
      safe = np.where(valid, idx, 0)
      r = np.where(valid, self.rows[safe], INVALID_ID).astype(np.int32)
      c = np.where(valid, self.cols[safe], INVALID_ID).astype(np.int32)
      lab = None
      if self.labels is not None:
        lab = np.where(valid, self.labels[safe], 0)
      yield r, c, lab

  # -- DataPlaneState: the cursor lives in the index batcher -----------------
  def state_dict(self) -> dict:
    return self._idx.state_dict()

  def load_state_dict(self, state: dict, mid_epoch: bool = False) -> None:
    self._idx.load_state_dict(state, mid_epoch=mid_epoch)


class LinkLoader(PrefetchingLoader):
  """Seed edges -> ``sampler.sample_from_edges`` -> collate.

  Args:
    data: the `data.Dataset`.
    sampler: a sampler with ``sample_from_edges``.
    edge_label_index: ``[2, E]`` or ``(rows, cols)`` seed edges;
      ``(edge_type, (rows, cols))`` on a heterogeneous dataset.
    edge_label: optional ``[E]`` labels.
    neg_sampling: a `sampler.NegativeSampling`, a mode string or a
      ``(mode, amount)`` tuple.
    batch_size / shuffle / drop_last / seed: epoch iteration.
    prefetch: batches a worker thread prepares ahead (`NodeLoader`).
  """

  def __init__(self, data, sampler: BaseSampler, edge_label_index,
               edge_label=None, neg_sampling=None, batch_size: int = 1,
               shuffle: bool = False, drop_last: bool = False,
               seed: Optional[int] = None, prefetch: int = 0):
    self.prefetch = int(prefetch)
    self.data = data
    self.sampler = sampler
    self._prefetch_device = getattr(sampler, 'device', None)
    self.input_type, rows, cols = as_edge_pairs(edge_label_index)
    if self.input_type is not None and not data.is_hetero:
      raise ValueError(f'seed edges of edge type {self.input_type} need a '
                       'heterogeneous dataset')
    self.neg_sampling = NegativeSampling.cast(neg_sampling)
    self._batcher = EdgeSeedBatcher(rows, cols, edge_label, batch_size,
                                    shuffle, drop_last, seed)
    self.batch_size = int(batch_size)

  def __len__(self):
    return len(self._batcher)

  def _produce(self, seed_iter) -> Batch:
    r, c, lab = next(seed_iter)
    if lab is not None and self.neg_sampling is not None \
        and self.neg_sampling.is_binary():
      lab = shift_binary_labels(r, c, lab)
    return self._collate_fn(self.sampler.sample_from_edges(
        EdgeSamplerInput(row=r, col=c, label=lab,
                         input_type=self.input_type,
                         neg_sampling=self.neg_sampling)))

  def _collate_fn(self, out) -> Batch:
    return collate(self.data, out)


class LinkNeighborLoader(LinkLoader):
  """A `LinkLoader` over a `sampler.NeighborSampler`: multi-hop uniform
  neighborhoods around every endpoint, the loader of unsupervised
  GraphSAGE (BASELINE config 2); on a heterogeneous dataset over a
  `sampler.HeteroNeighborSampler` with the dataset's node counts by
  type (the negatives' id space), yielding `HeteroBatch` es.

  Example::

      loader = LinkNeighborLoader(ds, [10, 10], (rows, cols),
                                  neg_sampling=NegativeSampling('binary'),
                                  batch_size=512, shuffle=True, seed=0)
      step = make_unsupervised_step(model, optimizer)
      for batch in loader:
        loss = step(batch)

  On a bipartite graph::

      loader = LinkNeighborLoader(ds, [8, 8], (('user', 'clicks', 'item'),
                                               (users, items)),
                                  neg_sampling='binary', batch_size=512)
      for batch in loader:        # HeteroBatch
        h = model(batch.x_dict, batch.edge_index_dict,
                  batch.edge_mask_dict)

  Args:
    num_neighbors: per-hop fanouts (heterogeneous: one list for every
      edge type, or ``{EdgeType: list}``).
    with_edge: emit the sampled edges' ids and their features.
    draws / neg_draws: the sampler's draws providers
      (`sampler.neighbor_sampler`, `sampler.hetero_neighbor_sampler`).
    device: where sampling runs (default ``'cuda'``): the dataset's
      device.
    The rest as `LinkLoader`.
  """

  def __init__(self, data, num_neighbors: Sequence[int], edge_label_index,
               edge_label=None, neg_sampling=None, batch_size: int = 1,
               shuffle: bool = False, drop_last: bool = False,
               with_edge: bool = False, seed: Optional[int] = None,
               draws: Optional[Callable] = None,
               neg_draws: Optional[Callable] = None, device='cuda',
               prefetch: int = 0):
    if data.is_hetero:
      sampler = HeteroNeighborSampler(
          data.get_graph(), num_neighbors, device=device,
          with_edge=with_edge, num_nodes=data.num_nodes_dict(),
          seed=seed or 0, draws=draws, neg_draws=neg_draws)
    else:
      sampler = NeighborSampler(data.get_graph(), num_neighbors,
                                device=device, with_edge=with_edge,
                                seed=seed or 0, draws=draws,
                                neg_draws=neg_draws)
    super().__init__(data, sampler, edge_label_index, edge_label,
                     neg_sampling, batch_size, shuffle, drop_last, seed,
                     prefetch)
