"""Hotness reordering for the tiered feature store (the JAX package's
`data/reorder.py`): order feature rows hottest-first, so that the
leading ``split_ratio`` of them — the rows `Feature` keeps on the card —
are the ones sampling touches most.  In-degree is the access proxy:
under uniform neighbor sampling a node is reached in proportion to the
edges that point at it.

Both functions return ``(reordered_feats, id2index)`` with
``reordered_feats[id2index[v]] == feature_array[v]``, byte-equal to the
JAX package's for the same input.  A numpy table comes back as numpy, a
CPU tensor as a CPU tensor.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _in_degree(csr_topo, n: int) -> np.ndarray:
  """Counts of each id among ``csr_topo.indices`` (``[n]`` int64): a
  host `np.bincount`, or a `torch.bincount` where the indices are a
  tensor (a graph built on the card: one ``[n]`` copy to the host)."""
  indices = csr_topo.indices
  if isinstance(indices, torch.Tensor):
    deg = torch.bincount(indices.long(), minlength=n).cpu().numpy()
  else:
    deg = np.bincount(np.asarray(indices), minlength=n)
  return deg[:n]


def sort_by_in_degree(feature_array, split_ratio: float,
                      csr_topo) -> Tuple[object, np.ndarray]:
  """Reorder rows hottest-first by in-degree.

  Args:
    feature_array: ``[N, D]`` host features (numpy or a CPU tensor)
      indexed by global id.
    split_ratio: the fraction destined for the card; unused, as in the
      JAX package (the whole permutation is applied, `Feature` applies
      the ratio).
    csr_topo: anything with the out-edge CSR's ``indices`` (a
      `CSRTopo`, or a `Graph` whose indices live on the card).
  """
  del split_ratio
  return sort_by_hotness(feature_array,
                         _in_degree(csr_topo, len(feature_array)))


def sort_by_hotness(feature_array, hotness) -> Tuple[object, np.ndarray]:
  """The same contract with any hotness score (descending, ties in id
  order)."""
  order = np.argsort(-np.asarray(hotness), kind='stable')
  n = len(order)
  id2index = np.empty(n, dtype=np.int64)
  id2index[order] = np.arange(n, dtype=np.int64)
  if isinstance(feature_array, torch.Tensor):
    feats = feature_array.index_select(0, torch.from_numpy(order))
  else:
    feats = np.asarray(feature_array)[order]
  return feats, id2index
