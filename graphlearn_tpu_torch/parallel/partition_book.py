"""Ownership arithmetic of the range partition book (identity book
only): the JAX package's `parallel/partition_book.py:316-400`.

Nodes are relabelled so partition ``p`` owns the contiguous id range
``[bounds[p], bounds[p+1])``; owner lookup is a `searchsorted`.
Edge-feature tables are mod-sharded instead: edge ``e`` lives in row
``e // P`` of partition ``e % P`` (`dist_data.build_dist_edge_feature`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def range_of(bounds: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
  """Device form: id -> range index (``searchsorted(side='right') -
  1``), int32; ``bounds`` an int64 tensor on the ids' device."""
  return (torch.searchsorted(bounds, ids.to(bounds.dtype), right=True)
          - 1).to(torch.int32)


def range_of_host(bounds, ids, num_parts: Optional[int] = None
                  ) -> np.ndarray:
  """Host form of `range_of`, clipped to valid ranges."""
  p = int(num_parts) if num_parts is not None else len(bounds) - 1
  return np.clip(np.searchsorted(bounds, np.asarray(ids), side='right') - 1,
                 0, p - 1).astype(np.int32)


def range_owner_fn(bounds: torch.Tensor):
  """The owner function of the hop and gather exchanges: owner ==
  range."""
  def owner_fn(v):
    return range_of(bounds, v)
  return owner_fn


def edge_owner_fn(num_parts: int):
  """The owner function of mod-sharded edge-feature tables: owner =
  ``eid % P``."""
  def owner_fn(v):
    return (v % num_parts).to(torch.int32)
  return owner_fn


def edge_local_rows(ids: torch.Tensor, num_parts: int) -> torch.Tensor:
  """The local row of mod-sharded tables: ``eid // P``."""
  return ids // num_parts


def hot_split_host(bounds, hot_counts, ids, valid=None):
  """The host-side hot/cold placement read: ``(rng, local, cold)`` —
  each id's range, its row within the range, and whether that row is
  past the range's hot count (served from the host tier)."""
  ids = np.asarray(ids)
  if valid is None:
    valid = ids >= 0
  hot_counts = np.asarray(hot_counts)
  rng = range_of_host(bounds, ids, num_parts=len(hot_counts))
  local = np.where(valid, ids - np.asarray(bounds)[rng], 0)
  cold = valid & (local >= hot_counts[rng])
  return rng, local, cold
