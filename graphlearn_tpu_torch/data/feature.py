"""Device-resident node feature table (the hot tier).

The JAX package's `Feature` splits rows between device memory (hot) and
host memory (cold).  This slice of the port carries the hot tier only:
``split_ratio == 1.0``, the whole ``[N, D]`` table on one device, read
through the fused remap + mask + row-gather kernel
(`ops.gather_rows`).  The tiered path is slice 6 of the ROADMAP.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.gather_rows import gather_rows
from ..utils import convert_to_array, resolve_device


def _device_gather(hot: torch.Tensor, ids: torch.Tensor,
                   id2index: Optional[torch.Tensor]) -> torch.Tensor:
  """``[B]`` global ids -> ``[B, D]`` rows: ``id2index`` remap, clamp,
  zero rows for invalid (``< 0``) or unmapped ids — the JAX
  `data/feature.py::_device_gather` contract, in one kernel launch."""
  return gather_rows(hot, ids, id2index)


def _as_tensor(data) -> torch.Tensor:
  if isinstance(data, torch.Tensor):
    return data
  return torch.from_numpy(np.ascontiguousarray(convert_to_array(data)))


class Feature:
  """Feature table addressed by global ids, fully resident on ``device``.

  Args:
    feature_array: ``[N, D]`` (or ``[N]``) numpy array or torch tensor.
    id2index: optional ``[max_id+1]`` map from global id to table row
      (``-1`` = unmapped); identity when ``None``.
    split_ratio: must be ``1.0`` in this slice.
    device: where the table lives (default ``'cuda'``).
    dtype: optional storage dtype (e.g. ``torch.bfloat16``).
  """

  def __init__(self, feature_array, id2index=None,
               split_ratio: float = 1.0, device='cuda',
               dtype: Optional[torch.dtype] = None):
    if float(split_ratio) != 1.0:
      raise NotImplementedError(
          'tiered features (split_ratio < 1) are not ported yet: they '
          'are slice 6 of the ROADMAP')
    dev = resolve_device(device)
    feats = _as_tensor(feature_array)
    if feats.ndim == 1:
      feats = feats[:, None]
    if dtype is not None:
      feats = feats.to(dtype)
    self.split_ratio = 1.0
    self._hot = feats.to(dev).contiguous()
    self._id2index = (None if id2index is None else
                      _as_tensor(id2index).to(dev, torch.int32).contiguous())
    self.hot_rows = int(self._hot.shape[0])

  @property
  def shape(self):
    return tuple(self._hot.shape)

  @property
  def dtype(self) -> torch.dtype:
    return self._hot.dtype

  @property
  def device(self) -> torch.device:
    return self._hot.device

  @property
  def feature_dim(self) -> int:
    return int(self._hot.shape[1])

  def size(self, dim: int = 0) -> int:
    return int(self._hot.shape[dim])

  @property
  def hot_tier(self) -> torch.Tensor:
    """The device table, ``[N, D]``."""
    return self._hot

  @property
  def id2index(self) -> Optional[torch.Tensor]:
    """The device id->row map (int32), or None."""
    return self._id2index

  def get(self, ids) -> torch.Tensor:
    """Rows by global id, on the table's device; invalid ids (``< 0``)
    and unmapped ids give zero rows."""
    ids = _as_tensor(ids).to(self.device)
    return _device_gather(self._hot, ids, self._id2index)

  __getitem__ = get

  def __repr__(self):
    return (f'Feature(shape={self.shape}, dtype={self.dtype}, '
            f'device={str(self.device)!r})')
