"""Host tensor helpers (numpy and torch only)."""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def convert_to_array(data: Any, dtype: Optional[np.dtype] = None):
  """Convert input (nested dicts / lists / tuples / arrays / torch
  tensors) into host numpy arrays."""
  if data is None:
    return None
  if isinstance(data, dict):
    return {k: convert_to_array(v, dtype) for k, v in data.items()}
  if isinstance(data, (list, tuple)) and len(data) > 0 and (
      hasattr(data[0], '__array__') or isinstance(data[0], (list, tuple))):
    return type(data)(convert_to_array(v, dtype) for v in data)
  if isinstance(data, torch.Tensor):
    data = data.detach().cpu().numpy()
  arr = np.asarray(data)
  if dtype is not None:
    arr = arr.astype(dtype, copy=False)
  return arr


def id2idx(ids, max_id: Optional[int] = None) -> np.ndarray:
  """Build a dense id->index map: ``out[ids[i]] = i``, -1 elsewhere."""
  ids = convert_to_array(ids)
  n = int(max_id) + 1 if max_id is not None else (int(ids.max()) + 1
                                                  if ids.size else 0)
  out = np.full((n,), -1, dtype=np.int64)
  out[ids] = np.arange(len(ids), dtype=np.int64)
  return out


class PinnedStaging:
  """A reusable host buffer for one batch's upload, page-locked when
  ``pin`` (a card's batches; a CPU store stages in plain memory), grown
  by powers of two; a reuse waits for the previous copy out of it."""

  def __init__(self, pin: bool = True):
    self.pin = pin
    self._buf = None
    self._event = None

  def take(self, n: int, dim: int, dtype) -> torch.Tensor:
    if self._event is not None:
      self._event.synchronize()
    rows = 1 << max(int(n) - 1, 0).bit_length()
    if (self._buf is None or self._buf.shape[0] < rows
        or self._buf.shape[1] != dim or self._buf.dtype != dtype):
      self._buf = torch.empty((rows, dim), dtype=dtype, pin_memory=self.pin)
    return self._buf[:n]

  def record(self) -> None:
    """Mark the copy out of the buffer, on the current stream (a
    prefetch worker's own stream inside the worker)."""
    if self.pin:
      self._event = torch.cuda.Event()
      self._event.record(torch.cuda.current_stream())
