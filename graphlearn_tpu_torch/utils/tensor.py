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
