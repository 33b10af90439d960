"""Feature row gather fused with the id remap and mask: the kernel
(`csrc/gather_rows.cu`, Hopper port of the JAX package's Pallas
`ops/pallas_gather.py::gather_rows`) and its plain PyTorch version.

Both compute the JAX `data/feature.py::_device_gather` contract::

  valid = ids >= 0;  idx = where(valid, ids, 0)
  if id2index is not None:
    idx = id2index[min(idx, M-1)];  valid &= idx >= 0
  out = where(valid, table[clamp(idx, 0, N-1)], 0)

`gather_rows` runs the plain version for a table on the CPU; for a CUDA
table it launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

_P = ctypes.c_void_p
_ARGTYPES = (_P, ctypes.c_longlong, ctypes.c_longlong, _P, ctypes.c_int,
             ctypes.c_longlong, _P, ctypes.c_longlong, _P, _P)


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor,
                      id2index: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
  """The plain PyTorch version (any device)."""
  gather_rows_plain.calls += 1
  ids = ids.long()
  valid = ids >= 0
  idx = torch.where(valid, ids, 0)
  if id2index is not None:
    idx = id2index[idx.clamp(max=id2index.numel() - 1)].long()
    valid = valid & (idx >= 0)
    idx = torch.where(valid, idx, 0)
  out = table[idx.clamp(0, table.shape[0] - 1)]
  return out.masked_fill(~valid[:, None], 0)


#: calls of the plain version (a serving run on the card expects 0)
gather_rows_plain.calls = 0


def _check(table, ids, id2index) -> None:
  if table.ndim != 2 or table.shape[0] < 1:
    raise ValueError(f'table must be [N >= 1, D], got {tuple(table.shape)}')
  if table.element_size() < 2:
    raise ValueError(f'table dtype {table.dtype}: rows of 2-, 4- or 8-byte '
                     'elements only')
  if ids.ndim != 1 or ids.dtype not in (torch.int32, torch.int64):
    raise ValueError(f'ids must be [B] int32/int64, got {ids.dtype} '
                     f'{tuple(ids.shape)}')
  if id2index is not None and (id2index.ndim != 1 or id2index.numel() < 1
                               or id2index.dtype != torch.int32):
    raise ValueError('id2index must be a non-empty [M] int32 tensor')


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                id2index: Optional[torch.Tensor] = None) -> torch.Tensor:
  """``[B]`` ids -> ``[B, D]`` rows of ``table`` (see module docstring).

  On CUDA: ``table`` contiguous ``[N, D]`` (f32, bf16 or any 2/4/8-byte
  type), ``ids`` int32/int64, ``id2index`` int32, all on one device.
  Launches on the current stream without synchronising.
  """
  _check(table, ids, id2index)
  dev = table.device
  if dev.type == 'cpu':
    return gather_rows_plain(table, ids, id2index)
  if dev.type != 'cuda':
    raise ValueError(f'gather_rows runs on cpu or cuda, not {dev}')
  for name, t in (('table', table), ('ids', ids), ('id2index', id2index)):
    if t is not None and (t.device != dev or not t.is_contiguous()):
      raise ValueError(f'{name} must be contiguous on {dev}; got '
                       f'{t.device}')
  b, d = ids.shape[0], table.shape[1]
  out = torch.empty((b, d), dtype=table.dtype, device=dev)
  if b == 0:
    return out
  fn = _build.kernel('gather_rows', 'glt_gather_rows', _ARGTYPES)
  err = fn(table.data_ptr(), table.shape[0], d * table.element_size(),
           ids.data_ptr(), int(ids.dtype == torch.int64), b,
           None if id2index is None else id2index.data_ptr(),
           0 if id2index is None else id2index.numel(), out.data_ptr(),
           torch.cuda.current_stream(dev).cuda_stream)
  _build.check(err, 'gather_rows')
  gather_rows.launches += 1
  return out


#: kernel launches (counted where the kernel is launched, nowhere else)
gather_rows.launches = 0
