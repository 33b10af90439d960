"""CSR neighbor-window gather: the kernel (`csrc/csr_window_gather.cu`,
Hopper port of the JAX package's Pallas `ops/pallas_window.py::
csr_window_gather`) and the plain versions of both JAX functions.

The two JAX functions differ where a start is out of range:

* `csr_window_gather` (the Pallas path) clamps the STARTS to
  ``[0, max(E-1, 0)]`` and reads ``indices[E-1]`` at every position
  past the array (its repacked table's pad fill); an empty ``indices``
  gives zeros.  Start -5 reads ``indices[0..w)``.
* `window_gather_plain` (the twin of `xla_window_gather`) clamps each
  POSITION ``start + j`` to ``[0, max(E-1, 0)]``.  Start -5 reads
  ``indices[0]`` six times first.

`csr_window_gather` runs `csr_window_gather_plain` for tensors on the
CPU; for CUDA tensors it launches the kernel or raises — there is no
fallback.  Unlike the TPU kernel, any window width ``w >= 1`` is taken
(the TPU's 128-lane cap does not exist here) and there is no one-time
repack of ``indices``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .launches import counted

_P = ctypes.c_void_p
_ARGTYPES = (_P, ctypes.c_longlong, _P, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int, _P, _P)


def _check(indices: torch.Tensor, starts: torch.Tensor, w: int) -> None:
  if w < 1:
    raise ValueError(f'window width must be >= 1, got {w}')
  if indices.ndim != 1 or indices.dtype != torch.int32:
    raise ValueError(f'indices must be [E] int32, got {indices.dtype} '
                     f'{tuple(indices.shape)}')
  if starts.ndim != 1 or starts.dtype not in (torch.int32, torch.int64):
    raise ValueError(f'starts must be [B] int32/int64, got {starts.dtype} '
                     f'{tuple(starts.shape)}')


def csr_window_gather_plain(indices: torch.Tensor, starts: torch.Tensor,
                            w: int) -> torch.Tensor:
  """The plain PyTorch version of `csr_window_gather` (any device)."""
  csr_window_gather_plain.calls += 1
  _check(indices, starts, w)
  e = indices.numel()
  if e == 0:
    return torch.zeros((starts.numel(), w), dtype=indices.dtype,
                       device=starts.device)
  s = starts.long().clamp(0, e - 1)
  lane = torch.arange(w, dtype=torch.int64, device=starts.device)
  return indices[(s[:, None] + lane[None, :]).clamp(max=e - 1)]


#: calls of the plain version (a run on the card expects 0)
csr_window_gather_plain.calls = 0


def window_gather_plain(indices: torch.Tensor, starts: torch.Tensor,
                        w: int) -> torch.Tensor:
  """The twin of the JAX package's `xla_window_gather`: ``out[i, j] =
  indices[clamp(starts[i] + j, 0, max(E-1, 0))]`` (zeros for an empty
  ``indices``)."""
  _check(indices, starts, w)
  e = indices.numel()
  if e == 0:
    return torch.zeros((starts.numel(), w), dtype=indices.dtype,
                       device=starts.device)
  lane = torch.arange(w, dtype=torch.int64, device=starts.device)
  return indices[(starts.long()[:, None] + lane[None, :]).clamp(0, e - 1)]


def csr_window_gather(indices: torch.Tensor, starts: torch.Tensor,
                      w: int) -> torch.Tensor:
  """``[B]`` starts -> ``[B, w]`` int32 windows of ``indices`` (see the
  module docstring for the clamps).

  On CUDA: ``indices`` contiguous ``[E]`` int32, ``starts`` contiguous
  ``[B]`` int32 or int64, on one device.  Launches on the current
  stream without synchronising.
  """
  w = int(w)
  _check(indices, starts, w)
  dev = starts.device
  if dev.type == 'cpu':
    return csr_window_gather_plain(indices, starts, w)
  if dev.type != 'cuda':
    raise ValueError(f'csr_window_gather runs on cpu or cuda, not {dev}')
  for name, t in (('indices', indices), ('starts', starts)):
    if t.device != dev or not t.is_contiguous():
      raise ValueError(f'{name} must be contiguous on {dev}; got '
                       f'{t.device}')
  b = starts.numel()
  out = torch.empty((b, w), dtype=torch.int32, device=dev)
  if b == 0:
    return out
  fn = _build.kernel('csr_window_gather', 'glt_csr_window_gather',
                     _ARGTYPES)
  err = fn(indices.data_ptr(), indices.numel(), starts.data_ptr(),
           int(starts.dtype == torch.int64), b, w, out.data_ptr(),
           torch.cuda.current_stream(dev).cuda_stream)
  _build.check(err, 'csr_window_gather')
  csr_window_gather.launches += 1
  return out


#: kernel launches (counted where the kernel is launched, nowhere else)
counted(csr_window_gather)
