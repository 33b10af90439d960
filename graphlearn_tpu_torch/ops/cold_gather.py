"""The tiered store's cold-row fill: the kernel (`csrc/cold_gather.cu`,
K6, the Hopper port of the JAX package's `PinnedColdBuffer.gather`,
`data/cold_cache.py:507`, with the mixed path's miss mask and
compact-rank expand fused in) and its plain PyTorch version.

Both fill, in place on ``out [B, D]``, the batch's miss rows from the
cold block ``cold [Nc, D]``::

  out[pos[i]] = cold[rel[i]]      for i < M

``pos`` are positions in ``out``, ``rel`` rows of the block (the global
row less the hot count).  Other rows of ``out`` are left as they are.

`cold_gather` runs the plain version for an ``out`` on the CPU.  For an
``out`` on the card it launches the kernel, which reads the block in
page-locked host memory through its device address, or raises: a block
that is not pinned is a `ValueError`, never a copy.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARGTYPES = (_P, _LL, _LL, _LL, _P, _P, _LL, _P, _LL, _P)


def cold_gather_plain(out: torch.Tensor, cold: torch.Tensor,
                      pos: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
  """The plain version, the JAX package's compact host path: a host
  `index_select` of the miss rows, one copy to ``out``'s device, an
  `index_copy_` into ``out``.  Returns ``out``."""
  cold_gather_plain.calls += 1
  if pos.numel() == 0:
    return out
  rows = torch.index_select(cold, 0, rel.cpu().long()).to(out.device)
  out.index_copy_(0, pos.to(out.device).long(), rows)
  return out


#: calls of the plain version (a run on the card expects 0)
cold_gather_plain.calls = 0


def _check(out, cold, pos, rel) -> None:
  if out.ndim != 2 or cold.ndim != 2 or cold.shape[0] < 1:
    raise ValueError(f'out must be [B, D] and cold [Nc >= 1, D]; got '
                     f'{tuple(out.shape)} and {tuple(cold.shape)}')
  if out.shape[1] != cold.shape[1]:
    raise ValueError(f'row width mismatch: out has {out.shape[1]} '
                     f'columns, the cold block {cold.shape[1]}')
  if out.dtype != cold.dtype:
    raise ValueError(f'dtype mismatch: out is {out.dtype}, the cold block '
                     f'{cold.dtype} (the cast happens once, at build)')
  for name, t in (('pos', pos), ('rel', rel)):
    if t.ndim != 1 or t.dtype != torch.int64:
      raise ValueError(f'{name} must be [M] int64, got {t.dtype} '
                       f'{tuple(t.shape)}')
  if pos.shape != rel.shape:
    raise ValueError(f'pos {tuple(pos.shape)} and rel {tuple(rel.shape)} '
                     'differ in length')


def cold_gather(out: torch.Tensor, cold: torch.Tensor, pos: torch.Tensor,
                rel: torch.Tensor) -> torch.Tensor:
  """Fill ``out[pos[i]] = cold[rel[i]]`` (see the module docstring);
  returns ``out``.

  On CUDA: ``out`` contiguous on the card, ``cold`` a contiguous
  page-locked host tensor of ``out``'s dtype and width, ``pos`` and
  ``rel`` int64 on ``out``'s device.  Launches on the current stream
  without synchronising; ``M = 0`` launches nothing.
  """
  _check(out, cold, pos, rel)
  dev = out.device
  if dev.type == 'cpu':
    return cold_gather_plain(out, cold, pos, rel)
  if dev.type != 'cuda':
    raise ValueError(f'cold_gather runs on cpu or cuda, not {dev}')
  if cold.device.type != 'cpu' or not cold.is_pinned():
    raise ValueError('the cold block must be a page-locked host tensor '
                     '(pinned or registered); got one on '
                     f'{cold.device}, pinned={cold.is_pinned()}')
  if not cold.is_contiguous() or not out.is_contiguous():
    raise ValueError('out and the cold block must be contiguous')
  for name, t in (('pos', pos), ('rel', rel)):
    if t.device != dev or not t.is_contiguous():
      raise ValueError(f'{name} must be contiguous on {dev}; got '
                       f'{t.device}')
  m = pos.numel()
  if m == 0:
    return out
  fn = _build.kernel('cold_gather', 'glt_cold_gather', _ARGTYPES)
  base = cold.untyped_storage().data_ptr()
  err = fn(base, cold.data_ptr() - base, cold.shape[0],
           cold.shape[1] * cold.element_size(), pos.data_ptr(),
           rel.data_ptr(), m, out.data_ptr(), out.shape[0],
           torch.cuda.current_stream(dev).cuda_stream)
  _build.check(err, 'cold_gather')
  cold_gather.launches += 1
  return out


#: kernel launches (counted where the kernel is launched, nowhere else)
cold_gather.launches = 0


def host_register(t: torch.Tensor) -> None:
  """Page-lock a contiguous CPU tensor's bytes in place and map them for
  the card (`cudaHostRegister`): exactly its size, where `pin_memory`
  would copy into a power-of-two block.  Undo with `host_unregister`
  before the tensor is freed."""
  if t.device.type != 'cpu' or not t.is_contiguous():
    raise ValueError('host_register takes a contiguous CPU tensor')
  fn = _build.kernel('cold_gather', 'glt_host_register', (_P, _LL))
  _build.check(fn(t.data_ptr(), t.numel() * t.element_size()),
               'cudaHostRegister')


def host_unregister(t: torch.Tensor) -> None:
  fn = _build.kernel('cold_gather', 'glt_host_unregister', (_P,))
  _build.check(fn(t.data_ptr()), 'cudaHostUnregister')
