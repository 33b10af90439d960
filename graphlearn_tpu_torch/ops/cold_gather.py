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
from .launches import counted

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
    if t.ndim != 1 or t.dtype != torch.int32:
      raise ValueError(f'{name} must be [M] int32 (the JAX gather\'s id '
                       f'type), got {t.dtype} {tuple(t.shape)}')
  if pos.shape != rel.shape:
    raise ValueError(f'pos {tuple(pos.shape)} and rel {tuple(rel.shape)} '
                     'differ in length')


#: misses from which the wrapper serves a fill in block order (the plan
#: step, `cold_plan`); chip_smoke.py's K6 diagnosis times the kernel on
#: both orders and the plan alone at 584 to 455,371 rows (see PERF.md)
PLAN_MIN_ROWS = 1 << 16


def cold_plan(pos: torch.Tensor, rel: torch.Tensor):
  """The plan step: the ``(pos, rel)`` pairs in block order (``rel``
  ascending), by a library sort on the tensors' device.  The positions
  are distinct, so a fill in this order equals a fill in any other."""
  rel, order = torch.sort(rel)
  return pos[order], rel


def _check_card(out, cold, pos, rel) -> None:
  dev = out.device
  if dev.type != 'cuda':
    raise ValueError(f'the cold-gather kernel runs on cuda, not {dev}')
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


def _launch(out, cold, pos, rel) -> torch.Tensor:
  fn = _build.kernel('cold_gather', 'glt_cold_gather', _ARGTYPES)
  base = cold.untyped_storage().data_ptr()
  err = fn(base, cold.data_ptr() - base, cold.shape[0],
           cold.shape[1] * cold.element_size(), pos.data_ptr(),
           rel.data_ptr(), pos.numel(), out.data_ptr(), out.shape[0],
           torch.cuda.current_stream(out.device).cuda_stream)
  _build.check(err, 'cold_gather')
  cold_gather.launches += 1
  return out


def cold_gather(out: torch.Tensor, cold: torch.Tensor, pos: torch.Tensor,
                rel: torch.Tensor) -> torch.Tensor:
  """Fill ``out[pos[i]] = cold[rel[i]]`` (see the module docstring);
  returns ``out``.  The positions ``pos`` must be distinct.

  On CUDA: ``out`` contiguous on the card, ``cold`` a contiguous
  page-locked host tensor of ``out``'s dtype and width, ``pos`` and
  ``rel`` int32 on ``out``'s device.  From `PLAN_MIN_ROWS` misses the
  pairs are first put in block order (`cold_plan`, counted in
  ``cold_gather.plans``).  Launches on the current stream without
  synchronising; ``M = 0`` launches nothing.
  """
  _check(out, cold, pos, rel)
  if out.device.type == 'cpu':
    return cold_gather_plain(out, cold, pos, rel)
  _check_card(out, cold, pos, rel)
  if pos.numel() == 0:
    return out
  if pos.numel() >= PLAN_MIN_ROWS:
    pos, rel = cold_plan(pos, rel)
    cold_gather.plans += 1
  return _launch(out, cold, pos, rel)


#: kernel launches (counted where the kernel is launched, nowhere else)
counted(cold_gather)
#: plan steps (`cold_plan` on the card before a launch)
cold_gather.plans = 0


def cold_gather_kernel(out: torch.Tensor, cold: torch.Tensor,
                       pos: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
  """The kernel alone, in the pairs' own order (no plan step), on the
  card only: what K6's diagnosis times.  Its launches count in
  ``cold_gather.launches``."""
  _check(out, cold, pos, rel)
  _check_card(out, cold, pos, rel)
  if pos.numel() == 0:
    return out
  return _launch(out, cold, pos, rel)


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

