"""The one-hop sampler kernel (`csrc/sample_one_hop.cu`): Hopper port of
the uniform arm of the JAX package's Pallas fused sample+compact
(`ops/pallas_sample.py`).

`sample_one_hop_fused` takes the same arguments as the plain version,
`ops.neighbor.sample_one_hop`, and returns the same bytes.  For tensors
on the CPU it runs that plain version; for CUDA tensors it launches the
kernel or raises — there is no fallback.  The GNS-biased arm is not
ported yet (ROADMAP, slice 6).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .neighbor import OneHopResult, sample_one_hop

#: the kernel keeps a row's window in shared memory
MAX_WINDOW = 256

_P = ctypes.c_void_p
_ARGTYPES = (_P, ctypes.c_longlong, _P, ctypes.c_longlong, _P,
             ctypes.c_longlong, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P,
             _P)


def _check(indptr, indices, seeds, k, u, gumbel) -> int:
  if k < 1:
    raise ValueError(f'fanout k must be >= 1, got {k}')
  if gumbel.ndim != 2 or u.ndim != 2:
    raise ValueError('u must be [B, k] and gumbel [B, w]')
  b, w = seeds.shape[0], gumbel.shape[1]
  if tuple(u.shape) != (b, k) or gumbel.shape[0] != b:
    raise ValueError(f'draws must be u [{b}, {k}] and gumbel [{b}, w]; '
                     f'got {tuple(u.shape)} and {tuple(gumbel.shape)}')
  if not k <= w <= MAX_WINDOW:
    raise ValueError(f'window {w} must lie in [k={k}, {MAX_WINDOW}]')
  return w


def sample_one_hop_fused(indptr: torch.Tensor, indices: torch.Tensor,
                         seeds: torch.Tensor, k: int, u: torch.Tensor,
                         gumbel: torch.Tensor) -> OneHopResult:
  """`ops.neighbor.sample_one_hop` through the CUDA kernel.

  On CUDA: ``indptr`` int64, ``indices`` int32, ``seeds`` int32,
  ``u``/``gumbel`` f32, all contiguous on one device; ``k <= w <= 256``.
  Launches on the current stream without synchronising.
  """
  w = _check(indptr, indices, seeds, k, u, gumbel)
  dev = seeds.device
  if dev.type == 'cpu':
    return sample_one_hop(indptr, indices, seeds, k, u, gumbel)
  if dev.type != 'cuda':
    raise ValueError(f'sample_one_hop_fused runs on cpu or cuda, not {dev}')
  for name, t, dtype in (('indptr', indptr, torch.int64),
                         ('indices', indices, torch.int32),
                         ('seeds', seeds, torch.int32),
                         ('u', u, torch.float32),
                         ('gumbel', gumbel, torch.float32)):
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
      raise ValueError(f'{name} must be a contiguous {dtype} tensor on '
                       f'{dev}; got {t.dtype} on {t.device}')
  b = seeds.shape[0]
  nbrs = torch.empty((b, k), dtype=torch.int32, device=dev)
  mask = torch.empty((b, k), dtype=torch.bool, device=dev)
  if b == 0:
    return OneHopResult(nbrs=nbrs, mask=mask)
  fn = _build.kernel('sample_one_hop', 'glt_sample_one_hop', _ARGTYPES)
  err = fn(indptr.data_ptr(), indptr.numel() - 1, indices.data_ptr(),
           indices.numel(), seeds.data_ptr(), b, u.data_ptr(),
           gumbel.data_ptr(), k, w, nbrs.data_ptr(), mask.data_ptr(),
           torch.cuda.current_stream(dev).cuda_stream)
  _build.check(err, 'sample_one_hop')
  sample_one_hop_fused.launches += 1
  return OneHopResult(nbrs=nbrs, mask=mask)


#: kernel launches (counted where the kernel is launched, nowhere else)
sample_one_hop_fused.launches = 0
