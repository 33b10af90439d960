"""The one-hop sampler kernels: Hopper ports of both arms of the JAX
package's Pallas fused sample+compact (`ops/pallas_sample.py`).

* `sample_one_hop_fused` (`csrc/sample_one_hop.cu`, the uniform arm)
  takes the arguments of the plain `ops.neighbor.sample_one_hop`;
* `sample_one_hop_gns_fused` (`csrc/sample_one_hop_gns.cu`, the GNS
  arm) takes those of the plain `ops.gns.sample_one_hop_gns`.

Each returns the same bytes as its plain version.  For tensors on the
CPU it runs that plain version; for CUDA tensors it launches the kernel
or raises — there is no fallback.

``sort_locality=True`` is the JAX samplers' default order: the rows are
sampled in ascending seed order (invalid seeds last, by a stable
argsort) and the results put back in input order.  The draws belong to
the SORTED rows: draw row ``j`` is used by the ``j``-th sorted seed, as
in JAX, where the key is consumed after the sort.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from .. import _build
from .gns import bits_rows, bits_table, sample_one_hop_gns
from .launches import counted
from .neighbor import (OneHopResult, check_edge_ids, default_window,
                       sample_one_hop)

#: the kernels keep a row's window in shared memory
MAX_WINDOW = 256

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARGTYPES = (_P, _LL, _P, _LL, _P, _LL, _P, _P, ctypes.c_int, ctypes.c_int,
             _P, _P, _P, _P, _P)
_GNS_ARGTYPES = (_P, _LL, _P, _LL, _P, _LL, _P, _P, _P, _LL, _LL, _P,
                 ctypes.c_int, ctypes.c_int, ctypes.c_float, _P, _P, _P, _P,
                 _P, _P)


def _check_k(k: int, w: int) -> None:
  if k < 1:
    raise ValueError(f'fanout k must be >= 1, got {k}')
  if not k <= w <= MAX_WINDOW:
    raise ValueError(f'window {w} must lie in [k={k}, {MAX_WINDOW}]')


def _check_cuda(dev, tensors) -> None:
  for name, t, dtype in tensors:
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
      raise ValueError(f'{name} must be a contiguous {dtype} tensor on '
                       f'{dev}; got {t.dtype} on {t.device}')


def _sorted(seeds: torch.Tensor, run: Callable, per_row) -> OneHopResult:
  """Sample the rows in ascending seed order (invalid seeds last) and
  restore input order; ``per_row`` are the per-row inputs that follow
  the seeds (the draws do not: they belong to the sorted rows)."""
  big = torch.iinfo(seeds.dtype).max
  order = torch.argsort(torch.where(seeds >= 0, seeds, big), stable=True)
  res = run(seeds[order], *(None if t is None else t[order]
                            for t in per_row))

  def back(t):
    return None if t is None else torch.empty_like(t).index_copy_(0, order,
                                                                   t)
  return OneHopResult(nbrs=back(res.nbrs), mask=back(res.mask),
                      eids=back(res.eids), weights=back(res.weights))


def sample_one_hop_fused(indptr: torch.Tensor, indices: torch.Tensor,
                         seeds: torch.Tensor, k: int, u: torch.Tensor,
                         gumbel: torch.Tensor,
                         sort_locality: bool = False,
                         edge_ids: Optional[torch.Tensor] = None,
                         with_edge_ids: bool = False) -> OneHopResult:
  """`ops.neighbor.sample_one_hop` through the CUDA kernel.

  On CUDA: ``indptr`` int64, ``indices`` int32, ``seeds`` int32,
  ``u``/``gumbel`` f32, ``edge_ids`` (optional) int32, all contiguous on
  one device; ``k <= w <= 256``.  With ``with_edge_ids`` the kernel
  also writes ``eids`` (``edge_ids`` at each slot's position, or the
  position).  Launches on the current stream without synchronising.
  """
  if gumbel.ndim != 2 or u.ndim != 2:
    raise ValueError('u must be [B, k] and gumbel [B, w]')
  b, w = seeds.shape[0], gumbel.shape[1]
  if tuple(u.shape) != (b, k) or gumbel.shape[0] != b:
    raise ValueError(f'draws must be u [{b}, {k}] and gumbel [{b}, w]; '
                     f'got {tuple(u.shape)} and {tuple(gumbel.shape)}')
  _check_k(k, w)
  dev = seeds.device
  if dev.type not in ('cpu', 'cuda'):
    raise ValueError(f'sample_one_hop_fused runs on cpu or cuda, not {dev}')

  check_edge_ids(indices.numel(), edge_ids, with_edge_ids)
  if not with_edge_ids:
    edge_ids = None

  def run(s):
    if dev.type == 'cpu':
      return sample_one_hop(indptr, indices, s, k, u, gumbel, edge_ids,
                            with_edge_ids)
    return _launch_uniform(indptr, indices, s, k, u, gumbel, w, edge_ids,
                           with_edge_ids)

  if sort_locality and b > 1:
    return _sorted(seeds, run, ())
  return run(seeds)


def _launch_uniform(indptr, indices, seeds, k, u, gumbel, w, edge_ids=None,
                    with_edge_ids=False):
  dev = seeds.device
  _check_cuda(dev, (('indptr', indptr, torch.int64),
                    ('indices', indices, torch.int32),
                    ('seeds', seeds, torch.int32),
                    ('u', u, torch.float32),
                    ('gumbel', gumbel, torch.float32))
              + ((('edge_ids', edge_ids, torch.int32),)
                 if edge_ids is not None else ()))
  b = seeds.shape[0]
  nbrs = torch.empty((b, k), dtype=torch.int32, device=dev)
  mask = torch.empty((b, k), dtype=torch.bool, device=dev)
  eids = (torch.empty((b, k), dtype=torch.int32, device=dev)
          if with_edge_ids else None)
  if b == 0:
    return OneHopResult(nbrs=nbrs, mask=mask, eids=eids)
  fn = _build.kernel('sample_one_hop', 'glt_sample_one_hop', _ARGTYPES)
  err = fn(indptr.data_ptr(), indptr.numel() - 1, indices.data_ptr(),
           indices.numel(), seeds.data_ptr(), b, u.data_ptr(),
           gumbel.data_ptr(), k, w, nbrs.data_ptr(), mask.data_ptr(),
           None if edge_ids is None else edge_ids.data_ptr(),
           None if eids is None else eids.data_ptr(),
           torch.cuda.current_stream(dev).cuda_stream)
  _build.check(err, 'sample_one_hop')
  sample_one_hop_fused.launches += 1
  return OneHopResult(nbrs=nbrs, mask=mask, eids=eids)


#: kernel launches (counted where the kernel is launched, nowhere else)
counted(sample_one_hop_fused)


def sample_one_hop_gns_fused(indptr: torch.Tensor, indices: torch.Tensor,
                             seeds: torch.Tensor, k: int, u: torch.Tensor,
                             v: torch.Tensor, bits, boost: float,
                             req: Optional[torch.Tensor] = None,
                             window: Optional[int] = None,
                             sort_locality: bool = False,
                             edge_ids: Optional[torch.Tensor] = None,
                             with_edge_ids: bool = False) -> OneHopResult:
  """`ops.gns.sample_one_hop_gns` through the CUDA kernel.

  On CUDA: ``indptr`` int64, ``indices`` int32, ``seeds`` int32, ``u``
  and ``v`` ``[B, k]`` f32, the bitmask's table uint8 (any of the three
  forms, on the same device), ``edge_ids`` (optional) int32, all
  contiguous; ``k <= w <= 256``.  With ``with_edge_ids`` the kernel also
  writes ``eids`` (``edge_ids`` at each slot's position, or the
  position).  Launches on the current stream without synchronising.
  """
  b = seeds.shape[0]
  w = int(window) if window is not None else default_window(k)
  if tuple(u.shape) != (b, k) or tuple(v.shape) != (b, k):
    raise ValueError(f'draws must be u and v [{b}, {k}]; got '
                     f'{tuple(u.shape)} and {tuple(v.shape)}')
  _check_k(k, w)
  if req is not None and req.shape != seeds.shape:
    raise ValueError(f'req must be [{b}], got {tuple(req.shape)}')
  dev = seeds.device
  if dev.type not in ('cpu', 'cuda'):
    raise ValueError(f'sample_one_hop_gns_fused runs on cpu or cuda, not '
                     f'{dev}')
  check_edge_ids(indices.numel(), edge_ids, with_edge_ids)
  if not with_edge_ids:
    edge_ids = None

  def run(s, r):
    if dev.type == 'cpu':
      return sample_one_hop_gns(indptr, indices, s, k, u, v, bits, boost,
                                req=r, window=w, edge_ids=edge_ids,
                                with_edge_ids=with_edge_ids)
    return _launch_gns(indptr, indices, s, k, u, v, bits, boost, r, w,
                       edge_ids, with_edge_ids)

  if sort_locality and b > 1:
    return _sorted(seeds, run, (req,))
  return run(seeds, req)


def _launch_gns(indptr, indices, seeds, k, u, v, bits, boost, req, w,
                edge_ids=None, with_edge_ids=False):
  dev = seeds.device
  table = bits_table(bits)
  _check_cuda(dev, (('indptr', indptr, torch.int64),
                    ('indices', indices, torch.int32),
                    ('seeds', seeds, torch.int32),
                    ('u', u, torch.float32), ('v', v, torch.float32),
                    ('bits table', table, torch.uint8))
              + ((('edge_ids', edge_ids, torch.int32),)
                 if edge_ids is not None else ()))
  if table.ndim != 2 or table.numel() == 0:
    raise ValueError('the bits table must be a non-empty [T, nbytes]')
  rows = bits_rows(bits, req, seeds.shape[0], dev).contiguous()
  return gns_kernel(indptr, indices, seeds, k, u, v, table, rows, boost, w,
                    edge_ids, with_edge_ids)


def gns_kernel(indptr, indices, seeds, k, u, v, table, rows, boost, w,
               edge_ids=None, with_edge_ids=False) -> OneHopResult:
  """The GNS kernel's launch alone, on inputs `_launch_gns` has checked
  (``table`` the ``[T, nbytes]`` byte table, ``rows`` the ``[B]`` int32
  table row of each seed): the outputs' allocation and one launch."""
  dev = seeds.device
  b = seeds.shape[0]
  nbrs = torch.empty((b, k), dtype=torch.int32, device=dev)
  mask = torch.empty((b, k), dtype=torch.bool, device=dev)
  weights = torch.empty((b, k), dtype=torch.float32, device=dev)
  eids = (torch.empty((b, k), dtype=torch.int32, device=dev)
          if with_edge_ids else None)
  if b == 0:
    return OneHopResult(nbrs=nbrs, mask=mask, eids=eids, weights=weights)
  fn = _build.kernel('sample_one_hop_gns', 'glt_sample_one_hop_gns',
                     _GNS_ARGTYPES)
  err = fn(indptr.data_ptr(), indptr.numel() - 1, indices.data_ptr(),
           indices.numel(), seeds.data_ptr(), b, u.data_ptr(), v.data_ptr(),
           table.data_ptr(), table.shape[0], table.shape[1], rows.data_ptr(),
           k, w, float(boost), nbrs.data_ptr(), mask.data_ptr(),
           weights.data_ptr(),
           None if edge_ids is None else edge_ids.data_ptr(),
           None if eids is None else eids.data_ptr(),
           torch.cuda.current_stream(dev).cuda_stream)
  _build.check(err, 'sample_one_hop_gns')
  sample_one_hop_gns_fused.launches += 1
  return OneHopResult(nbrs=nbrs, mask=mask, eids=eids, weights=weights)


#: kernel launches (counted where the kernel is launched, nowhere else)
counted(sample_one_hop_gns_fused)
