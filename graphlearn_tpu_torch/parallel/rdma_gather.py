"""The remote-push feature exchange (the JAX package's
`parallel/rdma_gather.py:102-151`): a row gather over the range-sharded
tables of the mesh whose reply path is a push by the owners.

`dist_sampler.dist_gather_multi` answers row requests with a reply
all-to-all: every owner first gathers its reply rows into a ``[P * C,
D]`` buffer, which then crosses the mesh.  Here the request ids still
cross by the all-to-all, and then each owner pushes each requested row
straight from its shard into the requester's receive buffer ``[P_o, C,
D]`` at ``[owner, slot]`` — the layout the stitch reads — with no
owner-side reply buffer.  On one card (the mesh's partitions share it)
the push is the kernel `push_rows` (`csrc/push_rows.cu`, the Hopper port
of the Pallas ``_push_rows_kernel``), writing into one ``[P_r, P_o, C,
D]`` tensor.

Bucketing, capacity and masking are those of `dist_gather_multi`, so the
two return the same bytes for the same ids and capacity.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from ..ops.launches import counted
from .dist_sampler import int64_on
from .dp import Mesh
from .exchange import plan_exchange
from .partition_book import range_owner_fn

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARGTYPES = (_P, _P, _P, _LL, _LL, _LL, _LL, _P, _LL, _P)


def push_rows_plain(recv_ids: torch.Tensor, starts: torch.Tensor,
                    shards: torch.Tensor) -> torch.Tensor:
  """The plain PyTorch version (any device): ``recv_ids [P_o, P_r, C]``
  (the ids each requester asked of each owner, -1 padded), ``starts
  [P]`` (each owner's first global id), ``shards [P, R, D]`` -> ``[P_r,
  P_o, C, D]``, slot ``(r, o, j)`` holding ``shards[o, clamp(recv_ids[o,
  r, j] - starts[o], 0, R - 1)]``."""
  push_rows_plain.calls += 1
  p = shards.shape[0]
  local = (recv_ids.long() - starts.long()[:, None, None]).clamp(
      0, shards.shape[1] - 1)
  owner = torch.arange(p, device=shards.device)[:, None, None]
  return shards[owner, local].transpose(0, 1).contiguous()


#: calls of the plain version (a run on the card expects 0)
push_rows_plain.calls = 0


def _check(recv_ids, starts, shards) -> None:
  if shards.ndim != 3 or shards.shape[1] < 1:
    raise ValueError(f'shards must be [P, R >= 1, D], got '
                     f'{tuple(shards.shape)}')
  p = shards.shape[0]
  if (recv_ids.ndim != 3 or recv_ids.shape[:2] != (p, p)
      or recv_ids.dtype != torch.int32):
    raise ValueError(f'recv_ids must be [{p}, {p}, C] int32, got '
                     f'{recv_ids.dtype} {tuple(recv_ids.shape)}')
  if tuple(starts.shape) != (p,) or starts.dtype != torch.int64:
    raise ValueError(f'starts must be [{p}] int64, got {starts.dtype} '
                     f'{tuple(starts.shape)}')


def push_rows(recv_ids: torch.Tensor, starts: torch.Tensor,
              shards: torch.Tensor) -> torch.Tensor:
  """`push_rows_plain` through the kernel for CUDA tensors (contiguous,
  on one device; rows of any width and element size); the plain version
  for CPU tensors.  Launches on the current stream without
  synchronising."""
  _check(recv_ids, starts, shards)
  dev = shards.device
  if dev.type == 'cpu':
    return push_rows_plain(recv_ids, starts, shards)
  if dev.type != 'cuda':
    raise ValueError(f'push_rows runs on cpu or cuda, not {dev}')
  for name, t in (('recv_ids', recv_ids), ('starts', starts),
                  ('shards', shards)):
    if t.device != dev or not t.is_contiguous():
      raise ValueError(f'{name} must be contiguous on {dev}; got '
                       f'{t.device}')
  p, _, cap = recv_ids.shape
  r, d = shards.shape[1], shards.shape[2]
  out = torch.empty((p, p, cap, d), dtype=shards.dtype, device=dev)
  row_bytes = d * shards.element_size()
  if cap == 0 or row_bytes == 0:
    return out
  # one base pointer per requester: on one card, rows of `out`
  base, stride = out.data_ptr(), p * cap * row_bytes
  dst = torch.arange(p, dtype=torch.int64, device=dev) * stride + base
  align = base | stride
  align = min(align & -align, 16)
  fn = _build.kernel('push_rows', 'glt_push_rows', _ARGTYPES)
  err = fn(recv_ids.data_ptr(), starts.data_ptr(), shards.data_ptr(), p,
           cap, r, row_bytes, dst.data_ptr(), align,
           torch.cuda.current_stream(dev).cuda_stream)
  _build.check(err, 'push_rows')
  push_rows.launches += 1
  return out


#: kernel launches (counted where the kernel is launched, nowhere else)
counted(push_rows)


def rdma_gather(mesh: Mesh, shards: torch.Tensor, bounds, ids: torch.Tensor,
                capacity: Optional[int] = None) -> torch.Tensor:
  """Row gather with the push reply path, for every partition at once.

  Args:
    mesh: the `Mesh` of the ``P`` partitions.
    shards: ``[P, R, D]`` (or ``[P, R]``, read as one column) stacked
      range shards; row ``i`` of shard ``p`` is global id ``bounds[p] +
      i``.
    bounds: ``[P + 1]`` ownership bounds (numpy or tensor).
    ids: ``[P, F]`` global ids each partition asks for (-1 padded).
    capacity: the dense per-destination capacity (None = exact).

  Returns ``[P, F, D]`` (``[P, F]``) rows, zero where the id is invalid
  or was past its owner's capacity.
  """
  one_col = shards.ndim == 2
  table = shards[..., None] if one_col else shards
  bounds_t = int64_on(bounds, ids.device)
  plan = plan_exchange(ids, range_owner_fn(bounds_t), mesh.size, mesh,
                       capacity)
  recv = plan.recv.reshape(mesh.size, mesh.size, plan.cap)
  buf = push_rows(recv.to(torch.int32), bounds_t[:-1].contiguous(), table)
  out = plan.stitch(buf, fill=0)
  return out[..., 0] if one_col else out
