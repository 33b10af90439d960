"""Delta-CSR merge ranks: the kernel (`csrc/merge_ranks.cu`, Hopper port
of the JAX package's Pallas `ops/pallas_delta.py::merge_ranks`), its
plain PyTorch version, and `merge_delta_csr_device`, the merge they
drive.

For each dirty row, with ``B`` the row's base columns (a CSR row, so
sorted) and ``S`` its new columns in EVENT order (not sorted)::

  pos_b[i] = i + #{j : S_j < B_i}
  pos_s[j] = #{i : B_i <= S_j} + #{m < j : S_m <= S_j}
                               + #{m > j : S_m <  S_j}

are the elements' positions in the merged row — the stable sort that
`coo_to_csr`'s lexsort gives: equal columns land base first, then in
event order.  The inputs are ragged (no padding, no width cap): the
dirty rows, the base read from the device ``indptr``/``indices``
where it already lives, each row's offset and count into the
src-sorted segment columns, and flat outputs ``pos_b [sum base_cnt]``
(row ``r`` at ``base_out[r]``) and ``pos_s [events]`` (row ``r`` at
``seg_off[r]``), int32.

`merge_ranks` runs the plain version for tensors on the CPU; for CUDA
tensors it launches the kernel or raises — there is no fallback and no
width at which it gives up.
"""
from __future__ import annotations

import ctypes
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build
from ..utils import ptr2ind, resolve_device

_P = ctypes.c_void_p
_ARGTYPES = (_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _P, _P, _P, _P)

#: elements of the broadcast compares the plain version holds at once
_PLAIN_BUDGET = 1 << 24

_INT32_MAX = np.iinfo(np.int32).max


class RankInputs(NamedTuple):
  """Host-side ragged inputs of the ranks for one segment.

  ``order`` is the stable argsort of the segment's sources; the segment
  columns in that order are the kernel's ``seg_cols``.  ``rows`` are the
  dirty rows ascending; row ``r``'s new columns are
  ``seg_cols[seg_off[r] : seg_off[r] + seg_cnt[r]]`` and its ``pos_b``
  block starts at ``base_out[r]``."""
  order: np.ndarray       # [events] int64
  rows: np.ndarray        # [R] int64
  seg_off: np.ndarray     # [R] int64
  seg_cnt: np.ndarray     # [R] int32
  base_cnt: np.ndarray    # [R] int64
  base_out: np.ndarray    # [R] int64

  @property
  def n_base(self) -> int:
    return int(self.base_cnt.sum())


def rank_inputs(indptr: np.ndarray, src: np.ndarray) -> RankInputs:
  """The ragged rank inputs of a segment with sources ``src`` over the
  host CSR row pointers ``indptr``."""
  src = np.asarray(src, np.int64)
  order = np.argsort(src, kind='stable')
  rows, seg_off, seg_cnt = np.unique(src[order], return_index=True,
                                     return_counts=True)
  indptr = np.asarray(indptr, np.int64)
  base_cnt = indptr[rows + 1] - indptr[rows]
  base_out = np.zeros(len(rows), np.int64)
  np.cumsum(base_cnt[:-1], out=base_out[1:])
  return RankInputs(order=order, rows=rows.astype(np.int64),
                    seg_off=seg_off.astype(np.int64),
                    seg_cnt=seg_cnt.astype(np.int32), base_cnt=base_cnt,
                    base_out=base_out)


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """``t[idx]`` as int64; zeros when ``t`` is empty (every position
  is then masked)."""
  if t.numel() == 0:
    return torch.zeros(idx.shape, dtype=torch.int64, device=idx.device)
  return t[idx].long()


def merge_ranks_plain(rows: torch.Tensor, indptr: torch.Tensor,
                      indices: torch.Tensor, seg_off: torch.Tensor,
                      seg_cnt: torch.Tensor, seg_cols: torch.Tensor,
                      base_out: torch.Tensor, n_base: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The plain PyTorch version (any device): the rank formulas by
  broadcast compare, over chunks of rows sized so no chunk holds more
  than `_PLAIN_BUDGET` compare elements."""
  merge_ranks_plain.calls += 1
  dev = rows.device
  pos_b = torch.empty(n_base, dtype=torch.int32, device=dev)
  pos_s = torch.empty(seg_cols.numel(), dtype=torch.int32, device=dev)
  start = indptr[rows]
  base_cnt = indptr[rows + 1] - start
  bcnt_h = base_cnt.cpu().numpy()
  scnt_h = seg_cnt.cpu().numpy().astype(np.int64)
  r, lo = rows.numel(), 0
  while lo < r:
    hi = min(r, lo + 4096)
    while True:
      lb = max(int(bcnt_h[lo:hi].max()), 1)
      ls = max(int(scnt_h[lo:hi].max()), 1)
      if hi - lo == 1 or (hi - lo) * ls * (lb + ls) <= _PLAIN_BUDGET:
        break
      hi = lo + (hi - lo) // 2
    sl = slice(lo, hi)
    bi = torch.arange(lb, device=dev)
    bmask = bi < base_cnt[sl, None]
    b = _take(indices, torch.where(bmask, start[sl, None] + bi, 0))
    si = torch.arange(ls, device=dev)
    smask = si < seg_cnt[sl, None].long()
    spos = torch.where(smask, seg_off[sl, None] + si, 0)
    s = _take(seg_cols, spos)
    # pos_b[i] = i + #{valid j : s_j < b_i}
    lt = (s[:, None, :] < b[:, :, None]) & smask[:, None, :]
    pb = bi + lt.sum(2)
    # pos_s[j] = #{valid i : b_i <= s_j} + #{valid m : s_m < s_j, or
    #            s_m == s_j and m < j}
    le = (b[:, None, :] <= s[:, :, None]) & bmask[:, None, :]
    sm, sj = s[:, None, :], s[:, :, None]
    before = ((sm < sj) | ((sm == sj) & (si[None, :] < si[:, None]))) \
        & smask[:, None, :]
    ps = le.sum(2) + before.sum(2)
    pos_b[(base_out[sl, None] + bi)[bmask]] = pb[bmask].to(torch.int32)
    pos_s[spos[smask]] = ps[smask].to(torch.int32)
    lo = hi
  return pos_b, pos_s


#: calls of the plain version (an ingest run on the card expects 0)
merge_ranks_plain.calls = 0


def merge_ranks(rows: torch.Tensor, indptr: torch.Tensor,
                indices: torch.Tensor, seg_off: torch.Tensor,
                seg_cnt: torch.Tensor, seg_cols: torch.Tensor,
                base_out: torch.Tensor, n_base: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
  """``(pos_b [n_base], pos_s [events])`` int32 merge ranks (module
  docstring).  ``rows``, ``seg_off``, ``base_out`` and ``indptr`` are
  int64, ``seg_cnt``, ``seg_cols`` and ``indices`` int32, all contiguous
  on one device; each base row ``indices[indptr[r]:indptr[r+1]]`` must
  be sorted.  On CUDA it launches on the current stream without
  synchronising."""
  dev = rows.device
  for name, t, dtype in (('rows', rows, torch.int64),
                         ('indptr', indptr, torch.int64),
                         ('indices', indices, torch.int32),
                         ('seg_off', seg_off, torch.int64),
                         ('seg_cnt', seg_cnt, torch.int32),
                         ('seg_cols', seg_cols, torch.int32),
                         ('base_out', base_out, torch.int64)):
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
      raise ValueError(f'{name} must be a contiguous {dtype} tensor on '
                       f'{dev}; got {t.dtype} on {t.device}')
  r = rows.numel()
  if not (seg_off.numel() == seg_cnt.numel() == base_out.numel() == r):
    raise ValueError('rows, seg_off, seg_cnt and base_out must have one '
                     'entry per dirty row')
  if dev.type == 'cpu':
    return merge_ranks_plain(rows, indptr, indices, seg_off, seg_cnt,
                             seg_cols, base_out, n_base)
  if dev.type != 'cuda':
    raise ValueError(f'merge_ranks runs on cpu or cuda, not {dev}')
  pos_b = torch.empty(n_base, dtype=torch.int32, device=dev)
  pos_s = torch.empty(seg_cols.numel(), dtype=torch.int32, device=dev)
  if r == 0:
    return pos_b, pos_s
  fn = _build.kernel('merge_ranks', 'glt_merge_ranks', _ARGTYPES)
  err = fn(rows.data_ptr(), r, indptr.data_ptr(), indices.data_ptr(),
           seg_off.data_ptr(), seg_cnt.data_ptr(), seg_cols.data_ptr(),
           base_out.data_ptr(), pos_b.data_ptr(), pos_s.data_ptr(),
           torch.cuda.current_stream(dev).cuda_stream)
  _build.check(err, 'merge_ranks')
  merge_ranks.launches += 1
  return pos_b, pos_s


#: kernel launches (counted where the kernel is launched, nowhere else)
merge_ranks.launches = 0


def merge_delta_csr_device(indptr: np.ndarray, indices: np.ndarray,
                           eids: np.ndarray, seg, *,
                           indptr_dev: Optional[torch.Tensor] = None,
                           indices_dev: Optional[torch.Tensor] = None,
                           device='cuda', timings: Optional[dict] = None
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """`streaming.delta.merge_delta_csr` with the dirty rows merged by
  `merge_ranks` — byte-identical to it, dtypes included (the result
  equals ``coo_to_csr`` over the full event-ordered edge list).

  The host does the new ``indptr`` prefix sum and the one-scatter
  shift of the whole base (as the JAX package's device merge does);
  the ranks of every dirty row come from one `merge_ranks` call on
  ``device``, reading the base rows from ``indptr_dev``/``indices_dev``
  (the previous view's device twins; uploaded from the host arrays
  when not given); the host then scatters the dirty rows by rank.
  ``timings``, when given, receives the host wall seconds of the
  ``shift``, ``ranks`` (upload, launch, download) and ``scatter``
  phases.
  """
  dev = resolve_device(device)
  t0 = time.perf_counter()
  num_nodes = len(indptr) - 1
  src = np.asarray(seg.src, np.int64)
  if src.size and (src.min() < 0 or src.max() >= num_nodes):
    raise ValueError(
        f'delta source ids out of range for num_nodes={num_nodes}')
  if num_nodes > _INT32_MAX:
    raise ValueError(f'num_nodes={num_nodes} does not fit the int32 '
                     'column ids the device graph holds')
  add = np.bincount(src, minlength=num_nodes).astype(np.int64)
  new_indptr = np.zeros(num_nodes + 1, np.int64)
  np.cumsum(np.diff(indptr) + add, out=new_indptr[1:])
  e_new = int(new_indptr[-1])
  new_indices = np.empty(e_new, indices.dtype)
  new_eids = np.empty(e_new, eids.dtype)
  if len(indices):
    # edge at old position p of row r lands at p + (new_indptr[r] -
    # indptr[r]); the dirty rows are overwritten below
    pos = np.arange(len(indices)) + (new_indptr[:-1] - indptr[:-1]
                                     )[ptr2ind(indptr)]
    new_indices[pos] = indices
    new_eids[pos] = eids
  t1 = time.perf_counter()
  t2 = t1
  if src.size:
    ri = rank_inputs(indptr, src)
    s_src = src[ri.order]
    s_dst = np.asarray(seg.dst)[ri.order]
    if indptr_dev is None:
      indptr_dev = torch.from_numpy(np.asarray(indptr, np.int64)).to(dev)
    if indices_dev is None:
      indices_dev = torch.from_numpy(
          np.asarray(indices, np.int32)).to(dev)

    def up(a, dtype):
      return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    pos_b, pos_s = merge_ranks(
        up(ri.rows, np.int64), indptr_dev, indices_dev,
        up(ri.seg_off, np.int64), up(ri.seg_cnt, np.int32),
        up(s_dst, np.int32), up(ri.base_out, np.int64), ri.n_base)
    pos_b, pos_s = pos_b.cpu().numpy(), pos_s.cpu().numpy()
    t2 = time.perf_counter()
    row_of_b = np.repeat(np.arange(len(ri.rows)), ri.base_cnt)
    within = np.arange(ri.n_base) - ri.base_out[row_of_b]
    srcpos = np.asarray(indptr)[ri.rows][row_of_b] + within
    tgt = new_indptr[ri.rows][row_of_b] + pos_b
    new_indices[tgt] = np.asarray(indices)[srcpos]
    new_eids[tgt] = np.asarray(eids)[srcpos]
    tgt = new_indptr[s_src] + pos_s
    new_indices[tgt] = s_dst.astype(new_indices.dtype)
    new_eids[tgt] = np.asarray(seg.eids)[ri.order].astype(new_eids.dtype)
  if timings is not None:
    timings.update(shift=t1 - t0, ranks=t2 - t1,
                   scatter=time.perf_counter() - t2)
  return new_indptr, new_indices, new_eids
