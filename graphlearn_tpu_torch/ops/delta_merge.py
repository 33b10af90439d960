"""Delta-CSR merge ranks: the kernel (`csrc/merge_ranks.cu`, Hopper port
of the JAX package's Pallas `ops/pallas_delta.py::merge_ranks`), its
plain PyTorch version, and `merge_delta_csr_device`, the merge they
drive.

For each dirty row, with ``B`` the row's base columns (a CSR row, so
sorted) and ``S`` its new columns in EVENT order (not sorted), compared
as signed int32::

  pos_b[i] = i + #{j : S_j < B_i}
  pos_s[j] = #{i : B_i <= S_j} + #{m : S_m < S_j, or S_m == S_j and m < j}

are the elements' positions in the merged row — the stable sort that
`coo_to_csr`'s lexsort gives: equal columns land base first, then in
event order.  The inputs are ragged (no padding, no width cap): per
dirty row its base start and width in ``indices`` (the device twin
where the base already lives), its offset and count into the
src-sorted segment columns, and its output offset; flat outputs
``pos_b [sum base_cnt]`` (row ``r`` at ``base_out[r]``) and ``pos_s
[events]`` (row ``r`` at ``seg_off[r]``), int32.

The host plans the launch (`rank_plan`): rows of at most `NARROW_BASE`
base and `NARROW_NEW` new columns are the narrow class (a warp a row),
the rest the wide class (blocks of `WIDE_QUERIES` queries, new columns
sorted in shared memory `MAX_TILE` keys at a time); `rank_rows` puts
the rows and the wide blocks' work on the device.  The split changes
the schedule only: the ranks are the formulas above for every row.

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
from ..utils import next_power_of_two, ptr2ind, resolve_device
from .launches import counted

_P = ctypes.c_void_p
_ARGTYPES = (_P, _P, _P, _P, _P, ctypes.c_longlong, _P, ctypes.c_longlong,
             ctypes.c_int, _P, _P, _P, _P, _P)

# The launch plan's sizes, fixed by the kernel (`csrc/merge_ranks.cu`:
# kNarrowBase, a lane's one new column, kThreads * kQueries, kMaxTile).
#: widest narrow row: base columns (4 a lane) and new columns (1 a lane)
NARROW_BASE = 128
NARROW_NEW = 32
#: queries (a wide row's base columns, then its new columns) a block owns
WIDE_QUERIES = 1024
#: new-column keys a wide block sorts at once in shared memory (64 KB)
MAX_TILE = 8192

#: elements of the broadcast compares the plain version holds at once
_PLAIN_BUDGET = 1 << 24

_INT32_MAX = np.iinfo(np.int32).max


class RankInputs(NamedTuple):
  """Host-side ragged inputs of the ranks for one segment.

  ``order`` is the stable argsort of the segment's sources; the segment
  columns in that order are the kernel's ``seg_cols``.  ``rows`` are the
  dirty rows ascending; row ``r``'s base is ``indices[base_start[r] :
  base_start[r] + base_cnt[r]]``, its new columns are
  ``seg_cols[seg_off[r] : seg_off[r] + seg_cnt[r]]`` and its ``pos_b``
  block starts at ``base_out[r]``."""
  order: np.ndarray       # [events] int64
  rows: np.ndarray        # [R] int64
  base_start: np.ndarray  # [R] int64
  base_cnt: np.ndarray    # [R] int64
  seg_off: np.ndarray     # [R] int64
  seg_cnt: np.ndarray     # [R] int32
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
  base_start = indptr[rows]
  base_cnt = indptr[rows + 1] - base_start
  base_out = np.zeros(len(rows), np.int64)
  np.cumsum(base_cnt[:-1], out=base_out[1:])
  return RankInputs(order=order, rows=rows.astype(np.int64),
                    base_start=base_start, base_cnt=base_cnt,
                    seg_off=seg_off.astype(np.int64),
                    seg_cnt=seg_cnt.astype(np.int32), base_out=base_out)


class RankPlan(NamedTuple):
  """The wide class of one `merge_ranks` call, from the rows' widths:
  ``blocks`` holds one ``(row, first query)`` pair a wide block, a row's
  queries being its base columns then its new columns; ``tile`` is the
  new-column keys a wide block sorts at once (0 when there is no wide
  row).  Every other row is narrow."""
  blocks: np.ndarray      # [W, 2] int64
  tile: int


def rank_plan(base_cnt: np.ndarray, seg_cnt: np.ndarray) -> RankPlan:
  """List the blocks of the rows of these base and new widths that are
  wider than the narrow class."""
  base_cnt = np.asarray(base_cnt, np.int64)
  seg_cnt = np.asarray(seg_cnt, np.int64)
  queries = base_cnt + seg_cnt
  if queries.size and (queries.max() > _INT32_MAX or base_cnt.min() < 0
                       or seg_cnt.min() < 0):
    raise ValueError('a merged row must hold 0 to 2**31 - 1 columns: its '
                     'ranks are int32')
  wide = np.flatnonzero((base_cnt > NARROW_BASE) | (seg_cnt > NARROW_NEW))
  if not wide.size:
    return RankPlan(blocks=np.zeros((0, 2), np.int64), tile=0)
  per_row = -(-queries[wide] // WIDE_QUERIES)
  first = (np.arange(int(per_row.sum()), dtype=np.int64)
           - np.repeat(np.cumsum(per_row) - per_row, per_row)) * WIDE_QUERIES
  return RankPlan(
      blocks=np.stack([np.repeat(wide, per_row), first], 1),
      tile=next_power_of_two(min(int(seg_cnt[wide].max()), MAX_TILE)))


class RankRows(NamedTuple):
  """One `merge_ranks` call's dirty rows on one device (`rank_rows`
  builds it): per row its base start and width in ``indices``, its
  offset and count in ``seg_cols`` and its ``pos_b`` offset; ``work``,
  one row a wide block: ``(base_start, seg_off, base_out, base_cnt,
  seg_cnt, first query)`` of its row; the plan's ``tile``; ``n_base``,
  the base columns of all rows.  The tensors are int64."""
  base_start: torch.Tensor  # [R]
  base_cnt: torch.Tensor    # [R]
  seg_off: torch.Tensor     # [R]
  seg_cnt: torch.Tensor     # [R]
  base_out: torch.Tensor    # [R]
  work: torch.Tensor        # [W, 6]
  tile: int
  n_base: int


def rank_rows(base_start, base_cnt, seg_off, seg_cnt, base_out,
              device='cuda') -> RankRows:
  """Plan the launch for these host per-row arrays (rows in any order)
  and put them on ``device`` in one copy: views of one buffer holding
  the work items first (the kernel reads an item as three 16-byte
  words), then the per-row arrays."""
  dev = resolve_device(device)
  plan = rank_plan(base_cnt, seg_cnt)
  cols = np.stack([np.asarray(a, np.int64) for a in
                   (base_start, base_cnt, seg_off, seg_cnt, base_out)])
  row, first = plan.blocks.T
  work = np.concatenate([cols[[0, 2, 4, 1, 3]][:, row], first[None]]).T
  flat = torch.from_numpy(np.concatenate([work.reshape(-1),
                                          cols.reshape(-1)])).to(dev)
  work_t, *per_row = flat.split([work.size] + [cols.shape[1]] * 5)
  return RankRows(*per_row, work=work_t.view(-1, 6), tile=plan.tile,
                  n_base=int(cols[1].sum()))


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """``t[idx]`` as int64; zeros when ``t`` is empty (every position
  is then masked)."""
  if t.numel() == 0:
    return torch.zeros(idx.shape, dtype=torch.int64, device=idx.device)
  return t[idx].long()


def merge_ranks_plain(rows: RankRows, indices: torch.Tensor,
                      seg_cols: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The plain PyTorch version (any device): the rank formulas by
  broadcast compare, over chunks of rows sized so no chunk holds more
  than `_PLAIN_BUDGET` compare elements.  The launch plan (``work``,
  ``tile``) is not read."""
  merge_ranks_plain.calls += 1
  dev = rows.base_start.device
  pos_b = torch.empty(rows.n_base, dtype=torch.int32, device=dev)
  pos_s = torch.empty(seg_cols.numel(), dtype=torch.int32, device=dev)
  start, seg_off, base_out = rows.base_start, rows.seg_off, rows.base_out
  base_cnt, seg_cnt = rows.base_cnt, rows.seg_cnt
  bcnt_h = base_cnt.cpu().numpy()
  scnt_h = seg_cnt.cpu().numpy()
  r, lo = start.numel(), 0
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
    smask = si < seg_cnt[sl, None]
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


def merge_ranks(rows: RankRows, indices: torch.Tensor,
                seg_cols: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """``(pos_b [rows.n_base], pos_s [events])`` int32 merge ranks (module
  docstring) of the dirty ``rows`` (from `rank_rows`) over the base
  columns ``indices`` and the segment columns ``seg_cols``, both int32,
  all contiguous on one device; each base row must be sorted.  On CUDA
  it launches on the current stream without synchronising."""
  dev = rows.base_start.device
  for name, t, dtype in (('base_start', rows.base_start, torch.int64),
                         ('base_cnt', rows.base_cnt, torch.int64),
                         ('seg_off', rows.seg_off, torch.int64),
                         ('seg_cnt', rows.seg_cnt, torch.int64),
                         ('base_out', rows.base_out, torch.int64),
                         ('work', rows.work, torch.int64),
                         ('indices', indices, torch.int32),
                         ('seg_cols', seg_cols, torch.int32)):
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
      raise ValueError(f'{name} must be a contiguous {dtype} tensor on '
                       f'{dev}; got {t.dtype} on {t.device}')
  if (rows.work.dim() != 2 or rows.work.shape[1] != 6
      or rows.work.data_ptr() % 16):
    raise ValueError('work must be [W, 6] and 16-byte aligned (the kernel '
                     f'reads an item as three 16-byte words); got '
                     f'{list(rows.work.shape)}')
  r = rows.base_start.numel()
  if not (rows.base_cnt.numel() == rows.seg_off.numel()
          == rows.seg_cnt.numel() == rows.base_out.numel() == r):
    raise ValueError('base_start, base_cnt, seg_off, seg_cnt and base_out '
                     'must have one entry per dirty row')
  if dev.type == 'cpu':
    return merge_ranks_plain(rows, indices, seg_cols)
  if dev.type != 'cuda':
    raise ValueError(f'merge_ranks runs on cpu or cuda, not {dev}')
  pos_b = torch.empty(rows.n_base, dtype=torch.int32, device=dev)
  pos_s = torch.empty(seg_cols.numel(), dtype=torch.int32, device=dev)
  if r == 0:
    return pos_b, pos_s
  fn = _build.kernel('merge_ranks', 'glt_merge_ranks', _ARGTYPES)
  err = fn(rows.base_start.data_ptr(), rows.base_cnt.data_ptr(),
           rows.seg_off.data_ptr(), rows.seg_cnt.data_ptr(),
           rows.base_out.data_ptr(), r, rows.work.data_ptr(),
           rows.work.shape[0], rows.tile, indices.data_ptr(),
           seg_cols.data_ptr(), pos_b.data_ptr(), pos_s.data_ptr(),
           torch.cuda.current_stream(dev).cuda_stream)
  _build.check(err, 'merge_ranks')
  merge_ranks.launches += 1
  return pos_b, pos_s


#: kernel launches (counted where the kernel is launched, nowhere else)
counted(merge_ranks)


def merge_delta_csr_device(indptr: np.ndarray, indices: np.ndarray,
                           eids: np.ndarray, seg, *,
                           indices_dev: Optional[torch.Tensor] = None,
                           device='cuda', timings: Optional[dict] = None
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """`streaming.delta.merge_delta_csr` with the dirty rows merged by
  `merge_ranks` — byte-identical to it, dtypes included (the result
  equals ``coo_to_csr`` over the full event-ordered edge list).

  The host does the new ``indptr`` prefix sum and the one-scatter
  shift of the whole base (as the JAX package's device merge does);
  the ranks of every dirty row come from one `merge_ranks` call on
  ``device``, reading the base rows from ``indices_dev`` (the previous
  view's device twin; uploaded from the host array when not given) at
  the starts the host reads from ``indptr``; the host then scatters the
  dirty rows by rank.  ``timings``, when given, receives the host wall
  seconds of the ``shift``, ``ranks`` (plan, upload, launch, download)
  and ``scatter`` phases.
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
    if indices_dev is None:
      indices_dev = torch.from_numpy(
          np.asarray(indices, np.int32)).to(dev)
    pos_b, pos_s = merge_ranks(
        rank_rows(ri.base_start, ri.base_cnt, ri.seg_off, ri.seg_cnt,
                  ri.base_out, dev), indices_dev,
        torch.from_numpy(np.ascontiguousarray(s_dst, np.int32)).to(dev))
    pos_b, pos_s = pos_b.cpu().numpy(), pos_s.cpu().numpy()
    t2 = time.perf_counter()
    row_of_b = np.repeat(np.arange(len(ri.rows)), ri.base_cnt)
    within = np.arange(ri.n_base) - ri.base_out[row_of_b]
    srcpos = ri.base_start[row_of_b] + within
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
