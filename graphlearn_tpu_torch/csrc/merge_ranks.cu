// Stable merge ranks of the dirty rows of a delta-CSR merge: the
// Hopper kernel behind graphlearn_tpu_torch/ops/delta_merge.py.
//
// Replaces the Pallas rank kernel of graphlearn_tpu/ops/pallas_delta.py
// (`_rank_call`, kernel body `_rank_kernel`).  For dirty row r, with B
// its base columns indices[base_start[r] .. + base_cnt[r]) (a CSR row,
// sorted ascending) and S its new columns seg_cols[seg_off[r] .. +
// seg_cnt[r]) in EVENT order (not sorted), compared as signed int32:
//
//   pos_b[base_out[r] + i] = i + #{j : S_j < B_i}
//   pos_s[seg_off[r] + j]  = #{i : B_i <= S_j}
//                            + #{m : S_m < S_j, or S_m == S_j and m < j}
//
// the elements' positions in the merged row under coo_to_csr's stable
// lexsort (equal columns: base first, then event order).  Rows are
// ragged, with no sentinel padding and no width cap; the TPU kernel
// padded every row to the batch's widest with an int32-max sentinel,
// capped widths at 2,048 and compared [L, L] tiles in VMEM, which is
// O(Lb * Ls + Ls^2) a row.
//
// What bounds it on the H100.  A publish of 4,096 uniform events into
// the products graph has ~4,095 dirty rows of up to ~43 base columns
// and 1-2 new ones: ~1 MB in and out, 0.3 us of HBM time.  So the
// launch and the chain of dependent loads a row waits on (its widths
// and offsets, then its columns) set the time, not bytes.  The first
// port gave every row a 128-thread block (most threads idle, two waves
// of blocks), read the row id, then indptr, then the columns, staged the
// new columns through shared memory behind barriers and searched the
// base in device memory; one block owned a whole row, so a forced
// 8,192 x 512 row cost O(Lb * Ls + Ls^2) serial compares on 128 threads.
//
// Design.  The host passes each row's base start already read from
// indptr, so no row id is dereferenced here, and lists the work items
// of the rows wider than the narrow class.  One launch a call; a
// block's index gives its role: the first blocks give every row a warp,
// 8 a block (a warp on a wide row leaves it to its work items), the
// rest one wide work item each.
//
//   narrow (base <= 128 and new <= 32 columns): a warp a row, all in
//     registers.  Lanes load the row's widths and offsets (one round),
//     then the base row coalesced, up to 4 columns a lane, and the new
//     columns one a lane (a second round).  Each new column in turn is
//     broadcast by a shuffle: every lane counts it against its base
//     columns and its own new column's stable in-segment rank, and a
//     ballot counts the base columns at or below it.  No shared memory,
//     no barrier; stores are coalesced.
//   wide (the rest): the host gives each row ceil((Lb + Ls) / 1,024)
//     work items, each with the row's widths and offsets in it, so a
//     block's chain is as short as a warp's, and no block holds an
//     8,192-wide row alone.  A block owns 1,024 consecutive queries of
//     its row (its base columns, then its new columns), stages the new
//     columns in shared memory as 64-bit keys (the column with its sign
//     bit flipped, so unsigned order is signed order, over its index j)
//     and sorts them: up to 256 keys each thread counts the keys below
//     its own and places it, beyond that a bitonic network.  A base
//     query counts the keys below it, a new column's query its own
//     key's position among them (exactly its stable in-segment count),
//     each by binary search; a new column then adds an upper bound over
//     its base row, searched in splitters of the row staged in shared
//     memory (the whole row up to 1,024 columns, else the last column of
//     each stride) and within one stride in device memory.
//     O((Lb + Ls) log Ls) work a row.  New columns past one tile of
//     shared memory (8,192 keys, 64 KB) are sorted and searched a tile
//     at a time, so no width is refused.
//
// Tried on the H100 and left out (PERF.md has the final numbers): up to
// 64 new columns a narrow row (two a lane) ran faster with thousands of
// rows but slower with a hub burst's few, where one warp's serial loop
// over 64 columns outlasted a wide block; counting a new column's base
// columns by shuffle binary search in place of the ballots was slower at
// the path's 1-2 new columns; reading a wide row's widths through its
// row index added a dependent load; putting the narrow rows first on
// the host (so no warp meets a wide row) was no faster on the path and
// cost a host permutation; register caps (launch bounds) made ptxas
// spill.  The kernel holds 40 registers a thread.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // 8 warps a block, in both roles
constexpr int kWarps = kThreads / 32;
constexpr int kNarrowBase = 128;    // base columns a narrow row may hold
constexpr int kBaseRegs = kNarrowBase / 32;
constexpr int kNarrowNew = 32;      // new columns a narrow row may hold
constexpr int kQueries = 4;         // queries a thread of a wide block
constexpr int kMaxTile = 8192;      // keys a wide block sorts at once
constexpr int kWork = 6;            // int64 words of a wide work item
constexpr int kSplit = 1024;        // base splitters a wide block holds
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPad = ~0ull;  // above every real key

__device__ __forceinline__ unsigned long long make_key(int32_t col,
                                                      int64_t j) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(col) ^
                                          0x80000000u) << 32) |
         static_cast<unsigned long long>(j);
}

// #{t < n : keys[t] < key} over ascending keys
__device__ __forceinline__ int count_below(const unsigned long long* keys,
                                           int n, unsigned long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #{i < n : base[i] <= v} over an ascending base row
__device__ __forceinline__ int upper_bound(const int32_t* base, int n,
                                           int32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (base[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Sort keys[0, n) ascending; keys[n, m) hold kPad, m the power of two
// at or above n.  Every thread of the block calls it; it returns after
// a barrier.  Up to one key a thread, a rank sort: each thread counts
// the keys below its own and places it (keys are distinct: j breaks
// ties); beyond, a bitonic network over m.
__device__ __forceinline__ void sort_keys(unsigned long long* keys, int n,
                                          int m) {
  if (n <= kThreads) {
    const unsigned long long mine =
        static_cast<int>(threadIdx.x) < n ? keys[threadIdx.x] : kPad;
    int below = 0;
#pragma unroll 8
    for (int i = 0; i < n; ++i) below += keys[i] < mine;
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < n) keys[below] = mine;
    __syncthreads();
    return;
  }
  const int half = m >> 1;
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < half; i += kThreads) {
        const int lo = 2 * i - (i & (j - 1));
        const int hi = lo + j;
        const unsigned long long a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & k) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// One narrow row on one warp: b0, lb, s0, ls and o are its base start
// and width, segment offset and width, and pos_b offset.
__device__ __forceinline__ void narrow_row(
    int lane, int64_t b0, int lb, int64_t s0, int ls, int64_t o,
    const int32_t* __restrict__ indices, const int32_t* __restrict__ seg_cols,
    int32_t* __restrict__ pos_b, int32_t* __restrict__ pos_s) {
  int32_t b[kBaseRegs];
#pragma unroll
  for (int k = 0; k < kBaseRegs; ++k) {
    const int i = lane + 32 * k;
    b[k] = i < lb ? indices[b0 + i] : 0;
  }
  const int32_t s = lane < ls ? seg_cols[s0 + lane] : 0;
  // every new column in turn, broadcast: the base columns above it and
  // the new columns it precedes in the stable order count it, and a
  // ballot counts the base columns at or below it for its own lane
  int below[kBaseRegs] = {};
  int base_le = 0, before = 0;
#pragma unroll 4
  for (int j = 0; j < ls; ++j) {
    const int32_t q = __shfl_sync(kFull, s, j);
    int le = 0;
#pragma unroll
    for (int k = 0; k < kBaseRegs; ++k) {
      below[k] += q < b[k];
      if (32 * k < lb)                // lb is the warp's
        le += __popc(__ballot_sync(kFull, (lane + 32 * k < lb) & (b[k] <= q)));
    }
    base_le = lane == j ? le : base_le;
    before += (q < s) | ((q == s) & (j < lane));
  }
#pragma unroll
  for (int k = 0; k < kBaseRegs; ++k) {
    const int i = lane + 32 * k;
    if (i < lb) pos_b[o + i] = i + below[k];
  }
  if (lane < ls) pos_s[s0 + lane] = base_le + before;
}

// One wide work item: w = {base start, segment offset, pos_b offset,
// base width, segment width, first query} of one row, the block owning
// queries [q0, q0 + kThreads * kQueries), where query q < Lb is base
// column q and Lb <= q < Lb + Ls new column q - Lb.
__device__ __forceinline__ void wide_item(
    const int64_t* __restrict__ w, int tile, unsigned long long* keys,
    const int32_t* __restrict__ indices, const int32_t* __restrict__ seg_cols,
    int32_t* __restrict__ pos_b, int32_t* __restrict__ pos_s) {
  const longlong2 w01 = reinterpret_cast<const longlong2*>(w)[0];
  const longlong2 w23 = reinterpret_cast<const longlong2*>(w)[1];
  const longlong2 w45 = reinterpret_cast<const longlong2*>(w)[2];
  const int64_t b0 = w01.x, s0 = w01.y, o = w23.x, q0 = w45.y;
  const int lb = static_cast<int>(w23.y), ls = static_cast<int>(w45.x);
  // a block with new columns keeps splitters of the base row in shared
  // memory beside the keys, the last column of each stride: the whole
  // row up to kSplit columns
  const bool has_new = q0 + kThreads * kQueries > lb;
  const int stride = lb <= kSplit ? 1 : (lb + kSplit - 1) / kSplit;
  const int n_split = (lb + stride - 1) / stride;
  int32_t* split = reinterpret_cast<int32_t*>(keys + tile);
  int32_t col[kQueries];
  int rank[kQueries];
#pragma unroll
  for (int k = 0; k < kQueries; ++k) {
    const int64_t q = q0 + threadIdx.x + k * kThreads;
    col[k] = q < lb ? indices[b0 + q] : (q < lb + ls ? seg_cols[s0 + q - lb]
                                                     : 0);
    rank[k] = q < lb ? static_cast<int>(q) : 0;
  }
  // tiles [t0, t0 + n) of the new columns (t0 + tile is formed only
  // below ls, so it cannot overflow)
  for (int t0 = 0; t0 < ls; t0 = ls - t0 > tile ? t0 + tile : ls) {
    const int n = ls - t0 < tile ? ls - t0 : tile;
    int m = 1;
    while (m < n) m <<= 1;
    if (t0 > 0) __syncthreads();      // the previous tile is consumed
    for (int i = threadIdx.x; i < m; i += kThreads)
      keys[i] = i < n ? make_key(seg_cols[s0 + t0 + i], t0 + i) : kPad;
    if (t0 == 0 && has_new) {
      for (int i = threadIdx.x; i < n_split; i += kThreads)
        split[i] = indices[b0 + (i + 1 < n_split ? (i + 1) * stride : lb) - 1];
    }
    __syncthreads();
    sort_keys(keys, n, m);
#pragma unroll
    for (int k = 0; k < kQueries; ++k) {
      // a base column's key takes index 0, so it counts only the keys
      // of smaller columns; a new column's counts its stable rank
      const int64_t q = q0 + threadIdx.x + k * kThreads;
      if (q < lb + ls)
        rank[k] += count_below(keys, n, make_key(col[k], q < lb ? 0 : q - lb));
    }
  }
#pragma unroll
  for (int k = 0; k < kQueries; ++k) {
    const int64_t q = q0 + threadIdx.x + k * kThreads;
    if (q < lb) {
      pos_b[o + q] = rank[k];
    } else if (q < lb + ls) {         // + #{i : B_i <= S_j}
      // strides whose last column is at or below it, then the columns
      // of the next stride
      const int c = upper_bound(split, n_split, col[k]);
      int le = c < n_split ? c * stride : lb;
      if (stride > 1 && c < n_split) {
        const int n = lb - le < stride ? lb - le : stride;
        le += upper_bound(indices + b0 + le, n, col[k]);
      }
      pos_s[s0 + q - lb] = rank[k] + le;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
merge_ranks_kernel(const int64_t* __restrict__ base_start,
                   const int64_t* __restrict__ base_cnt,
                   const int64_t* __restrict__ seg_off,
                   const int64_t* __restrict__ seg_cnt,
                   const int64_t* __restrict__ base_out, int64_t n_rows,
                   int64_t narrow_blocks, const int64_t* __restrict__ work,
                   int tile, const int32_t* __restrict__ indices,
                   const int32_t* __restrict__ seg_cols,
                   int32_t* __restrict__ pos_b, int32_t* __restrict__ pos_s) {
  extern __shared__ unsigned long long keys[];
  const int64_t blk = blockIdx.x;
  if (blk < narrow_blocks) {
    const int64_t p = blk * kWarps + (threadIdx.x >> 5);
    if (p >= n_rows) return;
    const int64_t b0 = base_start[p], s0 = seg_off[p], o = base_out[p];
    const int64_t lb = base_cnt[p], ls = seg_cnt[p];
    // a wide row is left to its work items: its warp runs with no
    // columns (a branch here let the compiler sink the other loads
    // behind the widths, a dependent load more)
    const bool narrow = lb <= kNarrowBase && ls <= kNarrowNew;
    narrow_row(threadIdx.x & 31, b0, narrow ? static_cast<int>(lb) : 0, s0,
               narrow ? static_cast<int>(ls) : 0, o, indices, seg_cols,
               pos_b, pos_s);
    return;
  }
  wide_item(work + kWork * (blk - narrow_blocks), tile, keys, indices,
            seg_cols, pos_b, pos_s);
}

}  // namespace

// The per-row arrays (int64) hold n_rows rows, in any order (a warp
// reads each and leaves a wide one to its work items); work holds
// n_work items of kWork int64 words (base start, segment offset, pos_b
// offset, base width, segment width, first query), one a wide block;
// tile (a power of two, at most kMaxTile; at least 1 when n_work > 0)
// is the keys a wide block sorts at once.
extern "C" int glt_merge_ranks(const void* base_start, const void* base_cnt,
                               const void* seg_off, const void* seg_cnt,
                               const void* base_out, long long n_rows,
                               const void* work, long long n_work, int tile,
                               const void* indices, const void* seg_cols,
                               void* pos_b, void* pos_s, void* stream) {
  if (n_rows < 0 || n_work < 0 || tile < 0 || tile > kMaxTile ||
      (tile & (tile - 1)) != 0 || (n_work > 0 && tile == 0))
    return cudaErrorInvalidValue;
  const long long narrow_blocks = (n_rows + kWarps - 1) / kWarps;
  const long long blocks = narrow_blocks + n_work;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the keys, then the base splitters
  const size_t smem = n_work > 0 ? sizeof(unsigned long long) * tile +
                                       sizeof(int32_t) * kSplit
                                 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_ranks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  merge_ranks_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(base_start),
      static_cast<const int64_t*>(base_cnt),
      static_cast<const int64_t*>(seg_off),
      static_cast<const int64_t*>(seg_cnt),
      static_cast<const int64_t*>(base_out), n_rows, narrow_blocks,
      static_cast<const int64_t*>(work), tile,
      static_cast<const int32_t*>(indices),
      static_cast<const int32_t*>(seg_cols), static_cast<int32_t*>(pos_b),
      static_cast<int32_t*>(pos_s));
  return static_cast<int>(cudaGetLastError());
}
