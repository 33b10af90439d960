// Stable merge ranks of the dirty rows of a delta-CSR merge: the
// Hopper kernel behind graphlearn_tpu_torch/ops/delta_merge.py.
//
// Replaces the Pallas rank kernel of graphlearn_tpu/ops/pallas_delta.py
// (`_rank_call`, kernel body `_rank_kernel`).  For dirty row r, with B
// its base columns indices[indptr[row] .. indptr[row+1]) (a CSR row,
// sorted ascending) and S its new columns seg_cols[seg_off[r] ..
// seg_off[r] + seg_cnt[r]) in EVENT order (not sorted):
//
//   pos_b[base_out[r] + i] = i + #{j : S_j < B_i}
//   pos_s[seg_off[r] + j]  = #{i : B_i <= S_j} + #{m < j : S_m <= S_j}
//                                              + #{m > j : S_m <  S_j}
//
// the elements' positions in the merged row under coo_to_csr's stable
// lexsort (equal columns: base first, then event order).
//
// What bounds it on the H100: bytes at the serving graph's shapes.  A
// publish of 4,096 uniform events touches ~4,096 rows of ~25 base
// columns and 1-2 new ones: under a megabyte read and written, well
// under a microsecond of HBM time, so a launch is bound by launch
// latency.  The compares are O(Lb * Ls + Ls^2) per row, which only a
// wide row with many new columns makes count.
//
// Design for this card, not carried over from the TPU: the TPU kernel
// padded every row to the batch's widest row with an int32-max
// sentinel and capped widths at 2048 (its [L, L] compare tiles had to
// fit VMEM).  Here the rows are ragged and there is no cap: one block
// per dirty row; the row's new columns are staged through shared
// memory in tiles of kTile (a row wider than that loops over tiles);
// a base element counts the staged new columns below it; a new column
// finds #{B_i <= S_j} by a binary search over its sorted base row in
// device memory and counts the staged new columns before it.  The base
// row is read where the published view already holds it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 2048;

// Stage tile [t0, t0 + n) of the row's new columns.  Every thread of
// the block calls it (it synchronises before and after).
__device__ __forceinline__ void stage(int32_t* tile,
                                      const int32_t* __restrict__ seg,
                                      int64_t t0, int n) {
  __syncthreads();                    // the previous tile is consumed
  for (int t = threadIdx.x; t < n; t += kThreads) tile[t] = seg[t0 + t];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
merge_ranks_kernel(const int64_t* __restrict__ rows, int64_t n_rows,
                   const int64_t* __restrict__ indptr,
                   const int32_t* __restrict__ indices,
                   const int64_t* __restrict__ seg_off,
                   const int32_t* __restrict__ seg_cnt,
                   const int32_t* __restrict__ seg_cols,
                   const int64_t* __restrict__ base_out,
                   int32_t* __restrict__ pos_b, int32_t* __restrict__ pos_s) {
  __shared__ int32_t tile[kTile];
  for (int64_t r = blockIdx.x; r < n_rows; r += gridDim.x) {
    const int64_t row = rows[r];
    const int64_t b0 = indptr[row];
    const int64_t lb = indptr[row + 1] - b0;
    const int32_t* base = indices + b0;
    const int32_t* seg = seg_cols + seg_off[r];
    const int64_t ls = seg_cnt[r];
    int32_t* out_b = pos_b + base_out[r];
    int32_t* out_s = pos_s + seg_off[r];

    // base ranks: i + #{j : S_j < B_i}
    for (int64_t i0 = 0; i0 < lb; i0 += kThreads) {
      const int64_t i = i0 + threadIdx.x;
      const int32_t b = i < lb ? base[i] : 0;
      int64_t below = 0;
      for (int64_t t0 = 0; t0 < ls; t0 += kTile) {
        const int n = static_cast<int>(ls - t0 < kTile ? ls - t0 : kTile);
        stage(tile, seg, t0, n);
        for (int t = 0; t < n; ++t) below += tile[t] < b;
      }
      if (i < lb) out_b[i] = static_cast<int32_t>(i + below);
    }

    // new-column ranks: #{B_i <= S_j} + #{m : S_m < S_j, or S_m == S_j
    // and m < j}
    for (int64_t j0 = 0; j0 < ls; j0 += kThreads) {
      const int64_t j = j0 + threadIdx.x;
      const bool live = j < ls;
      const int32_t s = live ? seg[j] : 0;
      int64_t rank = 0;
      if (live) {                     // upper bound of s in the base row
        int64_t lo = 0, hi = lb;
        while (lo < hi) {
          const int64_t mid = (lo + hi) >> 1;
          if (base[mid] <= s) lo = mid + 1; else hi = mid;
        }
        rank = lo;
      }
      for (int64_t t0 = 0; t0 < ls; t0 += kTile) {
        const int n = static_cast<int>(ls - t0 < kTile ? ls - t0 : kTile);
        stage(tile, seg, t0, n);
        for (int t = 0; t < n; ++t) {
          const int32_t v = tile[t];
          rank += (v < s) || (v == s && t0 + t < j);
        }
      }
      if (live) out_s[j] = static_cast<int32_t>(rank);
    }
  }
}

}  // namespace

extern "C" int glt_merge_ranks(const void* rows, long long n_rows,
                               const void* indptr, const void* indices,
                               const void* seg_off, const void* seg_cnt,
                               const void* seg_cols, const void* base_out,
                               void* pos_b, void* pos_s, void* stream) {
  if (n_rows < 0) return cudaErrorInvalidValue;
  if (n_rows > 0) {
    const long long max_grid = 1LL << 30;
    const dim3 grid(static_cast<unsigned>(n_rows < max_grid ? n_rows
                                                             : max_grid));
    merge_ranks_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(rows), n_rows,
        static_cast<const int64_t*>(indptr),
        static_cast<const int32_t*>(indices),
        static_cast<const int64_t*>(seg_off),
        static_cast<const int32_t*>(seg_cnt),
        static_cast<const int32_t*>(seg_cols),
        static_cast<const int64_t*>(base_out),
        static_cast<int32_t*>(pos_b), static_cast<int32_t*>(pos_s));
  }
  return static_cast<int>(cudaGetLastError());
}
