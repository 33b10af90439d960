// One-hop uniform neighbor sampling with injected draws: the Hopper
// kernel behind graphlearn_tpu_torch/ops/fused_sample.py.
//
// Replaces the uniform arm of the Pallas kernel in
// graphlearn_tpu/ops/pallas_sample.py (`_fused_draw`, kernel body
// `_make_kernel`), and computes the same values as the XLA
// `ops/neighbor.py::sample_one_hop(..., sort_locality=False)` given the
// same draws.  Per frontier row (seed s, degree deg, window w):
//
//   * s < 0             -> deg = 0, every slot masked (INVALID_ID);
//   * deg <= k          -> take all: slot j holds indices[start + j];
//   * k < deg <= w      -> without replacement: Gumbel top-k over the
//                          first deg window entries; slot j holds the
//                          entry of rank j under (value desc, index asc),
//                          the order jax.lax.top_k returns;
//   * deg > w           -> with replacement: off = min(trunc(u * deg),
//                          deg - 1), the product in f32.
//
// Every read position is clipped to [0, E-1] as the XLA gather does.
//
// What bounds it on the H100: bytes.  A row reads its seed (4 B), two
// indptr entries (16 B), the draws it needs (4 B per in-degree Gumbel,
// or 4 B per u) and k neighbor ids, and writes 5 B per slot.  At
// serving sizes (up to a few thousand rows per hop) that is well under
// a microsecond of HBM time, so a launch is bound by launch latency.
//
// Design for this card, not carried over from the TPU: one warp per
// row, eight rows per block.  The TPU kernel fetched two aligned 4 KB
// units per seed and rotated lanes to cut the window out; here the
// warp reads its Gumbels coalesced at any offset into a per-warp
// shared-memory row, and each lane ranks its entries against the row
// (broadcast reads, no bank conflicts): rank(e) = #{f : g[f] > g[e] or
// (g[f] == g[e] and f < e)}.  The entry of rank r < k writes slot r
// directly, so no sort network and no window tensor reach HBM, and
// only the k winners' neighbor ids are read.  The hub arm reads
// indices[start + off] directly.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxWindow = 256;

__global__ void __launch_bounds__(kWarps * 32)
sample_one_hop_kernel(const int64_t* __restrict__ indptr, int64_t n_nodes,
                      const int32_t* __restrict__ indices, int64_t n_edges,
                      const int32_t* __restrict__ seeds, int64_t n_rows,
                      const float* __restrict__ u,
                      const float* __restrict__ gumbel, int k, int w,
                      int32_t* __restrict__ nbrs, bool* __restrict__ mask) {
  __shared__ float window[kWarps][kMaxWindow];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (row >= n_rows) return;  // the whole warp leaves together

  const int32_t s = seeds[row];
  int64_t start = 0;
  int deg = 0;
  if (s >= 0) {
    // out-of-range ids clamp like an XLA gather: deg becomes 0
    const int64_t lo = s < n_nodes ? s : n_nodes;
    const int64_t hi = lo + 1 < n_nodes ? lo + 1 : n_nodes;
    start = indptr[lo];
    deg = static_cast<int>(indptr[hi] - start);
  }
  const int64_t last = n_edges > 0 ? n_edges - 1 : 0;
  int32_t* out = nbrs + row * k;
  bool* out_mask = mask + row * k;

  if (deg <= k || deg > w) {
    const int take = deg < k ? deg : k;
    for (int j = lane; j < k; j += 32) {
      int32_t v = -1;
      if (j < take) {
        int off = j;
        if (deg > k) {
          const float p = __fmul_rn(u[row * k + j], static_cast<float>(deg));
          off = static_cast<int>(p);
          off = off < deg - 1 ? off : deg - 1;
        }
        int64_t pos = start + off;
        pos = pos < 0 ? 0 : (pos > last ? last : pos);
        v = indices[pos];
      }
      out[j] = v;
      out_mask[j] = j < take;
    }
    return;
  }

  // k < deg <= w: rank-select the k largest Gumbels of the window
  float* g = window[warp];
  const float* g_row = gumbel + row * w;
  for (int e = lane; e < deg; e += 32) g[e] = g_row[e];
  __syncwarp();
  for (int e = lane; e < deg; e += 32) {
    const float ge = g[e];
    int rank = 0;
    for (int f = 0; f < deg; ++f) {
      const float gf = g[f];
      rank += (gf > ge) || (gf == ge && f < e);
    }
    if (rank < k) {
      int64_t pos = start + e;
      pos = pos > last ? last : pos;
      out[rank] = indices[pos];
    }
  }
  for (int j = lane; j < k; j += 32) out_mask[j] = true;
}

}  // namespace

extern "C" int glt_sample_one_hop(const void* indptr, long long n_nodes,
                                  const void* indices, long long n_edges,
                                  const void* seeds, long long n_rows,
                                  const void* u, const void* gumbel, int k,
                                  int w, void* nbrs, void* mask,
                                  void* stream) {
  if (k < 1 || w < k || w > kMaxWindow) return cudaErrorInvalidValue;
  if (n_rows > 0) {
    const dim3 grid(static_cast<unsigned>((n_rows + kWarps - 1) / kWarps));
    sample_one_hop_kernel<<<grid, kWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(indptr), n_nodes,
        static_cast<const int32_t*>(indices), n_edges,
        static_cast<const int32_t*>(seeds), n_rows,
        static_cast<const float*>(u), static_cast<const float*>(gumbel), k, w,
        static_cast<int32_t*>(nbrs), static_cast<bool*>(mask));
  }
  return static_cast<int>(cudaGetLastError());
}
