// One-hop cache-aware (GNS) neighbor sampling with injected draws: the
// Hopper kernel behind graphlearn_tpu_torch/ops/fused_sample.py
// (`sample_one_hop_gns_fused`).
//
// Replaces the GNS arm of the Pallas kernel in
// graphlearn_tpu/ops/pallas_sample.py (`_fused_draw` with gns=True,
// kernel body `_make_kernel`, the arm at its lines 178-207), and
// computes the same values as the XLA
// `ops/gns.py::sample_one_hop_gns(..., sort_locality=False)` given the
// same uniforms.  Per frontier row (seed s, degree deg, window w):
//
//   * s < 0           -> deg = 0: every slot masked (-1), weight 0;
//   * deg <= k        -> take all: slot j holds indices[start + j],
//                        weight 1;
//   * k < deg <= w    -> k independent draws from q(e) ∝ wgt[e] =
//                        1 + boost * bit(table[row], id_e) over the
//                        window: cum = inclusive prefix sum of wgt,
//                        total = cum[deg-1],
//                        off_j = min(#{e : cum[e] <= v_j * max(total,
//                        1e-9)}, deg - 1), weight (total / deg) /
//                        max(wgt[off_j], 1e-9);
//   * deg > w         -> with replacement: off = min(trunc(u * deg),
//                        deg - 1), weight 1.
//
// Every read position is clipped to [0, E-1] as the XLA gather does.
// Products, sums and quotients are single IEEE round-to-nearest
// operations (__fmul_rn, __fadd_rn, __fdiv_rn; built without
// --use_fast_math).  When boost and its multiples are exact in f32
// (16, 3), every cum and total is an exact integer whatever the order of
// the scan, so the results are byte-equal to the plain and JAX versions.
//
// What bounds it on the H100: bytes.  A medium row reads its seed, two
// indptr entries, its table row index, k draws, deg window ids and deg
// bit bytes, and writes 9 bytes per slot.  The bits table row
// (ceil(N/8) bytes, 306 KB at products scale) stays in the 50 MB L2.
//
// Design for this card, not carried over from the TPU: one warp per
// row, eight rows per block.  The TPU kernel DMA'd two aligned 4 KB
// units per seed, cut the window out with lane rotates and kept the
// whole bits table in VMEM; here the warp reads the window ids
// coalesced at any offset into shared memory, reads each id's byte of
// its table row straight from global memory (L2-resident), scans the
// weights 32 at a time with shuffles and a carried total, and each lane
// then answers its draws by a binary search over the shared cum (cum is
// nondecreasing, so the upper bound is the count of cum <= draw).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxWindow = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t clip(int64_t p, int64_t last) {
  return p < 0 ? 0 : (p > last ? last : p);
}

__global__ void __launch_bounds__(kWarps * 32)
sample_gns_kernel(const int64_t* __restrict__ indptr, int64_t n_nodes,
                  const int32_t* __restrict__ indices, int64_t n_edges,
                  const int32_t* __restrict__ seeds, int64_t n_rows,
                  const float* __restrict__ u, const float* __restrict__ v,
                  const uint8_t* __restrict__ table, int64_t table_rows,
                  int64_t nbytes, const int32_t* __restrict__ table_row,
                  int k, int w, float boost, int32_t* __restrict__ nbrs,
                  bool* __restrict__ mask, float* __restrict__ weights) {
  __shared__ int32_t s_ids[kWarps][kMaxWindow];
  __shared__ float s_wgt[kWarps][kMaxWindow];
  __shared__ float s_cum[kWarps][kMaxWindow];
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
  float* out_w = weights + row * k;

  if (deg <= k || deg > w) {
    const int take = deg < k ? deg : k;
    for (int j = lane; j < k; j += 32) {
      int32_t val = -1;
      if (j < take && n_edges > 0) {
        int off = j;
        if (deg > k) {
          const float p = __fmul_rn(u[row * k + j], static_cast<float>(deg));
          off = static_cast<int>(p);
          off = off < deg - 1 ? off : deg - 1;
        }
        val = indices[clip(start + off, last)];
      }
      out[j] = val;
      out_mask[j] = j < take;
      out_w[j] = j < take ? 1.0f : 0.0f;
    }
    return;
  }

  // k < deg <= w: the biased inverse-CDF draw over the window
  int64_t trow = table_row[row];
  trow = trow < 0 ? 0 : (trow >= table_rows ? table_rows - 1 : trow);
  const uint8_t* bits = table + trow * nbytes;
  int32_t* ids = s_ids[warp];
  float* wgt = s_wgt[warp];
  float* cum = s_cum[warp];
  float carry = 0.0f;
  for (int base = 0; base < deg; base += 32) {
    const int e = base + lane;
    float x = 0.0f;
    if (e < deg) {
      const int32_t id = indices[clip(start + e, last)];
      unsigned bit = 0;
      if (id >= 0) {
        const int64_t byte = (id >> 3) < nbytes ? (id >> 3) : nbytes - 1;
        bit = (bits[byte] >> (id & 7)) & 1u;
      }
      x = __fadd_rn(1.0f, __fmul_rn(boost, static_cast<float>(bit)));
      ids[e] = id;
      wgt[e] = x;
    }
    // inclusive warp scan of this chunk, then the carried total
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x = __fadd_rn(x, y);
    }
    const float c = __fadd_rn(carry, x);
    if (e < deg) cum[e] = c;
    carry = __shfl_sync(kFull, c, 31);
  }
  __syncwarp();
  const float total = carry;
  const float scale = fmaxf(total, 1e-9f);
  const float per_deg = __fdiv_rn(total, static_cast<float>(deg));
  for (int j = lane; j < k; j += 32) {
    const float d = __fmul_rn(v[row * k + j], scale);
    int lo = 0, hi = deg;  // upper bound: #{e < deg : cum[e] <= d}
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cum[mid] <= d) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int off = lo < deg - 1 ? lo : deg - 1;
    out[j] = ids[off];
    out_mask[j] = true;
    out_w[j] = __fdiv_rn(per_deg, fmaxf(wgt[off], 1e-9f));
  }
}

}  // namespace

extern "C" int glt_sample_one_hop_gns(
    const void* indptr, long long n_nodes, const void* indices,
    long long n_edges, const void* seeds, long long n_rows, const void* u,
    const void* v, const void* table, long long table_rows,
    long long nbytes, const void* table_row, int k, int w, float boost,
    void* nbrs, void* mask, void* weights, void* stream) {
  if (k < 1 || w < k || w > kMaxWindow || table_rows < 1 || nbytes < 1) {
    return cudaErrorInvalidValue;
  }
  if (n_rows > 0) {
    const dim3 grid(static_cast<unsigned>((n_rows + kWarps - 1) / kWarps));
    sample_gns_kernel<<<grid, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(indptr), n_nodes,
        static_cast<const int32_t*>(indices), n_edges,
        static_cast<const int32_t*>(seeds), n_rows,
        static_cast<const float*>(u), static_cast<const float*>(v),
        static_cast<const uint8_t*>(table), table_rows, nbytes,
        static_cast<const int32_t*>(table_row), k, w, boost,
        static_cast<int32_t*>(nbrs), static_cast<bool*>(mask),
        static_cast<float*>(weights));
  }
  return static_cast<int>(cudaGetLastError());
}
