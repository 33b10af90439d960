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
// What bounds it on the H100: bytes, in principle.  A row reads its seed
// (4 B), two indptr entries (16 B), the draws it needs (4 B per
// in-degree Gumbel, or 4 B per u) and k neighbor ids, and writes 5 B per
// slot.  At serving sizes (up to a few thousand rows per hop) that is
// well under a microsecond of HBM time, so a launch is bound by launch
// latency.
//
// The first design gave one warp to every row, eight rows a block, and
// each warp walked a chain of four dependent reads (seed -> indptr pair
// -> Gumbels or u -> the winners' ids) before it wrote; the take-all and
// hub arms kept only k of 32 lanes busy.  On the H100 (700 W) hop 3 of a
// per-batch step (153,600 rows at k 5) took 0.0786 ms against a 0.0073
// ms bound: ~18 waves of that chain, bound by latency with few loads in
// flight.
//
// Design now:
//
//  * a lane group of G = clamp(next_pow2(k), 4, 32) lanes a row, so a
//    warp carries 32 / G rows at a time (8 lanes at k 5); the launcher
//    widens G while rows x G would leave lanes of the card idle, so the
//    small serving hops and the first training hops keep a warp a row;
//  * a warp owns a tile of one or two passes of 32 / G rows and
//    preloads them in one coalesced pass: lane r loads row r's seed and
//    indptr pair, so those two latencies are paid once a tile.  Two
//    passes once the rows still fill the card (64 warps an SM) that
//    way: longer tiles (up to 32 rows, each latency paid once per 32
//    rows) measured slower on the H100 at every training hop, as the
//    warps' serial passes outweighed the latencies they saved;
//  * the window rows' deg <= w Gumbels are staged into a per-warp
//    shared-memory double buffer with cp.async (row stride w | 1, odd,
//    so the groups' rows fall in different banks): the second pass's
//    draws land while the first pass ranks;
//  * the rank-select stays within the lane group and ranks only the
//    entries that can win: T is the k-th largest of the G lane maxima
//    (each lane holds ceil(deg / G) entries), every entry below T has k
//    entries above it, so the group compacts the entries >= T (a ballot
//    a step, in window order) and ranks each of them among the others
//    by (value desc, index asc); the entry of rank r < k records its
//    window position in slot r of the tile's offset table.  A plain
//    rank of every entry against the whole row (deg^2 compares) took
//    more than half the kernel's time at k 5.  At G = 32 (a warp a row)
//    each lane still ranks its entries against the whole row: there the
//    threshold's 32 shuffles cost more than they save;
//  * then the warp walks the tile's rows * k output slots 32 at a time,
//    four batches of loads before their stores: each lane resolves its
//    slot's offset (j for take-all, trunc(u * deg) for hubs, the
//    recorded position for window rows), reads the neighbor id, and the
//    stores of ids and mask are coalesced across the tile.
//
// What bounds it now: the bytes it reads at sector granularity (a row's
// Gumbels and its winners' ids are each a few 32-byte sectors), the
// latency of the staged passes, and the shuffles of the threshold.
//
// Edge ids (the `eids` of `ops/pallas_sample.py:416-421`): a slot's CSR
// position is known where its neighbor id is read, so the edge-id arm
// is a compile-time mode of the same kernel (kEdge): 0 writes no ids,
// 1 writes the position itself, 2 reads edge_ids[position] (one 4-byte
// load a valid slot, issued beside the neighbor's) -- INVALID_ID where
// the slot is masked.  The launches without edges keep mode 0's
// registers and code.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "sm_count.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxWindow = 256;
constexpr int kBatch = 4;            // slot batches loaded before stores
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory a warp needs: two buffers of 32 / G staged rows, a
// candidate list (window positions, then values) of each row of a pass,
// then the tile's [tile, k] offset table.
__host__ __device__ inline int warp_smem_words(int rows_per_pass, int stride,
                                               int tile, int k, int w) {
  return (2 * stride + 2 * w) * rows_per_pass + tile * k;
}

// kEdge: 0 no edge ids, 1 the slot's CSR position, 2 edge_ids at it
template <int G, int kEdge>
__global__ void __launch_bounds__(kWarps * 32)
sample_one_hop_kernel(const int64_t* __restrict__ indptr, int64_t n_nodes,
                      const int32_t* __restrict__ indices, int64_t n_edges,
                      const int32_t* __restrict__ seeds, int64_t n_rows,
                      const float* __restrict__ u,
                      const float* __restrict__ gumbel, int k, int w,
                      int passes, int stride, int32_t* __restrict__ nbrs,
                      bool* __restrict__ mask,
                      const int32_t* __restrict__ edge_ids,
                      int32_t* __restrict__ eids) {
  constexpr int kRowsPerPass = 32 / G;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;
  const int lig = lane % G;
  const int tile = kRowsPerPass * passes;
  const int64_t row0 =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * tile;
  if (row0 >= n_rows) return;  // the whole warp leaves together
  const int rows = n_rows - row0 < tile ? static_cast<int>(n_rows - row0)
                                        : tile;
  float* gbuf =
      smem + warp * warp_smem_words(kRowsPerPass, stride, tile, k, w);
  int* cand = reinterpret_cast<int*>(gbuf + 2 * kRowsPerPass * stride);
  int* offs = cand + 2 * kRowsPerPass * w;

  // coalesced preload: lane r holds row r's window start and degree;
  // out-of-range ids clamp like an XLA gather (deg becomes 0)
  int64_t start = 0;
  int deg = 0;
  if (lane < rows) {
    const int32_t s = __ldg(seeds + row0 + lane);
    if (s >= 0) {
      const int64_t lo = s < n_nodes ? s : n_nodes;
      const int64_t hi = lo + 1 < n_nodes ? lo + 1 : n_nodes;
      start = __ldg(indptr + lo);
      deg = static_cast<int>(__ldg(indptr + hi) - start);
    }
  }

  // pass p: group grp ranks tile row p * kRowsPerPass + grp from buffer
  // p & 1, staged while the pass before it ranks
  auto staged = [&](int p) {
    return gbuf + ((p & 1) * kRowsPerPass + grp) * stride;
  };
  auto stage = [&](int p) {
    const int r = p * kRowsPerPass + grp;
    const int d = __shfl_sync(kFull, deg, r);
    if (r < rows && d > k && d <= w) {
      float* dst = staged(p);
      const float* src = gumbel + (row0 + r) * w;
      for (int e = lig; e < d; e += G) cp_async4(dst + e, src + e);
    }
    cp_async_commit();
  };
  stage(0);
  for (int p = 0; p < passes; ++p) {
    if (p + 1 < passes) {
      stage(p + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    // every lane takes part (shuffles and ballots); a group whose row is
    // not in the window arm ranks nothing (d = 0), a warp with no such
    // row skips the rank
    const int r = p * kRowsPerPass + grp;
    const int dr = __shfl_sync(kFull, deg, r);
    const int d = r < rows && dr > k && dr <= w ? dr : 0;
    const float* g = staged(p);
    if constexpr (G == 32) {
      // a warp a row: each lane ranks its entries against the row
      for (int e = lane; e < d; e += 32) {
        const float ge = g[e];
        int rank = 0;
        for (int f = 0; f < d; ++f) {
          const float gf = g[f];
          rank += (gf > ge) || (gf == ge && f < e);
        }
        if (rank < k) offs[r * k + rank] = e;
      }
    } else if (__any_sync(kFull, d != 0)) {
      // (1) T = the k-th largest of the group's lane maxima: every entry
      // below T has at least k entries above it, so only entries >= T
      // can win
      float m = -INFINITY;
      for (int e = lig; e < d; e += G) m = fmaxf(m, g[e]);
      int above = 0;
#pragma unroll
      for (int j = 0; j < G; ++j) above += __shfl_sync(kFull, m, j, G) > m;
      float t = above < k ? m : INFINITY;
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
        t = fminf(t, __shfl_xor_sync(kFull, t, o, G));
      }
      // (2) compact the candidates (entries >= T) in window order
      const unsigned group_mask = ((1u << G) - 1) << (grp * G);
      const unsigned lanes_below = (1u << lane) - 1;
      int* ce = cand + grp * w;
      float* cv = reinterpret_cast<float*>(cand + (kRowsPerPass + grp) * w);
      const int iters = (__reduce_max_sync(kFull, d) + G - 1) / G;
      int n_c = 0;
      for (int i = 0; i < iters; ++i) {
        const int e = lig + i * G;
        const float ge = e < d ? g[e] : 0.f;
        const bool c = e < d && ge >= t;
        const unsigned b = __ballot_sync(kFull, c) & group_mask;
        if (c) {
          const int at = n_c + __popc(b & lanes_below);
          ce[at] = e;
          cv[at] = ge;
        }
        n_c += __popc(b);
      }
      __syncwarp();
      // (3) rank each candidate among the candidates: (value desc,
      // index asc); the entry of rank q < k records its window position
      for (int a = lig; a < n_c; a += G) {
        const int e = ce[a];
        const float ge = cv[a];
        int rank = 0;
        for (int b = 0; b < n_c; ++b) {
          const float gf = cv[b];
          rank += (gf > ge) || (gf == ge && ce[b] < e);
        }
        if (rank < k) offs[r * k + rank] = e;
      }
    }
    __syncwarp();  // the buffer is staged again two passes on
  }

  // the tile's rows * k slots, 32 a step, kBatch steps of loads first
  const int64_t last = n_edges > 0 ? n_edges - 1 : 0;
  const int n_slots = rows * k;
  const float inv_k = 1.0f / static_cast<float>(k);
  const float* u_t = u + row0 * k;
  int32_t* out = nbrs + row0 * k;
  bool* out_mask = mask + row0 * k;
  for (int s0 = 0; s0 < n_slots; s0 += 32 * kBatch) {
    int32_t v[kBatch];
    int32_t ev[kBatch];
    bool on[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int s = s0 + i * 32 + lane;
      // s / k exactly: s < 1,024 (tile * k <= 512) and k <= 256 keep
      // (s + 0.5) / k at least 0.5 / k from an integer, far above the
      // f32 error
      const int r = s < n_slots
                        ? static_cast<int>((static_cast<float>(s) + 0.5f) *
                                           inv_k)
                        : 0;
      const int j = s - r * k;
      const int64_t st = __shfl_sync(kFull, start, r);
      const int d = __shfl_sync(kFull, deg, r);
      on[i] = s < n_slots && j < (d < k ? d : k);
      v[i] = -1;
      ev[i] = -1;
      if (on[i]) {
        int off = j;
        if (d > w) {
          const float prod = __fmul_rn(__ldg(u_t + s), static_cast<float>(d));
          off = static_cast<int>(prod);
          off = off < d - 1 ? off : d - 1;
        } else if (d > k) {
          off = offs[s];
        }
        int64_t pos = st + off;
        pos = pos < 0 ? 0 : (pos > last ? last : pos);
        v[i] = __ldg(indices + pos);
        if constexpr (kEdge == 1) ev[i] = static_cast<int32_t>(pos);
        if constexpr (kEdge == 2) ev[i] = __ldg(edge_ids + pos);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int s = s0 + i * 32 + lane;
      if (s < n_slots) {
        out[s] = v[i];
        out_mask[s] = on[i];
        if constexpr (kEdge != 0) eids[row0 * k + s] = ev[i];
      }
    }
  }
}

template <int G, int kEdge>
int launch(const void* indptr, long long n_nodes, const void* indices,
           long long n_edges, const void* seeds, long long n_rows,
           const void* u, const void* gumbel, int k, int w, void* nbrs,
           void* mask, const void* edge_ids, void* eids,
           cudaStream_t stream, int sms) {
  constexpr int kRowsPerPass = 32 / G;
  // two passes a warp once the card still holds 64 warps an SM that
  // way, else one: on the H100 the 153,600-row hop ran faster in two
  // passes, the 15,360-row hop and the mesh's partly empty receive
  // buffers in one, and longer tiles (up to 32 rows) slower everywhere
  const long long two_pass_rows =
      2LL * kRowsPerPass * static_cast<long long>(sms) * 64;
  const int passes = n_rows >= two_pass_rows ? 2 : 1;
  const int tile = kRowsPerPass * passes;
  const int stride = w | 1;
  const size_t smem = sizeof(float) * kWarps *
                      warp_smem_words(kRowsPerPass, stride, tile, k, w);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sample_one_hop_kernel<G, kEdge>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long rows_per_block = static_cast<long long>(kWarps) * tile;
  const dim3 grid(
      static_cast<unsigned>((n_rows + rows_per_block - 1) / rows_per_block));
  sample_one_hop_kernel<G, kEdge><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const int64_t*>(indptr), n_nodes,
      static_cast<const int32_t*>(indices), n_edges,
      static_cast<const int32_t*>(seeds), n_rows,
      static_cast<const float*>(u), static_cast<const float*>(gumbel), k, w,
      passes, stride, static_cast<int32_t*>(nbrs),
      static_cast<bool*>(mask), static_cast<const int32_t*>(edge_ids),
      static_cast<int32_t*>(eids));
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_edge(const void* indptr, long long n_nodes, const void* indices,
                long long n_edges, const void* seeds, long long n_rows,
                const void* u, const void* gumbel, int k, int w, void* nbrs,
                void* mask, const void* edge_ids, void* eids,
                cudaStream_t stream, int sms) {
  if (eids == nullptr) {
    return launch<G, 0>(indptr, n_nodes, indices, n_edges, seeds, n_rows, u,
                        gumbel, k, w, nbrs, mask, edge_ids, eids, stream,
                        sms);
  } else if (edge_ids == nullptr) {
    return launch<G, 1>(indptr, n_nodes, indices, n_edges, seeds, n_rows, u,
                        gumbel, k, w, nbrs, mask, edge_ids, eids, stream,
                        sms);
  }
  return launch<G, 2>(indptr, n_nodes, indices, n_edges, seeds, n_rows, u,
                      gumbel, k, w, nbrs, mask, edge_ids, eids, stream, sms);
}

}  // namespace

// eids null: no edge ids; edge_ids null (eids given): CSR positions
extern "C" int glt_sample_one_hop(const void* indptr, long long n_nodes,
                                  const void* indices, long long n_edges,
                                  const void* seeds, long long n_rows,
                                  const void* u, const void* gumbel, int k,
                                  int w, void* nbrs, void* mask,
                                  const void* edge_ids, void* eids,
                                  void* stream) {
  if (k < 1 || w < k || w > kMaxWindow) return cudaErrorInvalidValue;
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const int sms = glt::sm_count();
  // G = clamp(next_pow2(k), 4, 32), widened while the launch would leave
  // lanes of the card idle (serving hops, the first training hops)
  int g = 4;
  const long long lanes = static_cast<long long>(sms) * 512;
  while (g < 32 && (g < k || n_rows * g <= lanes)) g <<= 1;
  if (g == 4) {
    return launch_edge<4>(indptr, n_nodes, indices, n_edges, seeds, n_rows, u,
                          gumbel, k, w, nbrs, mask, edge_ids, eids, s, sms);
  } else if (g == 8) {
    return launch_edge<8>(indptr, n_nodes, indices, n_edges, seeds, n_rows, u,
                          gumbel, k, w, nbrs, mask, edge_ids, eids, s, sms);
  } else if (g == 16) {
    return launch_edge<16>(indptr, n_nodes, indices, n_edges, seeds, n_rows,
                           u, gumbel, k, w, nbrs, mask, edge_ids, eids, s,
                           sms);
  }
  return launch_edge<32>(indptr, n_nodes, indices, n_edges, seeds, n_rows, u,
                         gumbel, k, w, nbrs, mask, edge_ids, eids, s, sms);
}
