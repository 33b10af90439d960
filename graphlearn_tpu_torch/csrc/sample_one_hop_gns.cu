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
// Every read position is clipped to [0, E-1] as the XLA gather does; the
// table row clamps to [0, T-1] and the byte index to nbytes-1.
// Products, sums and quotients are single IEEE round-to-nearest
// operations (__fmul_rn, __fadd_rn, __fdiv_rn; built without
// --use_fast_math).  When boost and its multiples are exact in f32
// (16, 3), every cum and total is an exact integer whatever the order of
// the scan, so the results are byte-equal to the plain and JAX versions.
//
// What bounds it on the H100: bytes, in principle.  A medium row reads
// its seed, two indptr entries, its table row index, k draws, deg window
// ids and deg bit bytes, and writes 9 bytes per slot.  The bits table row
// (ceil(N/8) bytes, 306 KB at products scale) stays in the 50 MB L2.
//
// The first design gave one warp to every row, eight rows a block.  Each
// warp walked a chain of four dependent reads (seed -> indptr pair ->
// window ids -> each id's bit byte) before it read its draws and wrote;
// the take-all and hub arms kept k of 32 lanes busy; a row wrote its 9
// bytes a slot alone, so the stores were not coalesced across rows; and
// a padding row (seed -1, half of each owner's receive buffer on the
// mesh) still cost a warp.  On the H100 (700 W) a GNS training batch's
// three hops took 0.072 ms against a 0.0064 ms bound, and a mesh-train
// step's 24 calls 0.492 ms against 0.037: bound by latency, with few
// loads in flight.
//
// Design now (K1's lane groups and tiles, csrc/sample_one_hop.cu):
//
//  * a lane group of G = clamp(next_pow2(max(k, ceil(w / 8))), 4, 32)
//    lanes a row, so a warp carries 32 / G rows at a time and a lane
//    holds at most 8 entries of a window; the launcher widens G while
//    rows x G would leave lanes of the card idle (the first hops).  On
//    the paths' windows (w = 8k for k >= 8, 64 below) this is K1's
//    clamp(next_pow2(k), 4, 32); G from k alone gave a lane up to 64
//    entries of a 256-wide window and ran much slower there;
//  * a warp owns a tile of one or two passes of 32 / G rows (two once
//    one pass would not fit the rows in one wave of the card, from the
//    occupancy the runtime reports) and preloads it in one coalesced
//    pass: lane r loads row r's seed, indptr pair and table row; a tile
//    with no neighbor in any row (padding) then only stores its masked
//    slots, and a tile with no medium row skips the scan;
//  * the tile's slots (rows * k <= 64 while G >= k) issue their loads
//    next, before any window is read: a medium slot's draw v, a
//    take-all or hub slot's neighbor id (after u for a hub), so the
//    draws no longer wait at the end of the chain;
//  * the group then reads the windows of its medium rows, both passes
//    as one run of entries (lane lig: entries lig, lig + G, ..., eight
//    ids before their eight bit bytes), and stages ids and bits in the
//    warp's shared memory; then it scans: each lane sums its contiguous
//    share of a window, a group shuffle scan of the lane totals gives
//    its carry-in, and the lane writes its share's cum;
//  * each lane resolves its slots (a binary search of the staged cum
//    for medium rows) and the stores of ids, mask and weights are
//    coalesced across the tile, as the [B, k] draws' loads are.
//
// Registers are held to 64 a thread (32 warps an SM): uncapped, the
// compiler took more and the 153,600-row hop ran slower; at 40 it
// spilled and every hop slowed.  Tried and dropped on the H100: a
// persistent warp walking tiles with the next tile's seeds and indptr
// pairs loaded a tile ahead (every hop slower: one warp's tiles ran in
// series), G from ceil(w / 16) (slower on 256-wide windows), one pass
// where two fit (slower on the 15,360-row hops), two passes only past
// two waves (no faster anywhere), 32, 40 or 48 registers at G >= 16
// and 16 window ids a lane at once (each spilled and ran slower), and a
// tile's two passes half a launch apart, which spread a buffer's valid
// rows over every warp but ran slower on the paths' hops.
//
// What bounds it now: at the 153,600-row hop the bytes at sector
// granularity, with the dirty L2 that the flushed timer leaves (PERF.md
// §7); at the first hops the latency of one chain (seed, indptr pair,
// window ids, bit bytes) and the launch.  The first design's 64 warps
// an SM (32 registers) beat this one's 32 where windows of 120-136
// entries fill a launch of about 20,000 rows, by 2-3%, and on
// half-padding buffers of about 20,000 rows at k <= 8, where two passes
// of 4 rows put the valid rows in few warps, by 6-10% (PERF.md).
//
// Edge ids (the `eids` of `ops/pallas_sample.py:416-421` with gns=True,
// and of `ops/gns.py:566-573`): a compile-time mode of the same kernel
// (kEdge), as in csrc/sample_one_hop.cu: 0 writes no ids, 1 writes the
// slot's CSR position, 2 reads edge_ids[position] -- INVALID_ID where
// the slot is masked.  The position is the one the slot's neighbor id is
// read at: start + offset clipped to [0, E-1].  A take-all or hub slot
// knows it when its loads are issued (its edge id is loaded beside its
// neighbor id); a medium slot carries its row's start until the search
// has found the offset, then loads its edge id.  The launches without
// edges keep mode 0's registers and code; modes 1 and 2 spill 28-52
// bytes a thread at the 64-register cap (ptxas).
#include <cstdint>
#include <cuda_runtime.h>

#include "sm_count.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMinBlocks = 8;        // 32 warps an SM: at most 64 registers
constexpr int kMaxWindow = 256;
constexpr int kBatch = 2;            // slot batches issued before staging
constexpr int kLoads = 8;            // window ids a lane loads at once
constexpr unsigned kFull = 0xffffffffu;

// Shared memory a warp needs, in 4-byte words: per tile row its window
// ids and cum (stride w | 1, odd, so the rows fall in different banks),
// its (max(total, 1e-9), total / deg) pair, and its bits (a byte each,
// w / 4 + 1 words).
__host__ __device__ inline int warp_smem_words(int tile, int w) {
  return tile * (2 * (w | 1) + 2 + (w >> 2) + 1);
}

__device__ __forceinline__ float weight_of(float boost, unsigned bit) {
  return __fadd_rn(1.0f, __fmul_rn(boost, static_cast<float>(bit)));
}

// One output slot of a tile in two registers: `meta` packs its tile row
// (bits 0-4), whether it is on (bit 5) and on the medium arm (bit 6),
// and a medium row's degree (bits 7-15); `raw` holds what its loads
// brought: the draw v of a medium slot, else the neighbor id.  With edge
// ids (kEdge != 0) `pos` holds the slot's clipped CSR position (a medium
// slot's row start until it is resolved) and `eid` its edge id; mode 0
// never reads them, so the compiler drops them.
struct Slot {
  int meta;
  int32_t raw;
  int64_t pos;
  int32_t eid;
};

// Issues slot s's loads (every lane calls it: it shuffles the row's
// start and degree from the preload lanes).
template <int kEdge>
__device__ __forceinline__ Slot load_slot(
    int s, int n_slots, int k, int w, float inv_k, int64_t start, int deg,
    const float* __restrict__ u_t, const float* __restrict__ v_t,
    const int32_t* __restrict__ indices, int64_t n_edges, int64_t last,
    const int32_t* __restrict__ edge_ids) {
  // s / k exactly: s < 512 (tile * k <= 64 while k <= 32, tile <= 2 rows
  // beyond) keeps (s + 0.5) / k at least 0.5 / k from an integer, far
  // above the f32 error
  const int r = s < n_slots ? static_cast<int>(
                                  (static_cast<float>(s) + 0.5f) * inv_k)
                            : 0;
  const int j = s - r * k;
  const int64_t st = __shfl_sync(kFull, start, r);
  const int d = __shfl_sync(kFull, deg, r);
  const bool on = s < n_slots && j < (d < k ? d : k);
  const bool medium = on && d > k && d <= w;
  Slot t;
  t.meta = r | (on << 5) | (medium << 6) | (medium ? d << 7 : 0);
  t.raw = -1;
  t.pos = st;
  t.eid = -1;
  if (medium) {
    t.raw = __float_as_int(__ldg(v_t + s));
  } else if (on) {
    int off = j;
    if (d > w) {
      const float prod = __fmul_rn(__ldg(u_t + s), static_cast<float>(d));
      off = static_cast<int>(prod);
      off = off < d - 1 ? off : d - 1;
    }
    if (n_edges > 0) {
      int64_t pos = st + off;
      pos = pos < 0 ? 0 : (pos > last ? last : pos);
      t.raw = __ldg(indices + pos);
      if constexpr (kEdge == 1) t.eid = static_cast<int32_t>(pos);
      if constexpr (kEdge == 2) t.eid = __ldg(edge_ids + pos);
    }
  }
  return t;
}

// Resolves a medium slot by a binary search of its row's staged cum and
// stores slot s.
template <int kEdge>
__device__ __forceinline__ void store_slot(
    Slot t, int s, int n_slots, float boost, int stride, int bstride,
    const int32_t* s_ids, const float* s_cum, const float* s_meta,
    const uint8_t* s_bit, int32_t* out, bool* out_mask, float* out_w,
    int64_t n_edges, int64_t last, const int32_t* __restrict__ edge_ids,
    int32_t* __restrict__ out_e) {
  const bool on = (t.meta >> 5) & 1;
  int32_t val = t.raw;
  int32_t eid = t.eid;
  float wt = on ? 1.0f : 0.0f;
  if ((t.meta >> 6) & 1) {
    const int r = t.meta & 31, d = t.meta >> 7;
    const float* cum = s_cum + r * stride;
    const float x = __fmul_rn(__int_as_float(t.raw), s_meta[2 * r]);
    int lo = 0, hi = d;  // upper bound: #{e < d : cum[e] <= x}
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cum[mid] <= x) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int off = lo < d - 1 ? lo : d - 1;
    val = s_ids[r * stride + off];
    wt = __fdiv_rn(s_meta[2 * r + 1],
                   fmaxf(weight_of(boost, s_bit[r * bstride + off]), 1e-9f));
    if constexpr (kEdge != 0) {
      if (n_edges > 0) {
        int64_t pos = t.pos + off;
        pos = pos < 0 ? 0 : (pos > last ? last : pos);
        eid = kEdge == 1 ? static_cast<int32_t>(pos) : __ldg(edge_ids + pos);
      }
    }
  }
  if (s < n_slots) {
    out[s] = val;
    out_mask[s] = on;
    out_w[s] = wt;
    if constexpr (kEdge != 0) out_e[s] = on ? eid : -1;
  }
}

// kEdge: 0 no edge ids, 1 the slot's CSR position, 2 edge_ids at it
template <int G, int kEdge>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
sample_gns_kernel(const int64_t* __restrict__ indptr, int64_t n_nodes,
                  const int32_t* __restrict__ indices, int64_t n_edges,
                  const int32_t* __restrict__ seeds, int64_t n_rows,
                  const float* __restrict__ u, const float* __restrict__ v,
                  const uint8_t* __restrict__ table, int64_t table_rows,
                  int64_t nbytes, const int32_t* __restrict__ table_row,
                  int k, int w, float boost, int passes,
                  int32_t* __restrict__ nbrs, bool* __restrict__ mask,
                  float* __restrict__ weights,
                  const int32_t* __restrict__ edge_ids,
                  int32_t* __restrict__ eids) {
  constexpr int kRowsPerPass = 32 / G;
  extern __shared__ int smem[];
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
  const int stride = w | 1;
  const int bstride = ((w >> 2) + 1) * 4;
  int* base = smem + warp * warp_smem_words(tile, w);
  int32_t* s_ids = base;
  float* s_cum = reinterpret_cast<float*>(base + tile * stride);
  float* s_meta = reinterpret_cast<float*>(base + 2 * tile * stride);
  uint8_t* s_bit =
      reinterpret_cast<uint8_t*>(base + 2 * tile * stride + 2 * tile);
  const int64_t last = n_edges > 0 ? n_edges - 1 : 0;
  const float inv_k = 1.0f / static_cast<float>(k);

  // coalesced preload: lane r holds row r's window start, degree and
  // clamped table row; out-of-range ids clamp like an XLA gather (deg
  // becomes 0)
  int64_t start = 0;
  int deg = 0;
  int64_t trow = 0;
  if (lane < rows) {
    const int32_t sd = __ldg(seeds + row0 + lane);
    const int64_t tr = __ldg(table_row + row0 + lane);
    if (sd >= 0) {
      const int64_t lo = sd < n_nodes ? sd : n_nodes;
      const int64_t hi = lo + 1 < n_nodes ? lo + 1 : n_nodes;
      start = __ldg(indptr + lo);
      deg = static_cast<int>(__ldg(indptr + hi) - start);
    }
    trow = tr < 0 ? 0 : (tr >= table_rows ? table_rows - 1 : tr);
  }
  const int n_slots = rows * k;
  int32_t* out = nbrs + row0 * k;
  bool* out_mask = mask + row0 * k;
  float* out_w = weights + row0 * k;
  int32_t* out_e = kEdge != 0 ? eids + row0 * k : nullptr;
  if (!__any_sync(kFull, deg > 0)) {
    // a tile of padding (or of empty rows): every slot masked
    for (int s = lane; s < n_slots; s += 32) {
      out[s] = -1;
      out_mask[s] = false;
      out_w[s] = 0.0f;
      if constexpr (kEdge != 0) out_e[s] = -1;
    }
    return;
  }

  // the tile's first 32 * kBatch slots (all of them while G >= k):
  // each lane issues its slots' loads now, so they land while the
  // windows are staged
  const float* u_t = u + row0 * k;
  const float* v_t = v + row0 * k;
  Slot slot[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    slot[b] = load_slot<kEdge>(b * 32 + lane, n_slots, k, w, inv_k, start,
                               deg, u_t, v_t, indices, n_edges, last,
                               edge_ids);
  }

  // stage: group grp reads the windows of its medium tile rows (row
  // grp of pass 0, row kRowsPerPass + grp of pass 1) as one run of
  // entries, kLoads window ids a lane, then their bit bytes
  const int r0 = grp, r1 = kRowsPerPass + grp;
  const int dr0 = __shfl_sync(kFull, deg, r0);
  const int dr1 = __shfl_sync(kFull, deg, r1 & 31);
  const int64_t st0 = __shfl_sync(kFull, start, r0);
  const int64_t st1 = __shfl_sync(kFull, start, r1 & 31);
  const int64_t tr0 = __shfl_sync(kFull, trow, r0);
  const int64_t tr1 = __shfl_sync(kFull, trow, r1 & 31);
  const int d0 = r0 < rows && dr0 > k && dr0 <= w ? dr0 : 0;
  const int d1 =
      passes > 1 && r1 < rows && dr1 > k && dr1 <= w ? dr1 : 0;
  const uint8_t* bits0 = table + tr0 * nbytes;
  const uint8_t* bits1 = table + tr1 * nbytes;
  const int n_entries = d0 + d1;
  for (int f0 = lig; f0 < n_entries; f0 += G * kLoads) {
    int32_t id[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int f = f0 + i * G;
      id[i] = -1;
      if (f < n_entries && n_edges > 0) {
        int64_t pos = f < d0 ? st0 + f : st1 + (f - d0);
        pos = pos < 0 ? 0 : (pos > last ? last : pos);
        id[i] = __ldg(indices + pos);
      }
    }
    unsigned by[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int f = f0 + i * G;
      by[i] = 0;
      if (f < n_entries && id[i] >= 0) {
        const int64_t byte = (id[i] >> 3) < nbytes ? (id[i] >> 3)
                                                   : nbytes - 1;
        by[i] = __ldg((f < d0 ? bits0 : bits1) + byte);
      }
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int f = f0 + i * G;
      if (f < n_entries) {
        const int at = f < d0 ? r0 * stride + f : r1 * stride + (f - d0);
        const int bat =
            f < d0 ? r0 * bstride + f : r1 * bstride + (f - d0);
        s_ids[at] = id[i];
        s_bit[bat] = static_cast<uint8_t>((by[i] >> (id[i] & 7)) & 1u);
      }
    }
  }
  __syncwarp();

  // scan: lane lig sums its contiguous share [lig * c, lig * c + c) of
  // the window, a group shuffle scan gives its carry-in, then it writes
  // its share's cum; every lane takes part in the shuffles (a tile with
  // no medium row scans nothing)
  const int scan_passes = __any_sync(kFull, n_entries > 0) ? passes : 0;
  for (int p = 0; p < scan_passes; ++p) {
    const int r = p ? r1 : r0;
    const int d = p ? d1 : d0;
    const uint8_t* bt = s_bit + r * bstride;
    const int c = (d + G - 1) / G;
    const int e_lo = lig * c < d ? lig * c : d;
    const int e_hi = e_lo + c < d ? e_lo + c : d;
    float sum = 0.0f;
    for (int e = e_lo; e < e_hi; ++e) {
      sum = __fadd_rn(sum, weight_of(boost, bt[e]));
    }
    float incl = sum;
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, o, G);
      if (lig >= o) incl = __fadd_rn(incl, y);
    }
    float run = __shfl_up_sync(kFull, incl, 1, G);
    if (lig == 0) run = 0.0f;
    const float total = __shfl_sync(kFull, incl, G - 1, G);
    float* cum = s_cum + r * stride;
    for (int e = e_lo; e < e_hi; ++e) {
      run = __fadd_rn(run, weight_of(boost, bt[e]));
      cum[e] = run;
    }
    if (lig == 0 && d > 0) {
      s_meta[2 * r] = fmaxf(total, 1e-9f);
      s_meta[2 * r + 1] = __fdiv_rn(total, static_cast<float>(d));
    }
  }
  __syncwarp();

  // resolve and store: ids, mask and weights coalesced across the
  // tile; the slots past 32 * kBatch (k > 32 only) load and store in
  // turn
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    store_slot<kEdge>(slot[b], b * 32 + lane, n_slots, boost, stride,
                      bstride, s_ids, s_cum, s_meta, s_bit, out, out_mask,
                      out_w, n_edges, last, edge_ids, out_e);
  }
  for (int s0 = 32 * kBatch; s0 < n_slots; s0 += 32) {
    const Slot x = load_slot<kEdge>(s0 + lane, n_slots, k, w, inv_k, start,
                                    deg, u_t, v_t, indices, n_edges, last,
                                    edge_ids);
    store_slot<kEdge>(x, s0 + lane, n_slots, boost, stride, bstride, s_ids,
                      s_cum, s_meta, s_bit, out, out_mask, out_w, n_edges,
                      last, edge_ids, out_e);
  }
}

template <int G, int kEdge>
int launch(const void* indptr, long long n_nodes, const void* indices,
           long long n_edges, const void* seeds, long long n_rows,
           const void* u, const void* v, const void* table,
           long long table_rows, long long nbytes, const void* table_row,
           int k, int w, float boost, void* nbrs, void* mask, void* weights,
           const void* edge_ids, void* eids, cudaStream_t stream, int sms) {
  constexpr int kRowsPerPass = 32 / G;
  // two passes a warp once one pass would not fit the rows in one wave
  // of the card (the blocks an SM holds, read once per window)
  static int blocks_at[kMaxWindow + 1] = {};
  const auto smem_of = [&](int passes) {
    return sizeof(int) * kWarps *
           static_cast<size_t>(warp_smem_words(kRowsPerPass * passes, w));
  };
  if (blocks_at[w] == 0) {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, sample_gns_kernel<G, kEdge>, kWarps * 32, smem_of(1));
    blocks_at[w] = b > 0 ? b : 1;
  }
  const long long one_wave =
      static_cast<long long>(sms) * blocks_at[w] * kWarps * kRowsPerPass;
  const int passes = n_rows > one_wave ? 2 : 1;
  const int tile = kRowsPerPass * passes;
  // G >= w / 8 keeps a tile's staged entries at 512 or fewer: at most
  // ~19 KB a block, under the 48 KB a launch gets without an attribute
  const size_t smem = smem_of(passes);
  const long long rows_per_block = static_cast<long long>(kWarps) * tile;
  const dim3 grid(
      static_cast<unsigned>((n_rows + rows_per_block - 1) / rows_per_block));
  sample_gns_kernel<G, kEdge><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const int64_t*>(indptr), n_nodes,
      static_cast<const int32_t*>(indices), n_edges,
      static_cast<const int32_t*>(seeds), n_rows,
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const uint8_t*>(table), table_rows, nbytes,
      static_cast<const int32_t*>(table_row), k, w, boost, passes,
      static_cast<int32_t*>(nbrs), static_cast<bool*>(mask),
      static_cast<float*>(weights), static_cast<const int32_t*>(edge_ids),
      static_cast<int32_t*>(eids));
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_edge(const void* indptr, long long n_nodes, const void* indices,
                long long n_edges, const void* seeds, long long n_rows,
                const void* u, const void* v, const void* table,
                long long table_rows, long long nbytes, const void* table_row,
                int k, int w, float boost, void* nbrs, void* mask,
                void* weights, const void* edge_ids, void* eids,
                cudaStream_t stream, int sms) {
  if (eids == nullptr) {
    return launch<G, 0>(indptr, n_nodes, indices, n_edges, seeds, n_rows, u,
                        v, table, table_rows, nbytes, table_row, k, w, boost,
                        nbrs, mask, weights, edge_ids, eids, stream, sms);
  } else if (edge_ids == nullptr) {
    return launch<G, 1>(indptr, n_nodes, indices, n_edges, seeds, n_rows, u,
                        v, table, table_rows, nbytes, table_row, k, w, boost,
                        nbrs, mask, weights, edge_ids, eids, stream, sms);
  }
  return launch<G, 2>(indptr, n_nodes, indices, n_edges, seeds, n_rows, u, v,
                      table, table_rows, nbytes, table_row, k, w, boost, nbrs,
                      mask, weights, edge_ids, eids, stream, sms);
}

}  // namespace

// eids null: no edge ids; edge_ids null (eids given): CSR positions
extern "C" int glt_sample_one_hop_gns(
    const void* indptr, long long n_nodes, const void* indices,
    long long n_edges, const void* seeds, long long n_rows, const void* u,
    const void* v, const void* table, long long table_rows,
    long long nbytes, const void* table_row, int k, int w, float boost,
    void* nbrs, void* mask, void* weights, const void* edge_ids, void* eids,
    void* stream) {
  if (k < 1 || w < k || w > kMaxWindow || table_rows < 1 || nbytes < 1) {
    return cudaErrorInvalidValue;
  }
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const int sms = glt::sm_count();
  // G = clamp(next_pow2(max(k, ceil(w / 8))), 4, 32): at most 8 window
  // entries a lane; widened while the launch would leave lanes of the
  // card idle (the first hops, small mesh buffers)
  int g = 4;
  const long long lanes = static_cast<long long>(sms) * 512;
  while (g < 32 && (g < k || 8 * g < w || n_rows * g <= lanes)) g <<= 1;
  if (g == 4) {
    return launch_edge<4>(indptr, n_nodes, indices, n_edges, seeds, n_rows, u,
                          v, table, table_rows, nbytes, table_row, k, w,
                          boost, nbrs, mask, weights, edge_ids, eids, s, sms);
  } else if (g == 8) {
    return launch_edge<8>(indptr, n_nodes, indices, n_edges, seeds, n_rows, u,
                          v, table, table_rows, nbytes, table_row, k, w,
                          boost, nbrs, mask, weights, edge_ids, eids, s, sms);
  } else if (g == 16) {
    return launch_edge<16>(indptr, n_nodes, indices, n_edges, seeds, n_rows,
                           u, v, table, table_rows, nbytes, table_row, k, w,
                           boost, nbrs, mask, weights, edge_ids, eids, s,
                           sms);
  }
  return launch_edge<32>(indptr, n_nodes, indices, n_edges, seeds, n_rows, u,
                         v, table, table_rows, nbytes, table_row, k, w, boost,
                         nbrs, mask, weights, edge_ids, eids, s, sms);
}
