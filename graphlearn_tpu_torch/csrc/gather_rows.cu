// Feature row gather fused with the id remap and the invalid-row mask:
// the Hopper kernel behind graphlearn_tpu_torch/ops/gather_rows.py.
//
// Replaces the Pallas per-row DMA gather of
// graphlearn_tpu/ops/pallas_gather.py (`_gather_rows_dma`, reached
// through `gather_rows`) together with the XLA ops its caller
// `data/feature.py::_device_gather` wraps around it.  For each id b:
//
//   valid = ids[b] >= 0;  idx = valid ? ids[b] : 0
//   if id2index:  idx = id2index[min(idx, M-1)];  valid &= idx >= 0
//   out[b] = valid ? table[clamp(idx, 0, N-1)] : 0
//
// byte-equal to `_device_gather` (the Pallas kernel clamps its row ids
// the same way).
//
// What bounds it on the H100: bytes.  It reads each valid row once and
// writes every output row once, B * D * itemsize each way, plus the
// ids.  The rows are scattered over the table, so the reads are whole
// rows at random addresses.
//
// The first design gave one warp to every output row, eight rows a
// block.  On the H100 (700 W) that was latency-bound at both ends of
// the width range: a 4-byte label row used one lane of 32, so a block
// moved 32 bytes and every warp paid the id load's latency and then
// the row load's (0.134 ms for 14,656 GNS labels where `index_select`
// takes 0.019 ms; 1.12-1.15 ms for a mesh batch's 7.5 M labels, 0.03
// of the bound); and a 400-byte f32 row kept one random 400-byte read
// in flight a warp, 0.62-0.65 of the bound.
//
// Design now, by the row's vector count (the vector is the widest of
// 16, 8, 4 or 2 bytes that the row bytes and both base pointers allow):
//
//  * narrow rows (at most 16 vectors) get a lane group of G lanes, the
//    smallest power of two that covers the row's vectors, and a warp
//    serves 32 / G rows.  Rows of at most 16 bytes take one thread a
//    row: a warp gathers 32 rows and its id loads are one coalesced
//    128-byte read.  The launcher picks G from the row bytes.
//  * wide rows (more than 16 vectors: 400 B f32 and 200 B bf16 at
//    D = 100) take R = 8 rows a warp (2 or 1 on gathers too small to
//    fill the card that way).  Lane r < R resolves row r's id (one
//    coalesced load, then the remap), the warp shares the rows by
//    shuffles, and every lane issues its vector of all of them before
//    it stores any, so each warp has R random row reads in flight
//    instead of one.  Of 2, 4, 8 and 16 rows a warp, 8 and 16 were the
//    fastest for bf16 rows on the H100; f32 rows did not tell them
//    apart.  A TMA or cp.async staging through shared memory was not
//    tried: the rows go straight from registers to their output.
//
// What bounds it now: the random row reads' DRAM efficiency on wide
// rows, the sector size (32 B) on narrow ones.  Row offsets are int64:
// the mesh shards pass 2^31 bytes.
#include <cstdint>
#include <cuda_runtime.h>

#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWideRows = 8;        // most rows a warp has in flight (wide)
constexpr int kMaxNarrowVecs = 16;  // widest lane group's vectors
constexpr unsigned kFull = 0xffffffffu;

// The row index of id b and whether the row is valid (JAX's clamp).
template <typename I>
__device__ __forceinline__ bool resolve(const I* __restrict__ ids, int64_t b,
                                        const int32_t* __restrict__ id2index,
                                        int64_t n_map, int64_t n_rows,
                                        int64_t* idx_out) {
  const int64_t id = static_cast<int64_t>(__ldg(ids + b));
  bool valid = id >= 0;
  int64_t idx = valid ? id : 0;
  if (id2index != nullptr) {
    const int64_t mapped = __ldg(id2index + (idx < n_map ? idx : n_map - 1));
    valid = valid && mapped >= 0;
    idx = valid ? mapped : 0;
  }
  *idx_out = idx < n_rows ? idx : n_rows - 1;
  return valid;
}

// G lanes a row; G == 1 copies the row's (at most 8) vectors alone.
template <typename V, typename I, int G>
__global__ void __launch_bounds__(kThreads)
gather_narrow(const V* __restrict__ table, int64_t n_rows, int vecs,
              const I* __restrict__ ids, int64_t n_ids,
              const int32_t* __restrict__ id2index, int64_t n_map,
              V* __restrict__ out) {
  constexpr int kRowsPerBlock = kThreads / G;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                    threadIdx.x / G;
  if (b >= n_ids) return;
  int64_t idx;
  const bool valid = resolve(ids, b, id2index, n_map, n_rows, &idx);
  const V* src = table + idx * vecs;
  V* dst = out + b * vecs;
  if constexpr (G == 1) {
    constexpr int kMax = 16 / sizeof(V);
    V v[kMax];
#pragma unroll
    for (int i = 0; i < kMax; ++i) {
      if (i < vecs) v[i] = valid ? __ldg(src + i) : V{};
    }
#pragma unroll
    for (int i = 0; i < kMax; ++i) {
      if (i < vecs) dst[i] = v[i];
    }
  } else {
    const int i = threadIdx.x % G;
    if (i < vecs) dst[i] = valid ? __ldg(src + i) : V{};
  }
}

// R rows a warp, every row's load issued before any store.
template <typename V, typename I, int R>
__global__ void __launch_bounds__(kThreads)
gather_wide(const V* __restrict__ table, int64_t n_rows, int64_t vecs,
            const I* __restrict__ ids, int64_t n_ids,
            const int32_t* __restrict__ id2index, int64_t n_map,
            V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t b0 = (static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      (threadIdx.x >> 5)) * R;
  if (b0 >= n_ids) return;  // the whole warp leaves together
  int64_t my_idx = 0;
  int my_valid = 0;
  if (lane < R && b0 + lane < n_ids) {
    my_valid = resolve(ids, b0 + lane, id2index, n_map, n_rows, &my_idx);
  }
  const V* src[R];
  bool valid[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t idx = __shfl_sync(kFull, my_idx, r);
    valid[r] = __shfl_sync(kFull, my_valid, r) != 0;
    src[r] = table + idx * vecs;
  }
  V* dst = out + b0 * vecs;
  const int64_t rows = n_ids - b0 < R ? n_ids - b0 : R;
  for (int64_t base = 0; base < vecs; base += 32) {
    const int64_t i = base + lane;
    V v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = (valid[r] && i < vecs) ? __ldg(src[r] + i) : V{};
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows && i < vecs) dst[r * vecs + i] = v[r];
    }
  }
}

template <typename V, typename I>
void launch_ids(const void* table, long long n_rows, long long row_bytes,
                const void* ids, long long n_ids, const void* id2index,
                long long n_map, void* out, cudaStream_t stream) {
  const auto* t = static_cast<const V*>(table);
  const auto* d = static_cast<const I*>(ids);
  const auto* m = static_cast<const int32_t*>(id2index);
  auto* o = static_cast<V*>(out);
  const int64_t vecs = row_bytes / static_cast<long long>(sizeof(V));
  auto grid = [n_ids](int64_t rows_per_block) {
    return dim3(static_cast<unsigned>((n_ids + rows_per_block - 1) /
                                      rows_per_block));
  };
  const int nv = static_cast<int>(vecs);
  // wide rows: kWideRows a warp once the warps would still fill the card
  // (8 an SM), fewer on small gathers so that their rows spread
  const long long rows_per_warp = n_ids / (8LL * glt::sm_count());
  if (row_bytes <= 16) {
    gather_narrow<V, I, 1><<<grid(kThreads), kThreads, 0, stream>>>(
        t, n_rows, nv, d, n_ids, m, n_map, o);
  } else if (vecs <= 2) {
    gather_narrow<V, I, 2><<<grid(kThreads / 2), kThreads, 0, stream>>>(
        t, n_rows, nv, d, n_ids, m, n_map, o);
  } else if (vecs <= 4) {
    gather_narrow<V, I, 4><<<grid(kThreads / 4), kThreads, 0, stream>>>(
        t, n_rows, nv, d, n_ids, m, n_map, o);
  } else if (vecs <= 8) {
    gather_narrow<V, I, 8><<<grid(kThreads / 8), kThreads, 0, stream>>>(
        t, n_rows, nv, d, n_ids, m, n_map, o);
  } else if (vecs <= kMaxNarrowVecs) {
    gather_narrow<V, I, 16><<<grid(kThreads / 16), kThreads, 0, stream>>>(
        t, n_rows, nv, d, n_ids, m, n_map, o);
  } else if (rows_per_warp >= kWideRows) {
    gather_wide<V, I, kWideRows><<<grid(kThreads / 32 * kWideRows), kThreads,
                                   0, stream>>>(t, n_rows, vecs, d, n_ids, m,
                                                n_map, o);
  } else if (rows_per_warp >= 2) {
    gather_wide<V, I, 2><<<grid(kThreads / 32 * 2), kThreads, 0, stream>>>(
        t, n_rows, vecs, d, n_ids, m, n_map, o);
  } else {
    gather_wide<V, I, 1><<<grid(kThreads / 32), kThreads, 0, stream>>>(
        t, n_rows, vecs, d, n_ids, m, n_map, o);
  }
}

template <typename V>
void launch(const void* table, long long n_rows, long long row_bytes,
            const void* ids, int ids_is64, long long n_ids,
            const void* id2index, long long n_map, void* out,
            cudaStream_t stream) {
  if (ids_is64) {
    launch_ids<V, int64_t>(table, n_rows, row_bytes, ids, n_ids, id2index,
                           n_map, out, stream);
  } else {
    launch_ids<V, int32_t>(table, n_rows, row_bytes, ids, n_ids, id2index,
                           n_map, out, stream);
  }
}

bool aligned(long long row_bytes, const void* a, const void* b, int n) {
  return row_bytes % n == 0 && reinterpret_cast<uintptr_t>(a) % n == 0 &&
         reinterpret_cast<uintptr_t>(b) % n == 0;
}

}  // namespace

extern "C" int glt_gather_rows(const void* table, long long n_rows,
                               long long row_bytes, const void* ids,
                               int ids_is64, long long n_ids,
                               const void* id2index, long long n_map,
                               void* out, void* stream) {
  if (n_rows < 1 || row_bytes < 2 || row_bytes % 2 != 0 ||
      (id2index != nullptr && n_map < 1)) {
    return cudaErrorInvalidValue;
  }
  if (n_ids > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (aligned(row_bytes, table, out, 16)) {
      launch<uint4>(table, n_rows, row_bytes, ids, ids_is64, n_ids, id2index,
                    n_map, out, s);
    } else if (aligned(row_bytes, table, out, 8)) {
      launch<uint2>(table, n_rows, row_bytes, ids, ids_is64, n_ids, id2index,
                    n_map, out, s);
    } else if (aligned(row_bytes, table, out, 4)) {
      launch<unsigned int>(table, n_rows, row_bytes, ids, ids_is64, n_ids,
                           id2index, n_map, out, s);
    } else {
      launch<unsigned short>(table, n_rows, row_bytes, ids, ids_is64, n_ids,
                             id2index, n_map, out, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
