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
// Design: one warp per output row, eight rows per block.  The warp
// copies its row with 16-byte vector loads and stores when the row's
// bytes and both base pointers are 16-byte aligned (D = 100 f32 is 400
// B = 25 vectors), else with the widest of 8, 4 or 2 bytes that fits;
// reads go through the read-only data cache.  The TPU kernel's limits
// (SMEM id budget, D % 128, 32-bit rows only) do not exist here.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

template <typename V, typename I>
__global__ void __launch_bounds__(kWarps * 32)
gather_rows_kernel(const V* __restrict__ table, int64_t n_rows,
                   int64_t vecs_per_row, const I* __restrict__ ids,
                   int64_t n_ids, const int32_t* __restrict__ id2index,
                   int64_t n_map, V* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= n_ids) return;
  const int64_t id = static_cast<int64_t>(ids[b]);
  bool valid = id >= 0;
  int64_t idx = valid ? id : 0;
  if (id2index != nullptr) {
    const int64_t mapped = id2index[idx < n_map ? idx : n_map - 1];
    valid = valid && mapped >= 0;
    idx = valid ? mapped : 0;
  }
  idx = idx < n_rows ? idx : n_rows - 1;
  V* dst = out + b * vecs_per_row;
  if (valid) {
    const V* src = table + idx * vecs_per_row;
    for (int64_t i = lane; i < vecs_per_row; i += 32) dst[i] = __ldg(src + i);
  } else {
    const V zero{};
    for (int64_t i = lane; i < vecs_per_row; i += 32) dst[i] = zero;
  }
}

template <typename V>
void launch(const void* table, long long n_rows, long long row_bytes,
            const void* ids, int ids_is64, long long n_ids,
            const void* id2index, long long n_map, void* out,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n_ids + kWarps - 1) / kWarps));
  const int64_t vecs = row_bytes / static_cast<long long>(sizeof(V));
  const auto* map = static_cast<const int32_t*>(id2index);
  if (ids_is64) {
    gather_rows_kernel<V, int64_t><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const V*>(table), n_rows, vecs,
        static_cast<const int64_t*>(ids), n_ids, map, n_map,
        static_cast<V*>(out));
  } else {
    gather_rows_kernel<V, int32_t><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const V*>(table), n_rows, vecs,
        static_cast<const int32_t*>(ids), n_ids, map, n_map,
        static_cast<V*>(out));
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
