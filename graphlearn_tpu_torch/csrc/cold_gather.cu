// The pinned-host cold-row gather of the tiered feature store: the Hopper
// kernel behind graphlearn_tpu_torch/ops/cold_gather.py.
//
// Replaces the JAX package's `PinnedColdBuffer.gather`
// (graphlearn_tpu/data/cold_cache.py:507, a jitted `jnp.take` over a
// `pinned_host` array) together with the miss mask and the compact-rank
// expand its caller wraps around it (graphlearn_tpu/data/feature.py,
// the mixed path).  The cold block [Nc, D] lives in page-locked host
// memory; for each miss i of a batch
//
//   out[pos[i], :] = cold[clamp(rel[i], 0, Nc - 1), :]
//
// in place on the device tensor out [B, D]; every other row of out is
// left as it is.  A pos outside [0, B) writes nothing.  The positions
// are distinct (every caller gives each output row at most once), so
// the order in which the misses are served does not change out.  The
// device reads the host rows itself through their device-visible
// address (UVA zero-copy, the technique of GLT's UnifiedTensor and
// PyTorch-Direct): no host thread touches a feature byte per batch, and
// only the miss bytes cross the link.  Ids are int32, as the JAX
// gather's.
//
// What bounds it on the H100 (80GB HBM3, 700 W; chip_smoke.py's K6
// diagnosis): the rate at which the host answers the SMs' reads, and
// that rate differs between hosts.  On some it was 46-47 GB/s for a
// training batch's 455k random 400-byte rows, 0.85 of a pinned copy of
// the same bytes; on others 20-28 GB/s for every order of the same rows,
// one stream included, while the copy engine still reached 47-55 GB/s.
// On both, 512-byte rows cost their extra bytes, a cudaHostAlloc block
// or a block advised huge pages cost the same as the registered one, and
// the rows in block order saved 1-4% on the first hosts and 10-13% on
// the second.  So the kernel puts on the link only each row's own
// 32-byte sectors, in as few requests as the row's lines allow, and the
// wrapper sorts a large batch's (pos, rel) pairs by rel first (the plan
// step, ops/cold_gather.py `cold_plan`, a library sort).
//
// Design: a row's bytes are read by one lane group in one instruction a
// pass, never split across warps or widened to whole lines (either puts
// more requests or bytes on the link than the row's sectors).  The group
// is G lanes, the smallest power of two that covers the row's vectors
// up to a warp (rows of 4 to 16 bytes take a thread, a 400-byte f32 row
// a warp), and a warp serves 32 / G rows at once, so narrow rows keep
// every lane busy and their ids arrive in one coalesced load.  A lane
// issues all its loads of a row (up to kPerLane vectors a pass, 2 KB
// rows at 16 bytes) before it stores any.  The grid is persistent, as
// many blocks as fit the card at once (the SM count times the
// occupancy), and its warps stride over the rows.  Vectors are the
// widest of 16, 8, 4, 2 or 1 bytes that the row bytes and both base
// addresses allow (16 at D = 100 f32, 8 at D = 100 bf16).
#include <cstdint>
#include <cuda_runtime.h>

#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerLane = 4;

template <typename V, int G>
__global__ void __launch_bounds__(kThreads)
cold_gather_kernel(const V* __restrict__ cold, int n_cold, int vecs,
                   const int* __restrict__ pos, const int* __restrict__ rel,
                   int m, V* __restrict__ out, int n_out) {
  constexpr int kRows = 32 / G;              // rows a warp serves at once
  constexpr int kUnroll = G == 32 ? kPerLane : 1;
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long stride =
      (static_cast<long long>(gridDim.x) * kThreads >> 5) * kRows;
  for (long long i = warp * kRows + lane / G; i < m; i += stride) {
    const int p = __ldg(pos + i);
    if (p < 0 || p >= n_out) continue;
    int r = __ldg(rel + i);
    r = r < 0 ? 0 : (r >= n_cold ? n_cold - 1 : r);
    const V* src = cold + static_cast<long long>(r) * vecs;
    V* dst = out + static_cast<long long>(p) * vecs;
    for (int base = sub; base < vecs; base += G * kUnroll) {
      V v[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int k = base + j * G;
        if (k < vecs) v[j] = src[k];
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int k = base + j * G;
        if (k < vecs) dst[k] = v[j];
      }
    }
  }
}

template <typename V, int G>
int launch_g(const void* cold, int n_cold, int vecs, const int* pos,
             const int* rel, int m, void* out, int n_out,
             cudaStream_t stream) {
  auto* kernel = cold_gather_kernel<V, G>;
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows_a_block = static_cast<long long>(kThreads / 32) *
                                 (32 / G);
  const long long need = (m + rows_a_block - 1) / rows_a_block;
  const long long fit = static_cast<long long>(glt::sm_count()) *
                        (per_sm > 0 ? per_sm : 1);
  const dim3 grid(static_cast<unsigned>(need < fit ? need : fit));
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<const V*>(cold), n_cold,
                                        vecs, pos, rel, m,
                                        static_cast<V*>(out), n_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch(const void* cold, int n_cold, long long row_bytes,
           const int* pos, const int* rel, int m, void* out, int n_out,
           cudaStream_t s) {
  const int vecs = static_cast<int>(row_bytes / sizeof(V));
  if (vecs <= 1) return launch_g<V, 1>(cold, n_cold, vecs, pos, rel, m, out, n_out, s);
  if (vecs <= 2) return launch_g<V, 2>(cold, n_cold, vecs, pos, rel, m, out, n_out, s);
  if (vecs <= 4) return launch_g<V, 4>(cold, n_cold, vecs, pos, rel, m, out, n_out, s);
  if (vecs <= 8) return launch_g<V, 8>(cold, n_cold, vecs, pos, rel, m, out, n_out, s);
  if (vecs <= 16) return launch_g<V, 16>(cold, n_cold, vecs, pos, rel, m, out, n_out, s);
  return launch_g<V, 32>(cold, n_cold, vecs, pos, rel, m, out, n_out, s);
}

bool aligned(long long row_bytes, const void* a, const void* b, int n) {
  return row_bytes % n == 0 && reinterpret_cast<uintptr_t>(a) % n == 0 &&
         reinterpret_cast<uintptr_t>(b) % n == 0;
}

}  // namespace

// Register [ptr, ptr + bytes) as page-locked and mapped for the device
// (the tiered store's cold block: an exact-size registration where a
// pin_memory() copy would round up to a power of two).
extern "C" int glt_host_register(void* ptr, long long bytes) {
  return static_cast<int>(cudaHostRegister(
      ptr, static_cast<size_t>(bytes),
      cudaHostRegisterMapped | cudaHostRegisterPortable));
}

extern "C" int glt_host_unregister(void* ptr) {
  return static_cast<int>(cudaHostUnregister(ptr));
}

// `cold_host` is the start of a page-locked allocation (cudaHostAlloc or
// a registration) and `cold_offset` the block's byte offset in it; the
// kernel reads through the allocation's device pointer.  `pos` and `rel`
// are int32 on the device; the block has fewer than 2^31 rows and out
// fewer than 2^31 rows.
extern "C" int glt_cold_gather(void* cold_host, long long cold_offset,
                               long long n_cold, long long row_bytes,
                               const void* pos, const void* rel, long long m,
                               void* out, long long n_out, void* stream) {
  if (n_cold < 1 || n_cold > INT32_MAX || row_bytes < 1 || m < 0 ||
      m > INT32_MAX || n_out < 0 || n_out > INT32_MAX) {
    return cudaErrorInvalidValue;
  }
  if (m == 0) return cudaSuccess;
  void* dev_base = nullptr;
  const cudaError_t err = cudaHostGetDevicePointer(&dev_base, cold_host, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* cold = static_cast<const char*>(dev_base) + cold_offset;
  const auto* p = static_cast<const int*>(pos);
  const auto* r = static_cast<const int*>(rel);
  const auto s = static_cast<cudaStream_t>(stream);
  const int nc = static_cast<int>(n_cold), mm = static_cast<int>(m),
            no = static_cast<int>(n_out);
  if (aligned(row_bytes, cold, out, 16)) {
    return launch<uint4>(cold, nc, row_bytes, p, r, mm, out, no, s);
  }
  if (aligned(row_bytes, cold, out, 8)) {
    return launch<uint2>(cold, nc, row_bytes, p, r, mm, out, no, s);
  }
  if (aligned(row_bytes, cold, out, 4)) {
    return launch<unsigned int>(cold, nc, row_bytes, p, r, mm, out, no, s);
  }
  if (aligned(row_bytes, cold, out, 2)) {
    return launch<unsigned short>(cold, nc, row_bytes, p, r, mm, out, no, s);
  }
  return launch<unsigned char>(cold, nc, row_bytes, p, r, mm, out, no, s);
}
