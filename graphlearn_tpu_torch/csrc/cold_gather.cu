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
// left as it is.  A pos outside [0, B) writes nothing.  The device reads
// the host rows itself through their device-visible address (UVA
// zero-copy, the technique of GLT's UnifiedTensor and PyTorch-Direct):
// no host thread touches a feature byte per batch, and only the miss
// bytes cross the link.
//
// What bounds it on the H100: the host link, not HBM.  Each miss row
// crosses PCIe once (M * D * itemsize bytes); a pinned host-to-device
// copy of the same bytes is the yardstick.  Zero-copy reads are
// latency-bound per request (a round trip over PCIe is on the order of
// a microsecond), so the link fills only with many rows in flight.
//
// Design (a first, simple kernel): one warp a miss row, eight warps a
// block, one block per eight rows, so a batch's misses give a grid of
// many waves and every resident warp has its row's reads in flight at
// once.  A lane issues all its loads of a row (up to kPerLane vectors,
// 2 KB rows with 16-byte vectors) before it stores any; a longer row
// takes more passes.  Vectors are the widest of 16, 8, 4, 2 or 1 bytes
// that the row bytes and both base addresses allow (16 at D = 100 f32,
// 8 at D = 100 bf16).  Positions and rows are int64.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kPerLane = 4;

template <typename V>
__global__ void __launch_bounds__(kWarps * 32)
cold_gather_kernel(const V* __restrict__ cold, int64_t n_cold, int64_t vecs,
                   const int64_t* __restrict__ pos,
                   const int64_t* __restrict__ rel, int64_t m,
                   V* __restrict__ out, int64_t n_out) {
  const int lane = threadIdx.x & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (i >= m) return;  // the whole warp leaves together
  const int64_t p = __ldg(pos + i);
  if (p < 0 || p >= n_out) return;
  int64_t r = __ldg(rel + i);
  r = r < 0 ? 0 : (r >= n_cold ? n_cold - 1 : r);
  const V* src = cold + r * vecs;
  V* dst = out + p * vecs;
  for (int64_t base = 0; base < vecs; base += 32 * kPerLane) {
    V v[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int64_t k = base + j * 32 + lane;
      if (k < vecs) v[j] = src[k];
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int64_t k = base + j * 32 + lane;
      if (k < vecs) dst[k] = v[j];
    }
  }
}

template <typename V>
void launch(const void* cold, long long n_cold, long long row_bytes,
            const int64_t* pos, const int64_t* rel, long long m, void* out,
            long long n_out, cudaStream_t stream) {
  const int64_t vecs = row_bytes / static_cast<long long>(sizeof(V));
  const dim3 grid(static_cast<unsigned>((m + kWarps - 1) / kWarps));
  cold_gather_kernel<V><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const V*>(cold), n_cold, vecs, pos, rel, m,
      static_cast<V*>(out), n_out);
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
// kernel reads through the allocation's device pointer.
extern "C" int glt_cold_gather(void* cold_host, long long cold_offset,
                               long long n_cold, long long row_bytes,
                               const void* pos, const void* rel, long long m,
                               void* out, long long n_out, void* stream) {
  if (n_cold < 1 || row_bytes < 1 || m < 0 || n_out < 0) {
    return cudaErrorInvalidValue;
  }
  if (m == 0) return cudaSuccess;
  void* dev_base = nullptr;
  const cudaError_t err = cudaHostGetDevicePointer(&dev_base, cold_host, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* cold = static_cast<const char*>(dev_base) + cold_offset;
  const auto* p = static_cast<const int64_t*>(pos);
  const auto* r = static_cast<const int64_t*>(rel);
  const auto s = static_cast<cudaStream_t>(stream);
  if (aligned(row_bytes, cold, out, 16)) {
    launch<uint4>(cold, n_cold, row_bytes, p, r, m, out, n_out, s);
  } else if (aligned(row_bytes, cold, out, 8)) {
    launch<uint2>(cold, n_cold, row_bytes, p, r, m, out, n_out, s);
  } else if (aligned(row_bytes, cold, out, 4)) {
    launch<unsigned int>(cold, n_cold, row_bytes, p, r, m, out, n_out, s);
  } else if (aligned(row_bytes, cold, out, 2)) {
    launch<unsigned short>(cold, n_cold, row_bytes, p, r, m, out, n_out, s);
  } else {
    launch<unsigned char>(cold, n_cold, row_bytes, p, r, m, out, n_out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
