// The owner-side row push of the remote-push feature exchange: the Hopper
// kernel behind graphlearn_tpu_torch/parallel/rdma_gather.py.
//
// Replaces the Pallas kernel of graphlearn_tpu/parallel/rdma_gather.py
// (`_push_rows_kernel`, launched by `rdma_gather`), in which each device
// starts one remote DMA per (requester, slot) of its receive buffer.
// After the request all-to-all, owner o holds ids [P_r, C] (the ids each
// requester r asked of it); for every slot (r, j) it writes
//
//   dst[r][o, j, :] = shard_o[clamp(ids[o, r, j] - start_o, 0, R - 1), :]
//
// into requester r's receive buffer dst[r] ([P_o, C, D]), the layout the
// requester's stitch reads.  An invalid (-1) or foreign id pushes the
// clamped row, as the TPU kernel does; the stitch masks it, so every slot
// carries exactly one row and the kernel's whole output is defined.
//
// What bounds it on the H100: bytes.  It reads the P*P*C ids, one row
// per slot (the invalid slots all read row 0, which stays in L2) and
// writes every slot's row once: P*P*C*D*itemsize bytes out, 3.0 GB at the
// mesh batch's node tables (8 x 8 x 117,248 x 100 f32).
//
// Design: one warp per (owner, requester, slot) row, eight warps per
// block, blocks striding the P*P*C rows (row indices and byte offsets in
// int64: the buffer passes 2^31 bytes).  The grid runs in the owner's
// view: it reads owner o's ids and start, and writes through requester
// r's base pointer, taken from a small device array of P_r pointers.  On
// one card those point into one [P_r, P_o, C, D] tensor; on several cards
// the same kernel would write through peer pointers.  Lanes copy the row
// with 16-byte vectors when the row's bytes, the shard and every
// requester base allow it, else with the widest of 8, 4, 2 or 1 bytes
// that does (D = 3 f32, odd-D bf16 and the 4-byte label column take the
// narrow paths).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxBlocks = 132 * 32;

template <typename V>
__global__ void __launch_bounds__(kWarps * 32)
push_rows_kernel(const int32_t* __restrict__ ids,
                 const int64_t* __restrict__ starts,
                 const V* __restrict__ shards, int64_t n_parts, int64_t cap,
                 int64_t n_rows, int64_t vecs_per_row,
                 V* const* __restrict__ dst) {
  const int lane = threadIdx.x & 31;
  const int64_t total = n_parts * n_parts * cap;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
       row < total; row += stride) {
    const int64_t o = row / (n_parts * cap);      // owner
    const int64_t rem = row - o * n_parts * cap;
    const int64_t r = rem / cap;                  // requester
    const int64_t j = rem - r * cap;              // slot
    int64_t local = static_cast<int64_t>(ids[row]) - starts[o];
    local = local < 0 ? 0 : (local >= n_rows ? n_rows - 1 : local);
    const V* src = shards + (o * n_rows + local) * vecs_per_row;
    V* out = dst[r] + (o * cap + j) * vecs_per_row;
    for (int64_t i = lane; i < vecs_per_row; i += 32) out[i] = __ldg(src + i);
  }
}

template <typename V>
void launch(const void* ids, const void* starts, const void* shards,
            long long n_parts, long long cap, long long n_rows,
            long long row_bytes, void* const* dst, cudaStream_t stream) {
  const long long total = n_parts * n_parts * cap;
  long long blocks = (total + kWarps - 1) / kWarps;
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  push_rows_kernel<V><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                        stream>>>(
      static_cast<const int32_t*>(ids), static_cast<const int64_t*>(starts),
      static_cast<const V*>(shards), n_parts, cap, n_rows,
      row_bytes / static_cast<long long>(sizeof(V)),
      reinterpret_cast<V* const*>(dst));
}

bool fits(long long row_bytes, const void* shards, long long dst_align,
          long long n) {
  return row_bytes % n == 0 && dst_align % n == 0 &&
         reinterpret_cast<uintptr_t>(shards) % n == 0;
}

}  // namespace

// ids [P, P, C] int32 (owner-major), starts [P] int64, shards [P, R, row]
// bytes, dst a device array of P requester base pointers, each aligned to
// dst_align bytes (a power of two; the caller's promise, read to pick the
// vector width).
extern "C" int glt_push_rows(const void* ids, const void* starts,
                             const void* shards, long long n_parts,
                             long long cap, long long n_rows,
                             long long row_bytes, void* const* dst,
                             long long dst_align, void* stream) {
  if (n_parts < 1 || cap < 0 || n_rows < 1 || row_bytes < 1 ||
      dst_align < 1 || (dst_align & (dst_align - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  if (cap > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (fits(row_bytes, shards, dst_align, 16)) {
      launch<uint4>(ids, starts, shards, n_parts, cap, n_rows, row_bytes,
                    dst, s);
    } else if (fits(row_bytes, shards, dst_align, 8)) {
      launch<uint2>(ids, starts, shards, n_parts, cap, n_rows, row_bytes,
                    dst, s);
    } else if (fits(row_bytes, shards, dst_align, 4)) {
      launch<unsigned int>(ids, starts, shards, n_parts, cap, n_rows,
                           row_bytes, dst, s);
    } else if (fits(row_bytes, shards, dst_align, 2)) {
      launch<unsigned short>(ids, starts, shards, n_parts, cap, n_rows,
                             row_bytes, dst, s);
    } else {
      launch<unsigned char>(ids, starts, shards, n_parts, cap, n_rows,
                            row_bytes, dst, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
