// CSR neighbor-window gather: the Hopper kernel behind
// graphlearn_tpu_torch/ops/window_gather.py.
//
// Replaces the Pallas aligned-overfetch DMA kernel of
// graphlearn_tpu/ops/pallas_window.py (`_window_dma`, reached through
// `csr_window_gather`).  For each row i and j < w:
//
//   s = clamp(starts[i], 0, max(E-1, 0))
//   out[i, j] = E == 0 ? 0 : indices[min(s + j, E-1)]
//
// byte-equal to the Pallas path, whose repacked table pads past the
// array with indices[E-1] (`prepare_window_table`) and whose caller
// clamps the starts.  The TPU kernel fetched two 4 KB-aligned units per
// row into VMEM and rotated lanes to cut the window out, because a TPU
// DMA cannot start at an arbitrary element; a warp can, so there is no
// repack, no overfetch and no cap on w.
//
// What bounds it on the H100: bytes, in principle.  It reads w ids per
// row (the window, one contiguous run at any 4-byte offset) and the
// row's start, and writes w ids; nothing is computed.
//
// The first design gave one warp to every row, eight warps a block, the
// grid capped at SMs x 8 blocks with the warps striding over the rows,
// and each lane loaded and stored its window entries in turn.  At the
// path's 8,192 starts x 128 that is a single wave in which every warp
// loads its start, then issues 4 loads of 4 B a lane interleaved with
// their stores.  On the H100 (700 W) it took 5.48-5.60 us a call back
// to back against a 2.524 us bound (8.45 MB).
//
// Design now: one warp a row, the grid one warp for every row (no cap,
// no stride), and each lane issues the loads of all the 32-id steps of
// the window it holds, up to 8 (256 ids a row), before any of their
// stores.  The steps are a template argument picked from w: 4 up to 128
// ids (the path's width), 8 beyond; a window of at most 32 ids takes
// one load a lane.  Tried on the H100: predicated-off steps slowed
// narrow windows, and a step left to a second round added a DRAM
// latency to wide ones; a steps count read at run time in the kernel
// ran slower at every width.  Tried and taken
// out: several rows a warp, and 16-byte loads of each window's aligned
// superset realigned by shuffles.  They won only past one wave of rows
// (more than 8,448) or at 192 ids a row and more, and the one caller
// sends 8,192 x 128.
//
// What bounds it now: latency.  A 1-wide call of 8,192 rows costs 0.7
// of the 128-wide one back to back (PERF.md): the launch and
// the two dependent DRAM latencies of a row (its start, then its
// window), which the 2.524 us bound leaves out, set the time; the bytes
// are the rest.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps a block

// kSteps: the 32-id steps of a window a lane loads before it stores
template <typename S, int kSteps>
__global__ void __launch_bounds__(kWarps * 32)
csr_window_gather_kernel(const int32_t* __restrict__ indices,
                         int64_t n_edges, const S* __restrict__ starts,
                         int64_t n_rows, int w, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int64_t last = n_edges > 0 ? n_edges - 1 : 0;
  int64_t s = static_cast<int64_t>(starts[row]);
  s = s < 0 ? 0 : (s > last ? last : s);
  int32_t* dst = out + row * w;
  if (w <= 32) {  // one load a lane
    if (lane < w) {
      const int64_t p = s + lane;
      dst[lane] = n_edges > 0 ? __ldg(indices + (p < last ? p : last)) : 0;
    }
    return;
  }
  for (int j0 = lane; j0 < w; j0 += 32 * kSteps) {
    int32_t x[kSteps];
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {  // every load of the steps first
      const int j = j0 + 32 * t;
      const int64_t p = s + j;
      x[t] = j < w && n_edges > 0 ? __ldg(indices + (p < last ? p : last))
                                  : 0;
    }
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      const int j = j0 + 32 * t;
      if (j < w) dst[j] = x[t];
    }
  }
}

template <typename S, int kSteps>
int launch_steps(const int32_t* indices, long long n_edges, const S* starts,
                 long long n_rows, int w, int32_t* out, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n_rows + kWarps - 1) / kWarps));
  csr_window_gather_kernel<S, kSteps><<<grid, kWarps * 32, 0, stream>>>(
      indices, n_edges, starts, n_rows, w, out);
  return static_cast<int>(cudaGetLastError());
}

// Steps a lane loads at once: 4 up to 128 ids a row, 8 beyond.
template <typename S>
int launch(const int32_t* indices, long long n_edges, const S* starts,
           long long n_rows, int w, int32_t* out, cudaStream_t stream) {
  if (w <= 128) {
    return launch_steps<S, 4>(indices, n_edges, starts, n_rows, w, out,
                              stream);
  }
  return launch_steps<S, 8>(indices, n_edges, starts, n_rows, w, out,
                            stream);
}

}  // namespace

extern "C" int glt_csr_window_gather(const void* indices, long long n_edges,
                                     const void* starts, int starts_is64,
                                     long long n_rows, int w, void* out,
                                     void* stream) {
  if (w < 1 || n_edges < 0 || n_rows < 0) return cudaErrorInvalidValue;
  if (n_rows == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ind = static_cast<const int32_t*>(indices);
  auto* o = static_cast<int32_t*>(out);
  if (starts_is64) {
    return launch(ind, n_edges, static_cast<const int64_t*>(starts), n_rows,
                  w, o, s);
  }
  return launch(ind, n_edges, static_cast<const int32_t*>(starts), n_rows, w,
                o, s);
}
