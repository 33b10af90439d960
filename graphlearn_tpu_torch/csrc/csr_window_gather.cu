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
// clamps the starts.
//
// What bounds it on the H100: bytes.  It reads w ids per row (the
// window, one contiguous run at any offset) and the row's start, and
// writes w ids; nothing is computed.
//
// Design: one warp per row, eight warps per block, the blocks striding
// over the rows.  Lane l copies window entries l, l+32, ..., so the
// reads of a window are one coalesced run and the writes of an output
// row are too.  The TPU kernel fetched two 4 KB-aligned units per row
// into VMEM and rotated lanes to cut the window out, because a TPU DMA
// cannot start at an arbitrary element; a warp can, so there is no
// repack, no overfetch and no cap on w.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kBlocksPerSm = 8;

template <typename S>
__global__ void __launch_bounds__(kWarps * 32)
csr_window_gather_kernel(const int32_t* __restrict__ indices,
                         int64_t n_edges, const S* __restrict__ starts,
                         int64_t n_rows, int w, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t last = n_edges > 0 ? n_edges - 1 : 0;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
       row < n_rows; row += stride) {
    int64_t s = static_cast<int64_t>(starts[row]);
    s = s < 0 ? 0 : (s > last ? last : s);
    int32_t* dst = out + row * w;
    for (int j = lane; j < w; j += 32) {
      const int64_t p = s + j;
      dst[j] = n_edges > 0 ? __ldg(indices + (p < last ? p : last)) : 0;
    }
  }
}

}  // namespace

extern "C" int glt_csr_window_gather(const void* indices, long long n_edges,
                                     const void* starts, int starts_is64,
                                     long long n_rows, int w, void* out,
                                     void* stream) {
  if (w < 1 || n_edges < 0 || n_rows < 0) return cudaErrorInvalidValue;
  if (n_rows > 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long need = (n_rows + kWarps - 1) / kWarps;
    const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
    const dim3 grid(static_cast<unsigned>(need < cap ? need : cap));
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* ind = static_cast<const int32_t*>(indices);
    auto* o = static_cast<int32_t*>(out);
    if (starts_is64) {
      csr_window_gather_kernel<int64_t><<<grid, kWarps * 32, 0, s>>>(
          ind, n_edges, static_cast<const int64_t*>(starts), n_rows, w, o);
    } else {
      csr_window_gather_kernel<int32_t><<<grid, kWarps * 32, 0, s>>>(
          ind, n_edges, static_cast<const int32_t*>(starts), n_rows, w, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
