// The current device's SM count, read once per device: the launchers
// size their grids and per-warp work from it.
#pragma once
#include <cuda_runtime.h>

namespace glt {

inline int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = sms > 0 ? sms : 1;
  }
  return counts[dev];
}

}  // namespace glt
