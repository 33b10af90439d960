// Shared helpers for the graphlearn_tpu_torch native host runtime.
//
// Host counterpart of the reference's `include/common.h`: the device
// plane is the port's CUDA kernels (none here); this library provides the
// *host* runtime — cross-process queues, serialization, and CPU twins
// of the sampling ops for producer processes (reference:
// `csrc/cpu/*.cc`).  All external entry points are `extern "C"` for
// ctypes binding (no pybind11 in this build).
#pragma once

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace glt {

// Sentinel for padded/invalid ids — must match
// graphlearn_tpu_torch/utils/padding.py INVALID_ID.
constexpr int64_t kInvalidId = -1;

// SplitMix64 — counter-based, statistically solid, fast.  Used to
// derive per-row streams so sampling is order-independent and
// reproducible, mirroring the counter-based (threefry/Philox) stance
// of the device ops.
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(splitmix64(seed)) {}
  inline uint64_t next() {
    state = state * 6364136223846793005ull + 1442695040888963407ull;
    uint64_t x = state;
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdull;
    x ^= x >> 33;
    return x;
  }
  // Unbiased-enough bounded draw (Lemire).
  inline uint64_t bounded(uint64_t n) {
    if (n == 0) return 0;
    __uint128_t m = (__uint128_t)next() * n;
    return (uint64_t)(m >> 64);
  }
};

}  // namespace glt
