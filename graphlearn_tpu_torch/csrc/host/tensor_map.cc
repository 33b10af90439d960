// Flat binary serialization of a sample message: Dict[str, ndarray].
//
// Counterpart of the reference's TensorMapSerializer
// (`csrc/tensor_map.cc:28-85`, `include/tensor_map.h:21-28`), host-only
// (device arrays are materialized to host by the producer before
// enqueue; batches cross the process boundary as host numpy
// buffers and are copied to the card by the
// consumer).
//
// Layout (little-endian, 8-byte aligned data):
//   u64 magic | u32 n_entries | per entry:
//     u16 key_len | key bytes | u8 dtype | u8 ndim | u64 shape[ndim]
//     | pad to 8 | u64 nbytes | data | pad to 8
//
// dtype codes match numpy via the Python wrapper's table.
#include <cstdint>
#include <cstring>

#include "common.h"

namespace {
constexpr uint64_t kMagic = 0x474c54544d415031ull;  // "GLTTMAP1"
inline uint64_t pad8(uint64_t x) { return (x + 7) & ~7ull; }
}  // namespace

extern "C" {

// Compute the serialized size of a message described by parallel
// arrays (key lengths, ndims, shapes flattened, nbytes per tensor).
uint64_t glt_tmap_size(uint32_t n, const uint16_t* key_lens,
                       const uint8_t* ndims, const uint64_t* nbytes) {
  uint64_t sz = 8 + 4;
  for (uint32_t i = 0; i < n; ++i) {
    sz += 2 + key_lens[i] + 1 + 1 + 8ull * ndims[i];
    sz = pad8(sz);
    sz += 8 + nbytes[i];
    sz = pad8(sz);
  }
  return sz;
}

// Serialize into `out` (caller sized it with glt_tmap_size).
// `keys` is the concatenation of key bytes; `shapes` the concatenation
// of per-tensor shapes; `datas` an array of source pointers.
// Returns bytes written.
uint64_t glt_tmap_write(uint32_t n, const uint16_t* key_lens,
                        const char* keys, const uint8_t* dtypes,
                        const uint8_t* ndims, const uint64_t* shapes,
                        const uint64_t* nbytes, const void* const* datas,
                        char* out) {
  char* p = out;
  memcpy(p, &kMagic, 8); p += 8;
  memcpy(p, &n, 4); p += 4;
  const char* kp = keys;
  const uint64_t* sp = shapes;
  for (uint32_t i = 0; i < n; ++i) {
    memcpy(p, &key_lens[i], 2); p += 2;
    memcpy(p, kp, key_lens[i]); p += key_lens[i]; kp += key_lens[i];
    *p++ = (char)dtypes[i];
    *p++ = (char)ndims[i];
    memcpy(p, sp, 8ull * ndims[i]); p += 8ull * ndims[i]; sp += ndims[i];
    p = out + pad8(p - out);
    memcpy(p, &nbytes[i], 8); p += 8;
    memcpy(p, datas[i], nbytes[i]); p += nbytes[i];
    p = out + pad8(p - out);
  }
  return (uint64_t)(p - out);
}

// Parse pass 1: entry count (0 on bad magic).
uint32_t glt_tmap_count(const char* buf, uint64_t len) {
  if (len < 12) return 0;
  uint64_t magic;
  memcpy(&magic, buf, 8);
  if (magic != kMagic) return 0;
  uint32_t n;
  memcpy(&n, buf + 8, 4);
  return n;
}

// Parse pass 2: fill parallel descriptor arrays; data_offsets are
// byte offsets into `buf` (so Python can build zero-copy views).
// Returns 0 ok, -1 malformed.
int glt_tmap_parse(const char* buf, uint64_t len, uint16_t* key_lens,
                   char* keys /*cap: sum of key_lens*/, uint8_t* dtypes,
                   uint8_t* ndims, uint64_t* shapes /*cap: sum ndims*/,
                   uint64_t* nbytes, uint64_t* data_offsets) {
  uint32_t n = glt_tmap_count(buf, len);
  const char* p = buf + 12;
  const char* end = buf + len;
  char* kp = keys;
  uint64_t* sp = shapes;
  for (uint32_t i = 0; i < n; ++i) {
    if (p + 2 > end) return -1;
    memcpy(&key_lens[i], p, 2); p += 2;
    if (p + key_lens[i] + 2 > end) return -1;
    memcpy(kp, p, key_lens[i]); p += key_lens[i]; kp += key_lens[i];
    dtypes[i] = (uint8_t)*p++;
    ndims[i] = (uint8_t)*p++;
    if (p + 8ull * ndims[i] > end) return -1;
    memcpy(sp, p, 8ull * ndims[i]); p += 8ull * ndims[i]; sp += ndims[i];
    p = buf + pad8(p - buf);
    if (p + 8 > end) return -1;
    memcpy(&nbytes[i], p, 8); p += 8;
    if (p + nbytes[i] > end) return -1;
    data_offsets[i] = (uint64_t)(p - buf);
    p += nbytes[i];
    p = buf + pad8(p - buf);
  }
  return 0;
}

}  // extern "C"
