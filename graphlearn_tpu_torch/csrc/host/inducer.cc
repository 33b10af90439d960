// Host-side stateful inducer: cross-hop dedup + global->local relabel.
//
// Counterpart of the reference's CPU inducer (`csrc/cpu/inducer.cc`,
// `include/inducer.h:27-70`): `InitNode(seed)` seeds the table,
// `InduceNext(...)` inserts new nodes and emits local COO.  The host
// side has no static-shape constraint, so a plain open-addressing
// table is the right tool (the device twin in
// `graphlearn_tpu_torch/ops/unique.py` is sort-based with fixed capacity).
// Inputs are the dense `[B, k]` + mask layout of our sampling ops;
// masked slots produce no edges.
#include <cstdint>
#include <cstring>
#include <vector>

#include "common.h"

using glt::kInvalidId;
using glt::splitmix64;

namespace {

// Open-addressing global->local map sized for ~millions of nodes.
class Inducer {
 public:
  explicit Inducer(int64_t capacity_hint) { reserve(capacity_hint * 2 + 64); }

  void clear() {
    std::fill(keys_.begin(), keys_.end(), kInvalidId);
    vals_.assign(vals_.size(), 0);
    nodes_.clear();
  }

  // Insert; returns local id.
  int32_t insert(int64_t g) {
    if (nodes_.size() * 2 >= keys_.size()) grow();
    size_t m = keys_.size() - 1;
    size_t pos = splitmix64((uint64_t)g) & m;
    while (true) {
      if (keys_[pos] == g) return vals_[pos];
      if (keys_[pos] == kInvalidId) {
        keys_[pos] = g;
        vals_[pos] = (int32_t)nodes_.size();
        nodes_.push_back(g);
        return vals_[pos];
      }
      pos = (pos + 1) & m;
    }
  }

  int32_t lookup(int64_t g) const {
    size_t m = keys_.size() - 1;
    size_t pos = splitmix64((uint64_t)g) & m;
    while (true) {
      if (keys_[pos] == g) return vals_[pos];
      if (keys_[pos] == kInvalidId) return -1;
      pos = (pos + 1) & m;
    }
  }

  const std::vector<int64_t>& nodes() const { return nodes_; }

 private:
  void reserve(size_t n) {
    size_t cap = 64;
    while (cap < n) cap <<= 1;
    keys_.assign(cap, kInvalidId);
    vals_.assign(cap, 0);
  }
  void grow() {
    std::vector<int64_t> old_nodes = nodes_;
    reserve(keys_.size() * 2);
    nodes_.clear();
    for (int64_t g : old_nodes) insert(g);
  }

  std::vector<int64_t> keys_;
  std::vector<int32_t> vals_;
  std::vector<int64_t> nodes_;
};

}  // namespace

extern "C" {

void* glt_inducer_create(int64_t capacity_hint) {
  return new Inducer(capacity_hint);
}

void glt_inducer_destroy(void* h) { delete static_cast<Inducer*>(h); }

void glt_inducer_clear(void* h) { static_cast<Inducer*>(h)->clear(); }

int64_t glt_inducer_num_nodes(void* h) {
  return (int64_t)static_cast<Inducer*>(h)->nodes().size();
}

// Seed the table; writes local ids of the seeds to `out_local`.
void glt_inducer_init(void* h, const int64_t* seeds, int64_t n,
                      int32_t* out_local) {
  auto* ind = static_cast<Inducer*>(h);
  for (int64_t i = 0; i < n; ++i) {
    out_local[i] =
        seeds[i] == kInvalidId ? -1 : ind->insert(seeds[i]);
  }
}

// One hop: srcs [B] global, nbrs/mask [B, k].  Emits local COO into
// row_local/col_local (capacity B*k; masked slots get -1) and returns
// the number of *new* unique nodes appended to the table (fetch them
// with glt_inducer_nodes_since).
int64_t glt_inducer_induce(void* h, const int64_t* srcs, const int64_t* nbrs,
                           const uint8_t* mask, int64_t batch, int64_t k,
                           int32_t* row_local, int32_t* col_local) {
  auto* ind = static_cast<Inducer*>(h);
  int64_t before = (int64_t)ind->nodes().size();
  for (int64_t b = 0; b < batch; ++b) {
    int64_t s = srcs[b];
    int32_t sl = s == kInvalidId ? -1 : ind->insert(s);
    for (int64_t j = 0; j < k; ++j) {
      int64_t idx = b * k + j;
      if (sl < 0 || !mask[idx] || nbrs[idx] == kInvalidId) {
        row_local[idx] = -1;
        col_local[idx] = -1;
        continue;
      }
      int32_t nl = ind->insert(nbrs[idx]);
      // PyG message-passing direction: edge from neighbor -> seed
      // (reference transposes likewise,
      //  `sampler/neighbor_sampler.py:159-166`).
      row_local[idx] = nl;
      col_local[idx] = sl;
    }
  }
  return (int64_t)ind->nodes().size() - before;
}

// Copy table nodes [start, start+n) into `out` (global ids in local-id
// order).
void glt_inducer_nodes_since(void* h, int64_t start, int64_t n,
                             int64_t* out) {
  auto* ind = static_cast<Inducer*>(h);
  memcpy(out, ind->nodes().data() + start, sizeof(int64_t) * n);
}

// One HETERO hop: the frontier lives in a *different* (source-type)
// table, so its local ids are passed in directly; neighbors insert
// into THIS (destination-type) table.  Counterpart of the reference's
// per-node-type hetero inducer (`csrc/cpu/inducer.cc`, hetero variants
// keyed by type at `csrc/cuda/inducer.cu:149+`).  src_local [B] are
// seed-side local ids (already -1 for invalid slots); nbrs/mask [B,k]
// are destination-type globals.  Emits neighbor->seed local COO (row =
// dst-table local, col = src-table local) and returns the number of
// new unique nodes appended to this table.
int64_t glt_inducer_induce_pair(void* dst_h, const int32_t* src_local,
                                const int64_t* nbrs, const uint8_t* mask,
                                int64_t batch, int64_t k,
                                int32_t* row_local, int32_t* col_local) {
  auto* dst = static_cast<Inducer*>(dst_h);
  int64_t before = (int64_t)dst->nodes().size();
  for (int64_t b = 0; b < batch; ++b) {
    int32_t sl = src_local[b];
    for (int64_t j = 0; j < k; ++j) {
      int64_t idx = b * k + j;
      if (sl < 0 || !mask[idx] || nbrs[idx] == kInvalidId) {
        row_local[idx] = -1;
        col_local[idx] = -1;
        continue;
      }
      row_local[idx] = dst->insert(nbrs[idx]);
      col_local[idx] = sl;
    }
  }
  return (int64_t)dst->nodes().size() - before;
}

}  // extern "C"
