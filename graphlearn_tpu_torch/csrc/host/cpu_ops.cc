// Host-side CPU twins of the sampling ops, for producer processes.
//
// Counterparts of the reference's CPU kernels
// (`csrc/cpu/random_sampler.cc:76-113`,
// `csrc/cpu/random_negative_sampler.cc`, `csrc/cpu/subgraph_op.cc`,
// `graph.cc`) — but emitting the *dense* `[B, k]` + validity-mask
// layout of the device (CUDA) ops rather than the reference's ragged
// `(nbrs, nbrs_num)`, so host-produced and device-produced batches are
// interchangeable pytrees.  Parallelized with OpenMP (the reference
// uses at::parallel_for).
#include <omp.h>

#include <algorithm>
#include <cstdint>
#include <vector>

#include "common.h"

using glt::kInvalidId;
using glt::Rng;
using glt::splitmix64;

extern "C" {

// ---------------------------------------------------------------------------
// coo_to_csr: counting sort on row ids.  Returns edge permutation so
// callers can carry edge ids / features (`utils/topo.py` twin).
// ---------------------------------------------------------------------------
void glt_coo_to_csr(const int64_t* rows, const int64_t* cols, int64_t num_edges,
                    int64_t num_nodes, int64_t* indptr /*[n+1]*/,
                    int64_t* indices /*[e]*/, int64_t* perm /*[e]*/) {
  for (int64_t i = 0; i <= num_nodes; ++i) indptr[i] = 0;
  for (int64_t e = 0; e < num_edges; ++e) indptr[rows[e] + 1]++;
  for (int64_t i = 0; i < num_nodes; ++i) indptr[i + 1] += indptr[i];
  // Stable fill using a moving cursor per row.
  std::vector<int64_t> cursor(indptr, indptr + num_nodes);
  for (int64_t e = 0; e < num_edges; ++e) {
    int64_t pos = cursor[rows[e]]++;
    indices[pos] = cols[e];
    perm[pos] = e;
  }
}

// ---------------------------------------------------------------------------
// Uniform neighbor sampling, dense layout.
//
// Per row: deg <= k -> copy all; deg > k -> k distinct picks via
// Floyd's algorithm (O(k) memory, exact without-replacement), the
// sequential-host answer to the reference's GPU reservoir kernel
// (`random_sampler.cu:58-108`).  Seeds may be kInvalidId (padded rows)
// -> fully masked output.
// ---------------------------------------------------------------------------
void glt_sample_one_hop(const int64_t* indptr, const int64_t* indices,
                        const int64_t* edge_ids /*nullable*/,
                        const int64_t* seeds, int64_t batch,
                        int64_t num_nodes, int64_t k, uint64_t seed,
                        int64_t* out_nbrs /*[B,k]*/,
                        uint8_t* out_mask /*[B,k]*/,
                        int64_t* out_eids /*nullable [B,k]*/) {
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t b = 0; b < batch; ++b) {
    int64_t* nb = out_nbrs + b * k;
    uint8_t* mk = out_mask + b * k;
    int64_t* ei = out_eids ? out_eids + b * k : nullptr;
    int64_t v = seeds[b];
    // out-of-range ids degrade to empty rows, like the reference's
    // empty-sample fallback (`sampler/neighbor_sampler.py:118-136`)
    if (v < 0 || v >= num_nodes) {
      for (int64_t j = 0; j < k; ++j) {
        nb[j] = kInvalidId;
        mk[j] = 0;
        if (ei) ei[j] = kInvalidId;
      }
      continue;
    }
    int64_t lo = indptr[v], hi = indptr[v + 1];
    int64_t deg = hi - lo;
    if (deg <= k) {
      for (int64_t j = 0; j < deg; ++j) {
        nb[j] = indices[lo + j];
        mk[j] = 1;
        if (ei) ei[j] = edge_ids ? edge_ids[lo + j] : lo + j;
      }
      for (int64_t j = deg; j < k; ++j) {
        nb[j] = kInvalidId;
        mk[j] = 0;
        if (ei) ei[j] = kInvalidId;
      }
      continue;
    }
    // Floyd's sampling of k distinct offsets in [0, deg).
    Rng rng(splitmix64(seed) ^ splitmix64((uint64_t)v * 0x9e3779b9ull + b));
    int64_t picks[256];  // k is a fanout, always small (<=256 enforced
                         // by the Python wrapper).
    int64_t np = 0;
    for (int64_t j = deg - k; j < deg; ++j) {
      int64_t t = (int64_t)rng.bounded((uint64_t)(j + 1));
      bool seen = false;
      for (int64_t s = 0; s < np; ++s)
        if (picks[s] == t) { seen = true; break; }
      picks[np++] = seen ? j : t;
    }
    for (int64_t j = 0; j < k; ++j) {
      int64_t off = lo + picks[j];
      nb[j] = indices[off];
      mk[j] = 1;
      if (ei) ei[j] = edge_ids ? edge_ids[off] : off;
    }
  }
}

// ---------------------------------------------------------------------------
// Weighted per-node sampling probability propagation for the frequency
// partitioner (`random_sampler.cu:166-208` CalNbrProbKernel analog):
// prob_out[nbr] += min(1, k/deg(v)) * prob_in[v] accumulated over edges.
// ---------------------------------------------------------------------------
void glt_cal_nbr_prob(const int64_t* indptr, const int64_t* indices,
                      const float* prob_in, int64_t num_nodes, int64_t k,
                      float* prob_out) {
  for (int64_t v = 0; v < num_nodes; ++v) {
    int64_t lo = indptr[v], hi = indptr[v + 1];
    int64_t deg = hi - lo;
    if (deg == 0 || prob_in[v] == 0.f) continue;
    float w = prob_in[v] * std::min(1.0f, (float)k / (float)deg);
    for (int64_t e = lo; e < hi; ++e) prob_out[indices[e]] += w;
  }
}

// ---------------------------------------------------------------------------
// Random negative sampling with strict CSR rejection
// (`random_negative_sampler.cu:37-120` behavior): draw (r, c) pairs;
// in strict mode reject pairs that exist as edges (binary search in
// the row's column range); retry up to `trials` rounds; if `padding`,
// fill the remainder with non-strict draws.  Returns count written.
// ---------------------------------------------------------------------------
int64_t glt_negative_sample(const int64_t* indptr, const int64_t* indices,
                            int64_t num_nodes, int64_t req_num, int64_t trials,
                            int strict, int padding, uint64_t seed,
                            int64_t* out_rows, int64_t* out_cols) {
  int64_t count = 0;
  Rng rng(seed);
  for (int64_t t = 0; t < trials && count < req_num; ++t) {
    for (int64_t i = count; i < req_num; ++i) {
      int64_t r = (int64_t)rng.bounded((uint64_t)num_nodes);
      int64_t c = (int64_t)rng.bounded((uint64_t)num_nodes);
      if (strict) {
        // Linear membership scan: CSR columns are not required to be
        // sorted within a row (unlike the reference's binary-search
        // `EdgeInCSR`, which assumes sorted columns).
        const int64_t* lo = indices + indptr[r];
        const int64_t* hi = indices + indptr[r + 1];
        if (std::find(lo, hi, c) != hi) continue;
      }
      out_rows[count] = r;
      out_cols[count] = c;
      ++count;
    }
  }
  if (padding) {
    while (count < req_num) {
      out_rows[count] = (int64_t)rng.bounded((uint64_t)num_nodes);
      out_cols[count] = (int64_t)rng.bounded((uint64_t)num_nodes);
      ++count;
    }
  }
  return count;
}

}  // extern "C"
