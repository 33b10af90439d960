// The locality partitioner's streaming greedy on the host (the port's
// compiled copy of `parallel/locality.py::_greedy`, decision for decision).
//
// Each node of `order` is placed on the partition maximising
//   aff[p] * (1 - size[p] / cap) - size[p] * tie
// over the partitions with room (aff[p]: the weights of its neighbours
// already on p, summed in neighbour order as numpy's bincount sums them);
// the first maximum wins.  A refinement sweep scores the node's own
// partition without the node and moves it only to a strictly better
// partition with room.  Plain double arithmetic, one operation at a time,
// so every score rounds as numpy's does.  No device code.
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

int best_part(int64_t v, int64_t current, const int64_t* indptr,
              const int64_t* nbrs, const double* w, const int64_t* part,
              const int64_t* sizes, int num_parts, int64_t cap, double tie,
              std::vector<double>& aff) {
  for (int p = 0; p < num_parts; ++p) aff[p] = 0.0;
  for (int64_t j = indptr[v]; j < indptr[v + 1]; ++j) {
    const int64_t u = nbrs[j];
    const int64_t q = part[u];
    if (q >= 0) aff[q] += w[u];
  }
  const double dcap = static_cast<double>(cap);
  int best = 0;
  double best_score = 0.0;
  for (int p = 0; p < num_parts; ++p) {
    double score;
    if (p == current) {
      const int64_t s1 = sizes[p] - 1;
      const double load = 1.0 - static_cast<double>(s1) / dcap;
      const double pen = static_cast<double>(s1) * tie;
      score = aff[p] * load - pen;
    } else if (sizes[p] >= cap) {
      score = -std::numeric_limits<double>::infinity();
    } else {
      const double load = 1.0 - static_cast<double>(sizes[p]) / dcap;
      const double pen = static_cast<double>(sizes[p]) * tie;
      score = aff[p] * load - pen;
    }
    if (p == 0 || score > best_score) {
      best = p;
      best_score = score;
    }
  }
  return best;
}

}  // namespace

extern "C" int locality_greedy(const int64_t* indptr, const int64_t* nbrs,
                               const double* w, const int64_t* order,
                               int64_t n, int num_parts, int64_t cap,
                               int passes, int64_t* part, int64_t* sizes) {
  if (num_parts < 1 || cap < 1) return 1;
  std::vector<double> aff(num_parts);
  const double tie =
      1.0 / (static_cast<double>(cap * static_cast<int64_t>(num_parts)) * 4.0);
  for (int64_t i = 0; i < n; ++i) part[i] = -1;
  for (int p = 0; p < num_parts; ++p) sizes[p] = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t v = order[i];
    const int p = best_part(v, -1, indptr, nbrs, w, part, sizes, num_parts,
                            cap, tie, aff);
    part[v] = p;
    sizes[p] += 1;
  }
  for (int sweep = 0; sweep < passes; ++sweep) {
    int64_t moved = 0;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t v = order[i];
      const int64_t cur = part[v];
      const int p = best_part(v, cur, indptr, nbrs, w, part, sizes,
                              num_parts, cap, tie, aff);
      if (p != cur && sizes[p] < cap) {
        sizes[cur] -= 1;
        sizes[p] += 1;
        part[v] = p;
        moved += 1;
      }
    }
    if (moved == 0) break;
  }
  return 0;
}
