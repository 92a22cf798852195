// ddmcore: native host-side DDM topology kernels.
//
// This framework's equivalent of the reference's native setup layer: where
// dune-ddm runs overlap extension as MPI rounds over DUNE index sets
// (dune/ddm/overlap_extension.hh) with intra-rank Taskflow concurrency, this
// module computes, for ALL subdomains in parallel (std::thread pool =
// Taskflow-equivalent), directly on the global matrix graph:
//
//   * the overlapping dof sets (`overlap` BFS rounds on the adjacency graph)
//   * the subdomain boundary masks (dof with a neighbour outside the set)
//   * graph distances from the boundary (capped)
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).  The Python
// fallback (scipy sparse boolean matmuls, core/indexmaps.py) remains the
// reference implementation; this path wins on large unstructured graphs.
//
// Build: python -m ddm_jax._native.build  (invoked lazily, cached .so)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct SubResult {
  std::vector<int32_t> ids;    // sorted member dof ids
  std::vector<uint8_t> bnd;    // boundary flag per member
  std::vector<int32_t> dist;   // distance from boundary per member
};

void process_subdomain(const int64_t* indptr, const int32_t* indices,
                       int64_t n, const int32_t* seed, int64_t n_seed,
                       int32_t overlap, int32_t cap, SubResult& out) {
  // membership marker: 0 = outside, 1 = member
  std::vector<uint8_t> member(n, 0);
  std::vector<int32_t> frontier(seed, seed + n_seed);
  std::vector<int32_t> members(seed, seed + n_seed);
  for (int64_t i = 0; i < n_seed; ++i) member[seed[i]] = 1;

  // overlap rounds of graph growth
  for (int32_t round = 0; round < overlap; ++round) {
    std::vector<int32_t> next;
    next.reserve(frontier.size());
    for (int32_t u : frontier) {
      for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
        int32_t v = indices[k];
        if (!member[v]) {
          member[v] = 1;
          next.push_back(v);
          members.push_back(v);
        }
      }
    }
    frontier.swap(next);
    if (frontier.empty()) break;
  }

  std::sort(members.begin(), members.end());
  const int64_t m = static_cast<int64_t>(members.size());

  // boundary: member with a neighbour outside the member set
  out.ids = std::move(members);
  out.bnd.assign(m, 0);
  out.dist.assign(m, cap);
  std::vector<int32_t> local(n, -1);
  for (int64_t i = 0; i < m; ++i) local[out.ids[i]] = static_cast<int32_t>(i);

  std::vector<int32_t> bfs;
  bfs.reserve(m);
  for (int64_t i = 0; i < m; ++i) {
    int32_t u = out.ids[i];
    for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
      if (!member[indices[k]]) {
        out.bnd[i] = 1;
        out.dist[i] = 0;
        bfs.push_back(static_cast<int32_t>(i));
        break;
      }
    }
  }

  // BFS distances from the boundary within the subdomain, capped
  size_t head = 0;
  while (head < bfs.size()) {
    int32_t li = bfs[head++];
    int32_t d = out.dist[li];
    if (d >= cap) continue;
    int32_t u = out.ids[li];
    for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
      int32_t v = indices[k];
      int32_t lv = local[v];
      if (lv >= 0 && out.dist[lv] > d + 1) {
        out.dist[lv] = d + 1;
        bfs.push_back(lv);
      }
    }
  }
}

std::vector<SubResult>* g_results = nullptr;

}  // namespace

extern "C" {

// Phase 1: compute everything, return total member count.  Results are held
// in a module-global until collected (single-threaded driver assumption).
int64_t ddm_topology_compute(const int64_t* indptr, const int32_t* indices,
                             int64_t n, const int64_t* seed_offsets,
                             const int32_t* seed_ids, int64_t n_sub,
                             int32_t overlap, int32_t cap, int32_t n_threads) {
  delete g_results;
  g_results = new std::vector<SubResult>(n_sub);
  std::atomic<int64_t> next_k{0};
  auto worker = [&]() {
    while (true) {
      int64_t k = next_k.fetch_add(1);
      if (k >= n_sub) break;
      process_subdomain(indptr, indices, n, seed_ids + seed_offsets[k],
                        seed_offsets[k + 1] - seed_offsets[k], overlap, cap,
                        (*g_results)[k]);
    }
  };
  int nt = n_threads > 0
               ? n_threads
               : static_cast<int>(std::thread::hardware_concurrency());
  nt = std::max(1, std::min<int>(nt, static_cast<int>(n_sub)));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();

  int64_t total = 0;
  for (auto& r : *g_results) total += static_cast<int64_t>(r.ids.size());
  return total;
}

// Phase 2: collect into caller-provided flat buffers (offsets: n_sub+1).
void ddm_topology_collect(int64_t* offsets, int32_t* ids, uint8_t* bnd,
                          int32_t* dist) {
  if (!g_results) return;
  int64_t pos = 0;
  int64_t k = 0;
  for (auto& r : *g_results) {
    offsets[k++] = pos;
    const int64_t m = static_cast<int64_t>(r.ids.size());
    std::memcpy(ids + pos, r.ids.data(), m * sizeof(int32_t));
    std::memcpy(bnd + pos, r.bnd.data(), m * sizeof(uint8_t));
    std::memcpy(dist + pos, r.dist.data(), m * sizeof(int32_t));
    pos += m;
  }
  offsets[k] = pos;
  delete g_results;
  g_results = nullptr;
}

}  // extern "C"
