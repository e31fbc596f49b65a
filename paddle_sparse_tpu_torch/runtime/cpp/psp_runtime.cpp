// Native host runtime: graph preprocessing & sampling kernels.
//
// TPU-native architecture note: device compute is XLA/Pallas; this library
// accelerates the *host-side* structural work the reference implemented as
// Paddle custom ops (csrc/cpu/sample_cpu.cpp, csrc/cpu/convert_cpu.cpp) —
// minibatch subgraph sampling for data loading, canonicalization sorts, and
// graph reordering.  Exposed via a plain C ABI and loaded with ctypes (no
// pybind11 dependency).  All functions are single-call, buffer-in/buffer-out,
// and thread-safe (no global state; PRNG state is caller-provided seed).
//
// Semantics parity targets:
//  - psp_sample_adj reproduces the reference sampler's contract
//    (first-seen n_id ordering via hash map, per-row sorted local cols,
//    csrc/cpu/sample_cpu.cpp:10-148) with three modes: full (-1),
//    with-replacement, and distinct (Robert Floyd).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (see runtime/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// ind2ptr / ptr2ind (host, int64) — sequential scans, used by the host
// data-loading path; device path uses XLA searchsorted.
// ---------------------------------------------------------------------------
void psp_ind2ptr(const int64_t* row, int64_t nnz, int64_t M, int64_t* ptr) {
  int64_t i = 0;
  for (int64_t r = 0; r <= M; ++r) {
    while (i < nnz && row[i] < r) ++i;
    ptr[r] = i;
  }
}

void psp_ptr2ind(const int64_t* ptr, int64_t M, int64_t* row) {
  for (int64_t r = 0; r < M; ++r)
    for (int64_t k = ptr[r]; k < ptr[r + 1]; ++k) row[k] = r;
}

// ---------------------------------------------------------------------------
// Canonicalization sort: stable lexicographic (row, col) argsort.
// ---------------------------------------------------------------------------
void psp_lexsort_rowcol(const int64_t* row, const int64_t* col, int64_t nnz,
                        int64_t* perm) {
  for (int64_t i = 0; i < nnz; ++i) perm[i] = i;
  std::stable_sort(perm, perm + nnz, [&](int64_t a, int64_t b) {
    if (row[a] != row[b]) return row[a] < row[b];
    return col[a] < col[b];
  });
}

// ---------------------------------------------------------------------------
// sample_adj — GraphSAGE-style sampled subgraph with first-seen relabeling.
//
// Outputs (caller-allocated):
//   out_rowptr : n_subset + 1
//   out_col    : capacity  (local node ids)
//   out_eid    : capacity  (source edge positions)
//   out_nid    : n_subset + capacity (global node ids)
// Returns number of sampled edges; *out_num_nodes receives |n_id|.
// capacity must be >= sum of per-row sample counts (python computes it).
// ---------------------------------------------------------------------------
int64_t psp_sample_adj(const int64_t* rowptr, const int64_t* col,
                       const int64_t* subset, int64_t n_subset,
                       int64_t num_neighbors, int32_t replace, uint64_t seed,
                       int64_t* out_rowptr, int64_t* out_col,
                       int64_t* out_eid, int64_t* out_nid,
                       int64_t* out_num_nodes) {
  std::mt19937_64 rng(seed);
  std::unordered_map<int64_t, int64_t> n_id_map;
  n_id_map.reserve(n_subset * 2);
  int64_t num_nodes = 0;
  for (int64_t i = 0; i < n_subset; ++i) {
    out_nid[num_nodes] = subset[i];
    n_id_map.emplace(subset[i], num_nodes++);
  }

  std::vector<std::pair<int64_t, int64_t>> local;  // (local col, e_id)
  std::vector<int64_t> pool;
  int64_t e_out = 0;
  out_rowptr[0] = 0;

  for (int64_t i = 0; i < n_subset; ++i) {
    const int64_t n = subset[i];
    const int64_t lo = rowptr[n], hi = rowptr[n + 1];
    const int64_t deg = hi - lo;
    local.clear();

    auto push = [&](int64_t e) {
      const int64_t c = col[e];
      auto it = n_id_map.find(c);
      int64_t id;
      if (it == n_id_map.end()) {
        id = num_nodes;
        n_id_map.emplace(c, num_nodes);
        out_nid[num_nodes++] = c;
      } else {
        id = it->second;
      }
      local.emplace_back(id, e);
    };

    if (num_neighbors < 0) {                       // full neighborhood
      for (int64_t e = lo; e < hi; ++e) push(e);
    } else if (deg > 0 && replace) {               // with replacement
      for (int64_t s = 0; s < num_neighbors; ++s)
        push(lo + (int64_t)(rng() % (uint64_t)deg));
    } else if (deg > 0) {                          // distinct: Robert Floyd
      if (deg <= num_neighbors) {
        for (int64_t e = lo; e < hi; ++e) push(e);
      } else {
        pool.clear();
        for (int64_t j = deg - num_neighbors; j < deg; ++j) {
          int64_t t = (int64_t)(rng() % (uint64_t)(j + 1));
          if (std::find(pool.begin(), pool.end(), t) == pool.end())
            pool.push_back(t);
          else
            pool.push_back(j);
        }
        for (int64_t t : pool) push(lo + t);
      }
    }

    std::sort(local.begin(), local.end());         // per-row sorted cols
    for (auto& [c, e] : local) {
      out_col[e_out] = c;
      out_eid[e_out] = e;
      ++e_out;
    }
    out_rowptr[i + 1] = e_out;
  }
  *out_num_nodes = num_nodes;
  return e_out;
}

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee: BFS from low-degree roots, neighbors by degree.
// ---------------------------------------------------------------------------
void psp_rcm(const int64_t* rowptr, const int64_t* col, int64_t N,
             int64_t* perm) {
  std::vector<int64_t> deg(N), order(N), roots(N);
  for (int64_t v = 0; v < N; ++v) deg[v] = rowptr[v + 1] - rowptr[v];
  for (int64_t v = 0; v < N; ++v) roots[v] = v;
  std::stable_sort(roots.begin(), roots.end(),
                   [&](int64_t a, int64_t b) { return deg[a] < deg[b]; });

  std::vector<char> visited(N, 0);
  std::vector<int64_t> queue, neigh;
  int64_t pos = 0;
  for (int64_t root : roots) {
    if (visited[root]) continue;
    visited[root] = 1;
    queue.clear();
    queue.push_back(root);
    for (size_t qh = 0; qh < queue.size(); ++qh) {
      const int64_t v = queue[qh];
      order[pos++] = v;
      neigh.clear();
      for (int64_t e = rowptr[v]; e < rowptr[v + 1]; ++e)
        if (!visited[col[e]]) neigh.push_back(col[e]);
      std::stable_sort(neigh.begin(), neigh.end(), [&](int64_t a, int64_t b) {
        return deg[a] < deg[b];
      });
      for (int64_t u : neigh) {
        if (!visited[u]) {
          visited[u] = 1;
          queue.push_back(u);
        }
      }
    }
  }
  for (int64_t i = 0; i < N; ++i) perm[i] = order[N - 1 - i];
}

// ---------------------------------------------------------------------------
// BFS region-growing partitioner (see partition.py for the algorithm) —
// native version for large graphs.
// ---------------------------------------------------------------------------
void psp_partition(const int64_t* rowptr, const int64_t* col, int64_t N,
                   int64_t num_parts, int64_t* cluster) {
  const int64_t target = (N + num_parts - 1) / num_parts;
  std::vector<int64_t> deg(N), seeds(N), sizes(num_parts, 0);
  for (int64_t v = 0; v < N; ++v) deg[v] = rowptr[v + 1] - rowptr[v];
  for (int64_t v = 0; v < N; ++v) seeds[v] = v;
  std::stable_sort(seeds.begin(), seeds.end(),
                   [&](int64_t a, int64_t b) { return deg[a] > deg[b]; });
  std::fill(cluster, cluster + N, -1);

  std::vector<int64_t> frontier;
  size_t seed_cursor = 0;
  for (int64_t p = 0; p < num_parts; ++p) {
    while (seed_cursor < seeds.size() && cluster[seeds[seed_cursor]] >= 0)
      ++seed_cursor;
    if (seed_cursor >= seeds.size()) break;
    frontier.clear();
    frontier.push_back(seeds[seed_cursor]);
    for (size_t fh = 0; fh < frontier.size() && sizes[p] < target; ++fh) {
      const int64_t v = frontier[fh];
      if (cluster[v] >= 0) continue;
      cluster[v] = p;
      ++sizes[p];
      for (int64_t e = rowptr[v]; e < rowptr[v + 1]; ++e)
        if (cluster[col[e]] < 0) frontier.push_back(col[e]);
    }
  }
  for (int64_t v = 0; v < N; ++v) {
    if (cluster[v] < 0) {
      int64_t p = (int64_t)(std::min_element(sizes.begin(), sizes.end()) -
                            sizes.begin());
      cluster[v] = p;
      ++sizes[p];
    }
  }
  // greedy boundary refinement (one sweep)
  std::vector<int64_t> counts(num_parts);
  for (int64_t v = 0; v < N; ++v) {
    if (rowptr[v] == rowptr[v + 1]) continue;
    std::fill(counts.begin(), counts.end(), 0);
    for (int64_t e = rowptr[v]; e < rowptr[v + 1]; ++e)
      ++counts[cluster[col[e]]];
    int64_t best = (int64_t)(std::max_element(counts.begin(), counts.end()) -
                             counts.begin());
    const int64_t cur = cluster[v];
    if (best != cur && counts[best] > counts[cur] &&
        sizes[best] < target + 1) {
      cluster[v] = best;
      ++sizes[best];
      --sizes[cur];
    }
  }
}

}  // extern "C"
