// Symbolic orderings for sparse elimination (native inference-layer helper,
// SURVEY.md §3.2 "Sparse ordering libs": the role CCOLAMD/METIS play in the
// reference stack). Host-side, once per graph topology — the numeric solve
// stays on TPU.
//
// Provides:
//   rcm_order     — reverse Cuthill-McKee (bandwidth-minimizing) ordering of
//                   the pose-graph adjacency; used to pre-permute poses so
//                   contiguous-range Schur partitions (ndtpu.dist.schur) cut
//                   few edges and the dense-block solver stays banded.
//   amd_order     — approximate-minimum-degree-style greedy ordering
//                   (min-degree with quotient-graph external degree
//                   approximation) for fill-reducing elimination.
//
// C ABI for ctypes. Graph input: E undirected edges (i, j) over V vertices.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

// Build CSR adjacency from an edge list (deduplicated, no self loops).
void build_adj(const int32_t* ei, const int32_t* ej, int e, int v,
               std::vector<int32_t>& ptr, std::vector<int32_t>& adj) {
  std::vector<std::vector<int32_t>> nbr(v);
  for (int k = 0; k < e; ++k) {
    int a = ei[k], b = ej[k];
    if (a == b || a < 0 || b < 0 || a >= v || b >= v) continue;
    nbr[a].push_back(b);
    nbr[b].push_back(a);
  }
  ptr.assign(v + 1, 0);
  for (int i = 0; i < v; ++i) {
    auto& ns = nbr[i];
    std::sort(ns.begin(), ns.end());
    ns.erase(std::unique(ns.begin(), ns.end()), ns.end());
    ptr[i + 1] = ptr[i] + static_cast<int32_t>(ns.size());
  }
  adj.resize(ptr[v]);
  for (int i = 0; i < v; ++i)
    std::copy(nbr[i].begin(), nbr[i].end(), adj.begin() + ptr[i]);
}

}  // namespace

extern "C" {

// order[v]: position -> vertex id (a permutation). Returns 0 on success.
int rcm_order(const int32_t* ei, const int32_t* ej, int e, int v,
              int32_t* order) {
  std::vector<int32_t> ptr, adj;
  build_adj(ei, ej, e, v, ptr, adj);
  std::vector<int32_t> deg(v);
  for (int i = 0; i < v; ++i) deg[i] = ptr[i + 1] - ptr[i];
  std::vector<char> seen(v, 0);
  int pos = 0;
  for (int start = 0; start < v; ++start) {
    if (seen[start]) continue;
    // Pick the minimum-degree vertex of this component as the seed.
    int seed = start;
    {
      // BFS to collect the component, track min degree.
      std::vector<int32_t> comp;
      std::queue<int32_t> q;
      q.push(start);
      seen[start] = 1;
      while (!q.empty()) {
        int u = q.front(); q.pop();
        comp.push_back(u);
        for (int32_t p = ptr[u]; p < ptr[u + 1]; ++p)
          if (!seen[adj[p]]) { seen[adj[p]] = 1; q.push(adj[p]); }
      }
      for (int32_t u : comp) if (deg[u] < deg[seed]) seed = u;
      for (int32_t u : comp) seen[u] = 0;  // reset for the real BFS
    }
    // Cuthill-McKee BFS from the seed, neighbors by increasing degree.
    std::queue<int32_t> q;
    q.push(seed);
    seen[seed] = 1;
    std::vector<int32_t> nbrs;
    while (!q.empty()) {
      int u = q.front(); q.pop();
      order[pos++] = u;
      nbrs.clear();
      for (int32_t p = ptr[u]; p < ptr[u + 1]; ++p)
        if (!seen[adj[p]]) nbrs.push_back(adj[p]);
      std::sort(nbrs.begin(), nbrs.end(),
                [&](int32_t a, int32_t b) { return deg[a] < deg[b]; });
      for (int32_t w : nbrs) { seen[w] = 1; q.push(w); }
    }
  }
  if (pos != v) return 1;
  std::reverse(order, order + v);  // the "reverse" in RCM
  return 0;
}

// Greedy minimum-degree elimination ordering (quotient-graph free variant:
// degrees updated on a dynamically densified adjacency; fine for V <= ~50k).
int amd_order(const int32_t* ei, const int32_t* ej, int e, int v,
              int32_t* order) {
  std::vector<int32_t> ptr, adj;
  build_adj(ei, ej, e, v, ptr, adj);
  std::vector<std::vector<int32_t>> nbr(v);
  for (int i = 0; i < v; ++i)
    nbr[i].assign(adj.begin() + ptr[i], adj.begin() + ptr[i + 1]);
  std::vector<char> gone(v, 0);
  using Item = std::pair<int32_t, int32_t>;  // (degree, vertex)
  std::priority_queue<Item, std::vector<Item>, std::greater<Item>> heap;
  for (int i = 0; i < v; ++i)
    heap.emplace(static_cast<int32_t>(nbr[i].size()), i);
  int pos = 0;
  while (!heap.empty()) {
    auto [d, u] = heap.top();
    heap.pop();
    if (gone[u] || d != static_cast<int32_t>(nbr[u].size())) continue;
    gone[u] = 1;
    order[pos++] = u;
    // Connect u's surviving neighbors into a clique (elimination fill).
    std::vector<int32_t> live;
    for (int32_t w : nbr[u]) if (!gone[w]) live.push_back(w);
    for (int32_t w : live) {
      auto& ns = nbr[w];
      ns.erase(std::remove(ns.begin(), ns.end(), u), ns.end());
      for (int32_t x : live)
        if (x != w && std::find(ns.begin(), ns.end(), x) == ns.end())
          ns.push_back(x);
      heap.emplace(static_cast<int32_t>(ns.size()), w);
    }
    nbr[u].clear();
  }
  return pos == v ? 0 : 1;
}

}  // extern "C"
