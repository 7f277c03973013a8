// Clean-room s-t max-flow / min-cut for mesh trimming.
//
// Replaces the reference's IBFS solver (code/mesh_cut/IBFS/, research-only
// license) with a freshly written Dinic's algorithm: BFS level graph +
// blocking-flow DFS with current-arc optimization. Mesh graphs here are
// sparse (3 neighbors/face) with small integer capacities (unary 1,
// pairwise ~10), where Dinic runs in a few hundred ms for millions of faces.
//
// Graph contract (mirrors mesh_cut_ext.cpp:10-55): every face i gets a
// terminal arc — label!=0 => source->i with capacity 1, else i->sink with
// capacity 1; every adjacency edge (u, v, cap) becomes a symmetric pair of
// residual arcs with capacity cap each direction. After max-flow,
// out_src_side[i] = 1 iff node i is reachable from the source in the
// residual graph (these faces are removed by the driver).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Dinic {
  struct Arc {
    int32_t to;
    int32_t next;
    int64_t cap;
  };

  int32_t n;  // nodes incl. s, t
  std::vector<Arc> arcs;
  std::vector<int32_t> head;
  std::vector<int32_t> level;
  std::vector<int32_t> iter;

  explicit Dinic(int32_t n_) : n(n_), head(n_, -1), level(n_), iter(n_) {}

  void add_edge(int32_t u, int32_t v, int64_t cap, int64_t rev_cap) {
    arcs.push_back({v, head[u], cap});
    head[u] = (int32_t)arcs.size() - 1;
    arcs.push_back({u, head[v], rev_cap});
    head[v] = (int32_t)arcs.size() - 1;
  }

  bool bfs(int32_t s, int32_t t) {
    std::fill(level.begin(), level.end(), -1);
    std::vector<int32_t> q;
    q.reserve(n);
    q.push_back(s);
    level[s] = 0;
    for (size_t qi = 0; qi < q.size(); ++qi) {
      int32_t u = q[qi];
      for (int32_t a = head[u]; a != -1; a = arcs[a].next) {
        if (arcs[a].cap > 0 && level[arcs[a].to] < 0) {
          level[arcs[a].to] = level[u] + 1;
          q.push_back(arcs[a].to);
        }
      }
    }
    return level[t] >= 0;
  }

  int64_t dfs(int32_t u, int32_t t, int64_t f) {
    if (u == t) return f;
    for (int32_t &a = iter[u]; a != -1; a = arcs[a].next) {
      int32_t v = arcs[a].to;
      if (arcs[a].cap > 0 && level[v] == level[u] + 1) {
        int64_t d = dfs(v, t, f < arcs[a].cap ? f : arcs[a].cap);
        if (d > 0) {
          arcs[a].cap -= d;
          arcs[a ^ 1].cap += d;
          return d;
        }
      }
    }
    return 0;
  }

  int64_t max_flow(int32_t s, int32_t t) {
    int64_t flow = 0;
    const int64_t INF = INT64_MAX / 4;
    while (bfs(s, t)) {
      for (int32_t i = 0; i < n; ++i) iter[i] = head[i];
      int64_t f;
      while ((f = dfs(s, t, INF)) > 0) flow += f;
    }
    return flow;
  }

  // source-side = reachable in residual graph (uses last bfs levels)
  void src_side(int32_t s, uint8_t *out, int32_t n_data) {
    bfs(s, s == 0 ? 1 : 0);  // recompute reachability from s
    for (int32_t i = 0; i < n_data; ++i) out[i] = level[i + 2] >= 0;
  }
};

}  // namespace

extern "C" {

// labels: n_nodes bytes (nonzero => source-linked, "spurious" face)
// edges:  n_edges * 3 uint32 (u, v, cap) face-adjacency with capacity
// out_src_side: n_nodes bytes, set to 1 for source-side (to-remove) faces
// returns the max-flow value
int64_t mesh_maxflow_cut(const uint8_t *labels, int32_t n_nodes,
                         const uint32_t *edges, int64_t n_edges,
                         uint8_t *out_src_side) {
  const int32_t S = 0, T = 1;
  Dinic g(n_nodes + 2);
  g.arcs.reserve(2 * (n_nodes + n_edges));
  for (int32_t i = 0; i < n_nodes; ++i) {
    if (labels[i])
      g.add_edge(S, i + 2, 1, 0);
    else
      g.add_edge(i + 2, T, 1, 0);
  }
  for (int64_t e = 0; e < n_edges; ++e) {
    uint32_t u = edges[3 * e], v = edges[3 * e + 1], cap = edges[3 * e + 2];
    g.add_edge((int32_t)u + 2, (int32_t)v + 2, cap, cap);
  }
  int64_t flow = g.max_flow(S, T);
  g.src_side(S, out_src_side, n_nodes);
  return flow;
}
}
