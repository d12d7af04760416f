// Exact Earth Mover's Distance (transportation problem) solvers.
//
// Native replacement for the reference's POT `ot.emd` (reference
// utils.py:1074-1113 calls it on histogram masses + sqeuclidean costs).
//
// Primary: `emd_solve` — a transportation network simplex written from the
// textbook algorithm (MODI / u-v method on a spanning-tree basis):
//   - initial basis from the northwest-corner rule (always yields exactly
//     n+m-1 basic arcs forming a spanning tree),
//   - node duals recomputed from the tree after each pivot (O(V)),
//   - entering arc by block pricing over the flattened arc list (scan
//     ~sqrt(nm) arcs per pivot, wrap-around cursor),
//   - leaving arc = minimum-flow backward arc on the tree cycle,
//   - degeneracy broken by a deterministic O(1e-14)-scale perturbation of
//     the supplies (removed from the last demand), small enough to stay
//     under the 1e-10 marginal tolerances used by callers.
//
// Secondary: `emd_solve_ssp` — the round-2 successive-shortest-paths solver,
// kept as an independent implementation for cross-validation tests.
//
// C ABI for ctypes (both):
//   int emd_solve(int n, int m, const double* mu,  // source masses [n]
//                 const double* nu,                // target masses [m]
//                 const double* cost,              // row-major [n*m]
//                 double* plan);                   // out, row-major [n*m]
// Returns 0 on success, nonzero on failure.
//
// Build: g++ -O3 -shared -fPIC (xsdba_tpu_torch/native/__init__.py builds it at
// first use into build/kernels/libxsdba_emd_<hash>.so)

#include <algorithm>
#include <cmath>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// ---------------------------------------------------------------------------
// Network simplex
// ---------------------------------------------------------------------------

struct TreeState {
  // Nodes: sources 0..n-1, sinks n..n+m-1.  Rooted at node 0.
  std::vector<int> parent;     // parent node (-1 at root)
  std::vector<double> pflow;   // flow on the arc (v, parent[v])
  std::vector<int> order;      // BFS order from root (parents before children)
  std::vector<double> dual;    // u on sources, v on sinks: c[s][t] = u[s]+v[t] on basis
  std::vector<int> kid_head, kid_next;  // children lists (allocation-free rebuild)
};

// Rebuild BFS order and duals from parent[] (O(V), no allocations).
void refresh_tree(int n, int m, const double* cost, TreeState& T) {
  const int V = n + m;
  std::fill(T.kid_head.begin(), T.kid_head.end(), -1);
  for (int v = 0; v < V; ++v) {
    int p = T.parent[v];
    if (p >= 0) {
      T.kid_next[v] = T.kid_head[p];
      T.kid_head[p] = v;
    }
  }
  T.order.clear();
  T.order.push_back(0);
  T.dual[0] = 0.0;
  for (size_t h = 0; h < T.order.size(); ++h) {
    int u = T.order[h];
    for (int w = T.kid_head[u]; w >= 0; w = T.kid_next[w]) {
      // basic arc between source s and sink t: dual[s] + dual[t] = c[s][t]
      int s = (w < n) ? w : u;
      int t = (w < n) ? u : w;
      T.dual[w] = cost[(size_t)s * m + (t - n)] - T.dual[u];
      T.order.push_back(w);
    }
  }
}

}  // namespace

extern "C" int emd_solve(int n, int m, const double* mu, const double* nu,
                         const double* cost, double* plan) {
  const int V = n + m;
  std::memset(plan, 0, sizeof(double) * (size_t)n * m);

  double total_s = 0, total_d = 0;
  for (int i = 0; i < n; ++i) total_s += mu[i];
  for (int j = 0; j < m; ++j) total_d += nu[j];
  if (std::fabs(total_s - total_d) > 1e-6 * std::max(total_s, total_d)) return 1;

  // Trivial shapes.
  if (n == 1) {
    for (int j = 0; j < m; ++j) plan[j] = nu[j];
    return 0;
  }
  if (m == 1) {
    for (int i = 0; i < n; ++i) plan[(size_t)i] = mu[i];
    return 0;
  }

  // Deterministic anti-degeneracy perturbation (total ~V*1e-14*scale).
  const double pert = 1e-14 * std::max(1.0, total_s);
  std::vector<double> supply(mu, mu + n), demand(nu, nu + m);
  double added = 0;
  for (int i = 0; i < n; ++i) {
    double d = pert * (i + 1);
    supply[i] += d;
    added += d;
  }
  demand[m - 1] += added;

  TreeState T;
  T.parent.assign(V, -1);
  T.pflow.assign(V, 0.0);
  T.dual.assign(V, 0.0);
  T.kid_head.assign(V, -1);
  T.kid_next.assign(V, -1);
  T.order.reserve(V);

  // Northwest-corner initial basis: walk (i, j) advancing whichever of
  // supply/demand is exhausted; the n+m-1 visited cells become the basic
  // arcs and their staircase shape is automatically a spanning tree.
  {
    std::vector<double> s(supply), d(demand);
    int i = 0, j = 0;
    // Root the tree at source 0; each later cell introduces exactly one new
    // node (the advanced index), attached under the already-seen endpoint.
    std::vector<char> seen_dst(m, 0);
    while (true) {
      double f = std::min(s[i], d[j]);
      if (!seen_dst[j]) {
        T.parent[n + j] = i;
        T.pflow[n + j] = f;
        seen_dst[j] = 1;
      } else {  // source i is the new endpoint
        T.parent[i] = n + j;
        T.pflow[i] = f;
      }
      s[i] -= f;
      d[j] -= f;
      if (i == n - 1 && j == m - 1) break;
      bool advance_i = (i < n - 1) && (j == m - 1 || s[i] <= d[j]);
      if (advance_i)
        ++i;
      else
        ++j;
    }
  }
  refresh_tree(n, m, cost, T);

  // Pricing tolerance relative to the cost magnitude.
  double cmax = 0;
  for (size_t a = 0; a < (size_t)n * m; ++a) cmax = std::max(cmax, std::fabs(cost[a]));
  const double tol = 1e-11 * std::max(1.0, cmax);

  const size_t narcs = (size_t)n * m;
  const size_t block = std::max<size_t>(64, (size_t)std::sqrt((double)narcs));
  size_t cursor = 0;

  std::vector<int> path_i, path_j;  // ancestor chains for cycle tracing
  std::vector<int> depth(V);

  long long max_pivots = 64LL * (n + m) * (long long)std::max(n, m) + 1000000;
  for (long long pivot = 0;; ++pivot) {
    if (pivot > max_pivots) return 3;  // anti-cycling backstop

    // -- entering arc: best reduced cost within the first block that has one
    double best_rc = -tol;
    size_t best_a = narcs;
    size_t scanned = 0;
    while (scanned < narcs) {
      size_t end = std::min(cursor + block, narcs);
      for (size_t a = cursor; a < end; ++a) {
        int i = (int)(a / m), j = (int)(a % m);
        double rc = cost[a] - T.dual[i] - T.dual[n + j];
        if (rc < best_rc) {
          best_rc = rc;
          best_a = a;
        }
      }
      scanned += end - cursor;
      cursor = (end == narcs) ? 0 : end;
      if (best_a != narcs) break;
    }
    if (best_a == narcs) break;  // optimal

    const int ei = (int)(best_a / m);       // entering source
    const int ej = n + (int)(best_a % m);   // entering sink (node id)

    // -- depths for LCA (recomputed from BFS order: parents precede children)
    for (int v : T.order) depth[v] = (T.parent[v] < 0) ? 0 : depth[T.parent[v]] + 1;

    // -- trace the cycle: ei -> ... -> lca <- ... <- ej
    path_i.clear();
    path_j.clear();
    {
      int a = ei, b = ej;
      while (depth[a] > depth[b]) {
        path_i.push_back(a);
        a = T.parent[a];
      }
      while (depth[b] > depth[a]) {
        path_j.push_back(b);
        b = T.parent[b];
      }
      while (a != b) {
        path_i.push_back(a);
        a = T.parent[a];
        path_j.push_back(b);
        b = T.parent[b];
      }
    }

    // -- find delta: pushing flow ei->ej on the entering arc means arcs
    // traversed source->sink on the ej-side chain GAIN flow and arcs
    // traversed sink->source LOSE it; signs alternate and invert on the
    // ei-side chain.  An arc (v, parent) on the ei-side chain loses flow
    // when v is a source (flow v->parent is pushed back), on the ej-side
    // chain loses when v is a sink.
    double delta = kInf;
    int leave = -1;       // node whose parent-arc leaves
    bool leave_on_i = false;
    for (int v : path_i) {
      bool loses = (v < n);
      if (loses && T.pflow[v] < delta) {
        delta = T.pflow[v];
        leave = v;
        leave_on_i = true;
      }
    }
    for (int v : path_j) {
      bool loses = (v >= n);
      if (loses && T.pflow[v] < delta) {
        delta = T.pflow[v];
        leave = v;
        leave_on_i = false;
      }
    }
    if (leave < 0) return 2;  // unbounded: impossible in transportation

    // -- apply flow change along both chains
    for (int v : path_i) T.pflow[v] += (v < n) ? -delta : delta;
    for (int v : path_j) T.pflow[v] += (v >= n) ? -delta : delta;

    // -- structural update: remove (leave, parent[leave]), insert (ei, ej).
    // The entering endpoint inside the cut-off subtree becomes its new root:
    // reverse parent pointers (and carry flows) from that endpoint up to
    // `leave`, then hang it under the other endpoint with flow delta.
    {
      int sub_root = leave_on_i ? ei : ej;   // inside the subtree under `leave`
      int anchor = leave_on_i ? ej : ei;     // stays in the main tree
      int v = sub_root, pv = T.parent[v];
      double fv = T.pflow[v];
      T.parent[sub_root] = anchor;
      T.pflow[sub_root] = delta;
      while (v != leave) {
        int nv = T.parent[pv];
        double nf = T.pflow[pv];
        T.parent[pv] = v;
        T.pflow[pv] = fv;
        v = pv;
        pv = nv;
        fv = nf;
      }
    }
    refresh_tree(n, m, cost, T);
  }

  // -- extract plan from basis flows, clipping the perturbation dust
  for (int v = 0; v < V; ++v) {
    if (T.parent[v] < 0) continue;
    int s = (v < n) ? v : T.parent[v];
    int t = (v < n) ? T.parent[v] : v;
    double f = T.pflow[v];
    if (f > 0) plan[(size_t)s * m + (t - n)] += f;
  }
  // remove the perturbation from the marginals: subtract dust proportionally
  for (int i = 0; i < n; ++i) {
    double rowsum = 0;
    double* row = plan + (size_t)i * m;
    for (int j = 0; j < m; ++j) rowsum += row[j];
    if (rowsum > 0 && mu[i] >= 0) {
      double f = mu[i] / rowsum;
      for (int j = 0; j < m; ++j) row[j] *= f;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Successive shortest augmenting paths (independent reference implementation)
// ---------------------------------------------------------------------------

namespace {
struct HeapItem {
  double dist;
  int node;
  bool operator<(const HeapItem& o) const { return dist > o.dist; }
};
}  // namespace

extern "C" int emd_solve_ssp(int n, int m, const double* mu, const double* nu,
                             const double* cost, double* plan) {
  const int V = n + m;
  std::vector<double> supply(mu, mu + n);
  std::vector<double> demand(nu, nu + m);

  double total_s = 0, total_d = 0;
  for (int i = 0; i < n; ++i) total_s += supply[i];
  for (int j = 0; j < m; ++j) total_d += demand[j];
  if (std::fabs(total_s - total_d) > 1e-6 * std::max(total_s, total_d)) return 1;

  std::memset(plan, 0, sizeof(double) * static_cast<size_t>(n) * m);

  // Node potentials keep reduced costs nonnegative so Dijkstra stays valid.
  std::vector<double> pot(V, 0.0);
  std::vector<double> dist(V);
  std::vector<int> prev(V);  // predecessor node along the shortest path
  std::vector<char> active_src(n), active_dst(m);

  const double eps = 1e-15 * std::max(1.0, total_s);

  while (true) {
    int n_src = 0;
    for (int i = 0; i < n; ++i) active_src[i] = supply[i] > eps, n_src += active_src[i];
    int n_dst = 0;
    for (int j = 0; j < m; ++j) active_dst[j] = demand[j] > eps, n_dst += active_dst[j];
    if (n_src == 0 || n_dst == 0) break;

    // Multi-source Dijkstra from all active sources over the residual graph,
    // on reduced costs (arcs carrying flow have reduced cost exactly 0 by
    // complementary slackness, so their backward arcs cost 0 too).
    std::fill(dist.begin(), dist.end(), kInf);
    std::fill(prev.begin(), prev.end(), -1);
    std::priority_queue<HeapItem> heap;
    for (int i = 0; i < n; ++i) {
      if (active_src[i]) {
        dist[i] = 0.0;
        heap.push({0.0, i});
      }
    }
    while (!heap.empty()) {
      HeapItem top = heap.top();
      heap.pop();
      int u = top.node;
      if (top.dist > dist[u] + 1e-18) continue;
      if (u < n) {
        // forward arcs u -> all sinks
        const double* crow = cost + static_cast<size_t>(u) * m;
        for (int j = 0; j < m; ++j) {
          double rc = crow[j] + pot[u] - pot[n + j];
          double nd = dist[u] + (rc > 0 ? rc : 0);
          if (nd + 1e-18 < dist[n + j]) {
            dist[n + j] = nd;
            prev[n + j] = u;
            heap.push({nd, n + j});
          }
        }
      } else {
        // backward arcs sink -> sources with positive flow (reduced cost 0)
        int j = u - n;
        for (int i = 0; i < n; ++i) {
          if (plan[static_cast<size_t>(i) * m + j] > eps) {
            double rc = -(cost[static_cast<size_t>(i) * m + j] + pot[i] - pot[n + j]);
            double nd = dist[u] + (rc > 0 ? rc : 0);
            if (nd + 1e-18 < dist[i]) {
              dist[i] = nd;
              prev[i] = u;
              heap.push({nd, i});
            }
          }
        }
      }
    }
    int reached_sink = -1;
    double best = kInf;
    for (int j = 0; j < m; ++j) {
      if (active_dst[j] && dist[n + j] < best) {
        best = dist[n + j];
        reached_sink = j;
      }
    }
    if (reached_sink < 0) return 2;  // disconnected (should not happen)

    // Update potentials (cap at the chosen sink's distance so unreachable /
    // farther nodes keep valid potentials).
    for (int v = 0; v < V; ++v) {
      pot[v] += std::min(dist[v], best);
    }

    // Trace the path back, find the bottleneck.
    int sink = n + reached_sink;
    double bottleneck = demand[reached_sink];
    for (int v = sink; prev[v] != -1; v = prev[v]) {
      int u = prev[v];
      if (u >= n) {  // backward arc v(source) <- u(sink): limited by flow
        bottleneck = std::min(bottleneck, plan[static_cast<size_t>(v) * m + (u - n)]);
      }
    }
    {
      // path root is a source
      int v = sink;
      while (prev[v] != -1) v = prev[v];
      bottleneck = std::min(bottleneck, supply[v]);
    }

    // Apply the augmentation.
    for (int v = sink; prev[v] != -1; v = prev[v]) {
      int u = prev[v];
      if (u < n) {  // forward arc u(source) -> v(sink)
        plan[static_cast<size_t>(u) * m + (v - n)] += bottleneck;
      } else {  // backward arc u(sink) -> v(source): reduce flow v->u
        plan[static_cast<size_t>(v) * m + (u - n)] -= bottleneck;
      }
    }
    {
      int v = sink;
      while (prev[v] != -1) v = prev[v];
      supply[v] -= bottleneck;
    }
    demand[reached_sink] -= bottleneck;
  }
  return 0;
}
