// Native host-side runtime for pangulu_jax.
//
// C++ implementations of the sequential, correctness-critical host
// pipeline pieces whose Python versions do not scale: elimination
// tree (Liu), symbolic fill enumeration (row-subtree traversal),
// approximate-minimum-degree ordering, and the MC64 job-5
// max-product bipartite matching with dual-variable scalings
// (functional counterpart of the reference's pangulu_mc64,
// pangulu_reordering.c:149-681, and pangulu_symbolic.c:132-248).
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this
// environment).  All index arrays are int64 unless noted.

#include <algorithm>
#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

extern "C" {

// ABI version stamp: the ctypes loader rebuilds the .so when this does
// not match (a stale binary from an older source otherwise survives
// because the loader only builds when the file is absent).
int64_t pangulu_abi_version() { return 5; }

// ---------------------------------------------------------------------------
// Elimination tree (Liu's algorithm) on a symmetric pattern in CSR.
// ---------------------------------------------------------------------------
void pangulu_etree(int64_t n, const int64_t* indptr, const int32_t* indices,
                   int64_t* parent) {
  std::vector<int64_t> ancestor(n, -1);
  for (int64_t i = 0; i < n; ++i) parent[i] = -1;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t j = indices[p];
      if (j >= i) continue;
      while (ancestor[j] != -1 && ancestor[j] != i) {
        int64_t t = ancestor[j];
        ancestor[j] = i;
        j = t;
      }
      if (ancestor[j] == -1) {
        ancestor[j] = i;
        parent[j] = i;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Fill enumeration: count |strict lower L| and mark nb-blocks.
// block_mark is a bl*bl row-major uint8 array (bl = ceil(n/nb)).
// Returns the strict-lower fill count.
// ---------------------------------------------------------------------------
int64_t pangulu_fill_walk(int64_t n, const int64_t* indptr,
                          const int32_t* indices, const int64_t* parent,
                          int64_t nb, uint8_t* block_mark, int64_t bl) {
  std::vector<int64_t> visited(n, -1);
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    visited[i] = i;
    const int64_t bi = i / nb;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t j = indices[p];
      if (j >= i) continue;
      while (visited[j] != i) {
        visited[j] = i;
        ++count;
        if (block_mark) block_mark[bi * bl + j / nb] = 1;
        j = parent[j];
        if (j == -1 || j >= i) break;
      }
    }
  }
  return count;
}

// Variant also filling colcnt[j] = |{i > j : L(i,j) != 0}| (strictly-
// lower per-column fill counts) — the inputs to the exact sparse LU
// flop model (reference counts the same intersections at run time,
// pangulu_kernel_interface.c:4-178; we count them once symbolically).
int64_t pangulu_fill_walk_counts(int64_t n, const int64_t* indptr,
                                 const int32_t* indices,
                                 const int64_t* parent, int64_t nb,
                                 uint8_t* block_mark, int64_t bl,
                                 int64_t* colcnt) {
  std::vector<int64_t> visited(n, -1);
  for (int64_t j = 0; j < n; ++j) colcnt[j] = 0;
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    visited[i] = i;
    const int64_t bi = i / nb;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t j = indices[p];
      if (j >= i) continue;
      while (visited[j] != i) {
        visited[j] = i;
        ++count;
        ++colcnt[j];
        if (block_mark) block_mark[bi * bl + j / nb] = 1;
        j = parent[j];
        if (j == -1 || j >= i) break;
      }
    }
  }
  return count;
}

// Emit every strictly-lower fill entry (i, j) of L (original + fill).
// Caller sizes out_i/out_j from a prior pangulu_fill_walk count.
// Returns the number written.
int64_t pangulu_fill_entries(int64_t n, const int64_t* indptr,
                             const int32_t* indices, const int64_t* parent,
                             int32_t* out_i, int32_t* out_j) {
  std::vector<int64_t> visited(n, -1);
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    visited[i] = i;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t j = indices[p];
      if (j >= i) continue;
      while (visited[j] != i) {
        visited[j] = i;
        out_i[k] = static_cast<int32_t>(i);
        out_j[k] = static_cast<int32_t>(j);
        ++k;
        j = parent[j];
        if (j == -1 || j >= i) break;
      }
    }
  }
  return k;
}

// ---------------------------------------------------------------------------
// Approximate minimum degree ordering (quotient graph, AMD-style
// approximate external degrees, element absorption).  Pattern must be
// symmetric CSR without requiring sorted rows; self loops ignored.
// ---------------------------------------------------------------------------
namespace {
struct MinDeg {
  int64_t n;
  // adjacency storage: per-vertex list of (live vertex) neighbours and
  // element ids; rebuilt lazily on elimination.
  std::vector<std::vector<int64_t>> adj;    // original live neighbours
  std::vector<std::vector<int64_t>> elems;  // adjacent element ids
  std::vector<std::vector<int64_t>> members; // element id -> reach
  std::vector<char> alive;
  std::vector<int64_t> degree;
  std::vector<int64_t> stamp;
  int64_t stamp_cur = 0;

  explicit MinDeg(int64_t n_) : n(n_), adj(n_), elems(n_), members(n_),
                                alive(n_, 1), degree(n_, 0), stamp(n_, -1) {}

  void mark_begin() { ++stamp_cur; }
  bool marked(int64_t v) const { return stamp[v] == stamp_cur; }
  void mark(int64_t v) { stamp[v] = stamp_cur; }
};
}  // namespace

void pangulu_mindeg(int64_t n, const int64_t* indptr, const int32_t* indices,
                    int64_t* order) {
  MinDeg g(n);
  for (int64_t i = 0; i < n; ++i) {
    auto& a = g.adj[i];
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t j = indices[p];
      if (j != i) a.push_back(j);
    }
    std::sort(a.begin(), a.end());
    a.erase(std::unique(a.begin(), a.end()), a.end());
    g.degree[i] = static_cast<int64_t>(a.size());
  }
  using Node = std::pair<int64_t, int64_t>;  // (degree, vertex)
  std::priority_queue<Node, std::vector<Node>, std::greater<Node>> heap;
  for (int64_t i = 0; i < n; ++i) heap.emplace(g.degree[i], i);

  // second stamp set for absorbed-element membership tests (the first
  // marks the reach); O(1) per element instead of a nested scan
  std::vector<int64_t> estamp(n, -1);
  int64_t estamp_cur = 0;

  std::vector<int64_t> reach;
  int64_t pos = 0;
  int64_t live = n;
  while (!heap.empty()) {
    auto [d, v] = heap.top();
    heap.pop();
    if (!g.alive[v] || d != g.degree[v]) continue;
    // Reach(v) = live adj(v) ∪ members of adjacent elements.
    g.mark_begin();
    g.mark(v);
    reach.clear();
    for (int64_t u : g.adj[v])
      if (g.alive[u] && !g.marked(u)) { g.mark(u); reach.push_back(u); }
    for (int64_t e : g.elems[v])
      for (int64_t u : g.members[e])
        if (g.alive[u] && !g.marked(u)) { g.mark(u); reach.push_back(u); }

    order[pos++] = v;
    g.alive[v] = 0;
    --live;

    // DENSE-PHASE SHORTCUT: v adjacent to every live vertex means the
    // remainder is a clique after this elimination — any order of the
    // rest is fill-optimal.  This is what makes expander-like graphs
    // (where fill densifies fast) terminate in near-linear time
    // instead of churning a dense quotient graph.
    if (static_cast<int64_t>(reach.size()) >= live && live > 0) {
      std::sort(reach.begin(), reach.end());
      for (int64_t u : reach)
        if (!g.alive[u]) continue; else { order[pos++] = u; g.alive[u] = 0; }
      break;
    }

    // v becomes element v absorbing its adjacent elements.
    ++estamp_cur;
    for (int64_t e : g.elems[v]) {
      estamp[e] = estamp_cur;  // mark absorbed
      g.members[e].clear();
      g.members[e].shrink_to_fit();
    }
    g.members[v] = reach;
    for (int64_t u : reach) {
      // drop absorbed elements from u's list (stamp test, O(|eu|))
      auto& eu = g.elems[u];
      size_t w = 0;
      for (int64_t e : eu)
        if (estamp[e] != estamp_cur) eu[w++] = e;
      eu.resize(w);
      eu.push_back(v);
      // approximate degree: |live adj| + sum of member counts (AMD
      // overcount), minus self.
      int64_t deg = 0;
      for (int64_t x : g.adj[u]) if (g.alive[x]) ++deg;
      int64_t seen = 0;
      for (int64_t e : eu) seen += static_cast<int64_t>(g.members[e].size());
      g.degree[u] = deg + std::max<int64_t>(seen - 1, 0);
      heap.emplace(g.degree[u], u);
    }
    g.elems[v].clear();
    g.elems[v].shrink_to_fit();
  }
  // defensive completeness (isolated vertices never reached, etc.)
  if (pos != n) {
    std::vector<char> used(n, 0);
    for (int64_t i = 0; i < pos; ++i) used[order[i]] = 1;
    for (int64_t v = 0; v < n && pos < n; ++v)
      if (!used[v]) order[pos++] = v;
  }
}

// ---------------------------------------------------------------------------
// Multilevel nested dissection (the reference's METIS_NodeND role,
// pangulu_reordering.c:1080).  Same algorithmic skeleton as METIS:
// per recursion level a MULTILEVEL edge bisection — heavy-edge-matching
// coarsening, graph-growing initial bisection on the coarsest graph,
// greedy boundary (FM-style) refinement during uncoarsening — then a
// vertex separator covering the cut, recursion on the two parts, and
// minimum-degree ordering on small leaves (METIS uses MMD there).
// Original algorithm implementation; no METIS code consulted.
// ---------------------------------------------------------------------------
namespace nd {

struct Graph {
  int64_t n = 0;
  std::vector<int64_t> xadj;
  std::vector<int32_t> adj;
  std::vector<int64_t> ewgt;
  std::vector<int64_t> vwgt;
};

inline uint64_t xrand(uint64_t* s) {
  *s ^= *s << 13; *s ^= *s >> 7; *s ^= *s << 17;
  return *s;
}

// Heavy-edge matching; fills cmap with coarse ids, returns coarse n.
static int64_t hem_match(const Graph& g, std::vector<int64_t>& cmap,
                         uint64_t* seed) {
  std::vector<int64_t> perm(g.n);
  for (int64_t i = 0; i < g.n; ++i) perm[i] = i;
  for (int64_t i = g.n - 1; i > 0; --i)
    std::swap(perm[i], perm[xrand(seed) % (i + 1)]);
  cmap.assign(g.n, -1);
  int64_t nc = 0;
  for (int64_t idx = 0; idx < g.n; ++idx) {
    const int64_t v = perm[idx];
    if (cmap[v] != -1) continue;
    int64_t best = -1, bw = -1;
    for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
      const int64_t u = g.adj[p];
      if (u != v && cmap[u] == -1 && g.ewgt[p] > bw) {
        bw = g.ewgt[p];
        best = u;
      }
    }
    cmap[v] = nc;
    if (best != -1) cmap[best] = nc;
    ++nc;
  }
  return nc;
}

static Graph contract(const Graph& g, const std::vector<int64_t>& cmap,
                      int64_t nc) {
  Graph c;
  c.n = nc;
  c.vwgt.assign(nc, 0);
  for (int64_t v = 0; v < g.n; ++v) c.vwgt[cmap[v]] += g.vwgt[v];
  std::vector<int64_t> head(nc, -1), nxt(g.n);
  for (int64_t v = 0; v < g.n; ++v) {
    nxt[v] = head[cmap[v]];
    head[cmap[v]] = v;
  }
  c.xadj.assign(nc + 1, 0);
  std::vector<int64_t> mark(nc, -1), at(nc);
  for (int64_t cv = 0; cv < nc; ++cv) {
    for (int64_t v = head[cv]; v != -1; v = nxt[v])
      for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
        const int64_t cu = cmap[g.adj[p]];
        if (cu == cv) continue;
        if (mark[cu] != cv) {
          mark[cu] = cv;
          at[cu] = static_cast<int64_t>(c.adj.size());
          c.adj.push_back(static_cast<int32_t>(cu));
          c.ewgt.push_back(g.ewgt[p]);
        } else {
          c.ewgt[at[cu]] += g.ewgt[p];
        }
      }
    c.xadj[cv + 1] = static_cast<int64_t>(c.adj.size());
  }
  return c;
}

static int64_t cut_of(const Graph& g, const std::vector<int8_t>& part) {
  int64_t cut = 0;
  for (int64_t v = 0; v < g.n; ++v)
    for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p)
      if (part[g.adj[p]] != part[v]) cut += g.ewgt[p];
  return cut / 2;
}

// Greedy boundary refinement: move positive-gain boundary vertices
// while both sides stay within the balance envelope; a balance pass
// first if a side exceeds it.  Several sweeps (multilevel projection
// leaves mostly-local errors, so sweeps converge fast).
static void refine(const Graph& g, std::vector<int8_t>& part,
                   int passes = 6) {
  int64_t tot = 0;
  for (int64_t w : g.vwgt) tot += w;
  int64_t w0 = 0;
  for (int64_t v = 0; v < g.n; ++v)
    if (part[v] == 0) w0 += g.vwgt[v];
  const int64_t hi = static_cast<int64_t>(tot * 0.60);
  const int64_t lo = tot - hi;
  auto gain_of = [&](int64_t v) {
    int64_t same = 0, other = 0;
    for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p)
      (part[g.adj[p]] == part[v] ? same : other) += g.ewgt[p];
    return other - same;
  };
  for (int pass = 0; pass < passes; ++pass) {
    bool moved = false;
    // rebalance if needed: move best-gain vertices off the heavy side.
    // Every accepted move must strictly shrink the imbalance (coarse
    // vertices heavier than the balance band would otherwise oscillate
    // between sides forever), and a move-count guard bounds the loop.
    int64_t guard = g.n + 8;
    while ((w0 > hi || w0 < lo) && guard-- > 0) {
      const int8_t from = (w0 > hi) ? 0 : 1;
      const int64_t imb = std::llabs(2 * w0 - tot);
      int64_t best = -1, bg = std::numeric_limits<int64_t>::min();
      for (int64_t v = 0; v < g.n; ++v)
        if (part[v] == from) {
          const int64_t nw0 =
              w0 + ((from == 0) ? -g.vwgt[v] : g.vwgt[v]);
          if (std::llabs(2 * nw0 - tot) >= imb) continue;
          const int64_t gn = gain_of(v);
          if (gn > bg) { bg = gn; best = v; }
        }
      if (best < 0) break;
      part[best] = static_cast<int8_t>(1 - from);
      w0 += (from == 0) ? -g.vwgt[best] : g.vwgt[best];
      moved = true;
    }
    // FM pass: move best-gain vertices (negative gains allowed — hill
    // climbing), lock each moved vertex, track the best prefix and
    // roll back past it.  This is what recovers smooth separators
    // after multilevel projection; greedy positive-only refinement
    // cannot cross the small barriers between local optima.
    std::vector<int64_t> gain(g.n);
    for (int64_t v = 0; v < g.n; ++v) gain[v] = gain_of(v);
    using QN = std::pair<int64_t, int64_t>;  // (gain, vertex)
    std::priority_queue<QN> pq;
    for (int64_t v = 0; v < g.n; ++v)
      for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p)
        if (part[g.adj[p]] != part[v]) { pq.emplace(gain[v], v); break; }
    std::vector<char> locked(g.n, 0);
    std::vector<int64_t> trail;
    int64_t cur = 0, best_val = 0, best_len = 0, since_best = 0;
    const int64_t climb_limit = 64;
    int64_t w0_run = w0;
    while (!pq.empty() && since_best < climb_limit) {
      auto [gn, v] = pq.top();
      pq.pop();
      if (locked[v] || gn != gain[v]) continue;
      const int8_t from = part[v];
      const int64_t nw0 =
          w0_run + ((from == 0) ? -g.vwgt[v] : g.vwgt[v]);
      if (nw0 > hi || nw0 < lo) continue;
      part[v] = static_cast<int8_t>(1 - from);
      locked[v] = 1;
      w0_run = nw0;
      trail.push_back(v);
      cur -= gn;  // cut after this move
      if (cur < best_val) {
        best_val = cur;
        best_len = static_cast<int64_t>(trail.size());
        since_best = 0;
      } else {
        ++since_best;
      }
      for (int64_t p = g.xadj[v]; p < g.xadj[v + 1]; ++p) {
        const int64_t u = g.adj[p];
        if (locked[u]) continue;
        gain[u] += (part[u] == from) ? 2 * g.ewgt[p] : -2 * g.ewgt[p];
        pq.emplace(gain[u], u);
      }
    }
    // roll back past the best prefix
    for (int64_t i = static_cast<int64_t>(trail.size()) - 1;
         i >= best_len; --i)
      part[trail[i]] = static_cast<int8_t>(1 - part[trail[i]]);
    // recompute w0 exactly (cheap, and immune to rollback bookkeeping)
    w0 = 0;
    for (int64_t v = 0; v < g.n; ++v)
      if (part[v] == 0) w0 += g.vwgt[v];
    if (best_len > 0) moved = true;
    if (!moved) break;
  }
}

// Graph-growing initial bisection on the coarsest graph: BFS from a
// random seed accumulating vertex weight to half; a few tries, best
// refined cut kept.
static void init_bisect(const Graph& g, std::vector<int8_t>& part,
                        uint64_t* seed) {
  int64_t tot = 0;
  for (int64_t w : g.vwgt) tot += w;
  std::vector<int8_t> best;
  int64_t best_cut = std::numeric_limits<int64_t>::max();
  for (int t = 0; t < 4; ++t) {
    std::vector<int8_t> p(g.n, 1);
    std::vector<int64_t> q;
    std::vector<char> seen(g.n, 0);
    int64_t start = static_cast<int64_t>(xrand(seed) % g.n);
    q.push_back(start);
    seen[start] = 1;
    int64_t w0 = 0;
    size_t qh = 0;
    while (w0 * 2 < tot) {
      if (qh == q.size()) {  // disconnected: jump to an unseen vertex
        int64_t nxt = -1;
        for (int64_t v = 0; v < g.n; ++v)
          if (!seen[v]) { nxt = v; break; }
        if (nxt < 0) break;
        q.push_back(nxt);
        seen[nxt] = 1;
      }
      const int64_t v = q[qh++];
      p[v] = 0;
      w0 += g.vwgt[v];
      for (int64_t e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
        const int32_t u = g.adj[e];
        if (!seen[u]) { seen[u] = 1; q.push_back(u); }
      }
    }
    refine(g, p);
    const int64_t c = cut_of(g, p);
    if (c < best_cut) { best_cut = c; best = p; }
  }
  part = best;
}

// Multilevel edge bisection of g into part 0/1.
static void ml_bisect(const Graph& g0, std::vector<int8_t>& part,
                      uint64_t* seed) {
  const int64_t kCoarsest = 96;
  std::vector<Graph> graphs;
  std::vector<std::vector<int64_t>> cmaps;
  graphs.push_back(g0);
  while (graphs.back().n > kCoarsest) {
    std::vector<int64_t> cmap;
    const int64_t nc = hem_match(graphs.back(), cmap, seed);
    if (nc > graphs.back().n * 95 / 100) break;  // matching stalled
    graphs.push_back(contract(graphs.back(), cmap, nc));
    cmaps.push_back(std::move(cmap));
  }
  std::vector<int8_t> p;
  init_bisect(graphs.back(), p, seed);
  for (int64_t i = static_cast<int64_t>(cmaps.size()) - 1; i >= 0; --i) {
    std::vector<int8_t> fine(graphs[i].n);
    for (int64_t v = 0; v < graphs[i].n; ++v) fine[v] = p[cmaps[i][v]];
    refine(graphs[i], fine);
    p = std::move(fine);
  }
  part = std::move(p);
}

// Extract the subgraph induced by nodes (unit weights at every level:
// separator quality at the FINE grain is what matters for fill).
static Graph subgraph(const int64_t* indptr, const int32_t* indices,
                      const std::vector<int64_t>& nodes,
                      std::vector<int64_t>& inv, int64_t n_total) {
  Graph s;
  s.n = static_cast<int64_t>(nodes.size());
  for (int64_t i = 0; i < s.n; ++i) inv[nodes[i]] = i;
  s.xadj.assign(s.n + 1, 0);
  s.vwgt.assign(s.n, 1);
  for (int64_t i = 0; i < s.n; ++i) {
    const int64_t v = nodes[i];
    for (int64_t p = indptr[v]; p < indptr[v + 1]; ++p) {
      const int32_t u = indices[p];
      if (u == v) continue;
      const int64_t lu = inv[u];
      if (lu >= 0 && lu < s.n && nodes[lu] == u) {
        s.adj.push_back(static_cast<int32_t>(lu));
        s.ewgt.push_back(1);
      }
    }
    s.xadj[i + 1] = static_cast<int64_t>(s.adj.size());
  }
  return s;
}

}  // namespace nd

// Multilevel nested dissection ordering: order[k] = original index of
// the k-th pivot.  leaf_size-sized leaves fall back to pangulu_mindeg.
void pangulu_mindeg(int64_t n, const int64_t* indptr, const int32_t* indices,
                    int64_t* order);  // fwd decl (defined above)
void pangulu_ndorder_aligned(int64_t n, const int64_t* indptr,
                             const int32_t* indices, int64_t leaf_size,
                             int64_t align_nb, int64_t* order);

void pangulu_ndorder(int64_t n, const int64_t* indptr,
                     const int32_t* indices, int64_t leaf_size,
                     int64_t* order) {
  pangulu_ndorder_aligned(n, indptr, indices, leaf_size, 0, order);
}

// align_nb > 1: force |A| to a multiple of align_nb at every split of
// a part >= 3*align_nb (remainder boundary vertices join the
// separator).  Parts then start at block-aligned offsets, so disjoint
// subtrees occupy DISJOINT nb-blocks and the block-level dependency
// DAG keeps the elimination tree's parallelism (super-level batching,
// Schedule.superlevels) — unaligned parts straddle blocks and the
// straddling tile columns serialize the subtrees.
void pangulu_ndorder_aligned(int64_t n, const int64_t* indptr,
                             const int32_t* indices, int64_t leaf_size,
                             int64_t align_nb, int64_t* order) {
  if (leaf_size < 32) leaf_size = 32;
  uint64_t seed = 0x9E3779B97F4A7C15ull;
  std::vector<int64_t> inv(n, -1);  // shared scratch: global -> local id
  int64_t pos = 0;

  // explicit recursion: entries are (nodes, emit) — emit entries dump
  // their nodes (separators) in the stored order
  struct Task {
    std::vector<int64_t> nodes;
    bool emit;
  };
  std::vector<Task> stack;
  {
    std::vector<int64_t> all(n);
    for (int64_t i = 0; i < n; ++i) all[i] = i;
    stack.push_back({std::move(all), false});
  }

  auto leaf = [&](const std::vector<int64_t>& nodes) {
    nd::Graph s = nd::subgraph(indptr, indices, nodes, inv, n);
    std::vector<int64_t> sub_order(s.n);
    // mindeg wants CSR arrays
    pangulu_mindeg(s.n, s.xadj.data(), s.adj.data(), sub_order.data());
    for (int64_t i = 0; i < s.n; ++i) order[pos++] = nodes[sub_order[i]];
  };

  while (!stack.empty()) {
    Task t = std::move(stack.back());
    stack.pop_back();
    if (t.emit) {
      for (int64_t v : t.nodes) order[pos++] = v;
      continue;
    }
    if (static_cast<int64_t>(t.nodes.size()) <= leaf_size) {
      leaf(t.nodes);
      continue;
    }
    nd::Graph s = nd::subgraph(indptr, indices, t.nodes, inv, n);
    std::vector<int8_t> part;
    nd::ml_bisect(s, part, &seed);
    // vertex separator: the smaller boundary side covers every cut edge
    std::vector<char> bnd(s.n, 0);
    int64_t b0 = 0, b1 = 0;
    for (int64_t v = 0; v < s.n; ++v)
      for (int64_t p = s.xadj[v]; p < s.xadj[v + 1]; ++p)
        if (part[s.adj[p]] != part[v]) {
          if (!bnd[v]) {
            bnd[v] = 1;
            (part[v] == 0 ? b0 : b1)++;
          }
          break;
        }
    const int8_t sep_side = (b0 <= b1) ? 0 : 1;
    // side: 0 = A, 1 = B, 2 = separator
    std::vector<int8_t> side(s.n);
    for (int64_t v = 0; v < s.n; ++v)
      side[v] = (bnd[v] && part[v] == sep_side) ? 2 : part[v];
    // separator THINNING: a separator vertex with no neighbour in one
    // part can rejoin the other part — the one-side cover is a crude
    // superset, and separator size is the dominant fill driver
    for (int round = 0; round < 4; ++round) {
      bool changed = false;
      for (int64_t v = 0; v < s.n; ++v) {
        if (side[v] != 2) continue;
        bool in_a = false, in_b = false;
        for (int64_t p = s.xadj[v]; p < s.xadj[v + 1]; ++p) {
          const int8_t su = side[s.adj[p]];
          in_a |= (su == 0);
          in_b |= (su == 1);
        }
        if (!in_b) { side[v] = 0; changed = true; }
        else if (!in_a) { side[v] = 1; changed = true; }
      }
      if (!changed) break;
    }
    // nb-alignment: shrink A to a multiple of align_nb by moving its
    // remainder (preferring vertices already adjacent to the
    // separator) into the separator
    if (align_nb > 1 &&
        static_cast<int64_t>(t.nodes.size()) >= 3 * align_nb) {
      int64_t na = 0;
      for (int64_t v = 0; v < s.n; ++v) na += (side[v] == 0);
      int64_t r = na % align_nb;
      if (r > 0 && na - r >= align_nb) {
        // pass 1: A vertices adjacent to S; pass 2: any A vertex
        for (int pass = 0; pass < 2 && r > 0; ++pass)
          for (int64_t v = 0; v < s.n && r > 0; ++v) {
            if (side[v] != 0) continue;
            if (pass == 0) {
              bool near_s = false;
              for (int64_t p = s.xadj[v]; p < s.xadj[v + 1]; ++p)
                if (side[s.adj[p]] == 2) { near_s = true; break; }
              if (!near_s) continue;
            }
            side[v] = 2;
            --r;
          }
      }
    }
    std::vector<int64_t> a_part, b_part, s_part;
    for (int64_t v = 0; v < s.n; ++v) {
      if (side[v] == 2) s_part.push_back(t.nodes[v]);
      else if (side[v] == 0) a_part.push_back(t.nodes[v]);
      else b_part.push_back(t.nodes[v]);
    }
    if (a_part.empty() || b_part.empty()) {
      leaf(t.nodes);  // bisection degenerated (dense/tiny-diameter)
      continue;
    }
    if (!s_part.empty())
      stack.push_back({std::move(s_part), true});  // eliminated last
    stack.push_back({std::move(b_part), false});
    stack.push_back({std::move(a_part), false});
  }
  // pos == n by construction; defensive: fill any gap as identity
  if (pos != n) {
    std::vector<char> used(n, 0);
    for (int64_t i = 0; i < pos; ++i) used[order[i]] = 1;
    for (int64_t v = 0; v < n && pos < n; ++v)
      if (!used[v]) order[pos++] = v;
  }
}

// ---------------------------------------------------------------------------
// MC64 job 5: max-product perfect matching + scalings.
//
// Cost c[i][j] = log(colmax_j) - log|a_ij| >= 0; find a perfect
// matching minimizing total cost via shortest augmenting paths with
// potentials (Dijkstra, binary heap) — the same optimization problem
// the reference solves (pangulu_reordering.c:387-587).  Outputs
// colperm (column j of the permuted matrix = original column
// colperm[j] pairing with row j), and dual-based scalings
// row_scale[i] = exp(u_i), col_scale[j] = exp(v_j)/colmax_j so the
// scaled+permuted matrix has unit diagonal and all |entries| <= 1
// (reference: exp() factors at pangulu_reordering.c:655-663).
// Returns 0 on success, 1 if structurally singular.
// ---------------------------------------------------------------------------
int pangulu_mc64(int64_t n, const int64_t* colptr, const int32_t* rowidx,
                 const double* absval, int64_t* colperm, double* row_scale,
                 double* col_scale) {
  const double INF = std::numeric_limits<double>::infinity();
  const int64_t nnz = colptr[n];
  // Build CSR with costs: c[i][j] = log(colmax_j) - log|a_ij|.
  std::vector<double> logmax(n, 0.0);
  for (int64_t j = 0; j < n; ++j) {
    double m = 0.0;
    for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p)
      m = std::max(m, absval[p]);
    logmax[j] = (m > 0.0) ? std::log(m) : 0.0;
  }
  std::vector<int64_t> rptr(n + 1, 0);
  for (int64_t p = 0; p < nnz; ++p) ++rptr[rowidx[p] + 1];
  for (int64_t i = 0; i < n; ++i) rptr[i + 1] += rptr[i];
  std::vector<int32_t> rcol(nnz);
  std::vector<double> rcost(nnz);
  {
    std::vector<int64_t> w(rptr.begin(), rptr.end() - 1);
    for (int64_t j = 0; j < n; ++j)
      for (int64_t p = colptr[j]; p < colptr[j + 1]; ++p) {
        const int64_t i = rowidx[p];
        const int64_t q = w[i]++;
        rcol[q] = static_cast<int32_t>(j);
        rcost[q] = (absval[p] > 0.0) ? logmax[j] - std::log(absval[p]) : INF;
      }
  }

  // Sparse Jonker-Volgenant: assign each row via shortest augmenting
  // path over columns.  Only column potentials v are stored; a matched
  // row's potential is implicit from its tight edge
  // (u_r = c(r, j_match) - v[j_match]) — the lapjvsp formulation.
  std::vector<double> v(n, 0.0);
  std::vector<int64_t> row2col(n, -1), col2row(n, -1);
  std::vector<double> dist(n);
  std::vector<int64_t> pred(n);      // predecessor row of column j
  // timestamp validity instead of per-row O(n) refills (the refills
  // made the whole matching O(n^2): 35 s at n=262k, ~1 s with stamps)
  std::vector<int64_t> stamp_d(n, -1), stamp_f(n, -1);
  std::vector<int64_t> touched;
  using QN = std::pair<double, int64_t>;  // (dist, column)

  // Greedy zero-cost pre-match (the reference's initial-extreme-match
  // phase, pangulu_reordering.c:261-288): each column's max entry has
  // cost exactly 0, so matching it is optimal while columns are free.
  for (int64_t r = 0; r < n; ++r)
    for (int64_t p = rptr[r]; p < rptr[r + 1]; ++p) {
      const int64_t j = rcol[p];
      if (rcost[p] == 0.0 && col2row[j] == -1) {
        row2col[r] = j;
        col2row[j] = r;
        break;
      }
    }

  for (int64_t r0 = 0; r0 < n; ++r0) {
    if (row2col[r0] != -1) continue;  // pre-matched
    touched.clear();
    std::priority_queue<QN, std::vector<QN>, std::greater<QN>> pq;
    for (int64_t p = rptr[r0]; p < rptr[r0 + 1]; ++p) {
      const int64_t j = rcol[p];
      const double d = rcost[p] - v[j];
      if (stamp_d[j] != r0 || d < dist[j]) {
        dist[j] = d; stamp_d[j] = r0; pred[j] = r0; pq.emplace(d, j);
      }
    }
    int64_t sink = -1;
    double lsp = INF;
    while (!pq.empty()) {
      auto [d, j] = pq.top();
      pq.pop();
      if (stamp_f[j] == r0 || d > dist[j]) continue;
      stamp_f[j] = r0;
      touched.push_back(j);
      if (col2row[j] == -1) { sink = j; lsp = d; break; }
      const int64_t r = col2row[j];
      // implicit row potential from the tight matched edge (r, j)
      double ur = 0.0;
      for (int64_t p = rptr[r]; p < rptr[r + 1]; ++p)
        if (rcol[p] == j) { ur = rcost[p] - v[j]; break; }
      for (int64_t p = rptr[r]; p < rptr[r + 1]; ++p) {
        const int64_t j2 = rcol[p];
        if (stamp_f[j2] == r0) continue;
        const double nd = d + (rcost[p] - ur - v[j2]);
        if (stamp_d[j2] != r0 || nd < dist[j2]) {
          dist[j2] = nd; stamp_d[j2] = r0; pred[j2] = r;
          pq.emplace(nd, j2);
        }
      }
    }
    if (sink == -1) return 1;  // structurally singular
    // Dual update on finalized columns, then augment.
    for (int64_t j : touched)
      if (j != sink) v[j] += dist[j] - lsp;
    int64_t j = sink;
    while (true) {
      const int64_t r = pred[j];
      const int64_t jnext = row2col[r];
      row2col[r] = j;
      col2row[j] = r;
      if (r == r0) break;
      j = jnext;
    }
  }

  // Python-layer semantics: A2[:, i] = A1[:, colperm[i]] puts the
  // matched entry of row i on the diagonal -> colperm[i] = row2col[i].
  for (int64_t i = 0; i < n; ++i) colperm[i] = row2col[i];
  for (int64_t i = 0; i < n; ++i) {
    const int64_t jm = row2col[i];
    double ui = 0.0;
    for (int64_t p = rptr[i]; p < rptr[i + 1]; ++p)
      if (rcol[p] == jm) { ui = rcost[p] - v[jm]; break; }
    row_scale[i] = std::exp(ui);
  }
  for (int64_t j = 0; j < n; ++j) col_scale[j] = std::exp(v[j] - logmax[j]);
  return 0;
}

// ---------------------------------------------------------------------------
// Fast MatrixMarket coordinate reader (counterpart of the reference's
// vendored mmio_highlevel.h, examples/mmio*.h — C there, C++ here).
// Two-phase ctypes protocol:
//   pangulu_mmio_probe(path, hdr[5]) -> 0 ok / -1 error
//     hdr = {nrows, ncols, nnz_declared, field, symmetry}
//     field: 0 real, 1 integer, 2 pattern, 3 complex
//     symmetry: 0 general, 1 symmetric, 2 skew-symmetric, 3 hermitian
//   pangulu_mmio_read(path, nnz, rows, cols, re, im) -> count / -1
//     caller allocates nnz-sized arrays; im may be null for real data.
// Symmetry expansion happens in the Python layer (vectorized numpy).
// ---------------------------------------------------------------------------

static int mmio_parse_header(FILE* f, int64_t hdr[5]) {
  char line[1024];
  if (!fgets(line, sizeof line, f)) return -1;
  char obj[64] = {0}, fmt[64] = {0}, fld[64] = {0}, sym[64] = {0};
  if (sscanf(line, "%%%%MatrixMarket %63s %63s %63s %63s",
             obj, fmt, fld, sym) != 4) return -1;
  for (char* p = fld; *p; ++p) *p = (char)tolower(*p);
  for (char* p = sym; *p; ++p) *p = (char)tolower(*p);
  for (char* p = fmt; *p; ++p) *p = (char)tolower(*p);
  if (strcmp(fmt, "coordinate") != 0) return -1;  // dense: python path
  int64_t field;
  if (!strcmp(fld, "real")) field = 0;
  else if (!strcmp(fld, "integer")) field = 1;
  else if (!strcmp(fld, "pattern")) field = 2;
  else if (!strcmp(fld, "complex")) field = 3;
  else return -1;
  int64_t symmetry;
  if (!strcmp(sym, "general")) symmetry = 0;
  else if (!strcmp(sym, "symmetric")) symmetry = 1;
  else if (!strcmp(sym, "skew-symmetric")) symmetry = 2;
  else if (!strcmp(sym, "hermitian")) symmetry = 3;
  else return -1;
  // skip comments, read size line
  while (fgets(line, sizeof line, f)) {
    if (line[0] == '%') continue;
    long long m = 0, n = 0, nz = 0;
    if (sscanf(line, "%lld %lld %lld", &m, &n, &nz) != 3) return -1;
    hdr[0] = m; hdr[1] = n; hdr[2] = nz; hdr[3] = field; hdr[4] = symmetry;
    return 0;
  }
  return -1;
}

int pangulu_mmio_probe(const char* path, int64_t hdr[5]) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  const int rc = mmio_parse_header(f, hdr);
  fclose(f);
  return rc;
}

int64_t pangulu_mmio_read(const char* path, int64_t nnz, int32_t* rows,
                          int32_t* cols, double* re, double* im) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  int64_t hdr[5];
  if (mmio_parse_header(f, hdr) != 0) { fclose(f); return -1; }
  const int64_t field = hdr[3];
  static const size_t kBuf = 1 << 20;
  std::vector<char> buf(kBuf);
  setvbuf(f, buf.data(), _IOFBF, kBuf);
  char line[1024];
  int64_t k = 0;
  while (k < nnz && fgets(line, sizeof line, f)) {
    char* p = line;
    while (*p == ' ' || *p == '\t') ++p;
    if (*p == '%' || *p == '\n' || *p == '\0') continue;
    char* end;
    const long long r = strtoll(p, &end, 10);
    if (end == p) { fclose(f); return -1; }
    p = end;
    const long long c = strtoll(p, &end, 10);
    if (end == p) { fclose(f); return -1; }
    p = end;
    double vre = 1.0, vim = 0.0;
    if (field == 0 || field == 1) {
      vre = strtod(p, &end);
      if (end == p) { fclose(f); return -1; }
    } else if (field == 3) {
      vre = strtod(p, &end);
      if (end == p) { fclose(f); return -1; }
      p = end;
      vim = strtod(p, &end);
      if (end == p) { fclose(f); return -1; }
    }
    rows[k] = (int32_t)(r - 1);  // 1-based -> 0-based
    cols[k] = (int32_t)(c - 1);
    re[k] = vre;
    if (im) im[k] = vim;
    ++k;
  }
  fclose(f);
  return k;
}

}  // extern "C"
