// Graphlet node-orbit counting for generation-quality evaluation.
//
// The reference's dependency chain compiles AutoGraph's ORCA (C++ orbit
// counter) during env setup (reference docs/setup.md:30-36) and uses it for
// generation-quality statistics — never on the training path. This is the
// TPU framework's equivalent host component: per-node induced-subgraph
// orbit counts for all 2-4-node graphlets (ORCA orbits 0-14), consumed by
// glearning_benchmark_tpu/eval/graph_stats.py for MMD distribution
// comparisons between corpora.
//
// Method: bitset adjacency rows + exhaustive triple/quad enumeration with
// degree-sequence classification. Benchmark graphs are <=64 nodes, so
// C(n,3)+C(n,4) enumeration (~250k subsets at n=50) costs ~ms per graph;
// correctness is trivially auditable against the by-hand orbit tables in
// tests/test_graph_stats.py, unlike ORCA's algebraic recurrences.
//
// Orbit ids (Przulj's numbering, same as ORCA):
//   0: edge endpoint (degree)
//   1: P3 end          2: P3 middle
//   3: triangle
//   4: P4 end          5: P4 middle
//   6: 3-star leaf     7: 3-star centre
//   8: C4
//   9: paw tail       10: paw triangle (off-tail)  11: paw triangle (on-tail)
//  12: diamond deg-2  13: diamond deg-3
//  14: K4

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline bool testbit(const uint64_t* row, int32_t j) {
  return (row[j >> 6] >> (j & 63)) & 1ull;
}

}  // namespace

extern "C" {

// Per-node orbit counts for one undirected simple graph.
//   src/dst: n_edges directed-or-undirected pairs; duplicates and both
//            directions are tolerated (the bitset dedups), self-loops are
//            rejected.
//   counts:  caller-zeroed int64 [n_nodes * 15], row-major per node.
// Returns 0 on success, -1 on bad input.
int32_t gstats_orbit_counts(const int32_t* src, const int32_t* dst,
                            int64_t n_edges, int32_t n, int64_t* counts) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  const int32_t words = (n + 63) >> 6;
  std::vector<uint64_t> adj(static_cast<size_t>(n) * words, 0ull);
  for (int64_t e = 0; e < n_edges; ++e) {
    int32_t u = src[e], v = dst[e];
    if (u < 0 || v < 0 || u >= n || v >= n || u == v) return -1;
    adj[static_cast<size_t>(u) * words + (v >> 6)] |= 1ull << (v & 63);
    adj[static_cast<size_t>(v) * words + (u >> 6)] |= 1ull << (u & 63);
  }
  std::vector<int32_t> deg(n, 0);
  for (int32_t u = 0; u < n; ++u) {
    int32_t d = 0;
    for (int32_t w = 0; w < words; ++w)
      d += __builtin_popcountll(adj[static_cast<size_t>(u) * words + w]);
    deg[u] = d;
    counts[static_cast<size_t>(u) * 15 + 0] = d;  // orbit 0
  }

  auto A = [&](int32_t u) { return &adj[static_cast<size_t>(u) * words]; };

  // triples: triangle (orbit 3) / P3 (orbits 1, 2)
  for (int32_t a = 0; a < n; ++a)
    for (int32_t b = a + 1; b < n; ++b) {
      const bool ab = testbit(A(a), b);
      for (int32_t c = b + 1; c < n; ++c) {
        const bool ac = testbit(A(a), c), bc = testbit(A(b), c);
        const int e3 = int(ab) + int(ac) + int(bc);
        if (e3 == 3) {
          counts[size_t(a) * 15 + 3]++;
          counts[size_t(b) * 15 + 3]++;
          counts[size_t(c) * 15 + 3]++;
        } else if (e3 == 2) {
          // middle = the node on both edges
          const int32_t mid = (ab && ac) ? a : (ab && bc) ? b : c;
          for (int32_t x : {a, b, c})
            counts[size_t(x) * 15 + (x == mid ? 2 : 1)]++;
        }
      }
    }

  // quads: classify the induced subgraph by edge count + in-subset degrees
  int32_t q[4];
  for (int32_t a = 0; a < n; ++a)
    for (int32_t b = a + 1; b < n; ++b) {
      const bool ab = testbit(A(a), b);
      for (int32_t c = b + 1; c < n; ++c) {
        const bool ac = testbit(A(a), c), bc = testbit(A(b), c);
        for (int32_t d = c + 1; d < n; ++d) {
          const bool ad = testbit(A(a), d), bd = testbit(A(b), d),
                     cd = testbit(A(c), d);
          const int e4 =
              int(ab) + int(ac) + int(bc) + int(ad) + int(bd) + int(cd);
          if (e4 < 3) continue;  // cannot be connected
          int32_t dg[4] = {int32_t(ab) + int32_t(ac) + int32_t(ad),
                           int32_t(ab) + int32_t(bc) + int32_t(bd),
                           int32_t(ac) + int32_t(bc) + int32_t(cd),
                           int32_t(ad) + int32_t(bd) + int32_t(cd)};
          q[0] = a; q[1] = b; q[2] = c; q[3] = d;
          if (e4 == 6) {                       // K4
            for (int i = 0; i < 4; ++i) counts[size_t(q[i]) * 15 + 14]++;
          } else if (e4 == 5) {                // diamond
            for (int i = 0; i < 4; ++i)
              counts[size_t(q[i]) * 15 + (dg[i] == 3 ? 13 : 12)]++;
          } else if (e4 == 4) {                // C4 or paw
            bool cyc = true;                   // C4 <=> all degrees 2
            for (int i = 0; i < 4; ++i) cyc = cyc && (dg[i] == 2);
            if (cyc) {
              for (int i = 0; i < 4; ++i) counts[size_t(q[i]) * 15 + 8]++;
            } else {                           // paw: degs {1,2,2,3}
              for (int i = 0; i < 4; ++i)
                counts[size_t(q[i]) * 15 +
                       (dg[i] == 1 ? 9 : dg[i] == 3 ? 11 : 10)]++;
            }
          } else {                             // e4 == 3: P4, star, or
                                               // triangle+isolate (skip)
            int mx = 0, iso = 0;
            for (int i = 0; i < 4; ++i) {
              if (dg[i] > mx) mx = dg[i];
              if (dg[i] == 0) iso = 1;
            }
            if (iso) continue;                 // disconnected
            if (mx == 3) {                     // 3-star
              for (int i = 0; i < 4; ++i)
                counts[size_t(q[i]) * 15 + (dg[i] == 3 ? 7 : 6)]++;
            } else {                           // P4: degs {1,2,2,1}
              for (int i = 0; i < 4; ++i)
                counts[size_t(q[i]) * 15 + (dg[i] == 1 ? 4 : 5)]++;
            }
          }
        }
      }
    }
  return 0;
}

// Batch form over a flat edge list: graph g owns edges
// [edge_off[g], edge_off[g+1]) and nodes 0..n_nodes[g)-1; counts is a
// caller-zeroed int64 [sum(n_nodes) * 15] with per-graph rows starting at
// node_off[g]*15. Returns 0, or -(g+1) for the first bad graph.
int32_t gstats_orbit_counts_batch(const int32_t* src, const int32_t* dst,
                                  const int64_t* edge_off,
                                  const int32_t* n_nodes,
                                  const int64_t* node_off, int32_t n_graphs,
                                  int64_t* counts) {
  for (int32_t g = 0; g < n_graphs; ++g) {
    const int64_t e0 = edge_off[g];
    const int32_t rc = gstats_orbit_counts(
        src + e0, dst + e0, edge_off[g + 1] - e0, n_nodes[g],
        counts + node_off[g] * 15);
    if (rc != 0) return -(g + 1);
  }
  return 0;
}

}  // extern "C"
