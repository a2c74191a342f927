// gtok: native host-side tokenization core.
//
// The TPU compute path is JAX/XLA; this library covers the *host* hot loops
// that feed it: SENT trail decomposition (per-graph Hierholzer walks — the
// one serialization stage that resists vectorization) and whitespace text ->
// vocab-id encoding for the graph-token corpora. C ABI, loaded via ctypes
// (no pybind11 in this image). Semantics are bit-identical to the Python
// reference implementations in glearning_benchmark_tpu/tokenization
// (sent.py TrailTokenizer, ibtt.py encode_text) and are cross-checked by
// tests/test_native.py.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <utility>
#include <vector>

namespace {

constexpr int32_t SOS = 0, RESET = 1, LADJ = 2, RADJ = 3, EOS = 4;
constexpr int32_t NUM_SPECIALS = 6;

// Host-side corpus loops are embarrassingly parallel over molecules; shard
// [0, n) across a small thread pool. Thread count from GTOK_THREADS (default
// hardware_concurrency, capped), dropping to 1 for small inputs so tiny
// calls don't pay thread-spawn latency. Determinism: shards write disjoint
// output rows, so results are bit-identical to the sequential loop.
int n_gtok_threads(int64_t n_items, int64_t min_per_thread = 2048) {
  const char* env = std::getenv("GTOK_THREADS");
  int t = env ? std::atoi(env) : static_cast<int>(std::thread::hardware_concurrency());
  if (t < 1) t = 1;
  if (t > 16) t = 16;
  int64_t by_work = n_items / min_per_thread;
  if (by_work < t) t = static_cast<int>(by_work);
  return t < 1 ? 1 : t;
}

template <typename F>
void parallel_for_shards(int64_t n, int threads, F&& body) {
  if (threads <= 1) {
    body(0, n);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([&body, lo, hi] { body(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

struct Vocab {
  std::string blob;  // owns the token bytes; map keys view into it
  std::unordered_map<std::string_view, int32_t> map;
};

// Correctly-rounded "%.2f" fast path. snprintf("%.2f") costs ~270ns/call
// under glibc (locale machinery + exact dtoa) and dominates the ZINC vocab
// stream's label phase; this integer path is ~10x faster and byte-equal.
// Math: the exact value of y*100 is p + err with p = y*100 (one rounding)
// and err = fma(y, 100, -p) (the exact product residual — a double*double
// product fits in 106 bits, so fma recovers it exactly). Round-half-even of
// the true product is then nearbyint(p) corrected by the true remainder
// r = (p - n) + err: p - n is exact for |p| < 2^51 (the remainder is a
// multiple of ulp(p) <= 0.5), so r misses only err's own last bits.
// Near-tie cases (|r| within 1e-9 of 0.5, where half-even on the DECIMAL
// expansion could disagree with the double comparison) return -1 and the
// caller falls back to snprintf — correctness never rides on the fast path.
// Returns the formatted length, or -1 to request the snprintf fallback.
inline int fast_fmt_2f(double y, char* out) {
  if (!std::isfinite(y)) return -1;              // "nan"/"inf": snprintf's job
  const double p = y * 100.0;
  if (std::fabs(p) >= 2.0e15) return -1;         // stay inside exact p-n zone
  const double err = std::fma(y, 100.0, -p);
  double n = std::nearbyint(p);                  // half-even (default FE mode)
  const double r = (p - n) + err;                // true remainder to ~1 ulp
  const double a = std::fabs(r);
  if (a > 0.5 - 1e-9) {
    if (a < 0.5 + 1e-9) return -1;               // near-tie: let snprintf decide
    n += (r > 0.0) ? 1.0 : -1.0;                 // beyond halfway: bump to n+-1
  }
  const long long v = static_cast<long long>(n);
  unsigned long long mag = static_cast<unsigned long long>(v < 0 ? -v : v);
  int k = 0;
  if (std::signbit(y)) out[k++] = '-';           // sign from y: -0.001 -> "-0.00"
  const unsigned long long ip = mag / 100, fr = mag % 100;
  char tmp[24];
  int t = 0;
  unsigned long long q = ip;
  do { tmp[t++] = static_cast<char>('0' + q % 10); q /= 10; } while (q);
  while (t) out[k++] = tmp[--t];
  out[k++] = '.';
  out[k++] = static_cast<char>('0' + fr / 10);
  out[k++] = static_cast<char>('0' + fr % 10);
  out[k] = '\0';
  return k;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// text encoding
// ---------------------------------------------------------------------------

void* gtok_vocab_create(const char* tokens, const int64_t* offs, int32_t n,
                        const int32_t* ids) {
  auto* v = new Vocab();
  v->blob.assign(tokens, tokens + offs[n]);
  v->map.reserve(static_cast<size_t>(n) * 2);
  for (int32_t i = 0; i < n; ++i) {
    v->map.emplace(std::string_view(v->blob.data() + offs[i],
                                    static_cast<size_t>(offs[i + 1] - offs[i])),
                   ids[i]);
  }
  return v;
}

void gtok_vocab_free(void* vocab) { delete static_cast<Vocab*>(vocab); }

// Encode n_texts whitespace-tokenized texts to ids.
//   buf/text_offs: concatenated UTF-8 texts (text i = [offs[i], offs[i+1]))
//   strip_label:   cut after the first "<p>" token (inclusive)
//   out_ids:       [n_texts * max_len] prefilled by caller is NOT required;
//                  rows are padded with pad_id up to max_len
//   out_lens:      [n_texts]
// Returns 0 on success.
int32_t gtok_encode_texts(const void* vocab, const char* buf,
                          const int64_t* text_offs, int32_t n_texts,
                          int32_t max_len, int32_t pad_id, int32_t strip_label,
                          int32_t* out_ids, int32_t* out_lens) {
  const auto& map = static_cast<const Vocab*>(vocab)->map;
  // Python str.split() whitespace for ASCII bytes: \t\n\v\f\r, space, and
  // the 0x1c-0x1f separators (all .isspace() in Python). The ctypes wrapper
  // routes non-ASCII texts to the scalar path, so matching the ASCII set
  // here keeps native == Python bit-for-bit.
  auto is_split_ws = [](unsigned char c) {
    return c == ' ' || (c >= '\t' && c <= '\r') || (c >= 0x1c && c <= 0x1f);
  };
  // texts are independent and the vocab map is read-only: shard across
  // threads (disjoint output rows, deterministic)
  parallel_for_shards(
      n_texts, n_gtok_threads(n_texts, /*min_per_thread=*/1024),
      [&](int64_t lo, int64_t hi) {
        for (int64_t t = lo; t < hi; ++t) {
          const char* p = buf + text_offs[t];
          const char* end = buf + text_offs[t + 1];
          int32_t* row = out_ids + t * max_len;
          int32_t len = 0;
          while (p < end && len < max_len) {
            while (p < end && is_split_ws(*p)) ++p;
            const char* start = p;
            while (p < end && !is_split_ws(*p)) ++p;
            if (p == start) break;
            const std::string_view tok(start, static_cast<size_t>(p - start));
            auto it = map.find(tok);
            row[len++] = (it == map.end()) ? pad_id : it->second;
            if (strip_label && tok == "<p>") break;
          }
          out_lens[t] = len;
          for (int32_t i = len; i < max_len; ++i) row[i] = pad_id;
        }
      });
  return 0;
}

// ---------------------------------------------------------------------------
// SENT trail tokenization (batched)
// ---------------------------------------------------------------------------

// One graph's trail tokenization. Mirrors TrailTokenizer.__call__:
// unique undirected edges in first-occurrence order; Hierholzer greedy walks
// starting at the lowest-index odd-degree (else lowest-index) vertex,
// stepping to the lowest-index unused neighbor; RESET between trails, LADJ
// when a trail starts at an already-seen vertex, RADJ when a trail's end
// vertex starts a later trail; isolated nodes as singleton trails; EOS;
// truncation keeps EOS.
// Reusable per-thread workspace: the per-graph cost at molecule scale
// (~25 nodes / ~27 unique edges) was dominated by heap churn — a
// vector-of-vectors adjacency, two hash sets, and per-trail vectors, all
// allocated per graph. Flat CSR + bitmaps + flattened trail storage in a
// scratch that persists across a thread's shard keeps the walk
// allocation-free after warm-up. The walk ORDER is unchanged (bit-exact vs
// tokenization/sent.py, tests/test_native.py): same first-occurrence edge
// dedup, same (neighbor, edge index) adjacency order, same start selection,
// same greedy pointer advance.
struct SentScratch {
  std::vector<int32_t> eu, ev, eb;             // unique undirected edges
  std::vector<uint64_t> pair_bits;             // dedup bitmap (lo*n+hi)
  std::unordered_set<int64_t> pair_set;        // fallback for huge n
  std::vector<int32_t> adj_off;                // CSR offsets [n+1]
  std::vector<int64_t> adj_pack;               // (neighbor<<32 | edge idx)
  std::vector<int32_t> ptr, remaining, deg;
  std::vector<uint8_t> used, seen_node;
  std::vector<int32_t> tn, te, t_off;          // trails, flattened
};

static void sent_one(const int32_t* src, const int32_t* dst,
                     const int32_t* elab, int64_t n_edges, int32_t n_nodes,
                     const int32_t* nlab, int32_t labeled, int32_t idx_offset,
                     int32_t node_idx_offset, int32_t edge_idx_offset,
                     int32_t trunc_len, std::vector<int32_t>& out,
                     SentScratch& ws) {
  // unique undirected edges, first occurrence. Pair dedup through a bitmap
  // when n^2 bits is small (every benchmark graph; <=512KB), else the hash
  // set — identical acceptance order either way.
  const int64_t n2 = static_cast<int64_t>(n_nodes) * n_nodes;
  const bool small = n2 <= (1LL << 22);
  ws.eu.clear(); ws.ev.clear(); ws.eb.clear();
  if (small) {
    ws.pair_bits.assign(static_cast<size_t>((n2 + 63) / 64), 0);
  } else {
    ws.pair_set.clear();
  }
  for (int64_t i = 0; i < n_edges; ++i) {
    const int32_t a = src[i], b = dst[i];
    const int64_t lo = a < b ? a : b, hi = a < b ? b : a;
    if (small) {
      const int64_t key = lo * n_nodes + hi;
      uint64_t& w = ws.pair_bits[static_cast<size_t>(key >> 6)];
      const uint64_t bit = 1ULL << (key & 63);
      if (w & bit) continue;
      w |= bit;
    } else {
      if (!ws.pair_set.insert(lo * 1000003 + hi).second) continue;
    }
    ws.eu.push_back(a);
    ws.ev.push_back(b);
    ws.eb.push_back(elab ? elab[i] : 1);
  }
  const int32_t m = static_cast<int32_t>(ws.eu.size());

  // CSR adjacency sorted ascending by (neighbor, edge index): count, prefix,
  // fill, then sort each node's segment of packed (neighbor<<32 | edge) keys
  ws.deg.assign(n_nodes, 0);
  for (int32_t i = 0; i < m; ++i) { ++ws.deg[ws.eu[i]]; ++ws.deg[ws.ev[i]]; }
  ws.adj_off.resize(n_nodes + 1);
  ws.adj_off[0] = 0;
  for (int32_t u = 0; u < n_nodes; ++u)
    ws.adj_off[u + 1] = ws.adj_off[u] + ws.deg[u];
  ws.adj_pack.resize(2 * m);
  {
    std::vector<int32_t>& fill = ws.ptr;  // reuse as fill cursor
    fill.assign(ws.adj_off.begin(), ws.adj_off.end() - 1);
    for (int32_t i = 0; i < m; ++i) {
      const int64_t u = ws.eu[i], v = ws.ev[i];
      ws.adj_pack[fill[u]++] = (v << 32) | static_cast<uint32_t>(i);
      ws.adj_pack[fill[v]++] = (u << 32) | static_cast<uint32_t>(i);
    }
  }
  for (int32_t u = 0; u < n_nodes; ++u)
    std::sort(ws.adj_pack.begin() + ws.adj_off[u],
              ws.adj_pack.begin() + ws.adj_off[u + 1]);

  ws.used.assign(m, 0);
  ws.ptr.assign(n_nodes, 0);
  ws.remaining.assign(ws.deg.begin(), ws.deg.end());

  // trail decomposition into flat (t_off-indexed) node/edge sequences;
  // trail t's nodes are tn[t_off[t] .. t_off[t+1]) and its edges are the
  // same range minus one (te grows one behind tn)
  ws.tn.clear(); ws.te.clear(); ws.t_off.assign(1, 0);
  int64_t rem_total = 2LL * m;
  while (rem_total > 0) {
    int32_t start = -1;
    for (int32_t u = 0; u < n_nodes; ++u)
      if (ws.remaining[u] > 0 && (ws.remaining[u] % 2) == 1) { start = u; break; }
    if (start < 0)
      for (int32_t u = 0; u < n_nodes; ++u)
        if (ws.remaining[u] > 0) { start = u; break; }
    ws.tn.push_back(start);
    int32_t cur = start;
    for (;;) {
      int32_t nxt = -1, ei = -1;
      while (ws.ptr[cur] < ws.deg[cur]) {
        const int64_t pk = ws.adj_pack[ws.adj_off[cur] + ws.ptr[cur]];
        const int32_t e = static_cast<int32_t>(pk & 0xffffffff);
        if (!ws.used[e]) { nxt = static_cast<int32_t>(pk >> 32); ei = e; break; }
        ++ws.ptr[cur];
      }
      if (nxt < 0) break;
      ws.used[ei] = 1;
      ws.remaining[cur]--; ws.remaining[nxt]--; rem_total -= 2;
      ws.tn.push_back(nxt);
      ws.te.push_back(ei);
      cur = nxt;
    }
    ws.t_off.push_back(static_cast<int32_t>(ws.tn.size()));
  }
  for (int32_t u = 0; u < n_nodes; ++u)
    if (ws.deg[u] == 0) {
      ws.tn.push_back(u);
      ws.t_off.push_back(static_cast<int32_t>(ws.tn.size()));
    }

  // emission
  out.clear();
  out.push_back(SOS);
  ws.seen_node.assign(n_nodes, 0);
  const size_t nt = ws.t_off.size() - 1;
  for (size_t t = 0; t < nt; ++t) {
    const int32_t lo = ws.t_off[t], hi = ws.t_off[t + 1];
    const int32_t te_base = lo - static_cast<int32_t>(t);  // te skips trail heads
    if (t > 0) {
      out.push_back(RESET);
      if (ws.seen_node[ws.tn[lo]]) out.push_back(LADJ);
    }
    out.push_back(idx_offset + ws.tn[lo]);
    if (labeled && nlab) out.push_back(node_idx_offset + nlab[ws.tn[lo]]);
    ws.seen_node[ws.tn[lo]] = 1;
    for (int32_t k = lo + 1; k < hi; ++k) {
      if (labeled)
        out.push_back(edge_idx_offset + ws.eb[ws.te[te_base + (k - lo - 1)]] - 1);
      out.push_back(idx_offset + ws.tn[k]);
      if (labeled && nlab) out.push_back(node_idx_offset + nlab[ws.tn[k]]);
      ws.seen_node[ws.tn[k]] = 1;
    }
    if (t + 1 < nt) {
      const int32_t last = ws.tn[hi - 1];
      bool radj = false;
      for (size_t u = t + 1; u < nt; ++u)
        if (ws.tn[ws.t_off[u]] == last) { radj = true; break; }
      if (radj) out.push_back(RADJ);
    }
  }
  out.push_back(EOS);
  if (static_cast<int32_t>(out.size()) > trunc_len) {
    out.resize(trunc_len);
    out.back() = EOS;
  }
}

// Batched SENT tokenization over a flat edge list.
//   edge_off: [n_graphs+1] into src/dst/elab; num_nodes: [n_graphs]
//   node_off: [n_graphs+1] into nlab (ignored unless labeled)
//   out_tokens: [n_graphs * trunc_len] (pad-filled), out_lens: [n_graphs]
int32_t gtok_sent_tokenize_batch(
    const int32_t* src, const int32_t* dst, const int32_t* elab,
    const int64_t* edge_off, const int32_t* num_nodes, const int32_t* nlab,
    const int64_t* node_off, int32_t n_graphs, int32_t labeled,
    int32_t idx_offset, int32_t node_idx_offset, int32_t edge_idx_offset,
    int32_t trunc_len, int32_t pad_id, int32_t* out_tokens,
    int32_t* out_lens) {
  // per-graph Hierholzer walks are independent; shard graphs across threads
  // (disjoint output rows, deterministic — the walk itself is seed-free)
  parallel_for_shards(
      n_graphs, n_gtok_threads(n_graphs, /*min_per_thread=*/256),
      [&](int64_t lo, int64_t hi) {
        std::vector<int32_t> buf;
        SentScratch ws;  // reused across the shard: allocation-free after warm-up
        for (int64_t g = lo; g < hi; ++g) {
          int64_t es = edge_off[g], ee = edge_off[g + 1];
          const int32_t* gl = (labeled && nlab) ? nlab + node_off[g] : nullptr;
          sent_one(src + es, dst + es, elab ? elab + es : nullptr, ee - es,
                   num_nodes[g], gl, labeled, idx_offset, node_idx_offset,
                   edge_idx_offset, trunc_len, buf, ws);
          int32_t* row = out_tokens + g * trunc_len;
          int32_t len = static_cast<int32_t>(buf.size());
          std::memcpy(row, buf.data(), sizeof(int32_t) * len);
          for (int32_t i = len; i < trunc_len; ++i) row[i] = pad_id;
          out_lens[g] = len;
        }
      });
  return 0;
}

// ---------------------------------------------------------------------------
// ZINC IBTT corpus encode (flat arrays -> padded id matrix)
// ---------------------------------------------------------------------------

// Byte-exact with tokenization.ibtt_fast.corpus_ids_vectorized for
// lexsorted directed edge lists (PyG layout): per molecule emits
//   <bos> (<atom> sym)*N (<bond> type u v)*E' <q> regression <p>
// stripped at '<p>', with string-path-equivalent truncation handled by the
// caller (rows whose full length exceeds max_len must be patched in Python;
// out_trunc flags them). Canonical dedup keeps edges with src < dst.
int32_t gtok_zinc_encode(
    const int32_t* atoms, const int64_t* node_off,
    const int32_t* src, const int32_t* dst, const int32_t* bond,
    const int64_t* edge_off, int32_t n_mols,
    const int32_t* atom_ids /*[9]*/, const int32_t* bond_ids /*[5], 1-based*/,
    const int32_t* index_ids /*[max_nodes+1]*/,
    const int32_t* tail_ids /*[5]: q, regress, p, <atom>, <bond>*/,
    int32_t max_len, int32_t pad_id, int32_t bos_id, int32_t l_max,
    int32_t* out_ids /*[n_mols * l_max]*/, int32_t* out_lens,
    uint8_t* out_trunc) {
  std::atomic<int32_t> rc{0};
  parallel_for_shards(n_mols, n_gtok_threads(n_mols), [&](int64_t lo, int64_t hi) {
    for (int64_t mol = lo; mol < hi; ++mol) {
      int64_t ns = node_off[mol], ne = node_off[mol + 1];
      int64_t es = edge_off[mol], ee = edge_off[mol + 1];
      // bounds check BEFORE writing: a lexsorted-but-unmirrored edge list can
      // keep up to E (not E/2) edges, so a caller sizing l_max from E/2 would
      // otherwise overflow the numpy-owned row buffer
      int64_t kept = 0;
      for (int64_t i = es; i < ee; ++i) kept += (src[i] < dst[i]);
      int64_t needed = 1 + 2 * (ne - ns) + 4 * kept + 3;
      if (needed > l_max) {
        rc.store(-2, std::memory_order_relaxed);
        return;
      }
      int32_t* row = out_ids + mol * l_max;
      int32_t pos = 0;
      row[pos++] = bos_id;
      for (int64_t i = ns; i < ne; ++i) {
        row[pos++] = tail_ids[3];  // <atom> marker
        int32_t a = atoms[i];
        row[pos++] = atom_ids[(a >= 0 && a < 9) ? a : 0];
      }
      for (int64_t i = es; i < ee; ++i) {
        if (src[i] >= dst[i]) continue;  // canonical dedup (lexsorted input)
        row[pos++] = tail_ids[4];  // <bond> marker
        int32_t b = bond[i];
        row[pos++] = bond_ids[(b >= 1 && b <= 4) ? b : 0];
        row[pos++] = index_ids[src[i]];
        row[pos++] = index_ids[dst[i]];
      }
      row[pos++] = tail_ids[0];  // <q>
      row[pos++] = tail_ids[1];  // regression
      row[pos++] = tail_ids[2];  // <p>
      out_lens[mol] = pos;
      out_trunc[mol] = (pos + 2 > max_len) ? 1 : 0;  // +label+<eos>
      for (int32_t i = pos; i < l_max; ++i) row[i] = pad_id;
    }
  });
  return rc.load();
}

// ---------------------------------------------------------------------------
// ZINC dynamic-vocab discovery
// ---------------------------------------------------------------------------

// Test hook for the fast "%.2f" path: formats y into out (fast path, or the
// snprintf fallback it would take in production) and returns 1 if the fast
// path produced it, 0 on fallback. tests/test_native.py cross-checks the
// bytes against Python's f"{y:.2f}" over adversarial values.
int32_t gtok_fmt_2f(double y, char* out, int32_t cap) {
  if (cap < 32) return -1;
  if (fast_fmt_2f(y, out) >= 0) return 1;
  std::snprintf(out, static_cast<size_t>(cap), "%.2f", y);
  return 0;
}

// Emits the dynamic (out-of-fixed-vocab) tokens of the ZINC IBTT corpus in
// first-occurrence order: per molecule, node-index tokens in canonical bond
// emission order (str(u), str(v) per kept edge), then the molecule's
// 'val_*' label. Mirrors tokenization.ibtt_fast.build_zinc_vocab_fast.
// Outputs: out_codes[k] = node index i (code i) or max_nodes+1+label_rank;
// label strings are returned as a '\n'-joined blob in label rank order.
// Returns the number of ordered unique codes, or -1 if bufs are too small.
int32_t gtok_zinc_vocab_stream(
    const int32_t* src, const int32_t* dst, const int64_t* edge_off,
    const double* y, int32_t n_mols, int32_t max_nodes,
    int64_t* out_codes, int32_t out_codes_cap,
    char* label_blob, int64_t label_blob_cap) {
  // phase 1 (parallel): format every molecule's label string
  // f"val_{y:.2f}" ('.'->'_', '-'->'neg') into a fixed-stride buffer —
  // snprintf dominates the sequential loop's cost and is per-molecule
  // independent; the dedup pass below stays sequential (first-occurrence
  // order is the contract).
  constexpr int kLabW = 72;  // "val_" + rewritten %.2f fits for |y| < ~1e64;
                             // wider labels are DETECTED (not truncated) and
                             // error out -> caller falls back to exact path
  std::vector<char> lab(static_cast<size_t>(n_mols) * kLabW);
  std::atomic<bool> lab_overflow{false};
  parallel_for_shards(n_mols, n_gtok_threads(n_mols), [&](int64_t lo, int64_t hi) {
    char buf[512];
    for (int64_t mol = lo; mol < hi; ++mol) {
      if (fast_fmt_2f(y[mol], buf) < 0)
        std::snprintf(buf, sizeof(buf), "%.2f", y[mol]);
      char* s = lab.data() + mol * kLabW;
      int k = 0;
      s[k++] = 'v'; s[k++] = 'a'; s[k++] = 'l'; s[k++] = '_';
      const char* p = buf;
      for (; *p && k < kLabW - 4; ++p) {
        if (*p == '.') s[k++] = '_';
        else if (*p == '-') { s[k++] = 'n'; s[k++] = 'e'; s[k++] = 'g'; }
        else s[k++] = *p;
      }
      if (*p) lab_overflow.store(true, std::memory_order_relaxed);
      s[k] = '\0';
    }
  });
  // a label wider than the stride would be silently truncated (and could
  // collide); error out so the caller falls back to the exact string path
  if (lab_overflow.load()) return -1;

  // phase 1.5 (parallel): distinct kept-endpoint census. Lets phase 2 stop
  // scanning a molecule's edges once every distinct node code in the corpus
  // has been emitted (true after the first few molecules on real corpora —
  // the edge scan was most of phase 2's cost), and surfaces out-of-range
  // ids up front: the same -1 the sequential scan produces on reaching one,
  // just earlier. Per-thread local bitmaps OR-merged under a mutex keep the
  // census race-free; the distinct COUNT is order-independent, so the
  // emitted first-occurrence order is untouched.
  const int64_t seen_cap = static_cast<int64_t>(max_nodes) + 2;
  const int64_t n_edges_total = edge_off[n_mols];
  std::vector<uint8_t> will_see(static_cast<size_t>(seen_cap), 0);
  std::atomic<bool> oob{false};
  {
    std::mutex merge_mu;
    parallel_for_shards(
        n_edges_total, n_gtok_threads(n_edges_total, 65536),
        [&](int64_t lo, int64_t hi) {
          std::vector<uint8_t> local(static_cast<size_t>(seen_cap), 0);
          for (int64_t i = lo; i < hi; ++i) {
            if (src[i] >= dst[i]) continue;
            const int64_t u = src[i], v = dst[i];
            if (u < 0 || u >= seen_cap || v < 0 || v >= seen_cap) {
              oob.store(true, std::memory_order_relaxed);
              return;
            }
            local[static_cast<size_t>(u)] = 1;
            local[static_cast<size_t>(v)] = 1;
          }
          std::lock_guard<std::mutex> g(merge_mu);
          for (int64_t c = 0; c < seen_cap; ++c) will_see[c] |= local[c];
        });
  }
  if (oob.load()) return -1;
  int32_t distinct_nodes = 0;
  for (int64_t c = 0; c < seen_cap; ++c) distinct_nodes += will_see[c];

  // phase 2 (sequential): dedup/emit in first-occurrence order. Node codes
  // dedup through a flat byte table (codes are <= max_nodes); label codes
  // through a string_view->rank map whose keys view straight into the
  // preformatted buffer (no per-molecule std::string temporaries).
  std::unordered_map<std::string_view, int32_t> label_rank;
  std::vector<std::string_view> labels;
  std::vector<uint8_t> seen_node(static_cast<size_t>(seen_cap), 0);
  int32_t n_out = 0;
  int32_t node_seen_count = 0;
  int64_t blob_len = 0;

  auto emit_node = [&](int64_t code) -> bool {
    // bounds-check: the lexsorted gate validates ordering, not index range —
    // an out-of-range node id must error (caller falls back to the exact
    // Python path) instead of indexing past the table (the census above
    // already rejected them, so this is belt-and-braces)
    if (code < 0 || code >= seen_cap) return false;
    if (seen_node[code]) return true;
    seen_node[code] = 1;
    ++node_seen_count;
    if (n_out >= out_codes_cap) return false;
    out_codes[n_out++] = code;
    return true;
  };

  for (int32_t mol = 0; mol < n_mols; ++mol) {
    if (node_seen_count < distinct_nodes) {
      for (int64_t i = edge_off[mol]; i < edge_off[mol + 1]; ++i) {
        if (src[i] >= dst[i]) continue;
        if (!emit_node(src[i]) || !emit_node(dst[i])) return -1;
      }
    }
    const std::string_view sv(lab.data() + static_cast<int64_t>(mol) * kLabW);
    auto it = label_rank.find(sv);
    if (it == label_rank.end()) {
      int32_t rank = static_cast<int32_t>(labels.size());
      label_rank.emplace(sv, rank);
      labels.push_back(sv);
      // a new label is by definition first-occurrence: emit unconditionally
      if (n_out >= out_codes_cap) return -1;
      out_codes[n_out++] = static_cast<int64_t>(max_nodes) + 1 + rank;
    }
  }

  for (const auto& s : labels) {
    if (blob_len + static_cast<int64_t>(s.size()) + 1 > label_blob_cap) return -1;
    std::memcpy(label_blob + blob_len, s.data(), s.size());
    blob_len += s.size();
    label_blob[blob_len++] = '\n';
  }
  if (blob_len < label_blob_cap) label_blob[blob_len] = '\0';
  return n_out;
}

// ---------------------------------------------------------------------------
// Corpus pack: pad [n, l] id rows out to a static bucket width + bool mask
// ---------------------------------------------------------------------------

// Semantics of tokenization.pack.pack_corpus: out[:, :l] = ids,
// out[:, l:] = pad_id, mask[i, j] = j < lens[i]. One parallel pass over the
// output (the stage is pure memory bandwidth; numpy does it in three).
void gtok_pack_ids(const int32_t* ids, const int32_t* lens,
                   int32_t n, int32_t l, int32_t l_bucket, int32_t pad_id,
                   int32_t* out, uint8_t* mask) {
  parallel_for_shards(n, n_gtok_threads(n), [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int32_t* row = out + i * l_bucket;
      std::memcpy(row, ids + i * l, sizeof(int32_t) * l);
      for (int32_t j = l; j < l_bucket; ++j) row[j] = pad_id;
      uint8_t* mrow = mask + i * l_bucket;
      int32_t k = lens[i];
      if (k > l_bucket) k = l_bucket;
      if (k < 0) k = 0;  // numpy semantics: negative length -> all-False row
      std::memset(mrow, 1, k);
      std::memset(mrow + k, 0, l_bucket - k);
    }
  });
}

// Fast-path gate for the vectorized ZINC encoders
// (ibtt_fast._edges_lexsorted_per_mol semantics, exactly): per molecule the
// directed edge list must be STRICTLY lexsorted by (src, dst), contain no
// self-loops, and every reversed (src > dst) edge must have its directed
// mirror (dst, src) in the same molecule. One O(E log deg) pass, no
// allocation; tuple comparisons (no src*big+dst key) so arbitrary int64
// ids cannot overflow. Returns 1 if every molecule passes, else 0.
// Exact output-row sizing for gtok_zinc_encode: max over molecules of
// 1 + 2*n_nodes + 4*kept + 3, kept = #(src < dst) edges. One parallel
// pass; replaces a numpy keep/cumsum chain that cost more than the encode
// kernel itself at 10k molecules.
int64_t gtok_zinc_lmax(const int32_t* src, const int32_t* dst,
                       const int64_t* edge_off, const int32_t* n_nodes,
                       int32_t n_mols) {
  std::atomic<int64_t> lmax{1};
  parallel_for_shards(n_mols, n_gtok_threads(n_mols),
                      [&](int64_t lo, int64_t hi) {
    int64_t local = 1;
    for (int64_t m = lo; m < hi; ++m) {
      int64_t kept = 0;
      for (int64_t i = edge_off[m]; i < edge_off[m + 1]; ++i) {
        kept += src[i] < dst[i];
      }
      const int64_t l = 1 + 2 * static_cast<int64_t>(n_nodes[m]) + 4 * kept + 3;
      if (l > local) local = l;
    }
    int64_t cur = lmax.load(std::memory_order_relaxed);
    while (local > cur &&
           !lmax.compare_exchange_weak(cur, local,
                                       std::memory_order_relaxed)) {}
  });
  return lmax.load();
}

int32_t gtok_edges_lexsorted(const int32_t* src, const int32_t* dst,
                             const int64_t* edge_off, int32_t n_mols) {
  // per-molecule checks are independent; shard across the pool. The result
  // is a single AND over per-molecule verdicts, so a relaxed early-exit
  // flag keeps semantics identical to the sequential scan (the mirror
  // pass dominated the sequential cost).
  std::atomic<bool> bad{false};
  auto check_mol = [&](int32_t m) -> bool {
    const int64_t s = edge_off[m], e = edge_off[m + 1];
    int64_t max_id = -1;
    for (int64_t i = s; i < e; ++i) {
      if (src[i] == dst[i]) return false;  // self-loop
      if (i > s && (src[i] < src[i - 1] ||
                    (src[i] == src[i - 1] && dst[i] <= dst[i - 1]))) {
        return false;  // not strictly increasing (duplicates included)
      }
      const int64_t hi_id = src[i] > dst[i] ? src[i] : dst[i];
      if (hi_id > max_id) max_id = hi_id;
    }
    // mirror check. Fast path for small-id molecules (every benchmark
    // corpus: nodes < 128): mark forward pairs in a stack bitset, then
    // each reversed edge is one bit probe — O(E) instead of O(E log E).
    if (max_id >= 0 && max_id < 128) {
      uint64_t bits[256] = {0};  // 128*128 pair bits / 64 per word = 2KB
      for (int64_t i = s; i < e; ++i) {
        if (src[i] < dst[i]) {
          const int64_t p = src[i] * 128 + dst[i];
          bits[p >> 6] |= (uint64_t{1} << (p & 63));
        }
      }
      for (int64_t i = s; i < e; ++i) {
        if (src[i] < dst[i]) continue;
        const int64_t p = dst[i] * 128 + src[i];
        if (!(bits[p >> 6] & (uint64_t{1} << (p & 63)))) return false;
      }
      return true;
    }
    for (int64_t i = s; i < e; ++i) {
      if (src[i] < dst[i]) continue;  // forward edge
      // reversed: binary-search the molecule's (sorted) slice for (dst, src)
      const int64_t u = dst[i], v = src[i];
      int64_t lo = s, hi = e;
      bool found = false;
      while (lo < hi) {
        const int64_t mid = lo + (hi - lo) / 2;
        if (src[mid] < u || (src[mid] == u && dst[mid] < v)) {
          lo = mid + 1;
        } else if (src[mid] == u && dst[mid] == v) {
          found = true;
          break;
        } else {
          hi = mid;
        }
      }
      if (!found) return false;
    }
    return true;
  };
  parallel_for_shards(n_mols, n_gtok_threads(n_mols),
                      [&](int64_t lo, int64_t hi) {
    for (int64_t m = lo; m < hi; ++m) {
      if (bad.load(std::memory_order_relaxed)) return;
      if (!check_mol(static_cast<int32_t>(m))) {
        bad.store(true, std::memory_order_relaxed);
        return;
      }
    }
  });
  return bad.load() ? 0 : 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// corpus scanning: parse a graph-token JSON corpus file without building
// Python objects. Strict layout only — exactly what data/generator.py
// writes: a JSON array of {"text": "..."} objects, ASCII, no escapes.
// Anything else (JSONL, extra keys, escapes, non-ASCII) returns null and
// the caller falls back to the Python reader, so behavior on the full
// format-tolerant surface (reference data_loader.py:112-245) is unchanged.
// Labels/queries are parsed with the exact semantics of
// data/text_grammar.py (itself mirroring reference data_loader.py:12-55).
// ---------------------------------------------------------------------------

namespace {

struct CorpusRec {
  int64_t off, len;       // text span within the caller's buffer
  int32_t label;          // parsed label; -2 encodes Python None
  int32_t has_q;          // 1 when a query parsed (query ints may be any value)
  int32_t qu, qv;
};

struct CorpusScan {
  std::vector<CorpusRec> recs;
};

inline bool is_ws(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}

// Python-int semantics on ASCII tokens: [+-]? digit ('_'? digit)*
// (underscores allowed singly between digits). Returns false on anything
// int() would reject.
// Tri-state Python-int parse. Syntax follows int(): optional sign, digits,
// '_' separators between digits. PYINT_OVERFLOW means the token IS a valid
// Python int but does not fit the scanner's int32 record fields — the
// strict scan must then ABORT (Python would accept the value; truncating
// through int32 would break the native==Python byte-parity contract), so
// the loader falls back to the Python path for the whole file.
enum PyIntParse { PYINT_BAD = 0, PYINT_OK = 1, PYINT_OVERFLOW = 2 };

int parse_py_int(const char* s, int64_t n, long long* out) {
  int64_t i = 0;
  bool neg = false;
  if (i < n && (s[i] == '+' || s[i] == '-')) {
    neg = s[i] == '-';
    ++i;
  }
  if (i >= n) return PYINT_BAD;
  long long v = 0;
  bool prev_digit = false;
  bool any_digit = false;
  bool huge = false;
  for (; i < n; ++i) {
    char c = s[i];
    if (c >= '0' && c <= '9') {
      if (!huge) {
        v = v * 10 + (c - '0');
        if (v > (1LL << 40)) huge = true;  // stop accumulating, keep checking syntax
      }
      prev_digit = any_digit = true;
    } else if (c == '_') {
      if (!prev_digit) return PYINT_BAD;  // '_' must follow a digit…
      prev_digit = false;
    } else {
      return PYINT_BAD;
    }
  }
  if (!prev_digit || !any_digit) return PYINT_BAD;  // …and precede one
  *out = neg ? -v : v;
  // one-off margins: parse_distance stores v-1
  if (huge || v > 2147483646LL || (neg && -v < -2147483647LL))
    return PYINT_OVERFLOW;
  return PYINT_OK;
}

inline bool tok_eq(const char* s, int64_t n, const char* lit) {
  int64_t m = static_cast<int64_t>(std::strlen(lit));
  return n == m && std::memcmp(s, lit, m) == 0;
}

inline bool tok_eq_upper(const char* s, int64_t n, const char* lit_upper) {
  int64_t m = static_cast<int64_t>(std::strlen(lit_upper));
  if (n != m) return false;
  for (int64_t i = 0; i < m; ++i) {
    char c = s[i];
    if (c >= 'a' && c <= 'z') c = static_cast<char>(c - 'a' + 'A');
    if (c != lit_upper[i]) return false;
  }
  return true;
}

// whitespace-tokenize a span (Python str.split semantics) into (ptr, len)
void split_tokens(const char* s, int64_t n,
                  std::vector<std::pair<const char*, int64_t>>* toks) {
  toks->clear();
  int64_t i = 0;
  while (i < n) {
    while (i < n && is_ws(static_cast<unsigned char>(s[i]))) ++i;
    int64_t start = i;
    while (i < n && !is_ws(static_cast<unsigned char>(s[i]))) ++i;
    if (i > start) toks->emplace_back(s + start, i - start);
  }
}

// text_grammar.parse_yes_no_from_text: LAST yes/no token wins
int32_t parse_yes_no(const std::vector<std::pair<const char*, int64_t>>& t) {
  for (int64_t i = static_cast<int64_t>(t.size()) - 1; i >= 0; --i) {
    if (tok_eq_upper(t[i].first, t[i].second, "YES")) return 1;
    if (tok_eq_upper(t[i].first, t[i].second, "NO")) return 0;
  }
  return -2;
}

// text_grammar.parse_distance_label_from_text
int32_t parse_distance(const std::vector<std::pair<const char*, int64_t>>& t) {
  for (size_t i = 0; i + 1 < t.size(); ++i) {
    if (!tok_eq(t[i].first, t[i].second, "<p>")) continue;
    const char* s = t[i + 1].first;
    int64_t n = t[i + 1].second;
    if (tok_eq_upper(s, n, "INF") || tok_eq_upper(s, n, "INFINITY") ||
        tok_eq_upper(s, n, "<EOS>")) {
      return -2;  // unreachable -> None
    }
    if (n >= 3 && tok_eq_upper(s, 3, "LEN")) {
      long long v;
      int r = parse_py_int(s + 3, n - 3, &v);
      if (r == PYINT_OK) return static_cast<int32_t>(v - 1);
      if (r == PYINT_OVERFLOW) return INT32_MIN;  // abort the strict scan
      // ValueError -> keep scanning for another '<p>' (reference behavior)
    }
  }
  return -2;
}

// text_grammar.parse_query_nodes_from_text
// Returns 0 = no query, 1 = parsed, 2 = int too large for int32 (abort the
// strict scan — Python would accept the value).
int parse_query(const std::vector<std::pair<const char*, int64_t>>& t,
                int32_t* qu, int32_t* qv) {
  for (size_t i = 0; i + 3 < t.size(); ++i) {
    if (!tok_eq(t[i].first, t[i].second, "<q>")) continue;
    if (!tok_eq(t[i + 1].first, t[i + 1].second, "shortest_distance")) continue;
    long long u, v;
    int ru = parse_py_int(t[i + 2].first, t[i + 2].second, &u);
    int rv = parse_py_int(t[i + 3].first, t[i + 3].second, &v);
    if (ru == PYINT_OVERFLOW || rv == PYINT_OVERFLOW) return 2;
    if (ru == PYINT_OK && rv == PYINT_OK) {
      *qu = static_cast<int32_t>(u);
      *qv = static_cast<int32_t>(v);
      return 1;
    }
    // ValueError -> keep scanning (reference behavior)
  }
  return 0;
}

}  // namespace

extern "C" {

// Scan a strict graph-token corpus JSON buffer.
//   task_kind: 0 = cycle_check (yes/no label, no query)
//              1 = shortest_path (lenK/INF label + '<q> shortest_distance u v')
// Returns an opaque handle (free with gtok_corpus_free) and sets *out_n,
// or null if the buffer deviates from the strict layout.
void* gtok_corpus_scan(const char* buf, int64_t n_bytes, int32_t task_kind,
                       int64_t* out_n) {
  auto scan = std::unique_ptr<CorpusScan>(new CorpusScan());
  std::vector<std::pair<const char*, int64_t>> toks;
  int64_t i = 0;
  auto skip_ws = [&]() {
    while (i < n_bytes && is_ws(static_cast<unsigned char>(buf[i]))) ++i;
  };
  skip_ws();
  if (i >= n_bytes || buf[i] != '[') return nullptr;
  ++i;
  skip_ws();
  bool first = true;
  while (i < n_bytes && buf[i] != ']') {
    if (!first) {
      if (buf[i] != ',') return nullptr;
      ++i;
      skip_ws();
    }
    first = false;
    // {"text": "...."}
    if (i >= n_bytes || buf[i] != '{') return nullptr;
    ++i;
    skip_ws();
    const char kText[] = "\"text\"";
    if (i + 6 > n_bytes || std::memcmp(buf + i, kText, 6) != 0) return nullptr;
    i += 6;
    skip_ws();
    if (i >= n_bytes || buf[i] != ':') return nullptr;
    ++i;
    skip_ws();
    if (i >= n_bytes || buf[i] != '"') return nullptr;
    ++i;
    int64_t start = i;
    while (i < n_bytes) {
      unsigned char c = static_cast<unsigned char>(buf[i]);
      if (c == '"') break;
      // escapes or non-ASCII would make raw bytes differ from the decoded
      // string (and Python int() accepts non-ASCII digits) -> fall back
      if (c == '\\' || c < 0x20 || c >= 0x80) return nullptr;
      ++i;
    }
    if (i >= n_bytes) return nullptr;
    int64_t tlen = i - start;
    ++i;  // closing quote
    skip_ws();
    if (i >= n_bytes || buf[i] != '}') return nullptr;  // extra keys -> fallback
    ++i;
    skip_ws();

    // Python's loader strips each text (loader._extract_text_and_label);
    // store the stripped span so materialized strings match byte-for-byte
    while (tlen > 0 && is_ws(static_cast<unsigned char>(buf[start]))) {
      ++start;
      --tlen;
    }
    while (tlen > 0 &&
           is_ws(static_cast<unsigned char>(buf[start + tlen - 1]))) {
      --tlen;
    }
    CorpusRec rec{start, tlen, -2, 0, 0, 0};
    split_tokens(buf + start, tlen, &toks);
    if (task_kind == 1) {
      rec.label = parse_distance(toks);
      if (rec.label == INT32_MIN) return nullptr;  // int32 overflow -> Python path
      int q = parse_query(toks, &rec.qu, &rec.qv);
      if (q == 2) return nullptr;  // int32 overflow -> Python path
      rec.has_q = q;
    } else {
      rec.label = parse_yes_no(toks);
    }
    scan->recs.push_back(rec);
  }
  if (i >= n_bytes || buf[i] != ']') return nullptr;
  ++i;
  skip_ws();
  if (i != n_bytes) return nullptr;  // trailing garbage (e.g. JSONL) -> fallback
  *out_n = static_cast<int64_t>(scan->recs.size());
  return scan.release();
}

void gtok_corpus_fill(void* handle, int64_t* offs, int64_t* lens,
                      int32_t* labels, int32_t* has_q, int32_t* qu,
                      int32_t* qv) {
  auto* scan = static_cast<CorpusScan*>(handle);
  for (size_t k = 0; k < scan->recs.size(); ++k) {
    const CorpusRec& r = scan->recs[k];
    offs[k] = r.off;
    lens[k] = r.len;
    labels[k] = r.label;
    has_q[k] = r.has_q;
    qu[k] = r.qu;
    qv[k] = r.qv;
  }
}

void gtok_corpus_free(void* handle) { delete static_cast<CorpusScan*>(handle); }

}  // extern "C"
