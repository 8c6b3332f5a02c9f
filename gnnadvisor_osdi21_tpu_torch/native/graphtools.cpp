// Native graph preprocessing for GNNAdvisor-TPU.
//
// TPU-native re-expression of the reference's C++/CUDA host components:
//  - edge-list text parser        (rabbit_module/src/edge_list.hpp:59-161)
//  - rabbit community reordering  (rabbit_module/src/rabbit_order.hpp,
//                                  reorder.cpp:235-295)
//  - neighbor-partition builder   (GNNAdvisor/GNNConv/GNNAdvisor.cpp:210-251)
//
// Same algorithms, reduced dependencies: std::atomic + OpenMP only (no
// boost/numa/tcmalloc).  Exposed as a plain C ABI consumed through ctypes
// (no pybind11 in this environment).
//
// Build: g++ -O3 -fopenmp -shared -fPIC graphtools.cpp -o libgraphtools.so

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Edge-list parser: "src dst" per line, '#' comments.  Returns the number of
// edges parsed; fills caller buffers if capacity suffices (two-call pattern).
// ---------------------------------------------------------------------------
int64_t gt_parse_edge_list(const char* path, int64_t* src, int64_t* dst,
                           int64_t capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  const long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  if (fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return -1;
  }
  fclose(f);
  buf[size] = '\0';

  // Chunked parallel parse: each thread starts at the next line boundary
  // (the mmap+dynamic-chunk scheme of edge_list.hpp:121-161, simplified).
  int nthreads = 1;
#ifdef _OPENMP
  nthreads = omp_get_max_threads();
#endif
  std::vector<std::vector<std::pair<int64_t, int64_t>>> parts(nthreads);

#pragma omp parallel num_threads(nthreads)
  {
    int tid = 0;
#ifdef _OPENMP
    tid = omp_get_thread_num();
#endif
    const long chunk = (size + nthreads - 1) / nthreads;
    long begin = tid * chunk;
    long end = std::min<long>(begin + chunk, size);
    if (begin > 0) {  // skip partial line (owned by the previous chunk)
      while (begin < end && buf[begin - 1] != '\n') ++begin;
    }
    auto& out = parts[tid];
    long i = begin;
    while (i < end) {
      if (buf[i] == '#') {  // comment line
        while (i < size && buf[i] != '\n') ++i;
        ++i;
        continue;
      }
      char* p = &buf[i];
      char* q = nullptr;
      long a = strtol(p, &q, 10);
      if (q == p) {  // blank/garbage line
        while (i < size && buf[i] != '\n') ++i;
        ++i;
        continue;
      }
      long b = strtol(q, &q, 10);
      out.emplace_back(a, b);
      i = (q - buf.data());
      while (i < size && buf[i] != '\n') ++i;
      ++i;
    }
  }

  int64_t total = 0;
  for (auto& p : parts) total += static_cast<int64_t>(p.size());
  if (src && dst && total <= capacity) {
    int64_t off = 0;
    for (auto& p : parts) {
      for (auto& e : p) {
        src[off] = e.first;
        dst[off] = e.second;
        ++off;
      }
    }
  }
  return total;
}

// ---------------------------------------------------------------------------
// Rabbit-style community reordering.
//
// Pipeline parity with reorder.cpp:235-290: symmetrize + dedup + drop self
// loops (reorder.cpp:32-97), then greedy incremental aggregation in
// increasing-degree order merging each vertex into the neighbor community
// with the best positive modularity gain dQ ~ w_uv - s_u*s_v/(2W).  Large
// graphs merge CONCURRENTLY with address-ordered per-community spinlocks —
// the std::atomic re-expression of the reference's lock-free merge
// (rabbit_order.hpp:477-526); small graphs run sequentially
// (deterministic).  The final ordering is a DFS over the recorded merge
// dendrogram (children in merge order), reproducing the hierarchical
// intra-community locality of compute_perm (rabbit_order.hpp:623-673)
// rather than a flat first-seen community order.
// ---------------------------------------------------------------------------

static int64_t uf_find(std::vector<int64_t>& parent, int64_t x) {
  int64_t root = x;
  while (parent[root] != root) root = parent[root];
  while (parent[x] != root) {
    int64_t nxt = parent[x];
    parent[x] = root;
    x = nxt;
  }
  return root;
}

// Lock-free find over the atomic parent array (racy path halving is safe:
// any interleaving still points at an ancestor).
static int64_t uf_find_atomic(std::vector<std::atomic<int64_t>>& parent,
                              int64_t x) {
  int64_t p = parent[x].load(std::memory_order_relaxed);
  while (p != x) {
    const int64_t gp = parent[p].load(std::memory_order_relaxed);
    parent[x].store(gp, std::memory_order_relaxed);  // path halving
    x = p;
    p = gp;
  }
  return x;
}

int gt_rabbit_permutation(const int64_t* src, const int64_t* dst,
                          int64_t num_edges, int64_t n, int64_t* perm_out) {
  // --- build symmetric dedup'd CSR (parallel counting sort) ---
  std::vector<int64_t> deg(n + 1, 0);
  std::vector<int64_t> us, vs;
  us.reserve(2 * num_edges);
  vs.reserve(2 * num_edges);
  for (int64_t e = 0; e < num_edges; ++e) {
    if (src[e] == dst[e]) continue;
    if (src[e] < 0 || src[e] >= n || dst[e] < 0 || dst[e] >= n) return -1;
    us.push_back(src[e]);
    vs.push_back(dst[e]);
    us.push_back(dst[e]);
    vs.push_back(src[e]);
  }
  const int64_t m2 = static_cast<int64_t>(us.size());
  for (int64_t e = 0; e < m2; ++e) deg[us[e] + 1]++;
  std::vector<int64_t> rp(n + 1, 0);
  std::partial_sum(deg.begin(), deg.end(), rp.begin());
  std::vector<int64_t> cols(m2);
  {
    std::vector<int64_t> cur(rp.begin(), rp.end() - 1);
    for (int64_t e = 0; e < m2; ++e) cols[cur[us[e]]++] = vs[e];
  }
  // sort + dedup each row
#pragma omp parallel for schedule(dynamic, 1024)
  for (int64_t v = 0; v < n; ++v) {
    std::sort(cols.begin() + rp[v], cols.begin() + rp[v + 1]);
  }
  std::vector<int64_t> rp2(n + 1, 0);
  std::vector<int64_t> cols2;
  cols2.reserve(m2);
  for (int64_t v = 0; v < n; ++v) {
    int64_t prev = -1;
    for (int64_t i = rp[v]; i < rp[v + 1]; ++i) {
      if (cols[i] != prev) {
        cols2.push_back(cols[i]);
        prev = cols[i];
      }
    }
    rp2[v + 1] = static_cast<int64_t>(cols2.size());
  }

  // --- greedy modularity merging, increasing-degree order ---
  double two_w = 0;
  for (int64_t v = 0; v < n; ++v) two_w += double(rp2[v + 1] - rp2[v]);
  if (two_w == 0) {
    for (int64_t v = 0; v < n; ++v) perm_out[v] = v;
    return 0;
  }
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return (rp2[a + 1] - rp2[a]) < (rp2[b + 1] - rp2[b]);
  });

  // Dendrogram: every vertex merges (as a representative) at most once;
  // children are recorded in merge order for the DFS below.
  std::vector<int64_t> child_head(n, -1), child_next(n, -1), child_tail(n, -1);
  auto record_child = [&](int64_t parent_c, int64_t child) {
    if (child_head[parent_c] < 0) {
      child_head[parent_c] = child_tail[parent_c] = child;
    } else {
      child_next[child_tail[parent_c]] = child;
      child_tail[parent_c] = child;
    }
  };

  const bool parallel_merge = n >= 200000;
  std::vector<int64_t> parent_seq;
  std::vector<std::atomic<int64_t>> parent_at;
  if (parallel_merge) {
    // -- concurrent merging (the rabbit_order.hpp:477-526 analog) --------
    parent_at = std::vector<std::atomic<int64_t>>(n);
    std::vector<std::atomic<int64_t>> strength(n);
    std::vector<std::atomic<uint8_t>> lock(n);
    for (int64_t v = 0; v < n; ++v) {
      parent_at[v].store(v, std::memory_order_relaxed);
      strength[v].store(rp2[v + 1] - rp2[v], std::memory_order_relaxed);
      lock[v].store(0, std::memory_order_relaxed);
    }
    auto acquire = [&](int64_t i) {
      uint8_t expected = 0;
      while (!lock[i].compare_exchange_weak(expected, 1,
                                            std::memory_order_acquire)) {
        expected = 0;
      }
    };
    auto release = [&](int64_t i) {
      lock[i].store(0, std::memory_order_release);
    };

    int merge_threads = 8;  // 8B/node/thread of scratch: cap the footprint
#ifdef _OPENMP
    merge_threads = std::min(omp_get_max_threads(), 8);
#endif
#pragma omp parallel num_threads(merge_threads)
    {
      // thread-local epoch-stamped gain accumulator (float+int32: ~8B/node)
      std::vector<int32_t> stamp(n, -1);
      std::vector<float> wacc(n, 0.f);
      std::vector<int64_t> touched;
      touched.reserve(256);
#pragma omp for schedule(dynamic, 512)
      for (int64_t idx = 0; idx < n; ++idx) {
        const int64_t v = order[idx];
        const int64_t beg = rp2[v], end = rp2[v + 1];
        if (beg == end) continue;
        for (int attempt = 0; attempt < 4; ++attempt) {
          const int64_t rv = uf_find_atomic(parent_at, v);
          touched.clear();
          for (int64_t i = beg; i < end; ++i) {
            const int64_t rn = uf_find_atomic(parent_at, cols2[i]);
            if (rn == rv) continue;
            if (stamp[rn] != int32_t(idx)) {
              stamp[rn] = int32_t(idx);
              wacc[rn] = 0.f;
              touched.push_back(rn);
            }
            wacc[rn] += 1.f;
          }
          int64_t best = -1;
          double best_gain = 0.0;
          const double sv =
              double(strength[rv].load(std::memory_order_relaxed));
          for (int64_t rn : touched) {
            const double gain =
                double(wacc[rn]) -
                sv * double(strength[rn].load(std::memory_order_relaxed)) /
                    two_w;
            if (gain > best_gain) {
              best_gain = gain;
              best = rn;
            }
          }
          if (best < 0) break;
          // address-ordered locks: no deadlock; re-check roots under lock
          const int64_t a = std::min(rv, best), b = std::max(rv, best);
          acquire(a);
          acquire(b);
          const bool still_roots =
              parent_at[rv].load(std::memory_order_relaxed) == rv &&
              parent_at[best].load(std::memory_order_relaxed) == best;
          if (still_roots) {
            parent_at[rv].store(best, std::memory_order_relaxed);
            strength[best].fetch_add(
                strength[rv].load(std::memory_order_relaxed),
                std::memory_order_relaxed);
            record_child(best, rv);  // safe: best's lock is held
            release(b);
            release(a);
            break;
          }
          release(b);
          release(a);  // roots moved under us: recompute and retry
        }
      }
    }
  } else {
    // -- sequential merging (deterministic; small graphs) ----------------
    parent_seq.resize(n);
    std::iota(parent_seq.begin(), parent_seq.end(), 0);
    std::vector<int64_t> strength(n);
    for (int64_t v = 0; v < n; ++v) strength[v] = rp2[v + 1] - rp2[v];
    std::vector<int64_t> stamp(n, -1);
    std::vector<double> wacc(n, 0.0);
    std::vector<int64_t> touched;
    touched.reserve(256);
    for (int64_t idx = 0; idx < n; ++idx) {
      const int64_t v = order[idx];
      const int64_t beg = rp2[v], end = rp2[v + 1];
      if (beg == end) continue;
      const int64_t rv = uf_find(parent_seq, v);
      touched.clear();
      for (int64_t i = beg; i < end; ++i) {
        const int64_t rn = uf_find(parent_seq, cols2[i]);
        if (rn == rv) continue;
        if (stamp[rn] != idx) {
          stamp[rn] = idx;
          wacc[rn] = 0.0;
          touched.push_back(rn);
        }
        wacc[rn] += 1.0;
      }
      int64_t best = -1;
      double best_gain = 0.0;
      const double sv = double(strength[rv]);
      for (int64_t rn : touched) {
        const double gain = wacc[rn] - sv * double(strength[rn]) / two_w;
        if (gain > best_gain) {
          best_gain = gain;
          best = rn;
        }
      }
      if (best >= 0) {
        parent_seq[rv] = best;
        strength[best] += strength[rv];
        record_child(best, rv);
      }
    }
  }

  // --- dendrogram-DFS permutation (rabbit_order.hpp:623-673 analog) -----
  // Roots in ascending vertex id; each subtree emits the representative
  // first, then its children in merge order — recently merged
  // sub-communities stay contiguous inside their community.
  std::vector<int64_t> merged_into(n);
  if (parallel_merge) {
    for (int64_t v = 0; v < n; ++v)
      merged_into[v] = parent_at[v].load(std::memory_order_relaxed);
  } else {
    merged_into = parent_seq;
  }
  int64_t pos = 0;
  std::vector<int64_t> stack;
  for (int64_t r = 0; r < n; ++r) {
    if (merged_into[r] != r) continue;  // not a top-level community
    stack.push_back(r);
    while (!stack.empty()) {
      const int64_t u = stack.back();
      stack.pop_back();
      perm_out[u] = pos++;
      // push children reversed so DFS visits them in merge order
      int64_t count = 0;
      for (int64_t c = child_head[u]; c >= 0; c = child_next[c]) ++count;
      const size_t base = stack.size();
      stack.resize(base + count);
      int64_t w = count;
      for (int64_t c = child_head[u]; c >= 0; c = child_next[c]) {
        stack[base + (--w)] = c;
      }
    }
  }
  return pos == n ? 0 : -2;
}

// ---------------------------------------------------------------------------
// Neighbor-partition builder (GNNAdvisor.cpp:210-251): split each CSR row
// into ceil(deg/part_size) parts; emits partPtr / part2Node.  Two-call
// pattern: returns the part count; fills buffers when capacity suffices.
// ---------------------------------------------------------------------------
int64_t gt_build_parts(const int32_t* row_ptr, int64_t n, int64_t part_size,
                       int32_t* part_ptr, int32_t* part2node,
                       int64_t capacity) {
  int64_t num_parts = 0;
  for (int64_t v = 0; v < n; ++v) {
    const int64_t d = row_ptr[v + 1] - row_ptr[v];
    num_parts += (d + part_size - 1) / part_size;
  }
  if (!part_ptr || !part2node || num_parts > capacity) return num_parts;
  int64_t p = 0;
  for (int64_t v = 0; v < n; ++v) {
    for (int64_t s = row_ptr[v]; s < row_ptr[v + 1]; s += part_size) {
      part_ptr[p] = static_cast<int32_t>(s);
      part2node[p] = static_cast<int32_t>(v);
      ++p;
    }
  }
  part_ptr[num_parts] = row_ptr[n];
  return num_parts;
}

}  // extern "C"
