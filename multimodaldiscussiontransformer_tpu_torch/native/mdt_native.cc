// Host-side graph-preprocessing helpers of the PyTorch port (the port's own
// copy of the JAX package's native/mdt_native.cc). The functional
// equivalents of:
//   - the reference's per-tree Python recursion for relative (up, down)
//     tree distances (hateful_discussions.py:242-264), and
//   - the reference's (vestigial) Cython Floyd–Warshall APSP
//     (mDT/src/data/algos.pyx:7-52),
// for the ingestion and collation hot loops. A plain C ABI, loaded from
// Python with ctypes (native/loader.py).
//
// Build (native/loader.py does it at first use, into the package's _build/):
//   g++ -O3 -shared -fPIC -std=c++17 -o libmdt_native.so mdt_native.cc

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// All-pairs (up, down) tree distances.
//   parents: length-n array of parent indices, -1 for the root.
//   out:     n*n*2 int64 buffer; out[(i*n + j)*2 + {0,1}] = (up, down) where
//            up = depth(i) - depth(lca), down = depth(j) - depth(lca).
// Returns 0 on success, nonzero on malformed input (cycle / bad parent).
int mdt_tree_distance_pairs(const int64_t* parents, int64_t n, int64_t* out) {
  if (n <= 0) return 0;
  std::vector<int64_t> depth(n, -1);
  std::vector<int64_t> chain;
  for (int64_t i = 0; i < n; ++i) {
    chain.clear();
    int64_t j = i;
    while (j != -1 && depth[j] < 0) {
      chain.push_back(j);
      j = parents[j];
      if (j < -1 || j >= n) return 1;
      if ((int64_t)chain.size() > n) return 2;  // cycle
    }
    int64_t base = (j == -1) ? 0 : depth[j] + 1;
    for (int64_t k = (int64_t)chain.size() - 1; k >= 0; --k) {
      depth[chain[(size_t)k]] = base + ((int64_t)chain.size() - 1 - k);
    }
  }
  int64_t max_depth = 0;
  for (int64_t i = 0; i < n; ++i)
    if (depth[i] > max_depth) max_depth = depth[i];
  // ancestor-at-depth table: anc[i * (max_depth+1) + d]
  const int64_t nd = max_depth + 1;
  std::vector<int64_t> anc((size_t)(n * nd), -1);
  for (int64_t i = 0; i < n; ++i) {
    int64_t j = i, d = depth[i];
    while (j != -1) {
      anc[(size_t)(i * nd + d)] = j;
      j = parents[j];
      --d;
    }
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t* ai = &anc[(size_t)(i * nd)];
    const int64_t di = depth[i];
    for (int64_t j = 0; j < n; ++j) {
      const int64_t* aj = &anc[(size_t)(j * nd)];
      const int64_t dj = depth[j];
      int64_t lim = di < dj ? di : dj;
      // multi-root forests: nodes in different trees share no ancestor;
      // lca depth -1 matches the numpy path (a virtual super-root one
      // level above every root)
      int64_t lca_d = -1;
      for (int64_t d = lim; d >= 0; --d) {
        if (ai[d] == aj[d] && ai[d] >= 0) {
          lca_d = d;
          break;
        }
      }
      out[(size_t)((i * n + j) * 2) + 0] = di - lca_d;
      out[(size_t)((i * n + j) * 2) + 1] = dj - lca_d;
    }
  }
  return 0;
}

// Dense Floyd–Warshall all-pairs shortest path.
//   adj: n*n int64; nonzero = unit edge. Modifies nothing; writes to out.
//   unreachable: clamp value for disconnected pairs (reference uses 510).
void mdt_floyd_warshall(const int64_t* adj, int64_t n, int64_t unreachable,
                        int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < n; ++j) {
      int64_t v = adj[(size_t)(i * n + j)];
      out[(size_t)(i * n + j)] = (i == j) ? 0 : (v != 0 ? 1 : unreachable);
    }
  }
  for (int64_t k = 0; k < n; ++k) {
    const int64_t* rk = &out[(size_t)(k * n)];
    for (int64_t i = 0; i < n; ++i) {
      int64_t* ri = &out[(size_t)(i * n)];
      const int64_t ik = ri[k];
      if (ik >= unreachable) continue;
      for (int64_t j = 0; j < n; ++j) {
        const int64_t c = ik + rk[j];
        if (ri[j] > c) ri[j] = c;
      }
    }
  }
  for (int64_t i = 0; i < n * n; ++i)
    if (out[i] >= unreachable) out[i] = unreachable;
}

// Map (up, down) distance pairs to spatial buckets given a lookup table.
//   pairs:   n*n*2 int64 (up, down)
//   table:   (clip+1)*(clip+1) int64 bucket ids for clipped (up, down)
//   clip:    max per-component distance (reference clips at 5)
//   out:     n*n int64 bucket ids
void mdt_spatial_buckets(const int64_t* pairs, int64_t n, const int64_t* table,
                         int64_t clip, int64_t* out) {
  const int64_t w = clip + 1;
  for (int64_t idx = 0; idx < n * n; ++idx) {
    int64_t u = pairs[(size_t)(idx * 2)];
    int64_t d = pairs[(size_t)(idx * 2) + 1];
    if (u > clip || d > clip) {
      u = clip;
      d = clip;
    }
    out[idx] = table[(size_t)(u * w + d)];
  }
}

}  // extern "C"
