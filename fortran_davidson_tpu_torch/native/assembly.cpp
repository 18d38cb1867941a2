// Host-side sparse assembly kernels (COO -> padded ELL).
//
// The TPU framework's native runtime layer: the reference's only native
// code is the external LAPACK/BLAS binary it links against
// (the reference's CMakeLists.txt:29-49); the device-side equivalents of
// those routines live in XLA/Pallas, while THIS file covers the
// host-side data path — one-time operator assembly, which for the
// north-star scales (1e7+ rows, ~5e8 nnz) is worth doing without
// numpy's intermediate fancy-index copies.
//
// Exposed via ctypes (see __init__.py); every function is exercised
// against the pure-numpy fallback in tests/test_native.py.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

template <typename T>
int64_t ell_from_coo(int64_t n, int64_t nnz, const int64_t* rows,
                     const int64_t* cols, const T* vals, int64_t L,
                     int32_t* indices_out, T* values_out) {
  std::vector<int64_t> order(nnz);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (rows[a] != rows[b]) return rows[a] < rows[b];
    return cols[a] < cols[b];
  });

  if (L > 0) {
    for (int64_t r = 0; r < n; ++r) {
      for (int64_t l = 0; l < L; ++l) {
        indices_out[r * L + l] = static_cast<int32_t>(r);
        values_out[r * L + l] = T(0);
      }
    }
  }

  int64_t maxcount = 0;
  int64_t i = 0;
  while (i < nnz) {
    const int64_t r = rows[order[i]];
    if (r < 0 || r >= n) return -1;
    int64_t slot = 0;
    while (i < nnz && rows[order[i]] == r) {
      const int64_t c = cols[order[i]];
      if (c < 0 || c >= n) return -1;
      T s = T(0);
      while (i < nnz && rows[order[i]] == r && cols[order[i]] == c) {
        s += vals[order[i]];
        ++i;
      }
      if (L > 0 && slot < L) {
        indices_out[r * L + slot] = static_cast<int32_t>(c);
        values_out[r * L + slot] = s;
      }
      ++slot;
    }
    maxcount = std::max(maxcount, slot);
  }
  return maxcount;
}

// Reverse Cuthill-McKee ordering on the symmetrized COO pattern.
// perm_out[i] = original index of the node placed at new position i.
// Classic bandwidth-reducing reordering: BFS from a minimum-degree seed
// per component, neighbors visited in ascending degree, order reversed.
int64_t rcm_order_impl(int64_t n, int64_t nnz, const int64_t* rows,
                       const int64_t* cols, int64_t* perm_out) {
  // Build symmetric adjacency in CSR (self loops dropped, duplicates
  // tolerated — duplicates only cost a little BFS work).
  std::vector<int64_t> deg(n, 0);
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t r = rows[i], c = cols[i];
    if (r < 0 || r >= n || c < 0 || c >= n) return -1;
    if (r == c) continue;
    ++deg[r];
    ++deg[c];
  }
  std::vector<int64_t> ptr(n + 1, 0);
  for (int64_t v = 0; v < n; ++v) ptr[v + 1] = ptr[v] + deg[v];
  std::vector<int64_t> adj(ptr[n]);
  std::vector<int64_t> fill(ptr.begin(), ptr.end() - 1);
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t r = rows[i], c = cols[i];
    if (r == c) continue;
    adj[fill[r]++] = c;
    adj[fill[c]++] = r;
  }

  std::vector<char> seen(n, 0);
  std::vector<int64_t> order;
  order.reserve(n);
  std::vector<int64_t> queue;
  queue.reserve(n);

  // Seeds in ascending degree: cheap pseudo-peripheral heuristic.
  std::vector<int64_t> seeds(n);
  std::iota(seeds.begin(), seeds.end(), 0);
  std::sort(seeds.begin(), seeds.end(), [&](int64_t a, int64_t b) {
    if (deg[a] != deg[b]) return deg[a] < deg[b];
    return a < b;
  });

  std::vector<int64_t> nbrs;
  for (int64_t s : seeds) {
    if (seen[s]) continue;
    seen[s] = 1;
    queue.clear();
    queue.push_back(s);
    for (size_t qi = 0; qi < queue.size(); ++qi) {
      const int64_t v = queue[qi];
      order.push_back(v);
      nbrs.clear();
      for (int64_t p = ptr[v]; p < ptr[v + 1]; ++p) {
        const int64_t u = adj[p];
        if (!seen[u]) {
          seen[u] = 1;
          nbrs.push_back(u);
        }
      }
      std::sort(nbrs.begin(), nbrs.end(), [&](int64_t a, int64_t b) {
        if (deg[a] != deg[b]) return deg[a] < deg[b];
        return a < b;
      });
      for (int64_t u : nbrs) queue.push_back(u);
    }
  }
  std::reverse(order.begin(), order.end());
  std::copy(order.begin(), order.end(), perm_out);
  return 0;
}

}  // namespace

extern "C" {

// Reverse Cuthill-McKee: fills perm_out (length n) with the new-to-old
// node order; returns 0, or -1 on out-of-range indices.
int64_t rcm_order(int64_t n, int64_t nnz, const int64_t* rows,
                  const int64_t* cols, int64_t* perm_out) {
  return rcm_order_impl(n, nnz, rows, cols, perm_out);
}

// Returns the max number of unique columns in any row (the required ELL
// width), or -1 on out-of-range indices. With L == 0 only counts; with
// L > 0 also fills the (n, L) row-major padded tables (padded slots:
// index = own row, value = 0). Duplicate (row, col) entries are summed.
int64_t ell_from_coo_f64(int64_t n, int64_t nnz, const int64_t* rows,
                         const int64_t* cols, const double* vals, int64_t L,
                         int32_t* indices_out, double* values_out) {
  return ell_from_coo<double>(n, nnz, rows, cols, vals, L, indices_out,
                              values_out);
}

int64_t ell_from_coo_f32(int64_t n, int64_t nnz, const int64_t* rows,
                         const int64_t* cols, const float* vals, int64_t L,
                         int32_t* indices_out, float* values_out) {
  return ell_from_coo<float>(n, nnz, rows, cols, vals, L, indices_out,
                             values_out);
}

}  // extern "C"
