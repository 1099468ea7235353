// Native host kernels of the PyTorch port: setup-time work that is too
// slow in Python at a million rows.
//   - sptpu_ilu0: ILU(0) factorization on CSR (-pc_type ilu's PCSetUp)
//   - sptpu_rcm: reverse Cuthill-McKee ordering (csr_to_dia's RCM option)
//   - sptpu_aggregate: greedy standard aggregation (gamg's PCSetUp)
//   - sptpu_coo_to_csr: COO triplets -> CSR with duplicates summed
//   - sptpu_lower_solve_unit, sptpu_upper_solve: exact sequential CSR
//     triangular solves (a host check of the ILU(0) factors)
//
// Copies of the functions of the same names in the JAX package's
// saddle_point_petsc_tpu/csrc/sptpu_native.cpp, so that the port builds
// and loads nothing of that package; tests/test_torch_utils.py and
// tests/test_torch_ilu.py hold them to the same arrays. Host code, not
// device kernels.
//
// Built at first use by saddle_point_petsc_tpu_torch/utils/native.py:
//   g++ -O3 -std=c++17 -shared -fPIC -o <out> native_host.cpp
// and loaded through ctypes; every caller keeps a numpy/scipy fallback.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// ILU(0): in-place IKJ factorization restricted to the sparsity pattern.
// indptr/indices: CSR structure (column indices sorted within each row);
// data: values, overwritten with L (strict lower, unit diagonal implicit)
// and U (upper with the diagonal). Returns 0 on success, else row + 1 of
// a missing structural diagonal or of a zero pivot.
int64_t sptpu_ilu0(int64_t n, const int32_t* indptr, const int32_t* indices,
                   double* data) {
  std::vector<int32_t> diag(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      if (indices[p] == i) {
        diag[i] = p;
        break;
      }
    }
    if (diag[i] < 0) return i + 1;  // missing structural diagonal
  }
  // workspace: position of column j in the current row (or -1)
  std::vector<int32_t> pos(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t row_beg = indptr[i], row_end = indptr[i + 1];
    for (int32_t p = row_beg; p < row_end; ++p) pos[indices[p]] = p;
    for (int32_t kk = row_beg; kk < row_end; ++kk) {
      const int32_t k = indices[kk];
      if (k >= i) break;
      const double akk = data[diag[k]];
      if (akk == 0.0) {
        for (int32_t p = row_beg; p < row_end; ++p) pos[indices[p]] = -1;
        return k + 1;
      }
      const double lik = data[kk] / akk;
      data[kk] = lik;
      // a_ij -= l_ik * u_kj for j > k within the pattern of row i, as one
      // fused multiply-add: the JAX package's build (-march=native) contracts
      // it so on any host with FMA, and std::fma rounds it so on every host
      for (int32_t pp = diag[k] + 1; pp < indptr[k + 1]; ++pp) {
        const int32_t j = indices[pp];
        const int32_t pj = pos[j];
        if (pj >= 0) data[pj] = std::fma(-lik, data[pp], data[pj]);
      }
    }
    for (int32_t p = row_beg; p < row_end; ++p) pos[indices[p]] = -1;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// COO -> CSR with duplicate summation.  rows/cols/vals: nnz triplets
// (rows < 0 = padding, dropped).  Outputs: indptr (m+1), out_cols/out_vals
// (capacity nnz; first *out_nnz entries valid).  Returns 0.
// ---------------------------------------------------------------------------
int64_t sptpu_coo_to_csr(int64_t m, int64_t nnz, const int32_t* rows,
                         const int32_t* cols, const double* vals,
                         int32_t* indptr, int32_t* out_cols, double* out_vals,
                         int64_t* out_nnz) {
  std::vector<int64_t> order(nnz);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    const int32_t ra = rows[a] < 0 ? INT32_MAX : rows[a];
    const int32_t rb = rows[b] < 0 ? INT32_MAX : rows[b];
    if (ra != rb) return ra < rb;
    return cols[a] < cols[b];
  });
  int64_t w = -1;
  int32_t prev_r = -2, prev_c = -2;
  for (int64_t q = 0; q < nnz; ++q) {
    const int64_t e = order[q];
    const int32_t r = rows[e];
    if (r < 0 || r >= m) continue;
    const int32_t c = cols[e];
    if (r == prev_r && c == prev_c) {
      out_vals[w] += vals[e];
    } else {
      ++w;
      out_cols[w] = c;
      out_vals[w] = vals[e];
      prev_r = r;
      prev_c = c;
    }
    // record row starts lazily below
  }
  const int64_t total = w + 1;
  *out_nnz = total;
  // rebuild indptr with a counting pass over deduped entries
  std::fill(indptr, indptr + m + 1, 0);
  {
    int64_t w2 = -1;
    prev_r = -2;
    prev_c = -2;
    for (int64_t q = 0; q < nnz; ++q) {
      const int64_t e = order[q];
      const int32_t r = rows[e];
      if (r < 0 || r >= m) continue;
      const int32_t c = cols[e];
      if (!(r == prev_r && c == prev_c)) {
        ++w2;
        indptr[r + 1] += 1;
        prev_r = r;
        prev_c = c;
      }
    }
  }
  for (int64_t i = 0; i < m; ++i) indptr[i + 1] += indptr[i];
  return 0;
}

// ---------------------------------------------------------------------------
// CSR triangular solves (exact, sequential) — host-side validation path and
// small-system coarse solves.  L: strict lower w/ unit diag; U incl diag.
// ---------------------------------------------------------------------------
void sptpu_lower_solve_unit(int64_t n, const int32_t* indptr,
                            const int32_t* indices, const double* data,
                            const double* b, double* x) {
  for (int64_t i = 0; i < n; ++i) {
    double s = b[i];
    // s -= a_ij x_j as one fused multiply-add, as in sptpu_ilu0
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
      s = std::fma(-data[p], x[indices[p]], s);
    x[i] = s;
  }
}

void sptpu_upper_solve(int64_t n, const int32_t* indptr,
                       const int32_t* indices, const double* data,
                       const double* b, double* x) {
  for (int64_t i = n - 1; i >= 0; --i) {
    double s = b[i];
    double d = 1.0;
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int32_t j = indices[p];
      if (j == i)
        d = data[p];
      else if (j > i)
        s = std::fma(-data[p], x[j], s);
    }
    x[i] = s / d;
  }
}

// Reverse Cuthill-McKee ordering (bandwidth reduction). indptr/indices:
// CSR structure of a symmetric pattern. perm (out, length n).
void sptpu_rcm(int64_t n, const int32_t* indptr, const int32_t* indices,
               int32_t* perm) {
  std::vector<int32_t> deg(n);
  for (int64_t i = 0; i < n; ++i) deg[i] = indptr[i + 1] - indptr[i];
  std::vector<char> visited(n, 0);
  std::vector<int32_t> order;
  order.reserve(n);
  std::vector<int32_t> queue;
  while ((int64_t)order.size() < n) {
    // pick unvisited vertex of minimum degree as the next component seed
    int32_t seed = -1, best = INT32_MAX;
    for (int64_t i = 0; i < n; ++i)
      if (!visited[i] && deg[i] < best) {
        best = deg[i];
        seed = (int32_t)i;
      }
    if (seed < 0) break;
    queue.clear();
    queue.push_back(seed);
    visited[seed] = 1;
    for (size_t qh = 0; qh < queue.size(); ++qh) {
      const int32_t v = queue[qh];
      order.push_back(v);
      std::vector<int32_t> nbrs;
      for (int32_t p = indptr[v]; p < indptr[v + 1]; ++p) {
        const int32_t u = indices[p];
        if (!visited[u]) {
          visited[u] = 1;
          nbrs.push_back(u);
        }
      }
      std::sort(nbrs.begin(), nbrs.end(),
                [&](int32_t a, int32_t b) { return deg[a] < deg[b]; });
      for (int32_t u : nbrs) queue.push_back(u);
    }
  }
  for (int64_t i = 0; i < n; ++i) perm[i] = order[n - 1 - i];  // reverse
}

// Greedy standard aggregation over a strength graph (smoothed-aggregation
// AMG setup). indptr/indices: CSR of the strong off-diagonal connections
// (symmetric). agg (out, length n): aggregate id per node. Returns the
// aggregate count. Three passes (Vanek/Mandel/Brezina):
//   1. a node whose strong neighbours are all unaggregated roots a new
//      aggregate containing itself and those neighbours;
//   2. remaining nodes attach to the first adjacent aggregate (decided on
//      the state after pass 1);
//   3. leftovers form aggregates with any still-free strong neighbours.
int64_t sptpu_aggregate(int64_t n, const int32_t* indptr,
                        const int32_t* indices, int32_t* agg) {
  for (int64_t i = 0; i < n; ++i) agg[i] = -1;
  int32_t na = 0;
  for (int64_t i = 0; i < n; ++i) {  // pass 1
    if (agg[i] >= 0) continue;
    bool free_nbhd = true;
    for (int32_t p = indptr[i]; p < indptr[i + 1] && free_nbhd; ++p)
      if (agg[indices[p]] >= 0) free_nbhd = false;
    if (!free_nbhd) continue;
    agg[i] = na;
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
      agg[indices[p]] = na;
    ++na;
  }
  std::vector<int32_t> attach(n, -1);  // pass 2
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] >= 0) continue;
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (agg[indices[p]] >= 0) {
        attach[i] = agg[indices[p]];
        break;
      }
  }
  for (int64_t i = 0; i < n; ++i)
    if (attach[i] >= 0) agg[i] = attach[i];
  for (int64_t i = 0; i < n; ++i) {  // pass 3
    if (agg[i] >= 0) continue;
    agg[i] = na;
    for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (agg[indices[p]] < 0) agg[indices[p]] = na;
    ++na;
  }
  return na;
}

}  // extern "C"
