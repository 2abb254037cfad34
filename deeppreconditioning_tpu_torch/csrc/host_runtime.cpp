// Host runtime of the PyTorch port: the sequential host steps that prepare
// index plans and incomplete factors for the device code.
//
//   * dptpu_conv_plan     -- sparse-conv output sites and gather maps of a
//                            sorted, stride-1, ordinary layer
//                            (ops/sparse_conv.py::build_conv_maps)
//   * dptpu_ic0           -- in-place IC(0) on a tril CSR pattern
//                            (ops/ic0.py::ic0_factor)
//   * dptpu_ict           -- left-looking ICT with threshold dropping and a
//                            fill cap (ops/ic0.py::ict_factor)
//   * dptpu_levels        -- dependency levels of a lower-triangular factor
//                            (ops/trisolve.py::compute_levels)
//   * dptpu_fvm_assemble  -- the FVM pressure-Poisson assembly (bound and
//                            tested; the port assembles in numpy)
//
// The same entry points, contracts and arithmetic as the JAX package's
// native/src/dptpu.cpp, compiled by the port itself with g++ on first use
// (_backend.host_library) and bound with ctypes (native/__init__.py).  All
// counts and row pointers are int64, all indices int32, as numpy gives
// them.  Built with -ffp-contract=off, so no multiply-add is fused and each
// factor rounds as the numpy version of the same step does.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Sparse-conv plan builder.
//
// Inputs: nnz active sites (rows, cols) on an (h_in, w_in) grid, sorted by
// linearized id row * w_in + col; kernel (kh, kw), padding (ph, pw),
// stride 1.  Ordinary (non-submanifold) convolution: the output active set
// is the input set dilated by the kernel footprint.
//
// Outputs (caller-allocated):
//   out_rows/out_cols — capacity nnz * kh * kw
//   gather            — capacity kh * kw * nnz * kh * kw, row-major
//                       (offset k, out index), sentinel -1 where the
//                       contributing input site is inactive.
// Returns nnz_out.
int64_t dptpu_conv_plan(int64_t nnz, const int32_t* rows,
                        const int32_t* cols, int32_t h_in, int32_t w_in,
                        int32_t kh, int32_t kw, int32_t ph, int32_t pw,
                        int32_t* out_rows, int32_t* out_cols,
                        int32_t* gather) {
  const int32_t h_out = h_in + 2 * ph - kh + 1;
  const int32_t w_out = w_in + 2 * pw - kw + 1;

  // input linearized ids (already sorted by contract; verify cheaply)
  std::vector<int64_t> lin_in(nnz);
  for (int64_t i = 0; i < nnz; ++i)
    lin_in[i] = (int64_t)rows[i] * w_in + cols[i];

  // candidate output sites
  std::vector<int64_t> cand;
  cand.reserve(nnz * kh * kw);
  for (int32_t ki = 0; ki < kh; ++ki) {
    for (int32_t kj = 0; kj < kw; ++kj) {
      for (int64_t i = 0; i < nnz; ++i) {
        const int32_t ro = rows[i] + ph - ki;
        const int32_t co = cols[i] + pw - kj;
        if (ro >= 0 && ro < h_out && co >= 0 && co < w_out)
          cand.push_back((int64_t)ro * w_out + co);
      }
    }
  }
  std::sort(cand.begin(), cand.end());
  cand.erase(std::unique(cand.begin(), cand.end()), cand.end());
  const int64_t nnz_out = (int64_t)cand.size();

  for (int64_t o = 0; o < nnz_out; ++o) {
    out_rows[o] = (int32_t)(cand[o] / w_out);
    out_cols[o] = (int32_t)(cand[o] % w_out);
  }

  // gather maps: binary search each contributing input site
  for (int32_t ki = 0; ki < kh; ++ki) {
    for (int32_t kj = 0; kj < kw; ++kj) {
      int32_t* g = gather + (int64_t)(ki * kw + kj) * nnz_out;
      for (int64_t o = 0; o < nnz_out; ++o) {
        const int32_t ri = out_rows[o] - ph + ki;
        const int32_t ci = out_cols[o] - pw + kj;
        if (ri < 0 || ri >= h_in || ci < 0 || ci >= w_in) {
          g[o] = -1;
          continue;
        }
        const int64_t key = (int64_t)ri * w_in + ci;
        auto it = std::lower_bound(lin_in.begin(), lin_in.end(), key);
        g[o] = (it != lin_in.end() && *it == key)
                   ? (int32_t)(it - lin_in.begin())
                   : -1;
      }
    }
  }
  return nnz_out;
}

// ---------------------------------------------------------------------------
// IC(0): in-place incomplete Cholesky on a lower-triangular CSR pattern
// (column indices ascending per row, diagonal last).  Returns 0 on
// success, 1-based row index of the first non-positive pivot otherwise.
int64_t dptpu_ic0(int64_t n, const int64_t* indptr, const int32_t* indices,
                  double* data) {
  // diag_pos[i] = index of the diagonal entry of row i
  std::vector<int64_t> diag_pos(n);
  for (int64_t i = 0; i < n; ++i) diag_pos[i] = indptr[i + 1] - 1;

  for (int64_t i = 0; i < n; ++i) {
    const int64_t lo = indptr[i], hi = indptr[i + 1];
    for (int64_t idx = lo; idx < hi; ++idx) {
      const int32_t j = indices[idx];
      double s = data[idx];
      // two-pointer dot of row i and row j over columns < j
      int64_t pi = lo, pj = indptr[j];
      const int64_t pj_end = indptr[j + 1];
      while (pi < idx && pj < pj_end) {
        const int32_t ci = indices[pi], cj = indices[pj];
        if (ci >= j || cj >= j) break;
        if (ci == cj) {
          s -= data[pi] * data[pj];
          ++pi;
          ++pj;
        } else if (ci < cj) {
          ++pi;
        } else {
          ++pj;
        }
      }
      if (j < i) {
        data[idx] = s / data[diag_pos[j]];
      } else {  // diagonal
        if (s <= 0.0) return i + 1;
        data[idx] = std::sqrt(s);
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// ICT: left-looking incomplete Cholesky with threshold dropping and a
// fill cap per row.  Inputs: full symmetric A in CSR.  Outputs a tril CSR
// factor written into caller buffers (capacity: per-row a_nnz_row +
// add_fill_in + 1).  Returns nnz of L, or -1 on capacity overflow.
int64_t dptpu_ict(int64_t n, const int64_t* a_indptr,
                  const int32_t* a_indices, const double* a_data,
                  int32_t add_fill_in, double threshold,
                  int64_t* l_indptr, int32_t* l_indices, double* l_data,
                  int64_t capacity) {
  std::vector<std::vector<int32_t>> l_cols(n);
  std::vector<std::vector<double>> l_vals(n);
  std::vector<double> l_diag(n, 0.0);
  std::vector<double> w(n, 0.0);      // dense work row
  std::vector<int32_t> wset;          // nonzero positions in w
  std::vector<char> inw(n, 0);

  // column-linked structure: for each column j, the rows i > j with
  // L[i][j] != 0 appear as we factor; we need row j's L entries, which we
  // keep in l_cols/l_vals directly.
  for (int64_t i = 0; i < n; ++i) {
    wset.clear();
    double aii = 0.0;
    for (int64_t p = a_indptr[i]; p < a_indptr[i + 1]; ++p) {
      const int32_t j = a_indices[p];
      if (j < i) {
        w[j] = a_data[p];
        if (!inw[j]) {
          inw[j] = 1;
          wset.push_back(j);
        }
      } else if (j == i) {
        aii = a_data[p];
      }
    }
    // IKJ form: w holds A[i, :i]; for each pivot j ascending, finalize
    // l_ij = (w[j] - sum_{k<j} L[i,k] L[j,k]) / L[j,j] using the sparse
    // rows accepted so far.  Restricting pivots to pattern(A row i)
    // plus dropped fill keeps this the "no new fill chains" ICT variant
    // (same class as ilupp's icholt with a fill cap).
    std::sort(wset.begin(), wset.end());
    std::vector<int32_t> row_cols;
    std::vector<double> row_vals;
    double norm2 = 0.0;
    for (size_t s = 0; s < wset.size(); ++s) norm2 += w[wset[s]] * w[wset[s]];
    const double drop = threshold * std::sqrt(norm2);
    for (size_t s = 0; s < wset.size(); ++s) {
      const int32_t j = wset[s];
      double val = w[j];
      // dot row_cols (this row's accepted entries) with L row j
      size_t pi = 0, pj = 0;
      const auto& cj = l_cols[j];
      const auto& vj = l_vals[j];
      while (pi < row_cols.size() && pj < cj.size()) {
        if (row_cols[pi] == cj[pj]) {
          val -= row_vals[pi] * vj[pj];
          ++pi;
          ++pj;
        } else if (row_cols[pi] < cj[pj]) {
          ++pi;
        } else {
          ++pj;
        }
      }
      const double lij = val / l_diag[j];
      if (std::fabs(lij) >= drop) {
        row_cols.push_back(j);
        row_vals.push_back(lij);
      }
    }
    // fill cap: keep largest (a_row_nnz + add_fill_in) entries
    const int64_t a_row_nnz = a_indptr[i + 1] - a_indptr[i];
    const size_t budget = (size_t)std::max<int64_t>(
        0, a_row_nnz + add_fill_in);
    if (row_cols.size() > budget) {
      std::vector<size_t> order(row_cols.size());
      for (size_t s = 0; s < order.size(); ++s) order[s] = s;
      std::partial_sort(
          order.begin(), order.begin() + budget, order.end(),
          [&](size_t a, size_t b) {
            return std::fabs(row_vals[a]) > std::fabs(row_vals[b]);
          });
      order.resize(budget);
      std::sort(order.begin(), order.end());
      std::vector<int32_t> nc;
      std::vector<double> nv;
      for (size_t s : order) {
        nc.push_back(row_cols[s]);
        nv.push_back(row_vals[s]);
      }
      row_cols.swap(nc);
      row_vals.swap(nv);
    }
    double pivot = aii;
    for (size_t s = 0; s < row_cols.size(); ++s)
      pivot -= row_vals[s] * row_vals[s];
    if (pivot < 1e-12) pivot = 1e-12;
    l_diag[i] = std::sqrt(pivot);
    l_cols[i] = std::move(row_cols);
    l_vals[i] = std::move(row_vals);
    // reset work row
    for (int32_t j : wset) {
      w[j] = 0.0;
      inw[j] = 0;
    }
  }

  // emit CSR (diag last per row)
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    l_indptr[i] = pos;
    const int64_t need = (int64_t)l_cols[i].size() + 1;
    if (pos + need > capacity) return -1;
    for (size_t s = 0; s < l_cols[i].size(); ++s) {
      l_indices[pos] = l_cols[i][s];
      l_data[pos] = l_vals[i][s];
      ++pos;
    }
    l_indices[pos] = (int32_t)i;
    l_data[pos] = l_diag[i];
    ++pos;
  }
  l_indptr[n] = pos;
  return pos;
}

// ---------------------------------------------------------------------------
// Dependency levelization of a lower-triangular CSR factor:
// level[i] = 1 + max(level[j]) over strictly-lower entries j of row i.
void dptpu_levels(int64_t n, const int64_t* indptr, const int32_t* indices,
                  int32_t* levels) {
  for (int64_t i = 0; i < n; ++i) {
    int32_t lv = 0;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int32_t j = indices[p];
      if (j < i && levels[j] + 1 > lv) lv = levels[j] + 1;
    }
    levels[i] = lv;
  }
}


// ---------------------------------------------------------------------------
// FVM pressure-Poisson assembly — the C++ form of the numpy assembler
// (data/fvm.py assemble_pressure_poisson), which mirrors OpenFOAM's
// fvm::laplacian assembly (pEqn.H:43-96).  2-D structured grid, harmonic face
// interpolation of rau = dt / rho, Dirichlet top boundary folded into the
// diagonal.  Emits COO triplets (capacity >= 5 * n); returns nnz.
int64_t dptpu_fvm_assemble(int32_t ny, int32_t nx, const double* rho,
                           double dx, double dy, double dt,
                           int32_t dirichlet_top, int32_t* rows,
                           int32_t* cols, double* vals,
                           double* diag_extra) {
  const int64_t n = (int64_t)ny * nx;
  std::vector<double> diag(n, 0.0);
  std::vector<double> rau(n);
  for (int64_t i = 0; i < n; ++i) rau[i] = dt / rho[i];

  int64_t pos = 0;
  auto face = [&](int64_t p, int64_t q, double area_over_dist) {
    const double rf = 2.0 * rau[p] * rau[q] / (rau[p] + rau[q]);
    const double c = rf * area_over_dist;
    rows[pos] = (int32_t)p;
    cols[pos] = (int32_t)q;
    vals[pos] = -c;
    ++pos;
    rows[pos] = (int32_t)q;
    cols[pos] = (int32_t)p;
    vals[pos] = -c;
    ++pos;
    diag[p] += c;
    diag[q] += c;
  };

  for (int32_t j = 0; j < ny; ++j)
    for (int32_t i = 0; i + 1 < nx; ++i)
      face((int64_t)j * nx + i, (int64_t)j * nx + i + 1, dy / dx);
  for (int32_t j = 0; j + 1 < ny; ++j)
    for (int32_t i = 0; i < nx; ++i)
      face((int64_t)j * nx + i, (int64_t)(j + 1) * nx + i, dx / dy);

  for (int64_t i = 0; i < n; ++i) diag_extra[i] = 0.0;
  if (dirichlet_top) {
    for (int32_t i = 0; i < nx; ++i) {
      const int64_t cell = (int64_t)(ny - 1) * nx + i;
      const double c_b = rau[cell] * dx / (dy / 2.0);
      diag_extra[cell] = c_b;
      diag[cell] += c_b;
    }
  } else {
    diag[0] += 1.0;
  }

  for (int64_t i = 0; i < n; ++i) {
    rows[pos] = (int32_t)i;
    cols[pos] = (int32_t)i;
    vals[pos] = diag[i];
    ++pos;
  }
  return pos;
}

}  // extern "C"
