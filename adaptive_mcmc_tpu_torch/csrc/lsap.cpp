// lsap.cpp — exact linear sum assignment (Hungarian algorithm with
// potentials, O(n^2 m)) for the exact 1-1 Wasserstein metric, as a small
// host library of the PyTorch port.
//
// The assignment problem is sequential (augmenting paths), so it runs on
// the host.  metrics/assignment.py compiles this file with the host C++
// compiler into adaptive_mcmc_tpu_torch/_build/liblsap-<digest>.so at
// first use and calls it through ctypes; tests hold it to SciPy's
// linear_sum_assignment.  The port's own copy of the JAX package's
// _native/lsap.cpp: the code below is the same.
//
// Algorithm: the classic shortest-augmenting-path Hungarian method with
// dual potentials (Jonker–Volgenant family).  For each row we grow an
// alternating tree over columns, maintaining reduced costs, until an
// unmatched column is reached, then augment and update the potentials.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// cost: row-major (nr x nc), nr <= nc required.
// row_to_col: output, length nr.
// Returns 0 on success, -1 on infeasible/invalid input.
int lsap_solve_f64(int64_t nr, int64_t nc, const double* cost,
                   int64_t* row_to_col) {
  if (nr <= 0 || nc <= 0 || nr > nc) return -1;
  const double INF = std::numeric_limits<double>::infinity();

  // col_to_row[0] is a virtual root slot; columns are 1-indexed internally.
  std::vector<double> u(nr + 1, 0.0), v(nc + 1, 0.0);
  std::vector<int64_t> col_to_row(nc + 1, 0);
  std::vector<int64_t> parent_col(nc + 1, 0);

  std::vector<double> min_reduced(nc + 1);
  std::vector<char> in_tree(nc + 1);

  for (int64_t row = 1; row <= nr; ++row) {
    col_to_row[0] = row;
    int64_t j0 = 0;
    std::fill(min_reduced.begin(), min_reduced.end(), INF);
    std::fill(in_tree.begin(), in_tree.end(), 0);

    do {
      in_tree[j0] = 1;
      const int64_t i0 = col_to_row[j0];
      double delta = INF;
      int64_t j1 = -1;
      const double* crow = cost + (i0 - 1) * nc;

      for (int64_t j = 1; j <= nc; ++j) {
        if (in_tree[j]) continue;
        const double red = crow[j - 1] - u[i0] - v[j];
        if (red < min_reduced[j]) {
          min_reduced[j] = red;
          parent_col[j] = j0;
        }
        if (min_reduced[j] < delta) {
          delta = min_reduced[j];
          j1 = j;
        }
      }
      if (j1 < 0 || delta == INF) return -1;

      for (int64_t j = 0; j <= nc; ++j) {
        if (in_tree[j]) {
          u[col_to_row[j]] += delta;
          v[j] -= delta;
        } else {
          min_reduced[j] -= delta;
        }
      }
      j0 = j1;
    } while (col_to_row[j0] != 0);

    // Augment along the alternating path back to the root.
    while (j0 != 0) {
      const int64_t j1 = parent_col[j0];
      col_to_row[j0] = col_to_row[j1];
      j0 = j1;
    }
  }

  for (int64_t j = 1; j <= nc; ++j) {
    if (col_to_row[j] > 0) row_to_col[col_to_row[j] - 1] = j - 1;
  }
  return 0;
}

int lsap_solve_f32(int64_t nr, int64_t nc, const float* cost,
                   int64_t* row_to_col) {
  std::vector<double> c(static_cast<size_t>(nr) * nc);
  for (size_t k = 0; k < c.size(); ++k) c[k] = cost[k];
  return lsap_solve_f64(nr, nc, c.data(), row_to_col);
}

}  // extern "C"
