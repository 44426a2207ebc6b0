// Dense linear assignment (Jonker-Volgenant) — native host-side solver.
//
// Replaces the reference's third-party `lapsolver.solve_dense` /
// `lap.lapjv` C++ wheels (reference: src/fitting_utils.py:372,
// src/utils.py:231). Used by the host post-processing paths (spline refit
// correspondence, uv-grid assignment); the on-device jit path uses the JAX
// auction solver in ops/hungarian.py.
//
// Implementation: classic JV with column reduction, augmenting row
// reduction, and shortest augmenting paths (Dijkstra-style), O(n^3).
#include <cfloat>
#include <cstdint>
#include <cstddef>
using std::size_t;
#include <vector>

extern "C" {

// cost: row-major n x n matrix. Outputs: col_of_row[n], row_of_col[n].
// Returns the optimal total cost.
double lapjv(const double* cost, int32_t n, int32_t* col_of_row,
             int32_t* row_of_col) {
  if (n <= 0) return 0.0;
  std::vector<double> v(n, 0.0);
  std::vector<int32_t> rowsol(n, -1), colsol(n, -1);
  std::vector<int32_t> free_rows(n);
  int32_t num_free = 0;

  auto C = [&](int32_t r, int32_t c) { return cost[(size_t)r * n + c]; };

  // --- column reduction
  for (int32_t c = n - 1; c >= 0; --c) {
    double minv = C(0, c);
    int32_t imin = 0;
    for (int32_t r = 1; r < n; ++r) {
      if (C(r, c) < minv) { minv = C(r, c); imin = r; }
    }
    v[c] = minv;
    if (rowsol[imin] == -1) {
      rowsol[imin] = c;
      colsol[c] = imin;
    }
  }
  for (int32_t r = 0; r < n; ++r)
    if (rowsol[r] == -1) free_rows[num_free++] = r;

  // --- augmenting row reduction (two sweeps)
  for (int sweep = 0; sweep < 2; ++sweep) {
    int32_t prev_free = num_free;
    num_free = 0;
    int32_t k = 0;
    while (k < prev_free) {
      int32_t r = free_rows[k++];
      double min1 = DBL_MAX, min2 = DBL_MAX;
      int32_t c1 = 0;
      for (int32_t c = 0; c < n; ++c) {
        double h = C(r, c) - v[c];
        if (h < min1) { min2 = min1; min1 = h; c1 = c; }
        else if (h < min2) { min2 = h; }
      }
      int32_t i0 = colsol[c1];
      if (min1 < min2) {
        v[c1] -= (min2 - min1);
      } else if (i0 >= 0) {
        // tie: try the second-best column
        for (int32_t c = 0; c < n; ++c) {
          if (c != c1 && C(r, c) - v[c] == min2 && colsol[c] < 0) {
            c1 = c; i0 = -1; break;
          }
        }
      }
      rowsol[r] = c1;
      if (i0 >= 0) {
        rowsol[i0] = -1;
        if (min1 < min2) {
          // r stays in the current list (re-examine the displaced row later)
          free_rows[--k] = i0;
        } else {
          free_rows[num_free++] = i0;
        }
      }
      colsol[c1] = r;
    }
  }

  // --- shortest augmenting paths for the remaining free rows
  std::vector<double> d(n);
  std::vector<int32_t> pred(n);
  std::vector<uint8_t> done(n);
  for (int32_t f = 0; f < num_free; ++f) {
    int32_t r0 = free_rows[f];
    for (int32_t c = 0; c < n; ++c) {
      d[c] = C(r0, c) - v[c];
      pred[c] = r0;
      done[c] = 0;
    }
    int32_t c_final = -1;
    double mind = 0.0;
    std::vector<int32_t> scanned;
    while (c_final < 0) {
      mind = DBL_MAX;
      int32_t c_min = -1;
      for (int32_t c = 0; c < n; ++c)
        if (!done[c] && d[c] < mind) { mind = d[c]; c_min = c; }
      done[c_min] = 1;
      scanned.push_back(c_min);
      if (colsol[c_min] < 0) {
        c_final = c_min;
        break;
      }
      int32_t r = colsol[c_min];
      // relax through row r: the path reaches r at distance `mind`; the
      // reduced edge r->c costs (C(r,c)-v[c]) - (C(r,c_min)-v[c_min])
      double base = C(r, c_min) - v[c_min];
      for (int32_t c = 0; c < n; ++c) {
        if (done[c]) continue;
        double nd = mind + (C(r, c) - v[c]) - base;
        if (nd < d[c]) { d[c] = nd; pred[c] = r; }
      }
    }
    // update potentials along scanned columns
    for (int32_t idx = 0; idx < (int32_t)scanned.size(); ++idx) {
      int32_t c = scanned[idx];
      v[c] += d[c] - mind;
    }
    // augment along the alternating path
    int32_t c = c_final;
    while (true) {
      int32_t r = pred[c];
      colsol[c] = r;
      int32_t tmp = rowsol[r];
      rowsol[r] = c;
      if (r == r0) break;
      c = tmp;
    }
  }

  double total = 0.0;
  for (int32_t r = 0; r < n; ++r) {
    col_of_row[r] = rowsol[r];
    row_of_col[rowsol[r]] = r;
    total += C(r, rowsol[r]);
  }
  return total;
}

// Batched variant: costs [b, n, n] row-major; out [b, n].
void lapjv_batch(const double* costs, int32_t b, int32_t n,
                 int32_t* col_of_row) {
  std::vector<int32_t> roc(n);
  for (int32_t i = 0; i < b; ++i) {
    lapjv(costs + (size_t)i * n * n, n, col_of_row + (size_t)i * n,
          roc.data());
  }
}

}  // extern "C"
