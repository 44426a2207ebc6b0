// As-rigid-as-possible (ARAP) surface deformation — native solver.
//
// Equivalent of Open3D's TriangleMesh::deform_as_rigid_as_possible used by
// the reference's spline post-optimization (reference:
// src/fitting_optimization.py:32-114 `Arap`, max_iter=500): given a
// triangle mesh and a set of pinned handle vertices with target positions,
// alternate (Sorkine & Alexa 2007):
//   local step:  per-vertex rotation R_i from the SVD of the weighted
//                covariance of original vs current edge vectors,
//   global step: solve the cotangent-Laplacian system L p' = b with handle
//                rows eliminated, via conjugate gradient.
//
// Plain C++ (no Eigen dependency): sparse CSR Laplacian + CG; 3x3 SVD via
// cyclic Jacobi on S^T S.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct CSR {
  std::vector<int32_t> indptr, indices;
  std::vector<double> data;
  int32_t n = 0;
};

// --- 3x3 helpers -----------------------------------------------------------
static void jacobi_eig3(const double A[9], double V[9], double w[3]) {
  double a[9];
  std::memcpy(a, A, sizeof(a));
  double v[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
  for (int sweep = 0; sweep < 12; ++sweep) {
    static const int pq[3][2] = {{0, 1}, {0, 2}, {1, 2}};
    for (int t = 0; t < 3; ++t) {
      int p = pq[t][0], q = pq[t][1];
      double apq = a[p * 3 + q];
      if (std::fabs(apq) < 1e-15) continue;
      double theta = 0.5 * std::atan2(2 * apq, a[q * 3 + q] - a[p * 3 + p]);
      double c = std::cos(theta), s = std::sin(theta);
      for (int kk = 0; kk < 3; ++kk) {  // a = J^T a J (apply from both sides)
        double akp = a[kk * 3 + p], akq = a[kk * 3 + q];
        a[kk * 3 + p] = c * akp - s * akq;
        a[kk * 3 + q] = s * akp + c * akq;
      }
      for (int kk = 0; kk < 3; ++kk) {
        double apk = a[p * 3 + kk], aqk = a[q * 3 + kk];
        a[p * 3 + kk] = c * apk - s * aqk;
        a[q * 3 + kk] = s * apk + c * aqk;
      }
      for (int kk = 0; kk < 3; ++kk) {
        double vkp = v[kk * 3 + p], vkq = v[kk * 3 + q];
        v[kk * 3 + p] = c * vkp - s * vkq;
        v[kk * 3 + q] = s * vkp + c * vkq;
      }
    }
  }
  for (int i = 0; i < 3; ++i) w[i] = a[i * 3 + i];
  std::memcpy(V, v, sizeof(v));
}

// Rotation part of the polar decomposition of S (det(R) = +1).
static void polar_rotation(const double S[9], double R[9]) {
  double StS[9] = {0};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k)
        StS[i * 3 + j] += S[k * 3 + i] * S[k * 3 + j];
  double V[9], w[3];
  jacobi_eig3(StS, V, w);
  // S^+half-inverse: R = S V diag(1/sqrt(w)) V^T, with degenerate guards
  double inv_sqrt[3];
  for (int i = 0; i < 3; ++i)
    inv_sqrt[i] = w[i] > 1e-12 ? 1.0 / std::sqrt(w[i]) : 0.0;
  double M[9] = {0};  // V diag V^T
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k)
        M[i * 3 + j] += V[i * 3 + k] * inv_sqrt[k] * V[j * 3 + k];
  double Rt[9] = {0};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k)
        Rt[i * 3 + j] += S[i * 3 + k] * M[k * 3 + j];
  // det correction -> proper rotation
  double det = Rt[0] * (Rt[4] * Rt[8] - Rt[5] * Rt[7])
             - Rt[1] * (Rt[3] * Rt[8] - Rt[5] * Rt[6])
             + Rt[2] * (Rt[3] * Rt[7] - Rt[4] * Rt[6]);
  if (det < 0) {
    // flip the axis of the smallest singular value
    int mi = 0;
    for (int i = 1; i < 3; ++i)
      if (w[i] < w[mi]) mi = i;
    double flipped[9];
    std::memcpy(flipped, M, sizeof(M));
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        flipped[i * 3 + j] -= 2.0 * V[i * 3 + mi] * inv_sqrt[mi] * V[j * 3 + mi];
    std::memset(Rt, 0, sizeof(Rt));
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        for (int k = 0; k < 3; ++k)
          Rt[i * 3 + j] += S[i * 3 + k] * flipped[k * 3 + j];
  }
  // guard fully-degenerate S
  double norm = 0;
  for (int i = 0; i < 9; ++i) norm += Rt[i] * Rt[i];
  if (!(norm > 1e-12)) {
    std::memset(Rt, 0, sizeof(Rt));
    Rt[0] = Rt[4] = Rt[8] = 1.0;
  }
  std::memcpy(R, Rt, sizeof(Rt));
}

// CG for SPD CSR system with pinned rows treated as identity.
static void cg_solve(const CSR& L, const std::vector<uint8_t>& pinned,
                     const double* b, double* x, int max_iter, double tol) {
  int32_t n = L.n;
  std::vector<double> r(n), p(n), Ap(n);
  auto matvec = [&](const double* in, double* out) {
    for (int32_t i = 0; i < n; ++i) {
      if (pinned[i]) {
        out[i] = in[i];
        continue;
      }
      double acc = 0;
      for (int32_t jj = L.indptr[i]; jj < L.indptr[i + 1]; ++jj) {
        int32_t j = L.indices[jj];
        acc += L.data[jj] * (pinned[j] ? 0.0 : in[j]);
      }
      out[i] = acc;
    }
  };
  matvec(x, Ap.data());
  double rs = 0;
  for (int32_t i = 0; i < n; ++i) {
    r[i] = b[i] - Ap[i];
    if (pinned[i]) r[i] = 0;
    p[i] = r[i];
    rs += r[i] * r[i];
  }
  for (int it = 0; it < max_iter && rs > tol; ++it) {
    matvec(p.data(), Ap.data());
    double pAp = 0;
    for (int32_t i = 0; i < n; ++i) pAp += p[i] * Ap[i];
    if (pAp <= 0) break;
    double alpha = rs / pAp;
    double rs_new = 0;
    for (int32_t i = 0; i < n; ++i) {
      x[i] += alpha * p[i];
      r[i] -= alpha * Ap[i];
      rs_new += r[i] * r[i];
    }
    double beta = rs_new / rs;
    rs = rs_new;
    for (int32_t i = 0; i < n; ++i) p[i] = r[i] + beta * p[i];
  }
}

}  // namespace

extern "C" {

// vertices: [n, 3] float32 (modified in place to the deformed positions)
// triangles: [m, 3] int32
// handle_idx: [h] int32, handle_pos: [h, 3] float32
// max_iter: ARAP outer iterations (reference uses 500 in Open3D)
void arap_deform(float* vertices, int32_t n, const int32_t* triangles,
                 int32_t m, const int32_t* handle_idx,
                 const float* handle_pos, int32_t h, int32_t max_iter) {
  if (n <= 0 || m <= 0) return;
  // --- cotangent weights -> CSR Laplacian
  std::vector<std::vector<std::pair<int32_t, double>>> adj(n);
  auto add_w = [&](int32_t i, int32_t j, double w) {
    for (auto& pr : adj[i])
      if (pr.first == j) { pr.second += w; return; }
    adj[i].push_back({j, w});
  };
  const float* V0 = vertices;
  for (int32_t t = 0; t < m; ++t) {
    int32_t i0 = triangles[t * 3], i1 = triangles[t * 3 + 1],
            i2 = triangles[t * 3 + 2];
    int32_t idx[3] = {i0, i1, i2};
    for (int corner = 0; corner < 3; ++corner) {
      int32_t a = idx[corner], b = idx[(corner + 1) % 3],
              c = idx[(corner + 2) % 3];
      // cot at vertex a for edge (b, c)
      double u[3], v[3];
      for (int d = 0; d < 3; ++d) {
        u[d] = V0[b * 3 + d] - V0[a * 3 + d];
        v[d] = V0[c * 3 + d] - V0[a * 3 + d];
      }
      double dot = u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
      double cx = u[1] * v[2] - u[2] * v[1];
      double cy = u[2] * v[0] - u[0] * v[2];
      double cz = u[0] * v[1] - u[1] * v[0];
      double crs = std::sqrt(cx * cx + cy * cy + cz * cz);
      double cot = dot / (crs > 1e-12 ? crs : 1e-12);
      cot = std::max(std::min(cot, 1e4), -1e4) * 0.5;
      add_w(b, c, cot);
      add_w(c, b, cot);
    }
  }
  // clamp negative weights slightly for stability
  for (int32_t i = 0; i < n; ++i)
    for (auto& pr : adj[i]) pr.second = std::max(pr.second, 1e-6);

  CSR L;
  L.n = n;
  L.indptr.assign(n + 1, 0);
  for (int32_t i = 0; i < n; ++i) L.indptr[i + 1] = L.indptr[i] + adj[i].size() + 1;
  L.indices.resize(L.indptr[n]);
  L.data.resize(L.indptr[n]);
  for (int32_t i = 0; i < n; ++i) {
    int32_t o = L.indptr[i];
    double diag = 0;
    for (size_t jj = 0; jj < adj[i].size(); ++jj) {
      L.indices[o + jj] = adj[i][jj].first;
      L.data[o + jj] = -adj[i][jj].second;
      diag += adj[i][jj].second;
    }
    L.indices[o + adj[i].size()] = i;
    L.data[o + adj[i].size()] = diag + 1e-9;
  }

  std::vector<uint8_t> pinned(n, 0);
  std::vector<double> P(n * 3);     // current positions
  std::vector<double> orig(n * 3);  // original positions
  for (int32_t i = 0; i < n * 3; ++i) orig[i] = P[i] = vertices[i];
  for (int32_t k = 0; k < h; ++k) {
    int32_t i = handle_idx[k];
    pinned[i] = 1;
    for (int d = 0; d < 3; ++d) P[i * 3 + d] = handle_pos[k * 3 + d];
  }

  std::vector<double> R(n * 9);
  std::vector<double> b(n), x(n);
  for (int it = 0; it < max_iter; ++it) {
    // --- local step: per-vertex rotations
    for (int32_t i = 0; i < n; ++i) {
      double S[9] = {0};
      for (int32_t jj = L.indptr[i]; jj < L.indptr[i + 1]; ++jj) {
        int32_t j = L.indices[jj];
        if (j == i) continue;
        double w = -L.data[jj];
        double e0[3], e1[3];
        for (int d = 0; d < 3; ++d) {
          e0[d] = orig[i * 3 + d] - orig[j * 3 + d];
          e1[d] = P[i * 3 + d] - P[j * 3 + d];
        }
        for (int a = 0; a < 3; ++a)
          for (int c = 0; c < 3; ++c) S[a * 3 + c] += w * e0[a] * e1[c];
      }
      polar_rotation(S, &R[i * 9]);  // R maps orig edges -> current edges
    }
    // --- global step: solve per coordinate
    for (int d = 0; d < 3; ++d) {
      for (int32_t i = 0; i < n; ++i) {
        if (pinned[i]) {
          b[i] = P[i * 3 + d];
          x[i] = P[i * 3 + d];
          continue;
        }
        double acc = 0;
        for (int32_t jj = L.indptr[i]; jj < L.indptr[i + 1]; ++jj) {
          int32_t j = L.indices[jj];
          if (j == i) continue;
          double w = -L.data[jj];
          double e0[3] = {orig[i * 3] - orig[j * 3],
                          orig[i * 3 + 1] - orig[j * 3 + 1],
                          orig[i * 3 + 2] - orig[j * 3 + 2]};
          double re[3] = {0, 0, 0};
          for (int a = 0; a < 3; ++a)
            for (int c = 0; c < 3; ++c)
              re[a] += 0.5 * (R[i * 9 + a * 3 + c] + R[j * 9 + a * 3 + c]) * e0[c];
          acc += w * re[d];
        }
        // pinned neighbours contribute w * P_j to the rhs (eliminated cols)
        for (int32_t jj = L.indptr[i]; jj < L.indptr[i + 1]; ++jj) {
          int32_t j = L.indices[jj];
          if (j != i && pinned[j]) acc += (-L.data[jj]) * P[j * 3 + d];
        }
        b[i] = acc;
        x[i] = P[i * 3 + d];
      }
      cg_solve(L, pinned, b.data(), x.data(), 200, 1e-12);
      for (int32_t i = 0; i < n; ++i)
        if (!pinned[i]) P[i * 3 + d] = x[i];
    }
  }
  for (int32_t i = 0; i < n * 3; ++i) vertices[i] = (float)P[i];
}

}  // extern "C"
