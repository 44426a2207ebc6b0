// Statistical outlier removal — native host-side implementation.
//
// Equivalent of Open3D's remove_statistical_outlier used by the reference's
// eval-time fitting (reference: src/fitting_utils.py:704-710, called from
// src/primitive_forward.py:986-1035): for each point compute the mean
// distance to its k nearest neighbours; points whose mean distance exceeds
// mean + std_ratio * std over the cloud are marked as outliers.
//
// Brute-force O(n^2 k) neighbour search — eval segments are <= a few
// thousand points, and this runs on the host post-processing path only.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// points: [n, 3] row-major float32. keep_mask: [n] uint8 output (1 = keep).
// Returns the number of kept points.
int32_t remove_statistical_outliers(const float* points, int32_t n,
                                    int32_t nb_neighbors, float std_ratio,
                                    uint8_t* keep_mask) {
  if (n <= 0) return 0;
  int32_t k = std::min(nb_neighbors, n - 1);
  if (k <= 0) {
    for (int32_t i = 0; i < n; ++i) keep_mask[i] = 1;
    return n;
  }
  std::vector<double> mean_dist(n);
  std::vector<float> d2(n);
  for (int32_t i = 0; i < n; ++i) {
    const float* pi = points + (size_t)i * 3;
    for (int32_t j = 0; j < n; ++j) {
      const float* pj = points + (size_t)j * 3;
      float dx = pi[0] - pj[0], dy = pi[1] - pj[1], dz = pi[2] - pj[2];
      d2[j] = dx * dx + dy * dy + dz * dz;
    }
    d2[i] = 1e30f;  // exclude self
    std::nth_element(d2.begin(), d2.begin() + k - 1, d2.end());
    double acc = 0.0;
    for (int32_t j = 0; j < k; ++j) acc += std::sqrt((double)d2[j]);
    mean_dist[i] = acc / k;
  }
  double mu = 0.0;
  for (int32_t i = 0; i < n; ++i) mu += mean_dist[i];
  mu /= n;
  double var = 0.0;
  for (int32_t i = 0; i < n; ++i) {
    double d = mean_dist[i] - mu;
    var += d * d;
  }
  double sigma = std::sqrt(var / n);
  double thresh = mu + std_ratio * sigma;
  int32_t kept = 0;
  for (int32_t i = 0; i < n; ++i) {
    keep_mask[i] = mean_dist[i] <= thresh ? 1 : 0;
    kept += keep_mask[i];
  }
  return kept;
}

}  // extern "C"
