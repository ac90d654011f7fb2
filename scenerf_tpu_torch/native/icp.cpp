// Native point-to-point ICP registration.
//
// Host-side C++ replacement for the reference's open3d registration_icp
// dependency (ref scenerf/data/utils/helpers.py:106-114: point-to-point,
// max_correspondence 0.2 m, max 200 iterations) used to refine KITTI relative
// poses during preprocessing. Nearest neighbors come from a uniform grid hash
// (cell = max correspondence distance, 27-cell probe); the rigid alignment per
// iteration uses Horn's quaternion method (power iteration on the 4x4
// N-matrix), which avoids an SVD dependency.
//
// C ABI consumed by ctypes (scenerf_tpu_torch/data/icp.py); built by
// scenerf_tpu_torch/native/build.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct GridNN {
  float cell;
  std::unordered_map<uint64_t, std::vector<int>> buckets;
  const float* pts;
  int n;

  static uint64_t key(int64_t x, int64_t y, int64_t z) {
    // offset to keep coordinates positive within 21 bits each
    const int64_t off = 1 << 20;
    return (static_cast<uint64_t>(x + off) << 42) |
           (static_cast<uint64_t>(y + off) << 21) |
           static_cast<uint64_t>(z + off);
  }

  void build(const float* p, int count, float cell_size) {
    pts = p;
    n = count;
    cell = cell_size;
    buckets.clear();
    buckets.reserve(count);
    for (int i = 0; i < count; i++) {
      int64_t cx = static_cast<int64_t>(std::floor(p[3 * i] / cell));
      int64_t cy = static_cast<int64_t>(std::floor(p[3 * i + 1] / cell));
      int64_t cz = static_cast<int64_t>(std::floor(p[3 * i + 2] / cell));
      buckets[key(cx, cy, cz)].push_back(i);
    }
  }

  // nearest neighbor within `cell` of q; returns -1 if none
  int query(const float* q, float* dist2_out) const {
    int64_t cx = static_cast<int64_t>(std::floor(q[0] / cell));
    int64_t cy = static_cast<int64_t>(std::floor(q[1] / cell));
    int64_t cz = static_cast<int64_t>(std::floor(q[2] / cell));
    int best = -1;
    float best_d2 = cell * cell;
    for (int64_t dx = -1; dx <= 1; dx++)
      for (int64_t dy = -1; dy <= 1; dy++)
        for (int64_t dz = -1; dz <= 1; dz++) {
          auto it = buckets.find(key(cx + dx, cy + dy, cz + dz));
          if (it == buckets.end()) continue;
          for (int i : it->second) {
            float ddx = pts[3 * i] - q[0];
            float ddy = pts[3 * i + 1] - q[1];
            float ddz = pts[3 * i + 2] - q[2];
            float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
            if (d2 < best_d2) {
              best_d2 = d2;
              best = i;
            }
          }
        }
    *dist2_out = best_d2;
    return best;
  }
};

// Rotation from Horn's quaternion method: dominant eigenvector of the 4x4
// N-matrix built from the cross-covariance H.
void horn_rotation(const double H[9], double R[9]) {
  const double Sxx = H[0], Sxy = H[1], Sxz = H[2];
  const double Syx = H[3], Syy = H[4], Syz = H[5];
  const double Szx = H[6], Szy = H[7], Szz = H[8];
  double N[16] = {
      Sxx + Syy + Szz, Syz - Szy,       Szx - Sxz,       Sxy - Syx,
      Syz - Szy,       Sxx - Syy - Szz, Sxy + Syx,       Szx + Sxz,
      Szx - Sxz,       Sxy + Syx,       -Sxx + Syy - Szz, Syz + Szy,
      Sxy - Syx,       Szx + Sxz,       Syz + Szy,       -Sxx - Syy + Szz};

  // shift to make the dominant eigenvalue strictly largest in magnitude
  double trace_bound = 0;
  for (int i = 0; i < 16; i++) trace_bound += std::fabs(N[i]);
  for (int i = 0; i < 4; i++) N[5 * i] += trace_bound;

  double q[4] = {1, 0, 0, 0};
  for (int it = 0; it < 200; it++) {
    double nq[4] = {0, 0, 0, 0};
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) nq[i] += N[4 * i + j] * q[j];
    double norm = std::sqrt(nq[0] * nq[0] + nq[1] * nq[1] + nq[2] * nq[2] +
                            nq[3] * nq[3]);
    if (norm < 1e-30) break;
    double delta = 0;
    for (int i = 0; i < 4; i++) {
      nq[i] /= norm;
      delta += std::fabs(nq[i] - q[i]);
      q[i] = nq[i];
    }
    if (delta < 1e-14) break;
  }
  const double w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1 - 2 * (y * y + z * z);
  R[1] = 2 * (x * y - w * z);
  R[2] = 2 * (x * z + w * y);
  R[3] = 2 * (x * y + w * z);
  R[4] = 1 - 2 * (x * x + z * z);
  R[5] = 2 * (y * z - w * x);
  R[6] = 2 * (x * z - w * y);
  R[7] = 2 * (y * z + w * x);
  R[8] = 1 - 2 * (x * x + y * y);
}

}  // namespace

extern "C" {

// Register source onto target: finds T (row-major 4x4 out) minimizing
// point-to-point distances, open3d-style. Returns achieved inlier RMSE.
double icp_register(const float* src, int n_src, const float* tgt, int n_tgt,
                    float max_dist, int max_iter, double* T_out) {
  GridNN nn;
  nn.build(tgt, n_tgt, max_dist);

  double T[16] = {1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1};
  std::vector<float> cur(static_cast<size_t>(n_src) * 3);
  for (int i = 0; i < n_src * 3; i++) cur[i] = src[i];

  double prev_rmse = -1.0;
  double rmse = 0.0;
  for (int iter = 0; iter < max_iter; iter++) {
    // correspondences
    double cs[3] = {0, 0, 0}, ct[3] = {0, 0, 0};
    std::vector<int> pair_s, pair_t;
    pair_s.reserve(n_src);
    pair_t.reserve(n_src);
    double err2 = 0;
    for (int i = 0; i < n_src; i++) {
      float d2;
      int j = nn.query(&cur[3 * i], &d2);
      if (j < 0) continue;
      pair_s.push_back(i);
      pair_t.push_back(j);
      err2 += d2;
    }
    if (pair_s.size() < 3) break;
    rmse = std::sqrt(err2 / pair_s.size());
    if (prev_rmse >= 0 && std::fabs(prev_rmse - rmse) < 1e-6) break;
    prev_rmse = rmse;

    size_t m = pair_s.size();
    for (size_t k = 0; k < m; k++) {
      for (int d = 0; d < 3; d++) {
        cs[d] += cur[3 * pair_s[k] + d];
        ct[d] += tgt[3 * pair_t[k] + d];
      }
    }
    for (int d = 0; d < 3; d++) {
      cs[d] /= m;
      ct[d] /= m;
    }

    double H[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (size_t k = 0; k < m; k++) {
      double a[3], b[3];
      for (int d = 0; d < 3; d++) {
        a[d] = cur[3 * pair_s[k] + d] - cs[d];
        b[d] = tgt[3 * pair_t[k] + d] - ct[d];
      }
      for (int r = 0; r < 3; r++)
        for (int c = 0; c < 3; c++) H[3 * r + c] += a[r] * b[c];
    }

    double R[9];
    horn_rotation(H, R);
    double t[3];
    for (int r = 0; r < 3; r++)
      t[r] = ct[r] - (R[3 * r] * cs[0] + R[3 * r + 1] * cs[1] +
                      R[3 * r + 2] * cs[2]);

    // T = [R t] @ T
    double Tn[16];
    for (int r = 0; r < 3; r++) {
      for (int c = 0; c < 4; c++) {
        Tn[4 * r + c] = R[3 * r] * T[c] + R[3 * r + 1] * T[4 + c] +
                        R[3 * r + 2] * T[8 + c];
      }
      Tn[4 * r + 3] += t[r];
    }
    Tn[12] = 0;
    Tn[13] = 0;
    Tn[14] = 0;
    Tn[15] = 1;
    std::memcpy(T, Tn, sizeof(T));

    // re-transform the source points
    for (int i = 0; i < n_src; i++) {
      double px = src[3 * i], py = src[3 * i + 1], pz = src[3 * i + 2];
      for (int r = 0; r < 3; r++) {
        cur[3 * i + r] = static_cast<float>(
            T[4 * r] * px + T[4 * r + 1] * py + T[4 * r + 2] * pz +
            T[4 * r + 3]);
      }
    }
  }
  std::memcpy(T_out, T, sizeof(T));
  return rmse;
}

}  // extern "C"
