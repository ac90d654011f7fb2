// Kernel G-bwd: backward of the multi-level bilinear gather (kernel G).
//
// Replaces the TPU-shaped backward of the JAX package's bilinear sampling:
// the custom VJPs of scenerf_tpu/ops/gather_scatter.py:129 (win2, backward
// at :141-176), :229 (mm) and :362 (mmseg), and the autodiff of
// geometry.py:106 bilinear_sample that the default "taps" path takes. On the
// training path it carries the gradient of the field latent [N, 2480] back
// into the five pyramid levels (rendering.py:64 featurize_points), of the
// encoder taps into the decoder (sphere_decoder.py:69), and of the target
// colors into the reprojected pixel coords (losses.py:53 via
// geometry.py:179 sample_pix_features).
//
// For every point p and level l with a gradient buffer it adds the cotangent
// slice dout[p, col_l : col_l + C_l] times the four corner weights of kernel
// G into the channel-last level gradient d_level[l] [H_l * W_l, C_l] (f32,
// zeroed by the caller); out-of-bounds corners are skipped. Where the caller
// asks for coordinate gradients (d_ix, d_iy not null) it re-gathers the four
// masked corner values and writes
//   d_ix[l, p] = sum_c g_c ((v10 - v00)(1 - wy) + (v11 - v01) wy)
//   d_iy[l, p] = sum_c g_c ((v01 (1 - wx) + v11 wx) - (v00 (1 - wx) + v10 wx))
// (the floor of a coordinate has zero derivative, as in autodiff of the
// plain version).
//
// Bound: device-memory bytes. A point reads its cotangent row (2480 floats
// at the KITTI widths) once and adds it, four times weighted, into up to four
// rows of every level. Design: one warp per point, lanes across channels, so
// a warp's 32 atomic adds hit 128 consecutive bytes of one row; f32
// atomicAdd (red.global.add) accumulates in L2. Atomics make the summation
// order, and so the last bits of d_level, depend on the schedule: compare by
// tolerance. The corner weights are the plain version's autograd products,
// (g * (1 - wy)) * (1 - wx) and so on, with explicitly rounded multiplies.
#include <stdint.h>

#include "common.cuh"

namespace scenerf {
namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;

struct LevelsBwd {
  const float* val[kMaxLevels];  // level values; read only for coord grads
  float* grad[kMaxLevels];       // level gradients; null: no gradient wanted
  int H[kMaxLevels];
  int W[kMaxLevels];
  int C[kMaxLevels];
  int col[kMaxLevels];
  int n;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * kWarpSize)
gather_levels_bwd_kernel(LevelsBwd lv, const float* __restrict__ ix,
                         const float* __restrict__ iy, int n_points,
                         const float* __restrict__ dout, int out_cols,
                         float* __restrict__ d_ix, float* __restrict__ d_iy) {
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int64_t p = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= n_points) return;
  const float* grow = dout + p * (int64_t)out_cols;
  const bool want_xy = d_ix != nullptr;

  for (int l = 0; l < lv.n; ++l) {
    float* g = lv.grad[l];
    if (g == nullptr && !want_xy) continue;
    const int H = lv.H[l], W = lv.W[l], C = lv.C[l];
    const float x = ix[(int64_t)l * n_points + p];
    const float y = iy[(int64_t)l * n_points + p];
    const float x0 = floorf(x), y0 = floorf(y);
    const float wx = __fsub_rn(x, x0), wy = __fsub_rn(y, y0);
    const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
    // the same corner bounds as kernel G: a huge or NaN coordinate is never cast
    const bool x0in = x0 >= 0.0f && x0 < (float)W;
    const bool x1in = x0 >= -1.0f && x0 < (float)(W - 1);
    const bool y0in = y0 >= 0.0f && y0 < (float)H;
    const bool y1in = y0 >= -1.0f && y0 < (float)(H - 1);
    const int64_t xi = x0in || x1in ? (int64_t)x0 : 0;
    const int64_t yi = y0in || y1in ? (int64_t)y0 : 0;
    const int64_t o00 = x0in && y0in ? (yi * W + xi) * C : -1;
    const int64_t o10 = x1in && y0in ? (yi * W + xi + 1) * C : -1;
    const int64_t o01 = x0in && y1in ? ((yi + 1) * W + xi) * C : -1;
    const int64_t o11 = x1in && y1in ? ((yi + 1) * W + xi + 1) * C : -1;
    const float* gcol = grow + lv.col[l];
    const float* v = lv.val[l];

    float sx = 0.f, sy = 0.f;
    for (int c = lane; c < C; c += kWarpSize) {
      const float go = gcol[c];
      const float gt = __fmul_rn(go, uy);  // cotangent of the top row pair
      const float gb = __fmul_rn(go, wy);  // ... and of the bottom pair
      if (g != nullptr) {
        if (o00 >= 0) atomicAdd(g + o00 + c, __fmul_rn(gt, ux));
        if (o10 >= 0) atomicAdd(g + o10 + c, __fmul_rn(gt, wx));
        if (o01 >= 0) atomicAdd(g + o01 + c, __fmul_rn(gb, ux));
        if (o11 >= 0) atomicAdd(g + o11 + c, __fmul_rn(gb, wx));
      }
      if (want_xy) {
        const float v00 = o00 >= 0 ? v[o00 + c] : 0.f;
        const float v10 = o10 >= 0 ? v[o10 + c] : 0.f;
        const float v01 = o01 >= 0 ? v[o01 + c] : 0.f;
        const float v11 = o11 >= 0 ? v[o11 + c] : 0.f;
        const float top = __fadd_rn(__fmul_rn(v00, ux), __fmul_rn(v10, wx));
        const float bot = __fadd_rn(__fmul_rn(v01, ux), __fmul_rn(v11, wx));
        sx = __fadd_rn(sx, __fadd_rn(__fmul_rn(gt, __fsub_rn(v10, v00)),
                                     __fmul_rn(gb, __fsub_rn(v11, v01))));
        sy = __fadd_rn(sy, __fmul_rn(go, __fsub_rn(bot, top)));
      }
    }
    if (want_xy) {
      sx = warp_sum(sx);
      sy = warp_sum(sy);
      if (lane == 0) {
        d_ix[(int64_t)l * n_points + p] = sx;
        d_iy[(int64_t)l * n_points + p] = sy;
      }
    }
  }
}

}  // namespace
}  // namespace scenerf

// level_vals[l]: device pointer of the contiguous [H, W, C] f32 map l (read
// only when d_ix is not null); level_grads[l]: its zeroed [H, W, C] f32
// gradient, or null for a level that needs none; hwcc[4 * l ...]: H, W, C and
// the column offset of level l in dout. ix, iy: [n_levels, n_points] f32;
// dout: [n_points, out_cols] f32; d_ix, d_iy: [n_levels, n_points] f32, or
// both null when the coordinates need no gradient.
SCENERF_API int scenerf_gather_levels_bwd_f32(
    const void* const* level_vals, void* const* level_grads, const int* hwcc,
    int n_levels, const float* ix, const float* iy, int n_points,
    const float* dout, int out_cols, float* d_ix, float* d_iy, void* stream) {
  using namespace scenerf;
  if (n_levels < 1 || n_levels > kMaxLevels || n_points < 0 ||
      ((d_ix == nullptr) != (d_iy == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_points == 0) return (int)cudaSuccess;
  LevelsBwd lv;
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.val[l] = static_cast<const float*>(level_vals[l]);
    lv.grad[l] = static_cast<float*>(level_grads[l]);
    lv.H[l] = hwcc[4 * l + 0];
    lv.W[l] = hwcc[4 * l + 1];
    lv.C[l] = hwcc[4 * l + 2];
    lv.col[l] = hwcc[4 * l + 3];
    if (d_ix != nullptr && lv.val[l] == nullptr) return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = ((int64_t)n_points + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gather_levels_bwd_kernel<<<(unsigned)blocks, kWarpsPerBlock * kWarpSize, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      lv, ix, iy, n_points, dout, out_cols, d_ix, d_iy);
  return (int)cudaGetLastError();
}
