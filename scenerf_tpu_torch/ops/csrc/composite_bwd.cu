// Kernel C-bwd: backward of the per-ray sort + alpha composite (kernel C).
//
// Replaces the autodiff that the JAX package takes through
// scenerf_tpu/sampling.py:198 sort_samples_by_distance (take_along_axis
// gathers) and rendering.py:102 composite (shifted cumprod transmittance and
// the weighted sums). Only depth and color are differentiable outputs.
//
// Per ray it takes the cotangents g_D = d_depth[r], g_C = d_color[r] and the
// forward's sorted distances and depths with each sorted slot's drawn index
// (`order`, written by kernel C), recomputes the forward in the same rounded
// arithmetic, and writes, in drawn order, d_sd, d_dv, d_density and d_rgb:
//   g_w_i   = g_D dv_i + g_C . rgb_i
//   g_a_i   = T_i (g_w_i - S_i),  S_i = sum_{k>i} g_w_k a_k prod_{i<j<k} f_j
//   d_delta = g_a exp(-delta sigma) sigma,  d_sigma = g_a exp(-delta sigma) delta
//   d_sd_i  = d_delta_i - d_delta_{i+1} where sd_i >= 0 (the clamp at 0)
//   d_dv_i  = g_D w_i,  d_rgb_i = g_C w_i
// with f_j = 1 - a_j + 1e-10 and T_i = prod_{j<i} f_j. S is a reverse
// (suffix) scan, S_i = U_{i+1} with U_i = g_w_i a_i + f_i U_{i+1}, so no step
// divides by f_i: JAX differentiates the cumprod by its product structure,
// and f_i is 1e-10 where alpha rounds to 1 in f32 (a saturated sample).
//
// Bound: latency, like kernel C: a ray reads 7 * P + 4 values and writes
// 6 * P, and the scans are chains of dependent shuffles. Design: one warp per
// ray, two samples per lane (positions lane and lane + 32) as in kernel C;
// the suffix scan composes affine maps x -> f x + b with shuffles down each
// 32-lane slot and carries slot 1 into slot 0. Positions past P are padding
// (f = 1, b = 0, no writes). Every drawn index is written exactly once, so
// the outputs need no zeroing.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace scenerf {
namespace {

constexpr int kMaxPts = 64;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * kWarpSize)
sort_composite_bwd_kernel(const float* __restrict__ sd_sorted,
                          const float* __restrict__ dv_sorted,
                          const int* __restrict__ order,
                          const float* __restrict__ density,
                          const float* __restrict__ rgb,
                          const float* __restrict__ d_depth,
                          const float* __restrict__ d_color, int n_rays, int P,
                          float* __restrict__ d_sd, float* __restrict__ d_dv,
                          float* __restrict__ d_density, float* __restrict__ d_rgb) {
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= n_rays) return;
  const int64_t row = r * P;

  // ---- the forward's sorted samples, as kernel C holds them
  bool valid[2];
  int idx[2];
  float key[2], dvs[2], sdc[2], dens[2], col[2][3];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int pos = s * kWarpSize + lane;
    valid[s] = pos < P;
    idx[s] = valid[s] ? order[row + pos] : 0;
    const int64_t src = row + idx[s];
    key[s] = valid[s] ? sd_sorted[row + pos] : 0.f;
    dvs[s] = valid[s] ? dv_sorted[row + pos] : 0.f;
    dens[s] = valid[s] ? density[src] : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) col[s][c] = valid[s] ? rgb[src * 3 + c] : 0.f;
    sdc[s] = valid[s] ? fmaxf(key[s], 0.f) : 0.f;
  }
  const float up0 = __shfl_up_sync(kFullMask, sdc[0], 1);
  const float up1 = __shfl_up_sync(kFullMask, sdc[1], 1);
  const float last0 = __shfl_sync(kFullMask, sdc[0], kWarpSize - 1);
  float delta[2];
  delta[0] = lane == 0 ? sdc[0] : __fsub_rn(sdc[0], up0);
  delta[1] = __fsub_rn(sdc[1], lane == 0 ? last0 : up1);

  float e[2], alpha[2], f[2], incl[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    e[s] = valid[s] ? expf(__fmul_rn(-delta[s], dens[s])) : 1.f;
    alpha[s] = valid[s] ? __fsub_rn(1.f, e[s]) : 0.f;
    f[s] = valid[s] ? __fadd_rn(__fsub_rn(1.f, alpha[s]), 1e-10f) : 1.f;
    incl[s] = f[s];
  }
  // exclusive transmittance T, exactly as kernel C computes it
#pragma unroll
  for (int o = 1; o < kWarpSize; o <<= 1) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float t = __shfl_up_sync(kFullMask, incl[s], o);
      if (lane >= o) incl[s] = __fmul_rn(incl[s], t);
    }
  }
  const float total0 = __shfl_sync(kFullMask, incl[0], kWarpSize - 1);
  incl[1] = __fmul_rn(incl[1], total0);
  float trans[2];
  trans[0] = __shfl_up_sync(kFullMask, incl[0], 1);
  trans[1] = __shfl_up_sync(kFullMask, incl[1], 1);
  if (lane == 0) {
    trans[0] = 1.f;
    trans[1] = total0;
  }
  float w[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) w[s] = valid[s] ? __fmul_rn(alpha[s], trans[s]) : 0.f;

  // ---- cotangent of each weight
  const float gD = d_depth[r];
  const float gC0 = d_color[r * 3 + 0], gC1 = d_color[r * 3 + 1], gC2 = d_color[r * 3 + 2];
  float gw[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float gc = __fadd_rn(__fadd_rn(__fmul_rn(gC0, col[s][0]), __fmul_rn(gC1, col[s][1])),
                               __fmul_rn(gC2, col[s][2]));
    gw[s] = valid[s] ? __fadd_rn(__fmul_rn(gD, dvs[s]), gc) : 0.f;
  }

  // ---- suffix scan U_i = b_i + f_i U_{i+1}, b_i = g_w_i a_i: compose the
  // affine maps (m, b) of positions i.. within each 32-lane slot
  float m[2], b[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    m[s] = f[s];
    b[s] = __fmul_rn(gw[s], alpha[s]);
  }
#pragma unroll
  for (int o = 1; o < kWarpSize; o <<= 1) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float mn = __shfl_down_sync(kFullMask, m[s], o);
      const float bn = __shfl_down_sync(kFullMask, b[s], o);
      if (lane + o < kWarpSize) {
        b[s] = __fadd_rn(b[s], __fmul_rn(m[s], bn));
        m[s] = __fmul_rn(m[s], mn);
      }
    }
  }
  const float u32 = __shfl_sync(kFullMask, b[1], 0);  // U at position 32
  float u[2];
  u[0] = __fadd_rn(b[0], __fmul_rn(m[0], u32));
  u[1] = b[1];
  // S_i = U_{i+1}
  float S[2];
  const float u0n = __shfl_down_sync(kFullMask, u[0], 1);
  const float u1n = __shfl_down_sync(kFullMask, u[1], 1);
  S[0] = lane == kWarpSize - 1 ? u32 : u0n;
  S[1] = lane == kWarpSize - 1 ? 0.f : u1n;

  float d_delta[2], d_sigma[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float ga = valid[s] ? __fmul_rn(trans[s], __fsub_rn(gw[s], S[s])) : 0.f;
    const float gt = __fmul_rn(ga, e[s]);  // cotangent of -delta * sigma, negated
    d_delta[s] = __fmul_rn(gt, dens[s]);
    d_sigma[s] = __fmul_rn(gt, delta[s]);
  }
  // d_sd_i = d_delta_i - d_delta_{i+1}
  const float nx0 = __shfl_down_sync(kFullMask, d_delta[0], 1);
  const float nx1 = __shfl_down_sync(kFullMask, d_delta[1], 1);
  const float first1 = __shfl_sync(kFullMask, d_delta[1], 0);
  float d_sdc[2];
  d_sdc[0] = __fsub_rn(d_delta[0], lane == kWarpSize - 1 ? first1 : nx0);
  d_sdc[1] = __fsub_rn(d_delta[1], lane == kWarpSize - 1 ? 0.f : nx1);

#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (!valid[s]) continue;
    const int64_t o = row + idx[s];
    d_sd[o] = key[s] >= 0.f ? d_sdc[s] : 0.f;
    d_dv[o] = __fmul_rn(gD, w[s]);
    d_density[o] = d_sigma[s];
    d_rgb[o * 3 + 0] = __fmul_rn(gC0, w[s]);
    d_rgb[o * 3 + 1] = __fmul_rn(gC1, w[s]);
    d_rgb[o * 3 + 2] = __fmul_rn(gC2, w[s]);
  }
}

}  // namespace
}  // namespace scenerf

// sd_sorted, dv_sorted: [n_rays, P] f32 and order [n_rays, P] int32 from
// kernel C; density [n_rays, P] and rgb [n_rays, P, 3] f32 in drawn order;
// d_depth [n_rays], d_color [n_rays, 3] f32. Outputs d_sd, d_dv, d_density
// [n_rays, P] and d_rgb [n_rays, P, 3] f32, in drawn order. All contiguous.
SCENERF_API int scenerf_sort_composite_bwd_f32(
    const float* sd_sorted, const float* dv_sorted, const int* order,
    const float* density, const float* rgb, const float* d_depth,
    const float* d_color, int n_rays, int P, float* d_sd, float* d_dv,
    float* d_density, float* d_rgb, void* stream) {
  using namespace scenerf;
  if (P < 1 || P > kMaxPts || n_rays < 0) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return (int)cudaSuccess;
  const int64_t blocks = ((int64_t)n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sort_composite_bwd_kernel<<<(unsigned)blocks, kWarpsPerBlock * kWarpSize, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      sd_sorted, dv_sorted, order, density, rgb, d_depth, d_color, n_rays, P,
      d_sd, d_dv, d_density, d_rgb);
  return (int)cudaGetLastError();
}
