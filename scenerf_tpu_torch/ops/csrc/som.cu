// Kernel S: the RaySOM EM update (no gradient).
//
// Replaces the TPU-shaped EM half of scenerf_tpu/som.py:37 ray_som (one
// batched einsum + a one-hot contraction that stands in for a gather, which
// XLA lowered badly on the TPU). The KL toward the re-estimated Gaussians,
// the only part with a gradient, stays plain PyTorch on [R, C].
//
// Per ray, from the predicted mixture means m and stds s [C] and the sorted
// sample distances d and alphas [P] (all detached), it computes
//   rel[k][c]   = exp(-(m_k - m_c)^2 / (2 sigma^2)),  q[k][c] = rel[k][c] / sum_c rel[k][c]
//   p1[p][c]    = (exp(-|m_c - d_p|^2 / (2 s_c^2)) / (sqrt(2 pi) s_c) + 1e-5)
//                 * (alpha_p + 1e-8) + 1e-8
//   p2[p][k]    = sum_c p1[p][c] q[k][c] + C * 1e-8;  best_p = first argmax_k
//   w[c][p]     = rel[c][best_p] p1[p][c] / max_k p2[p][k] + 1e-5
//   new_mean_c  = sum_p w d / sum_p w,  new_var_c = sum_p w (d - new_mean_c)^2 / sum_p w
//   mask_c      = (|m_c - new_mean_c| > thr) & (|sqrt(s_c^2) - sqrt(new_var_c)| > thr)
//                 & (new_var_c > 0)
// with the 1e-5 / 1e-8 / C * 1e-8 floors in the JAX package's order.
//
// Bound: latency: a ray reads 2 C + 2 P floats and writes 3 C, and its work
// (C^2 + about 10 C operations per sample) is small. Design: one warp per
// ray, two samples per lane as in kernel C; the C x C neighbourhood tables
// live in the warp's slice of shared memory (the best prototype indexes them
// per sample), the sums over samples are butterfly reductions, and the
// weights stay in registers between the mean and the variance pass.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace scenerf {
namespace {

constexpr int kMaxPts = 64;
constexpr int kMaxProtos = 8;
constexpr int kWarpsPerBlock = 8;
constexpr float kSqrt2Pi = 2.5066282746310002f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * kWarpSize)
ray_som_kernel(const float* __restrict__ means, const float* __restrict__ stds,
               const float* __restrict__ sd, const float* __restrict__ alphas,
               int n_rays, int C, int P, float two_sigma2, float c_floor,
               float threshold, float* __restrict__ new_means,
               float* __restrict__ new_vars, float* __restrict__ mask) {
  __shared__ float s_rel[kWarpsPerBlock][kMaxProtos * kMaxProtos];
  __shared__ float s_q[kWarpsPerBlock][kMaxProtos * kMaxProtos];
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int warp = threadIdx.x >> 5;
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (r >= n_rays) return;  // whole warps only: no block-wide barrier below

  float m[kMaxProtos], s[kMaxProtos], two_var[kMaxProtos], norm[kMaxProtos];
#pragma unroll
  for (int c = 0; c < kMaxProtos; ++c) {
    m[c] = c < C ? means[r * C + c] : 0.f;
    s[c] = c < C ? stds[r * C + c] : 1.f;
    two_var[c] = __fmul_rn(2.f, __fmul_rn(s[c], s[c]));
    norm[c] = __fmul_rn(kSqrt2Pi, s[c]);
  }
  float* rel = s_rel[warp];
  float* q = s_q[warp];
  for (int e = lane; e < C * C; e += kWarpSize) {
    const int k = e / C, c = e % C;
    const float dm = __fsub_rn(means[r * C + k], means[r * C + c]);
    rel[e] = expf(__fdiv_rn(-__fmul_rn(dm, dm), two_sigma2));
  }
  __syncwarp();
  if (lane < C) {
    float sum = 0.f;
    for (int c = 0; c < C; ++c) sum = __fadd_rn(sum, rel[lane * C + c]);
    for (int c = 0; c < C; ++c) q[lane * C + c] = __fdiv_rn(rel[lane * C + c], sum);
  }
  __syncwarp();

  // ---- per sample: likelihoods, best prototype, EM weights
  const int64_t row = r * P;
  float d[2], w[2][kMaxProtos];
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pos = h * kWarpSize + lane;
    valid[h] = pos < P;
    d[h] = valid[h] ? sd[row + pos] : 0.f;
    const float dens = __fadd_rn(valid[h] ? alphas[row + pos] : 0.f, 1e-8f);
    float p1[kMaxProtos];
#pragma unroll
    for (int c = 0; c < kMaxProtos; ++c) {
      const float dist = fabsf(__fsub_rn(m[c], d[h]));
      const float g = __fdiv_rn(expf(__fdiv_rn(-__fmul_rn(dist, dist), two_var[c])), norm[c]);
      p1[c] = __fadd_rn(__fmul_rn(__fadd_rn(g, 1e-5f), dens), 1e-8f);
    }
    float best_p = -INFINITY;
    int best = 0;
    for (int k = 0; k < C; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxProtos; ++c) {
        if (c < C) acc = __fadd_rn(acc, __fmul_rn(p1[c], q[k * C + c]));
      }
      acc = __fadd_rn(acc, c_floor);
      if (acc > best_p) {  // strictly greater: ties keep the first index
        best_p = acc;
        best = k;
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxProtos; ++c) {
      const float wr = c < C ? rel[c * C + best] : 0.f;
      w[h][c] = valid[h] && c < C
                    ? __fadd_rn(__fdiv_rn(__fmul_rn(wr, p1[c]), best_p), 1e-5f)
                    : 0.f;
    }
  }

  // ---- weighted mean, then weighted variance, per prototype
#pragma unroll
  for (int c = 0; c < kMaxProtos; ++c) {
    if (c >= C) break;
    const float wsum = warp_sum(__fadd_rn(w[0][c], w[1][c]));
    const float wd = warp_sum(__fadd_rn(__fmul_rn(w[0][c], d[0]), __fmul_rn(w[1][c], d[1])));
    const float nm = __fdiv_rn(wd, wsum);
    const float e0 = __fsub_rn(d[0], nm), e1 = __fsub_rn(d[1], nm);
    const float wv = warp_sum(__fadd_rn(__fmul_rn(w[0][c], __fmul_rn(e0, e0)),
                                        __fmul_rn(w[1][c], __fmul_rn(e1, e1))));
    const float nv = __fdiv_rn(wv, wsum);
    if (lane == c) {
      const bool moved = fabsf(__fsub_rn(m[c], nm)) > threshold;
      const bool widened =
          fabsf(__fsub_rn(sqrtf(__fmul_rn(s[c], s[c])), sqrtf(nv))) > threshold;
      new_means[r * C + c] = nm;
      new_vars[r * C + c] = nv;
      mask[r * C + c] = moved && widened && nv > 0.f ? 1.f : 0.f;
    }
  }
}

}  // namespace
}  // namespace scenerf

// means, stds: [n_rays, C] f32; sd, alphas: [n_rays, P] f32 (sorted samples);
// outputs new_means, new_vars, mask: [n_rays, C] f32; all contiguous.
// two_sigma2 = 2 som_sigma^2, c_floor = C * 1e-8, threshold: the mask's
// movement threshold, each rounded to f32 by the caller.
SCENERF_API int scenerf_ray_som_f32(const float* means, const float* stds,
                                    const float* sd, const float* alphas,
                                    int n_rays, int C, int P, float two_sigma2,
                                    float c_floor, float threshold,
                                    float* new_means, float* new_vars,
                                    float* mask, void* stream) {
  using namespace scenerf;
  if (C < 1 || C > kMaxProtos || P < 1 || P > kMaxPts || n_rays < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rays == 0) return (int)cudaSuccess;
  const int64_t blocks = ((int64_t)n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock;
  ray_som_kernel<<<(unsigned)blocks, kWarpsPerBlock * kWarpSize, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      means, stds, sd, alphas, n_rays, C, P, two_sigma2, c_floor, threshold,
      new_means, new_vars, mask);
  return (int)cudaGetLastError();
}
