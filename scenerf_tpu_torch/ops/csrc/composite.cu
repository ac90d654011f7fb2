// Kernel C: per-ray sort + alpha composite (forward).
//
// Replaces the TPU-shaped per-ray sort and composite of the JAX package:
// scenerf_tpu/sampling.py:198 sort_samples_by_distance (one argsort plus
// take_along_axis gathers that XLA fuses into a single TPU sort) followed by
// rendering.py:102 composite (shifted cumprod transmittance, weighted sums,
// argmin of the closest sample).
//
// Per ray it takes the P <= 64 samples in the order they were drawn
// (unsorted sensor distance sd, source-frame depth dv, density, rgb), sorts
// them by sd (stable: ties keep their drawn order), and computes
//   delta_i = max(sd_i, 0) - max(sd_{i-1}, 0), delta_0 = max(sd_0, 0)
//   alpha_i = 1 - exp(-delta_i * density_i)
//   T_i     = prod_{j < i} (1 - alpha_j + 1e-10)
//   w_i     = alpha_i * T_i,  depth = sum w_i dv_i,  color = sum w_i rgb_i
// and the first index of min |depth - dv_i| with its distance and weight.
//
// Bound: latency, not bandwidth: a ray reads 6 * P floats and writes
// 4 * P + 7, and the sort is a chain of dependent steps. Design: one warp
// per ray, two samples per lane (position lane and lane + 32) held in
// registers; a 64-wide bitonic network on (sd, drawn index) pairs, whose
// strict total order makes the result equal to a stable sort; the payloads
// are then fetched once by drawn index; the exclusive transmittance product
// is a shuffle scan; sums and the argmin are butterfly reductions. Positions
// past P are padding: they sort last (key +inf, index >= P) and are masked
// explicitly, since a sentinel distance alone would give inf * 0 = NaN.
// When the caller needs a gradient it also passes `order`, which receives
// each sorted slot's drawn index, so the backward (composite_bwd.cu) does not
// sort again.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace scenerf {
namespace {

constexpr int kMaxPts = 64;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ bool key_less(float ka, int ia, float kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * kWarpSize)
sort_composite_kernel(const float* __restrict__ sd, const float* __restrict__ dv,
                      const float* __restrict__ density,
                      const float* __restrict__ rgb, int n_rays, int P,
                      float* __restrict__ sd_sorted, float* __restrict__ dv_sorted,
                      float* __restrict__ alphas, float* __restrict__ weights,
                      float* __restrict__ depth, float* __restrict__ color,
                      float* __restrict__ weights_at_depth,
                      float* __restrict__ closest_dist,
                      int* __restrict__ closest_idx, int* __restrict__ order) {
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int64_t r = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= n_rays) return;
  const int64_t row = r * P;

  // ---- stable sort of (sd, drawn index), slot s holds position s*32+lane
  float key[2];
  int idx[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int pos = s * kWarpSize + lane;
    idx[s] = pos;
    key[s] = pos < P ? sd[row + pos] : INFINITY;
  }
#pragma unroll
  for (int k = 2; k <= kMaxPts; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == kWarpSize) {
        // only at k == 64: ascending, slot 0 keeps the smaller element
        if (key_less(key[1], idx[1], key[0], idx[0])) {
          const float tk = key[0]; key[0] = key[1]; key[1] = tk;
          const int ti = idx[0]; idx[0] = idx[1]; idx[1] = ti;
        }
      } else {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int pos = s * kWarpSize + lane;
          const float pk = __shfl_xor_sync(kFullMask, key[s], j);
          const int pi = __shfl_xor_sync(kFullMask, idx[s], j);
          const bool lower = (pos & j) == 0;
          const bool ascending = (pos & k) == 0;
          const bool take = (lower == ascending) ? key_less(pk, pi, key[s], idx[s])
                                                 : key_less(key[s], idx[s], pk, pi);
          if (take) {
            key[s] = pk;
            idx[s] = pi;
          }
        }
      }
    }
  }

  // ---- payloads by drawn index; alpha and the transmittance factor
  bool valid[2];
  float dvs[2], sdc[2], dens[2], col[2][3];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int pos = s * kWarpSize + lane;
    valid[s] = pos < P;
    const int64_t src = row + (valid[s] ? idx[s] : 0);
    dvs[s] = valid[s] ? dv[src] : 0.f;
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

  float alpha[2], incl[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    alpha[s] = valid[s] ? __fsub_rn(1.f, expf(__fmul_rn(-delta[s], dens[s]))) : 0.f;
    incl[s] = valid[s] ? __fadd_rn(__fsub_rn(1.f, alpha[s]), 1e-10f) : 1.f;
  }
  // inclusive product scan within each slot, then carry slot 0 into slot 1
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

  const float d = warp_sum(__fadd_rn(__fmul_rn(w[0], dvs[0]), __fmul_rn(w[1], dvs[1])));
  float rgb_sum[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rgb_sum[c] = warp_sum(__fadd_rn(__fmul_rn(w[0], col[0][c]), __fmul_rn(w[1], col[1][c])));
  }

  // ---- argmin |depth - dv|, first index on ties
  const float a0 = valid[0] ? fabsf(__fsub_rn(d, dvs[0])) : INFINITY;
  const float a1 = valid[1] ? fabsf(__fsub_rn(d, dvs[1])) : INFINITY;
  float best = a0;
  int best_pos = lane;
  if (a1 < a0) {
    best = a1;
    best_pos = lane + kWarpSize;
  }
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(kFullMask, best, o);
    const int op = __shfl_xor_sync(kFullMask, best_pos, o);
    if (ob < best || (ob == best && op < best_pos)) {
      best = ob;
      best_pos = op;
    }
  }
  const float w_sel = (best_pos >> 5) == 0 ? w[0] : w[1];
  const float w_best = __shfl_sync(kFullMask, w_sel, best_pos & (kWarpSize - 1));

#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (!valid[s]) continue;
    const int64_t o = row + s * kWarpSize + lane;
    sd_sorted[o] = key[s];
    dv_sorted[o] = dvs[s];
    alphas[o] = alpha[s];
    weights[o] = w[s];
    if (order != nullptr) order[o] = idx[s];
  }
  if (lane == 0) {
    depth[r] = d;
    color[r * 3 + 0] = rgb_sum[0];
    color[r * 3 + 1] = rgb_sum[1];
    color[r * 3 + 2] = rgb_sum[2];
    weights_at_depth[r] = w_best;
    closest_dist[r] = best;
    closest_idx[r] = best_pos;
  }
}

}  // namespace
}  // namespace scenerf

// sd, dv, density: [n_rays, P] f32; rgb: [n_rays, P, 3] f32, all contiguous.
// Outputs: sd_sorted, dv_sorted, alphas, weights [n_rays, P]; depth,
// weights_at_depth, closest_dist [n_rays]; color [n_rays, 3];
// closest_idx [n_rays] int32 (position in the sorted order); order
// [n_rays, P] int32 (drawn index of each sorted slot), or null.
SCENERF_API int scenerf_sort_composite_f32(
    const float* sd, const float* dv, const float* density, const float* rgb,
    int n_rays, int P, float* sd_sorted, float* dv_sorted, float* alphas,
    float* weights, float* depth, float* color, float* weights_at_depth,
    float* closest_dist, int* closest_idx, int* order, void* stream) {
  using namespace scenerf;
  if (P < 1 || P > kMaxPts || n_rays < 0) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return (int)cudaSuccess;
  const int64_t blocks = ((int64_t)n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sort_composite_kernel<<<(unsigned)blocks, kWarpsPerBlock * kWarpSize, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      sd, dv, density, rgb, n_rays, P, sd_sorted, dv_sorted, alphas, weights,
      depth, color, weights_at_depth, closest_dist, closest_idx, order);
  return (int)cudaGetLastError();
}
