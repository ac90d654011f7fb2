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
// registers. Every payload (sd, dv, density, rgb) is loaded in drawn order at
// the start, so the loads' latency overlaps the sort (rgb as three loads at
// stride 3 that together read the slot's 384 contiguous bytes). The sort is
// a 64-wide bitonic network on one 64-bit key per sample (the distance's
// bits in float order, then the drawn index): the keys are distinct, so the
// result is the stable sort's, and a compare-exchange is one 64-bit compare;
// it runs with each lane holding two neighbouring positions, so 6 of its 21
// stages need no shuffle. Then each sorted slot takes its payload from the
// lane that holds its drawn index (two shuffles and a select), with no load
// after the sort; the exclusive transmittance product is a shuffle scan;
// sums and the argmin are butterfly reductions. Positions past P are padding:
// they sort last (key +inf, index >= P) and are masked explicitly, since a
// sentinel distance alone would give inf * 0 = NaN. Blocks hold
// kWarpsPerBlock rays.
// When the caller needs a gradient it also passes `order`, which receives
// each sorted slot's drawn index, so the backward (composite_bwd.cu) does not
// sort again. The training render's launch also runs RaySOM's EM update
// (som_em.cuh) on the sorted distances and alphas the warp holds: the means
// and stds are loaded before the sort, and no second launch re-reads the
// samples.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "som_em.cuh"

namespace scenerf {
namespace {

constexpr int kMaxPts = 64;

struct CompositeArgs {
  const float* sd;       // [n_rays, P], drawn order
  const float* dv;       // [n_rays, P]
  const float* density;  // [n_rays, P]
  const float* rgb;      // [n_rays, P, 3]
  int n_rays, P;
  float* sd_sorted;      // [n_rays, P]
  float* dv_sorted;      // [n_rays, P]
  float* alphas;         // [n_rays, P]
  float* weights;        // [n_rays, P]
  float* depth;          // [n_rays]
  float* color;          // [n_rays, 3]
  float* weights_at_depth;  // [n_rays]
  float* closest_dist;   // [n_rays]
  int* closest_idx;      // [n_rays]
  int* order;            // [n_rays, P] or null
};

// A sample's sort key: its distance mapped to an unsigned integer of the
// same order (-0 as +0: the two compare equal as floats), then its drawn
// index, which makes every key distinct and the sort stable.
__device__ __forceinline__ uint64_t sort_key(float sd, int drawn) {
  uint32_t b = __float_as_uint(__fadd_rn(sd, 0.f));
  b ^= (b >> 31) ? 0xffffffffu : 0x80000000u;
  return ((uint64_t)b << 32) | (uint32_t)drawn;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// the value of drawn sample i, held by lane i & 31 in slot i >> 5 (padding,
// i >= P, holds the padding value)
__device__ __forceinline__ float from_owner(const float (&v)[2], int i) {
  const float a = __shfl_sync(kFullMask, v[0], i & (kWarpSize - 1));
  const float b = __shfl_sync(kFullMask, v[1], i & (kWarpSize - 1));
  return (i >> 5) == 0 ? a : b;
}

// NC = 0: sort + composite; NC in [1, 8]: and RaySOM's EM with NC prototypes
template <int NC>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarpSize)
sort_composite_kernel(CompositeArgs a, SomArgs som) {
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= a.n_rays) return;
  const int P = a.P;
  const int64_t row = r * P;

  // ---- every payload in drawn order: slot s holds drawn sample s*32+lane
  float sd_d[2], dv_d[2], dens_d[2], rgb_d[3][2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int pos = s * kWarpSize + lane;
    const bool in = pos < P;
    sd_d[s] = in ? __ldg(a.sd + row + pos) : INFINITY;
    dv_d[s] = in ? __ldg(a.dv + row + pos) : 0.f;
    dens_d[s] = in ? __ldg(a.density + row + pos) : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb_d[c][s] = in ? __ldg(a.rgb + (row + pos) * 3 + c) : 0.f;
  }
  // the sort's own layout: lane l holds positions 2l and 2l + 1, so the
  // network's 6 stages at distance 1 compare within a lane
  uint64_t e[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int pos = 2 * lane + s;
    e[s] = sort_key(pos < P ? __ldg(a.sd + row + pos) : INFINITY, pos);
  }
  constexpr int kProtos = NC > 0 ? NC : 1;
  float m[kProtos], sdev[kProtos];
  if constexpr (NC > 0) som_load_protos<NC>(som, r, m, sdev);

  // ---- bitonic sort of the 64 distinct keys (distance, drawn index)
#pragma unroll
  for (int k = 2; k <= kMaxPts; k <<= 1) {
    const bool ascending = (lane & (k >> 1)) == 0;  // (position & k) == 0
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 1) {  // within the lane: slot 0 is the lower position
        if ((e[1] < e[0]) == ascending) {
          const uint64_t t = e[0]; e[0] = e[1]; e[1] = t;
        }
      } else {
        const bool keep_min = ((lane & (j >> 1)) == 0) == ascending;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const uint64_t pk = __shfl_xor_sync(kFullMask, e[s], j >> 1);
          if ((pk < e[s]) == keep_min) e[s] = pk;  // keys are distinct
        }
      }
    }
  }

  // ---- back to slot-major (sorted position s*32+lane), then each sorted
  // slot's payloads from the lanes that hold them; alpha and the
  // transmittance factor
  int idx[2];
  float key[2];
  bool valid[2];
  float dvs[2], sdc[2], dens[2], col[2][3];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int src = (s * kWarpSize + lane) >> 1;
    const uint64_t e0 = __shfl_sync(kFullMask, e[0], src);
    const uint64_t e1 = __shfl_sync(kFullMask, e[1], src);
    idx[s] = (int)(uint32_t)((lane & 1) ? e1 : e0);
    valid[s] = s * kWarpSize + lane < P;
    key[s] = from_owner(sd_d, idx[s]);
    dvs[s] = from_owner(dv_d, idx[s]);
    dens[s] = from_owner(dens_d, idx[s]);
#pragma unroll
    for (int c = 0; c < 3; ++c) col[s][c] = from_owner(rgb_d[c], idx[s]);
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
    a.sd_sorted[o] = key[s];
    a.dv_sorted[o] = dvs[s];
    a.alphas[o] = alpha[s];
    a.weights[o] = w[s];
    if (a.order != nullptr) a.order[o] = idx[s];
  }
  if (lane == 0) {
    a.depth[r] = d;
    a.color[r * 3 + 0] = rgb_sum[0];
    a.color[r * 3 + 1] = rgb_sum[1];
    a.color[r * 3 + 2] = rgb_sum[2];
    a.weights_at_depth[r] = w_best;
    a.closest_dist[r] = best;
    a.closest_idx[r] = best_pos;
  }
  if constexpr (NC > 0) som_em_warp<NC>(som, r, lane, P, m, sdev, key, alpha);
}

__global__ void empty_kernel() {}

}  // namespace
}  // namespace scenerf

// sd, dv, density: [n_rays, P] f32; rgb: [n_rays, P, 3] f32, all contiguous.
// Outputs: sd_sorted, dv_sorted, alphas, weights [n_rays, P]; depth,
// weights_at_depth, closest_dist [n_rays]; color [n_rays, 3];
// closest_idx [n_rays] int32 (position in the sorted order); order
// [n_rays, P] int32 (drawn index of each sorted slot), or null.
// C = 0: no RaySOM. C in [1, 8]: also RaySOM's EM on the sorted samples, with
// means, stds [n_rays, C] and the outputs new_means, new_vars, mask
// [n_rays, C], and two_sigma2, c_floor, threshold as for scenerf_ray_som_f32.
SCENERF_API int scenerf_sort_composite_f32(
    const float* sd, const float* dv, const float* density, const float* rgb,
    int n_rays, int P, float* sd_sorted, float* dv_sorted, float* alphas,
    float* weights, float* depth, float* color, float* weights_at_depth,
    float* closest_dist, int* closest_idx, int* order, const float* means,
    const float* stds, int C, float two_sigma2, float c_floor, float threshold,
    float* new_means, float* new_vars, float* mask, void* stream) {
  using namespace scenerf;
  if (P < 1 || P > kMaxPts || n_rays < 0 || C < 0 || C > kMaxProtos) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rays == 0) return (int)cudaSuccess;
  const CompositeArgs a{sd, dv, density, rgb, n_rays, P, sd_sorted, dv_sorted, alphas,
                        weights, depth, color, weights_at_depth, closest_dist, closest_idx,
                        order};
  const SomArgs som{means, stds, two_sigma2, c_floor, threshold, new_means, new_vars, mask};
  const unsigned blocks = (unsigned)(((int64_t)n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const unsigned threads = kWarpsPerBlock * kWarpSize;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
#define SCENERF_COMPOSITE_CASE(N) \
  case N: sort_composite_kernel<N><<<blocks, threads, 0, st>>>(a, som); break;
    SCENERF_COMPOSITE_CASE(0) SCENERF_COMPOSITE_CASE(1) SCENERF_COMPOSITE_CASE(2)
    SCENERF_COMPOSITE_CASE(3) SCENERF_COMPOSITE_CASE(4) SCENERF_COMPOSITE_CASE(5)
    SCENERF_COMPOSITE_CASE(6) SCENERF_COMPOSITE_CASE(7) SCENERF_COMPOSITE_CASE(8)
#undef SCENERF_COMPOSITE_CASE
  }
  return (int)cudaGetLastError();
}

// An empty kernel on the grid kernels C and S take for n_rays rays: the floor
// of one launch's device time, which a single-wave kernel cannot beat.
SCENERF_API int scenerf_empty_launch(int n_rays, void* stream) {
  using namespace scenerf;
  if (n_rays < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(((int64_t)n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock);
  empty_kernel<<<blocks, kWarpsPerBlock * kWarpSize, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
