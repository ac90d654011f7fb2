// The RaySOM EM update of one ray by one warp, shared by kernel S (som.cu,
// the standalone launch) and kernel C's training launch (composite.cu), which
// runs it on the sorted samples and alphas it already holds in registers.
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
// with the 1e-5 / 1e-8 / C * 1e-8 floors in the JAX package's order, every
// division an IEEE one and the sums over prototypes left to right, as
// scenerf_tpu_torch/som.py som_em_plain computes them.
//
// Design: the prototype count NC is a template parameter, so C = 4 computes
// 4 likelihoods per sample. The C x C tables live in registers, entry
// e = k * NC + c on lane e & 31, slot e >> 5; a lane reads an entry from its
// owner with a shuffle (the best prototype's row varies by sample). The 2 C
// sums of weights and weighted distances run as interleaved butterflies, then
// the C variance sums: two rounds of 5 shuffle steps. A division whose
// dividend is zero or subnormal takes the IEEE division's slow path, and
// far samples and far prototypes give such dividends (an exp that
// underflows) in some lane of most warps; where the quotient then only
// enters a sum that rounds it away (g + 1e-5, w + 1e-5, a product beside
// the diagonal term in p2), `quotient_or_zero` skips it, so every result
// stays the one of the IEEE division.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace scenerf {

constexpr int kMaxProtos = 8;
constexpr float kSqrt2Pi = 2.5066282746310002f;
// block size of kernels C and S (one warp per ray): one warp per SM
// sub-partition; 1, 2 and 8 were no faster at any KITTI launch size
// (scripts/composite_compare_torch.py builds them with -D to compare)
#ifndef SCENERF_WARPS_PER_BLOCK
#define SCENERF_WARPS_PER_BLOCK 4
#endif
constexpr int kWarpsPerBlock = SCENERF_WARPS_PER_BLOCK;

struct SomArgs {
  const float* means;  // [n_rays, C]
  const float* stds;   // [n_rays, C]
  float two_sigma2;    // 2 som_sigma^2, rounded to f32
  float c_floor;       // C * 1e-8, rounded to f32
  float threshold;     // the mask's movement threshold
  float* new_means;    // [n_rays, C]
  float* new_vars;     // [n_rays, C]
  float* mask;         // [n_rays, C]
};

// a / b (IEEE, b > 0), or 0 where a < 1e-30: the caller adds the quotient to a
// term that it cannot change (below 2^-25 of it). The dividend of the
// division is then 1, so no lane takes the slow path.
__device__ __forceinline__ float quotient_or_zero(float a, float b) {
  const bool tiny = a < 1e-30f;
  const float q = __fdiv_rn(tiny ? 1.f : a, b);
  return tiny ? 0.f : q;
}

template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int i) {
  float x = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) x = i == j ? v[j] : x;
  return x;
}

// entry e of a register table: lane e & 31, slot e >> 5 (all lanes call it)
template <int NE>
__device__ __forceinline__ float table_at(const float (&t)[NE], int e) {
  float v = __shfl_sync(kFullMask, t[0], e & (kWarpSize - 1));
#pragma unroll
  for (int i = 1; i < NE; ++i) {
    const float u = __shfl_sync(kFullMask, t[i], e & (kWarpSize - 1));
    v = (e >> 5) == i ? u : v;
  }
  return v;
}

template <int NC>
__device__ __forceinline__ void som_load_protos(const SomArgs& a, int64_t r, float (&m)[NC],
                                                float (&s)[NC]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    m[c] = __ldg(a.means + r * NC + c);
    s[c] = __ldg(a.stds + r * NC + c);
  }
}

// One ray's EM step. Slot h of this lane holds sorted sample h * 32 + lane
// (distance d[h], alpha[h]); samples at positions >= P are padding.
template <int NC>
__device__ __forceinline__ void som_em_warp(const SomArgs& a, int64_t r, int lane, int P,
                                            const float (&m)[NC], const float (&s)[NC],
                                            const float (&d_in)[2], const float (&alpha)[2]) {
  constexpr int NE = (NC * NC + kWarpSize - 1) / kWarpSize;

  // ---- neighbourhood tables rel and q = rel / row sum, entry e = k * NC + c
  float rel[NE], q[NE];
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    const int e = i * kWarpSize + lane;
    const int k = min(e / NC, NC - 1), c = e % NC;
    const float dm = __fsub_rn(pick(m, k), pick(m, c));
    const float x = -__fmul_rn(dm, dm);  // 0 on the diagonal: exp(+-0) = 1
    rel[i] = expf(x == 0.f ? 0.f : __fdiv_rn(x == 0.f ? -1.f : x, a.two_sigma2));
  }
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    const int k = min((i * kWarpSize + lane) / NC, NC - 1);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) sum = __fadd_rn(sum, table_at(rel, k * NC + c));
    // an off-diagonal q < 1e-30 adds p1 q < 1e-30 to a p2 that holds
    // p1[k] q[k][k] >= 1e-8 / C
    q[i] = quotient_or_zero(rel[i], sum);
  }
  float qa[NC][NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
#pragma unroll
    for (int c = 0; c < NC; ++c) qa[k][c] = table_at(q, k * NC + c);
  }
  float two_var[NC], norm[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    two_var[c] = __fmul_rn(2.f, __fmul_rn(s[c], s[c]));
    norm[c] = __fmul_rn(kSqrt2Pi, s[c]);
  }

  // ---- per sample: likelihoods, best prototype, EM weights
  float d[2], w[2][NC];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool valid = h * kWarpSize + lane < P;
    d[h] = valid ? d_in[h] : 0.f;
    const float dens = __fadd_rn(valid ? alpha[h] : 0.f, 1e-8f);
    float p1[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float dist = fabsf(__fsub_rn(m[c], d[h]));
      const float g =
          quotient_or_zero(expf(__fdiv_rn(-__fmul_rn(dist, dist), two_var[c])), norm[c]);
      p1[c] = __fadd_rn(__fmul_rn(__fadd_rn(g, 1e-5f), dens), 1e-8f);
    }
    float best_p = -INFINITY;
    int best = 0;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc = __fadd_rn(acc, __fmul_rn(p1[c], qa[k][c]));
      acc = __fadd_rn(acc, a.c_floor);
      if (acc > best_p) {  // strictly greater: ties keep the first index
        best_p = acc;
        best = k;
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float wr = table_at(rel, c * NC + best);
      // best_p >= C * 1e-8: a quotient skipped is < 2.5e-23, rounded away by + 1e-5
      w[h][c] = valid ? __fadd_rn(quotient_or_zero(__fmul_rn(wr, p1[c]), best_p), 1e-5f) : 0.f;
    }
  }

  // ---- weight and weighted-distance sums, interleaved; then the variances
  float ws[NC], wd[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    ws[c] = __fadd_rn(w[0][c], w[1][c]);
    wd[c] = __fadd_rn(__fmul_rn(w[0][c], d[0]), __fmul_rn(w[1][c], d[1]));
  }
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      ws[c] = __fadd_rn(ws[c], __shfl_xor_sync(kFullMask, ws[c], o));
      wd[c] = __fadd_rn(wd[c], __shfl_xor_sync(kFullMask, wd[c], o));
    }
  }
  float nm[NC], wv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    nm[c] = __fdiv_rn(wd[c], ws[c]);
    const float e0 = __fsub_rn(d[0], nm[c]), e1 = __fsub_rn(d[1], nm[c]);
    wv[c] = __fadd_rn(__fmul_rn(w[0][c], __fmul_rn(e0, e0)), __fmul_rn(w[1][c], __fmul_rn(e1, e1)));
  }
#pragma unroll
  for (int o = kWarpSize / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < NC; ++c) wv[c] = __fadd_rn(wv[c], __shfl_xor_sync(kFullMask, wv[c], o));
  }
  if (lane < NC) {  // lane c writes prototype c
    const int c = lane;
    const float nmc = pick(nm, c), mc = pick(m, c), sc = pick(s, c);
    const float nv = __fdiv_rn(pick(wv, c), pick(ws, c));
    const bool moved = fabsf(__fsub_rn(mc, nmc)) > a.threshold;
    const bool widened = fabsf(__fsub_rn(sqrtf(__fmul_rn(sc, sc)), sqrtf(nv))) > a.threshold;
    a.new_means[r * NC + c] = nmc;
    a.new_vars[r * NC + c] = nv;
    a.mask[r * NC + c] = moved && widened && nv > 0.f ? 1.f : 0.f;
  }
}

}  // namespace scenerf
