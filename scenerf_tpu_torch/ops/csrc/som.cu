// Kernel S: the RaySOM EM update (no gradient), standalone.
//
// Replaces the TPU-shaped EM half of scenerf_tpu/som.py:37 ray_som (one
// batched einsum + a one-hot contraction that stands in for a gather, which
// XLA lowered badly on the TPU). The KL toward the re-estimated Gaussians,
// the only part with a gradient, stays plain PyTorch on [R, C]. The EM itself
// is `som_em_warp` (som_em.cuh), which the training render runs inside kernel
// C's launch; this entry serves callers that hold sorted samples but ran no
// composite.
//
// Bound: latency: a ray reads 2 C + 2 P floats and writes 3 C, and its work
// (C^2 + about 10 C operations per sample) is small. Design: one warp per
// ray, two samples per lane as in kernel C, kWarpsPerBlock rays a block.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "som_em.cuh"

namespace scenerf {
namespace {

constexpr int kMaxPts = 64;

template <int NC>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarpSize)
ray_som_kernel(SomArgs a, const float* __restrict__ sd, const float* __restrict__ alphas,
               int n_rays, int P) {
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= n_rays) return;  // whole warps only: no block-wide barrier below
  float m[NC], s[NC];
  som_load_protos<NC>(a, r, m, s);
  const int64_t row = r * P;
  float d[2], alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pos = h * kWarpSize + lane;
    d[h] = pos < P ? __ldg(sd + row + pos) : 0.f;
    alpha[h] = pos < P ? __ldg(alphas + row + pos) : 0.f;
  }
  som_em_warp<NC>(a, r, lane, P, m, s, d, alpha);
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
  const SomArgs a{means, stds, two_sigma2, c_floor, threshold, new_means, new_vars, mask};
  const unsigned blocks = (unsigned)(((int64_t)n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const unsigned threads = kWarpsPerBlock * kWarpSize;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
#define SCENERF_SOM_CASE(N) \
  case N: ray_som_kernel<N><<<blocks, threads, 0, st>>>(a, sd, alphas, n_rays, P); break;
    SCENERF_SOM_CASE(1) SCENERF_SOM_CASE(2) SCENERF_SOM_CASE(3) SCENERF_SOM_CASE(4)
    SCENERF_SOM_CASE(5) SCENERF_SOM_CASE(6) SCENERF_SOM_CASE(7) SCENERF_SOM_CASE(8)
#undef SCENERF_SOM_CASE
  }
  return (int)cudaGetLastError();
}
