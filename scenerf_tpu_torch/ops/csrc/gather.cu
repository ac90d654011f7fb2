// Kernel G: multi-level bilinear gather (forward).
//
// Replaces the TPU-shaped row-gather bilinear sampling of the JAX package:
// scenerf_tpu/geometry.py:106 bilinear_sample, reached from
// rendering.py:64 featurize_points (five pyramid levels, the [N, 2480] field
// latent) and encoder/sphere_decoder.py:69 sphere_scatter_gather (one level,
// the encoder taps resampled onto the sphere grid).
//
// For every point p and level l it samples the channel-last map
// [H_l, W_l, C_l] at the continuous pixel coords (ix[l, p], iy[l, p]) with
// zero padding outside the map (torch grid_sample, padding "zeros",
// align_corners=False, coords already unnormalized by the caller), and writes
// the C_l values straight into columns [col_l, col_l + C_l) of out[p], so the
// per-level pieces and their concatenation never exist in device memory.
//
// Bound: device-memory bytes. Per point it reads four corner rows of every
// level and writes one output row (2480 floats at the KITTI widths); there is
// no reuse to exploit beyond what L2 gives neighbouring points. Design: one
// warp per point, lanes across channels, 16-byte loads and stores where the
// level's channel count, column offset and row stride allow it (all KITTI
// levels), a scalar lane loop otherwise (the `tiny` preset's 2..32-channel
// levels, the 3-channel image tap). The interpolation uses explicitly
// rounded multiplies and adds, in the same order as the plain PyTorch
// version, so the two agree bit for bit.
#include <stdint.h>

#include "common.cuh"

namespace scenerf {
namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  const float* ptr[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
  int C[kMaxLevels];
  int col[kMaxLevels];
  int vec[kMaxLevels];  // 1 where float4 loads/stores are 16-byte aligned
  int n;
};

__device__ __forceinline__ float lerp2(float a, float b, float wa, float wb) {
  // a * wa + b * wb without contraction into an fma
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

__global__ void __launch_bounds__(kWarpsPerBlock * kWarpSize)
gather_levels_kernel(Levels lv, const float* __restrict__ ix,
                     const float* __restrict__ iy, int n_points,
                     float* __restrict__ out, int out_cols) {
  const int lane = threadIdx.x & (kWarpSize - 1);
  const int64_t p = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= n_points) return;
  float* orow = out + p * (int64_t)out_cols;

  for (int l = 0; l < lv.n; ++l) {
    const int H = lv.H[l], W = lv.W[l], C = lv.C[l];
    const float x = ix[(int64_t)l * n_points + p];
    const float y = iy[(int64_t)l * n_points + p];
    const float x0 = floorf(x), y0 = floorf(y);
    const float wx = __fsub_rn(x, x0), wy = __fsub_rn(y, y0);
    const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
    // bounds on the float corners: a huge or NaN coordinate is never cast
    const bool x0in = x0 >= 0.0f && x0 < (float)W;
    const bool x1in = x0 >= -1.0f && x0 < (float)(W - 1);
    const bool y0in = y0 >= 0.0f && y0 < (float)H;
    const bool y1in = y0 >= -1.0f && y0 < (float)(H - 1);
    const int64_t xi = x0in || x1in ? (int64_t)x0 : 0;
    const int64_t yi = y0in || y1in ? (int64_t)y0 : 0;
    const float* base = lv.ptr[l];
    const float* r00 = x0in && y0in ? base + (yi * W + xi) * C : nullptr;
    const float* r10 = x1in && y0in ? base + (yi * W + xi + 1) * C : nullptr;
    const float* r01 = x0in && y1in ? base + ((yi + 1) * W + xi) * C : nullptr;
    const float* r11 = x1in && y1in ? base + ((yi + 1) * W + xi + 1) * C : nullptr;
    float* o = orow + lv.col[l];

    if (lv.vec[l]) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c = lane * 4; c < C; c += kWarpSize * 4) {
        const float4 v00 = r00 ? *reinterpret_cast<const float4*>(r00 + c) : zero;
        const float4 v10 = r10 ? *reinterpret_cast<const float4*>(r10 + c) : zero;
        const float4 v01 = r01 ? *reinterpret_cast<const float4*>(r01 + c) : zero;
        const float4 v11 = r11 ? *reinterpret_cast<const float4*>(r11 + c) : zero;
        float4 r;
        r.x = lerp2(lerp2(v00.x, v10.x, ux, wx), lerp2(v01.x, v11.x, ux, wx), uy, wy);
        r.y = lerp2(lerp2(v00.y, v10.y, ux, wx), lerp2(v01.y, v11.y, ux, wx), uy, wy);
        r.z = lerp2(lerp2(v00.z, v10.z, ux, wx), lerp2(v01.z, v11.z, ux, wx), uy, wy);
        r.w = lerp2(lerp2(v00.w, v10.w, ux, wx), lerp2(v01.w, v11.w, ux, wx), uy, wy);
        *reinterpret_cast<float4*>(o + c) = r;
      }
    } else {
      for (int c = lane; c < C; c += kWarpSize) {
        const float v00 = r00 ? r00[c] : 0.f;
        const float v10 = r10 ? r10[c] : 0.f;
        const float v01 = r01 ? r01[c] : 0.f;
        const float v11 = r11 ? r11[c] : 0.f;
        o[c] = lerp2(lerp2(v00, v10, ux, wx), lerp2(v01, v11, ux, wx), uy, wy);
      }
    }
  }
}

}  // namespace
}  // namespace scenerf

// level_ptrs[l]: device pointer of the contiguous [H, W, C] f32 map l;
// hwcc[4 * l ...]: H, W, C and the output column offset of level l.
// ix, iy: [n_levels, n_points] f32; out: [n_points, out_cols] f32.
SCENERF_API int scenerf_gather_levels_f32(const void* const* level_ptrs,
                                          const int* hwcc, int n_levels,
                                          const float* ix, const float* iy,
                                          int n_points, float* out,
                                          int out_cols, void* stream) {
  using namespace scenerf;
  if (n_levels < 1 || n_levels > kMaxLevels || n_points < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_points == 0) return (int)cudaSuccess;
  Levels lv;
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.ptr[l] = static_cast<const float*>(level_ptrs[l]);
    lv.H[l] = hwcc[4 * l + 0];
    lv.W[l] = hwcc[4 * l + 1];
    lv.C[l] = hwcc[4 * l + 2];
    lv.col[l] = hwcc[4 * l + 3];
    lv.vec[l] = (lv.C[l] % 4 == 0) && (lv.col[l] % 4 == 0) && (out_cols % 4 == 0) &&
                (reinterpret_cast<uintptr_t>(lv.ptr[l]) % 16 == 0) &&
                (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  }
  const int64_t blocks = ((int64_t)n_points + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gather_levels_kernel<<<(unsigned)blocks, kWarpsPerBlock * kWarpSize, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      lv, ix, iy, n_points, out, out_cols);
  return (int)cudaGetLastError();
}

SCENERF_API const char* scenerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
