// What kernels G and G-bwd share: the level table, the lane groups, the
// staging of a warp's coordinates, and the four bilinear corners of a point.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace scenerf {
namespace gather {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;  // 8 warps per block

// Channel-last levels [H, W, C] and where each one's columns start in the
// [N, out_cols] latent (or its cotangent). `vec`: the level's rows, its
// gradient's rows and its column slice are all 16-byte aligned, so a lane
// moves one 16-byte vector (Elem<T>::kVec channels) at a time; otherwise 1.
template <typename T>
struct Levels {
  const T* val[kMaxLevels];  // values (kernel G; G-bwd reads them for coord grads)
  float* grad[kMaxLevels];   // G-bwd: f32 gradient to add into, null if unwanted
  int H[kMaxLevels];
  int W[kMaxLevels];
  int C[kMaxLevels];
  int col[kMaxLevels];
  int vec[kMaxLevels];
  int n;
};

// A group of G lanes (a power of two, 1..32) serves one point: the warp
// serves kPts = 32 / G points at once. Lane `sub` of a group takes the
// channel vectors sub, sub + G, ...
template <int G>
struct Lanes {
  static constexpr int kPts = kWarpSize / G;
  // coordinate values a warp stages per level and point, one per lane and
  // register: value k = l * kPts + q (level l, point q) sits in lane k % 32,
  // register k / 32
  static constexpr int kRegs = (kMaxLevels * kPts + kWarpSize - 1) / kWarpSize;
};

// The coordinates (ix, iy) of a warp's kPts points at every level: one
// coalesced load per lane and register, issued together before any corner
// is read, so a point's five levels wait on one round trip, not five.
template <int G>
struct TileCoords {
  float x[Lanes<G>::kRegs];
  float y[Lanes<G>::kRegs];

  __device__ __forceinline__ void load(const float* __restrict__ ix,
                                       const float* __restrict__ iy, int n_levels,
                                       int n_points, int64_t first, int lane) {
    constexpr int kPts = Lanes<G>::kPts;
#pragma unroll
    for (int i = 0; i < Lanes<G>::kRegs; ++i) {
      const int k = i * kWarpSize + lane;
      const int l = k / kPts;
      const int64_t p = first + k % kPts;
      const bool in = l < n_levels && p < n_points;
      const int64_t at = in ? (int64_t)l * n_points + p : 0;
      x[i] = in ? __ldg(ix + at) : 0.f;
      y[i] = in ? __ldg(iy + at) : 0.f;
    }
  }

  // Level l's (ix, iy) of point q. Every lane of the warp must call it
  // (it shuffles).
  __device__ __forceinline__ float2 at(int l, int q) const {
    constexpr int kPts = Lanes<G>::kPts;
    const int k = l * kPts + q;
    const int reg = (l * kPts) / kWarpSize;  // the same for every q: kPts divides 32
    float vx = x[0], vy = y[0];
#pragma unroll
    for (int i = 1; i < Lanes<G>::kRegs; ++i) {
      if (reg == i) {
        vx = x[i];
        vy = y[i];
      }
    }
    return make_float2(__shfl_sync(kFullMask, vx, k % kWarpSize),
                       __shfl_sync(kFullMask, vy, k % kWarpSize));
  }
};

// The four bilinear corners of (x, y) on an H x W map with C channels: the
// element offsets of their rows (-1 for a corner off the map: zero padding)
// and the weights, rounded exactly as the plain version computes them.
struct Corners {
  int64_t o00, o10, o01, o11;
  float wx, wy, ux, uy;
};

__device__ __forceinline__ Corners corners(float x, float y, int H, int W, int C) {
  Corners k;
  const float x0 = floorf(x), y0 = floorf(y);
  k.wx = __fsub_rn(x, x0);
  k.wy = __fsub_rn(y, y0);
  k.ux = __fsub_rn(1.0f, k.wx);
  k.uy = __fsub_rn(1.0f, k.wy);
  // bounds on the float corners: a huge or NaN coordinate is never cast
  const bool x0in = x0 >= 0.0f && x0 < (float)W;
  const bool x1in = x0 >= -1.0f && x0 < (float)(W - 1);
  const bool y0in = y0 >= 0.0f && y0 < (float)H;
  const bool y1in = y0 >= -1.0f && y0 < (float)(H - 1);
  const int64_t xi = x0in || x1in ? (int64_t)x0 : 0;
  const int64_t yi = y0in || y1in ? (int64_t)y0 : 0;
  k.o00 = x0in && y0in ? (yi * W + xi) * C : -1;
  k.o10 = x1in && y0in ? (yi * W + xi + 1) * C : -1;
  k.o01 = x0in && y1in ? ((yi + 1) * W + xi) * C : -1;
  k.o11 = x1in && y1in ? ((yi + 1) * W + xi + 1) * C : -1;
  return k;
}

// Element access by type: levels, the latent and its cotangent are f32 or
// bf16 (the mixed-precision path); coordinates, weights, arithmetic and the
// gradient buffers are f32. A 16-byte vector holds 4 f32 or 8 bf16
// channels; in registers it is a float4, or a Bf16x8 of 8 floats (a bf16
// value converts exactly to f32, and an output rounds to bf16 once, at its
// store, with __float2bfloat16_rn).
using bf16 = __nv_bfloat16;

struct Bf16x8 {
  float v[8];
};

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using Vec = float4;  // a vector in registers
  using Raw = float4;  // a vector as loaded
  static constexpr int kVec = 4;
};
template <>
struct Elem<bf16> {
  using Vec = Bf16x8;
  using Raw = uint4;
  static constexpr int kVec = 8;
};

__device__ __forceinline__ float4 unpack(float4 r) { return r; }
__device__ __forceinline__ Bf16x8 unpack(uint4 r) {
  Bf16x8 o;
  const bf16* h = reinterpret_cast<const bf16*>(&r);
#pragma unroll
  for (int j = 0; j < 8; ++j) o.v[j] = __bfloat162float(h[j]);
  return o;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ Bf16x8 load4(const bf16* p) {
  return unpack(__ldg(reinterpret_cast<const uint4*>(p)));
}
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// a streamed (read-once) vector or element: the cotangent
__device__ __forceinline__ float4 load4_cs(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint4 load4_cs_raw(const bf16* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ float4 load4_cs_raw(const float* p) { return load4_cs(p); }
__device__ __forceinline__ float load1_cs(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load1_cs(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcs(reinterpret_cast<const unsigned short*>(p))));
}

}  // namespace gather
}  // namespace scenerf
