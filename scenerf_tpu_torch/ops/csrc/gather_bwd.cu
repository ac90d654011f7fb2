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
// G into the channel-last f32 level gradient d_level[l] [H_l * W_l, C_l];
// out-of-bounds corners are skipped. The kernel only adds: the caller zeroes
// the buffer once, and on the training path every gather on one pyramid
// adds into the same buffers (ops/gather.py, PyramidGrads), so a step zeroes
// each level once, not once per launch. Where the caller asks for coordinate
// gradients (d_ix, d_iy not null) it re-gathers the four masked corner
// values and writes
//   d_ix[l, p] = sum_c g_c ((v10 - v00)(1 - wy) + (v11 - v01) wy)
//   d_iy[l, p] = sum_c g_c ((v01 (1 - wx) + v11 wx) - (v00 (1 - wx) + v10 wx))
// (the floor of a coordinate has zero derivative, as in autodiff of the
// plain version).
//
// Bound: bytes. A point reads its cotangent row (2480 floats at the KITTI
// widths) once and adds it, four times weighted, into up to four rows of
// every level; the adds accumulate in L2, and their traffic into L2 (four
// times the cotangent) is what bounds a mapping that issues them per point:
// one warp's scalar atomics to a row already reach L2 as whole sectors, so
// sm_90's vector atomics alone gained 7% at the training chunk. Design:
// - Wide launches (32 lanes per point, aligned levels, no coordinate
//   gradients, enough work: the pyramid's chunks and anchors) take the
//   run-merging mapping below: a warp walks 32 consecutive points of one
//   level and one slice of 32 vectors (128 f32 channels), sums the weighted cotangent in
//   registers while the points stay in one cell, and issues the atomics
//   when the cell changes (2.9x faster at the training chunk).
// - The rest take the per-point mapping: the lane groups of kernel G (G
//   lanes per point, the coordinate sums reduced over the group), the
//   coordinates staged once per warp, the cotangent read as a stream
//   (ld.global.cs: it is read once).
// Both add 4 channels at a time with atomicAdd(float4*, float4)
// (red.global.add.v4.f32) where the level gradient, the cotangent slice and
// the level are 16-byte aligned; misaligned levels and the `tiny` widths
// take scalar f32 atomics. Atomics make the summation order, and so the last
// bits of d_level, depend on the schedule: compare by tolerance. The corner
// weights are the plain version's autograd products, (g * (1 - wy)) * (1 -
// wx) and so on, with explicitly rounded multiplies.
//
// On the mixed-precision path the levels and the cotangent are bf16 (one
// instantiation each): a lane reads 8 cotangent channels per 16-byte vector,
// converts them exactly to f32, and adds into the same f32 gradient buffers
// with the same f32 atomics (two vector atomics per 8 channels); the
// coordinate gradients stay f32.
#include "gather_common.cuh"

namespace scenerf {
namespace {

using namespace gather;

__device__ __forceinline__ float4 mul4(float4 a, float s) {
  return make_float4(__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s),
                     __fmul_rn(a.w, s));
}

__device__ __forceinline__ Bf16x8 mul4(const Bf16x8& a, float s) {
  Bf16x8 o;
#pragma unroll
  for (int j = 0; j < 8; ++j) o.v[j] = __fmul_rn(a.v[j], s);
  return o;
}

__device__ __forceinline__ void red4(float* g, int64_t off, int c, float4 v) {
  if (off >= 0) atomicAdd(reinterpret_cast<float4*>(g + off + c), v);
}

__device__ __forceinline__ void red4(float* g, int64_t off, int c, const Bf16x8& v) {
  if (off >= 0) {
    atomicAdd(reinterpret_cast<float4*>(g + off + c),
              make_float4(v.v[0], v.v[1], v.v[2], v.v[3]));
    atomicAdd(reinterpret_cast<float4*>(g + off + c + 4),
              make_float4(v.v[4], v.v[5], v.v[6], v.v[7]));
  }
}

__device__ __forceinline__ void red1(float* g, int64_t off, int c, float v) {
  if (off >= 0) atomicAdd(g + off + c, v);
}

// the (d_ix, d_iy) terms of one channel
__device__ __forceinline__ void coord_terms(float go, float v00, float v10, float v01, float v11,
                                            const Corners& k, float& sx, float& sy) {
  const float gt = __fmul_rn(go, k.uy), gb = __fmul_rn(go, k.wy);
  const float top = __fadd_rn(__fmul_rn(v00, k.ux), __fmul_rn(v10, k.wx));
  const float bot = __fadd_rn(__fmul_rn(v01, k.ux), __fmul_rn(v11, k.wx));
  sx = __fadd_rn(sx, __fadd_rn(__fmul_rn(gt, __fsub_rn(v10, v00)),
                               __fmul_rn(gb, __fsub_rn(v11, v01))));
  sy = __fadd_rn(sy, __fmul_rn(go, __fsub_rn(bot, top)));
}

// the (d_ix, d_iy) terms of one vector's channels
__device__ __forceinline__ void coord_terms4(float4 go, float4 a, float4 b, float4 e, float4 f,
                                             const Corners& k, float& sx, float& sy) {
  coord_terms(go.x, a.x, b.x, e.x, f.x, k, sx, sy);
  coord_terms(go.y, a.y, b.y, e.y, f.y, k, sx, sy);
  coord_terms(go.z, a.z, b.z, e.z, f.z, k, sx, sy);
  coord_terms(go.w, a.w, b.w, e.w, f.w, k, sx, sy);
}
__device__ __forceinline__ void coord_terms4(const Bf16x8& go, const Bf16x8& a, const Bf16x8& b,
                                             const Bf16x8& e, const Bf16x8& f, const Corners& k,
                                             float& sx, float& sy) {
#pragma unroll
  for (int j = 0; j < 8; ++j) coord_terms(go.v[j], a.v[j], b.v[j], e.v[j], f.v[j], k, sx, sy);
}

__device__ __forceinline__ void zero(float4& v) { v = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(Bf16x8& v) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v.v[j] = 0.f;
}

template <typename T>
__device__ __forceinline__ typename Elem<T>::Vec corner4(const T* base, int64_t off, int c) {
  typename Elem<T>::Vec v;
  if (off >= 0) {
    v = load4(base + off + c);
  } else {
    zero(v);
  }
  return v;
}

template <typename T>
__device__ __forceinline__ float corner1(const T* base, int64_t off, int c) {
  return off >= 0 ? load1(base + off + c) : 0.f;
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
gather_levels_bwd_kernel(Levels<T> lv, const float* __restrict__ ix,
                         const float* __restrict__ iy, int n_points,
                         const T* __restrict__ dout, int out_cols,
                         float* __restrict__ d_ix, float* __restrict__ d_iy) {
  constexpr int kVec = Elem<T>::kVec;
  const int lane = threadIdx.x % kWarpSize;
  const int sub = lane % G, q = lane / G;
  const int64_t first =
      ((int64_t)blockIdx.x * (kThreads / kWarpSize) + threadIdx.x / kWarpSize) *
      Lanes<G>::kPts;
  if (first >= n_points) return;  // warp-uniform
  TileCoords<G> tc;
  tc.load(ix, iy, lv.n, n_points, first, lane);
  const int64_t p = first + q;
  const bool active = p < n_points;
  const T* grow = dout + (active ? p : 0) * (int64_t)out_cols;
  const bool want_xy = d_ix != nullptr;

  for (int l = 0; l < lv.n; ++l) {
    float* g = lv.grad[l];
    if (g == nullptr && !want_xy) continue;  // warp-uniform
    const float2 xy = tc.at(l, q);          // every lane: it shuffles
    const int C = lv.C[l];
    const Corners k = corners(xy.x, xy.y, lv.H[l], lv.W[l], C);
    const T* gcol = grow + lv.col[l];
    const T* v = lv.val[l];
    float sx = 0.f, sy = 0.f;
    if (active && lv.vec[l]) {
      for (int c = kVec * sub; c < C; c += kVec * G) {
        const auto go = unpack(load4_cs_raw(gcol + c));
        if (g != nullptr) {
          const auto gt = mul4(go, k.uy), gb = mul4(go, k.wy);  // row pairs
          red4(g, k.o00, c, mul4(gt, k.ux));
          red4(g, k.o10, c, mul4(gt, k.wx));
          red4(g, k.o01, c, mul4(gb, k.ux));
          red4(g, k.o11, c, mul4(gb, k.wx));
        }
        if (want_xy) {
          coord_terms4(go, corner4(v, k.o00, c), corner4(v, k.o10, c), corner4(v, k.o01, c),
                       corner4(v, k.o11, c), k, sx, sy);
        }
      }
    } else if (active) {
      for (int c = sub; c < C; c += G) {
        const float go = load1_cs(gcol + c);
        if (g != nullptr) {
          const float gt = __fmul_rn(go, k.uy), gb = __fmul_rn(go, k.wy);
          red1(g, k.o00, c, __fmul_rn(gt, k.ux));
          red1(g, k.o10, c, __fmul_rn(gt, k.wx));
          red1(g, k.o01, c, __fmul_rn(gb, k.ux));
          red1(g, k.o11, c, __fmul_rn(gb, k.wx));
        }
        if (want_xy) {
          coord_terms(go, corner1(v, k.o00, c), corner1(v, k.o10, c), corner1(v, k.o01, c),
                      corner1(v, k.o11, c), k, sx, sy);
        }
      }
    }
    if (want_xy) {
      sx = group_sum<G>(sx);
      sy = group_sum<G>(sy);
      if (active && sub == 0) {
        d_ix[(int64_t)l * n_points + p] = sx;
        d_iy[(int64_t)l * n_points + p] = sy;
      }
    }
  }
}

// The run-merging mapping, for launches of wide levels without coordinate
// gradients (the pyramid, the s16/s32 resamples): a warp takes one work unit
// (kTile consecutive points, one level, one chunk of 32 channel vectors) and
// walks its points in order, adding each point's four weighted cotangent
// vectors into registers while the points share a cell; it issues the four
// atomics only when the cell changes. Consecutive points are the samples of
// one ray, which at the coarse levels (2240 of the 2480 channels) land in the
// same cell again and again: this cuts the atomic traffic into L2, which
// bounds the per-point mapping (one warp's scalar or vector atomics to a
// row reach L2 as the same sectors). kAhead cotangent vectors per lane are
// loaded before their arithmetic.
constexpr int kTile = 32;
constexpr int kAhead = 8;
// Fewer units than this leave the card idle while each warp walks its
// points one after another: the single-level s8..s32 resamples (166-420
// warps) run faster per point, a training chunk's anchors (798) merging.
constexpr int64_t kRunsMinWarps = 512;

struct Units {
  int first[kMaxLevels + 1];  // a tile's first unit of each level; first[n]: units per tile
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ Bf16x8 add4(const Bf16x8& a, const Bf16x8& b) {
  Bf16x8 o;
#pragma unroll
  for (int j = 0; j < 8; ++j) o.v[j] = __fadd_rn(a.v[j], b.v[j]);
  return o;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_levels_bwd_runs_kernel(Levels<T> lv, Units units, const float* __restrict__ ix,
                              const float* __restrict__ iy, int n_points,
                              const T* __restrict__ dout, int out_cols) {
  using Vec = typename Elem<T>::Vec;
  using Raw = typename Elem<T>::Raw;
  constexpr int kVec = Elem<T>::kVec;
  const int lane = threadIdx.x % kWarpSize;
  const int64_t unit = (int64_t)blockIdx.x * (kThreads / kWarpSize) + threadIdx.x / kWarpSize;
  const int per_tile = units.first[lv.n];
  const int64_t first = unit / per_tile * kTile;
  if (first >= n_points) return;  // warp-uniform
  const int r = (int)(unit % per_tile);
  int l = 0;
  while (r >= units.first[l + 1]) ++l;
  const int C = lv.C[l];
  const int c = kVec * ((r - units.first[l]) * kWarpSize + lane);  // this lane's channels
  const bool on = c < C;
  float* g = lv.grad[l];
  const int n_in = (int)min((int64_t)kTile, (int64_t)n_points - first);
  const int64_t at = (int64_t)l * n_points + first + lane;
  const float cx = lane < n_in ? __ldg(ix + at) : 0.f;
  const float cy = lane < n_in ? __ldg(iy + at) : 0.f;
  const T* drow = dout + first * (int64_t)out_cols + lv.col[l] + (on ? c : 0);

  Vec acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) zero(acc[i]);
  int64_t cur[4] = {-1, -1, -1, -1};
  for (int t0 = 0; t0 < n_in; t0 += kAhead) {
    Raw go[kAhead];  // as loaded: a bf16 vector converts to f32 at its use
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (on && t0 + j < n_in) {
        go[j] = load4_cs_raw(drow + (int64_t)(t0 + j) * out_cols);
      } else {
        go[j] = Raw{};
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (t0 + j >= n_in) break;  // warp-uniform
      const Corners k = corners(__shfl_sync(kFullMask, cx, t0 + j),
                                __shfl_sync(kFullMask, cy, t0 + j), lv.H[l], lv.W[l], C);
      if (k.o00 != cur[0] || k.o10 != cur[1] || k.o01 != cur[2] || k.o11 != cur[3]) {
        if (on) {  // the run ends: its sums go out
#pragma unroll
          for (int i = 0; i < 4; ++i) red4(g, cur[i], c, acc[i]);
        }
        cur[0] = k.o00;
        cur[1] = k.o10;
        cur[2] = k.o01;
        cur[3] = k.o11;
#pragma unroll
        for (int i = 0; i < 4; ++i) zero(acc[i]);
      }
      const Vec gj = unpack(go[j]);
      const Vec gt = mul4(gj, k.uy), gb = mul4(gj, k.wy);  // row pairs
      acc[0] = add4(acc[0], mul4(gt, k.ux));
      acc[1] = add4(acc[1], mul4(gt, k.wx));
      acc[2] = add4(acc[2], mul4(gb, k.ux));
      acc[3] = add4(acc[3], mul4(gb, k.wx));
    }
  }
  if (on) {
#pragma unroll
    for (int i = 0; i < 4; ++i) red4(g, cur[i], c, acc[i]);
  }
}

template <typename T, int G>
cudaError_t launch(const Levels<T>& lv, const float* ix, const float* iy, int n_points,
                   const T* dout, int out_cols, float* d_ix, float* d_iy,
                   cudaStream_t stream) {
  const int64_t warps = ((int64_t)n_points + Lanes<G>::kPts - 1) / Lanes<G>::kPts;
  const int64_t blocks = (warps + kThreads / kWarpSize - 1) / (kThreads / kWarpSize);
  gather_levels_bwd_kernel<T, G><<<(unsigned)blocks, kThreads, 0, stream>>>(
      lv, ix, iy, n_points, dout, out_cols, d_ix, d_iy);
  return cudaGetLastError();
}

template <typename T>
int gather_bwd_entry(const void* const* level_vals, void* const* level_grads, const int* hwcc,
                     int n_levels, const float* ix, const float* iy, int n_points,
                     const T* dout, int out_cols, float* d_ix, float* d_iy, int lanes,
                     int per_point, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_points < 0 ||
      ((d_ix == nullptr) != (d_iy == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_points == 0) return (int)cudaSuccess;
  constexpr int kVec = Elem<T>::kVec;
  Levels<T> lv = {};
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.val[l] = static_cast<const T*>(level_vals[l]);
    lv.grad[l] = static_cast<float*>(level_grads[l]);
    lv.H[l] = hwcc[4 * l + 0];
    lv.W[l] = hwcc[4 * l + 1];
    lv.C[l] = hwcc[4 * l + 2];
    lv.col[l] = hwcc[4 * l + 3];
    if (d_ix != nullptr && lv.val[l] == nullptr) return (int)cudaErrorInvalidValue;
    lv.vec[l] = (lv.C[l] % kVec == 0) && (lv.col[l] % kVec == 0) && (out_cols % kVec == 0) &&
                (reinterpret_cast<uintptr_t>(dout) % 16 == 0) &&
                (reinterpret_cast<uintptr_t>(lv.grad[l]) % 16 == 0) &&
                (reinterpret_cast<uintptr_t>(lv.val[l]) % 16 == 0);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool runs = !per_point && lanes == kWarpSize && d_ix == nullptr;
  Units units = {};
  for (int l = 0; l < n_levels; ++l) {
    runs = runs && (lv.grad[l] == nullptr || lv.vec[l]);
    const int chunks =
        lv.grad[l] == nullptr ? 0 : (lv.C[l] / kVec + kWarpSize - 1) / kWarpSize;
    units.first[l + 1] = units.first[l] + chunks;
  }
  const int64_t warps = ((int64_t)n_points + kTile - 1) / kTile * units.first[n_levels];
  if (runs && warps >= kRunsMinWarps) {
    const int64_t blocks = (warps + kThreads / kWarpSize - 1) / (kThreads / kWarpSize);
    gather_levels_bwd_runs_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        lv, units, ix, iy, n_points, dout, out_cols);
    return (int)cudaGetLastError();
  }
  switch (lanes) {
    case 1: return (int)launch<T, 1>(lv, ix, iy, n_points, dout, out_cols, d_ix, d_iy, s);
    case 2: return (int)launch<T, 2>(lv, ix, iy, n_points, dout, out_cols, d_ix, d_iy, s);
    case 4: return (int)launch<T, 4>(lv, ix, iy, n_points, dout, out_cols, d_ix, d_iy, s);
    case 8: return (int)launch<T, 8>(lv, ix, iy, n_points, dout, out_cols, d_ix, d_iy, s);
    case 16: return (int)launch<T, 16>(lv, ix, iy, n_points, dout, out_cols, d_ix, d_iy, s);
    case 32: return (int)launch<T, 32>(lv, ix, iy, n_points, dout, out_cols, d_ix, d_iy, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace scenerf

// level_vals[l]: device pointer of the contiguous [H, W, C] map l, f32 (the
// _f32 entry) or bf16 (_bf16), read only when d_ix is not null;
// level_grads[l]: its [H, W, C] f32 gradient, added into, or null for a level
// that needs none; hwcc[4 * l ...]: H, W, C and the column offset of level l
// in dout. ix, iy: [n_levels, n_points] f32; dout: [n_points, out_cols] of the
// levels' type; d_ix, d_iy: [n_levels, n_points] f32, or both null when the
// coordinates need no gradient. lanes: lanes per point (1, 2, 4, ..., 32).
// The run-merging mapping serves launches of 32 lanes per point, 16-byte
// aligned levels and no coordinate gradients that give it at least
// kRunsMinWarps warps; the rest take the per-point mapping, and so does
// every launch with per_point = 1 (to measure what merging buys).
SCENERF_API int scenerf_gather_levels_bwd_f32(
    const void* const* level_vals, void* const* level_grads, const int* hwcc, int n_levels,
    const float* ix, const float* iy, int n_points, const float* dout, int out_cols,
    float* d_ix, float* d_iy, int lanes, int per_point, void* stream) {
  return scenerf::gather_bwd_entry<float>(level_vals, level_grads, hwcc, n_levels, ix, iy,
                                          n_points, dout, out_cols, d_ix, d_iy, lanes,
                                          per_point, stream);
}

SCENERF_API int scenerf_gather_levels_bwd_bf16(
    const void* const* level_vals, void* const* level_grads, const int* hwcc, int n_levels,
    const float* ix, const float* iy, int n_points, const __nv_bfloat16* dout, int out_cols,
    float* d_ix, float* d_iy, int lanes, int per_point, void* stream) {
  return scenerf::gather_bwd_entry<__nv_bfloat16>(level_vals, level_grads, hwcc, n_levels, ix,
                                                  iy, n_points, dout, out_cols, d_ix, d_iy,
                                                  lanes, per_point, stream);
}
