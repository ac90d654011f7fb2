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
// Bound: bytes. The level rows the points touch are read (at best) once and
// the output written once; on the pyramid the output, 3.2 GB at 320,000
// points, is most of it. Besides, every point reads four corner rows of
// every level (40 KB at the KITTI widths), from L2 or L1 where neighbouring
// points share cells. Design, each choice made by the host per launch
// (ops/gather.py):
// - Lane groups sized to the launch: G lanes serve a point, G the next power
//   of two >= ceil(max_l C_l / 4) in [1, 32] (doubled for launches too small
//   to fill the card), each lane moving 4 channels at a time (16-byte loads
//   and stores where the level's rows and column slice are aligned; one
//   channel at a time otherwise: the `tiny` widths, the 3-channel taps,
//   where one thread serves a point in the 678,000-cell s1 resample). So the
//   32-channel s2 resample keeps all 32 lanes busy (8 per point), not 8 of
//   32 as one warp per point does.
// - The warp's coordinates of all levels come in one coalesced load per lane
//   before any corner is read (TileCoords), then shuffles.
// - Levels are read through the read-only path, the output written with
//   streaming stores (st.global.cs), which keep the write-once latent from
//   evicting the level lines that neighbouring points read next.
// - Wide levels (rows of >= 640 bytes: 160 f32 or 320 bf16 channels) go
//   through a cp.async ring of 16-byte slots in shared memory: two chunks of a point-level's corner rows in flight while the
//   third is interpolated (off-map corners zero-filled by the copy), in the
//   training and GT-depth launches (-15 to -20% there). The serve chunk's
//   320,000 points instead run 4 rounds of points per warp, walking 4
//   consecutive samples of a ray whose coarse-level corner rows it has just
//   read into L1 (-15%); the ring's 48 KB per block would take that L1.
// A sample-major walk of a chunk (adjacent rays at one sample index)
// measured slower at every shape: along a ray the coarse levels, 2240 of the
// 2480 channels, repeat cells. The interpolation uses explicitly rounded
// multiplies and adds, in the same order as the plain PyTorch version, so
// the two agree bit for bit.
//
// Levels and the output are f32, or bf16 on the mixed-precision path (one
// instantiation each; the coordinates and all arithmetic are f32 in both):
// a bf16 lane moves 8 channels per 16-byte vector where f32 moves 4, so the
// host sizes the lane groups by 16-byte vectors, and each output is
// interpolated in f32 from exactly converted corner values and rounded to
// bf16 once, as the plain version does it.
#include "gather_common.cuh"

namespace scenerf {
namespace {

using namespace gather;

__device__ __forceinline__ float lerp2(float a, float b, float wa, float wb) {
  // a * wa + b * wb without contraction into an fma
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

__device__ __forceinline__ float bilerp(float v00, float v10, float v01, float v11,
                                        const Corners& k) {
  return lerp2(lerp2(v00, v10, k.ux, k.wx), lerp2(v01, v11, k.ux, k.wx), k.uy, k.wy);
}

__device__ __forceinline__ float4 bilerp4(float4 a, float4 b, float4 c, float4 d,
                                          const Corners& k) {
  return make_float4(bilerp(a.x, b.x, c.x, d.x, k), bilerp(a.y, b.y, c.y, d.y, k),
                     bilerp(a.z, b.z, c.z, d.z, k), bilerp(a.w, b.w, c.w, d.w, k));
}

__device__ __forceinline__ Bf16x8 bilerp4(const Bf16x8& a, const Bf16x8& b, const Bf16x8& c,
                                          const Bf16x8& d, const Corners& k) {
  Bf16x8 o;
#pragma unroll
  for (int j = 0; j < 8; ++j) o.v[j] = bilerp(a.v[j], b.v[j], c.v[j], d.v[j], k);
  return o;
}

__device__ __forceinline__ void store4_cs(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ void store4_cs(bf16* p, const Bf16x8& v) {
  uint4 q;
  bf16* h = reinterpret_cast<bf16*>(&q);
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16_rn(v.v[j]);
  __stcs(reinterpret_cast<uint4*>(p), q);
}
__device__ __forceinline__ void store1_cs(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store1_cs(bf16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
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

// One level of one point, a 16-byte vector a lane: the vectors sub, sub + G, ...
template <typename T, int G>
__device__ __forceinline__ void level_vec(const T* base, const Corners& k, int nv, int sub,
                                          T* o) {
  for (int v = sub; v < nv; v += G) {
    const int c = Elem<T>::kVec * v;
    store4_cs(o + c, bilerp4(corner4(base, k.o00, c), corner4(base, k.o10, c),
                             corner4(base, k.o01, c), corner4(base, k.o11, c), k));
  }
}

// One level of one point, one channel a lane (unaligned or narrow levels),
// four of its channels at a time with all their corner loads issued first:
// a 3-channel tap served by one thread waits on one round trip, not three.
template <typename T, int G>
__device__ __forceinline__ void level_scalar(const T* base, const Corners& k, int C, int sub,
                                             T* o) {
  for (int c0 = sub; c0 < C; c0 += 4 * G) {
    float v[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j * G;
      const bool in = c < C;
      v[j][0] = in ? corner1(base, k.o00, c) : 0.f;
      v[j][1] = in ? corner1(base, k.o10, c) : 0.f;
      v[j][2] = in ? corner1(base, k.o01, c) : 0.f;
      v[j][3] = in ? corner1(base, k.o11, c) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j * G < C) store1_cs(o + c0 + j * G, bilerp(v[j][0], v[j][1], v[j][2], v[j][3], k));
    }
  }
}

// Wide levels through cp.async: a ring of kStages chunks of 32 16-byte
// vectors x 4 corners per warp in shared memory; each lane copies and later
// reads only its own slots, and off-map corners are zero-filled by the copy.
constexpr int kStages = 3;
constexpr int kAsyncMinBytes = 640;  // a level row of at least this goes through the ring
struct AsyncRing {
  float4 v[kStages][4][kWarpSize];
};

// a ring slot as the level's vector
template <typename T>
__device__ __forceinline__ typename Elem<T>::Vec slot_vec(const float4& slot) {
  return unpack(*reinterpret_cast<const typename Elem<T>::Raw*>(&slot));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__device__ __forceinline__ void level_async(AsyncRing& ring, const T* base, const Corners& k,
                                            int nv, int lane, T* o) {
  constexpr int kVec = Elem<T>::kVec;
  const int n_chunks = (nv + kWarpSize - 1) / kWarpSize;
  const int64_t offs[4] = {k.o00, k.o10, k.o01, k.o11};
  auto issue = [&](int chunk) {
    const int v = chunk * kWarpSize + lane;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = v < nv && offs[j] >= 0;
      cp_async16(&ring.v[chunk % kStages][j][lane], in ? base + offs[j] + kVec * v : base,
                 in ? 16 : 0);
    }
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) issue(s);
    cp_async_commit();
  }
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    if (chunk + kStages - 1 < n_chunks) issue(chunk + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // the chunk's own group has landed
    const int v = chunk * kWarpSize + lane;
    if (v < nv) {
      const int s = chunk % kStages;
      store4_cs(o + kVec * v,
                bilerp4(slot_vec<T>(ring.v[s][0][lane]), slot_vec<T>(ring.v[s][1][lane]),
                        slot_vec<T>(ring.v[s][2][lane]), slot_vec<T>(ring.v[s][3][lane]), k));
    }
  }
}

template <typename T, int G, bool kAsync>
__global__ void __launch_bounds__(kThreads)
gather_levels_kernel(Levels<T> lv, const float* __restrict__ ix, const float* __restrict__ iy,
                     int n_points, int rounds, T* __restrict__ out, int out_cols) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarpSize;
  const int sub = lane % G, q = lane / G;
  const int64_t warp = (int64_t)blockIdx.x * (kThreads / kWarpSize) + threadIdx.x / kWarpSize;
  AsyncRing& ring = reinterpret_cast<AsyncRing*>(smem_raw)[threadIdx.x / kWarpSize];

  for (int r = 0; r < rounds; ++r) {
    const int64_t first = (warp * rounds + r) * Lanes<G>::kPts;
    if (first >= n_points) return;  // warp-uniform
    TileCoords<G> tc;
    tc.load(ix, iy, lv.n, n_points, first, lane);
    const int64_t p = first + q;
    const bool active = p < n_points;
    T* orow = out + (active ? p : 0) * (int64_t)out_cols;
    for (int l = 0; l < lv.n; ++l) {
      const float2 xy = tc.at(l, q);  // every lane: it shuffles
      if (!active) continue;
      const int C = lv.C[l];
      const Corners k = corners(xy.x, xy.y, lv.H[l], lv.W[l], C);
      T* o = orow + lv.col[l];
      if (!lv.vec[l]) {
        level_scalar<T, G>(lv.val[l], k, C, sub, o);
      } else if (kAsync && C * (int)sizeof(T) >= kAsyncMinBytes) {
        level_async<T>(ring, lv.val[l], k, C / Elem<T>::kVec, lane, o);
      } else {
        level_vec<T, G>(lv.val[l], k, C / Elem<T>::kVec, sub, o);
      }
    }
  }
}

template <typename T, int G>
cudaError_t launch(const Levels<T>& lv, const float* ix, const float* iy, int n_points,
                   int rounds, bool async_wide, T* out, int out_cols, cudaStream_t stream) {
  const int64_t tiles = ((int64_t)n_points + Lanes<G>::kPts - 1) / Lanes<G>::kPts;
  const int64_t warps = (tiles + rounds - 1) / rounds;
  const int64_t blocks = (warps + kThreads / kWarpSize - 1) / (kThreads / kWarpSize);
  if constexpr (G == kWarpSize) {
    if (async_wide) {
      gather_levels_kernel<T, G, true>
          <<<(unsigned)blocks, kThreads, sizeof(AsyncRing) * (kThreads / kWarpSize), stream>>>(
              lv, ix, iy, n_points, rounds, out, out_cols);
      return cudaGetLastError();
    }
  }
  gather_levels_kernel<T, G, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
      lv, ix, iy, n_points, rounds, out, out_cols);
  return cudaGetLastError();
}

template <typename T>
int gather_entry(const void* const* level_ptrs, const int* hwcc, int n_levels, const float* ix,
                 const float* iy, int n_points, T* out, int out_cols, int lanes, int rounds,
                 int async_wide, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_points < 0 || rounds < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_points == 0) return (int)cudaSuccess;
  constexpr int kVec = Elem<T>::kVec;
  Levels<T> lv = {};
  lv.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    lv.val[l] = static_cast<const T*>(level_ptrs[l]);
    lv.H[l] = hwcc[4 * l + 0];
    lv.W[l] = hwcc[4 * l + 1];
    lv.C[l] = hwcc[4 * l + 2];
    lv.col[l] = hwcc[4 * l + 3];
    lv.vec[l] = (lv.C[l] % kVec == 0) && (lv.col[l] % kVec == 0) && (out_cols % kVec == 0) &&
                (reinterpret_cast<uintptr_t>(lv.val[l]) % 16 == 0) &&
                (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aw = async_wide != 0;
  switch (lanes) {
    case 1: return (int)launch<T, 1>(lv, ix, iy, n_points, rounds, aw, out, out_cols, s);
    case 2: return (int)launch<T, 2>(lv, ix, iy, n_points, rounds, aw, out, out_cols, s);
    case 4: return (int)launch<T, 4>(lv, ix, iy, n_points, rounds, aw, out, out_cols, s);
    case 8: return (int)launch<T, 8>(lv, ix, iy, n_points, rounds, aw, out, out_cols, s);
    case 16: return (int)launch<T, 16>(lv, ix, iy, n_points, rounds, aw, out, out_cols, s);
    case 32: return (int)launch<T, 32>(lv, ix, iy, n_points, rounds, aw, out, out_cols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace scenerf

// level_ptrs[l]: device pointer of the contiguous [H, W, C] map l, f32 (the
// _f32 entry) or bf16 (_bf16); hwcc[4 * l ...]: H, W, C and the output column
// offset of level l. ix, iy: [n_levels, n_points] f32; out: [n_points,
// out_cols] of the levels' type. lanes: lanes per point (1, 2, 4, ..., 32);
// rounds: point groups a warp serves one after another; async_wide: wide
// levels through cp.async.
SCENERF_API int scenerf_gather_levels_f32(const void* const* level_ptrs, const int* hwcc,
                                          int n_levels, const float* ix, const float* iy,
                                          int n_points, float* out, int out_cols, int lanes,
                                          int rounds, int async_wide, void* stream) {
  return scenerf::gather_entry<float>(level_ptrs, hwcc, n_levels, ix, iy, n_points, out,
                                      out_cols, lanes, rounds, async_wide, stream);
}

SCENERF_API int scenerf_gather_levels_bf16(const void* const* level_ptrs, const int* hwcc,
                                           int n_levels, const float* ix, const float* iy,
                                           int n_points, __nv_bfloat16* out, int out_cols,
                                           int lanes, int rounds, int async_wide, void* stream) {
  return scenerf::gather_entry<__nv_bfloat16>(level_ptrs, hwcc, n_levels, ix, iy, n_points, out,
                                              out_cols, lanes, rounds, async_wide, stream);
}

SCENERF_API const char* scenerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
