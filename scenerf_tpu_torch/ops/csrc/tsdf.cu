// Kernel T: TSDF integration of a frame sequence into a voxel volume.
//
// Replaces the TPU-shaped fusion of the JAX package:
// scenerf_tpu/fusion/tsdf.py:44 _integrate_one (a fused gather + elementwise
// update over the whole voxel grid) and :124 _integrate_frames (the frame
// sequence folded into one lax.scan), which fuse the reconstruction CLI's
// 63-pose sweep into the 256x256x32 KITTI grid and BundleFusion's 33-pose
// sweep and 16 GT depth maps into its 120x120x96 grid.
//
// Unlike JAX's immutable arrays, the tsdf, weight and color volumes are
// updated IN PLACE.
//
// For every voxel (i, j, k), in world coords w = origin + (i, j, k) * voxel,
// and every frame f in sweep order: the camera point c = R_f w + t_f, the
// pixel (px, py) = rint(fx c_x / z + cx, fy c_y / z + cy) with z = c_z if
// c_z > 0 else 1, and where the pixel lies in the image and c_z > 0 the depth
// d and the packed color at it; with dd = d - c_z a frame is valid where
// d > 0 and dd >= -trunc. "closest" (mode 0) takes dd and the color where
// |tsdf| >= |dd| (a later frame wins a tie) and adds obs_weight to the
// weight; "average" (mode 1) blends min(1, dd / trunc) and the unpacked RGB
// into the running weighted averages.
//
// Bound. Each voxel's state (3 x 4 B) is read and written once; a voxel-major
// kernel reads only the depth pixels voxels project to, and a color only
// where it is taken. The work is ~32 f32 operations per voxel-frame in view
// and ~7 more per valid one; a voxel-frame out of view needs none where whole
// tiles of them are culled at once. One thread per voxel with lanes along
// the contiguous z axis, the camera read from global memory and the exact
// chain on every voxel-frame (~97 instructions each) is bound by instruction
// issue and, at KITTI, by its depth gathers, a warp's 32 loads touching ~31
// sectors (PERF.md).
//
// Design:
// - Tiles of 32 x kWarps x kRun voxels. Lanes run along the grid axis A, x
//   or y, whose step moves a voxel's projection along an image row (the
//   lateral axis j at KITTI, x at BundleFusion), so a warp's depth loads
//   fall on one or two image rows; warps take consecutive values of the
//   other one, B, and each thread a run of kRun voxels along z. The block
//   decides A from the poses: each frame votes for the one of x and y with
//   the larger |R[0][a]| - |R[1][a]| (the camera's x row against its y row),
//   and the most votes win (a tie to x).
// - Frames culled per tile. For each pass of up to kChunk frames, 4 threads
//   test a frame against 2 of the tile's 8 corners each, in f64; the live
//   frames (in sweep order) and their cameras are staged in shared memory.
//   A frame is culled when every corner lies behind the camera, or every
//   corner lies in front and past the same image edge, each with a margin
//   (below) that covers the f32 chain's rounding: such a voxel-frame is one
//   the exact chain rejects too. Every live frame runs the exact chain, as
//   the plain version does.
// - Frames outer, the run inner: per live frame a thread reads the camera
//   from shared memory once and computes the fixed axes' products and their
//   sum, (R[r][0] x + R[r][1] y), once for its run (the additions stay in
//   the JAX package's order). It then projects the run's voxels, issues
//   their depth loads together (predicated, so they are in flight at once),
//   and updates those that are valid. The run's state lives in shared
//   memory, loaded and stored once as one 16-B vector per volume where the
//   run is whole and aligned, and touched in between only where a frame is
//   valid, so the registers hold the camera and the run's projections.
// - The depth and color loads go through the read-only cache (__ldg).
//
// The cull's margins. A voxel's camera row r in f32 (six roundings) lies
// within 2^-21 S_r of its exact value, S_r = sum_a |R[r][a]| max|w_a| +
// |t_r| over the tile (a corner bounds every voxel: the world coords are
// monotone in the index). The exact chain keeps px < 0 whenever
// fl(fx c_x) < (-1.5 - cx) c_z with c_z > 0 (then the quotient rounds to at
// most fl(-1.5 - cx) and the sum to at most -1.25), and px >= W whenever
// fl(fx c_x) > (W + 0.5 - cx) c_z; the same for rows. The corner test asks
// fx c_x - e c_z (f64, exact rows) to clear each such edge e by 2^-18
// (|fx| S_x + |e| S_z), and c_z to clear 0 by 2^-18 S_z: more than the f32
// rows' error, fx's rounding and the f64 arithmetic's together. The test is
// affine in w, so the corners settle the whole tile. A camera with a
// non-finite entry or a principal point or image size of 2^20 or more is
// never culled.
//
// Rounding as XLA compiles the JAX package's expressions: the world coords
// origin + i * voxel and the running averages t * w + obs * x are one fma
// each (__fmaf_rn); every other product, sum and quotient is rounded on its
// own, in the JAX package's order (__fmul_rn / __fadd_rn / __fdiv_rn, so
// nvcc contracts nothing else). The pixel is rounded half to even, as
// jnp.round, by adding and subtracting 1.5 * 2^23 (kRound below), and the
// range check runs on the rounded floats, so no out-of-range value is ever
// taken as an index. The plain PyTorch version computes the same, and the
// two agree bit for bit.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace scenerf {
namespace {

constexpr int kWarps = 8;                      // the tile's extent along axis B
constexpr int kThreads = kWarps * kWarpSize;
constexpr int kRun = 4;                        // voxels a thread holds along axis L
                                               // (ops/tsdf.py's TILE_RUN): one float4
constexpr int kChunk = kThreads / 4;           // frames culled and staged per pass: 4
                                               // threads a frame, 2 tile corners each
constexpr int kMinBlocks = 5;                  // resident blocks an SM fits: 48 registers
constexpr float kColorConst = 65536.0f;
// x + kRound - kRound is rintf(x) (half to even) for |x| < 2^22, and the
// integer sits in the low bits of x + kRound; for larger |x| it stays on the
// same side of [0, 2^22) as rintf(x), so the pixel range check reads the same
constexpr float kRound = 12582912.0f;          // 1.5 * 2^23
constexpr int kRoundBits = 0x4B400000;         // its bit pattern
constexpr double kMargin = 1.0 / 262144.0;     // 2^-18
constexpr double kMaxPixel = 1048576.0;        // 2^20

struct Volume {
  float* tsdf;
  float* weight;
  float* color;
  int dim[3];
};

struct Frames {
  const float* depths;  // [F, H, W]
  const float* colors;  // [F, H, W] packed B*65536 + G*256 + R
  const float* intrs;   // [F, 3, 3]
  const float* w2cs;    // [F, 4, 4]
  int F, H, W;
};

struct Grid {
  float origin[3];
  float voxel;
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// the tile counts of layout A (lanes along A, x or y; warps along B, the
// other; runs along z)
struct Layout {
  int A, B;
  int tiles[3];  // along A, B, z

  __host__ __device__ Layout(int a, const int dim[3]) : A(a), B(1 - a) {
    tiles[0] = ceil_div(dim[A], kWarpSize);
    tiles[1] = ceil_div(dim[B], kWarps);
    tiles[2] = ceil_div(dim[2], kRun);
  }
  __host__ __device__ int count() const { return tiles[0] * tiles[1] * tiles[2]; }
};

// frame's vote: y where |R[0][1]| - |R[1][1]| exceeds |R[0][0]| - |R[1][0]|,
// else x (a NaN never wins)
__device__ bool votes_y(const float* w2c) {
  return __fsub_rn(fabsf(w2c[1]), fabsf(w2c[5])) > __fsub_rn(fabsf(w2c[0]), fabsf(w2c[4]));
}

// the frame's camera: fx, cx, fy, cy and the three rows of world -> camera
__device__ void load_camera(const Frames& fr, int f, float k[4], float m[12]) {
  const float* K = fr.intrs + 9 * (int64_t)f;
  const float* M = fr.w2cs + 16 * (int64_t)f;
  k[0] = K[0];
  k[1] = K[2];
  k[2] = K[4];
  k[3] = K[5];
  for (int q = 0; q < 12; ++q) m[q] = M[q];
}

// The cull's test at one corner q (0..7) of the box [lo, hi] (world coords of
// the tile's corner voxels): bits kBehind .. kBottom where the corner clears
// that edge (see "The cull's margins" above); 0 for a camera that is never
// culled. A frame is culled when the bits of all 8 corners, ANDed, say
// behind, or in front and past one edge.
enum : unsigned { kBehind = 1, kFront = 2, kLeft = 4, kRight = 8, kTop = 16, kBottom = 32 };

__device__ unsigned corner_flags(const float k[4], const float m[12], const double lo[3],
                                 const double hi[3], int q, double W, double H) {
  bool finite = fabs((double)k[1]) < kMaxPixel && fabs((double)k[3]) < kMaxPixel &&
                W < kMaxPixel && H < kMaxPixel;
#pragma unroll
  for (int e = 0; e < 4; ++e) finite = finite && isfinite(k[e]);
#pragma unroll
  for (int e = 0; e < 12; ++e) finite = finite && isfinite(m[e]);
  if (!finite) return 0;
  const double w[3] = {q & 1 ? hi[0] : lo[0], q & 2 ? hi[1] : lo[1], q & 4 ? hi[2] : lo[2]};
  double S[3], c[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    S[r] = fabs((double)m[4 * r + 3]);
    c[r] = m[4 * r + 3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      S[r] += fabs((double)m[4 * r + a]) * fmax(fabs(lo[a]), fabs(hi[a]));
      c[r] += (double)m[4 * r + a] * w[a];
    }
  }
  const double e_left = -1.5 - k[1], e_right = W + 0.5 - k[1];
  const double e_top = -1.5 - k[3], e_bottom = H + 0.5 - k[3];
  const double fx = fabs((double)k[0]) * S[0], fy = fabs((double)k[2]) * S[1];
  const double u = k[0] * c[0], v = k[2] * c[1], tz = kMargin * S[2];
  unsigned bits = 0;
  bits |= c[2] <= -tz ? kBehind : 0u;
  bits |= c[2] > tz ? kFront : 0u;
  bits |= u - e_left * c[2] <= -kMargin * (fx + fabs(e_left) * S[2]) ? kLeft : 0u;
  bits |= u - e_right * c[2] >= kMargin * (fx + fabs(e_right) * S[2]) ? kRight : 0u;
  bits |= v - e_top * c[2] <= -kMargin * (fy + fabs(e_top) * S[2]) ? kTop : 0u;
  bits |= v - e_bottom * c[2] >= kMargin * (fy + fabs(e_bottom) * S[2]) ? kBottom : 0u;
  return bits;
}

// (old * w + obs * new) / w_new (the sum an fma), rounded half to even,
// capped at 255
__device__ __forceinline__ float mix_channel(float old_c, float new_c, float w, float obs,
                                             float w_new) {
  return fminf(rintf(__fdiv_rn(__fmaf_rn(old_c, w, __fmul_rn(obs, new_c)), w_new)), 255.0f);
}

__device__ __forceinline__ void unpack_rgb(float packed, float* rgb) {
  rgb[0] = fmodf(packed, 256.0f);
  rgb[1] = fmodf(floorf(__fdiv_rn(packed, 256.0f)), 256.0f);
  rgb[2] = floorf(__fdiv_rn(packed, kColorConst));
}

// A block's shared memory: its voxels' state (touched only where a frame is
// valid), its tile's corners and the live frames of a pass, in sweep order.
struct Shared {
  float state[3][kRun][kThreads];  // tsdf, weight, color of each thread's run
  float4 cam[kChunk][4];           // (fx, cx, fy, cy), then the rows of world -> camera
  int64_t first_pixel[kChunk];
  double lo[3], hi[3];             // the tile's corner voxels' world coords
  int warp_live[kWarps];
};

// One tile: lanes along lay.A, warps along lay.B, kRun voxels a thread along
// z.
template <int kMode>
__device__ void fuse_tile(const Layout& lay, const Volume& vol, const Frames& fr,
                          const Grid& g, float trunc, float obs, Shared& sh) {
  const int lane = threadIdx.x & (kWarpSize - 1), warp = threadIdx.x / kWarpSize;
  int t = blockIdx.x;
  const int tl = t % lay.tiles[2];
  t /= lay.tiles[2];
  const int ta = t % lay.tiles[0], tb = t / lay.tiles[0];
  // per grid axis: the tile's first voxel, its extent, and this thread's
  // first voxel
  int first[3], ext[3], idx[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const bool is_a = a == lay.A, is_b = a == lay.B;
    first[a] = is_a ? ta * kWarpSize : is_b ? tb * kWarps : tl * kRun;
    ext[a] = min(is_a ? kWarpSize : is_b ? kWarps : kRun, vol.dim[a] - first[a]);
    idx[a] = first[a] + (is_a ? lane : is_b ? warp : 0);
  }
  const int n_run = ext[2];
  const bool active = idx[0] < first[0] + ext[0] && idx[1] < first[1] + ext[1] &&
                      idx[2] < first[2] + ext[2];
  const int64_t base = ((int64_t)idx[0] * vol.dim[1] + idx[1]) * vol.dim[2] + idx[2];
  // the voxel's world coords on the thread's fixed axes, one fma each
  float wfix[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) wfix[a] = __fmaf_rn((float)idx[a], g.voxel, g.origin[a]);
  if (threadIdx.x < 3) {
    const int a = threadIdx.x;
    sh.lo[a] = __fmaf_rn((float)first[a], g.voxel, g.origin[a]);
    sh.hi[a] = __fmaf_rn((float)(first[a] + ext[a] - 1), g.voxel, g.origin[a]);
  }
  float* const st_t = &sh.state[0][0][threadIdx.x];
  float* const st_w = &sh.state[1][0][threadIdx.x];
  float* const st_c = &sh.state[2][0][threadIdx.x];
  // one 16-B vector per volume where the run is whole and every address
  // aligned (a volume may start anywhere 4-B aligned)
  const bool vec = n_run == kRun && ((reinterpret_cast<uintptr_t>(vol.tsdf + base) |
                                      reinterpret_cast<uintptr_t>(vol.weight + base) |
                                      reinterpret_cast<uintptr_t>(vol.color + base)) &
                                     15) == 0;
  if (active) {
    if (vec) {
      const float4 a = *reinterpret_cast<const float4*>(vol.tsdf + base);
      const float4 b = *reinterpret_cast<const float4*>(vol.weight + base);
      const float4 c = *reinterpret_cast<const float4*>(vol.color + base);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w},
                  cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        st_t[e * kThreads] = av[e];
        st_w[e * kThreads] = bv[e];
        st_c[e * kThreads] = cv[e];
      }
    } else {
      for (int q = 0; q < n_run; ++q) {
        st_t[q * kThreads] = vol.tsdf[base + q];
        st_w[q * kThreads] = vol.weight[base + q];
        st_c[q * kThreads] = vol.color[base + q];
      }
    }
  }
  const float Wf = (float)fr.W, Hf = (float)fr.H;
  const int64_t frame_px = (int64_t)fr.H * fr.W;
  const float run0 = (float)idx[2];

  for (int f0 = 0; f0 < fr.F; f0 += kChunk) {
    __syncthreads();  // the corners are in place; the last pass is done with the staged frames
    // cull: 4 threads test frame f0 + t / 4, each at 2 corners of the tile;
    // the live frames are staged in sweep order
    const int f = f0 + (int)threadIdx.x / 4, quarter = threadIdx.x & 3;
    float k[4], m[12];
    unsigned bits = 0;
    if (f < fr.F) {
      load_camera(fr, f, k, m);
      bits = corner_flags(k, m, sh.lo, sh.hi, 2 * quarter, (double)fr.W, (double)fr.H) &
             corner_flags(k, m, sh.lo, sh.hi, 2 * quarter + 1, (double)fr.W, (double)fr.H);
    }
    bits &= __shfl_xor_sync(kFullMask, bits, 1);
    bits &= __shfl_xor_sync(kFullMask, bits, 2);
    const bool unseen = (bits & kBehind) ||
                        ((bits & kFront) && (bits & (kLeft | kRight | kTop | kBottom)));
    const bool live = f < fr.F && quarter == 0 && !unseen;
    const unsigned ballot = __ballot_sync(kFullMask, live);
    if (lane == 0) sh.warp_live[warp] = __popc(ballot);
    __syncthreads();
    int pos = __popc(ballot & ((1u << lane) - 1u)), n_live = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      pos += w < warp ? sh.warp_live[w] : 0;
      n_live += sh.warp_live[w];
    }
    if (live) {
      sh.cam[pos][0] = make_float4(k[0], k[1], k[2], k[3]);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        sh.cam[pos][1 + r] = make_float4(m[4 * r], m[4 * r + 1], m[4 * r + 2], m[4 * r + 3]);
      }
      sh.first_pixel[pos] = f * frame_px;
    }
    __syncthreads();
    if (!active) continue;

    for (int q = 0; q < n_live; ++q) {
      const float4 kk = sh.cam[q][0];
      const float4 Mr[3] = {sh.cam[q][1], sh.cam[q][2], sh.cam[q][3]};
      // the fixed axes' share of each camera row, in the JAX package's order
      float P[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        P[r] = __fadd_rn(__fmul_rn(Mr[r].x, wfix[0]), __fmul_rn(Mr[r].y, wfix[1]));
      }
      const float* const dmap = fr.depths + sh.first_pixel[q];
      const float* const cmap = fr.colors + sh.first_pixel[q];
      // the run's voxels: their pixels first, then their depth loads
      // together (predicated, in flight at once), then their updates
      float cz[kRun], d[kRun];
      int off[kRun];
      bool seen[kRun];
      float lf = run0;
#pragma unroll
      for (int e = 0; e < kRun; ++e, lf = __fadd_rn(lf, 1.0f)) {
        const float wz = __fmaf_rn(lf, g.voxel, g.origin[2]);
        float c[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          c[r] = __fadd_rn(__fadd_rn(P[r], __fmul_rn(Mr[r].z, wz)), Mr[r].w);
        }
        // c_z <= 0 is out of view: the plain version divides by 1 there,
        // then rejects the pixel
        const float sz = c[2] > 0.0f ? c[2] : 1.0f;
        const float tx = __fadd_rn(__fadd_rn(__fdiv_rn(__fmul_rn(kk.x, c[0]), sz), kk.y),
                                   kRound);
        const float ty = __fadd_rn(__fadd_rn(__fdiv_rn(__fmul_rn(kk.z, c[1]), sz), kk.w),
                                   kRound);
        const float px = __fsub_rn(tx, kRound), py = __fsub_rn(ty, kRound);
        cz[e] = c[2];
        seen[e] = e < n_run && c[2] > 0.0f && px >= 0.0f && px < Wf && py >= 0.0f && py < Hf;
        off[e] = seen[e] ? (__float_as_int(ty) - kRoundBits) * fr.W +
                               (__float_as_int(tx) - kRoundBits)
                         : 0;
      }
#pragma unroll
      for (int e = 0; e < kRun; ++e) d[e] = seen[e] ? __ldg(dmap + off[e]) : 0.0f;
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        const float dd = __fsub_rn(d[e], cz[e]);
        if (!(seen[e] && d[e] > 0.0f && dd >= -trunc)) continue;
        float* const pt = st_t + e * kThreads;
        float* const pw = st_w + e * kThreads;
        float* const pc = st_c + e * kThreads;
        if (kMode == 0) {
          if (fabsf(*pt) >= fabsf(dd)) {
            *pt = dd;
            *pc = __ldg(cmap + off[e]);
          }
          *pw = __fadd_rn(*pw, obs);
        } else {
          const float w = *pw;
          const float dist = fminf(1.0f, __fdiv_rn(dd, trunc));
          const float w_new = __fadd_rn(w, obs);
          *pt = __fdiv_rn(__fmaf_rn(*pt, w, __fmul_rn(obs, dist)), w_new);
          float old_rgb[3], new_rgb[3];
          unpack_rgb(*pc, old_rgb);
          unpack_rgb(__ldg(cmap + off[e]), new_rgb);
          const float r = mix_channel(old_rgb[0], new_rgb[0], w, obs, w_new);
          const float gr = mix_channel(old_rgb[1], new_rgb[1], w, obs, w_new);
          const float b = mix_channel(old_rgb[2], new_rgb[2], w, obs, w_new);
          *pc = __fadd_rn(__fadd_rn(__fmul_rn(b, kColorConst), __fmul_rn(gr, 256.0f)), r);
          *pw = w_new;
        }
      }
    }
  }

  if (active) {
    if (vec) {
      *reinterpret_cast<float4*>(vol.tsdf + base) =
          make_float4(st_t[0], st_t[kThreads], st_t[2 * kThreads], st_t[3 * kThreads]);
      *reinterpret_cast<float4*>(vol.weight + base) =
          make_float4(st_w[0], st_w[kThreads], st_w[2 * kThreads], st_w[3 * kThreads]);
      *reinterpret_cast<float4*>(vol.color + base) =
          make_float4(st_c[0], st_c[kThreads], st_c[2 * kThreads], st_c[3 * kThreads]);
    } else {
      for (int q = 0; q < n_run; ++q) {
        vol.tsdf[base + q] = st_t[q * kThreads];
        vol.weight[base + q] = st_w[q * kThreads];
        vol.color[base + q] = st_c[q * kThreads];
      }
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tsdf_integrate_kernel(Volume vol, Frames fr, Grid g, float trunc, float obs) {
  __shared__ Shared sh;
  // the lanes' axis: the votes of all frames (every block counts the same)
  int votes_for_y = 0;
  for (int f0 = 0; f0 < fr.F; f0 += kThreads) {
    const int f = f0 + threadIdx.x;
    votes_for_y += __syncthreads_count(f < fr.F && votes_y(fr.w2cs + 16 * (int64_t)f));
  }
  const Layout lay(2 * votes_for_y > fr.F ? 1 : 0, vol.dim);
  if ((int)blockIdx.x >= lay.count()) return;  // the launch covers the larger layout
  fuse_tile<kMode>(lay, vol, fr, g, trunc, obs, sh);
}

}  // namespace
}  // namespace scenerf

// tsdf, weight, color: contiguous [X, Y, Z] f32 volumes, updated in place.
// depths, colors: [F, H, W] f32; intrs: [F, 3, 3]; w2cs: [F, 4, 4] (world ->
// camera). mode: 0 "closest", 1 "average".
SCENERF_API int scenerf_tsdf_integrate_f32(float* tsdf, float* weight, float* color,
                                           const float* depths, const float* colors,
                                           const float* intrs, const float* w2cs, int F,
                                           int H, int W, int X, int Y, int Z, float ox,
                                           float oy, float oz, float voxel, float trunc,
                                           float obs, int mode, void* stream) {
  using namespace scenerf;
  // a pixel's offset in its frame is an int; rounding needs H, W < 2^22
  if (F < 0 || H < 1 || W < 1 || H >= (1 << 22) || W >= (1 << 22) ||
      (int64_t)H * W >= ((int64_t)1 << 31) || X < 0 || Y < 0 || Z < 0 ||
      (mode != 0 && mode != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((int64_t)X * Y * Z == 0 || F == 0) return (int)cudaSuccess;
  const Volume vol{tsdf, weight, color, {X, Y, Z}};
  const Frames fr{depths, colors, intrs, w2cs, F, H, W};
  const Grid g{{ox, oy, oz}, voxel};
  // the kernel picks the layout from the poses: cover the larger
  const int n0 = Layout(0, vol.dim).count(), n1 = Layout(1, vol.dim).count();
  const int blocks = n0 > n1 ? n0 : n1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    tsdf_integrate_kernel<0><<<blocks, kThreads, 0, s>>>(vol, fr, g, trunc, obs);
  } else {
    tsdf_integrate_kernel<1><<<blocks, kThreads, 0, s>>>(vol, fr, g, trunc, obs);
  }
  return (int)cudaGetLastError();
}

// Kernel T's tile extents and cull constants (lanes, warps, run, margin,
// largest principal point or image size culled), for the plain twin of its
// plan in ops/tsdf.py to check its own against.
SCENERF_API int scenerf_tsdf_plan_constants(double* out) {
  using namespace scenerf;
  out[0] = kWarpSize;
  out[1] = kWarps;
  out[2] = kRun;
  out[3] = kMargin;
  out[4] = kMaxPixel;
  return 0;
}
