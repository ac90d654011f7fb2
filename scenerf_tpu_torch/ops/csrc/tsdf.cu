// Kernel T: TSDF integration of a frame sequence into a voxel volume.
//
// Replaces the TPU-shaped fusion of the JAX package:
// scenerf_tpu/fusion/tsdf.py:44 _integrate_one (a fused gather + elementwise
// update over the whole voxel grid) and :124 _integrate_frames (the frame
// sequence folded into one lax.scan), which fuse the reconstruction CLI's
// 63-pose sweep into the 256x256x32 KITTI grid.
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
// Bound: device-memory bytes. The volume (3 x 4 B per voxel, read and
// written once) and the frames (8 B per pixel: depth + packed color, read
// once) are 50.3 + 227.5 MB at the KITTI shapes, ~83 us at 3.35 TB/s, while
// the ~30 operations per voxel and frame are ~59 us at the f32 peak. Design:
// one thread per voxel, consecutive threads on consecutive z (the volume's
// contiguous axis, so its loads and stores coalesce), the frames looped
// inside the thread in sweep order with the voxel's state in registers: the
// volume moves through device memory once, however many frames there are.
// The per-frame depth reads are gathers; neighbouring voxels project to
// neighbouring pixels, and a color is read only where it is taken. The frames
// together exceed the 50 MB L2, so each resident wave of voxels streams its
// pixels of all frames through it (a later design could tile frames).
//
// Rounding as XLA compiles the JAX package's expressions: the world coords
// origin + i * voxel and the running averages t * w + obs * x are one fma
// each (__fmaf_rn); every other product, sum and quotient is rounded on its
// own, in the JAX package's order (__fmul_rn / __fadd_rn / __fdiv_rn, so
// nvcc contracts nothing else). rintf rounds half to even as jnp.round, and
// the pixel range check runs on the rounded floats, so no out-of-range value
// is ever cast to an int. The plain PyTorch version computes the same, and
// the two agree bit for bit.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace scenerf {
namespace {

constexpr int kThreads = 256;
constexpr float kColorConst = 65536.0f;

struct Frames {
  const float* depths;  // [F, H, W]
  const float* colors;  // [F, H, W] packed B*65536 + G*256 + R
  const float* intrs;   // [F, 3, 3]
  const float* w2cs;    // [F, 4, 4]
  int F, H, W;
};

// r*x + s*y + u*z + t, left to right, each step rounded
__device__ __forceinline__ float affine_row(const float* m, float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], x), __fmul_rn(m[1], y)),
                             __fmul_rn(m[2], z)), m[3]);
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

template <int kMode>
__global__ void __launch_bounds__(kThreads)
tsdf_integrate_kernel(float* __restrict__ tsdf, float* __restrict__ weight,
                      float* __restrict__ color, Frames fr, int X, int Y, int Z,
                      float ox, float oy, float oz, float voxel, float trunc, float obs) {
  const int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (v >= (int64_t)X * Y * Z) return;
  const int k = (int)(v % Z);
  const int j = (int)((v / Z) % Y);
  const int i = (int)(v / ((int64_t)Y * Z));
  // the voxel's world coords, one fma each
  const float wx = __fmaf_rn((float)i, voxel, ox);
  const float wy = __fmaf_rn((float)j, voxel, oy);
  const float wz = __fmaf_rn((float)k, voxel, oz);

  float t = tsdf[v], w = weight[v], c = color[v];
  const int64_t frame_px = (int64_t)fr.H * fr.W;
  for (int f = 0; f < fr.F; ++f) {
    const float* K = fr.intrs + 9 * f;
    const float* M = fr.w2cs + 16 * f;
    const float cx = affine_row(M, wx, wy, wz);
    const float cy = affine_row(M + 4, wx, wy, wz);
    const float cz = affine_row(M + 8, wx, wy, wz);
    const float sz = cz > 0.0f ? cz : 1.0f;
    const float px = rintf(__fadd_rn(__fdiv_rn(__fmul_rn(K[0], cx), sz), K[2]));
    const float py = rintf(__fadd_rn(__fdiv_rn(__fmul_rn(K[4], cy), sz), K[5]));
    if (!(px >= 0.0f && px < (float)fr.W && py >= 0.0f && py < (float)fr.H && cz > 0.0f)) {
      continue;  // out of view: depth 0, so not valid, and nothing changes
    }
    const int64_t pix = f * frame_px + (int64_t)py * fr.W + (int64_t)px;
    const float d = fr.depths[pix];
    const float dd = __fsub_rn(d, cz);
    if (!(d > 0.0f && dd >= -trunc)) continue;
    if (kMode == 0) {
      if (fabsf(t) >= fabsf(dd)) {
        t = dd;
        c = fr.colors[pix];
      }
      w = __fadd_rn(w, obs);
    } else {
      const float dist = fminf(1.0f, __fdiv_rn(dd, trunc));
      const float w_new = __fadd_rn(w, obs);
      t = __fdiv_rn(__fmaf_rn(t, w, __fmul_rn(obs, dist)), w_new);
      float old_rgb[3], new_rgb[3];
      unpack_rgb(c, old_rgb);
      unpack_rgb(fr.colors[pix], new_rgb);
      const float r = mix_channel(old_rgb[0], new_rgb[0], w, obs, w_new);
      const float g = mix_channel(old_rgb[1], new_rgb[1], w, obs, w_new);
      const float b = mix_channel(old_rgb[2], new_rgb[2], w, obs, w_new);
      c = __fadd_rn(__fadd_rn(__fmul_rn(b, kColorConst), __fmul_rn(g, 256.0f)), r);
      w = w_new;
    }
  }
  tsdf[v] = t;
  weight[v] = w;
  color[v] = c;
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
  if (F < 0 || H < 1 || W < 1 || X < 0 || Y < 0 || Z < 0 || (mode != 0 && mode != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n = (int64_t)X * Y * Z;
  if (n == 0 || F == 0) return (int)cudaSuccess;
  const Frames fr{depths, colors, intrs, w2cs, F, H, W};
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    tsdf_integrate_kernel<0><<<blocks, kThreads, 0, s>>>(tsdf, weight, color, fr, X, Y, Z,
                                                         ox, oy, oz, voxel, trunc, obs);
  } else {
    tsdf_integrate_kernel<1><<<blocks, kThreads, 0, s>>>(tsdf, weight, color, fr, X, Y, Z,
                                                         ox, oy, oz, voxel, trunc, obs);
  }
  return (int)cudaGetLastError();
}
