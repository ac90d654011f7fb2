// Kernel K5: batch normalization fused with its activation and an optional
// residual add, forward and backward, over a channel-last [M, C] tensor.
//
// Replaces the TPU-shaped scenerf_tpu/encoder/norm.py:31 FusedBatchNorm (f32
// statistics with the converts fused into the reductions, the affine folded
// into per-channel mul/add in the compute dtype) together with the swish /
// leaky-ReLU that follows it (scenerf_tpu/encoder/backbones.py:99,106,161;
// scenerf_tpu/encoder/sphere_decoder.py:153,157,161,165): the affine +
// activation half was the prologue of the JAX package's deleted Pallas conv.
//
//   N1 bn_stats       per-channel sum x and sum x^2 over the M rows, then the
//                     finalize: mean, mean2, var = max(mean2 - mean^2, 0)
//                     (E[x^2] - E[x]^2 as the reference computes it, not
//                     Welford), mul = w rsqrt(var + eps), add = b - mean mul,
//                     and the running statistics updated in place in flax's
//                     convention (ra = m ra + (1 - m) batch, the biased
//                     variance).
//   N2 bn_apply       z = x mul + add (+ r), y = act(z); in eval mode it folds
//                     mul/add from the running statistics itself.
//   N3 bn_bwd_reduce  g = dy act'(z) with z recomputed from x (no saved
//                     pre-activation), per-channel sum g and sum g x, then the
//                     finalize: dweight, dbias and the two per-channel
//                     coefficients of dx.
//   N4 bn_bwd_apply   dx = g mul + alpha_c + beta_c x; d_r = g.
//
// The gradient goes through mean and var as JAX's autodiff of FusedBatchNorm
// sends it: rsqrt's derivative -0.5 rsqrt(v) / v, and at max(v_raw, 0) half
// of it where v_raw == 0 (jnp.maximum's tie), none where v_raw < 0.
//
// Bound: device-memory bytes. Per element the work is a few operations
// (~10-20 with the SiLU), far under the card's 160 f32 operations per 8 bytes
// moved. The least traffic: train forward 2 passes over x (read x, write y)
// plus a read of r where the statistics stay on chip, 3 where x is read again;
// eval forward 2; backward 3 (read x and dy, write dx) plus r and d_r where
// the activation needs them, 5 where x and dy are read again.
//
// Two paths for a channel-last training site, chosen on the host per shape
// (ops/norm.py `plan`):
//
// The cluster path (forward and backward, stages 3): one launch per direction.
// A channel slice of SV vectors (32 bytes of each row) belongs to one thread
// block cluster of cs blocks (blockIdx.y the slice, blockIdx.x the rank);
// the cluster's blocks split the M rows. Each block copies its rows of the
// slice into shared memory once (cp.async, every thread its own 16-byte
// vectors, so it reads back only what it copied: no barrier before use): x,
// and the residual in the forward; x, dy and the residual where z needs it in
// the backward. It sums over its rows (per thread in f32, then the block's
// warps by shuffles in a fixed order), the cluster's blocks read each other's
// sums through distributed shared memory after cluster.sync() and each adds
// them in rank order in f64, so every block finalizes the same statistics
// (or gradients) and they are deterministic; rank 0 writes them (and the
// running statistics). Each block then applies N2 (or N4) to the tile it
// holds. No partials reach device memory and x is read once.
//
// The streaming path (the sites whose tile does not fit, every channel-first
// input, and a stage launched alone): the reduction (N1 or N3) with its
// finalize folded in, then the elementwise pass (N2 or N4). A thread owns VW
// consecutive channels (one 16-byte vector, VW = 4 in f32 or 8 in bf16, where
// C % VW == 0 and every pointer is 16-byte aligned, else 1) and walks the
// rows; TW threads cover a row (or a tile of it: columns of 32 channels in
// the reductions but N3 over at most 128 channels, up to 256 vectors in the
// elementwise passes), RB rows per block, so a warp reads consecutive
// addresses whatever C is. The row loop keeps 4 independent
// loads in flight per thread. The reduction sums in f32 per thread, then over
// the block's rows in shared memory, into one partial per block and channel
// in the workspace (at most 1/16 of x's bytes); the last block of each
// column of blocks to finish (an atomic ticket after a __threadfence, set
// back to 0 by that block for the next launch) sums the column's partials in
// f64 in a fixed order and finalizes its channels. A
// channel-first input (a [B, H, W, C] view of an NCHW-contiguous tensor, as
// the eval encoder's convolutions give) takes kernels of its own with one
// channel per blockIdx.y and the positions of its planes across the threads,
// scalar loads; the outputs keep the input's layout.
//
// Every kernel is templated on the element type T of x, r, y, dy, dx and d_r
// (f32, and bf16 for the mixed-precision path), always with f32 arithmetic and
// accumulation; the statistics, the per-channel vectors, the parameter
// gradients and the running statistics stay f32. In bf16 every value is
// converted to f32 when it is loaded (__bfloat162float) and each output is
// rounded to bf16 once, when it is stored (__float2bfloat16_rn): z, act(z),
// dx and g are f32 in between. ops/norm.py's plain version rounds at the same
// points.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace scenerf {
namespace {

constexpr int kThreads = 256;       // threads per block of the streaming kernels (at most)
constexpr int kClusterThreads = 512;  // threads per block of the cluster kernels
constexpr int kClusterWarps = kClusterThreads / kWarpSize;
constexpr int kSMs = 132;           // an H100's SMs
constexpr int kRedBlocks = 528;     // most blocks of a streaming reduction: 4 per SM
constexpr int kPartialBytes = 128;  // a streaming reduction: a block per 128 bytes of a channel at most
constexpr int kRedColumn = 32;      // channels of a streaming reduction's column of blocks
constexpr int kWideRow = 128;       // N3 over at most this many channels: whole rows
constexpr int64_t kWideBytes = 64 << 20;  // whole-row N3 over x this large: kRedBlocks blocks
constexpr int kApplyBlocks = 1056;  // most blocks of an elementwise pass (N2, N4)
constexpr int kUnroll = 4;          // rows in flight per thread
constexpr int kMaxChannels = 65535;  // the widest C an entry takes
// the workspace's head: a ticket for each column of blocks of the widest C
// (a fixed size, so that no launch's partials overlap another's tickets in a
// shared workspace), rounded up to 256 bytes
constexpr int kTickets = ((kMaxChannels + kRedColumn - 1) / kRedColumn + 63) / 64 * 64;
constexpr int kMaxCluster = 16;     // blocks of a cluster (above 8: non-portable)
constexpr float kLeakySlope = 0.01f;

enum Act { kIdentity = 0, kSilu = 1, kLeaky = 2 };
// rows of the per-channel stats [5, C]
enum StatRow { kMean = 0, kVarRaw = 1, kInv = 2, kMul = 3, kAdd = 4 };
// rows of the per-channel gradients [4, C]
enum GradRow { kDWeight = 0, kDBias = 1, kAlpha = 2, kBeta = 3 };

struct Tile {
  int V;       // vectors per row (C / vw)
  int TW;      // threads across a row tile
  int RB;      // rows per block
  int gy;      // row tiles (blocks along y)
  int gx;      // blocks along the rows
};

// a row in tiles of at most kThreads vectors, balanced; or (column > 0) in
// columns of `column` vectors, the last one narrower
Tile make_tile(int64_t M, int C, int vw, int max_blocks, int column = 0) {
  Tile t;
  t.V = C / vw;
  if (column > 0) {
    t.TW = min(column, t.V);
    t.gy = (t.V + t.TW - 1) / t.TW;
  } else {
    t.gy = (t.V + kThreads - 1) / kThreads;
    t.TW = (t.V + t.gy - 1) / t.gy;
  }
  t.RB = kThreads / t.TW;
  const int64_t row_blocks = (M + t.RB - 1) / t.RB;
  const int64_t cap = max_blocks / t.gy > 0 ? max_blocks / t.gy : 1;
  t.gx = (int)(row_blocks < cap ? row_blocks : cap);
  if (t.gx < 1) t.gx = 1;
  return t;
}

using bf16 = __nv_bfloat16;

// one element to f32 and back (bf16: the conversion intrinsics, round to
// nearest even)
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// channels of one 16-byte vector
template <typename T>
constexpr int kVecWidth = 16 / (int)sizeof(T);

// VW elements as one load or store: a 16-byte vector, or one element
template <typename T, int VW>
struct alignas(sizeof(T) * VW) Pack {
  T v[VW];
};

// a pack from (or to) memory: one 128-bit access for a 16-byte pack
template <typename T, int VW>
__device__ __forceinline__ Pack<T, VW> read_pack(const Pack<T, VW>* p) {
  if constexpr (sizeof(Pack<T, VW>) == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    Pack<T, VW> r;
    memcpy(&r, &q, 16);
    return r;
  } else {
    return *p;
  }
}

template <typename T, int VW>
__device__ __forceinline__ void write_pack(Pack<T, VW>* p, const Pack<T, VW>& v) {
  if constexpr (sizeof(Pack<T, VW>) == 16) {
    uint4 q;
    memcpy(&q, &v, 16);
    *reinterpret_cast<uint4*>(p) = q;
  } else {
    *p = v;
  }
}

template <typename T, int VW>
__device__ __forceinline__ void unpack(const Pack<T, VW>& q, float (&v)[VW]) {
#pragma unroll
  for (int j = 0; j < VW; ++j) v[j] = to_f32(q.v[j]);
}

template <typename T, int VW>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&v)[VW]) {
  unpack(read_pack(reinterpret_cast<const Pack<T, VW>*>(p)), v);
}

template <typename T, int VW>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[VW]) {
  Pack<T, VW> q;
#pragma unroll
  for (int j = 0; j < VW; ++j) q.v[j] = from_f32<T>(v[j]);
  write_pack(reinterpret_cast<Pack<T, VW>*>(p), q);
}

// z = x mul + add (+ r), each step rounded, in the plain version's order: N2
// and, recomputing z, N3 and N4 take the same z (and the same side of the
// leaky-ReLU's kink) as the forward
__device__ __forceinline__ float pre_act(float x, float mul, float add) {
  return __fadd_rn(__fmul_rn(x, mul), add);
}

template <int ACT>
__device__ __forceinline__ float act_fwd(float z) {
  if (ACT == kSilu) return __fdiv_rn(z, 1.0f + expf(-z));
  if (ACT == kLeaky) return z >= 0.0f ? z : kLeakySlope * z;
  return z;
}

// d act / dz: SiLU s (1 + z (1 - s)), leaky 1 where z >= 0 (JAX's where)
template <int ACT>
__device__ __forceinline__ float act_grad(float z) {
  if (ACT == kSilu) {
    const float s = __fdiv_rn(1.0f, 1.0f + expf(-z));
    return s * (1.0f + z * (1.0f - s));
  }
  if (ACT == kLeaky) return z >= 0.0f ? 1.0f : kLeakySlope;
  return 1.0f;
}

// the per-channel affine folded from the running statistics (eval); an eval
// launch that is given `stats` records the fold there for its backward
__device__ __forceinline__ void fold(const float* __restrict__ weight,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ run_mean,
                                     const float* __restrict__ run_var, float eps, int c,
                                     float& mean, float& var, float& inv, float& mul,
                                     float& add) {
  mean = run_mean[c];
  var = run_var[c];
  inv = rsqrtf(__fadd_rn(var, eps));
  mul = __fmul_rn(weight[c], inv);
  add = __fsub_rn(bias[c], __fmul_rn(mean, mul));
}

// N1's finalize of channel c from sum x (s) and sum x^2 (q) over the M rows:
// the statistics and the running update (where `write`); mul and add out
struct StatsFin {
  int64_t M;
  int C;
  const float* weight;
  const float* bias;
  float* run_mean;
  float* run_var;
  float momentum, one_minus_momentum, eps;
  float* stats;

  __device__ __forceinline__ void operator()(int c, double s, double q, bool write, float& mul,
                                             float& add) const {
    const float mean = (float)(s / (double)M);
    const float mean2 = (float)(q / (double)M);
    const float var_raw = __fsub_rn(mean2, __fmul_rn(mean, mean));
    const float var = fmaxf(var_raw, 0.0f);
    const float inv = rsqrtf(__fadd_rn(var, eps));
    mul = __fmul_rn(weight[c], inv);
    add = __fsub_rn(bias[c], __fmul_rn(mean, mul));
    if (!write) return;
    stats[kMean * C + c] = mean;
    stats[kVarRaw * C + c] = var_raw;
    stats[kInv * C + c] = inv;
    stats[kMul * C + c] = mul;
    stats[kAdd * C + c] = add;
    run_mean[c] = __fadd_rn(__fmul_rn(momentum, run_mean[c]),
                            __fmul_rn(one_minus_momentum, mean));
    run_var[c] = __fadd_rn(__fmul_rn(momentum, run_var[c]), __fmul_rn(one_minus_momentum, var));
  }
  __device__ __forceinline__ void operator()(int c, double s, double q) const {
    float mul, add;
    (*this)(c, s, q, true, mul, add);
  }
};

// N3's finalize of channel c from sum g (sg) and sum g x (sgx): dweight,
// dbias (where `write`) and dx's coefficients alpha, beta (out)
struct GradsFin {
  int64_t M;
  int C;
  const float* weight;
  const float* stats;
  float eps;
  int train;
  float* grads;

  __device__ __forceinline__ void operator()(int c, double sg, double sgx, bool write,
                                             float& alpha_out, float& beta_out) const {
    const double mean = stats[kMean * C + c], inv = stats[kInv * C + c];
    const double mul = stats[kMul * C + c];
    // z = x mul + add, add = bias - mean mul, mul = weight inv
    const double dmul = sgx - mean * sg;
    double alpha = 0.0, beta = 0.0;
    if (train) {
      // inv = rsqrt(var + eps), var = max(var_raw, 0), var_raw = mean2 - mean^2
      const float var_raw = stats[kVarRaw * C + c];
      const double var = var_raw > 0.0f ? (double)var_raw : 0.0;
      const double dinv = dmul * (double)weight[c];
      const double dvar = dinv * (-0.5 * inv / (var + (double)eps));
      const double share = var_raw > 0.0f ? 1.0 : (var_raw == 0.0f ? 0.5 : 0.0);
      const double dvar_raw = dvar * share;
      const double dmean = -mul * sg - 2.0 * mean * dvar_raw;
      alpha = dmean / (double)M;
      beta = 2.0 * dvar_raw / (double)M;
    }
    alpha_out = (float)alpha;
    beta_out = (float)beta;
    if (!write) return;
    grads[kDWeight * C + c] = (float)(dmul * inv);
    grads[kDBias * C + c] = (float)sg;
    grads[kAlpha * C + c] = alpha_out;
    grads[kBeta * C + c] = beta_out;
  }
  __device__ __forceinline__ void operator()(int c, double sg, double sgx) const {
    float alpha, beta;
    (*this)(c, sg, sgx, true, alpha, beta);
  }
  // the synced path: dx's coefficients from the world's sums (sgw, sgxw, over
  // the world's M rows), dweight and dbias from this rank's own (sg, sgx), as
  // JAX's autodiff of a pmean'd FusedBatchNorm gives them before the gradient
  // pmean; with one rank the two are the same numbers, and so is the result
  __device__ __forceinline__ void split(int c, double sg, double sgx, double sgw,
                                        double sgxw) const {
    float alpha, beta;
    (*this)(c, sgw, sgxw, false, alpha, beta);
    grads[kDWeight * C + c] = (float)((sgx - (double)stats[kMean * C + c] * sg) *
                                      (double)stats[kInv * C + c]);
    grads[kDBias * C + c] = (float)sg;
    grads[kAlpha * C + c] = alpha;
    grads[kBeta * C + c] = beta;
  }
};

// the synced path's reductions (N1 or N3 without its finalize): the last block
// of a column writes its channels' f64 sums [2, C] where the streaming path
// would finalize them. ops/norm.py all-reduces them over the ranks, then a
// finalize launch (bn_stats_finalize_kernel, bn_grads_finalize_kernel) reads
// them. The sums are those the streaming finalize takes, in the same order.
struct SumsOut {
  int C;
  double* sums;

  __device__ __forceinline__ void operator()(int c, double s, double q) const {
    sums[c] = s;
    sums[C + c] = q;
  }
};

// the synced forward's finalize from the world's sums [2, C] over fin.M rows:
// one thread a channel
__global__ void __launch_bounds__(kThreads)
bn_stats_finalize_kernel(const double* __restrict__ sums, StatsFin fin) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < fin.C) fin(c, sums[c], sums[fin.C + c]);
}

// the synced backward's finalize from this rank's sums and the world's
// (fin.M: the world's rows)
__global__ void __launch_bounds__(kThreads)
bn_grads_finalize_kernel(const double* __restrict__ local, const double* __restrict__ world,
                         GradsFin fin) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < fin.C) fin.split(c, local[c], local[fin.C + c], world[c], world[fin.C + c]);
}

// ---- the streaming path ----------------------------------------------------

// the row loop of one thread: rows ty, ty + step, ... of the block's share,
// kUnroll at a time
#define SCENERF_ROWS(...)                                                    \
  {                                                                          \
    const int64_t step = (int64_t)RB * gridDim.x;                            \
    for (int64_t r0 = (int64_t)blockIdx.x * RB + ty; r0 < M;                 \
         r0 += step * kUnroll) {                                             \
      _Pragma("unroll") for (int u = 0; u < kUnroll; ++u) {                  \
        const int64_t r = r0 + u * step;                                     \
        if (r < M) { __VA_ARGS__ }                                           \
      }                                                                      \
    }                                                                        \
  }

// sums a[2][VW] over the block's RB rows (shared memory tree) and writes the
// block's partials [gx, 2C]: row blockIdx.x, first C the sums of a[0], then
// those of a[1]
template <int VW>
__device__ __forceinline__ void block_partials(float (&a)[2][VW], int tx, int ty, int TW,
                                               int RB, bool active, int c0, int C,
                                               float* __restrict__ partials) {
  __shared__ float sm[2][kThreads * VW];
  const int slot = (ty * TW + tx) * VW;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int j = 0; j < VW; ++j) sm[k][slot + j] = a[k][j];
  }
  __syncthreads();
  int span = 1;
  while (span < RB) span <<= 1;
  for (int s = span >> 1; s > 0; s >>= 1) {
    if (ty < s && ty + s < RB) {
      const int other = ((ty + s) * TW + tx) * VW;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int j = 0; j < VW; ++j) sm[k][slot + j] += sm[k][other + j];
      }
    }
    __syncthreads();
  }
  if (ty == 0 && active) {
    float* row = partials + (int64_t)blockIdx.x * 2 * C;
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      row[c0 + j] = sm[0][slot + j];
      row[C + c0 + j] = sm[1][slot + j];
    }
  }
}

// true in every thread of the block that arrives last at `ticket` of the
// `blocks` that share it (every block's partials are then visible to it);
// that block sets the ticket back to 0 for the next launch
__device__ __forceinline__ bool last_block(unsigned* ticket, unsigned blocks) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1u) == blocks - 1;
    if (last) *ticket = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// the last block's finalize of channels [c0, c1): each channel's gx partial
// rows summed in f64 by the block's threads, lane l of a channel taking rows
// l, l + lanes, ..., then the lanes in order (fixed: the result does not
// depend on which block came last); fin(c, sum, sum2) per channel
template <typename Fin>
__device__ __forceinline__ void finalize_columns(const float* __restrict__ partials, int gx,
                                                 int C, int c0, int c1, const Fin& fin) {
  __shared__ double red[2][kThreads];
  const int nt = blockDim.x, t = threadIdx.x;
  for (int cb = c0; cb < c1; cb += nt) {
    const int nc = min(nt, c1 - cb);
    const int lanes = nt / nc;
    const int ci = t % nc, li = t / nc;
    double s = 0.0, q = 0.0;
    if (li < lanes) {
      // rows li, li + lanes, ... in order, 8 loads in flight
      const float* col = partials + cb + ci;
      constexpr int kInFlight = 8;
      for (int p0 = li; p0 < gx; p0 += kInFlight * lanes) {
        float v[kInFlight], w[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int p = p0 + u * lanes;
          v[u] = p < gx ? __ldcg(col + (int64_t)p * 2 * C) : 0.0f;
          w[u] = p < gx ? __ldcg(col + (int64_t)p * 2 * C + C) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          s += (double)v[u];
          q += (double)w[u];
        }
      }
    }
    red[0][t] = s;
    red[1][t] = q;
    __syncthreads();
    if (t < nc) {
      for (int l = 1; l < lanes; ++l) {
        s += red[0][l * nc + t];
        q += red[1][l * nc + t];
      }
      fin(cb + t, s, q);
    }
    __syncthreads();
  }
}

// finalize_columns for 16-byte-aligned columns of whole channel quads (N3's
// whole rows on the vector path): lane l of a quad takes rows l, l + lanes,
// ... as float4 loads, 8 in flight, so the last block reads the partials at
// a few rows a lane; the sums are f64 and the lanes add in order, as above.
// The whole-row N3 takes it, the 32-channel columns the scalar finalize.
template <typename Fin>
__device__ __forceinline__ void finalize_columns4(const float* __restrict__ partials, int gx,
                                                  int C, int c0, int c1, const Fin& fin) {
  __shared__ double red4[2][kThreads][4];
  const int nt = blockDim.x, t = threadIdx.x;
  for (int cb = c0; cb < c1; cb += 4 * nt) {
    const int nq = min(nt, (c1 - cb) / 4);
    const int lanes = nt / nq;
    const int qi = t % nq, li = t / nq;
    double s[4] = {0.0, 0.0, 0.0, 0.0}, q[4] = {0.0, 0.0, 0.0, 0.0};
    if (li < lanes) {
      const float* col = partials + cb + 4 * qi;
      constexpr int kInFlight = 8;
      for (int p0 = li; p0 < gx; p0 += kInFlight * lanes) {
        float4 v[kInFlight], w[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int p = p0 + u * lanes;
          const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          v[u] = p < gx ? __ldcg(reinterpret_cast<const float4*>(col + (int64_t)p * 2 * C)) : zero;
          w[u] = p < gx ? __ldcg(reinterpret_cast<const float4*>(col + (int64_t)p * 2 * C + C))
                        : zero;
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          s[0] += (double)v[u].x; s[1] += (double)v[u].y;
          s[2] += (double)v[u].z; s[3] += (double)v[u].w;
          q[0] += (double)w[u].x; q[1] += (double)w[u].y;
          q[2] += (double)w[u].z; q[3] += (double)w[u].w;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red4[0][t][j] = s[j];
      red4[1][t][j] = q[j];
    }
    __syncthreads();
    if (t < nq) {
      for (int l = 1; l < lanes; ++l) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[j] += red4[0][l * nq + t][j];
          q[j] += red4[1][l * nq + t][j];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) fin(cb + 4 * t + j, s[j], q[j]);
    }
    __syncthreads();
  }
}

// N1: partial sums of x and x^2, the last block of a column finalizing it
// (StatsFin) or writing its sums (SumsOut)
template <typename T, int VW, typename Fin>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const T* __restrict__ x, int64_t M, int C, int TW, int RB,
                float* __restrict__ partials, unsigned* __restrict__ tickets, Fin fin) {
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int cv = blockIdx.y * TW + tx;
  const bool active = cv * VW < C;
  const int c0 = cv * VW;
  float a[2][VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) a[0][j] = a[1][j] = 0.0f;
  if (active) {
    SCENERF_ROWS({
      float v[VW];
      load_vec<T, VW>(x + r * C + c0, v);
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        a[0][j] += v[j];
        a[1][j] = fmaf(v[j], v[j], a[1][j]);
      }
    })
  }
  block_partials<VW>(a, tx, ty, TW, RB, active, c0, C, partials);
  if (!last_block(tickets + blockIdx.y, gridDim.x)) return;
  const int col = blockIdx.y * TW * VW;
  finalize_columns(partials, gridDim.x, C, col, min(C, col + TW * VW), fin);
}

struct Affine {
  const float* stats;     // train: read mul/add here; eval: write the fold here (or null)
  const float* weight;    // eval: the fold's inputs
  const float* bias;
  const float* run_mean;
  const float* run_var;
  float eps;
  int train;
};

// N2: y = act(x mul + add (+ r))
template <typename T, int VW, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ y,
                int64_t M, int C, int TW, int RB, Affine af) {
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int cv = blockIdx.y * TW + tx;
  if (ty >= RB || cv * VW >= C) return;
  const int c0 = cv * VW;
  float mul[VW], add[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    if (af.train) {
      mul[j] = af.stats[kMul * C + c0 + j];
      add[j] = af.stats[kAdd * C + c0 + j];
    } else {
      float mean, var, inv;
      fold(af.weight, af.bias, af.run_mean, af.run_var, af.eps, c0 + j, mean, var, inv,
           mul[j], add[j]);
      if (af.stats != nullptr && blockIdx.x == 0 && ty == 0) {
        float* st = const_cast<float*>(af.stats);
        st[kMean * C + c0 + j] = mean;
        st[kVarRaw * C + c0 + j] = var;
        st[kInv * C + c0 + j] = inv;
        st[kMul * C + c0 + j] = mul[j];
        st[kAdd * C + c0 + j] = add[j];
      }
    }
  }
  SCENERF_ROWS({
    float v[VW];
    load_vec<T, VW>(x + r * C + c0, v);
    if (RES) {
      float rv[VW];
      load_vec<T, VW>(res + r * C + c0, rv);
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        v[j] = act_fwd<ACT>(__fadd_rn(pre_act(v[j], mul[j], add[j]), rv[j]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < VW; ++j) v[j] = act_fwd<ACT>(pre_act(v[j], mul[j], add[j]));
    }
    store_vec<T, VW>(y + r * C + c0, v);
  })
}

// g = dy act'(z) from x, dy (and r) in f32, z recomputed (the identity needs
// no z)
template <int VW, int ACT, bool RES>
__device__ __forceinline__ void grad_of(const float (&xv)[VW], const float (&rv)[VW],
                                        const float (&mul)[VW], const float (&add)[VW],
                                        float (&g)[VW]) {
  if (ACT == kIdentity) return;
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    const float z0 = pre_act(xv[j], mul[j], add[j]);
    const float z = RES ? __fadd_rn(z0, rv[j]) : z0;
    g[j] *= act_grad<ACT>(z);
  }
}

// g at element offset `at`, loaded from device memory
template <typename T, int VW, int ACT, bool RES>
__device__ __forceinline__ void grad_at(const T* __restrict__ x, const T* __restrict__ res,
                                        const T* __restrict__ dy, int64_t at,
                                        const float (&mul)[VW], const float (&add)[VW],
                                        float (&xv)[VW], float (&g)[VW]) {
  load_vec<T, VW>(x + at, xv);
  load_vec<T, VW>(dy + at, g);
  float rv[VW];
  if (ACT != kIdentity && RES) load_vec<T, VW>(res + at, rv);
  grad_of<VW, ACT, RES && ACT != kIdentity>(xv, rv, mul, add, g);
}

// N3: partial sums of g and g x, the last block of a column finalizing it
// (GradsFin) or writing its sums (SumsOut); at most 64 registers (4 blocks an
// SM), so kRedBlocks blocks run in one wave
template <typename T, int VW, int ACT, bool RES, bool WIDE, typename Fin>
__global__ void __launch_bounds__(kThreads, kRedBlocks / kSMs)
bn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ res,
                     const T* __restrict__ dy, int64_t M, int C, int TW, int RB,
                     const float* __restrict__ stats, float* __restrict__ partials,
                     unsigned* __restrict__ tickets, Fin fin) {
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int cv = blockIdx.y * TW + tx;
  const bool active = cv * VW < C;
  const int c0 = cv * VW;
  float a[2][VW], mul[VW], add[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    a[0][j] = a[1][j] = 0.0f;
    mul[j] = active ? stats[kMul * C + c0 + j] : 0.0f;
    add[j] = active ? stats[kAdd * C + c0 + j] : 0.0f;
  }
  if (active) {
    SCENERF_ROWS({
      float xv[VW], g[VW];
      grad_at<T, VW, ACT, RES>(x, res, dy, r * C + c0, mul, add, xv, g);
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        a[0][j] += g[j];
        a[1][j] = fmaf(g[j], xv[j], a[1][j]);
      }
    })
  }
  block_partials<VW>(a, tx, ty, TW, RB, active, c0, C, partials);
  if (!last_block(tickets + blockIdx.y, gridDim.x)) return;
  const int col = blockIdx.y * TW * VW;
  if constexpr (WIDE && VW >= 4) {
    finalize_columns4(partials, gridDim.x, C, col, min(C, col + TW * VW), fin);
  } else {
    finalize_columns(partials, gridDim.x, C, col, min(C, col + TW * VW), fin);
  }
}

// N4: dx = g mul + alpha + beta x; d_r = g
template <typename T, int VW, int ACT, bool RES, bool DRES>
__global__ void __launch_bounds__(kThreads)
bn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const T* __restrict__ dy, T* __restrict__ dx, T* __restrict__ dres,
                    int64_t M, int C, int TW, int RB, const float* __restrict__ stats,
                    const float* __restrict__ grads) {
  const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
  const int cv = blockIdx.y * TW + tx;
  if (ty >= RB || cv * VW >= C) return;
  const int c0 = cv * VW;
  float mul[VW], add[VW], alpha[VW], beta[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    mul[j] = stats[kMul * C + c0 + j];
    add[j] = stats[kAdd * C + c0 + j];
    alpha[j] = grads[kAlpha * C + c0 + j];
    beta[j] = grads[kBeta * C + c0 + j];
  }
  SCENERF_ROWS({
    const int64_t at = r * C + c0;
    float xv[VW], g[VW], out[VW];
    grad_at<T, VW, ACT, RES>(x, res, dy, at, mul, add, xv, g);
#pragma unroll
    for (int j = 0; j < VW; ++j) out[j] = fmaf(g[j], mul[j], fmaf(beta[j], xv[j], alpha[j]));
    store_vec<T, VW>(dx + at, out);
    if (DRES) store_vec<T, VW>(dres + at, g);
  })
}

// ---- channel-first inputs: x [B, C, S] contiguous, element (b, c, s) at
// (b C + c) S + s (a [B, H, W, C] tensor whose permute to [B, C, H, W] is
// contiguous, as a convolution's NCHW output gives). One channel per
// blockIdx.y, so the per-channel vectors load once per thread as above; the
// positions of the channel's B planes spread over blockIdx.x and the threads,
// consecutive threads on consecutive addresses. Scalar loads. The reductions
// share one ticket: the grid's last block finalizes every channel.

// the position loop of one thread in channel c's planes, kUnroll at a time
#define SCENERF_PLANES(...)                                                  \
  {                                                                          \
    const int64_t step = (int64_t)gridDim.x * kThreads;                      \
    for (int64_t b = 0; b < B; ++b) {                                        \
      const int64_t base = (b * C + c) * S;                                  \
      for (int64_t s0 = (int64_t)blockIdx.x * kThreads + threadIdx.x; s0 < S; \
           s0 += step * kUnroll) {                                           \
        _Pragma("unroll") for (int u = 0; u < kUnroll; ++u) {                \
          const int64_t pos = s0 + u * step;                                 \
          if (pos < S) {                                                     \
            const int64_t at = base + pos;                                   \
            __VA_ARGS__                                                      \
          }                                                                  \
        }                                                                    \
      }                                                                      \
    }                                                                        \
  }

// N1, channel-first
template <typename T, typename Fin>
__global__ void __launch_bounds__(kThreads)
bn_stats_cf_kernel(const T* __restrict__ x, int64_t B, int C, int64_t S,
                   float* __restrict__ partials, unsigned* __restrict__ tickets, Fin fin) {
  const int c = blockIdx.y;
  float a[2][1] = {{0.0f}, {0.0f}};
  SCENERF_PLANES({
    const float v = to_f32(x[at]);
    a[0][0] += v;
    a[1][0] = fmaf(v, v, a[1][0]);
  })
  block_partials<1>(a, 0, threadIdx.x, 1, kThreads, true, c, C, partials);
  if (!last_block(tickets, gridDim.x * gridDim.y)) return;
  finalize_columns(partials, gridDim.x, C, 0, C, fin);
}

// N2, channel-first
template <typename T, int ACT, bool RES>
__global__ void __launch_bounds__(kThreads)
bn_apply_cf_kernel(const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ y,
                   int64_t B, int C, int64_t S, Affine af) {
  const int c = blockIdx.y;
  float mul, add;
  if (af.train) {
    mul = af.stats[kMul * C + c];
    add = af.stats[kAdd * C + c];
  } else {
    float mean, var, inv;
    fold(af.weight, af.bias, af.run_mean, af.run_var, af.eps, c, mean, var, inv, mul, add);
    if (af.stats != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      float* st = const_cast<float*>(af.stats);
      st[kMean * C + c] = mean;
      st[kVarRaw * C + c] = var;
      st[kInv * C + c] = inv;
      st[kMul * C + c] = mul;
      st[kAdd * C + c] = add;
    }
  }
  SCENERF_PLANES({
    const float z = pre_act(to_f32(x[at]), mul, add);
    y[at] = from_f32<T>(act_fwd<ACT>(RES ? __fadd_rn(z, to_f32(res[at])) : z));
  })
}

// N3, channel-first
template <typename T, int ACT, bool RES, typename Fin>
__global__ void __launch_bounds__(kThreads)
bn_bwd_reduce_cf_kernel(const T* __restrict__ x, const T* __restrict__ res,
                        const T* __restrict__ dy, int64_t B, int C, int64_t S,
                        const float* __restrict__ stats, float* __restrict__ partials,
                        unsigned* __restrict__ tickets, Fin fin) {
  const int c = blockIdx.y;
  const float mul[1] = {stats[kMul * C + c]}, add[1] = {stats[kAdd * C + c]};
  float a[2][1] = {{0.0f}, {0.0f}};
  SCENERF_PLANES({
    float xv[1], g[1];
    grad_at<T, 1, ACT, RES>(x, res, dy, at, mul, add, xv, g);
    a[0][0] += g[0];
    a[1][0] = fmaf(g[0], xv[0], a[1][0]);
  })
  block_partials<1>(a, 0, threadIdx.x, 1, kThreads, true, c, C, partials);
  if (!last_block(tickets, gridDim.x * gridDim.y)) return;
  finalize_columns(partials, gridDim.x, C, 0, C, fin);
}

// N4, channel-first
template <typename T, int ACT, bool RES, bool DRES>
__global__ void __launch_bounds__(kThreads)
bn_bwd_apply_cf_kernel(const T* __restrict__ x, const T* __restrict__ res,
                       const T* __restrict__ dy, T* __restrict__ dx, T* __restrict__ dres,
                       int64_t B, int C, int64_t S, const float* __restrict__ stats,
                       const float* __restrict__ grads) {
  const int c = blockIdx.y;
  const float mul[1] = {stats[kMul * C + c]}, add[1] = {stats[kAdd * C + c]};
  const float alpha = grads[kAlpha * C + c], beta = grads[kBeta * C + c];
  SCENERF_PLANES({
    float xv[1], g[1];
    grad_at<T, 1, ACT, RES>(x, res, dy, at, mul, add, xv, g);
    dx[at] = from_f32<T>(fmaf(g[0], mul[0], fmaf(beta, xv[0], alpha)));
    if (DRES) dres[at] = from_f32<T>(g[0]);
  })
}

#undef SCENERF_PLANES
#undef SCENERF_ROWS

// ---- the cluster path ------------------------------------------------------

// one thread's copy of a pack into shared memory: cp.async for 4, 8 and 16
// bytes (16 bypasses L1), a plain load and store for a 2-byte element
template <int BYTES>
__device__ __forceinline__ void copy_in(void* smem, const void* gmem) {
  if constexpr (BYTES == 16) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
  } else if constexpr (BYTES == 4 || BYTES == 8) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(gmem),
                 "n"(BYTES));
  } else {
    static_assert(BYTES == 2, "a pack is 2, 4, 8 or 16 bytes");
    *static_cast<unsigned short*>(smem) = *static_cast<const unsigned short*>(gmem);
  }
}

__device__ __forceinline__ void copy_in_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a cluster block's dynamic shared memory: `arrays` tiles of rows x SV packs
// (each 16-byte aligned), then f32 [2][CW] sums (read by the cluster's other
// blocks) and [kClusterWarps][2][CW] warp sums, whose head holds the [2][CW]
// coefficients once the block's sums are made, CW = SV * VW channels. ops/norm.py's `plan` computes the same total; the entries refuse
// a plan whose bytes differ.
struct Layout {
  int64_t tile;   // bytes of one array's tile
  int64_t total;  // bytes in all
};

__host__ __device__ __forceinline__ Layout cluster_layout(int64_t rows, int SV, int pack_bytes,
                                                          int arrays, int CW) {
  Layout l;
  l.tile = (rows * SV * pack_bytes + 15) / 16 * 16;
  l.total = arrays * l.tile + (int64_t)(2 + 2 * kClusterWarps) * CW * (int64_t)sizeof(float);
  return l;
}

// sums a[2][VW] over the block: lanes with the same tx (lane % SV) hold the
// same channels, folded by shuffles (xor over the higher lane bits), then the
// warps in order; sums[k * CW + channel]
template <int VW>
__device__ __forceinline__ void block_sums(float (&a)[2][VW], int tx, int SV, int CW,
                                           float* __restrict__ warp_sums,
                                           float* __restrict__ sums) {
  for (int off = kWarpSize / 2; off >= SV; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int j = 0; j < VW; ++j) a[k][j] += __shfl_xor_sync(kFullMask, a[k][j], off);
    }
  }
  const int lane = threadIdx.x % kWarpSize, warp = threadIdx.x / kWarpSize;
  if (lane < SV) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int j = 0; j < VW; ++j) warp_sums[(warp * 2 + k) * CW + tx * VW + j] = a[k][j];
    }
  }
  __syncthreads();
  if (threadIdx.x < CW) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float s = 0.0f;
      for (int w = 0; w < kClusterWarps; ++w) s += warp_sums[(w * 2 + k) * CW + threadIdx.x];
      sums[k * CW + threadIdx.x] = s;
    }
  }
}

// the cluster's sums of channel c (slice channel j), added in rank order in
// f64: the same in every block of the cluster
__device__ __forceinline__ void cluster_sums(cg::cluster_group& cluster, float* sums, int CW,
                                             int j, double& s, double& q) {
  s = 0.0;
  q = 0.0;
  const int n = (int)cluster.num_blocks();
  for (int k = 0; k < n; ++k) {
    const float* o = cluster.map_shared_rank(sums, k);
    s += (double)o[j];
    q += (double)o[CW + j];
  }
}

// the forward's one launch: N1 over the cluster's rows of the slice, the
// finalize, N2 from the tile in shared memory
template <typename T, int VW, int ACT, bool RES>
__global__ void __launch_bounds__(kClusterThreads)
bn_forward_cluster_kernel(const T* __restrict__ x, const T* __restrict__ res,
                          T* __restrict__ y, int64_t M, int C, int SV, int64_t rows,
                          StatsFin fin) {
  extern __shared__ __align__(16) unsigned char smem[];
  using P = Pack<T, VW>;
  cg::cluster_group cluster = cg::this_cluster();
  const int CW = SV * VW, RB = kClusterThreads / SV;
  const int tx = threadIdx.x % SV, ty = threadIdx.x / SV;
  const int c0 = blockIdx.y * CW + tx * VW;
  const bool active = c0 < C;
  const int rank = (int)cluster.block_rank();
  const int64_t r_begin = rank * rows;
  const int n = (int)max((int64_t)0, min(rows, M - r_begin));
  const Layout L = cluster_layout(rows, SV, (int)sizeof(P), RES ? 2 : 1, CW);
  P* xt = reinterpret_cast<P*>(smem);
  P* rt = reinterpret_cast<P*>(smem + L.tile);
  float* sums = reinterpret_cast<float*>(smem + (RES ? 2 : 1) * L.tile);
  float* warp_sums = sums + 2 * CW;
  float* coef = warp_sums;  // written after the cluster's first sync: the warp sums are used
  if (active) {
    for (int i = ty; i < n; i += RB) {
      const int64_t at = (r_begin + i) * C + c0;
      copy_in<(int)sizeof(P)>(xt + i * SV + tx, x + at);
      if (RES) copy_in<(int)sizeof(P)>(rt + i * SV + tx, res + at);
    }
  }
  copy_in_wait();
  float a[2][VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) a[0][j] = a[1][j] = 0.0f;
  if (active) {
#pragma unroll 4
    for (int i = ty; i < n; i += RB) {
      float v[VW];
      unpack(read_pack(xt + i * SV + tx), v);
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        a[0][j] += v[j];
        a[1][j] = fmaf(v[j], v[j], a[1][j]);
      }
    }
  }
  block_sums<VW>(a, tx, SV, CW, warp_sums, sums);
  cluster.sync();
  if (threadIdx.x < CW && blockIdx.y * CW + (int)threadIdx.x < C) {
    double s, q;
    cluster_sums(cluster, sums, CW, threadIdx.x, s, q);
    fin(blockIdx.y * CW + threadIdx.x, s, q, rank == 0, coef[threadIdx.x],
        coef[CW + threadIdx.x]);
  }
  cluster.sync();  // the coefficients are in; no block reads another's sums after this
  if (!active) return;
  float mul[VW], add[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    mul[j] = coef[tx * VW + j];
    add[j] = coef[CW + tx * VW + j];
  }
#pragma unroll 4
  for (int i = ty; i < n; i += RB) {
    float v[VW];
    unpack(read_pack(xt + i * SV + tx), v);
    if (RES) {
      float rv[VW];
      unpack(read_pack(rt + i * SV + tx), rv);
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        v[j] = act_fwd<ACT>(__fadd_rn(pre_act(v[j], mul[j], add[j]), rv[j]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < VW; ++j) v[j] = act_fwd<ACT>(pre_act(v[j], mul[j], add[j]));
    }
    store_vec<T, VW>(y + (r_begin + i) * C + c0, v);
  }
}

// the backward's one launch: N3 over the cluster's rows of the slice (x, dy
// and, where z needs it, r held in shared memory), the finalize, N4 from the
// tiles
template <typename T, int VW, int ACT, bool RES, bool DRES>
__global__ void __launch_bounds__(kClusterThreads)
bn_backward_cluster_kernel(const T* __restrict__ x, const T* __restrict__ res,
                           const T* __restrict__ dy, T* __restrict__ dx, T* __restrict__ dres,
                           int64_t M, int C, int SV, int64_t rows, GradsFin fin) {
  extern __shared__ __align__(16) unsigned char smem[];
  using P = Pack<T, VW>;
  constexpr int kArrays = RES ? 3 : 2;
  cg::cluster_group cluster = cg::this_cluster();
  const int CW = SV * VW, RB = kClusterThreads / SV;
  const int tx = threadIdx.x % SV, ty = threadIdx.x / SV;
  const int c0 = blockIdx.y * CW + tx * VW;
  const bool active = c0 < C;
  const int rank = (int)cluster.block_rank();
  const int64_t r_begin = rank * rows;
  const int n = (int)max((int64_t)0, min(rows, M - r_begin));
  const Layout L = cluster_layout(rows, SV, (int)sizeof(P), kArrays, CW);
  P* xt = reinterpret_cast<P*>(smem);
  P* dyt = reinterpret_cast<P*>(smem + L.tile);
  P* rt = reinterpret_cast<P*>(smem + 2 * L.tile);
  float* sums = reinterpret_cast<float*>(smem + kArrays * L.tile);
  float* warp_sums = sums + 2 * CW;
  float* coef = warp_sums;  // written after the cluster's first sync: the warp sums are used
  if (active) {
    for (int i = ty; i < n; i += RB) {
      const int64_t at = (r_begin + i) * C + c0;
      copy_in<(int)sizeof(P)>(xt + i * SV + tx, x + at);
      copy_in<(int)sizeof(P)>(dyt + i * SV + tx, dy + at);
      if (RES) copy_in<(int)sizeof(P)>(rt + i * SV + tx, res + at);
    }
  }
  float mul[VW], add[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    mul[j] = active ? fin.stats[kMul * C + c0 + j] : 0.0f;
    add[j] = active ? fin.stats[kAdd * C + c0 + j] : 0.0f;
  }
  copy_in_wait();
  float a[2][VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) a[0][j] = a[1][j] = 0.0f;
  if (active) {
#pragma unroll 4
    for (int i = ty; i < n; i += RB) {
      float xv[VW], g[VW], rv[VW];
      unpack(read_pack(xt + i * SV + tx), xv);
      unpack(read_pack(dyt + i * SV + tx), g);
      if (RES) unpack(read_pack(rt + i * SV + tx), rv);
      grad_of<VW, ACT, RES>(xv, rv, mul, add, g);
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        a[0][j] += g[j];
        a[1][j] = fmaf(g[j], xv[j], a[1][j]);
      }
    }
  }
  block_sums<VW>(a, tx, SV, CW, warp_sums, sums);
  cluster.sync();
  if (threadIdx.x < CW && blockIdx.y * CW + (int)threadIdx.x < C) {
    double sg, sgx;
    cluster_sums(cluster, sums, CW, threadIdx.x, sg, sgx);
    fin(blockIdx.y * CW + threadIdx.x, sg, sgx, rank == 0, coef[threadIdx.x],
        coef[CW + threadIdx.x]);
  }
  cluster.sync();
  if (!active) return;
  float alpha[VW], beta[VW];
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    alpha[j] = coef[tx * VW + j];
    beta[j] = coef[CW + tx * VW + j];
  }
#pragma unroll 4
  for (int i = ty; i < n; i += RB) {
    float xv[VW], g[VW], rv[VW], out[VW];
    unpack(read_pack(xt + i * SV + tx), xv);
    unpack(read_pack(dyt + i * SV + tx), g);
    if (RES) unpack(read_pack(rt + i * SV + tx), rv);
    grad_of<VW, ACT, RES>(xv, rv, mul, add, g);
#pragma unroll
    for (int j = 0; j < VW; ++j) out[j] = fmaf(g[j], mul[j], fmaf(beta[j], xv[j], alpha[j]));
    const int64_t at = (r_begin + i) * C + c0;
    store_vec<T, VW>(dx + at, out);
    if (DRES) store_vec<T, VW>(dres + at, g);
  }
}

// ---- launches ----------------------------------------------------------------

bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15u) == 0; }

// the tensor: M rows of C channels; channel-first (plane > 0) as B = M /
// plane items of C planes of S = plane positions
struct Geometry {
  int64_t M;
  int C;
  int64_t B, S;
  bool cf;
};

// a cluster launch's tiling (ops/norm.py `plan`): cluster blocks per slice,
// SV vectors per slice, rows per block, the dynamic shared memory it
// computed; cs == 0 for the streaming path
struct ClusterPlan {
  int cs;
  int SV;
  int64_t rows;
  int64_t smem;
};

// blocks along the positions of a channel-first launch
int cf_splits(const Geometry& g, int max_blocks) {
  const int64_t want = (g.S + (int64_t)kThreads * kUnroll - 1) / ((int64_t)kThreads * kUnroll);
  const int64_t cap = max_blocks / g.C > 0 ? max_blocks / g.C : 1;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

// blocks along the rows of a streaming reduction (its partial rows): at
// most kRedBlocks, and (8 at the least) one per kPartialBytes of a channel's bytes, so
// that the [gx, 2C] f32 partials stay within 1/16 of x's bytes, which also
// bounds the last block's finalize (it reads them all)
int reduce_cap(const Geometry& g, int elem_bytes) {
  const int64_t budget = g.M * elem_bytes / kPartialBytes;
  return (int)(budget < kRedBlocks ? (budget > 8 ? budget : 8) : kRedBlocks);
}

// N3 at most this wide reduces whole rows (N3's "wide" tiling)
bool bwd_wide(const Geometry& g) { return g.C <= kWideRow; }

// a streaming reduction's tiling: 128-byte-aligned columns of kRedColumn
// channels, so that the last block of a column finalizes few channels with
// many lanes each; N3 of a narrow row (it reads two or three arrays) takes
// whole rows, as the elementwise passes, at half the blocks where x is
// under kWideBytes (there the finalize's tail outweighs the extra blocks)
Tile reduce_tile(const Geometry& g, int vw, int elem_bytes, bool backward) {
  if (backward && bwd_wide(g)) {
    const int cap = reduce_cap(g, elem_bytes);
    const bool large = g.M * g.C * elem_bytes >= kWideBytes;
    return make_tile(g.M, g.C, vw, large ? cap : min(cap, kRedBlocks / 2));
  }
  return make_tile(g.M, g.C, vw, reduce_cap(g, elem_bytes), kRedColumn / vw);
}

int reduce_blocks(const Geometry& g, int vw, int elem_bytes) {
  if (g.cf) return cf_splits(g, reduce_cap(g, elem_bytes));
  return max(reduce_tile(g, vw, elem_bytes, false).gx, reduce_tile(g, vw, elem_bytes, true).gx);
}

// floats of the workspace of a streaming reduction: kTickets tickets, then
// the [gx, 2C] partials
int64_t work_floats(const Geometry& g, int vw, int elem_bytes) {
  return kTickets + (int64_t)reduce_blocks(g, vw, elem_bytes) * 2 * g.C;
}

// a refused cluster tiling's error: more blocks than a cluster takes, more
// shared memory than a block may have, a plan that does not match the
// kernel's layout, or no cluster of it fitting on the card
// (cudaOccupancyMaxActiveClusters; cached per kernel, cluster and bytes)
template <typename Kern>
cudaError_t cluster_check(Kern kernel, const ClusterPlan& p, int64_t want_smem, int slices,
                          cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                          cudaStream_t s) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int64_t, int>, int> active;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (p.cs < 1 || p.cs > kMaxCluster || p.SV < 1 || p.SV > kWarpSize || (p.SV & (p.SV - 1)) ||
      p.rows < 1 || slices > 65535 || p.smem != want_smem) {
    return cudaErrorInvalidValue;
  }
  if (p.smem > optin) return cudaErrorInvalidConfiguration;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(p.cs, slices, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple((const void*)kernel, p.cs, p.smem, dev);
  auto it = active.find(key);
  if (it == active.end()) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (e != cudaSuccess) return e;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (e != cudaSuccess) return e;
    it = active.emplace(key, n).first;
  }
  return it->second > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

// N1 with its finalize, or its sums (into work: tickets, then partials)
template <typename T, int VW, typename Fin>
cudaError_t launch_stats(const T* x, const Geometry& g, const Fin& fin, float* work,
                         cudaStream_t s) {
  unsigned* tickets = reinterpret_cast<unsigned*>(work);
  float* partials = work + kTickets;
  if (g.cf) {
    bn_stats_cf_kernel<T, Fin>
        <<<dim3(cf_splits(g, reduce_cap(g, sizeof(T))), g.C), kThreads, 0, s>>>(
            x, g.B, g.C, g.S, partials, tickets, fin);
  } else {
    const Tile t = reduce_tile(g, VW, sizeof(T), false);
    if (t.gy > kTickets) return cudaErrorInvalidValue;
    bn_stats_kernel<T, VW, Fin><<<dim3(t.gx, t.gy), t.TW * t.RB, 0, s>>>(
        x, g.M, g.C, t.TW, t.RB, partials, tickets, fin);
  }
  return cudaGetLastError();
}

// N3 with its finalize, or its sums (into work: tickets, then partials)
template <typename T, int VW, int ACT, bool RES, typename Fin>
cudaError_t launch_bwd_reduce(const T* x, const T* res, const T* dy, const Geometry& g,
                              const float* stats, const Fin& fin, float* work, cudaStream_t s) {
  unsigned* tickets = reinterpret_cast<unsigned*>(work);
  float* partials = work + kTickets;
  if (g.cf) {
    bn_bwd_reduce_cf_kernel<T, ACT, RES, Fin>
        <<<dim3(cf_splits(g, reduce_cap(g, sizeof(T))), g.C), kThreads, 0, s>>>(
            x, res, dy, g.B, g.C, g.S, stats, partials, tickets, fin);
  } else {
    const Tile t = reduce_tile(g, VW, sizeof(T), true);
    if (t.gy > kTickets) return cudaErrorInvalidValue;
    const dim3 grid(t.gx, t.gy), block(t.TW * t.RB);
    if (bwd_wide(g)) {
      bn_bwd_reduce_kernel<T, VW, ACT, RES, true, Fin><<<grid, block, 0, s>>>(
          x, res, dy, g.M, g.C, t.TW, t.RB, stats, partials, tickets, fin);
    } else {
      bn_bwd_reduce_kernel<T, VW, ACT, RES, false, Fin><<<grid, block, 0, s>>>(
          x, res, dy, g.M, g.C, t.TW, t.RB, stats, partials, tickets, fin);
    }
  }
  return cudaGetLastError();
}

template <typename T, int VW, int ACT, bool RES>
void launch_apply(const T* x, const T* res, T* y, const Geometry& g, const Affine& af,
                  cudaStream_t s) {
  if (g.cf) {
    bn_apply_cf_kernel<T, ACT, RES><<<dim3(cf_splits(g, kApplyBlocks), g.C), kThreads, 0, s>>>(
        x, res, y, g.B, g.C, g.S, af);
  } else {
    const Tile t = make_tile(g.M, g.C, VW, kApplyBlocks);
    bn_apply_kernel<T, VW, ACT, RES><<<dim3(t.gx, t.gy), t.TW * t.RB, 0, s>>>(
        x, res, y, g.M, g.C, t.TW, t.RB, af);
  }
}

template <typename T, int VW, int ACT, bool RES>
cudaError_t launch_forward_cluster(const T* x, const T* res, T* y, const Geometry& g,
                                   const StatsFin& fin, const ClusterPlan& p, cudaStream_t s) {
  auto kernel = bn_forward_cluster_kernel<T, VW, ACT, RES>;
  const int CW = p.SV * VW;
  const int slices = (g.C + CW - 1) / CW;
  const Layout L = cluster_layout(p.rows, p.SV, (int)sizeof(Pack<T, VW>), RES ? 2 : 1, CW);
  if ((int64_t)p.cs * p.rows < g.M) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t e = cluster_check(kernel, p, L.total, slices, cfg, attr, s);
  if (e != cudaSuccess) return e;
  return cudaLaunchKernelEx(&cfg, kernel, x, res, y, g.M, g.C, p.SV, p.rows, fin);
}

template <typename T, int VW>
cudaError_t forward(const T* x, const T* res, T* y, const Geometry& g, const float* weight,
                    const float* bias, float* run_mean, float* run_var, float* stats,
                    float* work, float momentum, float one_minus_momentum, float eps, int act,
                    int train, int stages, const ClusterPlan& p, cudaStream_t s) {
  const StatsFin fin{g.M, g.C, weight, bias, run_mean, run_var, momentum, one_minus_momentum,
                     eps, stats};
  const bool r = res != nullptr;
  if (p.cs > 0) {
    if (!train || stages != 3 || g.cf) return cudaErrorInvalidValue;
    switch (act) {
#define SCENERF_BN_FWD_CLUSTER(A)                                                          \
  case A:                                                                                  \
    return r ? launch_forward_cluster<T, VW, A, true>(x, res, y, g, fin, p, s)             \
             : launch_forward_cluster<T, VW, A, false>(x, res, y, g, fin, p, s);
      SCENERF_BN_FWD_CLUSTER(kIdentity) SCENERF_BN_FWD_CLUSTER(kSilu)
      SCENERF_BN_FWD_CLUSTER(kLeaky)
#undef SCENERF_BN_FWD_CLUSTER
    }
    return cudaErrorInvalidValue;
  }
  if (train && (stages & 1)) {
    const cudaError_t e = launch_stats<T, VW>(x, g, fin, work, s);
    if (e != cudaSuccess) return e;
  }
  if (stages & 2) {
    const Affine af{stats, weight, bias, run_mean, run_var, eps, train};
    switch (act) {
#define SCENERF_BN_APPLY(A)                                            \
  case A:                                                              \
    if (r) launch_apply<T, VW, A, true>(x, res, y, g, af, s);          \
    else launch_apply<T, VW, A, false>(x, res, y, g, af, s);           \
    break;
      SCENERF_BN_APPLY(kIdentity) SCENERF_BN_APPLY(kSilu) SCENERF_BN_APPLY(kLeaky)
#undef SCENERF_BN_APPLY
    }
  }
  return cudaGetLastError();
}

template <typename T, int VW, int ACT, bool RES>
cudaError_t backward_act(const T* x, const T* res, const T* dy, T* dx, T* dres,
                         const Geometry& g, const GradsFin& fin, float* work, int stages,
                         const ClusterPlan& p, cudaStream_t s) {
  if (p.cs > 0) {
    if (stages != 3 || g.cf) return cudaErrorInvalidValue;
    const int CW = p.SV * VW;
    const int slices = (g.C + CW - 1) / CW;
    const Layout L =
        cluster_layout(p.rows, p.SV, (int)sizeof(Pack<T, VW>), RES ? 3 : 2, CW);
    if ((int64_t)p.cs * p.rows < g.M) return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    if (dres != nullptr) {
      auto kernel = bn_backward_cluster_kernel<T, VW, ACT, RES, true>;
      const cudaError_t e = cluster_check(kernel, p, L.total, slices, cfg, attr, s);
      if (e != cudaSuccess) return e;
      return cudaLaunchKernelEx(&cfg, kernel, x, res, dy, dx, dres, g.M, g.C, p.SV, p.rows,
                                fin);
    }
    auto kernel = bn_backward_cluster_kernel<T, VW, ACT, RES, false>;
    const cudaError_t e = cluster_check(kernel, p, L.total, slices, cfg, attr, s);
    if (e != cudaSuccess) return e;
    return cudaLaunchKernelEx(&cfg, kernel, x, res, dy, dx, dres, g.M, g.C, p.SV, p.rows, fin);
  }
  if (stages & 1) {
    const cudaError_t e =
        launch_bwd_reduce<T, VW, ACT, RES>(x, res, dy, g, fin.stats, fin, work, s);
    if (e != cudaSuccess) return e;
  }
  if (stages & 2) {
    const float* stats = fin.stats;
    const float* grads = fin.grads;
    if (g.cf) {
      const dim3 grid(cf_splits(g, kApplyBlocks), g.C);
      if (dres != nullptr) {
        bn_bwd_apply_cf_kernel<T, ACT, RES, true><<<grid, kThreads, 0, s>>>(
            x, res, dy, dx, dres, g.B, g.C, g.S, stats, grads);
      } else {
        bn_bwd_apply_cf_kernel<T, ACT, RES, false><<<grid, kThreads, 0, s>>>(
            x, res, dy, dx, dres, g.B, g.C, g.S, stats, grads);
      }
    } else {
      const Tile t = make_tile(g.M, g.C, VW, kApplyBlocks);
      const dim3 grid(t.gx, t.gy), block(t.TW * t.RB);
      if (dres != nullptr) {
        bn_bwd_apply_kernel<T, VW, ACT, RES, true><<<grid, block, 0, s>>>(
            x, res, dy, dx, dres, g.M, g.C, t.TW, t.RB, stats, grads);
      } else {
        bn_bwd_apply_kernel<T, VW, ACT, RES, false><<<grid, block, 0, s>>>(
            x, res, dy, dx, dres, g.M, g.C, t.TW, t.RB, stats, grads);
      }
    }
  }
  return cudaGetLastError();
}

template <typename T, int VW>
cudaError_t backward(const T* x, const T* res, const T* dy, T* dx, T* dres, const Geometry& g,
                     const float* weight, const float* stats, float* grads, float* work,
                     float eps, int act, int train, int stages, const ClusterPlan& p,
                     cudaStream_t s) {
  const GradsFin fin{g.M, g.C, weight, stats, eps, train, grads};
  const bool r = res != nullptr;
#define SCENERF_BN_BWD(A, R) \
  return backward_act<T, VW, A, R>(x, res, dy, dx, dres, g, fin, work, stages, p, s)
  switch (act) {
    case kIdentity: SCENERF_BN_BWD(kIdentity, false);  // z is not needed: r is not read
    case kSilu: if (r) SCENERF_BN_BWD(kSilu, true); SCENERF_BN_BWD(kSilu, false);
    default: if (r) SCENERF_BN_BWD(kLeaky, true); SCENERF_BN_BWD(kLeaky, false);
  }
#undef SCENERF_BN_BWD
}

bool valid(int64_t M, int C, int64_t plane, int act) {
  return M >= 0 && C >= 1 && C <= kMaxChannels && plane >= 0 &&
         (plane == 0 || M % plane == 0) && act >= kIdentity && act <= kLeaky;
}

Geometry geometry(int64_t M, int C, int64_t plane) {
  return Geometry{M, C, plane > 0 ? M / plane : 0, plane, plane > 0};
}

// the entries' bodies for element type T: one 16-byte vector per load where
// the channels and every pointer allow it, else one channel
template <typename T>
int forward_entry(const T* x, const T* res, T* y, long long M, int C, long long plane,
                  const float* weight, const float* bias, float* run_mean, float* run_var,
                  float* stats, float* work, long long work_cap, float momentum,
                  float one_minus_momentum, float eps, int act, int train, int stages,
                  const ClusterPlan& p, void* stream) {
  if (!valid(M, C, plane, act) || (train && stats == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0) return (int)cudaSuccess;
  const Geometry g = geometry(M, C, plane);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kW = kVecWidth<T>;
  const bool vec = !g.cf && C % kW == 0 && aligned16(x) && aligned16(res) && aligned16(y);
  const bool reduces = p.cs == 0 && train && (stages & 1);
  if (reduces && work_cap < work_floats(g, vec ? kW : 1, sizeof(T))) return (int)cudaErrorInvalidValue;
  if (vec) {
    return (int)forward<T, kW>(x, res, y, g, weight, bias, run_mean, run_var, stats, work,
                               momentum, one_minus_momentum, eps, act, train, stages, p, s);
  }
  return (int)forward<T, 1>(x, res, y, g, weight, bias, run_mean, run_var, stats, work,
                            momentum, one_minus_momentum, eps, act, train, stages, p, s);
}

template <typename T>
int backward_entry(const T* x, const T* res, const T* dy, T* dx, T* dres, long long M, int C,
                   long long plane, const float* weight, const float* stats, float* grads,
                   float* work, long long work_cap, float eps, int act, int train, int stages,
                   const ClusterPlan& p, void* stream) {
  if (!valid(M, C, plane, act)) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const Geometry g = geometry(M, C, plane);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kW = kVecWidth<T>;
  const bool vec = !g.cf && C % kW == 0 && aligned16(x) && aligned16(res) && aligned16(dy) &&
                   aligned16(dx) && aligned16(dres);
  if (p.cs == 0 && (stages & 1) && work_cap < work_floats(g, vec ? kW : 1, sizeof(T))) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec) {
    return (int)backward<T, kW>(x, res, dy, dx, dres, g, weight, stats, grads, work, eps, act,
                                train, stages, p, s);
  }
  return (int)backward<T, 1>(x, res, dy, dx, dres, g, weight, stats, grads, work, eps, act,
                             train, stages, p, s);
}

// the synced path's N1: this rank's sums [2, C] (f64) of x and x^2
template <typename T>
int sums_entry(const T* x, long long M, int C, long long plane, double* sums, float* work,
               long long work_cap, void* stream) {
  if (!valid(M, C, plane, 0) || sums == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0) return (int)cudaMemsetAsync(sums, 0, 2 * C * sizeof(double), s);
  const Geometry g = geometry(M, C, plane);
  constexpr int kW = kVecWidth<T>;
  const bool vec = !g.cf && C % kW == 0 && aligned16(x);
  if (work_cap < work_floats(g, vec ? kW : 1, sizeof(T))) return (int)cudaErrorInvalidValue;
  const SumsOut out{C, sums};
  if (vec) return (int)launch_stats<T, kW>(x, g, out, work, s);
  return (int)launch_stats<T, 1>(x, g, out, work, s);
}

// the synced path's N3: this rank's sums [2, C] (f64) of g and g x
template <typename T, int VW>
cudaError_t bwd_sums(const T* x, const T* res, const T* dy, const Geometry& g,
                     const float* stats, const SumsOut& out, float* work, int act,
                     cudaStream_t s) {
  const bool r = res != nullptr;
#define SCENERF_BN_SUMS(A, R) \
  return launch_bwd_reduce<T, VW, A, R>(x, res, dy, g, stats, out, work, s)
  switch (act) {
    case kIdentity: SCENERF_BN_SUMS(kIdentity, false);
    case kSilu: if (r) SCENERF_BN_SUMS(kSilu, true); SCENERF_BN_SUMS(kSilu, false);
    default: if (r) SCENERF_BN_SUMS(kLeaky, true); SCENERF_BN_SUMS(kLeaky, false);
  }
#undef SCENERF_BN_SUMS
}

template <typename T>
int bwd_sums_entry(const T* x, const T* res, const T* dy, long long M, int C, long long plane,
                   const float* stats, double* sums, float* work, long long work_cap, int act,
                   void* stream) {
  if (!valid(M, C, plane, act) || sums == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0) return (int)cudaMemsetAsync(sums, 0, 2 * C * sizeof(double), s);
  const Geometry g = geometry(M, C, plane);
  constexpr int kW = kVecWidth<T>;
  const bool vec = !g.cf && C % kW == 0 && aligned16(x) && aligned16(res) && aligned16(dy);
  if (work_cap < work_floats(g, vec ? kW : 1, sizeof(T))) return (int)cudaErrorInvalidValue;
  const SumsOut out{C, sums};
  if (vec) return (int)bwd_sums<T, kW>(x, res, dy, g, stats, out, work, act, s);
  return (int)bwd_sums<T, 1>(x, res, dy, g, stats, out, work, act, s);
}

}  // namespace
}  // namespace scenerf

// floats of the workspace a streaming reduction of this tensor needs (a
// multiple-use buffer: the caller zeroes it once, when it allocates it; the
// tickets at its head come back to 0 at the end of every launch). vector: 1
// where the launch will take 16-byte vectors (C a multiple of 16 / elem_bytes
// and every pointer 16-byte aligned), else 0. -1 for an invalid shape.
SCENERF_API long long scenerf_bn_work_floats(long long M, int C, long long plane,
                                             int elem_bytes, int vector) {
  if (!scenerf::valid(M, C, plane, 0) || (elem_bytes != 2 && elem_bytes != 4)) return -1;
  const scenerf::Geometry g = scenerf::geometry(M, C, plane);
  return (long long)scenerf::work_floats(g, vector && !g.cf ? 16 / elem_bytes : 1, elem_bytes);
}

// x, res (or null), y: [M, C] of one layout, f32 (the _f32 entry) or bf16
// (the _bf16 entry): channel-last contiguous (plane 0), or channel-first,
// [M / plane, C, plane] contiguous (plane > 0). weight, bias, run_mean,
// run_var: [C] f32. stats: [5, C] f32 (mean, mean2 - mean^2, rsqrt, mul, add):
// written by N1 in train mode, read by N2; in eval mode N2 writes the fold
// there when stats is not null. work: the streaming reduction's scratch, at
// least scenerf_bn_work_floats floats, zeroed once by its owner. act: 0
// identity, 1 SiLU, 2 leaky ReLU (slope 0.01). train: 1 batch statistics (N1
// with its finalize, which also updates run_mean/run_var in place, then N2),
// 0 running statistics (N2 alone). stages: bit 0 N1 (train only), bit 1 N2
// (3 for the whole forward). cluster, sv, rows, smem: ops/norm.py's plan of
// the cluster path (one launch, train, stages 3, channel-last; cluster 0: the
// streaming path); a plan the kernel's layout or the card refuses returns an
// error and launches nothing.
SCENERF_API int scenerf_bn_forward_f32(const float* x, const float* res, float* y,
                                       long long M, int C, long long plane,
                                       const float* weight, const float* bias,
                                       float* run_mean, float* run_var, float* stats,
                                       float* work, long long work_cap, float momentum,
                                       float one_minus_momentum, float eps, int act, int train,
                                       int stages, int cluster, int sv, long long rows,
                                       long long smem, void* stream) {
  return scenerf::forward_entry<float>(x, res, y, M, C, plane, weight, bias, run_mean, run_var,
                                       stats, work, work_cap, momentum, one_minus_momentum, eps,
                                       act, train, stages, {cluster, sv, rows, smem}, stream);
}

SCENERF_API int scenerf_bn_forward_bf16(const __nv_bfloat16* x, const __nv_bfloat16* res,
                                        __nv_bfloat16* y, long long M, int C, long long plane,
                                        const float* weight, const float* bias,
                                        float* run_mean, float* run_var, float* stats,
                                        float* work, long long work_cap, float momentum,
                                        float one_minus_momentum, float eps, int act, int train,
                                        int stages, int cluster, int sv, long long rows,
                                        long long smem, void* stream) {
  return scenerf::forward_entry<__nv_bfloat16>(x, res, y, M, C, plane, weight, bias, run_mean,
                                               run_var, stats, work, work_cap, momentum,
                                               one_minus_momentum, eps, act, train, stages,
                                               {cluster, sv, rows, smem}, stream);
}

// x, res (or null), dy, dx, dres (or null: no residual gradient written):
// [M, C] of the layout `plane` gives (as above), all f32 (_f32) or all bf16
// (_bf16); weight [C] f32; stats: the forward's [5, C] f32; grads: [4, C] f32
// out (dweight, dbias, then dx's alpha and beta). res is read only where the
// activation needs z (with the identity, d_r = dy: the caller passes res and
// dres null). stages: bit 0 N3 and its finalize, bit 1 N4. cluster, sv,
// rows, smem: the plan of the cluster path, as in the forward (stages 3).
SCENERF_API int scenerf_bn_backward_f32(const float* x, const float* res, const float* dy,
                                        float* dx, float* dres, long long M, int C,
                                        long long plane, const float* weight,
                                        const float* stats, float* grads, float* work,
                                        long long work_cap, float eps, int act, int train,
                                        int stages, int cluster, int sv, long long rows,
                                        long long smem, void* stream) {
  return scenerf::backward_entry<float>(x, res, dy, dx, dres, M, C, plane, weight, stats, grads,
                                        work, work_cap, eps, act, train, stages,
                                        {cluster, sv, rows, smem}, stream);
}

SCENERF_API int scenerf_bn_backward_bf16(const __nv_bfloat16* x, const __nv_bfloat16* res,
                                         const __nv_bfloat16* dy, __nv_bfloat16* dx,
                                         __nv_bfloat16* dres, long long M, int C,
                                         long long plane, const float* weight,
                                         const float* stats, float* grads, float* work,
                                         long long work_cap, float eps, int act, int train,
                                         int stages, int cluster, int sv, long long rows,
                                         long long smem, void* stream) {
  return scenerf::backward_entry<__nv_bfloat16>(x, res, dy, dx, dres, M, C, plane, weight,
                                                stats, grads, work, work_cap, eps, act, train,
                                                stages, {cluster, sv, rows, smem}, stream);
}

// The synced path of a training site (ops/norm.py `batch_norm_act_synced`):
// each direction split at its reduction, with an all-reduce of the sums over
// the ranks between the two halves.
//
// x: [M, C] of the layout `plane` gives, f32 (_f32) or bf16 (_bf16). sums:
// [2, C] f64 out, this rank's sum x and sum x^2 (N1 without its finalize).
// work: as the forward's.
SCENERF_API int scenerf_bn_sums_f32(const float* x, long long M, int C, long long plane,
                                    double* sums, float* work, long long work_cap,
                                    void* stream) {
  return scenerf::sums_entry<float>(x, M, C, plane, sums, work, work_cap, stream);
}

SCENERF_API int scenerf_bn_sums_bf16(const __nv_bfloat16* x, long long M, int C,
                                     long long plane, double* sums, float* work,
                                     long long work_cap, void* stream) {
  return scenerf::sums_entry<__nv_bfloat16>(x, M, C, plane, sums, work, work_cap, stream);
}

// x, res (or null), dy: as the backward's; stats: the [5, C] statistics;
// sums: [2, C] f64 out, this rank's sum g and sum g x (N3 without its
// finalize).
SCENERF_API int scenerf_bn_bwd_sums_f32(const float* x, const float* res, const float* dy,
                                        long long M, int C, long long plane,
                                        const float* stats, double* sums, float* work,
                                        long long work_cap, int act, void* stream) {
  return scenerf::bwd_sums_entry<float>(x, res, dy, M, C, plane, stats, sums, work, work_cap,
                                        act, stream);
}

SCENERF_API int scenerf_bn_bwd_sums_bf16(const __nv_bfloat16* x, const __nv_bfloat16* res,
                                         const __nv_bfloat16* dy, long long M, int C,
                                         long long plane, const float* stats, double* sums,
                                         float* work, long long work_cap, int act,
                                         void* stream) {
  return scenerf::bwd_sums_entry<__nv_bfloat16>(x, res, dy, M, C, plane, stats, sums, work,
                                                work_cap, act, stream);
}

// The forward's finalize from the world's sums [2, C] (f64) over M rows (every
// rank's): stats [5, C] out and the running statistics moved in place, as
// N1's finalize computes them.
SCENERF_API int scenerf_bn_stats_finalize(const double* sums, long long M, int C,
                                          const float* weight, const float* bias,
                                          float* run_mean, float* run_var, float* stats,
                                          float momentum, float one_minus_momentum, float eps,
                                          void* stream) {
  if (M < 1 || C < 1 || C > scenerf::kMaxChannels) return (int)cudaErrorInvalidValue;
  const scenerf::StatsFin fin{M, C, weight, bias, run_mean, run_var, momentum,
                              one_minus_momentum, eps, stats};
  scenerf::bn_stats_finalize_kernel<<<(C + scenerf::kThreads - 1) / scenerf::kThreads,
                                      scenerf::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sums, fin);
  return (int)cudaGetLastError();
}

// The backward's finalize: grads [4, C] out, dweight and dbias from this
// rank's sums `local` [2, C], alpha and beta from the world's `world` [2, C]
// over the world's M rows.
SCENERF_API int scenerf_bn_grads_finalize(const double* local, const double* world,
                                          long long M, int C, const float* weight,
                                          const float* stats, float* grads, float eps,
                                          int train, void* stream) {
  if (M < 1 || C < 1 || C > scenerf::kMaxChannels) return (int)cudaErrorInvalidValue;
  const scenerf::GradsFin fin{M, C, weight, stats, eps, train, grads};
  scenerf::bn_grads_finalize_kernel<<<(C + scenerf::kThreads - 1) / scenerf::kThreads,
                                      scenerf::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      local, world, fin);
  return (int)cudaGetLastError();
}
