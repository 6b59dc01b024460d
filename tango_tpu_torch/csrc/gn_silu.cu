// GroupNorm(+SiLU) for channels-first (NCHW) activations, f32 statistics.
//
// Replaces tango_tpu/ops/gn_silu_pallas.py: _gn_kernel (single pass),
// _gn_stats_kernel + _gn_apply_kernel (two stage) and _gn_bwd_kernel (the
// backward). The port keeps activations
// NCHW for cuDNN's convolutions, so one (batch, group) is one contiguous run of
// (C/G) * HW elements; the Pallas kernels worked on channels-last blocks of a
// whole sample and reduced channels to groups with a 0/1 matmul, which a
// contiguous group does not need.
//
// What bounds it on the H100: bytes. GroupNorm does ~8 flops per element, far
// below the ~295 flops per byte the card needs to be compute bound, so the
// least time is one read of x and one write of y at 3.35 TB/s.
//
// gn_fwd: one block per (batch, group) sums x and x^2 in f32 (per-thread
// partials, warp shuffles, then shared memory), then applies the per-channel
// affine y = x*a + b (+SiLU) in the same launch. The second read of the group
// hits L2 (a group is at most a few hundred KB). The Pallas kernel had one
// program per sample: on 132 SMs that would be 2 blocks, so the grid here goes
// over groups (B*G blocks).
//
// gn_stats / gn_apply: the two-stage form for large maps. gn_stats writes
// per-(batch, group, chunk) partial sums; the caller combines them into
// per-channel a, b (tiny torch ops, as the combine was XLA in JAX); gn_apply
// streams y = x*a + b (+SiLU) over a (B*C, blocks a row) grid.
//
// Limits: every element offset is 64-bit, and every grid puts its large
// extent (B*G, B*G*chunks, B*C) on grid.x, so a tensor may hold 2^31 elements
// or more; only B, C, HW and those block counts are 32-bit (below 2^31).
//
// gn_bwd: one block per (batch, group) again, streaming the group from device
// memory (the Pallas kernel held a whole sample in VMEM, hence its 8 MB
// limit; this one has none, so it also serves the backward of the two-stage
// sites). Three passes over the group, the later two mostly from L2:
//   1. sum x, x^2 -> mean, inv (the forward's statistics, recomputed);
//   2. per channel: dbeta_c = sum dpre, dgamma_c = sum dpre * xhat, where
//      dpre = g * silu'(y) on the SiLU route (y = xhat*gamma + beta) and g
//      otherwise. The work is cut into (channel, slice) items, one warp per
//      item, at least as many items as warps: at 64 or 256 tokens a channel
//      is one warp's work (a block-wide loop channel by channel would idle
//      most of the block, the forward's lesson), at 4096 tokens a channel is
//      split across warps. Warps add their item into shared per-channel sums;
//   3. dx = inv * (gamma_c*dpre - mean_g(gamma*dpre) - xhat *
//      mean_g(gamma*dpre*xhat)), the two group means taken from the
//      per-channel sums of pass 2.
// dgamma, dbeta come out per sample, (B, 2, C) f32; the caller sums over B.
// Bound: bytes, one read of x and g and one write of dx.
//
// Statistics follow the Pallas kernels: var = E[x^2] - mean^2, inv =
// 1/sqrt(var + eps).

#include "common.cuh"

namespace tt {
namespace {

constexpr int kFwdThreads = 512;
constexpr int kStatsThreads = 256;
constexpr int kApplyThreads = 256;
constexpr int kBwdThreads = 512;

// Sums a and b over the block; every thread gets the totals.
template <int NT>
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[32], sb[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < NT / 32 ? sa[lane] : 0.0f;
    b = lane < NT / 32 ? sb[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
      sa[0] = a;
      sb[0] = b;
    }
  }
  __syncthreads();
  a = sa[0];
  b = sb[0];
}

// Partial sum and sum of squares of n contiguous elements, strided over the
// block's threads. VEC: n and p are 16-byte aligned in packets.
template <typename T, bool VEC>
__device__ __forceinline__ void partial_sums(const T* p, int64_t n, float& s, float& ss) {
  if (VEC) {
    constexpr int N = Pack<T>::N;
    float v[N];
    for (int64_t i = (int64_t)threadIdx.x * N; i < n; i += (int64_t)blockDim.x * N) {
      load_pack(p + i, v);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        s += v[j];
        ss += v[j] * v[j];
      }
    }
  } else {
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
      const float v = to_f32(p[i]);
      s += v;
      ss += v * v;
    }
  }
}

// y[i] = act(x[i]*a + b) over n contiguous elements, strided from `start`.
template <typename T, bool VEC>
__device__ __forceinline__ void affine_row(const T* x, T* y, int64_t n, float a, float b,
                                           int act, int64_t start, int64_t step) {
  if (VEC) {
    constexpr int N = Pack<T>::N;
    float v[N];
    for (int64_t i = start * N; i < n; i += step * N) {
      load_pack(x + i, v);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        v[j] = v[j] * a + b;
        if (act) v[j] = silu(v[j]);
      }
      store_pack(y + i, v);
    }
  } else {
    for (int64_t i = start; i < n; i += step) {
      float v = to_f32(x[i]) * a + b;
      if (act) v = silu(v);
      y[i] = from_f32<T>(v);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kFwdThreads)
gn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y, int C, int HW, int G,
              float eps, int act) {
  const int b = blockIdx.x / G, g = blockIdx.x % G;
  const int cg = C / G;
  const int64_t n = (int64_t)cg * HW;
  const int64_t base = ((int64_t)b * C + (int64_t)g * cg) * HW;
  float s = 0.0f, ss = 0.0f;
  partial_sums<T, VEC>(x + base, n, s, ss);
  block_sum2<kFwdThreads>(s, ss);
  const float nf = (float)n;
  const float mean = s / nf;
  const float var = ss / nf - mean * mean;
  const float inv = 1.0f / sqrtf(var + eps);
  // the whole group at once, not channel by channel: a channel row of a
  // low-resolution map (HW = 64) would keep most of the block idle. A packet
  // never straddles two channels (HW is a whole number of packets).
  const T* xg = x + base;
  T* yg = y + base;
  constexpr int N = VEC ? Pack<T>::N : 1;
  for (int64_t i = (int64_t)threadIdx.x * N; i < n; i += (int64_t)blockDim.x * N) {
    const int ch = g * cg + (int)(i / HW);
    const float a = inv * gamma[ch];
    const float bb = beta[ch] - mean * a;
    affine_row<T, VEC>(xg + i, yg + i, N, a, bb, act, 0, 1);
  }
}

// grid (B*G*chunks): block bg*chunks + k sums chunk k of group bg into
// parts[(bg*chunks + k)*2 + {0: sum, 1: sum of squares}]. One flat grid.x
// (up to 2^31 - 1 blocks): grid.y would cap B*G at 65535.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kStatsThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ parts, int C, int HW, int G,
                int chunks) {
  const int64_t bg = blockIdx.x / chunks;
  const int k = blockIdx.x % chunks;
  const int64_t b = bg / G;
  const int g = bg % G;
  const int cg = C / G;
  const int64_t len = (int64_t)cg * HW / chunks;
  const int64_t base = (b * C + (int64_t)g * cg) * HW + (int64_t)k * len;
  float s = 0.0f, ss = 0.0f;
  partial_sums<T, VEC>(x + base, len, s, ss);
  block_sum2<kStatsThreads>(s, ss);
  if (threadIdx.x == 0) {
    parts[(int64_t)blockIdx.x * 2 + 0] = s;
    parts[(int64_t)blockIdx.x * 2 + 1] = ss;
  }
}

// grid (B*C, x-blocks): row bc of HW elements, y = act(x*a[bc] + b[bc]). The
// rows go on grid.x (up to 2^31 - 1), the few blocks a row on grid.y.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ bcoef, T* __restrict__ y, int HW, int act) {
  const int64_t row = blockIdx.x;
  const int64_t off = row * HW;
  affine_row<T, VEC>(x + off, y + off, HW, a[row], bcoef[row], act,
                     (int64_t)blockIdx.y * blockDim.x + threadIdx.x,
                     (int64_t)gridDim.y * blockDim.x);
}

// d(act(y))/dy * g with y = xhat*gamma + beta: g * silu'(y) on the SiLU route.
__device__ __forceinline__ float gn_dpre(float g, float xh, float gam, float bet, int act) {
  if (!act) return g;
  const float y = xh * gam + bet;
  const float sg = 1.0f / (1.0f + expf(-y));
  return g * (sg * (1.0f + y * (1.0f - sg)));
}

// grid (B*G): block bg writes dx for its group and dparam[b][0|1][channels of
// the group] = dgamma, dbeta of sample b. Dynamic shared memory: 2 * C/G f32.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kBwdThreads)
gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ dx, float* __restrict__ dparam,
              int C, int HW, int G, float eps, int act) {
  extern __shared__ float csum[];  // [0, cg): dgamma, [cg, 2cg): dbeta
  const int b = blockIdx.x / G, gi = blockIdx.x % G;
  const int cg = C / G;
  const int64_t n = (int64_t)cg * HW;
  const int64_t base = ((int64_t)b * C + (int64_t)gi * cg) * HW;
  float* sdg = csum;
  float* sdb = csum + cg;
  for (int i = threadIdx.x; i < 2 * cg; i += kBwdThreads) csum[i] = 0.0f;

  // 1. statistics (block_sum2 also orders the zeroing above before pass 2)
  float s = 0.0f, ss = 0.0f;
  partial_sums<T, VEC>(x + base, n, s, ss);
  block_sum2<kBwdThreads>(s, ss);
  const float nf = (float)n;
  const float mean = s / nf;
  const float inv = 1.0f / sqrtf(ss / nf - mean * mean + eps);

  // 2. per-channel sums over (channel, slice) items, one warp each
  constexpr int N = VEC ? Pack<T>::N : 1;
  constexpr int kWarps = kBwdThreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int slices = (kWarps + cg - 1) / cg;
  const int max_slices = HW / (32 * N) > 1 ? HW / (32 * N) : 1;  // >= one packet a lane
  if (slices > max_slices) slices = max_slices;
  const int len = ((HW + slices - 1) / slices + N - 1) / N * N;
  for (int item = warp; item < cg * slices; item += kWarps) {
    const int c = item / slices;
    const int start = (item % slices) * len;
    const int end = start + len < HW ? start + len : HW;
    const int ch = gi * cg + c;
    const float gam = gamma[ch], bet = beta[ch];
    const T* xr = x + base + (int64_t)c * HW;
    const T* gr = g + base + (int64_t)c * HW;
    float adb = 0.0f, adg = 0.0f;
    float xv[N], gv[N];
    for (int i = start + lane * N; i < end; i += 32 * N) {
      if constexpr (VEC) {
        load_pack(xr + i, xv);
        load_pack(gr + i, gv);
      } else {
        xv[0] = to_f32(xr[i]);
        gv[0] = to_f32(gr[i]);
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xh = (xv[j] - mean) * inv;
        const float dp = gn_dpre(gv[j], xh, gam, bet, act);
        adb += dp;
        adg = fmaf(dp, xh, adg);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      adb += __shfl_xor_sync(0xffffffffu, adb, o);
      adg += __shfl_xor_sync(0xffffffffu, adg, o);
    }
    if (lane == 0) {
      atomicAdd(&sdb[c], adb);
      atomicAdd(&sdg[c], adg);
    }
  }
  __syncthreads();

  // per-sample parameter gradients, and the two group means of pass 3
  float m1 = 0.0f, m2 = 0.0f;
  for (int c = threadIdx.x; c < cg; c += kBwdThreads) {
    const int ch = gi * cg + c;
    dparam[((int64_t)b * 2 + 0) * C + ch] = sdg[c];
    dparam[((int64_t)b * 2 + 1) * C + ch] = sdb[c];
    m1 = fmaf(gamma[ch], sdb[c], m1);
    m2 = fmaf(gamma[ch], sdg[c], m2);
  }
  block_sum2<kBwdThreads>(m1, m2);
  m1 /= nf;
  m2 /= nf;

  // 3. dx over the whole group (a packet never straddles two channels)
  const T* xg = x + base;
  const T* gg = g + base;
  T* dxg = dx + base;
  float xv[N], gv[N], out[N];
  for (int64_t i = (int64_t)threadIdx.x * N; i < n; i += (int64_t)kBwdThreads * N) {
    const int ch = gi * cg + (int)(i / HW);
    const float gam = gamma[ch], bet = beta[ch];
    if constexpr (VEC) {
      load_pack(xg + i, xv);
      load_pack(gg + i, gv);
    } else {
      xv[0] = to_f32(xg[i]);
      gv[0] = to_f32(gg[i]);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float xh = (xv[j] - mean) * inv;
      const float dxh = gn_dpre(gv[j], xh, gam, bet, act) * gam;
      out[j] = inv * (dxh - m1 - xh * m2);
    }
    if constexpr (VEC)
      store_pack(dxg + i, out);
    else
      dxg[i] = from_f32<T>(out[0]);
  }
}

template <typename T>
bool packable(const void* p, int HW) {
  return HW % Pack<T>::N == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
void launch_fwd(const void* x, const float* gamma, const float* beta, void* y, int B, int C,
                int HW, int G, float eps, int act, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (packable<T>(x, HW) && packable<T>(y, HW))
    gn_fwd_kernel<T, true><<<B * G, kFwdThreads, 0, st>>>(xt, gamma, beta, yt, C, HW, G, eps, act);
  else
    gn_fwd_kernel<T, false><<<B * G, kFwdThreads, 0, st>>>(xt, gamma, beta, yt, C, HW, G, eps, act);
}

template <typename T>
void launch_stats(const void* x, float* parts, int B, int C, int HW, int G, int chunks,
                  cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  dim3 grid((unsigned)((int64_t)B * G * chunks));
  // a chunk starts at k * (C/G)*HW/chunks elements: packets line up when
  // that length is a whole number of packets
  const int64_t len = (int64_t)(C / G) * HW / chunks;
  if (packable<T>(x, HW) && len % Pack<T>::N == 0)
    gn_stats_kernel<T, true><<<grid, kStatsThreads, 0, st>>>(xt, parts, C, HW, G, chunks);
  else
    gn_stats_kernel<T, false><<<grid, kStatsThreads, 0, st>>>(xt, parts, C, HW, G, chunks);
}

template <typename T>
void launch_apply(const void* x, const float* a, const float* b, void* y, int B, int C, int HW,
                  int act, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const bool vec = packable<T>(x, HW) && packable<T>(y, HW);
  const int per_block = kApplyThreads * (vec ? Pack<T>::N : 1);
  int xblocks = (HW + per_block - 1) / per_block;
  if (xblocks > 64) xblocks = 64;  // each thread then loops over the row
  dim3 grid((unsigned)((int64_t)B * C), xblocks);
  if (vec)
    gn_apply_kernel<T, true><<<grid, kApplyThreads, 0, st>>>(xt, a, b, yt, HW, act);
  else
    gn_apply_kernel<T, false><<<grid, kApplyThreads, 0, st>>>(xt, a, b, yt, HW, act);
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, const float* gamma, const float* beta,
                       void* dx, float* dparam, int B, int C, int HW, int G, float eps, int act,
                       cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  const size_t smem = 2 * sizeof(float) * (size_t)(C / G);
  if (packable<T>(x, HW) && packable<T>(g, HW) && packable<T>(dx, HW))
    gn_bwd_kernel<T, true><<<B * G, kBwdThreads, smem, st>>>(xt, gt, gamma, beta, dxt, dparam,
                                                             C, HW, G, eps, act);
  else
    gn_bwd_kernel<T, false><<<B * G, kBwdThreads, smem, st>>>(xt, gt, gamma, beta, dxt, dparam,
                                                              C, HW, G, eps, act);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tt

extern "C" {

int tt_gn_silu_fwd(const void* x, const void* gamma, const void* beta, void* y, int B, int C,
                   int HW, int G, float eps, int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  if (dtype == tt::kF32)
    tt::launch_fwd<float>(x, ga, be, y, B, C, HW, G, eps, act, st);
  else if (dtype == tt::kBF16)
    tt::launch_fwd<__nv_bfloat16>(x, ga, be, y, B, C, HW, G, eps, act, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int tt_gn_stats(const void* x, void* parts, int B, int C, int HW, int G, int chunks, int dtype,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(parts);
  if (dtype == tt::kF32)
    tt::launch_stats<float>(x, pt, B, C, HW, G, chunks, st);
  else if (dtype == tt::kBF16)
    tt::launch_stats<__nv_bfloat16>(x, pt, B, C, HW, G, chunks, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int tt_gn_apply(const void* x, const void* a, const void* b, void* y, int B, int C, int HW,
                int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  if (dtype == tt::kF32)
    tt::launch_apply<float>(x, af, bf, y, B, C, HW, act, st);
  else if (dtype == tt::kBF16)
    tt::launch_apply<__nv_bfloat16>(x, af, bf, y, B, C, HW, act, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int tt_gn_silu_bwd(const void* x, const void* g, const void* gamma, const void* beta, void* dx,
                   void* dparam, int B, int C, int HW, int G, float eps, int act, int dtype,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* dp = static_cast<float*>(dparam);
  if (dtype == tt::kF32)
    return (int)tt::launch_bwd<float>(x, g, ga, be, dx, dp, B, C, HW, G, eps, act, st);
  if (dtype == tt::kBF16)
    return (int)tt::launch_bwd<__nv_bfloat16>(x, g, ga, be, dx, dp, B, C, HW, G, eps, act, st);
  return (int)cudaErrorInvalidValue;
}

const char* tt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
