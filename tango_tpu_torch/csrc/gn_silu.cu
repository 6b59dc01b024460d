// GroupNorm(+SiLU) for channels-first (NCHW) activations, f32 statistics.
//
// Replaces tango_tpu/ops/gn_silu_pallas.py: _gn_kernel (single pass) and
// _gn_stats_kernel + _gn_apply_kernel (two stage). The port keeps activations
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
// streams y = x*a + b (+SiLU) over a (rows, B*C) grid.
//
// Statistics follow the Pallas kernels: var = E[x^2] - mean^2, inv =
// 1/sqrt(var + eps).

#include "common.cuh"

namespace tt {
namespace {

constexpr int kFwdThreads = 512;
constexpr int kStatsThreads = 256;
constexpr int kApplyThreads = 256;

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

// grid (chunks, B*G): block (k, bg) sums chunk k of group bg into
// parts[(bg*chunks + k)*2 + {0: sum, 1: sum of squares}].
template <typename T, bool VEC>
__global__ void __launch_bounds__(kStatsThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ parts, int C, int HW, int G,
                int chunks) {
  const int k = blockIdx.x, bg = blockIdx.y;
  const int b = bg / G, g = bg % G;
  const int cg = C / G;
  const int64_t len = (int64_t)cg * HW / chunks;
  const int64_t base = ((int64_t)b * C + (int64_t)g * cg) * HW + (int64_t)k * len;
  float s = 0.0f, ss = 0.0f;
  partial_sums<T, VEC>(x + base, len, s, ss);
  block_sum2<kStatsThreads>(s, ss);
  if (threadIdx.x == 0) {
    parts[((int64_t)bg * chunks + k) * 2 + 0] = s;
    parts[((int64_t)bg * chunks + k) * 2 + 1] = ss;
  }
}

// grid (x-blocks, B*C): row bc of HW elements, y = act(x*a[bc] + b[bc]).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ bcoef, T* __restrict__ y, int HW, int act) {
  const int64_t row = blockIdx.y;
  const int64_t off = row * HW;
  affine_row<T, VEC>(x + off, y + off, HW, a[row], bcoef[row], act,
                     (int64_t)blockIdx.x * blockDim.x + threadIdx.x,
                     (int64_t)gridDim.x * blockDim.x);
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
  dim3 grid(chunks, B * G);
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
  dim3 grid(xblocks, B * C);
  if (vec)
    gn_apply_kernel<T, true><<<grid, kApplyThreads, 0, st>>>(xt, a, b, yt, HW, act);
  else
    gn_apply_kernel<T, false><<<grid, kApplyThreads, 0, st>>>(xt, a, b, yt, HW, act);
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

const char* tt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
