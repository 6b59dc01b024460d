// Backward of bias-free softmax attention, f32 accumulation: two kernels on
// the CUDA cores, for the head dims that bwd_tc_body does not take (8, 16,
// 32 and 128; no attention of the UNet has them). f32 and bf16 at head dim 64,
// every attention of the full-width UNet, run the tensor-core body of
// attention_bwd_tc.cu from the same entry points.
//
// Replaces tango_tpu/ops/flash_attention.py: _bwd_dq_kernel and
// _bwd_dkv_kernel (via flash_attention_bwd). Like them, it is the gradient of
// the EXACT softmax(q k^T * scale) v, recomputed from q, k, v alone (the
// forward's static-shift softmax and its output are not saved):
//   s     = (q . k) * scale                          (f32)
//   lse   = max s + log sum exp(s - max s)           (per query row)
//   p     = exp(s - lse)
//   dp    = dO . v                                   (f32)
//   delta = sum p * dp                               (per query row; not the
//                                                     rowsum(dO o O) shortcut:
//                                                     no O is saved)
//   ds    = round_T(p * (dp - delta) * scale)        (storage type, as JAX)
//   dq    = ds . k          dk = ds^T . q            (f32, then storage type)
//   dv    = round_T(p)^T . dO
//
// attn_bwd_dq: one block per (64 query rows, b*h). The Pallas kernel held the
// whole K/V of a head in VMEM, so one pass saw a whole row. Shared memory
// cannot hold a 4096-row K/V, so K/V stream through it in 32-row tiles, and
// the row's lse and delta must be known before any ds. This kernel makes TWO
// passes over K/V per query tile, not three: the first carries an online
// max m, the sum l = sum exp(s - m) and dl = sum exp(s - m) * dp, rescaling
// both by exp(m_old - m_new) whenever the max grows, so that at its end
// lse = m + log l and delta = dl / l; the second recomputes s and dp and
// accumulates dq. It writes lse and delta as (BH, Sq) f32 for the dkv kernel.
//
// attn_bwd_dkv: one block per (64 key rows, b*h); Q, dO, lse and delta stream
// through shared memory in 32-row tiles, and dk and dv stay in registers.
// It reads the lse and delta that attn_bwd_dq wrote: the wrapper launches both
// on the current stream, dq first.
//
// What bounds them on the H100: operations. dq does 3 and dkv 4 products of
// 2*S*S*D flops per head against 8*S*D bytes (f32 K, V, Q, dO). This body
// runs every product on the CUDA cores in f32 (no tensor cores), and dq
// recomputes s and dp in its second pass (5 products instead of 3). What
// the design does about the bound: the (S x S) probabilities never reach
// device memory, each K/V (or Q/dO) tile is staged once in shared memory for
// 64 rows, and the accumulators stay in registers.
//
// Thread layout (both kernels): 256 threads, thread (ty, tx) = (tid/8, tid%8)
// owns rows ty and ty+32 of the block's 64 and columns tx+8j of a tile
// (logit columns) or of D (accumulator columns). Ragged edges are masked:
// keys past Skv get p = 0 in dq, queries past Sq get p = 0 in dkv, and rows
// past the end are not stored. The (b*h, row tile) blocks are flattened onto
// grid.x, so BH has no 65535 cap; element offsets are 64-bit.

#include <math_constants.h>

#include "common.cuh"

namespace tt {

// The tensor-core body (attention_bwd_tc.cu), f32 (3xTF32 logits, split-bf16
// gradients) or bf16.
cudaError_t attn_bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                           void* dq, float* lse, float* delta, int BH, int Sq, int Skv,
                           float scale, bool f32, cudaStream_t st);
cudaError_t attn_bwd_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dk, void* dv, int BH,
                            int Sq, int Skv, float scale, bool f32, cudaStream_t st);

namespace {

constexpr int kRows = 64;   // rows of q (dq) or k/v (dkv) per block
constexpr int kTile = 32;   // rows of the streamed tile
constexpr int kThreads = 256;

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO (kRows x D+1), K, V (kTile x D+1), dS (kRows x kTile+1), f32; the +1
  // pads rows so that columns fall in distinct shared-memory banks
  return sizeof(float) * (2 * kRows * (D + 1) + 2 * kTile * (D + 1) + kRows * (kTile + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V (kRows x D+1), Q, dO (kTile x D+1), P, dS (kRows x kTile+1), lse and
  // delta of the tile (kTile each)
  return sizeof(float) * (2 * kRows * (D + 1) + 2 * kTile * (D + 1) + 2 * kRows * (kTile + 1) +
                          2 * kTile);
}

// Loads rows [r0, r0 + n) of a (S, D) head into a padded f32 tile; rows past S
// are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0, int n, int S) {
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = r0 + r < S ? to_f32(src[(int64_t)(r0 + r) * D + d]) : 0.0f;
  }
}

__device__ __forceinline__ float sum8(float v) {
  // the 8 lanes sharing a row (tx = 0..7) are adjacent in the warp
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float max8(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// s[i][j] = A[row_i] . B[col_j] and t[i][j] = C[row_i] . E[col_j] over D, for
// the thread's two rows (ty, ty+32) and four columns (tx + 8j).
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* B, const float* C,
                                             const float* E, int ty, int tx, float s[2][4],
                                             float t[2][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) s[0][j] = s[1][j] = t[0][j] = t[1][j] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float a0 = A[ty * (D + 1) + d], a1 = A[(ty + 32) * (D + 1) + d];
    const float c0 = C[ty * (D + 1) + d], c1 = C[(ty + 32) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float b = B[(tx + 8 * j) * (D + 1) + d];
      const float e = E[(tx + 8 * j) * (D + 1) + d];
      s[0][j] = fmaf(a0, b, s[0][j]);
      s[1][j] = fmaf(a1, b, s[1][j]);
      t[0][j] = fmaf(c0, e, t[0][j]);
      t[1][j] = fmaf(c1, e, t[1][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ lse_out,
                   float* __restrict__ delta_out, int Sq, int Skv, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                        // [kRows][D + 1]
  float* dOs = Qs + kRows * (D + 1);       // [kRows][D + 1]
  float* Ks = dOs + kRows * (D + 1);       // [kTile][D + 1]
  float* Vs = Ks + kTile * (D + 1);        // [kTile][D + 1]
  float* dSs = Vs + kTile * (D + 1);       // [kRows][kTile + 1]

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int tiles = (Sq + kRows - 1) / kRows;  // (b*h, row tile) flattened onto grid.x
  const int64_t head = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kRows;
  const T* kh = k + head * Skv * D;
  const T* vh = v + head * Skv * D;
  load_rows<T, D>(Qs, q + head * Sq * D, q0, kRows, Sq);
  load_rows<T, D>(dOs, dout + head * Sq * D, q0, kRows, Sq);

  // pass 1: online max m, l = sum exp(s - m), dl = sum exp(s - m) * dp; each
  // lane keeps partial l and dl over its columns, rescaled by the row's shared
  // max, and the 8 lanes of a row add them up at the end
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f}, dl[2] = {0.0f, 0.0f};
  for (int k0 = 0; k0 < Skv; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done (and Q, dO are written)
    load_rows<T, D>(Ks, kh, k0, kTile, Skv);
    load_rows<T, D>(Vs, vh, k0, kTile, Skv);
    __syncthreads();
    float s[2][4], dp[2][4];
    two_products<D>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] = k0 + tx + 8 * j < Skv ? s[r][j] * scale : -CUDART_INF_F;
        tmax = fmaxf(tmax, s[r][j]);
      }
      const float mn = fmaxf(m[r], max8(tmax));  // finite: column k0 is a key
      const float f = expf(m[r] - mn);
      l[r] *= f;
      dl[r] *= f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[r][j] - mn);
        l[r] += e;
        dl[r] = fmaf(e, dp[r][j], dl[r]);
      }
      m[r] = mn;
    }
  }
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = sum8(l[r]);
    lse[r] = m[r] + logf(lt);
    delta[r] = sum8(dl[r]) / lt;
  }

  // pass 2: ds = round_T(p * (dp - delta) * scale), dq += ds . K
  constexpr int NC = D / 8;
  float acc[2][NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[0][j] = acc[1][j] = 0.0f;
  for (int k0 = 0; k0 < Skv; k0 += kTile) {
    __syncthreads();
    load_rows<T, D>(Ks, kh, k0, kTile, Skv);
    load_rows<T, D>(Vs, vh, k0, kTile, Skv);
    __syncthreads();
    float s[2][4], dp[2][4];
    two_products<D>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 8 * j;
        const float p = k0 + c < Skv ? expf(s[r][j] * scale - lse[r]) : 0.0f;
        dSs[(ty + 32 * r) * (kTile + 1) + c] = round_to<T>(p * (dp[r][j] - delta[r]) * scale);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      const float d0 = dSs[ty * (kTile + 1) + c];
      const float d1 = dSs[(ty + 32) * (kTile + 1) + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float kv = Ks[c * (D + 1) + tx + 8 * j];
        acc[0][j] = fmaf(d0, kv, acc[0][j]);
        acc[1][j] = fmaf(d1, kv, acc[1][j]);
      }
    }
  }

  T* dqh = dq + head * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + ty + 32 * r;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) dqh[(int64_t)row * D + tx + 8 * j] = from_f32<T>(acc[r][j]);
    if (tx == 0) {
      lse_out[head * Sq + row] = lse[r];
      delta_out[head * Sq + row] = delta[r];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                    int Sq, int Skv, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                        // [kRows][D + 1]
  float* Vs = Ks + kRows * (D + 1);        // [kRows][D + 1]
  float* Qs = Vs + kRows * (D + 1);        // [kTile][D + 1]
  float* dOs = Qs + kTile * (D + 1);       // [kTile][D + 1]
  float* Ps = dOs + kTile * (D + 1);       // [kRows][kTile + 1]
  float* dSs = Ps + kRows * (kTile + 1);   // [kRows][kTile + 1]
  float* lses = dSs + kRows * (kTile + 1); // [kTile]
  float* dels = lses + kTile;              // [kTile]

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int tiles = (Skv + kRows - 1) / kRows;  // (b*h, row tile) flattened onto grid.x
  const int64_t head = blockIdx.x / tiles;
  const int k0 = (blockIdx.x % tiles) * kRows;
  const T* qh = q + head * Sq * D;
  const T* doh = dout + head * Sq * D;
  load_rows<T, D>(Ks, k + head * Skv * D, k0, kRows, Skv);
  load_rows<T, D>(Vs, v + head * Skv * D, k0, kRows, Skv);

  constexpr int NC = D / 8;
  float adk[2][NC], adv[2][NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) adk[0][j] = adk[1][j] = adv[0][j] = adv[1][j] = 0.0f;

  for (int q0 = 0; q0 < Sq; q0 += kTile) {
    __syncthreads();
    load_rows<T, D>(Qs, qh, q0, kTile, Sq);
    load_rows<T, D>(dOs, doh, q0, kTile, Sq);
    if (tid < kTile) {
      const bool in = q0 + tid < Sq;
      // a query past Sq gets p = exp(s - inf) = 0
      lses[tid] = in ? lse[head * Sq + q0 + tid] : CUDART_INF_F;
      dels[tid] = in ? delta[head * Sq + q0 + tid] : 0.0f;
    }
    __syncthreads();
    // rows: keys ty, ty+32; columns: queries tx + 8j
    float s[2][4], dp[2][4];
    two_products<D>(Ks, Qs, Vs, dOs, ty, tx, s, dp);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 8 * j;
        const float p = expf(s[r][j] * scale - lses[c]);
        Ps[(ty + 32 * r) * (kTile + 1) + c] = round_to<T>(p);
        dSs[(ty + 32 * r) * (kTile + 1) + c] = round_to<T>(p * (dp[r][j] - dels[c]) * scale);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      const float p0 = Ps[ty * (kTile + 1) + c], p1 = Ps[(ty + 32) * (kTile + 1) + c];
      const float s0 = dSs[ty * (kTile + 1) + c], s1 = dSs[(ty + 32) * (kTile + 1) + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float o = dOs[c * (D + 1) + tx + 8 * j];
        const float qq = Qs[c * (D + 1) + tx + 8 * j];
        adv[0][j] = fmaf(p0, o, adv[0][j]);
        adv[1][j] = fmaf(p1, o, adv[1][j]);
        adk[0][j] = fmaf(s0, qq, adk[0][j]);
        adk[1][j] = fmaf(s1, qq, adk[1][j]);
      }
    }
  }

  T* dkh = dk + head * Skv * D;
  T* dvh = dv + head * Skv * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + ty + 32 * r;
    if (row >= Skv) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      dkh[(int64_t)row * D + tx + 8 * j] = from_f32<T>(adk[r][j]);
      dvh[(int64_t)row * D + tx + 8 * j] = from_f32<T>(adv[r][j]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout, void* dq,
                      float* lse, float* delta, int BH, int Sq, int Skv, float scale,
                      cudaStream_t st) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t e = allow_smem(attn_bwd_dq_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (int64_t)BH * ((Sq + kRows - 1) / kRows);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)blocks);
  attn_bwd_dq_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<T*>(dq), lse, delta, Sq, Skv, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int BH,
                       int Sq, int Skv, float scale, cudaStream_t st) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t e = allow_smem(attn_bwd_dkv_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (int64_t)BH * ((Skv + kRows - 1) / kRows);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)blocks);
  attn_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq,
      Skv, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v, const void* dout, void* dq,
                        float* lse, float* delta, int BH, int Sq, int Skv, int D, float scale,
                        cudaStream_t st) {
  switch (D) {
    case 8: return launch_dq<T, 8>(q, k, v, dout, dq, lse, delta, BH, Sq, Skv, scale, st);
    case 16: return launch_dq<T, 16>(q, k, v, dout, dq, lse, delta, BH, Sq, Skv, scale, st);
    case 32: return launch_dq<T, 32>(q, k, v, dout, dq, lse, delta, BH, Sq, Skv, scale, st);
    case 64: return launch_dq<T, 64>(q, k, v, dout, dq, lse, delta, BH, Sq, Skv, scale, st);
    case 128: return launch_dq<T, 128>(q, k, v, dout, dq, lse, delta, BH, Sq, Skv, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dk, void* dv, int BH,
                         int Sq, int Skv, int D, float scale, cudaStream_t st) {
  switch (D) {
    case 8: return launch_dkv<T, 8>(q, k, v, dout, lse, delta, dk, dv, BH, Sq, Skv, scale, st);
    case 16: return launch_dkv<T, 16>(q, k, v, dout, lse, delta, dk, dv, BH, Sq, Skv, scale, st);
    case 32: return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, BH, Sq, Skv, scale, st);
    case 64: return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, BH, Sq, Skv, scale, st);
    case 128:
      return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, BH, Sq, Skv, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tt

extern "C" {

int tt_attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* lse, void* delta, int BH, int Sq, int Skv, int D, float scale,
                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (tt::bwd_tc_body(dtype, D))
    return tt::tc_result(tt::attn_bwd_dq_tc(q, k, v, dout, dq, l, dl, BH, Sq, Skv, scale,
                                            dtype == tt::kF32, st));
  if (dtype == tt::kF32)
    return (int)tt::dispatch_dq<float>(q, k, v, dout, dq, l, dl, BH, Sq, Skv, D, scale, st);
  if (dtype == tt::kBF16)
    return (int)tt::dispatch_dq<__nv_bfloat16>(q, k, v, dout, dq, l, dl, BH, Sq, Skv, D, scale,
                                               st);
  return (int)cudaErrorInvalidValue;
}

int tt_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int BH, int Sq,
                    int Skv, int D, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (tt::bwd_tc_body(dtype, D))
    return tt::tc_result(tt::attn_bwd_dkv_tc(q, k, v, dout, l, dl, dk, dv, BH, Sq, Skv, scale,
                                             dtype == tt::kF32, st));
  if (dtype == tt::kF32)
    return (int)tt::dispatch_dkv<float>(q, k, v, dout, l, dl, dk, dv, BH, Sq, Skv, D, scale, st);
  if (dtype == tt::kBF16)
    return (int)tt::dispatch_dkv<__nv_bfloat16>(q, k, v, dout, l, dl, dk, dv, BH, Sq, Skv, D,
                                                scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
