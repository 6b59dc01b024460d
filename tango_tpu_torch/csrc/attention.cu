// Forward attention kernels, f32 accumulation, one tile loop for three
// softmax forms (the MODE template argument).
//
// kStatic, entry point tt_attn_fwd. Replaces tango_tpu/ops/flash_attention.py:
// _attn_kernel (flash_attention with bias=None). Same arithmetic, step for step:
//   qs    = round_T(q * scale * log2(e))          (prescaled q, storage type)
//   l     = qs . k                                (f32)
//   p     = exp2(min(l - 20, 96))                 (no running max: the shift is
//                                                  static, see the window note in
//                                                  the JAX file)
//   denom = sum p                                 (f32, unrounded p)
//   acc   = sum round_T(p) * v                    (f32)
//   o     = acc / (denom == 0 ? 1 : denom)        (zero row on underflow)
// Because the shift is static, denom and acc simply add up across key tiles:
// no rescaling of the accumulator as an online max-subtracted softmax needs.
//
// kOnline, entry point tt_attn_fwd_v2. Replaces _attn_kernel_v2 (through
// flash_attention_v2, which JAX takes for a bias-free call with
// Skv > 4096, Skv % 512 == 0 and Sq % 128 == 0): the max-subtracted
// FlashAttention-2 online softmax. Per key tile, with m starting at -1e30:
//   m'    = max(m, max_j l_j)
//   alpha = exp2(m - m')
//   p     = exp2(l - m')
//   denom = alpha * denom + sum p
//   acc   = alpha * acc + sum round_T(p) * v
//   o     = acc / denom                           (denom >= 1: no zero select)
// It has no exactness window. JAX steps over 1024-key blocks, this kernel
// over 32-key tiles: in f32 that is the same function; in bf16 round_T(p) is
// taken against another running max, which moves the output by at most one
// bf16 step.
//
// kBias, entry point tt_attn_fwd_bias. Replaces _attn_kernel_bias
// (flash_attention with a bias): l = qs . k + bias * log2(e), with an f32 bias
// (B, 1 | Sq, Skv) shared by the H heads of a batch row (head bh reads batch
// bh / H, JAX's `i // h` index map). JAX takes the max over the whole row at
// once (its K/V block is the whole key set); this kernel streams the keys
// with the kOnline carry instead, so the same bf16 remark holds. A row whose
// keys are all masked (bias -10000) stays finite: the max is subtracted.
//
// Which body a call takes: tc_body(dtype, D, mode) (common.cuh) sends head
// dim 64 in all three forms (every attention of the full-width UNet) and
// head dim 32 in the static form (AudioLDM's FiLM UNet) to the tensor-core
// bodies of attention_tc.cu, the same arithmetic on wgmma: bf16, and f32
// held to JAX's f32 limits by 3xTF32 products; the entry point says so by
// returning kTcLaunched. This file's body runs the other head dims (8, 16,
// 128) and the online and biased forms at 32, which no path launches; the
// entry point tt_attn_fwd_core launches it for the static form at any head
// dim it takes, so that a check can time it beside the tensor-core body.
//
// What bounds them on the H100: operations. At the UNet's shapes (S = 8192,
// 4096, 1024, 256, head dim 64; Skv = 256 for the biased cross-attention)
// attention does 4*Skv*D flops per query row against 8*D bytes, far above the
// card's ~295 flops per byte. This body runs the two products on the CUDA
// cores in f32 (no tensor cores, no wgmma), so it sits well below the bf16
// tensor-core bound; what its design does about the bound is keep the
// (Sq x Skv) logits out of device memory, stage each K/V tile once in shared
// memory for 64 query rows, and keep the output tile, the running max and
// the denominator in registers.
//
// Layout: q (BH, Sq, D), k and v (BH, Skv, D), contiguous. One block per
// (b*h, 64-row query tile), flattened onto grid.x (up to 2^31 - 1 blocks, so
// BH has no 65535 cap); 256 threads; thread (ty, tx) = (tid/8, tid%8) owns
// query rows ty and ty+32, key columns tx+8j of the logit tile and output
// columns tx+8j. Ragged edges are masked: rows past Sq are not stored, keys
// past Skv get p = 0. Element offsets are 64-bit.

#include <math_constants.h>

#include "common.cuh"

namespace tt {

// The tensor-core bodies (attention_tc.cu) at head dim D (64, or 32 in the
// static form); mode is an AttnMode.
cudaError_t attn_fwd_tc(const void* q, const void* k, const void* v, const float* bias,
                        int heads, int bias_rows, void* o, int BH, int Sq, int Skv, int D,
                        float qscale, int mode, bool f32, cudaStream_t st);

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr float kShift = 20.0f;
constexpr float kClamp = 96.0f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t attn_smem_bytes() {
  // Q (BQ x D+1), K (BK x D+1), V (BK x D), P (BQ x BK+1), all f32; the +1
  // pads rows so that columns fall in distinct shared-memory banks
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

// The bias operand of kBias: bias[(bh / heads) * rows * Skv + row * Skv + key],
// rows 1 (one row for every query) or Sq.
struct BiasArg {
  const float* ptr;
  int heads;
  int rows;
};

// Max over the 8 lanes that share a row (tx = 0..7, adjacent in the warp).
__device__ __forceinline__ float row_max8(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum8(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, BiasArg bias, int Sq, int Skv, float qscale) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);         // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);         // [kBK][D]
  float* Ps = Vs + kBK * D;               // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int tiles = (Sq + kBQ - 1) / kBQ;
  const int64_t head = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kBQ;
  const T* qh = q + head * Sq * D;
  const T* kh = k + head * Skv * D;
  const T* vh = v + head * Skv * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const float val = q0 + r < Sq ? to_f32(qh[(int64_t)(q0 + r) * D + d]) : 0.0f;
    Qs[r * (D + 1) + d] = round_to<T>(val * qscale);
  }

  constexpr int NC = D / 8;  // output columns per thread
  float acc[2][NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[0][j] = acc[1][j] = 0.0f;
  float den0 = 0.0f, den1 = 0.0f;
  float m0 = -1e30f, m1 = -1e30f;  // running row maxes (kOnline, kBias)
  const int r0 = ty, r1 = ty + 32;

  // the two bias rows of this thread (a ragged row past Sq reads row Sq - 1)
  const float* b0 = nullptr;
  const float* b1 = nullptr;
  if constexpr (MODE == kBias) {
    const float* bb = bias.ptr + (head / bias.heads) * (int64_t)bias.rows * Skv;
    b0 = bb + (bias.rows == 1 ? 0 : (int64_t)min(q0 + r0, Sq - 1) * Skv);
    b1 = bb + (bias.rows == 1 ? 0 : (int64_t)min(q0 + r1, Sq - 1) * Skv);
  }

  for (int k0 = 0; k0 < Skv; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done (and Qs is written)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < Skv;
      const int64_t g = (int64_t)(k0 + r) * D + d;
      Ks[r * (D + 1) + d] = in ? to_f32(kh[g]) : 0.0f;
      Vs[r * D + d] = in ? to_f32(vh[g]) : 0.0f;
    }
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[0][j] = s[1][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float a0 = Qs[r0 * (D + 1) + d];
      const float a1 = Qs[r1 * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = Ks[(tx + 8 * j) * (D + 1) + d];
        s[0][j] = fmaf(a0, kv, s[0][j]);
        s[1][j] = fmaf(a1, kv, s[1][j]);
      }
    }

    float p[2][4];
    if constexpr (MODE == kStatic) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = k0 + tx + 8 * j < Skv;
        p[0][j] = in ? exp2f(fminf(s[0][j] - kShift, kClamp)) : 0.0f;
        p[1][j] = in ? exp2f(fminf(s[1][j] - kShift, kClamp)) : 0.0f;
      }
    } else {
      float t0 = -CUDART_INF_F, t1 = -CUDART_INF_F;  // this tile's row maxes
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 8 * j;
        if (c < Skv) {
          if constexpr (MODE == kBias) {
            s[0][j] += b0[c] * kLog2e;
            s[1][j] += b1[c] * kLog2e;
          }
          t0 = fmaxf(t0, s[0][j]);
          t1 = fmaxf(t1, s[1][j]);
        }
      }
      const float n0 = fmaxf(m0, row_max8(t0));
      const float n1 = fmaxf(m1, row_max8(t1));
      const float alpha0 = exp2f(m0 - n0), alpha1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      den0 *= alpha0;
      den1 *= alpha1;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        acc[0][j] *= alpha0;
        acc[1][j] *= alpha1;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = k0 + tx + 8 * j < Skv;
        p[0][j] = in ? exp2f(s[0][j] - n0) : 0.0f;
        p[1][j] = in ? exp2f(s[1][j] - n1) : 0.0f;
      }
    }

    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 8 * j;
      sum0 += p[0][j];
      sum1 += p[1][j];
      Ps[r0 * (kBK + 1) + c] = round_to<T>(p[0][j]);
      Ps[r1 * (kBK + 1) + c] = round_to<T>(p[1][j]);
    }
    den0 += row_sum8(sum0);
    den1 += row_sum8(sum1);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float p0 = Ps[r0 * (kBK + 1) + c];
      const float p1 = Ps[r1 * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float vv = Vs[c * D + tx + 8 * j];
        acc[0][j] = fmaf(p0, vv, acc[0][j]);
        acc[1][j] = fmaf(p1, vv, acc[1][j]);
      }
    }
  }

  if constexpr (MODE == kStatic) {
    den0 = den0 == 0.0f ? 1.0f : den0;
    den1 = den1 == 0.0f ? 1.0f : den1;
  }
  T* oh = o + head * Sq * D;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int d = tx + 8 * j;
    if (q0 + r0 < Sq) oh[(int64_t)(q0 + r0) * D + d] = from_f32<T>(acc[0][j] / den0);
    if (q0 + r1 < Sq) oh[(int64_t)(q0 + r1) * D + d] = from_f32<T>(acc[1][j] / den1);
  }
}

template <typename T, int D, int MODE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, BiasArg bias, int BH,
                   int Sq, int Skv, float qscale, cudaStream_t st) {
  constexpr size_t smem = attn_smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attn_fwd_kernel<T, D, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks = (int64_t)BH * ((Sq + kBQ - 1) / kBQ);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  attn_fwd_kernel<T, D, MODE><<<(unsigned)blocks, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), bias, Sq, Skv, qscale);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, BiasArg bias,
                       int BH, int Sq, int Skv, int D, float qscale, cudaStream_t st) {
  switch (D) {
    case 8: return launch<T, 8, MODE>(q, k, v, o, bias, BH, Sq, Skv, qscale, st);
    case 16: return launch<T, 16, MODE>(q, k, v, o, bias, BH, Sq, Skv, qscale, st);
    case 32: return launch<T, 32, MODE>(q, k, v, o, bias, BH, Sq, Skv, qscale, st);
    case 64: return launch<T, 64, MODE>(q, k, v, o, bias, BH, Sq, Skv, qscale, st);
    case 128: return launch<T, 128, MODE>(q, k, v, o, bias, BH, Sq, Skv, qscale, st);
    default: return cudaErrorInvalidValue;
  }
}

// This file's CUDA-core body, whatever the rule says.
template <int MODE>
int core(const void* q, const void* k, const void* v, void* o, BiasArg bias, int BH, int Sq,
         int Skv, int D, float qscale, int dtype, cudaStream_t st) {
  if (dtype == kF32)
    return (int)dispatch_d<float, MODE>(q, k, v, o, bias, BH, Sq, Skv, D, qscale, st);
  if (dtype == kBF16)
    return (int)dispatch_d<__nv_bfloat16, MODE>(q, k, v, o, bias, BH, Sq, Skv, D, qscale, st);
  return (int)cudaErrorInvalidValue;
}

template <int MODE>
int dispatch(const void* q, const void* k, const void* v, void* o, BiasArg bias, int BH, int Sq,
             int Skv, int D, float qscale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc_body(dtype, D, MODE))
    return tc_result(attn_fwd_tc(q, k, v, bias.ptr, bias.heads, bias.rows, o, BH, Sq, Skv, D,
                                 qscale, MODE, dtype == kF32, st));
  return core<MODE>(q, k, v, o, bias, BH, Sq, Skv, D, qscale, dtype, st);
}

}  // namespace
}  // namespace tt

extern "C" {

int tt_attn_fwd(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv,
                int D, float qscale, int dtype, void* stream) {
  return tt::dispatch<tt::kStatic>(q, k, v, o, tt::BiasArg{nullptr, 1, 1}, BH, Sq, Skv, D,
                                   qscale, dtype, stream);
}

int tt_attn_fwd_v2(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                   int Skv, int D, float qscale, int dtype, void* stream) {
  return tt::dispatch<tt::kOnline>(q, k, v, o, tt::BiasArg{nullptr, 1, 1}, BH, Sq, Skv, D,
                                   qscale, dtype, stream);
}

// The CUDA-core body of the static form at any head dim it takes, never the
// tensor-core one: not on any path; chip_smoke.py times it beside tt_attn_fwd.
int tt_attn_fwd_core(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                     int Skv, int D, float qscale, int dtype, void* stream) {
  return tt::core<tt::kStatic>(q, k, v, o, tt::BiasArg{nullptr, 1, 1}, BH, Sq, Skv, D, qscale,
                               dtype, static_cast<cudaStream_t>(stream));
}

int tt_attn_fwd_bias(const void* q, const void* k, const void* v, const void* bias, void* o,
                     int BH, int Sq, int Skv, int D, int heads, int bias_rows, float qscale,
                     int dtype, void* stream) {
  if (heads < 1 || (bias_rows != 1 && bias_rows != Sq)) return (int)cudaErrorInvalidValue;
  const tt::BiasArg b{static_cast<const float*>(bias), heads, bias_rows};
  return tt::dispatch<tt::kBias>(q, k, v, o, b, BH, Sq, Skv, D, qscale, dtype, stream);
}

}  // extern "C"
