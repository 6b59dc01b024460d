// Bias-free attention with the static-shift exp2 softmax, f32 accumulation.
//
// Replaces tango_tpu/ops/flash_attention.py: _attn_kernel (via flash_attention
// with bias=None). Same arithmetic, step for step:
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
// What bounds it on the H100: operations. At the UNet's shapes (S = 4096,
// 1024, 256, head dim 64) attention does 4*S*D flops per query row against
// 8*D bytes, far above the card's ~295 flops per byte. This first version
// runs the two products on the CUDA cores in f32 (no tensor cores, no wgmma),
// so it sits well below the bf16 tensor-core bound; what its design does
// about the bound is keep the (S x S) logits out of device memory, stage each
// K/V tile once in shared memory for 64 query rows, and keep the output tile
// in registers.
//
// Layout: q (BH, Sq, D), k and v (BH, Skv, D), contiguous. One block per
// (64-row query tile, b*h); 256 threads; thread (ty, tx) = (tid/8, tid%8)
// owns query rows ty and ty+32, key columns tx+8j of the logit tile and
// output columns tx+8j. Ragged edges are masked: rows past Sq are not stored,
// keys past Skv get p = 0.

#include "common.cuh"

namespace tt {
namespace {

constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr float kShift = 20.0f;
constexpr float kClamp = 96.0f;

template <int D>
constexpr size_t attn_smem_bytes() {
  // Q (BQ x D+1), K (BK x D+1), V (BK x D), P (BQ x BK+1), all f32; the +1
  // pads rows so that columns fall in distinct shared-memory banks
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, int Sq, int Skv, float qscale) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);         // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);         // [kBK][D]
  float* Ps = Vs + kBK * D;               // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int q0 = blockIdx.x * kBQ;
  const int64_t head = blockIdx.y;
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
  const int r0 = ty, r1 = ty + 32;

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
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 8 * j;
      const bool in = k0 + c < Skv;
      const float p0 = in ? exp2f(fminf(s[0][j] - kShift, kClamp)) : 0.0f;
      const float p1 = in ? exp2f(fminf(s[1][j] - kShift, kClamp)) : 0.0f;
      sum0 += p0;
      sum1 += p1;
      Ps[r0 * (kBK + 1) + c] = round_to<T>(p0);
      Ps[r1 * (kBK + 1) + c] = round_to<T>(p1);
    }
    // the 8 lanes sharing a row (tx = 0..7) are adjacent in the warp
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    den0 += sum0;
    den1 += sum1;
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

  const float inv0 = 1.0f / (den0 == 0.0f ? 1.0f : den0);
  const float inv1 = 1.0f / (den1 == 0.0f ? 1.0f : den1);
  T* oh = o + head * Sq * D;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int d = tx + 8 * j;
    if (q0 + r0 < Sq) oh[(int64_t)(q0 + r0) * D + d] = from_f32<T>(acc[0][j] * inv0);
    if (q0 + r1 < Sq) oh[(int64_t)(q0 + r1) * D + d] = from_f32<T>(acc[1][j] * inv1);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                   int Skv, float qscale, cudaStream_t st) {
  constexpr size_t smem = attn_smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attn_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  attn_fwd_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, qscale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                       int Skv, int D, float qscale, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, BH, Sq, Skv, qscale, st);
    case 32: return launch<T, 32>(q, k, v, o, BH, Sq, Skv, qscale, st);
    case 64: return launch<T, 64>(q, k, v, o, BH, Sq, Skv, qscale, st);
    case 128: return launch<T, 128>(q, k, v, o, BH, Sq, Skv, qscale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tt

extern "C" int tt_attn_fwd(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                           int Skv, int D, float qscale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tt::kF32)
    return (int)tt::dispatch_d<float>(q, k, v, o, BH, Sq, Skv, D, qscale, st);
  if (dtype == tt::kBF16)
    return (int)tt::dispatch_d<__nv_bfloat16>(q, k, v, o, BH, Sq, Skv, D, qscale, st);
  return (int)cudaErrorInvalidValue;
}
