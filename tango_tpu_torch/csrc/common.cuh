// Shared helpers for the port's hand-written kernels: f32 <-> storage-type
// conversion and 16-byte vector loads. Storage types are float and bf16; all
// arithmetic is f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tt {

enum DType : int { kF32 = 0, kBF16 = 1 };

// The forward attention's three softmax forms (attention.cu, attention_tc.cu):
// kStatic tt_attn_fwd, kOnline tt_attn_fwd_v2, kBias tt_attn_fwd_bias.
enum AttnMode : int { kStatic = 0, kOnline = 1, kBias = 2 };

// What an entry point that has a tensor-core body returns after launching it;
// 0 is a launch of its CUDA-core body and a positive code a cudaError_t. The
// wrappers count tc_launches from this report.
constexpr int kTcLaunched = -1;
inline int tc_result(cudaError_t e) { return e == cudaSuccess ? kTcLaunched : (int)e; }

// tc_body(dtype, D, mode): the rule by which the forward attention entry
// points (attention.cu: tt_attn_fwd, tt_attn_fwd_v2, tt_attn_fwd_bias, their
// AttnMode) take their tensor-core bodies (attention_tc.cu): f32 or bf16, at
// head dim 64 in every form, and at head dim 32 (AudioLDM's) in the static
// form, the one a path launches there. bwd_tc_body(dtype, D): the same for
// the backward entry points (attention_bwd.cu: tt_attn_bwd_dq,
// tt_attn_bwd_dkv; attention_bwd_tc.cu): head dim 64, f32 or bf16. Both are
// in ops/flash_attention.py too, for the wrappers' alignment check; their
// counters read the kTcLaunched report.
inline bool tc_body(int dtype, int D, int mode) {
  return (dtype == kF32 || dtype == kBF16) && (D == 64 || (D == 32 && mode == kStatic));
}
inline bool bwd_tc_body(int dtype, int D) { return D == 64 && (dtype == kF32 || dtype == kBF16); }

// The same report for an entry point with a thread-block-cluster body
// (tt_gn_silu_fwd, tt_gn_silu_bwd, tt_gn_bwd_stats): its wrapper counts
// cluster_launches from it; and for tt_gn_bwd_apply's flat body
// (flat_launches).
constexpr int kClusterLaunched = -2;
inline int cluster_result(cudaError_t e) { return e == cudaSuccess ? kClusterLaunched : (int)e; }
constexpr int kFlatLaunched = -3;
inline int flat_result(cudaError_t e) { return e == cudaSuccess ? kFlatLaunched : (int)e; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round an f32 value to the storage type and back: the precision a value has
// after the JAX kernels' `.astype(x.dtype)`.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Elements of T in one 16-byte packet.
template <typename T> struct Pack { static constexpr int N = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load_pack(const T* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < Pack<T>::N; ++j) out[j] = to_f32(e[j]);
}

template <typename T>
__device__ __forceinline__ void store_pack(T* p, const float* in) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < Pack<T>::N; ++j) e[j] = from_f32<T>(in[j]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float silu(float y) { return y / (1.0f + expf(-y)); }

}  // namespace tt
