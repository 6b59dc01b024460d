// Tensor-core body of the bias-free forward attention: bf16 q, k, v, o at head
// dim 64, on Hopper's warpgroup matrix multiply (wgmma, sm_90a). The C entry
// points tt_attn_fwd and tt_attn_fwd_v2 (attention.cu) take it where
// tc_body(dtype, D) holds: bf16 and D == 64, every attention of the
// full-width UNet (heads 5, 10, 20 over 320, 640, 1280 channels). f32 (the
// trainer's type), other head dims and the biased form keep attention.cu's
// CUDA-core body: one-product TF32 wgmma cannot meet JAX's f32 limits, and
// the 3xTF32 split that can (attention_bwd_tc.cu's logit products) is not in
// this body.
//
// Replaces, as that body does, tango_tpu/ops/flash_attention.py:
//   _attn_kernel (:56)     through tt_attn_fwd, the static-shift form;
//   _attn_kernel_v2 (:103) through tt_attn_fwd_v2, the online max-subtracted form.
// The arithmetic is attention.cu's, step for step:
//   qs    = round_bf16(q * qscale)             (qscale = scale * log2(e), f32)
//   s     = qs . k                             (f32 accumulation)
//   static: p = exp2(min(s - 20, 96)), denom and acc add up over key tiles,
//           o = acc / (denom == 0 ? 1 : denom)
//   online: m' = max(m, max_j s_j), alpha = exp2(m - m'), p = exp2(s - m'),
//           denom = alpha * denom + sum p, acc = alpha * acc + ..., m from -1e30,
//           o = acc / denom
//   denom sums the unrounded f32 p; the PV product takes round_bf16(p).
// JAX walks 1024-key blocks (v2) or the whole key set (static), this body
// 128-key tiles: for the static form that changes only the f32 summation
// order; for the online form round_bf16(p) is taken against the running max
// of the tiles so far, which moves the output by at most one bf16 step
// (tests/test_torch_attn_tc.py emulates this walk against both JAX kernels).
//
// What bounds it on the H100: operations. A query row does 4*Skv*D flops
// against 8*D bytes of q and o (k and v are shared by the rows of a head),
// far above the card's ~295 bf16 flops a byte, and at D = 64 the softmax's
// one exp2 per logit costs the multi-function units about as long as the
// logit's 256 tensor-core flops. What the design does about it:
//   * Both products run on the tensor cores in bf16 with f32 accumulation:
//     S = Q K^T as wgmma m64n128k16 with both operands read from shared
//     memory through descriptors (Q is A and K is B, both K-major: K is
//     stored (keys, D), no transpose), 4 k-steps over D; O += P V as wgmma
//     m64n64k16 in its register-A form, 8 k-steps over 128 keys, with V as B
//     stored (keys, D), which is MN-major, so B is transposed (imm-trans-b).
//   * P never leaves registers: the m64nNk16 f32 accumulator layout, packed
//     in pairs to bf16x2, is the k16 A-fragment layout (FlashAttention-3's
//     observation), so s[8kk .. 8kk+7] become the four A registers of
//     k-step kk. The softmax runs on the accumulator fragments: a row's 128
//     values lie in the 4 threads of a quad, so a row max takes 2 shuffles;
//     the denominators stay per thread and are summed over the quad once,
//     at the end.
//   * A block of 2 warpgroups (256 threads) owns 128 query rows of one
//     (b*h); the Q tile (16 KB) is staged once, scaled and rounded on the
//     way in. K and V tiles of 128 keys x 64 (16 KB each) sit in a 2-stage
//     ring, filled by cp.async 16-byte copies (zero-fill past Skv, so the
//     padding of V is 0, not garbage that 0 * NaN would carry into O); tile
//     j+1 is in flight while tile j is computed, and one barrier a tile
//     serves both "tile j has landed" and "slot (j+1) % 2 is free". All
//     tiles use the 128-byte swizzle (chunk c of row r at c ^ (r % 8)), so
//     both wgmma's reads and the staging writes are free of bank conflicts.
//     80 KB of shared memory a block: 2 blocks an SM, so one block's softmax
//     overlaps the other's products.
// Headroom left for later: TMA loads with mbarriers from a producer warp,
// and ping-pong scheduling of the two warpgroups' softmax against the other
// one's wgmma (FlashAttention-3), instead of the block-wide barrier a tile.
//
// Layout: q, o (BH, Sq, 64) and k, v (BH, Skv, 64) bf16, contiguous, 16-byte
// aligned (the wrapper checks). One block per (b*h, 128-row query tile),
// flattened onto grid.x. Rows past Sq are zero in shared memory and not
// stored; keys past Skv get s = -inf, so p = 0. Element offsets are 64-bit.

#include <math_constants.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace tt {
namespace {

constexpr int kD = 64;                   // head dim of this body
constexpr int kRows = 128;               // query rows a block, 64 a warpgroup
constexpr int kKeys = 128;               // keys a K/V tile
constexpr int kThreads = 256;            // two warpgroups
constexpr int kMinBlocks = 2;            // blocks an SM (registers <= 128 a thread)
constexpr int kStages = 2;               // K/V tiles in the ring
constexpr int kTile = kKeys * kD * 2;    // bytes of the Q tile and of a K or V tile
// Q, K[kStages], V[kStages], and room to align the base to 1024 bytes
constexpr int kSmem = (1 + 2 * kStages) * kTile + 1024;
constexpr float kShift = 20.0f;
constexpr float kClamp = 96.0f;

// d (+)= A B^T for one k16 step: A 64 x 16 and B 128 x 16, bf16, both K-major
// in shared memory; d is the m64n128 f32 accumulator (overwritten if !acc).
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : TT_ACC8(0), TT_ACC8(8), TT_ACC8(16), TT_ACC8(24), TT_ACC8(32), TT_ACC8(40),
        TT_ACC8(48), TT_ACC8(56)
      : "l"(a), "l"(b), "r"(acc));
}

// Accumulator layout of m64nNk16 (f32), per thread of a warpgroup: warp w,
// lane l, quad position t = l % 4; rows r0 = 16w + l/4 and r1 = r0 + 8;
// d[4b + e] holds row (e < 2 ? r0 : r1), column 8b + 2t + (e & 1).
template <bool ONLINE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
attn_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq,
               int Skv, float qscale) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const qtile = smem_raw + (base - raw);
  const uint32_t sQ = base, sK = base + kTile, sV = sK + kStages * kTile;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t4 = lane & 3;
  const int tiles = (Sq + kRows - 1) / kRows;
  const int64_t head = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kRows;
  const __nv_bfloat16* kh = k + head * Skv * kD;
  const __nv_bfloat16* vh = v + head * Skv * kD;
  const int n_tiles = (Skv + kKeys - 1) / kKeys;

  auto load_kv = [&](int j) {  // tile j into ring slot j % kStages
    const int k0 = j * kKeys, slot = j % kStages;
#pragma unroll
    for (int it = 0; it < kKeys * 8 / kThreads; ++it) {
      const int r = (tid >> 3) + it * (kThreads / 8), c = tid & 7;
      const bool in = k0 + r < Skv;
      const int64_t g = in ? (int64_t)(k0 + r) * kD + c * 8 : 0;
      const uint32_t off = slot * kTile + sw128(r, c);
      cp_async16(sK + off, kh + g, in ? 16 : 0);
      cp_async16(sV + off, vh + g, in ? 16 : 0);
    }
  };
  // one copy group per tile, empty past the last, so that "tile j has landed"
  // is always "at most kStages - 2 groups pending" at iteration j
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_kv(j);
    cp_async_commit();
  }

  // Q: scaled by qscale in f32 and rounded to bf16 on the way in
  {
    const __nv_bfloat16* qh = q + head * Sq * kD;
#pragma unroll
    for (int it = 0; it < kRows * 8 / kThreads; ++it) {
      const int r = (tid >> 3) + it * (kThreads / 8), c = tid & 7;
      uint4 pk = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < Sq) pk = *reinterpret_cast<const uint4*>(qh + (int64_t)(q0 + r) * kD + c * 8);
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&pk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        h2[e] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
      }
      *reinterpret_cast<uint4*>(qtile + sw128(r, c)) = pk;
    }
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  float m0 = -1e30f, m1 = -1e30f;  // running row maxes (ONLINE)
  float l0 = 0.0f, l1 = 0.0f;      // this thread's share of the two denominators
  // this warpgroup's 64 Q rows; a k16 step advances 32 bytes along D
  const uint64_t dq = smem_desc(sQ + wg * 64 * 128, 16, 1024);

  for (int j = 0; j < n_tiles; ++j) {
    const int slot = j % kStages;
    cp_async_wait<kStages - 2>();
    fence_async_proxy();
    // tile j (and Q) are in shared memory, visible to wgmma; and every thread
    // is done with tile j - 1, whose slot the next copy may refill
    __syncthreads();
    if (j + kStages - 1 < n_tiles) load_kv(j + kStages - 1);  // in flight during tile j
    cp_async_commit();

    float s[64];
    const uint64_t dk = smem_desc(sK + slot * kTile, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) wgmma_qk(s, dq + 2 * kk, dk + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const int lim = Skv - j * kKeys;  // keys of this tile that exist
    if (lim < kKeys) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (8 * (i >> 2) + 2 * t4 + (i & 1) >= lim) s[i] = -CUDART_INF_F;
    }

    if constexpr (ONLINE) {
      float t0 = -CUDART_INF_F, t1 = -CUDART_INF_F;
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        t0 = fmaxf(t0, fmaxf(s[4 * b], s[4 * b + 1]));
        t1 = fmaxf(t1, fmaxf(s[4 * b + 2], s[4 * b + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, off));
        t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, off));
      }
      const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
      const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      l0 *= a0;
      l1 *= a1;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        acc[4 * b] *= a0;
        acc[4 * b + 1] *= a0;
        acc[4 * b + 2] *= a1;
        acc[4 * b + 3] *= a1;
      }
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        s[4 * b] = exp2f(s[4 * b] - n0);
        s[4 * b + 1] = exp2f(s[4 * b + 1] - n0);
        s[4 * b + 2] = exp2f(s[4 * b + 2] - n1);
        s[4 * b + 3] = exp2f(s[4 * b + 3] - n1);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = exp2f(fminf(s[i] - kShift, kClamp));
    }
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      l0 += s[4 * b] + s[4 * b + 1];
      l1 += s[4 * b + 2] + s[4 * b + 3];
    }

    // P in registers: the accumulator pairs of keys 16kk .. 16kk+15 are the
    // A fragment of k-step kk
    uint32_t p[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
      fence_regs(p[kk]);
    }
    fence_regs(acc);
    const uint64_t dv = smem_desc(sV + slot * kTile, 1024, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) wgmma_rs64(acc, p[kk], dv + kk * (16 * 128 >> 4));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if constexpr (!ONLINE) {
    l0 = l0 == 0.0f ? 1.0f : l0;  // an underflowed row is a zero row
    l1 = l1 == 0.0f ? 1.0f : l1;
  }
  const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  __nv_bfloat16* oh = o + head * Sq * kD + 2 * t4;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(oh + (int64_t)r0 * kD + 8 * b) =
          pack_bf16(acc[4 * b] / l0, acc[4 * b + 1] / l0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(oh + (int64_t)r1 * kD + 8 * b) =
          pack_bf16(acc[4 * b + 2] / l1, acc[4 * b + 3] / l1);
  }
}

template <bool ONLINE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv,
                   float qscale, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(attn_tc_kernel<ONLINE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (int64_t)BH * ((Sq + kRows - 1) / kRows);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  attn_tc_kernel<ONLINE><<<(unsigned)blocks, kThreads, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Skv, qscale);
  return cudaGetLastError();
}

}  // namespace

cudaError_t attn_fwd_tc(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                        int Skv, float qscale, bool online, cudaStream_t st) {
  return online ? launch<true>(q, k, v, o, BH, Sq, Skv, qscale, st)
                : launch<false>(q, k, v, o, BH, Sq, Skv, qscale, st);
}

}  // namespace tt
