// Tensor-core bodies of the forward attention on Hopper's warpgroup matrix
// multiply (wgmma, sm_90a). The C entry points of attention.cu take them
// where tc_body(dtype, D, mode) holds (common.cuh):
//   * head dim 64, all three forms (tt_attn_fwd, tt_attn_fwd_v2,
//     tt_attn_fwd_bias): every attention of the full-width UNet (heads 5, 10,
//     20 over 320, 640, 1280 channels);
//   * head dim 32, the static form (tt_attn_fwd): AudioLDM's FiLM UNet, whose
//     heads are num_head_channels = 32 wide, 20 launches an evaluation.
// In each, bf16 runs attn_tc_kernel (bf16 products) and f32
// attn_tc_f32_kernel (3xTF32 products). The other head dims, and the online
// and biased forms at head dim 32 (which no path launches), keep
// attention.cu's CUDA-core body.
//
// Replaces, as that body does, tango_tpu/ops/flash_attention.py:
//   _attn_kernel (:56)      through tt_attn_fwd, the static-shift form;
//   _attn_kernel_bias (:84) through tt_attn_fwd_bias, the biased form;
//   _attn_kernel_v2 (:103)  through tt_attn_fwd_v2, the online max-subtracted form.
// The arithmetic is attention.cu's, step for step:
//   qs    = round_T(q * qscale)                (qscale = scale * log2(e), f32;
//                                               no rounding in f32)
//   s     = qs . k                             (f32 accumulation)
//   bias: s += bias * log2(e), before the max  (bias f32 (B, 1 | Sq, Skv), head
//                                               bh reads batch row bh / heads)
//   static: p = exp2(min(s - 20, 96)), denom and acc add up over key tiles,
//           o = acc / (denom == 0 ? 1 : denom)
//   online, bias: m' = max(m, max_j s_j), alpha = exp2(m - m'), p = exp2(s - m'),
//           denom = alpha * denom + sum p, acc = alpha * acc + ..., m from -1e30,
//           o = acc / denom
//   denom sums the unrounded f32 p; the PV product takes round_T(p).
// JAX walks 1024-key blocks (v2) or the whole key set (static, bias), these
// bodies 128-key (bf16) or 64-key (f32; 32-key at D = 32) tiles: for the static form that
// changes only the f32 summation order; for the online and biased forms
// round_bf16(p) is taken against the running max of the tiles so far, which
// moves the output by at most one bf16 step (tests/test_torch_attn_tc.py and
// tests/test_torch_attn_bias_tc.py emulate this walk against the JAX kernels).
// A row whose keys are all masked (bias -10000) stays finite: the max is
// subtracted. Keys past Skv get s = -inf after the bias is added.
//
// What bounds it on the H100: operations. A query row does 4*Skv*D flops
// against 8*D bytes of q and o (k and v are shared by the rows of a head),
// far above the card's ~295 bf16 flops a byte. The softmax's one exp2 per
// logit runs on the multi-function units, 16 a clock an SM (about 4.2e12 a
// second over 132 SMs): at D = 64 it costs about as long as the logit's 256
// tensor-core flops, at D = 32 (128 flops a logit) about twice as long, so
// there the softmax sets the floor, ~1.8x the tensor-core bound. What the
// bf16 design does about it:
//   * Both products run on the tensor cores in bf16 with f32 accumulation:
//     S = Q K^T as wgmma m64n128k16 with both operands read from shared
//     memory through descriptors (Q is A and K is B, both K-major: K is
//     stored (keys, D), no transpose), D/16 k-steps over D; O += P V as wgmma
//     m64nDk16 in its register-A form, 8 k-steps over 128 keys, with V as B
//     stored (keys, D), which is MN-major, so B is transposed (imm-trans-b).
//   * P never leaves registers: the m64nNk16 f32 accumulator layout, packed
//     in pairs to bf16x2, is the k16 A-fragment layout (FlashAttention-3's
//     observation), so s[8kk .. 8kk+7] become the four A registers of
//     k-step kk. The softmax runs on the accumulator fragments: a row's 128
//     values lie in the 4 threads of a quad, so a row max takes 2 shuffles;
//     the denominators stay per thread and are summed over the quad once,
//     at the end. The bias is read per fragment (the thread's two rows, its
//     key columns) from device memory, where L1 serves the rows a block
//     shares: the path passes one bias row per batch row.
//   * A block of 2 warpgroups (256 threads) owns 128 query rows of one
//     (b*h); the Q tile is staged once, scaled and rounded on the way in. K
//     and V tiles of 128 keys sit in a 2-stage ring, filled by cp.async
//     16-byte copies (zero-fill past Skv, so the padding of V is 0, not
//     garbage that 0 * NaN would carry into O); tile j+1 is in flight while
//     tile j is computed, and one barrier a tile serves both "tile j has
//     landed" and "slot (j+1) % 2 is free". Every tile is swizzled at its
//     row width (Swizzle), so both wgmma's reads and the staging writes are
//     free of bank conflicts: at D = 64 a row is 128 bytes (the 128-byte
//     swizzle, chunk c of row r at c ^ (r % 8)), at D = 32 64 bytes (the
//     64-byte swizzle, c ^ ((r / 2) % 4); the descriptors' layout type, SBO
//     and MN-major stride follow it). 2 blocks an SM (registers <= 128), so
//     one block's softmax overlaps the other's products: 80 KB a block at
//     D = 64, 40 KB at D = 32.
//   * At D = 32 the softmax, not the products, sets the floor, and these
//     were measured on the card (scripts/attn_d32_variants.py): the shared
//     memory D = 32 frees buys nothing, a 3- or 4-stage ring times the same
//     as 2 and a third block an SM needs 90+ registers (ptxas refuses the
//     80 it would have); skewing the two warpgroups by half a tile, so that
//     one's softmax runs while the other's products do (FlashAttention-3's
//     ping-pong through the one barrier a tile), was 9% slower. The
//     softmax's exp2 stays on the multi-function units: by count a logit
//     issues 6-7 instructions, about the 8 issue slots an exp2 takes at the
//     units' full rate, so a polynomial on the FMA pipes (FlashAttention-4)
//     would move the limit to instruction issue, not past it (not tried).
// The f32 body (all three forms at D = 64, the static one at D = 32; the
// online and biased ones take s + e, the cross terms added, as the logit
// before the running max, the biased one with (bias - c) * log2(e) as the
// logit accumulator's initial value, c the row's largest bias, which softmax
// does not see: the products then add onto a value near 0 wherever a row has
// a key worth weighting, and not onto -14427 in a row whose keys are all
// masked, where each addition would keep 2^-10 of absolute precision (~1e-3
// on such a row's output, ten times the plain version's error, measured); and
// rescale acc before its P V products are issued, while e, the P V cross
// terms, starts afresh each tile) holds JAX's f32 limits (atol 2e-5, rtol
// 1e-4): one-product TF32 misses them at unit amplitude, and 3xTF32 logits
// with split-bf16 P V miss them with q and k at amplitude 3, so both products
// run in 3xTF32 (wgmma.cuh: hi/lo splits, the cross terms in their own
// accumulator); its bound is the tensor cores' 3xTF32 rate (165 TFLOP/s),
// with the exp2 floor below it:
//   * S = Qs K^T as wgmma m64nNCk8 .tf32, both operands rows operands in
//     shared memory; O += P V with P split in registers (Tf32A) and V staged
//     transposed (a cols operand: .tf32 takes only K-major B, and cannot
//     transpose V through the descriptor as bf16 does).
//   * The splits are made on the way into shared memory, which cp.async
//     cannot do: the next tile's raw chunks are loaded into registers during
//     the current tile, split and stored into the other of 2 stages while
//     the P V products run, one barrier a tile. At D = 64, Q hi/lo (128 rows,
//     64 KB) plus 2 stages of K and V^T hi/lo at 64 keys (64 KB a stage):
//     192 KB, one block an SM. At D = 32 a row is 128 bytes, one swizzle
//     atom: Q hi/lo is 32 KB and a stage of 32 keys 16 KB, 65 KB a block
//     and 110 registers a thread, so 2 blocks an SM, and one block's
//     softmax and staging overlap the other's products (64-key tiles took
//     128 registers and spilled 208 bytes, 16% slower).
// Headroom left for later: TMA loads with mbarriers from a producer warp,
// and ping-pong scheduling of the two warpgroups with their own barriers
// (FlashAttention-3), instead of the block-wide barrier a tile.
//
// Layout: q, o (BH, Sq, D) and k, v (BH, Skv, D), contiguous, 16-byte
// aligned, as the bias (the wrappers check). One block per (b*h, 128-row
// query tile), flattened onto grid.x. Rows past Sq are zero in shared memory
// and not stored; keys past Skv get s = -inf, so p = 0. Element offsets are
// 64-bit.

#include <math_constants.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace tt {
namespace {

constexpr int kRows = 128;               // query rows a block, 64 a warpgroup
constexpr int kKeys = 128;               // keys a K/V tile (bf16)
constexpr int kThreads = 256;            // two warpgroups
constexpr int kMinBlocks = 2;            // blocks an SM (registers <= 128 a thread)
constexpr int kStages = 2;               // K/V tiles in the ring
constexpr float kShift = 20.0f;
constexpr float kClamp = 96.0f;
constexpr float kLog2e = 1.4426950408889634f;

// The bf16 tiles' swizzle by head dim D: a row of Q, K or V is 2D bytes, one
// swizzle atom of that width (128 bytes at D = 64, 64 at D = 32), of
// 1 << kChunkBits 16-byte chunks.
template <int D> struct Swizzle;
template <> struct Swizzle<64> {
  static constexpr uint64_t kLayout = kSwizzle128;
  static constexpr int kChunkBits = 3;
  static __device__ __forceinline__ uint32_t at(int r, int c) { return sw128(r, c); }
};
template <> struct Swizzle<32> {
  static constexpr uint64_t kLayout = kSwizzle64;
  static constexpr int kChunkBits = 2;
  static __device__ __forceinline__ uint32_t at(int r, int c) { return sw64(r, c); }
};
// bytes of the Q tile and of a K or V tile
template <int D> constexpr int kTile = kKeys * D * 2;
// Q, K[kStages], V[kStages], and room to align the base to 1024 bytes
template <int D> constexpr int kSmem = (1 + 2 * kStages) * kTile<D> + 1024;

// The f32 body's geometry by head dim D: NC-key tiles, kMinBlocks blocks an
// SM; Q hi/lo (a rows operand), then 2 stages of K hi/lo (a rows operand)
// and V^T hi/lo (a cols operand), 4 bytes each of hi and lo an element.
template <int D> struct F32Geo;
template <> struct F32Geo<64> {
  static constexpr int NC = 64;
  static constexpr int kMinBlocks = 1;
};
template <> struct F32Geo<32> {
  static constexpr int NC = 32;
  static constexpr int kMinBlocks = 2;
};
template <int D> constexpr int kF32Q = 8 * kRows * D;                        // 64 KB at D = 64
template <int D> constexpr int kF32K = 8 * F32Geo<D>::NC * D;                // 32 KB at D = 64
template <int D> constexpr int kF32Stage = kF32K<D> + 8 * D * F32Geo<D>::NC;  // + V^T
template <int D> constexpr int kF32Smem = kF32Q<D> + 2 * kF32Stage<D> + 1024;

// The bias operand of the biased form: bias[(bh / heads) * rows * Skv + row * Skv + key].
struct Bias {
  const float* ptr;
  int heads;
  int rows;  // 1 (one row for every query) or Sq
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

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

// The online (and biased) softmax step on a thread's N accumulator values s
// of rows r0 (s[4b], s[4b+1]) and r1 (s[4b+2], s[4b+3]): new running maxes
// m0, m1, the accumulator acc and the denominators l0, l1 rescaled, s
// replaced by p = exp2(s - m).
template <int N>
__device__ __forceinline__ void online_step(float (&s)[N], float (&acc)[32], float& m0, float& m1,
                                            float& l0, float& l1) {
  float t0 = -CUDART_INF_F, t1 = -CUDART_INF_F;
#pragma unroll
  for (int b = 0; b < N / 4; ++b) {
    t0 = fmaxf(t0, fmaxf(s[4 * b], s[4 * b + 1]));
    t1 = fmaxf(t1, fmaxf(s[4 * b + 2], s[4 * b + 3]));
  }
  const float n0 = fmaxf(m0, quad_max(t0)), n1 = fmaxf(m1, quad_max(t1));
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
  for (int b = 0; b < N / 4; ++b) {
    s[4 * b] = exp2f(s[4 * b] - n0);
    s[4 * b + 1] = exp2f(s[4 * b + 1] - n0);
    s[4 * b + 2] = exp2f(s[4 * b + 2] - n1);
    s[4 * b + 3] = exp2f(s[4 * b + 3] - n1);
  }
}

// O += P V for one k16 step of 16 keys: P the k16 A fragment, V the MN-major
// B at descriptor b; acc the m64nD accumulator.
__device__ __forceinline__ void wgmma_pv(float (&acc)[32], const uint32_t (&p)[4], uint64_t b) {
  wgmma_rs64(acc, p, b);
}
__device__ __forceinline__ void wgmma_pv(float (&acc)[16], const uint32_t (&p)[4], uint64_t b) {
  wgmma_rs32(acc, p, b);
}

// Accumulator layout of m64nNk16 (f32), per thread of a warpgroup: warp w,
// lane l, quad position t = l % 4; rows r0 = 16w + l/4 and r1 = r0 + 8;
// d[4b + e] holds row (e < 2 ? r0 : r1), column 8b + 2t + (e & 1).
template <int MODE, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
attn_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Bias bias,
               int Sq, int Skv, float qscale) {
  using G = Swizzle<D>;
  constexpr int kT = kTile<D>;
  constexpr int kRowBytes = 2 * D, kChunks = D / 8;  // a row's bytes, its 16-byte chunks
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 (or 512) bytes: align the tiles to it
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const qtile = smem_raw + (base - raw);
  const uint32_t sQ = base, sK = base + kT, sV = sK + kStages * kT;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t4 = lane & 3;
  const int tiles = (Sq + kRows - 1) / kRows;
  const int64_t head = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kRows;
  const __nv_bfloat16* kh = k + head * Skv * D;
  const __nv_bfloat16* vh = v + head * Skv * D;
  const int n_tiles = (Skv + kKeys - 1) / kKeys;
  const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;

  // the bias rows of r0 and r1 (a ragged row past Sq reads row Sq - 1)
  const float* b0 = nullptr;
  const float* b1 = nullptr;
  if constexpr (MODE == kBias) {
    const float* bb = bias.ptr + (head / bias.heads) * (int64_t)bias.rows * Skv;
    b0 = bb + (bias.rows == 1 ? 0 : (int64_t)min(r0, Sq - 1) * Skv);
    b1 = bb + (bias.rows == 1 ? 0 : (int64_t)min(r1, Sq - 1) * Skv);
  }

  auto load_kv = [&](int j) {  // tile j into ring slot j % kStages
    const int k0 = j * kKeys, slot = j % kStages;
#pragma unroll
    for (int it = 0; it < kKeys * kChunks / kThreads; ++it) {
      const int r = (tid >> G::kChunkBits) + it * (kThreads / kChunks), c = tid & (kChunks - 1);
      const bool in = k0 + r < Skv;
      const int64_t g = in ? (int64_t)(k0 + r) * D + c * 8 : 0;
      const uint32_t off = slot * kT + G::at(r, c);
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
    const __nv_bfloat16* qh = q + head * Sq * D;
#pragma unroll
    for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
      const int r = (tid >> G::kChunkBits) + it * (kThreads / kChunks), c = tid & (kChunks - 1);
      uint4 pk = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < Sq) pk = *reinterpret_cast<const uint4*>(qh + (int64_t)(q0 + r) * D + c * 8);
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&pk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        h2[e] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
      }
      *reinterpret_cast<uint4*>(qtile + G::at(r, c)) = pk;
    }
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m0 = -1e30f, m1 = -1e30f;  // running row maxes (kOnline, kBias)
  float l0 = 0.0f, l1 = 0.0f;      // this thread's share of the two denominators
  // this warpgroup's 64 Q rows (K-major; 8-row groups 8 * kRowBytes apart);
  // a k16 step advances 32 bytes along D
  const uint64_t dq = smem_desc(sQ + wg * 64 * kRowBytes, 16, 8 * kRowBytes, G::kLayout);

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
    const uint64_t dk = smem_desc(sK + slot * kT, 16, 8 * kRowBytes, G::kLayout);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_qk(s, dq + 2 * kk, dk + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const int lim = Skv - j * kKeys;  // keys of this tile that exist
    if constexpr (MODE == kBias) {
      const int k0 = j * kKeys;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = 8 * (i >> 2) + 2 * t4 + (i & 1);
        s[i] = col < lim ? s[i] + __ldg(((i & 2) ? b1 : b0) + k0 + col) * kLog2e : -CUDART_INF_F;
      }
    } else if (lim < kKeys) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (8 * (i >> 2) + 2 * t4 + (i & 1) >= lim) s[i] = -CUDART_INF_F;
    }

    if constexpr (MODE == kStatic) {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = exp2f(fminf(s[i] - kShift, kClamp));
    } else {
      online_step(s, acc, m0, m1, l0, l1);
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
    // V as the MN-major B: 8-key groups 8 * kRowBytes apart along K, one
    // swizzle atom along D; a k16 step advances 16 keys
    const uint64_t dv = smem_desc(sV + slot * kT, 8 * kRowBytes, 8 * kRowBytes, G::kLayout);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) wgmma_pv(acc, p[kk], dv + kk * (16 * kRowBytes >> 4));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if constexpr (MODE == kStatic) {
    l0 = l0 == 0.0f ? 1.0f : l0;  // an underflowed row is a zero row
    l1 = l1 == 0.0f ? 1.0f : l1;
  }
  __nv_bfloat16* oh = o + head * Sq * D + 2 * t4;
#pragma unroll
  for (int b = 0; b < D / 8; ++b) {
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(oh + (int64_t)r0 * D + 8 * b) =
          pack_bf16(acc[4 * b] / l0, acc[4 * b + 1] / l0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(oh + (int64_t)r1 * D + 8 * b) =
          pack_bf16(acc[4 * b + 2] / l1, acc[4 * b + 3] / l1);
  }
}

// Raw chunk c (f32 head dims 4c .. 4c+3) of row `row` of an (S, D) head, zeros past S.
template <int D>
__device__ __forceinline__ uint4 load_chunk(const float* head, int row, int c, int S) {
  if (row >= S) return make_uint4(0u, 0u, 0u, 0u);
  return *reinterpret_cast<const uint4*>(head + (int64_t)row * D + c * 4);
}

// The three forms in f32 on 3xTF32 products (see the note at the top).
template <int MODE, int D>
__global__ void __launch_bounds__(kThreads, F32Geo<D>::kMinBlocks)
attn_tc_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, Bias bias, int Sq,
                   int Skv, float qscale) {
  constexpr int NC = F32Geo<D>::NC, kChunks = D / 4;  // keys a tile, 16-byte chunks a row
  static_assert(NC == D, "S and P V share the cross-term accumulator");
  constexpr int kPer = NC * kChunks / kThreads;       // raw chunks a thread, each of K, V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t4 = lane & 3;
  const int tiles = (Sq + kRows - 1) / kRows;
  const int64_t head = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kRows;
  const float* kh = k + head * Skv * D;
  const float* vh = v + head * Skv * D;
  const int n = (Skv + NC - 1) / NC;

  // the bias rows of this thread's rows r and r + 8 (a ragged row past Sq
  // reads row Sq - 1)
  const float* b0 = nullptr;
  const float* b1 = nullptr;
  if constexpr (MODE == kBias) {
    const int r = q0 + wg * 64 + warp * 16 + (lane >> 2);
    const float* bb = bias.ptr + (head / bias.heads) * (int64_t)bias.rows * Skv;
    b0 = bb + (bias.rows == 1 ? 0 : (int64_t)min(r, Sq - 1) * Skv);
    b1 = bb + (bias.rows == 1 ? 0 : (int64_t)min(r + 8, Sq - 1) * Skv);
  }
  // the largest bias of each of the two rows (the 4 threads of a quad share
  // them; one bias row serves both where the batch row has one), taken off
  // the bias below
  float c0 = -CUDART_INF_F, c1 = -CUDART_INF_F;
  if constexpr (MODE == kBias) {
    for (int col = t4; col < Skv; col += 4) c0 = fmaxf(c0, __ldg(b0 + col));
    if (bias.rows > 1)
      for (int col = t4; col < Skv; col += 4) c1 = fmaxf(c1, __ldg(b1 + col));
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      c0 = fmaxf(c0, __shfl_xor_sync(0xffffffffu, c0, o));
      c1 = fmaxf(c1, __shfl_xor_sync(0xffffffffu, c1, o));
    }
    if (bias.rows == 1) c1 = c0;
  }

  // the next tile's raw chunks, rows fastest: a warp holds 32 keys of one chunk
  uint4 rk[kPer], rv[kPer];
  auto load = [&](int j) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int y = tid + i * kThreads, r = j * NC + y % NC, c = y / NC;
      rk[i] = load_chunk<D>(kh, r, c, Skv);
      rv[i] = load_chunk<D>(vh, r, c, Skv);
    }
  };
  auto stage = [&](int slot) {
    uint8_t* st = gbase + kF32Q<D> + slot * kF32Stage<D>;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int y = tid + i * kThreads, r = y % NC, c = y / NC;
      stage_tf32_rows<D>(st, NC, r, c, rk[i]);
      stage_tf32_cols<D>(st + kF32K<D>, NC, r, c, rv[i]);
    }
  };

  load(0);
  {  // Q, scaled by qscale in f32 and split on the way in
    const float* qh = q + head * Sq * D;
    for (int x = tid; x < kRows * kChunks; x += kThreads) {
      const int r = x >> (D == 64 ? 4 : 3), c = x & (kChunks - 1);
      stage_tf32_rows<D>(gbase, kRows, r, c, load_chunk<D>(qh, q0 + r, c, Sq), qscale);
    }
  }
  stage(0);
  fence_async_proxy();
  __syncthreads();
  if (n > 1) load(1);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m0 = -1e30f, m1 = -1e30f;  // running row maxes (kOnline, kBias)
  float l0 = 0.0f, l1 = 0.0f;      // this thread's share of the two denominators

  for (int j = 0; j < n; ++j) {
    const uint32_t sK = base + kF32Q<D> + (j & 1) * kF32Stage<D>, sV = sK + kF32K<D>;
    const int k0 = j * NC, lim = Skv - k0;  // the tile's first key, its keys that exist
    // S, then P; the cross terms of S, then those of P V (NC == D)
    float s[NC / 2], e[NC / 2];
    if constexpr (MODE == kBias) {
      // (bias - c) * log2(e) is the logit accumulator's initial value: its
      // loads are in flight while Q K^T is issued, and no loaded value waits
      // in a register of its own beside S and its cross terms
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) {
        const int col = 8 * (i >> 2) + 2 * t4 + (i & 1);
        s[i] = col < lim ? (__ldg(((i & 2) ? b1 : b0) + k0 + col) - ((i & 2) ? c1 : c0)) * kLog2e
                         : 0.0f;
      }
      fence_regs(s);
    }
    wgmma_fence();
    mma_tf32x3_ss<NC, D>(s, e, base, kRows, wg * 64, sK, MODE == kBias);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(e);

    if constexpr (MODE == kStatic) {
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) {
        const bool in = 8 * (i >> 2) + 2 * t4 + (i & 1) < lim;
        s[i] = in ? exp2f(fminf(s[i] + e[i] - kShift, kClamp)) : 0.0f;
      }
    } else {
      // keys past Skv at -inf before the max: a padded logit of 0 would raise
      // the max of a row whose logits are all negative
#pragma unroll
      for (int i = 0; i < NC / 2; ++i)
        s[i] = 8 * (i >> 2) + 2 * t4 + (i & 1) < lim ? s[i] + e[i] : -CUDART_INF_F;
      online_step(s, acc, m0, m1, l0, l1);  // acc rescaled here, before P V is issued
    }
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) {
      if (i & 2) l1 += s[i];
      else l0 += s[i];
    }
    Tf32A<NC> a;
    a.pack(s);
    fence_regs(acc);
    wgmma_fence();
    mma_tf32x3_rs<NC, D>(acc, e, a, sV);
    wgmma_commit();
    // while the P V products run: stage tile j + 1 into the other stage (free
    // since the barrier that ended tile j - 1), then load tile j + 2
    if (j + 1 < n) {
      stage((j + 1) & 1);
      fence_async_proxy();
      if (j + 2 < n) load(j + 2);
    }
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(e);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += e[i];
    __syncthreads();  // tile j + 1 is staged, and no warpgroup reads tile j any more
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if constexpr (MODE == kStatic) {
    l0 = l0 == 0.0f ? 1.0f : l0;  // an underflowed row is a zero row
    l1 = l1 == 0.0f ? 1.0f : l1;
  }
  const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  float* oh = o + head * Sq * D + 2 * t4;
#pragma unroll
  for (int b = 0; b < D / 8; ++b) {
    if (r0 < Sq)
      *reinterpret_cast<float2*>(oh + (int64_t)r0 * D + 8 * b) =
          make_float2(acc[4 * b] / l0, acc[4 * b + 1] / l0);
    if (r1 < Sq)
      *reinterpret_cast<float2*>(oh + (int64_t)r1 * D + 8 * b) =
          make_float2(acc[4 * b + 2] / l1, acc[4 * b + 3] / l1);
  }
}

template <typename K>
cudaError_t prepare(K kernel, int smem, int64_t blocks) {
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int MODE, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, Bias bias, int BH,
                   int Sq, int Skv, float qscale, cudaStream_t st) {
  const int64_t blocks = (int64_t)BH * ((Sq + kRows - 1) / kRows);
  cudaError_t e = prepare(attn_tc_kernel<MODE, D>, kSmem<D>, blocks);
  if (e != cudaSuccess) return e;
  attn_tc_kernel<MODE, D><<<(unsigned)blocks, kThreads, kSmem<D>, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), bias, Sq, Skv,
      qscale);
  return cudaGetLastError();
}

template <int MODE, int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, Bias bias, int BH,
                       int Sq, int Skv, float qscale, cudaStream_t st) {
  const int64_t blocks = (int64_t)BH * ((Sq + kRows - 1) / kRows);
  cudaError_t e = prepare(attn_tc_f32_kernel<MODE, D>, kF32Smem<D>, blocks);
  if (e != cudaSuccess) return e;
  attn_tc_f32_kernel<MODE, D><<<(unsigned)blocks, kThreads, kF32Smem<D>, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), bias, Sq, Skv, qscale);
  return cudaGetLastError();
}

}  // namespace

cudaError_t attn_fwd_tc(const void* q, const void* k, const void* v, const float* bias,
                        int heads, int bias_rows, void* o, int BH, int Sq, int Skv, int D,
                        float qscale, int mode, bool f32, cudaStream_t st) {
  const Bias b{bias, heads, bias_rows};
  if (D == 32) {  // the static form alone (tc_body)
    if (mode != kStatic) return cudaErrorInvalidValue;
    return f32 ? launch_f32<kStatic, 32>(q, k, v, o, b, BH, Sq, Skv, qscale, st)
               : launch<kStatic, 32>(q, k, v, o, b, BH, Sq, Skv, qscale, st);
  }
  if (D != 64) return cudaErrorInvalidValue;
  if (f32) {
    switch (mode) {
      case kStatic: return launch_f32<kStatic, 64>(q, k, v, o, b, BH, Sq, Skv, qscale, st);
      case kOnline: return launch_f32<kOnline, 64>(q, k, v, o, b, BH, Sq, Skv, qscale, st);
      case kBias: return launch_f32<kBias, 64>(q, k, v, o, b, BH, Sq, Skv, qscale, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (mode) {
    case kStatic: return launch<kStatic, 64>(q, k, v, o, b, BH, Sq, Skv, qscale, st);
    case kOnline: return launch<kOnline, 64>(q, k, v, o, b, BH, Sq, Skv, qscale, st);
    case kBias: return launch<kBias, 64>(q, k, v, o, b, BH, Sq, Skv, qscale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tt
