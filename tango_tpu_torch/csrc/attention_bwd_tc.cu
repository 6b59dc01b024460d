// Tensor-core body of the attention backward: attn_bwd_dq and attn_bwd_dkv in
// f32 and bf16 at head dim 64, on Hopper's warpgroup matrix multiply (wgmma,
// sm_90a). The C entry points tt_attn_bwd_dq and tt_attn_bwd_dkv
// (attention_bwd.cu) take it where bwd_tc_body(dtype, D) holds: f32 or bf16
// at D == 64, every attention of the full-width UNet (heads 5, 10, 20 over
// 320, 640, 1280 channels), in the trainer's f32 as in bf16. Other head dims
// keep attention_bwd.cu's CUDA-core body.
//
// Replaces, as that body does, tango_tpu/ops/flash_attention.py:
//   _bwd_dq_kernel (:231)  through tt_attn_bwd_dq;
//   _bwd_dkv_kernel (:259) through tt_attn_bwd_dkv.
// The arithmetic is theirs: the gradient of the exact max-subtracted softmax,
// recomputed from q, k and v alone (no saved forward state), with their
// roundings for bf16 inputs (ds to bf16 before both products that take it,
// p to dO's type before dV = p^T dO):
//   s = (q . k) * scale, p = exp(s - lse), dp = dO . v, delta = sum_j p dp,
//   ds = p (dp - delta) scale, dq = ds . k, dk = ds^T . q, dv = p^T . dO.
// Internally the softmax runs in base 2 (t = (q . k) * scale * log2 e,
// p = exp2(t - lse * log2 e)); lse leaves and enters in natural units.
//
// The products, and why each has its type. Five products per head, two of
// them logits (S = Q K^T, dP = dO V^T; in dkv S^T = K Q^T, dP^T = V dO^T)
// and three gradients (dQ = dS K, dK = dS^T Q, dV = P^T dO).
//   * f32 inputs are the trainer's type, held to JAX's f32 limits (atol 1e-4,
//     rtol 1e-3). All five products run in 3xTF32 (wgmma.cuh): each operand
//     x splits into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and
//     wgmma m64nNk8 .tf32 runs a_hi b_hi into one f32 accumulator and
//     a_hi b_lo + a_lo b_hi into a second, added in f32 (the gradients' per
//     tile, into the running sum). .tf32 takes K-major operands only. The
//     logits' operands are (rows, D) with D contiguous, as stored. The
//     gradients' A is the accumulator of S or S^T after the softmax, split
//     in registers (Tf32A: the accumulator's column pairs fed in kpos order);
//     their B (K, Q, dO: the contraction runs over the streamed tile's rows)
//     is staged transposed, as (D, rows) tf32 hi and lo tiles with the rows
//     in kpos order. Plain one-product TF32 misses JAX's limits, split bf16
//     on the logits fails once they are large, and split-bf16 gradient
//     products used most of the margin with q and k at amplitude 3
//     (tests/test_torch_attn_bwd_tc.py and tests/test_torch_attn_f32_tc.py
//     pin all three).
//   * bf16 inputs run each product once in bf16 (m64nNk16), logits as SS,
//     gradients as RS on ds (and p) rounded to bf16 as the JAX kernels round,
//     with B (stored (rows, D): MN-major) transposed through the descriptor.
//
// What bounds it on the H100: operations. A head does 2 S^2 D flops per
// product against 8 S D bytes (f32 q, k, v, dO). f32 has no tensor-core rate
// of its own: 3xTF32 runs at a third of TF32's 495 TFLOP/s, the rate
// chip_smoke.py bounds these kernels by. What the design does about it:
//   * All five products on the tensor cores; the (S x S) p and ds never leave
//     registers (p and ds are the A operands of the gradient products).
//   * A block of 2 warpgroups (256 threads) owns 128 rows (queries in dq, keys
//     in dkv), 64 a warpgroup, staged once; the other side streams through
//     shared memory in tiles (64 keys in dq; 32 queries in f32 dkv, 64 in
//     bf16), shared by both warpgroups. The split copies are made on the way
//     in: the f32 row side holds tf32 hi and lo of two tensors (128 KB); a
//     streamed f32 tile holds tf32 hi and lo of both tensors, plus the
//     transposed hi and lo of the tensors that are B of a gradient product
//     (96 KB in dq, 64 KB in dkv; 225.5 KB in all for f32 dq, of the 227 a
//     block may have). One stage: the next tile's raw 16-byte chunks are
//     loaded into registers while the current tile is computed, then split
//     and stored after the barrier that frees the stage; in f32 a warp
//     stages 32 consecutive rows of one chunk, which keeps the transposed
//     stores free of bank conflicts. bf16 dq (48 KB) runs 2 blocks an SM,
//     the others 1.
//   * All tiles use the 128-byte swizzle (chunk c of row r at c ^ (r % 8)).
//     An f32 row of 64 is 256 bytes, two swizzle atoms: a tile is stored as
//     two (rows, 32) halves, and a k8 step moves the descriptor by 32 bytes
//     inside its half (the bf16 row is one atom; a k16 step moves 32 bytes).
//   * dq keeps JAX's two statistics without its VMEM: pass 1 over the key
//     tiles carries an online max m, l = sum exp2(t - m) and dl = sum
//     exp2(t - m) dp, rescaled when m grows, so lse = m + log2 l and
//     delta = dl / l; pass 2 recomputes S and dP and accumulates dQ. dkv reads
//     the lse and delta that dq wrote.
// Ordering: fence.proxy.async after the st.shared writes that wgmma reads;
// wgmma.fence before each batch of products (register A and accumulators
// written by ordinary instructions); empty asm fences on the accumulators and
// the packed A registers so that the compiler neither reads an accumulator
// before wgmma.wait_group nor writes one during a product.
//
// Layout: q, dO (BH, Sq, 64), k, v (BH, Skv, 64), contiguous, 16-byte aligned
// (the wrappers check); dq, dk, dv likewise; lse, delta (BH, Sq) f32. One
// block per (b*h, 128-row tile), flattened onto grid.x. Ragged edges: rows
// past the end are zero in shared memory (so 0 x NaN never reaches an
// accumulator) and not stored; keys past Skv get p = 0 in dq; queries past
// Sq get p = 0 in dkv, their lse read as +inf. Element offsets are 64-bit.

#include <math_constants.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace tt {
namespace {

constexpr int kD = 64;          // head dim of this body
constexpr int kRows = 128;      // rows a block, 64 a warpgroup
constexpr int kThreads = 256;   // two warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Rows a streamed tile (keys in dq, queries in dkv), by input type: a
// thread's logit accumulators are half of it (m64 x cols); f32 dkv's staged
// copies would not fit shared memory at 64, nor its registers.
template <typename T> constexpr int kDqCols = 64;
template <typename T> constexpr int kDkvCols = sizeof(T) == 4 ? 32 : 64;
// Blocks an SM for dq: bf16's 48 KB of shared memory leave room for 2 (its
// registers then fit 128 a thread, with a few bytes spilled: faster on the
// H100 all the same); f32 takes 225.5 KB.
template <typename T> constexpr int kDqMinBlocks = sizeof(T) == 2 ? 2 : 1;

// What differs between the two input types.
template <typename T>
struct Body {
  static constexpr bool kSplit = sizeof(T) == 4;          // f32: 3xTF32
  static constexpr int kRowChunks = kD * sizeof(T) / 16;  // 16-byte chunks a row: 16 or 8
  // bytes of a logit operand of R rows: f32 a rows operand (tf32 hi and lo,
  // each two (R, 128-byte) halves); bf16 one (R, 128-byte) tile
  __host__ __device__ static constexpr int logit_bytes(int R) { return (kSplit ? 4 : 1) * R * 128; }
  // bytes of the transposed copy a gradient product's B needs (f32: a cols
  // operand of R columns; bf16: none, the logit tile serves)
  __host__ __device__ static constexpr int grad_bytes(int R) { return kSplit ? 512 * R : 0; }
};

// Stage raw 16-byte chunk c of row r (of R rows) into a logit operand at
// `logit` and, where `grad` is given, into its transposed gradient copy.
template <typename T>
__device__ __forceinline__ void stage(uint8_t* logit, uint8_t* grad, int R, int r, int c,
                                      uint4 raw) {
  if constexpr (Body<T>::kSplit) {
    stage_tf32_rows(logit, R, r, c, raw);
    if (grad != nullptr) stage_tf32_cols(grad, R, r, c, raw);
  } else {
    *reinterpret_cast<uint4*>(logit + sw128(r, c)) = raw;
  }
}

// Raw chunk c of row `row` of a (S, 64) head, zeros past S.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* head, int row, int c, int S) {
  if (row >= S) return make_uint4(0u, 0u, 0u, 0u);
  return *reinterpret_cast<const uint4*>(head + (int64_t)row * kD + c * (16 / sizeof(T)));
}

// The raw chunks of a streamed tile of NC rows of two tensors, loaded ahead
// into registers: `kPer` a thread of each tensor.
template <typename T, int NC>
struct Prefetch {
  static constexpr int kPer = NC * Body<T>::kRowChunks / kThreads;
  uint4 raw[2][kPer];

  // (row, chunk) of the i-th chunk of thread tid. f32: rows vary fastest,
  // so a warp stages 32 rows of one chunk (NC is 32 or 64), as the
  // transposed copies want; bf16: chunks vary fastest, whole rows a load.
  __device__ __forceinline__ static int2 at(int tid, int i) {
    const int y = tid + i * kThreads;
    if constexpr (Body<T>::kSplit) return make_int2(y % NC, y / NC);
    return make_int2(y / Body<T>::kRowChunks, y % Body<T>::kRowChunks);
  }

  __device__ __forceinline__ void load(const T* a, const T* b, int row0, int S, int tid) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int2 rc = at(tid, i);
      raw[0][i] = load_chunk(a, row0 + rc.x, rc.y, S);
      raw[1][i] = load_chunk(b, row0 + rc.x, rc.y, S);
    }
  }

  // into the logit operands at la, lb and the gradient copies at ga, gb (or none)
  __device__ __forceinline__ void stage_all(uint8_t* la, uint8_t* ga, uint8_t* lb, uint8_t* gb,
                                            int tid) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int2 rc = at(tid, i);
      stage<T>(la, ga, NC, rc.x, rc.y, raw[0][i]);
      stage<T>(lb, gb, NC, rc.x, rc.y, raw[1][i]);
    }
  }
};

// s = A_s B_s^T and dp = A_p B_p^T over the 64 head dims, waited for: A_s,
// A_p are the 64 rows from row a0 of logit operands of ra rows at shared
// addresses as, ap; B_s, B_p the NC rows of logit operands at bs, bp. f32 in
// 3xTF32, the two products one after the other, sharing the cross-term
// accumulator.
template <typename T, int NC>
__device__ __forceinline__ void logits(float (&s)[NC / 2], float (&dp)[NC / 2], uint32_t as,
                                       uint32_t ap, uint32_t bs, uint32_t bp, int ra, int a0) {
  if constexpr (Body<T>::kSplit) {
    float e[NC / 2];
    auto product = [&](float (&d)[NC / 2], uint32_t a, uint32_t b) {
      wgmma_fence();
      mma_tf32x3_ss<NC>(d, e, a, ra, a0, b);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(d);
      fence_regs(e);
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) d[i] += e[i];
    };
    product(s, as, bs);
    product(dp, ap, bp);
  } else {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      Mma<NC>::bf16(s, smem_desc(as + a0 * 128 + kk * 32, 16, 1024),
                    smem_desc(bs + kk * 32, 16, 1024), kk);
      Mma<NC>::bf16(dp, smem_desc(ap + a0 * 128 + kk * 32, 16, 1024),
                    smem_desc(bp + kk * 32, 16, 1024), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
  }
}

// The A operand of a gradient product, from a logit accumulator x (m64 x
// NC). bf16: k16 step kk takes x[8kk .. 8kk+7] pairwise, rounded to bf16.
template <int NC>
struct Bf16A {
  uint32_t hi[NC / 16][4];

  __device__ __forceinline__ void pack(const float (&x)[NC / 2]) {
#pragma unroll
    for (int kk = 0; kk < NC / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) hi[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
      fence_regs(hi[kk]);
    }
  }
};

// f32: the tf32 hi and lo split (wgmma.cuh); bf16: the bf16 rounding
template <typename T, int NC>
using PackedA = std::conditional_t<Body<T>::kSplit, Tf32A<NC>, Bf16A<NC>>;

// d += A B, issued (bf16) or waited for (f32). f32: 3xTF32 with B the cols
// operand (64, NC) at b, the cross terms of this tile added to d in f32.
// bf16: B the NC x 64 bf16 tile at b, stored (k, n): MN-major, transposed by
// the descriptor; a k16 step is 16 rows, 2048 bytes.
template <typename T, int NC>
__device__ __forceinline__ void grad_product(float (&d)[32], const PackedA<T, NC>& a, uint32_t b) {
  if constexpr (Body<T>::kSplit) {
    float e[32];
    fence_regs(d);
    wgmma_fence();
    mma_tf32x3_rs<NC>(d, e, a, b);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(d);
    fence_regs(e);
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] += e[i];
  } else {
#pragma unroll
    for (int kk = 0; kk < NC / 16; ++kk)
      wgmma_rs64(d, a.hi[kk], smem_desc(b + kk * 2048, 1024, 1024));
  }
}

// Stores rows r0 (d[4b], d[4b+1]) and r1 = r0 + 8 (d[4b+2], d[4b+3]) of an
// m64n64 accumulator, columns 8b + 2t, into a (S, 64) head.
template <typename T>
__device__ __forceinline__ void store_rows(T* head, const float (&d)[32], int r0, int t4, int S) {
#pragma unroll
  for (int b = 0; b < 8; ++b) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r >= S) continue;
      T* p = head + (int64_t)r * kD + 8 * b + 2 * t4;
      const float x = d[4 * b + 2 * half], y = d[4 * b + 2 * half + 1];
      if constexpr (Body<T>::kSplit)
        *reinterpret_cast<float2*>(p) = make_float2(x, y);
      else
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Shared memory of a block: the 128-row side (two logit operands), a streamed
// tile of NC rows (two logit operands and the transposed copies of `grads`
// of them), room for the tile's lse and delta (dkv), and 1024 bytes to align the
// base to the swizzle's period.
template <typename T, int NC>
constexpr int smem_bytes(int grads) {
  using B = Body<T>;
  return 2 * B::logit_bytes(kRows) + 2 * B::logit_bytes(NC) + grads * B::grad_bytes(NC) +
         2 * 4 * NC + 1024;
}

// Accumulator layout of m64nN (f32), per thread of a warpgroup: warp w, lane
// l, quad position t = l % 4; rows r0 = 16w + l/4 and r1 = r0 + 8; d[4b + e]
// holds row (e < 2 ? r0 : r1), column 8b + 2t + (e & 1).

template <typename T>
__global__ void __launch_bounds__(kThreads, kDqMinBlocks<T>)
bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ lse_out,
                 float* __restrict__ delta_out, int Sq, int Skv, float scale) {
  using B = Body<T>;
  constexpr int NC = kDqCols<T>, NA = NC / 2, CPR = B::kRowChunks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  // Q, dO (128 rows), K, V (NC rows), K transposed (f32)
  constexpr int oQ = 0, odO = oQ + B::logit_bytes(kRows), oK = odO + B::logit_bytes(kRows);
  constexpr int oV = oK + B::logit_bytes(NC), oKg = oV + B::logit_bytes(NC);
  // B of dQ = dS K: K transposed (f32), or the K tile itself (bf16)
  const uint32_t kg = base + (B::kSplit ? oKg : oK);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t4 = lane & 3;
  const int tiles = (Sq + kRows - 1) / kRows;
  const int64_t head = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * kRows;
  const T* kh = k + head * Skv * kD;
  const T* vh = v + head * Skv * kD;

  {
    const T* qh = q + head * Sq * kD;
    const T* dh = dout + head * Sq * kD;
    for (int x = tid; x < kRows * CPR; x += kThreads) {
      const int r = x / CPR, c = x % CPR;
      stage<T>(gbase + oQ, nullptr, kRows, r, c, load_chunk(qh, q0 + r, c, Sq));
      stage<T>(gbase + odO, nullptr, kRows, r, c, load_chunk(dh, q0 + r, c, Sq));
    }
  }

  const int n = (Skv + NC - 1) / NC;
  Prefetch<T, NC> pre;  // the next K/V tile
  pre.load(kh, vh, 0, Skv, tid);

  const float c2 = scale * kLog2e;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;  // running row maxes (base 2)
  float l0 = 0.0f, l1 = 0.0f, dl0 = 0.0f, dl1 = 0.0f;  // this thread's share
  float acc[32];  // dQ, m64n64
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  for (int j = 0; j < 2 * n; ++j) {
    const bool pass2 = j >= n;
    const int k0 = (pass2 ? j - n : j) * NC;
    __syncthreads();  // every warpgroup is done with the previous tile
    pre.stage_all(gbase + oK, pass2 && B::kSplit ? gbase + oKg : nullptr, gbase + oV, nullptr,
                  tid);
    fence_async_proxy();
    __syncthreads();
    if (j + 1 < 2 * n) pre.load(kh, vh, ((j + 1) % n) * NC, Skv, tid);  // during this tile
    if (j == n) {  // pass 1 is done: the row statistics
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      dl0 = quad_sum(dl0) / l0;
      dl1 = quad_sum(dl1) / l1;
      m0 += log2f(l0);  // m now holds lse * log2 e, dl delta
      m1 += log2f(l1);
    }

    float s[NA], dp[NA];
    logits<T, NC>(s, dp, base + oQ, base + odO, base + oK, base + oV, kRows, wg * 64);

    const int lim = Skv - k0;  // keys of this tile that exist
    if (!pass2) {
      float t0 = -CUDART_INF_F, t1 = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int col = 8 * (i >> 2) + 2 * t4 + (i & 1);
        s[i] = col < lim ? s[i] * c2 : -CUDART_INF_F;
        if (i & 2) t1 = fmaxf(t1, s[i]);
        else t0 = fmaxf(t0, s[i]);
      }
      const float n0 = fmaxf(m0, quad_max(t0)), n1 = fmaxf(m1, quad_max(t1));
      const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
      l0 *= a0;
      l1 *= a1;
      dl0 *= a0;
      dl1 *= a1;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const float e = exp2f(s[i] - ((i & 2) ? n1 : n0));
        if (i & 2) {
          l1 += e;
          dl1 = fmaf(e, dp[i], dl1);
        } else {
          l0 += e;
          dl0 = fmaf(e, dp[i], dl0);
        }
      }
      m0 = n0;
      m1 = n1;
    } else {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int col = 8 * (i >> 2) + 2 * t4 + (i & 1);
        const bool r1 = i & 2;
        const float p = col < lim ? exp2f(s[i] * c2 - (r1 ? m1 : m0)) : 0.0f;
        s[i] = p * (dp[i] - (r1 ? dl1 : dl0)) * scale;  // ds
      }
      PackedA<T, NC> a;
      a.pack(s);
      if constexpr (B::kSplit) {
        grad_product<T, NC>(acc, a, kg);
      } else {
        fence_regs(acc);
        wgmma_fence();
        grad_product<T, NC>(acc, a, kg);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
    }
  }

  const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2);
  store_rows<T>(dq + head * Sq * kD, acc, r0, t4, Sq);
  if (t4 == 0) {
    if (r0 < Sq) {
      lse_out[head * Sq + r0] = m0 * kLn2;
      delta_out[head * Sq + r0] = dl0;
    }
    if (r0 + 8 < Sq) {
      lse_out[head * Sq + r0 + 8] = m1 * kLn2;
      delta_out[head * Sq + r0 + 8] = dl1;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                  int Sq, int Skv, float scale) {
  using B = Body<T>;
  constexpr int NC = kDkvCols<T>, NA = NC / 2, CPR = B::kRowChunks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  // K, V (128 rows), Q, dO (NC rows), both transposed (f32), lse and delta
  constexpr int oK = 0, oV = oK + B::logit_bytes(kRows), oQ = oV + B::logit_bytes(kRows);
  constexpr int odO = oQ + B::logit_bytes(NC), oQg = odO + B::logit_bytes(NC);
  constexpr int odOg = oQg + B::grad_bytes(NC), oStats = odOg + B::grad_bytes(NC);
  float* const lse2s = reinterpret_cast<float*>(gbase + oStats);  // lse * log2 e, NC
  float* const dels = lse2s + NC;
  // B of dK = dS^T Q and of dV = P^T dO
  const uint32_t qg = base + (B::kSplit ? oQg : oQ), dog = base + (B::kSplit ? odOg : odO);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t4 = lane & 3;
  const int tiles = (Skv + kRows - 1) / kRows;
  const int64_t head = blockIdx.x / tiles;
  const int k0 = (blockIdx.x % tiles) * kRows;
  const T* qh = q + head * Sq * kD;
  const T* dh = dout + head * Sq * kD;

  {
    const T* kh = k + head * Skv * kD;
    const T* vh = v + head * Skv * kD;
    for (int x = tid; x < kRows * CPR; x += kThreads) {
      const int r = x / CPR, c = x % CPR;
      stage<T>(gbase + oK, nullptr, kRows, r, c, load_chunk(kh, k0 + r, c, Skv));
      stage<T>(gbase + oV, nullptr, kRows, r, c, load_chunk(vh, k0 + r, c, Skv));
    }
  }

  const int n = (Sq + NC - 1) / NC;
  Prefetch<T, NC> pre;  // the next Q/dO tile, and its lse and delta
  float pre_lse = 0.0f, pre_del = 0.0f;
  auto load_tile = [&](int j) {
    pre.load(qh, dh, j * NC, Sq, tid);
    if (tid < NC) {
      const int row = j * NC + tid;
      // a query past Sq gets p = exp2(t - inf) = 0
      pre_lse = row < Sq ? lse[head * Sq + row] * kLog2e : CUDART_INF_F;
      pre_del = row < Sq ? delta[head * Sq + row] : 0.0f;
    }
  };
  load_tile(0);

  const float c2 = scale * kLog2e;
  float adk[32], adv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) adk[i] = adv[i] = 0.0f;

  for (int j = 0; j < n; ++j) {
    __syncthreads();  // every warpgroup is done with the previous tile
    pre.stage_all(gbase + oQ, B::kSplit ? gbase + oQg : nullptr, gbase + odO,
                  B::kSplit ? gbase + odOg : nullptr, tid);
    if (tid < NC) {
      lse2s[tid] = pre_lse;
      dels[tid] = pre_del;
    }
    fence_async_proxy();
    __syncthreads();
    if (j + 1 < n) load_tile(j + 1);  // in flight during this tile

    // rows: this warpgroup's 64 keys; columns: the tile's NC queries
    float s[NA], dp[NA];
    logits<T, NC>(s, dp, base + oK, base + oV, base + oQ, base + odO, kRows, wg * 64);

#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int col = 8 * (i >> 2) + 2 * t4 + (i & 1);
      const float p = exp2f(s[i] * c2 - lse2s[col]);
      dp[i] = p * (dp[i] - dels[col]) * scale;  // ds
      s[i] = p;
    }
    PackedA<T, NC> ap, as;
    ap.pack(s);   // p, rounded to dO's type for bf16
    as.pack(dp);  // ds, rounded to q's type for bf16
    if constexpr (B::kSplit) {  // one after the other, each waited for
      grad_product<T, NC>(adv, ap, dog);
      grad_product<T, NC>(adk, as, qg);
    } else {
      fence_regs(adv);
      fence_regs(adk);
      wgmma_fence();
      grad_product<T, NC>(adv, ap, dog);
      grad_product<T, NC>(adk, as, qg);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(adv);
      fence_regs(adk);
    }
  }

  const int r0 = k0 + wg * 64 + warp * 16 + (lane >> 2);
  store_rows<T>(dk + head * Skv * kD, adk, r0, t4, Skv);
  store_rows<T>(dv + head * Skv * kD, adv, r0, t4, Skv);
}

template <typename K>
cudaError_t prepare(K kernel, int smem, int64_t blocks) {
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout, void* dq,
                      float* lse, float* delta, int BH, int Sq, int Skv, float scale,
                      cudaStream_t st) {
  constexpr int smem = smem_bytes<T, kDqCols<T>>(1);
  const int64_t blocks = (int64_t)BH * ((Sq + kRows - 1) / kRows);
  cudaError_t e = prepare(bwd_dq_tc_kernel<T>, smem, blocks);
  if (e != cudaSuccess) return e;
  bwd_dq_tc_kernel<T><<<(unsigned)blocks, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<T*>(dq), lse, delta, Sq, Skv, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int BH,
                       int Sq, int Skv, float scale, cudaStream_t st) {
  constexpr int smem = smem_bytes<T, kDkvCols<T>>(2);
  const int64_t blocks = (int64_t)BH * ((Skv + kRows - 1) / kRows);
  cudaError_t e = prepare(bwd_dkv_tc_kernel<T>, smem, blocks);
  if (e != cudaSuccess) return e;
  bwd_dkv_tc_kernel<T><<<(unsigned)blocks, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq,
      Skv, scale);
  return cudaGetLastError();
}

}  // namespace

cudaError_t attn_bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                           void* dq, float* lse, float* delta, int BH, int Sq, int Skv,
                           float scale, bool f32, cudaStream_t st) {
  return f32 ? launch_dq<float>(q, k, v, dout, dq, lse, delta, BH, Sq, Skv, scale, st)
             : launch_dq<__nv_bfloat16>(q, k, v, dout, dq, lse, delta, BH, Sq, Skv, scale, st);
}

cudaError_t attn_bwd_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dk, void* dv, int BH,
                            int Sq, int Skv, float scale, bool f32, cudaStream_t st) {
  return f32 ? launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, BH, Sq, Skv, scale, st)
             : launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, BH, Sq, Skv, scale,
                                         st);
}

}  // namespace tt
