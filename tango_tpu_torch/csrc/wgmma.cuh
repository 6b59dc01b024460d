// Hopper building blocks shared by the tensor-core bodies (attention_tc.cu,
// attention_bwd_tc.cu, int8_gemm_tc.cu, winograd_tc.cu): the 128-byte and
// 64-byte swizzles, wgmma shared-memory descriptors, the cp.async ring's
// copies, the proxy and wgmma fences, the register-A m64n64k16 and m64n32k16
// bf16 products, the shared-memory-A m64n64k16 bf16 product, the m64n128k32
// s8 product, and the 3xTF32 products of the f32 attention bodies and the f32
// Winograd GEMM (splits, staging, fragments), at head dim 64 and 32.
// gn_silu.cu's cluster body takes the cp.async copies. sm_90a only.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tt {

// Byte offset of the 16-byte chunk c of row r in a tile of 128-byte rows
// under the 128-byte swizzle (chunk c of row r at c ^ (r % 8)); the tile's
// base is 1024-byte aligned, where the swizzle pattern repeats.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// The same for a tile of 64-byte rows (bf16 rows of 32 head dims) under the
// 64-byte swizzle: chunk c (of 4) of row r at c ^ ((r / 2) % 4), the XOR of
// address bits 4-5 with bits 7-8; the pattern repeats every 512 bytes.
__device__ __forceinline__ uint32_t sw64(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// The layout types of a wgmma descriptor (bits 62-63) used here.
constexpr uint64_t kSwizzle128 = 1, kSwizzle64 = 2;

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, all in 16-byte units, and the layout type (128-byte swizzle
// unless another is named). A K-major operand's SBO is the stride between
// groups of 8 rows; an MN-major (transposed) one's SBO is that along K and
// its LBO the stride between swizzle atoms along MN.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout = kSwizzle128) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | layout << 62;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  // bytes 0 copies nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's shared-memory writes (st.shared, cp.async) visible to
// wgmma's reads, which go through the async proxy.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Orders the compiler's reads and writes of these registers against the
// wgmma instructions around them (the accumulators are written
// asynchronously, between the mma and its wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define TT_ACC8(i)                                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A B for one k16 step: A 64 x 16 bf16 in registers (the k16 A
// fragment), B 16 x 64 bf16 in shared memory stored (k, n), i.e. MN-major:
// transposed (imm-trans-b = 1); d is the m64n64 f32 accumulator.
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TT_ACC8(0), TT_ACC8(8), TT_ACC8(16), TT_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The same at n32: B 16 x 32 bf16 stored (k, n) in 64-byte rows; d is the
// m64n32 f32 accumulator (the P V product at head dim 32).
__device__ __forceinline__ void wgmma_rs32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : TT_ACC8(0), TT_ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (+)= A B^T for one k16 step: A 64 x 16 and B 64 x 16 bf16, both K-major
// in shared memory; d is the m64n64 f32 accumulator (overwritten if !acc).
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : TT_ACC8(0), TT_ACC8(8), TT_ACC8(16), TT_ACC8(24)
      : "l"(a), "l"(b), "r"(acc));
}

#define TT_IACC8(i)                                                                        \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])

// d (+)= A B^T for one k32 step: A 64 x 32 and B 128 x 32 int8, both K-major
// in shared memory (8-bit operands have no transposed form); d is the m64n128
// s32 accumulator (overwritten if !acc), exact. Its layout is the f32
// accumulator's.
__device__ __forceinline__ void wgmma_s8_128(int (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : TT_IACC8(0), TT_IACC8(8), TT_IACC8(16), TT_IACC8(24), TT_IACC8(32), TT_IACC8(40),
        TT_IACC8(48), TT_IACC8(56)
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- 3xTF32
// f32 products within f32's accuracy on the TF32 tensor cores: each operand x
// splits into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) (x to ~2^-22),
// and a b = a_hi b_hi + (a_hi b_lo + a_lo b_hi), the cross terms in an
// accumulator of their own, added at the end in f32: the tensor cores round
// every addition, so small terms are kept apart from the large sum; where
// registers are short, the cross terms go first into the one accumulator
// (mma_tf32x3_ss_folded, CUTLASS's order). .tf32 wgmma takes K-major
// operands only.
//
// Two shared-memory layouts of D-column f32 operands (D = 64, or 32 in the
// forward at head dim 32), both 128-byte swizzled on 1024-byte aligned bases,
// each as tf32 hi then lo:
//   * rows (R, D): the head dim contiguous (q, k as stored), the A or B of a
//     product over the head dim; a row is 4D bytes, D/32 swizzle atoms, so
//     each of hi and lo is D/32 (R, 32) halves: at D = 64 hi at 0 and R*128,
//     lo at 2R*128 and 3R*128; at D = 32 hi at 0, lo at R*128. 4R*D bytes.
//   * cols (D, NC): an (NC, D) tile transposed, the B of a product over its
//     NC rows (k, q, v, dO as B of P V, dS K, dS^T Q, P^T dO): D rows of NC
//     tf32 values, each of hi and lo NC/32 halves of D x 128 bytes. The tile
//     rows are stored in kpos order (below). 8*D*NC bytes.
//
// The A operand of a product over NC columns comes from registers: the m64nN
// f32 accumulator of the logit product gives a thread columns 2t, 2t+1 of
// each group of 8 (t = lane % 4), and the .tf32 k8 A fragment wants
// columns t and t + 4 (PTX ISA, wgmma .m64nNk8 register fragments: a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)). Permuting the contraction
// index of both operands the same way leaves the product unchanged, so the
// accumulator's column 2t is fed as k = t and 2t + 1 as k = t + 4, and the B
// tile stores its row c at kpos(c).

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// Where row c of a tile sits along k in a cols operand (within its group of 8:
// even c at c / 2, odd c at 4 + c / 2).
__device__ __forceinline__ int kpos(int c) {
  const int w = c & 7;
  return (c & ~7) | ((w & 1) << 2) | (w >> 1);
}

// Stage the 4 f32 values of raw 16-byte chunk c (columns 4c .. 4c+3) of row r
// into a rows operand of R rows of D columns at `op`, split into hi and lo;
// `mul` scales them first (in f32).
template <int D = 64>
__device__ __forceinline__ void stage_tf32_rows(uint8_t* op, int R, int r, int c, uint4 raw,
                                                float mul = 1.0f) {
  const float x[4] = {__uint_as_float(raw.x) * mul, __uint_as_float(raw.y) * mul,
                      __uint_as_float(raw.z) * mul, __uint_as_float(raw.w) * mul};
  float hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(x[i]);
    lo[i] = tf32_rna(x[i] - hi[i]);
  }
  const uint32_t off = (c >> 3) * R * 128 + sw128(r, c & 7);
  *reinterpret_cast<float4*>(op + off) = make_float4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<float4*>(op + (D / 32) * R * 128 + off) =
      make_float4(lo[0], lo[1], lo[2], lo[3]);
}

// Stage the same chunk (row r of an NC-row tile) into a cols operand of D
// rows at `op`: value i goes to row 4c + i, column kpos(r). A warp that
// stages 32 consecutive rows of one chunk writes 32 distinct banks per store.
template <int D = 64>
__device__ __forceinline__ void stage_tf32_cols(uint8_t* op, int NC, int r, int c, uint4 raw) {
  const float x[4] = {__uint_as_float(raw.x), __uint_as_float(raw.y), __uint_as_float(raw.z),
                      __uint_as_float(raw.w)};
  const int k = kpos(r), kk = k & 31;
  const uint32_t lo_off = (NC >> 5) * D * 128;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float hi = tf32_rna(x[i]);
    const uint32_t off = (k >> 5) * D * 128 + sw128(4 * c + i, kk >> 2) + (kk & 3) * 4;
    *reinterpret_cast<float*>(op + off) = hi;
    *reinterpret_cast<float*>(op + lo_off + off) = tf32_rna(x[i] - hi);
  }
}

// The A operand of a product over NC columns, from an m64 x NC accumulator x:
// k8 step kk takes x[4kk], x[4kk + 2] (columns 2t of rows g, g + 8) as k = t
// and x[4kk + 1], x[4kk + 3] (columns 2t + 1) as k = t + 4, split into hi, lo.
template <int NC>
struct Tf32A {
  uint32_t hi[NC / 8][4], lo[NC / 8][4];

  __device__ __forceinline__ void pack(const float (&x)[NC / 2]) {
#pragma unroll
    for (int kk = 0; kk < NC / 8; ++kk) {
      const float v[4] = {x[4 * kk], x[4 * kk + 2], x[4 * kk + 1], x[4 * kk + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float h = tf32_rna(v[e]);
        hi[kk][e] = __float_as_uint(h);
        lo[kk][e] = __float_as_uint(tf32_rna(v[e] - h));
      }
      fence_regs(hi[kk]);
      fence_regs(lo[kk]);
    }
  }
};

#define TT_ACC16(i) TT_ACC8(i), TT_ACC8(i + 8)
#define TT_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define TT_D32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B^T for one k step (k8 in TF32, k16 in bf16): A 64 rows, B N rows,
// both K-major in shared memory; d is the m64nN f32 accumulator (overwritten
// if !acc). N = 32 is f32 dkv's query tile and the P V product at head dim
// 32, N = 64 the others.
template <int N> struct Mma;

template <>
struct Mma<32> {
  __device__ __forceinline__ static void tf32(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " TT_D16
                 ", %16, %17, p, 1, 1;\n}\n"
                 : TT_ACC16(0)
                 : "l"(a), "l"(b), "r"(acc));
  }
  // A from registers (a Tf32A k8 step), B K-major in shared memory
  __device__ __forceinline__ static void tf32_rs(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t b, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " TT_D16
                 ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : TT_ACC16(0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Mma<64> {
  __device__ __forceinline__ static void tf32(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " TT_D32
                 ", %32, %33, p, 1, 1;\n}\n"
                 : TT_ACC16(0), TT_ACC16(16)
                 : "l"(a), "l"(b), "r"(acc));
  }
  __device__ __forceinline__ static void bf16(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TT_D32
                 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : TT_ACC16(0), TT_ACC16(16)
                 : "l"(a), "l"(b), "r"(acc));
  }
  // A from registers (a Tf32A k8 step), B K-major in shared memory
  __device__ __forceinline__ static void tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t b, int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " TT_D32
                 ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : TT_ACC16(0), TT_ACC16(16)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

#undef TT_D32
#undef TT_D16
#undef TT_ACC16

// d (+)= A B^T over the D head dims in 3xTF32 (issued, not waited for): A
// the 64 rows from row a0 of a rows operand of ra rows at shared address a,
// B the N rows of a rows operand at b; d is overwritten unless acc (then the
// products add to what it holds); e receives the cross terms, to be added to
// d once waited for.
template <int N, int D = 64>
__device__ __forceinline__ void mma_tf32x3_ss(float (&d)[N / 2], float (&e)[N / 2], uint32_t a,
                                              int ra, int a0, uint32_t b, int acc = 0) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int h = kk >> 2, o = (kk & 3) * 32;  // half of the row, bytes into it
    const uint32_t ah = a + h * ra * 128 + a0 * 128 + o, bh = b + h * N * 128 + o;
    const uint64_t a_hi = smem_desc(ah, 16, 1024);
    const uint64_t a_lo = smem_desc(ah + (D / 32) * ra * 128, 16, 1024);
    const uint64_t b_hi = smem_desc(bh, 16, 1024);
    const uint64_t b_lo = smem_desc(bh + (D / 32) * N * 128, 16, 1024);
    Mma<N>::tf32(d, a_hi, b_hi, kk > 0 || acc);
    Mma<N>::tf32(e, a_hi, b_lo, kk);
    Mma<N>::tf32(e, a_lo, b_hi, 1);
  }
}

// d = A B^T over 64 columns in 3xTF32 with the cross terms in d itself
// (issued, not waited for; operands as in mma_tf32x3_ss): the 16 cross-term
// products first, from d = 0, then the 8 large ones, so the small terms add
// up at their own scale before the large sum arrives (CUTLASS's 3xTF32
// order). One accumulator instead of two, for a body whose registers hold
// other sums (winograd_tc.cu's f32 GEMM); each call starts a fresh sum.
template <int N>
__device__ __forceinline__ void mma_tf32x3_ss_folded(float (&d)[N / 2], uint32_t a, int ra, int a0,
                                                     uint32_t b) {
#pragma unroll
  for (int big = 0; big < 2; ++big) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int h = kk >> 2, o = (kk & 3) * 32;
      const uint32_t ah = a + h * ra * 128 + a0 * 128 + o, bh = b + h * N * 128 + o;
      const uint64_t a_hi = smem_desc(ah, 16, 1024), b_hi = smem_desc(bh, 16, 1024);
      if (big) {
        Mma<N>::tf32(d, a_hi, b_hi, 1);
      } else {
        Mma<N>::tf32(d, a_hi, smem_desc(bh + 2 * N * 128, 16, 1024), kk);
        Mma<N>::tf32(d, smem_desc(ah + 2 * ra * 128, 16, 1024), b_hi, 1);
      }
    }
  }
}

// d += A B over NC in 3xTF32 (issued, not waited for): A in registers, B the
// cols operand (D, NC) at shared address b; e (overwritten) receives the
// cross terms, to be added to d once waited for.
template <int NC, int D = 64>
__device__ __forceinline__ void mma_tf32x3_rs(float (&d)[D / 2], float (&e)[D / 2],
                                              const Tf32A<NC>& a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < NC / 8; ++kk) {
    const uint32_t bh = b + (kk >> 2) * D * 128 + (kk & 3) * 32;
    const uint64_t b_hi = smem_desc(bh, 16, 1024);
    const uint64_t b_lo = smem_desc(bh + (NC >> 5) * D * 128, 16, 1024);
    Mma<D>::tf32_rs(d, a.hi[kk], b_hi, 1);
    Mma<D>::tf32_rs(e, a.hi[kk], b_lo, kk);
    Mma<D>::tf32_rs(e, a.lo[kk], b_hi, 1);
  }
}

}  // namespace tt
