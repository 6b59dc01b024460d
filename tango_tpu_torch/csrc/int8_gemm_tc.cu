// Tensor-core body of the W8A8 GEMM: a quantize pass, then an s8 wgmma GEMM
// (sm_90a). The C entry point tt_w8a8_gemm (int8_gemm.cu) takes it where
// w8a8_tc_body(K) holds: K % 16 == 0, so that every row of x, xq and w is a
// whole number of 16-byte copies. Every dense layer of the int8 UNet
// qualifies (K 320 to 5120); other K keep int8_gemm.cu's __dp4a body.
//
// Replaces, as that body does, tango_tpu/ops/int8_gemm.py: _w8a8_kernel
// (through w8a8_matmul), with its arithmetic step for step:
//   scale = max(rowmax |x|, 1e-8) * (1/127)        (f32, one per row of x)
//   xq    = clip(rint(x / scale), -127, 127)        (int8, half to even; IEEE
//                                                   division: no fast-math)
//   acc   = sum_k xq[m, k] * w[n, k]                (int32, exact)
//   y     = (float(acc) * scale) * w_scale[n]       (f32, stored as T)
// The integer sum is exact in any order and the epilogue keeps the plain
// version's order, so the result is bit-equal to w8a8_matmul_plain.
//
// What bounds it on the H100: operations at the UNet's larger shapes (M up
// to 8192 tokens, K 320 to 5120, N up to 10240: 2*M*N*K int8 operations
// against ~3*M*K + N*K + 2*M*N bytes), bytes at the small ones. What the
// design does about it:
//   * (a) quantize_rows_kernel: one warp a row (up to 8 for K over 2048)
//     reads x once (16-byte loads), takes the row maximum with shuffles,
//     writes the row's scale and then its int8 row (the second read of the
//     row comes from L1/L2). The
//     __dp4a body repeated the row maxima and the quantization once for
//     every N-tile; here they happen once. xq (M, K) int8 and scale (M,) f32
//     are scratch that the wrapper allocates.
//   * (b) w8a8_tc_kernel: the products on the int8 tensor cores as wgmma
//     m64n128k32 s32.s8.s8, both operands K-major in shared memory (xq is A,
//     (M, K); w is B, (N, K), F.linear's layout: 8-bit wgmma takes no
//     transposed operand, and none is needed). A block of 2 warpgroups
//     (256 threads) owns a 128 x 128 tile of y; K walks in 128-byte stages
//     (4 k32 steps) through a 3-stage cp.async ring (16-byte copies,
//     zero-filled past M, N and K, so a ragged edge adds 0 to the sums),
//     128-byte swizzled (chunk c of row r at c ^ (r % 8)). 97 KB of shared
//     memory a block: 2 blocks an SM, so one block's barrier and epilogue
//     overlap the other's products. The epilogue converts each s32 sum to
//     f32, multiplies by the row's scale and then by w_scale[n], and stores
//     T through shared memory as 16-byte row packets (coalesced), masked
//     for the M and N tails.
//   * Where few 128 x 128 tiles meet a long K (M = 128 and 512 at K =
//     5120), the wrapper splits K over 2 to 16 blocks (`splits`, grid.z):
//     each writes its s32 partial sums to scratch, and w8a8_finish_kernel
//     adds them (exact) and runs the epilogue.
// Headroom left for later: TMA loads from a producer warp, and a persistent
// tile loop against the wave quantization of 100-300 blocks on 132 SMs.
//
// Layout: x (M, K) T = float or bf16, w (N, K) int8, y (M, N) T, all
// contiguous; x, w and y 16-byte aligned (the wrapper checks). Blocks: the
// 128-row M-tiles on grid.x, the N-tiles on grid.y. Element offsets are
// 64-bit.

#include "common.cuh"
#include "wgmma.cuh"

namespace tt {
namespace {

constexpr int kRows = 128;             // rows of y a block, 64 a warpgroup
constexpr int kCols = 128;             // columns of y a block
constexpr int kChunk = 128;            // K bytes a stage: one swizzled 128-byte row
constexpr int kThreads = 256;          // two warpgroups
constexpr int kMinBlocks = 2;          // blocks an SM (registers <= 128 a thread)
constexpr int kStages = 3;             // stages of the ring
constexpr int kTileA = kRows * kChunk;  // 16 KB of xq a stage
constexpr int kTileB = kCols * kChunk;  // 16 KB of w a stage
constexpr int kSmem = kStages * (kTileA + kTileB) + 1024;  // and room to align to 1024
constexpr int kQuantWarps = 8;         // warps a quantize block

// 8 consecutive elements of a row as f32 (16-byte aligned loads)
__device__ __forceinline__ void load8(const float* p, float* v) {
  load_pack(p, v);
  load_pack(p + 4, v + 4);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) { load_pack(p, v); }

// One row of x over `R` warps (R = 1, 2, 4 or 8; 8 / R rows a block): the
// row maximum (shuffles, then shared memory across the R warps), the scale,
// then the int8 row.
template <typename T>
__global__ void __launch_bounds__(kQuantWarps * 32)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ scale,
                     int M, int K, int R) {
  __shared__ float s_max[kQuantWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, part = warp % R;
  const int64_t row = (int64_t)blockIdx.x * (kQuantWarps / R) + warp / R;
  const bool live = row < M;
  const T* xr = x + (live ? row : 0) * K;
  const int packs = K / 8;
  float amax = 0.0f;
  for (int c = part * 32 + lane; live && c < packs; c += 32 * R) {
    float v[8];
    load8(xr + 8 * c, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) s_max[warp] = amax;
  __syncthreads();
  if (!live) return;
  for (int i = warp - part; i < warp - part + R; ++i) amax = fmaxf(amax, s_max[i]);
  const float s = fmaxf(amax, 1e-8f) * (1.0f / 127.0f);
  if (part == 0 && lane == 0) scale[row] = s;
  int8_t* qr = xq + row * K;
  for (int c = part * 32 + lane; c < packs; c += 32 * R) {
    float v[8];
    load8(xr + 8 * c, v);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = (int)fminf(fmaxf(rintf(v[j] / s), -127.0f), 127.0f);
      w[j / 4] |= ((uint32_t)q & 0xffu) << (8 * (j % 4));
    }
    *reinterpret_cast<uint2*>(qr + 8 * c) = make_uint2(w[0], w[1]);
  }
}

// Two adjacent outputs (columns n, n + 1 of a row) in one store.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, __nv_bfloat16 a, __nv_bfloat16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}

__device__ __forceinline__ void store2(int* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

// Writes this warpgroup's 64 x 128 outputs (val(i) is accumulator entry i in
// the output type O) to out (rows of N elements, m0 and n0 the tile's first
// row and column). Where rows of y are whole 16-byte packets (N * sizeof(O)
// % 16 == 0) the tile goes through shared memory (`stage`, the ring, free
// after the main loop; rows padded by 32 bytes against bank conflicts) and
// out as 16-byte row packets; otherwise pair by pair from registers.
template <typename O, typename F>
__device__ __forceinline__ void store_tile(O* __restrict__ out, uint8_t* stage, int64_t m0,
                                           int n0, int M, int N, F val) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);
  if ((N * (int)sizeof(O)) % 16) {
#pragma unroll
    for (int b = 0; b < kCols / 8; ++b) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t row = m0 + r0 + (e < 2 ? 0 : 8);
        const int n = n0 + 8 * b + 2 * t4 + (e & 1);
        if (row < M && n < N) out[row * N + n] = val(4 * b + e);
      }
    }
    return;
  }
  constexpr int kRowBytes = kCols * sizeof(O) + 32;
#pragma unroll
  for (int b = 0; b < kCols / 8; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store2(reinterpret_cast<O*>(stage + (r0 + 8 * h) * kRowBytes) + 8 * b + 2 * t4,
             val(4 * b + 2 * h), val(4 * b + 2 * h + 1));
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + (int)(threadIdx.x >> 7)) : "memory");
  constexpr int kPackets = kCols * sizeof(O) / 16;  // 16-byte packets a row
  constexpr int kPer = 16 / sizeof(O);              // elements a packet
#pragma unroll
  for (int i = tid; i < 64 * kPackets; i += 128) {
    const int r = i / kPackets, c = i % kPackets;
    const int64_t row = m0 + r;
    const int n = n0 + c * kPer;
    if (row < M && n < N)
      *reinterpret_cast<uint4*>(out + row * N + n) =
          *reinterpret_cast<const uint4*>(stage + r * kRowBytes + 16 * c);
  }
}

// Accumulator layout of m64nNk32 (s32), per thread of a warpgroup: warp w,
// lane l, quad position t = l % 4; rows r0 = 16w + l/4 and r1 = r0 + 8;
// d[4b + e] holds row (e < 2 ? r0 : r1), column 8b + 2t + (e & 1).
// A block sums the K chunks of its split (blockIdx.z of `splits`): with one
// split it runs the epilogue, with more it stores its s32 partial sums into
// part[split] (M, N) for w8a8_finish_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
w8a8_tc_kernel(const int8_t* __restrict__ xq, const float* __restrict__ scale,
               const int8_t* __restrict__ w, const float* __restrict__ w_scale,
               T* __restrict__ y, int* __restrict__ part, int M, int N, int K, int splits) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sA = base, sB = base + kStages * kTileA;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t4 = lane & 3;
  const int64_t m0 = (int64_t)blockIdx.x * kRows;
  const int n0 = blockIdx.y * kCols;
  const int all_chunks = (K + kChunk - 1) / kChunk;
  const int per_split = (all_chunks + splits - 1) / splits;
  const int c0 = blockIdx.z * per_split;
  const int n_chunks = max(0, min(per_split, all_chunks - c0));

  auto load = [&](int j) {  // K chunk c0 + j into ring slot j % kStages
    const int k0 = (c0 + j) * kChunk, slot = j % kStages;
#pragma unroll
    for (int it = 0; it < kRows * 8 / kThreads; ++it) {
      const int r = (tid >> 3) + it * (kThreads / 8), c = tid & 7;
      const int k = k0 + 16 * c;
      const bool a_in = m0 + r < M && k < K, b_in = n0 + r < N && k < K;
      cp_async16(sA + slot * kTileA + sw128(r, c), a_in ? xq + (m0 + r) * K + k : xq,
                 a_in ? 16 : 0);
      cp_async16(sB + slot * kTileB + sw128(r, c), b_in ? w + (int64_t)(n0 + r) * K + k : w,
                 b_in ? 16 : 0);
    }
  };
  // one copy group per chunk, empty past the last, so that "chunk j has
  // landed" is always "at most kStages - 2 groups pending" at iteration j
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_chunks) load(j);
    cp_async_commit();
  }

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  for (int j = 0; j < n_chunks; ++j) {
    const int slot = j % kStages;
    cp_async_wait<kStages - 2>();
    fence_async_proxy();
    // chunk j is in shared memory, visible to wgmma; and every thread is
    // done with chunk j - 1, whose slot the next copy refills
    __syncthreads();
    if (j + kStages - 1 < n_chunks) load(j + kStages - 1);
    cp_async_commit();

    // this warpgroup's 64 rows of xq; a k32 step advances 32 bytes along K
    const uint64_t da = smem_desc(sA + slot * kTileA + wg * 64 * kChunk, 16, 1024);
    const uint64_t db = smem_desc(sB + slot * kTileB, 16, 1024);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 32; ++kk) wgmma_s8_128(acc, da + 2 * kk, db + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

  // the ring is free once both warpgroups are past their last wgmma
  __syncthreads();
  uint8_t* const stage = smem_raw + (base - raw) + wg * 64 * (kCols * 4 + 32);
  const int64_t mw = m0 + wg * 64;  // this warpgroup's first row
  if (splits > 1) {  // the split's exact partial sums
    store_tile<int>(part + (int64_t)blockIdx.z * M * N, stage, mw, n0, M, N,
                    [&](int i) { return acc[i]; });
    return;
  }
  // the epilogue: (float(acc) * scale) * w_scale[n], in that order
  const int64_t r0 = mw + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const float s0 = r0 < M ? scale[r0] : 0.0f, s1 = r1 < M ? scale[r1] : 0.0f;
  float ws[kCols / 4];  // w_scale of this thread's 32 columns
#pragma unroll
  for (int b = 0; b < kCols / 8; ++b)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + 8 * b + 2 * t4 + e;
      ws[2 * b + e] = n < N ? w_scale[n] : 0.0f;
    }
  store_tile<T>(y, stage, mw, n0, M, N, [&](int i) {
    return from_f32<T>((float)acc[i] * ((i & 2) ? s1 : s0) * ws[2 * (i >> 2) + (i & 1)]);
  });
}

// The epilogue after a split K: the splits' s32 sums added (exact), then
// (float(acc) * scale) * w_scale[n] stored as T; four elements of a row a
// thread where N % 4 == 0, else one.
template <typename T, int V>
__global__ void __launch_bounds__(256)
w8a8_finish_kernel(const int* __restrict__ part, const float* __restrict__ scale,
                   const float* __restrict__ w_scale, T* __restrict__ y, int M, int N,
                   int splits) {
  const int64_t n = (int64_t)M * N, i = ((int64_t)blockIdx.x * 256 + threadIdx.x) * V;
  if (i >= n) return;
  int acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0;
  for (int s = 0; s < splits; ++s) {
    const int* p = part + s * n + i;
    if constexpr (V == 4) {
      const int4 a = *reinterpret_cast<const int4*>(p);
      acc[0] += a.x;
      acc[1] += a.y;
      acc[2] += a.z;
      acc[3] += a.w;
    } else {
      acc[0] += p[0];
    }
  }
  const int64_t row = i / N;
  const int col = (int)(i - row * N);
  const float sc = scale[row];
#pragma unroll
  for (int j = 0; j < V; ++j) y[i + j] = from_f32<T>((float)acc[j] * sc * w_scale[col + j]);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* ws, void* y, void* xq, void* scale,
                   void* part, int splits, int M, int N, int K, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(w8a8_tc_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  // warps a row of x: enough that each takes ~4 or more 16-byte packets a lane
  int R = 1;
  while (R < kQuantWarps && K / 8 >= 2 * R * 128) R *= 2;
  const int64_t quant_blocks = ((int64_t)M * R + kQuantWarps - 1) / kQuantWarps;
  const int64_t m_tiles = ((int64_t)M + kRows - 1) / kRows;
  const int n_tiles = (N + kCols - 1) / kCols;
  const bool vec = N % 4 == 0;
  const int64_t finish_blocks = ((int64_t)M * N / (vec ? 4 : 1) + 255) / 256;
  if (quant_blocks > 0x7fffffff || m_tiles > 0x7fffffff || n_tiles > 65535 ||
      (splits > 1 && finish_blocks > 0x7fffffff))
    return cudaErrorInvalidConfiguration;
  quantize_rows_kernel<T><<<(unsigned)quant_blocks, kQuantWarps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(xq), static_cast<float*>(scale), M, K, R);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  w8a8_tc_kernel<T><<<dim3((unsigned)m_tiles, (unsigned)n_tiles, (unsigned)splits), kThreads,
                       kSmem, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(scale),
      static_cast<const int8_t*>(w), static_cast<const float*>(ws), static_cast<T*>(y),
      static_cast<int*>(part), M, N, K, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int* pp = static_cast<const int*>(part);
  const float *sp = static_cast<const float*>(scale), *wp = static_cast<const float*>(ws);
  if (vec)
    w8a8_finish_kernel<T, 4><<<(unsigned)finish_blocks, 256, 0, st>>>(pp, sp, wp,
                                                                     static_cast<T*>(y), M, N,
                                                                     splits);
  else
    w8a8_finish_kernel<T, 1><<<(unsigned)finish_blocks, 256, 0, st>>>(pp, sp, wp,
                                                                     static_cast<T*>(y), M, N,
                                                                     splits);
  return cudaGetLastError();
}

}  // namespace

cudaError_t w8a8_gemm_tc(const void* x, const void* w, const void* w_scale, void* y, void* xq,
                         void* scale, void* part, int splits, int M, int N, int K, int dtype,
                         cudaStream_t st) {
  if (splits < 1 || splits > 65535 || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch<float>(x, w, w_scale, y, xq, scale, part, splits, M, N, K, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, w, w_scale, y, xq, scale, part, splits, M, N, K, st);
  return cudaErrorInvalidValue;
}

}  // namespace tt
