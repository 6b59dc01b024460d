// Tensor-core bodies of the Winograd F(2x2, 3x3) convolution (sm_90a), bf16
// and f32. The C entry point tt_wino_conv3x3 (winograd.cu) takes them where
// wino_tc_body(dtype) holds: both types, any Ci (V and U are zero-padded to
// Cs channels).
//
// Replaces tango_tpu/ops/winograd.py: _wino_kernel (through
// winograd_conv3x3_pallas), with its arithmetic:
//   V = B^T d B    f32 (the row combination first, then the column one),
//                  rounded to x's type (bf16; f32 keeps it as computed)
//   U = G g G^T    f32, rounded to x's type (JAX's XLA code; wino_weight_kernel here)
//   M[pq] = sum_ci V[pq][ci] U[pq][ci][co]   f32 accumulation
//   Y = A^T M A    f32, stored in x's type
// Only the order of the f32 sums differs: the tensor cores add the products
// of a k-step in their own order, Y adds the 16 points in pq order, and the
// f32 body adds each 64-channel chunk's M into Y (below).
//
// What bounds it on the H100: operations, at the UNet's shallow levels (16
// products of Ci x Co per 2x2 tile: 8*Ci*Co flops per tile against ~2 bytes
// an input and output element); bytes at the deep ones, where 32 to 128
// tiles meet Ci x Co up to 2560 x 1280 and U (16/9 the weight's bytes in
// bf16, and the f32 weight it is made from) is read for few tiles. What the
// design does about it:
//   * The 16 contractions run on the tensor cores, both operands K-major in
//     shared memory: A = V[pq] (tiles, Ci), B = U[pq] (Co, Ci). bf16 as
//     wgmma m64n64k16; f32 as 3xTF32 (below).
//   * U comes from its own launch, wino_weight_kernel (one thread a channel
//     pair, f32 in, x's type out in the GEMM's layout), which the wrapper
//     calls before the convolution; the transform is XLA's in JAX, outside
//     the Pallas kernel, and here it is one pass over the weight instead of
//     a chain of torch ops.
//   * wino_input_tc computes V for all 16 points of each (tile, 16-byte
//     packet of channels) from its 4x4 patches, read straight from NCHW x
//     with the edge test as the SAME padding (each input element read 4
//     times, from L1/L2), and writes V (16, tiles, Cs) to scratch the
//     wrapper allocates (Cs = Ci rounded up to 16, the pad zero), through
//     shared memory as 64-byte rows (32 bf16 or 16 f32 channels). Building V
//     inside the GEMM loop instead, point by point, would take 4 scattered
//     loads per value (x is NCHW, so neighbouring channels are H*W apart),
//     several times the tensor cores' time for the same tile; V in memory
//     costs 4x x's bytes written once, and the GEMM reads it with 16-byte
//     copies.
//   * A GEMM block of two warpgroups owns 128 tiles (64 each) x 64 output
//     channels, so the U slice of a stage serves both; it walks its points,
//     Ci in 64-channel chunks for each, and folds M into the four output
//     accumulators with the signs of A^T[a,p] A^T[d,q], so M never leaves
//     registers; one block an SM. The epilogue stores each tile's 2x2
//     outputs as two pairs.
//   * bf16 (wino_gemm_tc): a 6-stage cp.async ring (24 KB a stage,
//     128-byte swizzled, zero-filled past the tiles, Co and Cs); a point's
//     sum runs in one f32 accumulator m and is folded after its last chunk:
//     five 64 x 64 f32 accumulators, 160 registers a thread.
//   * f32 (wino_gemm_tf32): one-product TF32 misses JAX's f32 limit (1e-4)
//     at the JAX tests' shapes, so every product is 3xTF32 (wgmma.cuh: hi =
//     cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), a b = a_hi b_hi + a_hi b_lo
//     + a_lo b_hi), m64n64k8 .tf32. The splits are made on the way into
//     shared memory, which cp.async cannot do: the next chunk's raw 16-byte
//     packets of V and U are loaded into registers during the current
//     chunk, split and stored into the other of 2 stages while its products
//     run, one barrier a chunk (as the f32 attention body). A stage is 128
//     tiles x 64 channels of V plus 64 x 64 of U, each hi and lo: 96 KB, 2
//     stages 192 KB. Registers: the four output accumulators (128), the
//     chunk's accumulator (32) and the prefetch (48); so the cross terms
//     share the chunk's accumulator (mma_tf32x3_ss_folded: the small
//     products first), and each chunk's M starts afresh and is folded into
//     the outputs in f32 at once, so the tensor cores' additions never run
//     longer than one chunk (24 products); no separate point sum m.
//   * Where (tile block, channel block) pairs are too few to fill the card
//     (the deep levels: 20 to 80 blocks), the wrapper splits the 16 points
//     over 2 to 16 blocks (`splits`): each split writes its f32 partial Y,
//     and wino_sum_tc adds the splits in order and stores x's type, so the
//     result stays deterministic.
//   * Blocks: (tile block, split, output-channel block) flattened on grid.x
//     with the channel blocks fastest, so the blocks that run together share
//     their V rows through L2.
// Headroom left for later: V built in the GEMM's prologue from an NHWC copy
// of x (one 16-byte load for 8 channels), TMA loads from a producer warp,
// and a persistent tile loop against the wave quantization of 100-300
// blocks on 132 SMs.
//
// Layout: x (B, Ci, H, W) and y (B, Co, H, W), NCHW, H and W even, bf16 or
// f32; the weight (Co, Ci, 3, 3) f32; U (16, Co, Cs) and V (16, T, Cs) in
// x's type, with T = B * (H/2) * (W/2) tiles numbered row-major per sample;
// the partial sums (splits, B, Co, H, W) f32. Element offsets are 64-bit.

#include "common.cuh"
#include "wgmma.cuh"

namespace tt {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kTiles = 128;              // 2x2 tiles a GEMM block, 64 a warpgroup
constexpr int kCo = 64;                  // output channels a GEMM block
constexpr int kCi = 64;                  // input channels a stage
constexpr int kThreads = 256;            // two warpgroups
constexpr int kStages = 6;               // bf16 ring
constexpr int kTileA = kTiles * kCi * 2;  // 16 KB of bf16 V a stage
constexpr int kTileB = kCo * kCi * 2;     // 8 KB of bf16 U a stage
constexpr int kSmem = kStages * (kTileA + kTileB) + 1024;  // and room to align to 1024
// f32: V and U hi/lo as rows operands (wgmma.cuh), 2 stages
constexpr int kF32A = 4 * kTiles * 128;   // 64 KB of V a stage
constexpr int kF32B = 4 * kCo * 128;      // 32 KB of U a stage
constexpr int kF32Stage = kF32A + kF32B;
constexpr int kF32Smem = 2 * kF32Stage + 1024;
constexpr int kInputThreads = 128;       // threads a block of the elementwise kernels
constexpr int kInTiles = 32;             // tiles of a wino_input_tc block, a lane each

// The B^T combination of four values (rows of B^T: [1 0 -1 0], [0 1 1 0],
// [0 -1 1 0], [0 1 0 -1]), the Pallas kernel's bt_combine.
__device__ __forceinline__ void bt4(float a0, float a1, float a2, float a3, float* o) {
  o[0] = a0 - a2;
  o[1] = a1 + a2;
  o[2] = a2 - a1;
  o[3] = a1 - a3;
}

// V of 32 tiles x 4P channels for all 16 points, P = the channels of a
// 16-byte packet (8 bf16, 4 f32): warp g computes channels Pg .. Pg + P - 1
// of the block's 4P, lane l tile l (so the warp reads neighbouring tiles of
// one channel); the results meet in shared memory (rows padded to 80 bytes
// against bank conflicts) and leave as 64-byte rows of V, four packets each.
template <typename T>
__global__ void __launch_bounds__(kInputThreads)
wino_input_tc(const T* __restrict__ x, T* __restrict__ v, int Ci, int Cs, int H, int W,
              int64_t n_tiles, int c_blocks) {
  constexpr int P = Pack<T>::N;
  constexpr int kRow = 80;  // bytes a staged (point, tile) row of 4 packets
  __shared__ __align__(16) uint8_t sv[16 * kInTiles * kRow];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int64_t t0 = (int64_t)(blockIdx.x / c_blocks) * kInTiles;
  const int c0 = (blockIdx.x % c_blocks) * 4 * P;
  const int64_t tile = t0 + lane;
  const int tw = W / 2, per_sample = (H / 2) * tw;
  const int64_t b = tile / per_sample;
  const int tr = (int)(tile % per_sample) / tw, tc = (int)(tile % per_sample) % tw;

  uint32_t out[16][4];  // the 16 points' packets
#pragma unroll
  for (int c = 0; c < P; ++c) {
    const int ci = c0 + P * g + c;
    const bool ok = tile < n_tiles && ci < Ci;
    float d[4][4];
    const T* plane = x + (b * Ci + (ok ? ci : 0)) * H * W;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 2 * tr + i - 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 2 * tc + j - 1;
        d[i][j] = (ok && r >= 0 && r < H && col >= 0 && col < W)
                      ? to_f32(plane[(int64_t)r * W + col]) : 0.0f;
      }
    }
    float t[4][4];  // t[p][j] = sum_i BT[p][i] d[i][j]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float o[4];
      bt4(d[0][j], d[1][j], d[2][j], d[3][j], o);
#pragma unroll
      for (int p = 0; p < 4; ++p) t[p][j] = o[p];
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float o[4];
      bt4(t[p][0], t[p][1], t[p][2], t[p][3], o);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (P == 4) {
          out[4 * p + q][c] = __float_as_uint(o[q]);
        } else {
          const uint32_t h = __bfloat16_as_ushort(__float2bfloat16(o[q]));
          uint32_t& word = out[4 * p + q][c / 2];
          word = (c & 1) ? (word | (h << 16)) : h;
        }
      }
    }
  }
#pragma unroll
  for (int pq = 0; pq < 16; ++pq)
    *reinterpret_cast<uint4*>(sv + (pq * kInTiles + lane) * kRow + 16 * g) =
        make_uint4(out[pq][0], out[pq][1], out[pq][2], out[pq][3]);
  __syncthreads();
#pragma unroll
  for (int i = threadIdx.x; i < 16 * kInTiles * 4; i += kInputThreads) {
    const int pq = i / (kInTiles * 4), r = (i / 4) % kInTiles, c = i % 4;
    if (t0 + r < n_tiles && c0 + P * c < Cs)
      *reinterpret_cast<uint4*>(v + ((int64_t)pq * n_tiles + t0 + r) * Cs + c0 + P * c) =
          *reinterpret_cast<const uint4*>(sv + (pq * kInTiles + r) * kRow + 16 * c);
  }
}

// A^T = [[1, 1, 1, 0], [0, 1, -1, -1]]: the sign of point p in output row
// (or column) a, 0 where the point does not enter
__device__ __forceinline__ int at_sign(int a, int p) {
  return a == 0 ? (p < 3 ? 1 : 0) : (p == 0 ? 0 : (p == 1 ? 1 : -1));
}

// y += sign * m for a sign of 1, -1 or 0 (exact)
__device__ __forceinline__ void fold(float (&y)[32], const float (&m)[32], int sign) {
  if (sign > 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] += m[i];
  } else if (sign < 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] -= m[i];
  }
}

// M[pq] into the four outputs (a, d) = (0, 0), (0, 1), (1, 0), (1, 1)
__device__ __forceinline__ void fold_point(float (&acc)[4][32], const float (&m)[32], int pq) {
  const int p = pq / 4, q = pq % 4;
  fold(acc[0], m, at_sign(0, p) * at_sign(0, q));
  fold(acc[1], m, at_sign(0, p) * at_sign(1, q));
  fold(acc[2], m, at_sign(1, p) * at_sign(0, q));
  fold(acc[3], m, at_sign(1, p) * at_sign(1, q));
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// U = G g G^T of one (output channel, input channel) pair, computed in f32
// (G g first, then (G g) G^T) and rounded to T, stored K-major as
// U[pq][co][ci] with Cs = Ci rounded up to 16 and zeros past Ci; thread idx
// = co * Cs + ci, so a warp stores neighbouring input channels.
template <typename T>
__global__ void __launch_bounds__(kInputThreads)
wino_weight_kernel(const float* __restrict__ w, T* __restrict__ u, int Co, int Ci, int Cs) {
  const int64_t idx = (int64_t)blockIdx.x * kInputThreads + threadIdx.x;
  if (idx >= (int64_t)Co * Cs) return;
  const int co = (int)(idx / Cs), ci = (int)(idx % Cs);
  float out[16];
  if (ci < Ci) {
    const float* g = w + ((int64_t)co * Ci + ci) * 9;
    float t[4][3];  // t[p][j] = sum_i G[p][i] g[i][j]
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float g0 = g[j], g1 = g[3 + j], g2 = g[6 + j];
      t[0][j] = g0;
      t[1][j] = 0.5f * g0 + 0.5f * g1 + 0.5f * g2;
      t[2][j] = 0.5f * g0 - 0.5f * g1 + 0.5f * g2;
      t[3][j] = g2;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      out[4 * p] = t[p][0];
      out[4 * p + 1] = 0.5f * t[p][0] + 0.5f * t[p][1] + 0.5f * t[p][2];
      out[4 * p + 2] = 0.5f * t[p][0] - 0.5f * t[p][1] + 0.5f * t[p][2];
      out[4 * p + 3] = t[p][2];
    }
  } else {
#pragma unroll
    for (int pq = 0; pq < 16; ++pq) out[pq] = 0.0f;
  }
#pragma unroll
  for (int pq = 0; pq < 16; ++pq) u[((int64_t)pq * Co + co) * Cs + ci] = from_f32<T>(out[pq]);
}

// The epilogue of both GEMMs: the four output accumulators of this thread's
// two tiles, stored in T (one split) or as f32 partial sums into part[split].
// Accumulator layout of m64nN (f32), per thread of a warpgroup: warp w, lane
// l, quad position t = l % 4; rows r0 = 16w + l/4 and r1 = r0 + 8; d[4b + e]
// holds row (e < 2 ? r0 : r1), column 8b + 2t + (e & 1). Rows are tiles
// (warpgroup g owns the block's tiles 64g .. 64g + 63), columns output
// channels.
template <typename T>
__device__ __forceinline__ void store_tiles(const float (&acc)[4][32], T* y, float* part,
                                            int split, int splits, int64_t t0, int co0, int H,
                                            int W, int Co, int64_t n_tiles) {
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t4 = lane & 3;
  const int tw = W / 2, per_sample = (H / 2) * tw;
  float* const ps = splits > 1 ? part + (int64_t)split * n_tiles * 4 * Co : nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t tile = t0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
    if (tile >= n_tiles) continue;
    const int64_t b = tile / per_sample;
    const int tr = (int)(tile % per_sample) / tw, tc = (int)(tile % per_sample) % tw;
#pragma unroll
    for (int i = 0; i < 16; ++i) {  // column 8 (i / 2) + 2 t4 + (i % 2)
      const int co = co0 + 8 * (i / 2) + 2 * t4 + (i % 2);
      if (co >= Co) continue;
      const int e = 4 * (i / 2) + 2 * h + (i % 2);
      const int64_t at = ((b * Co + co) * H + 2 * tr) * W + 2 * tc;
      if (splits == 1) {
        store2(y + at, acc[0][e], acc[1][e]);
        store2(y + at + W, acc[2][e], acc[3][e]);
      } else {
        store2(ps + at, acc[0][e], acc[1][e]);
        store2(ps + at + W, acc[2][e], acc[3][e]);
      }
    }
  }
}

// The bf16 GEMM. A block sums the points s * 16 / splits .. (s + 1) * 16 /
// splits - 1 of split s: with one split it stores y in bf16, with more it
// stores its f32 partial sums into part[s] for wino_sum_tc.
__global__ void __launch_bounds__(kThreads, 1)
wino_gemm_tc(const bf16* __restrict__ v, const bf16* __restrict__ u, bf16* __restrict__ y,
             float* __restrict__ part, int Cs, int H, int W, int Co, int64_t n_tiles,
             int co_blocks, int splits) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sA = base, sB = base + kStages * kTileA;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int co0 = (blockIdx.x % co_blocks) * kCo;
  const int split = (blockIdx.x / co_blocks) % splits;
  const int64_t t0 = (int64_t)(blockIdx.x / co_blocks / splits) * kTiles;
  const int chunks = (Cs + kCi - 1) / kCi;
  const int points = 16 / splits, pq0 = split * points;
  const int steps = points * chunks;  // (point, chunk) pairs, point-major

  auto load = [&](int j) {  // step j into ring slot j % kStages
    const int pq = pq0 + j / chunks, ci = (j % chunks) * kCi, slot = j % kStages;
#pragma unroll
    for (int it = 0; it < kTiles * 8 / kThreads; ++it) {
      const int r = (tid >> 3) + it * (kThreads / 8), c = tid & 7;
      const int k = ci + 8 * c;
      const bool in = t0 + r < n_tiles && k < Cs;
      cp_async16(sA + slot * kTileA + sw128(r, c),
                 in ? v + ((int64_t)pq * n_tiles + t0 + r) * Cs + k : v, in ? 16 : 0);
    }
#pragma unroll
    for (int it = 0; it < kCo * 8 / kThreads; ++it) {
      const int r = (tid >> 3) + it * (kThreads / 8), c = tid & 7;
      const int k = ci + 8 * c;
      const bool in = co0 + r < Co && k < Cs;
      cp_async16(sB + slot * kTileB + sw128(r, c),
                 in ? u + ((int64_t)pq * Co + co0 + r) * Cs + k : u, in ? 16 : 0);
    }
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < steps) load(j);
    cp_async_commit();
  }

  float m[32];       // the current point's sum over Ci
  float acc[4][32];  // the outputs (a, d) = (0, 0), (0, 1), (1, 0), (1, 1)
#pragma unroll
  for (int o = 0; o < 4; ++o)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[o][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) m[i] = 0.0f;

  for (int j = 0; j < steps; ++j) {
    const int slot = j % kStages, chunk = j % chunks;
    cp_async_wait<kStages - 2>();
    fence_async_proxy();
    __syncthreads();
    if (j + kStages - 1 < steps) load(j + kStages - 1);
    cp_async_commit();

    // channels past Cs are zero in both tiles: every chunk takes 4 k16 steps
    const uint64_t da = smem_desc(sA + slot * kTileA + wg * 64 * 128, 16, 1024);
    const uint64_t db = smem_desc(sB + slot * kTileB, 16, 1024);
    fence_regs(m);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kCi / 16; ++kk)
      wgmma_ss64(m, da + 2 * kk, db + 2 * kk, chunk > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(m);

    if (chunk == chunks - 1) fold_point(acc, m, pq0 + j / chunks);  // the point's last chunk
  }
  store_tiles(acc, y, part, split, splits, t0, co0, H, W, Co, n_tiles);
}

// The f32 GEMM on 3xTF32 products (see the note at the top): the same blocks,
// splits and epilogue as wino_gemm_tc; 2 stages filled from registers.
__global__ void __launch_bounds__(kThreads, 1)
wino_gemm_tf32(const float* __restrict__ v, const float* __restrict__ u, float* __restrict__ y,
               float* __restrict__ part, int Cs, int H, int W, int Co, int64_t n_tiles,
               int co_blocks, int splits) {
  constexpr int kPerA = kTiles * 16 / kThreads, kPerB = kCo * 16 / kThreads;  // packets a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int co0 = (blockIdx.x % co_blocks) * kCo;
  const int split = (blockIdx.x / co_blocks) % splits;
  const int64_t t0 = (int64_t)(blockIdx.x / co_blocks / splits) * kTiles;
  const int chunks = (Cs + kCi - 1) / kCi;
  const int points = 16 / splits, pq0 = split * points;
  const int steps = points * chunks;  // (point, chunk) pairs, point-major

  // the next step's raw packets: packet y of a stage is row y / 16, channels
  // 4 (y % 16) .. + 3, so a warp reads two rows' 256 contiguous bytes
  uint4 ra[kPerA], rb[kPerB];
  auto load = [&](int j) {
    const int pq = pq0 + j / chunks, ci = (j % chunks) * kCi;
#pragma unroll
    for (int i = 0; i < kPerA; ++i) {
      const int y = tid + i * kThreads, r = y >> 4, k = ci + 4 * (y & 15);
      ra[i] = t0 + r < n_tiles && k < Cs
                  ? *reinterpret_cast<const uint4*>(v + ((int64_t)pq * n_tiles + t0 + r) * Cs + k)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kPerB; ++i) {
      const int y = tid + i * kThreads, r = y >> 4, k = ci + 4 * (y & 15);
      rb[i] = co0 + r < Co && k < Cs
                  ? *reinterpret_cast<const uint4*>(u + ((int64_t)pq * Co + co0 + r) * Cs + k)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto stage = [&](int slot) {
    uint8_t* st = gbase + slot * kF32Stage;
#pragma unroll
    for (int i = 0; i < kPerA; ++i) {
      const int y = tid + i * kThreads;
      stage_tf32_rows(st, kTiles, y >> 4, y & 15, ra[i]);
    }
#pragma unroll
    for (int i = 0; i < kPerB; ++i) {
      const int y = tid + i * kThreads;
      stage_tf32_rows(st + kF32A, kCo, y >> 4, y & 15, rb[i]);
    }
  };

  load(0);
  stage(0);
  fence_async_proxy();
  __syncthreads();
  if (steps > 1) load(1);

  float acc[4][32];  // the outputs (a, d) = (0, 0), (0, 1), (1, 0), (1, 1)
#pragma unroll
  for (int o = 0; o < 4; ++o)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[o][i] = 0.0f;

  for (int j = 0; j < steps; ++j) {
    const uint32_t sA = base + (j & 1) * kF32Stage;
    float m[32];  // this chunk's M[pq], cross terms included
    wgmma_fence();
    mma_tf32x3_ss_folded<kCo>(m, sA, kTiles, wg * 64, sA + kF32A);
    wgmma_commit();
    // while the products run: stage step j + 1 into the other stage (free
    // since the barrier that ended step j - 1), then load step j + 2
    if (j + 1 < steps) {
      stage((j + 1) & 1);
      fence_async_proxy();
      if (j + 2 < steps) load(j + 2);
    }
    wgmma_wait_all();
    fence_regs(m);
    fold_point(acc, m, pq0 + j / chunks);
    __syncthreads();  // step j + 1 is staged, and no warpgroup reads step j any more
  }
  store_tiles(acc, y, part, split, splits, t0, co0, H, W, Co, n_tiles);
}

// y = sum over the splits of part[s], in split order, in f32, stored as T;
// four elements a thread (H and W are even, so n is a multiple of 4).
template <typename T>
__global__ void __launch_bounds__(kInputThreads)
wino_sum_tc(const float* __restrict__ part, T* __restrict__ y, int64_t n, int splits) {
  const int64_t i = ((int64_t)blockIdx.x * kInputThreads + threadIdx.x) * 4;
  if (i >= n) return;
  float4 s = *reinterpret_cast<const float4*>(part + i);
  for (int k = 1; k < splits; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(part + k * n + i);
    s.x += a.x;
    s.y += a.y;
    s.z += a.z;
    s.w += a.w;
  }
  store2(y + i, s.x, s.y);
  store2(y + i + 2, s.z, s.w);
}

template <typename T>
cudaError_t weight(const void* w, void* u, int Co, int Ci, cudaStream_t st) {
  const int Cs = (Ci + 15) / 16 * 16;
  const int64_t blocks = ((int64_t)Co * Cs + kInputThreads - 1) / kInputThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  wino_weight_kernel<T><<<(unsigned)blocks, kInputThreads, 0, st>>>(
      static_cast<const float*>(w), static_cast<T*>(u), Co, Ci, Cs);
  return cudaGetLastError();
}

// The input transform, the GEMM (gemm, with smem bytes of dynamic shared
// memory) and, for splits > 1, the sum of the splits.
template <typename T, typename Gemm>
cudaError_t conv(Gemm gemm, int smem, const void* x, const void* u, void* y, void* v, void* part,
                 int splits, int B, int Ci, int H, int W, int Co, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int Cs = (Ci + 15) / 16 * 16;
  const int64_t n_tiles = (int64_t)B * (H / 2) * (W / 2);
  const int c_blocks = (Cs + 4 * Pack<T>::N - 1) / (4 * Pack<T>::N);
  const int64_t in_blocks = (n_tiles + kInTiles - 1) / kInTiles * c_blocks;
  const int co_blocks = (Co + kCo - 1) / kCo;
  const int64_t blocks = (n_tiles + kTiles - 1) / kTiles * splits * co_blocks;
  const int64_t n = n_tiles * 4 * Co;  // elements of y
  const int64_t sum_blocks = (n / 4 + kInputThreads - 1) / kInputThreads;
  if (in_blocks > 0x7fffffff || blocks > 0x7fffffff || sum_blocks > 0x7fffffff)
    return cudaErrorInvalidConfiguration;
  wino_input_tc<T><<<(unsigned)in_blocks, kInputThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(v), Ci, Cs, H, W, n_tiles, c_blocks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gemm<<<(unsigned)blocks, kThreads, smem, st>>>(
      static_cast<const T*>(v), static_cast<const T*>(u), static_cast<T*>(y),
      static_cast<float*>(part), Cs, H, W, Co, n_tiles, co_blocks, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  wino_sum_tc<T><<<(unsigned)sum_blocks, kInputThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<T*>(y), n, splits);
  return cudaGetLastError();
}

}  // namespace

cudaError_t wino_weight_tc(const void* w, void* u, int Co, int Ci, int dtype, cudaStream_t st) {
  if (dtype == kF32) return weight<float>(w, u, Co, Ci, st);
  if (dtype == kBF16) return weight<bf16>(w, u, Co, Ci, st);
  return cudaErrorInvalidValue;
}

cudaError_t wino_conv3x3_tc(const void* x, const void* u, void* y, void* v, void* part,
                            int splits, int B, int Ci, int H, int W, int Co, int dtype,
                            cudaStream_t st) {
  if (splits < 1 || splits > 16 || 16 % splits || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (dtype == kF32)
    return conv<float>(wino_gemm_tf32, kF32Smem, x, u, y, v, part, splits, B, Ci, H, W, Co, st);
  if (dtype == kBF16)
    return conv<bf16>(wino_gemm_tc, kSmem, x, u, y, v, part, splits, B, Ci, H, W, Co, st);
  return cudaErrorInvalidValue;
}

}  // namespace tt
