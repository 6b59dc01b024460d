// Winograd F(2x2, 3x3) convolution, 3x3 stride-1 SAME, entry point
// tt_wino_conv3x3, and its CUDA-core body. The entry point takes the
// tensor-core body of winograd_tc.cu where wino_tc_body(dtype) holds (bf16)
// and reports it by returning kTcLaunched; this file's body runs f32. The
// two bodies take U in different layouts (the wrapper applies the same
// rule): (16, Ci, Co) here, (16, Co, Cs) K-major there.
//
// Replaces tango_tpu/ops/winograd.py: _wino_kernel (through
// winograd_conv3x3_pallas). Same function, step for step, for each 2x2 output
// tile (tile row t, tile column s) of each sample:
//   d[i][j] = x[2t + i - 1][2s + j - 1]     (4x4 input patch, zero outside the
//                                             map: SAME padding of 1)
//   V = B^T d B                              (f32: the row combination first,
//                                             then the column one, as the
//                                             Pallas kernel; then rounded to T)
//   M[pq] = sum_ci V[pq][ci] * U[pq][ci][co] (f32 accumulation, 16 points pq)
//   Y = A^T M A                              (f32, 2x2 outputs, stored as T)
// U = G g G^T (16, Ci, Co), already rounded to T, comes from the wrapper
// (torch, f32 then cast, as winograd_conv3x3_pallas computes it in XLA).
// x is (B, Ci, H, W) and y (B, Co, H, W), NCHW, with H and W even.
//
// What bounds it on the H100: operations, at the UNet's shapes (Ci and Co
// 320 to 2560): 4 multiply-adds an output per input channel against ~2 bytes
// an input and an output element. This first version takes the channel
// products on the CUDA cores in f32 (no tensor cores); what its design does
// about the bound is compute each input transform once a block and keep it,
// and a chunk of U, in shared memory for 32 output channels, with the 64
// accumulators of a thread in registers. The Pallas kernel read a tile-row
// block and its 2-row halo as two views of the padded input; here each
// patch is read straight from x with the edge test in place of the padding,
// so adjacent tile-row blocks overlap by two rows through the cache, not
// through a second copy.
//
// Layout: a block owns 32 consecutive tiles of one sample (tiles numbered
// row-major over the (H/2) x (W/2) tile grid, so at the UNet's W = 2 to 16 a
// block spans several tile rows) and 32 output channels; it walks Ci in
// chunks of 8. 256 threads: for the input transform thread (c, p) = (tid /
// 32, tid % 32) transforms tile p of channel c of the chunk; for the
// products and the output thread (g, p) owns tile p and channels 4g..4g+3,
// so a warp reads 32 distinct V values and one broadcast float4 of U. Blocks:
// (sample, tile block) flattened on grid.x, channel blocks on grid.y. Element
// offsets are 64-bit.

#include "common.cuh"

namespace tt {
namespace {

constexpr int kTiles = 32;   // 2x2 output tiles a block
constexpr int kCoB = 32;     // output channels a block
constexpr int kCiC = 8;      // input channels a chunk
constexpr int kThreads = 256;

// The B^T combination of four values (rows of B^T: [1 0 -1 0], [0 1 1 0],
// [0 -1 1 0], [0 1 0 -1]), the Pallas kernel's bt_combine.
__device__ __forceinline__ void bt4(float a0, float a1, float a2, float a3, float* o) {
  o[0] = a0 - a2;
  o[1] = a1 + a2;
  o[2] = a2 - a1;
  o[3] = a1 - a3;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wino_kernel(const T* __restrict__ x, const T* __restrict__ u, T* __restrict__ y, int Ci,
            int H, int W, int Co, int tile_blocks) {
  __shared__ float s_v[16][kCiC][kTiles];
  __shared__ __align__(16) float s_u[16][kCiC][kCoB];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / tile_blocks;
  const int tw = W / 2, n_tiles = (H / 2) * tw;
  const int p = tid % kTiles;
  const int tile = (blockIdx.x % tile_blocks) * kTiles + p;
  const int co0 = blockIdx.y * kCoB;
  const int g = tid / kTiles;  // 0..7: the input channel of the transform, the
                               // output-channel group of the products
  const int tr = tile / tw, tc = tile % tw;
  const bool tile_ok = tile < n_tiles;

  float acc[16][4];
#pragma unroll
  for (int pq = 0; pq < 16; ++pq)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[pq][j] = 0.0f;

  for (int ci0 = 0; ci0 < Ci; ci0 += kCiC) {
    // the input transform of (tile p, channel ci0 + g)
    {
      const int ci = ci0 + g;
      float d[4][4];
      const bool ok = tile_ok && ci < Ci;
      const T* plane = x + ((int64_t)b * Ci + (ok ? ci : 0)) * H * W;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 2 * tr + i - 1;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 2 * tc + j - 1;
          d[i][j] = (ok && r >= 0 && r < H && c >= 0 && c < W)
                        ? to_f32(plane[(int64_t)r * W + c]) : 0.0f;
        }
      }
      float t[4][4];  // t[p][j] = sum_i BT[p][i] d[i][j]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float o[4];
        bt4(d[0][j], d[1][j], d[2][j], d[3][j], o);
#pragma unroll
        for (int q = 0; q < 4; ++q) t[q][j] = o[q];
      }
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        float o[4];
        bt4(t[pp][0], t[pp][1], t[pp][2], t[pp][3], o);
#pragma unroll
        for (int q = 0; q < 4; ++q) s_v[4 * pp + q][g][p] = round_to<T>(o[q]);
      }
    }
    // the chunk of U: 16 x kCiC x kCoB values
    for (int e = tid; e < 16 * kCiC * kCoB; e += kThreads) {
      const int pq = e / (kCiC * kCoB), c = (e / kCoB) % kCiC, o = e % kCoB;
      const int ci = ci0 + c, co = co0 + o;
      s_u[pq][c][o] = (ci < Ci && co < Co) ? to_f32(u[((int64_t)pq * Ci + ci) * Co + co]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kCiC; ++c) {
#pragma unroll
      for (int pq = 0; pq < 16; ++pq) {
        const float v = s_v[pq][c][p];
        const float4 w4 = *reinterpret_cast<const float4*>(&s_u[pq][c][4 * g]);
        acc[pq][0] = fmaf(v, w4.x, acc[pq][0]);
        acc[pq][1] = fmaf(v, w4.y, acc[pq][1]);
        acc[pq][2] = fmaf(v, w4.z, acc[pq][2]);
        acc[pq][3] = fmaf(v, w4.w, acc[pq][3]);
      }
    }
    __syncthreads();
  }

  if (!tile_ok) return;
  // the inverse transform (A^T rows [1 1 1 0], [0 1 -1 -1]: over p first,
  // then over q, as the Pallas kernel's at_combine) and the store
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + 4 * g + j;
    if (co >= Co) continue;
    float ya[2][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float m0 = acc[q][j], m1 = acc[4 + q][j], m2 = acc[8 + q][j], m3 = acc[12 + q][j];
      ya[0][q] = m0 + m1 + m2;
      ya[1][q] = m1 - m2 - m3;
    }
    T* out = y + ((int64_t)b * Co + co) * H * W;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int64_t row = (int64_t)(2 * tr + a) * W + 2 * tc;
      out[row] = from_f32<T>(ya[a][0] + ya[a][1] + ya[a][2]);
      out[row + 1] = from_f32<T>(ya[a][1] - ya[a][2] - ya[a][3]);
    }
  }
}

template <typename T>
void launch(const void* x, const void* u, void* y, int B, int Ci, int H, int W, int Co,
            cudaStream_t st) {
  const int n_tiles = (H / 2) * (W / 2);
  const int tile_blocks = (n_tiles + kTiles - 1) / kTiles;
  const dim3 grid((unsigned)(B * tile_blocks), (unsigned)((Co + kCoB - 1) / kCoB));
  wino_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x),
                                            static_cast<const T*>(u), static_cast<T*>(y), Ci,
                                            H, W, Co, tile_blocks);
}

}  // namespace

cudaError_t wino_conv3x3_tc(const void* x, const void* u, void* y, void* v, void* part,
                            int splits, int B, int Ci, int H, int W, int Co, cudaStream_t st);
cudaError_t wino_weight_tc(const void* w, void* u, int Co, int Ci, cudaStream_t st);

// wino_tc_body(dtype): the rule by which tt_wino_conv3x3 takes the
// tensor-core body, bf16 (wino_tc_body in ops/winograd.py is the same rule,
// for U's layout and V's scratch; its counter reads the kTcLaunched report).
bool wino_tc_body(int dtype) { return dtype == kBF16; }

}  // namespace tt

extern "C" {

// U (16, Co, Cs) bf16 of the tensor-core body from an f32 OIHW weight (Co,
// Ci, 3, 3), Cs = Ci rounded up to 16.
int tt_wino_weight(const void* w, void* u, int Co, int Ci, void* stream) {
  if (Co <= 0 || Ci <= 0) return (int)cudaErrorInvalidValue;
  return (int)tt::wino_weight_tc(w, u, Co, Ci, static_cast<cudaStream_t>(stream));
}

// v and part are the tensor-core body's scratch: V (16, B*(H/2)*(W/2), Ci
// rounded up to 16) bf16 and, for splits > 1, the partial sums (splits, B,
// Co, H, W) f32 (null for the CUDA-core body, and part for one split).
int tt_wino_conv3x3(const void* x, const void* u, void* y, void* v, void* part, int splits,
                    int B, int Ci, int H, int W, int Co, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Ci <= 0 || Co <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  if (tt::wino_tc_body(dtype)) {
    if (v == nullptr) return (int)cudaErrorInvalidValue;
    return tt::tc_result(tt::wino_conv3x3_tc(x, u, y, v, part, splits, B, Ci, H, W, Co, st));
  }
  if (dtype == tt::kF32)
    tt::launch<float>(x, u, y, B, Ci, H, W, Co, st);
  else if (dtype == tt::kBF16)
    tt::launch<__nv_bfloat16>(x, u, y, B, Ci, H, W, Co, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
