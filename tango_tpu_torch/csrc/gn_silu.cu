// GroupNorm(+SiLU) for channels-first (NCHW) activations, f32 statistics.
//
// Replaces tango_tpu/ops/gn_silu_pallas.py: _gn_kernel (single pass),
// _gn_stats_kernel + _gn_apply_kernel (two stage) and _gn_bwd_kernel (the
// backward). The port keeps activations
// NCHW for cuDNN's convolutions, so one (batch, group) is one contiguous run of
// (C/G) * HW elements; the Pallas kernels worked on channels-last blocks of a
// whole sample and reduced channels to groups with a 0/1 matmul, which a
// contiguous group does not need.
//
// What bounds it on the H100: bytes. GroupNorm does ~8 flops per element, far
// below the ~295 flops per byte the card needs to be compute bound, so the
// least time is one read of x and one write of y at 3.35 TB/s.
//
// gn_fwd, the cluster body (gn_fwd_cluster_kernel): R CTAs per (batch,
// group) in one thread-block cluster, R a power of two up to 16
// (gn_fwd_cluster_size). The Pallas kernel had one program per sample, and a
// block per group (the streaming body below) leaves 32-128 blocks for 132
// SMs at the paths' batches, each with one 16-byte load a thread in flight
// and a second pass over the group. Here each CTA issues the copies of its
// whole 1/R slice of the group's x into shared memory at once (cp.async,
// 16-byte packets; warp 0 fetches the slice's gamma_c, beta_c meanwhile),
// sums x and x^2 of it in f32, and pushes the pair into every peer's inbox
// (st.async onto the peer's mbarrier, see below); warp 0 adds the R pairs in
// rank order (the same bits in every CTA), turns gamma_c, beta_c into the
// affine a_c, b_c, and the CTA writes y = x*a_c + b_c (+SiLU) from its copy:
// device memory sees one read of x and one write of y, the bytes bound. R
// is the least power of two whose slice fits 72 KB and whose grid has at
// least 264 CTAs (two an SM) or whose slices would fall below 16 KB at 2R;
// else the largest R where the slice fits 226 KB (one CTA an SM); else the
// streaming body. At R = 1 the CTA skips the exchange. CTAs of 256
// threads. It needs HW a whole number of packets and 16-byte aligned x and
// y; the entry point reports it by returning kClusterLaunched.
//
// What the chip measured (scripts/gn_fwd_variants.py on the H100, the 50
// shapes of the paths; PERF.md): a launch takes about its bytes
// bound plus a fixed 3-4 us (a kernel in a CUDA graph, the load latency,
// the exchange), so the design cuts the fixed part and the apply pass's
// instructions. SiLU on the fast intrinsics (silu_fast): the IEEE
// exponential and division, ~20 instructions an element, had nothing to
// hide behind in the apply pass. R stays 1 where slices would fall below
// 16 KB: the 64- and 256-token maps' groups are faster whole in one CTA
// than cut for more CTAs (a rule without that floor was slower; 8 and 32 KB
// measured within a few percent). gamma and beta are fetched during the
// copies. The pairs are pushed, not pulled after a cluster barrier (a draft
// that pulled was slower at every shape with R > 1), and a CTA exits
// without a second barrier. 264 CTAs beat 132.
//
// gn_fwd, the streaming body (gn_fwd_kernel), for what the cluster body
// refuses: one block per (batch, group) sums x and x^2 in f32 (per-thread
// partials, warp shuffles, then shared memory), then applies the per-channel
// affine y = x*a + b (+SiLU) in the same launch; the second read of the group
// hits L2.
//
// gn_stats / gn_apply: the two-stage form for large maps. gn_stats writes
// per-(batch, group, chunk) partial sums; the caller combines them into
// per-channel a, b (tiny torch ops, as the combine was XLA in JAX); gn_apply
// streams y = x*a + b (+SiLU) over a (B*C, blocks a row) grid.
//
// Limits: every element offset is 64-bit, and every grid puts its large
// extent (B*G, B*G*chunks, B*C) on grid.x, so a tensor may hold 2^31 elements
// or more; only B, C, HW and those block counts are 32-bit (below 2^31).
//
// gn_bwd, the cluster body (gn_bwd_cluster_kernel): R CTAs per (batch,
// group), R a power of two up to 16 (gn_bwd_cluster_size), in one
// thread-block cluster with those of the group's other samples where B*R is
// at most 16 (the trainer's batch 2 at R <= 8), else on their own
// (gn_bwd_cluster_samples). Each CTA copies its 1/R slice of the group's x and
// g into shared memory once (cp.async, 16-byte packets: x in one copy group,
// g in a second, so the statistics start while g lands), and every later
// pass reads that copy: device memory sees one read of x and g and one
// write of dx, the bytes bound. The CTAs of a cluster combine what the
// group needs through distributed shared memory (mapa + ld.shared::cluster
// after barrier.cluster), each CTA summing the R partials in rank order, so
// that every CTA holds the same bits:
//   1. sum x, x^2 of the slice -> the group's mean, inv;
//   2. per-channel dbeta_c, dgamma_c of the slice (a channel may straddle
//      slices: each CTA sums only its own elements, and the R partials of a
//      channel add up to it once) -> the group's, and the two group means
//      of dx; rank 0 writes them to dparam, summed over the cluster's
//      samples (no global atomics, and no sum over B left to the caller
//      where the cluster holds the batch); in f32 on the
//      SiLU route dpre replaces g in shared memory;
//   3. dx for the slice (from that dpre, not a second sigmoid).
// A CTA reads its peers' shared memory only between the first cluster
// barrier and its last arrive, and waits for every peer's arrive before it
// exits. R is the least power of two whose slice fits 72 KB (three CTAs an
// SM) with at least 132 CTAs (the H100's SMs) in the grid; else R = 8 if
// the slice fits one CTA's 226 KB; else the streaming body below. At the
// trainer's batch 2 and 32 groups that is 256-1024 CTAs instead of 64
// blocks, of 256 threads, or 128 where many small CTAs share an SM. It
// needs HW a whole number of packets and 16-byte aligned x, g, dx; the
// entry point reports it by returning kClusterLaunched.
//
// gn_bwd, the streaming body (gn_bwd_kernel): one block per (batch, group),
// streaming the group from device memory (the Pallas kernel held a whole
// sample in VMEM, hence its 8 MB limit; this one has none, so it also serves
// groups too large for the cluster body, e.g. the VAE decoder's). Three
// passes over the group, the later two mostly from L2:
//   1. sum x, x^2 -> mean, inv (the forward's statistics, recomputed);
//   2. per channel: dbeta_c = sum dpre, dgamma_c = sum dpre * xhat, where
//      dpre = g * silu'(y) on the SiLU route (y = xhat*gamma + beta) and g
//      otherwise. The work is cut into (channel, slice) items, one warp per
//      item, at least as many items as warps: at 64 or 256 tokens a channel
//      is one warp's work (a block-wide loop channel by channel would idle
//      most of the block, the forward's lesson), at 4096 tokens a channel is
//      split across warps. Warps add their item into shared per-channel sums;
//   3. dx = inv * (gamma_c*dpre - mean_g(gamma*dpre) - xhat *
//      mean_g(gamma*dpre*xhat)), the two group means taken from the
//      per-channel sums of pass 2.
// dgamma, dbeta come out per sample, (B, 2, C) f32 (from the cluster body
// where a cluster holds one sample); the caller sums over B. Bound: bytes,
// one read of x and g and one write of dx.
//
// gn_bwd_stats + gn_bwd_apply: the backward split at its group sums, as
// gn_stats / gn_apply split the forward, for sequence parallelism, where a
// group spans the slabs of every model rank (_gn_bwd_kernel's reduction over
// the group inside one launch cannot see the other slabs). gn_bwd_stats
// writes each channel's sum dpre * xhat and sum dpre (dgamma, dbeta of the
// slab) and each group's (sum gamma*dpre, sum gamma*dpre*xhat) from the
// forward's saved mean and inv; the caller all-reduces the group sums over
// the slabs, and gn_bwd_apply writes dx = inv*(gamma_c*dpre - m1 - xhat*m2).
// Bound: bytes, two passes of x's size (x, g read) and three (x, g read, dx
// written). The slabs of a long clip are small (HW 64 to 4096 at batch 1,
// 32 groups: 0.1-4.7 us of bytes a call), so what a call costs beyond its
// bytes is the launch, one trip to device memory and the combine.
//
// gn_bwd_stats, the cluster body (gn_bwd_stats_cluster_kernel): R CTAs of
// 128 threads per (batch, group) in one thread-block cluster, R a power of
// two up to 16 (gn_bwd_stats_cluster_size): the least R whose grid has at
// least 264 CTAs (two an SM), or 132 where the slices of x and g at 2R
// would fall below 16 KB. Each CTA reads its 1/R slice of the group's x and
// g straight from device memory (slice_sums: each warp a contiguous run of
// 16-byte packets, 8 elements of x and of g a lane a step, so a 64-token
// map's short channels keep every lane busy), recomputes xhat, y and SiLU'
// (on the multi-function unit, dsilu_fast), and adds its per-channel sums
// in shared memory. Every rank pushes those into rank 0's inbox (st.async
// onto rank 0's mbarrier, as the forward's exchange) and exits; rank 0 adds
// the R partials of each channel in rank order and writes the dparam rows
// and the group's two sums. One launch a call: no ticket, no fence, no
// serial tail, no buffer to zero.
//
// What the chip measured (scripts/gn_bwd_split_variants.py on an NVIDIA
// H100 80GB HBM3 at 700 W, the 18 slabs of SP training; PERF.md): a
// cluster launch that does nothing but its syncs takes ~2.2 us a call and
// the exchange with rank 0's tail ~0.8 us more (--parts), so at the 64- to
// 256-token slabs the fixed part is most of a 4-6 us call. Staging the slice in
// shared memory (cp.async) measured no faster than reading it straight
// into registers, and in f32 its 61 KB slices left a second wave at 512
// CTAs; channel_sums' warp a channel took one trip to memory a channel (10
// in a row for a warp at 64 tokens); staging in 2 or 4 copy groups, R = 1
// for small groups, 256-thread CTAs, 132 CTAs, other slice floors and the
// IEEE SiLU' were each no faster.
//
// gn_bwd_apply, the flat body (gn_bwd_apply_flat_kernel): the slab as one
// flat run of 16-byte packets, K packets of x and of g a thread (all loads
// issued first), the CTA a contiguous run of 256*K packets, K the least up
// to 4 that keeps the grid within 264 CTAs (gn_bwd_apply_flat_grid). While
// the loads fly, the CTA folds the per-(b, c) terms of its rows into four
// coefficients in shared memory, a = inv*gamma, b = beta - mean*a (y = x*a
// + b), k2 = -inv^2*m2, k0 = inv^2*m2*mean - inv*m1, so that dx = a*dpre +
// k2*x + k0 costs a few fused multiply-adds and SiLU' an element
// (dsilu_fast). A packet's row is its offset over HW (HW a whole number of
// packets, so a packet never straddles two channels). Measured (the same
// script): the IEEE SiLU' ~24% slower in bf16 and ~9% in f32; one packet a
// thread within a few percent either way.
//
// The first bodies stay as the streaming fallbacks for what the new ones
// refuse (HW not a whole number of packets; x, g or dx not 16-byte aligned;
// gn_bwd_stats' groups of 2^30 elements, or too many channels for rank 0's
// inbox): gn_bwd_stats_kernel, a
// block of 256 threads a channel row, the group's last block (a ticket
// after a fence) adding the group's rows in channel order; and
// gn_bwd_apply_kernel over gn_apply's (B*C, x-blocks) grid. The entry
// points tt_gn_bwd_stats_rows / tt_gn_bwd_apply_rows launch them at any
// alignment, as a yardstick of the new bodies (no path calls them).
//
// Statistics follow the Pallas kernels: var = E[x^2] - mean^2, inv =
// 1/sqrt(var + eps).

#include <climits>

#include "common.cuh"
#include "wgmma.cuh"

namespace tt {
namespace {

constexpr int kFwdThreads = 512;
constexpr int kStatsThreads = 256;
constexpr int kApplyThreads = 256;
constexpr int kBwdThreads = 512;
constexpr int kSplitThreads = 256;  // gn_bwd_stats, gn_bwd_apply

// Sums a and b over the block; every thread gets the totals.
template <int NT>
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[32], sb[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < NT / 32 ? sa[lane] : 0.0f;
    b = lane < NT / 32 ? sb[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
      sa[0] = a;
      sb[0] = b;
    }
  }
  __syncthreads();
  a = sa[0];
  b = sb[0];
}

// Partial sum and sum of squares of n contiguous elements, strided over the
// block's threads. VEC: n and p are 16-byte aligned in packets.
template <typename T, bool VEC>
__device__ __forceinline__ void partial_sums(const T* p, int64_t n, float& s, float& ss) {
  if (VEC) {
    constexpr int N = Pack<T>::N;
    float v[N];
    for (int64_t i = (int64_t)threadIdx.x * N; i < n; i += (int64_t)blockDim.x * N) {
      load_pack(p + i, v);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        s += v[j];
        ss += v[j] * v[j];
      }
    }
  } else {
    for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
      const float v = to_f32(p[i]);
      s += v;
      ss += v * v;
    }
  }
}

// y[i] = act(x[i]*a + b) over n contiguous elements, strided from `start`.
template <typename T, bool VEC>
__device__ __forceinline__ void affine_row(const T* x, T* y, int64_t n, float a, float b,
                                           int act, int64_t start, int64_t step) {
  if (VEC) {
    constexpr int N = Pack<T>::N;
    float v[N];
    for (int64_t i = start * N; i < n; i += step * N) {
      load_pack(x + i, v);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        v[j] = v[j] * a + b;
        if (act) v[j] = silu(v[j]);
      }
      store_pack(y + i, v);
    }
  } else {
    for (int64_t i = start; i < n; i += step) {
      float v = to_f32(x[i]) * a + b;
      if (act) v = silu(v);
      y[i] = from_f32<T>(v);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kFwdThreads)
gn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y, int C, int HW, int G,
              float eps, int act) {
  const int b = blockIdx.x / G, g = blockIdx.x % G;
  const int cg = C / G;
  const int64_t n = (int64_t)cg * HW;
  const int64_t base = ((int64_t)b * C + (int64_t)g * cg) * HW;
  float s = 0.0f, ss = 0.0f;
  partial_sums<T, VEC>(x + base, n, s, ss);
  block_sum2<kFwdThreads>(s, ss);
  const float nf = (float)n;
  const float mean = s / nf;
  const float var = ss / nf - mean * mean;
  const float inv = 1.0f / sqrtf(var + eps);
  // the whole group at once, not channel by channel: a channel row of a
  // low-resolution map (HW = 64) would keep most of the block idle. A packet
  // never straddles two channels (HW is a whole number of packets).
  const T* xg = x + base;
  T* yg = y + base;
  constexpr int N = VEC ? Pack<T>::N : 1;
  for (int64_t i = (int64_t)threadIdx.x * N; i < n; i += (int64_t)blockDim.x * N) {
    const int ch = g * cg + (int)(i / HW);
    const float a = inv * gamma[ch];
    const float bb = beta[ch] - mean * a;
    affine_row<T, VEC>(xg + i, yg + i, N, a, bb, act, 0, 1);
  }
}

// grid (B*G*chunks): block bg*chunks + k sums chunk k of group bg into
// parts[(bg*chunks + k)*2 + {0: sum, 1: sum of squares}]. One flat grid.x
// (up to 2^31 - 1 blocks): grid.y would cap B*G at 65535.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kStatsThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ parts, int C, int HW, int G,
                int chunks) {
  const int64_t bg = blockIdx.x / chunks;
  const int k = blockIdx.x % chunks;
  const int64_t b = bg / G;
  const int g = bg % G;
  const int cg = C / G;
  const int64_t len = (int64_t)cg * HW / chunks;
  const int64_t base = (b * C + (int64_t)g * cg) * HW + (int64_t)k * len;
  float s = 0.0f, ss = 0.0f;
  partial_sums<T, VEC>(x + base, len, s, ss);
  block_sum2<kStatsThreads>(s, ss);
  if (threadIdx.x == 0) {
    parts[(int64_t)blockIdx.x * 2 + 0] = s;
    parts[(int64_t)blockIdx.x * 2 + 1] = ss;
  }
}

// grid (B*C, x-blocks): row bc of HW elements, y = act(x*a[bc] + b[bc]). The
// rows go on grid.x (up to 2^31 - 1), the few blocks a row on grid.y.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ bcoef, T* __restrict__ y, int HW, int act) {
  const int64_t row = blockIdx.x;
  const int64_t off = row * HW;
  affine_row<T, VEC>(x + off, y + off, HW, a[row], bcoef[row], act,
                     (int64_t)blockIdx.y * blockDim.x + threadIdx.x,
                     (int64_t)gridDim.y * blockDim.x);
}

// d(act(y))/dy * g with y = xhat*gamma + beta: g * silu'(y) on the SiLU route.
__device__ __forceinline__ float gn_dpre(float g, float xh, float gam, float bet, int act) {
  if (!act) return g;
  const float y = xh * gam + bet;
  const float sg = 1.0f / (1.0f + expf(-y));
  return g * (sg * (1.0f + y * (1.0f - sg)));
}

// silu'(y) = s*(1 + y*(1 - s)), s the sigmoid, on the multi-function unit
// in place of the IEEE exponential and division (some twenty instructions).
// f32 storage: the fast exponential and division, one operation each, s
// within a few f32 ulps of the IEEE form's (1 + e^-y past 2^126 makes s 0,
// its value to f32 precision). bf16 storage: s = (1 + tanh(y/2))/2 on the
// one-operation tanh, whose error (about 2^-11 relative) lies far below a
// bf16 step, as silu_fast's.
template <typename T>
__device__ __forceinline__ float dsilu_fast(float y) {
  float s;
  if constexpr (sizeof(T) == 2) {
    asm("tanh.approx.f32 %0, %1;\n" : "=f"(s) : "f"(0.5f * y));
    s = fmaf(0.5f, s, 0.5f);
  } else {
    s = __fdividef(1.0f, 1.0f + __expf(-y));
  }
  return s * fmaf(y, 1.0f - s, 1.0f);
}

// gn_dpre with SiLU' on dsilu_fast.
template <typename T>
__device__ __forceinline__ float gn_dpre_fast(float g, float xh, float gam, float bet, int act) {
  return act ? g * dsilu_fast<T>(fmaf(xh, gam, bet)) : g;
}

// N values from p (a 16-byte packet of T where N > 1), as f32, and back.
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float* v) {
  if constexpr (N == 1) v[0] = to_f32(*p);
  else load_pack(p, v);
}

template <typename T, int N>
__device__ __forceinline__ void store_n(T* p, const float* v) {
  if constexpr (N == 1) *p = from_f32<T>(v[0]);
  else store_pack(p, v);
}

// The backward's pass 2 over the window [lo, hi) of a group (offsets into
// the group; xw, gw hold its elements from lo on, in device or shared
// memory): adds sum dpre and sum dpre * xhat of each channel c of the group
// into sdb[c], sdg[c] (shared memory), where dpre = g * silu'(y) on the SiLU
// route (y = xhat*gamma + beta) and g otherwise. The work is cut into
// (channel, piece) items, one warp per item, at least as many items as
// warps: at 64 or 256 tokens a channel is one warp's work (a block-wide loop
// channel by channel would idle most of the block, the forward's lesson), at
// 4096 tokens a channel is split across warps. Where keep is not null, dpre
// is written there in place of g. I: the offsets' type, int where the window
// lies below 2^31 (fewer instructions a packet), else int64_t.
template <typename T, int N, int NT, typename I>
__device__ __forceinline__ void channel_sums(const T* xw, const T* gw, T* keep, I lo, I hi, int HW,
                                             const float* gam_g, const float* bet_g, float mean,
                                             float inv, int act, float* sdb, float* sdg) {
  constexpr int kWarps = NT / 32;
  if (hi <= lo) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = (int)(lo / HW), nch = (int)((hi - 1) / HW) - c0 + 1;
  int pieces = (kWarps + nch - 1) / nch;
  const int max_pieces = HW / (32 * N) > 1 ? HW / (32 * N) : 1;  // >= one packet a lane
  if (pieces > max_pieces) pieces = max_pieces;
  const int plen = ((HW + pieces - 1) / pieces + N - 1) / N * N;
  for (int item = warp; item < nch * pieces; item += kWarps) {
    const int c = c0 + item / pieces;
    const I p0 = (I)c * HW + (I)(item % pieces) * plen;
    const I cend = (I)(c + 1) * HW, pend = p0 + plen < cend ? p0 + plen : cend;
    const I start = p0 > lo ? p0 : lo, end = pend < hi ? pend : hi;
    const float gam = gam_g[c], bet = bet_g[c];
    float adb = 0.0f, adg = 0.0f, v[N], w[N];
    for (I i = start + lane * N; i < end; i += 32 * N) {
      load_n<T, N>(xw + (i - lo), v);
      load_n<T, N>(gw + (i - lo), w);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xh = (v[j] - mean) * inv;
        w[j] = gn_dpre(w[j], xh, gam, bet, act);
        adb += w[j];
        adg = fmaf(w[j], xh, adg);
      }
      if (keep) store_n<T, N>(keep + (i - lo), w);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      adb += __shfl_xor_sync(0xffffffffu, adb, o);
      adg += __shfl_xor_sync(0xffffffffu, adg, o);
    }
    if (lane == 0) {
      atomicAdd(&sdb[c], adb);
      atomicAdd(&sdg[c], adg);
    }
  }
}

// gn_bwd_stats' per-channel sums of the window [lo, lo + len) of a group,
// read from device memory (xw, gw from lo on): sum dpre and sum dpre * xhat
// of each channel c added into sdb[c], sdg[c] (shared memory), dpre as
// channel_sums' on dsilu_fast. Each warp walks an equal contiguous run of
// the window's 16-byte packets, 32*U at a step (neighbouring lanes on
// neighbouring packets), each lane loading its U packets of x and g and
// their channels' gamma and beta before any arithmetic. A step inside one
// channel adds into the lanes' running sums, which go to shared memory
// when the channel changes; a step across channels (every step of a 64- or
// 256-token map) adds each run of lanes that share a channel in a
// segmented scan, the run's last lane into shared memory. So every lane has
// work and a warp takes one trip to memory a step, where a warp a channel
// (channel_sums) idles most lanes of a short channel and takes a trip a
// channel. lo, len and HW are whole packets.
template <typename T, int NT, int U>
__device__ __forceinline__ void slice_sums(const T* xw, const T* gw, int lo, int len, int HW,
                                           const float* gam_g, const float* bet_g, float mean,
                                           float inv, int act, float* sdb, float* sdg) {
  constexpr int N = Pack<T>::N, kWarps = NT / 32, kStep = 32 * U;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int packets = len / N, hwp = HW / N, p0 = lo / N;  // p0: the window's first packet
  const int per = (packets + kWarps - 1) / kWarps;
  const int a = min(warp * per, packets), b = min(a + per, packets);
  int cur = -1;  // the channel of the running sums (the same in every lane)
  float run_b = 0.0f, run_g = 0.0f;
  const auto flush = [&] {  // the running sums of channel cur into shared memory
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      run_b += __shfl_xor_sync(0xffffffffu, run_b, o);
      run_g += __shfl_xor_sync(0xffffffffu, run_g, o);
    }
    if (lane == 0 && cur >= 0) {
      atomicAdd(&sdb[cur], run_b);
      atomicAdd(&sdg[cur], run_g);
    }
    run_b = run_g = 0.0f;
  };
  for (int st = a; st < b; st += kStep) {  // the same in every lane of the warp
    const int c_first = (p0 + st) / hwp, c_last = (p0 + min(st + kStep, b) - 1) / hwp;
    uint4 rx[U], rg[U];
    int ch[U];
    float gam[U], bet[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = st + u * 32 + lane;
      ch[u] = p < b ? (c_first == c_last ? c_first : (p0 + p) / hwp) : -1;
      if (ch[u] >= 0) {
        rx[u] = *reinterpret_cast<const uint4*>(xw + p * N);
        rg[u] = *reinterpret_cast<const uint4*>(gw + p * N);
        gam[u] = gam_g[ch[u]];
        bet[u] = bet_g[ch[u]];
      }
    }
    if (c_first == c_last && c_first != cur) {
      flush();
      cur = c_first;
    } else if (c_first != c_last) {
      flush();
      cur = -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float db = 0.0f, dg = 0.0f;
      if (ch[u] >= 0) {
        const T* xv = reinterpret_cast<const T*>(&rx[u]);
        const T* gv = reinterpret_cast<const T*>(&rg[u]);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float xh = (to_f32(xv[j]) - mean) * inv;
          const float d = gn_dpre_fast<T>(to_f32(gv[j]), xh, gam[u], bet[u], act);
          db += d;
          dg = fmaf(d, xh, dg);
        }
      }
      if (c_first == c_last) {
        run_b += db;
        run_g += dg;
        continue;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {  // every lane shuffles, then adds where it may
        const float pb = __shfl_up_sync(0xffffffffu, db, o);
        const float pg = __shfl_up_sync(0xffffffffu, dg, o);
        const int pc = __shfl_up_sync(0xffffffffu, ch[u], o);
        if (lane >= o && pc == ch[u]) {
          db += pb;
          dg += pg;
        }
      }
      const int next = __shfl_down_sync(0xffffffffu, ch[u], 1);
      if (ch[u] >= 0 && (lane == 31 || next != ch[u])) {
        atomicAdd(&sdb[ch[u]], db);
        atomicAdd(&sdg[ch[u]], dg);
      }
    }
  }
  flush();
}

// The backward's pass 3 over the window [lo, lo + len) of a group (xw, gw,
// dxw from lo on): dx = inv * (gamma_c*dpre - m1 - xhat*m2), m1 and m2 the
// group means of gamma*dpre and gamma*dpre*xhat; gw holds dpre where kept,
// else g. A packet never straddles two channels (lo and HW are whole
// packets). I as for channel_sums.
template <typename T, int N, int NT, typename I>
__device__ __forceinline__ void dx_pass(const T* xw, const T* gw, T* dxw, I lo, I len, int HW,
                                        const float* gam_g, const float* bet_g, float mean,
                                        float inv, float m1, float m2, int act, bool kept) {
  float v[N], w[N];
  for (I i = (I)threadIdx.x * N; i < len; i += (I)NT * N) {
    const int c = (int)((lo + i) / HW);
    const float gam = gam_g[c], bet = bet_g[c];
    load_n<T, N>(xw + i, v);
    load_n<T, N>(gw + i, w);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float xh = (v[j] - mean) * inv;
      const float dxh = (kept ? w[j] : gn_dpre(w[j], xh, gam, bet, act)) * gam;
      w[j] = inv * (dxh - m1 - xh * m2);
    }
    store_n<T, N>(dxw + i, w);
  }
}

// grid (B*G): block bg writes dx for its group and dparam[b][0|1][channels of
// the group] = dgamma, dbeta of sample b. Dynamic shared memory: 2 * C/G f32.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kBwdThreads)
gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ dx, float* __restrict__ dparam,
              int C, int HW, int G, float eps, int act) {
  extern __shared__ float csum[];  // [0, cg): dgamma, [cg, 2cg): dbeta
  const int b = blockIdx.x / G, gi = blockIdx.x % G;
  const int cg = C / G;
  const int64_t n = (int64_t)cg * HW;
  const int64_t base = ((int64_t)b * C + (int64_t)gi * cg) * HW;
  float* sdg = csum;
  float* sdb = csum + cg;
  for (int i = threadIdx.x; i < 2 * cg; i += kBwdThreads) csum[i] = 0.0f;

  // 1. statistics (block_sum2 also orders the zeroing above before pass 2)
  float s = 0.0f, ss = 0.0f;
  partial_sums<T, VEC>(x + base, n, s, ss);
  block_sum2<kBwdThreads>(s, ss);
  const float nf = (float)n;
  const float mean = s / nf;
  const float inv = 1.0f / sqrtf(ss / nf - mean * mean + eps);

  // 2. per-channel sums
  constexpr int N = VEC ? Pack<T>::N : 1;
  const float* gam_g = gamma + gi * cg;
  const float* bet_g = beta + gi * cg;
  channel_sums<T, N, kBwdThreads, int64_t>(x + base, g + base, nullptr, 0, n, HW, gam_g, bet_g,
                                           mean, inv, act, sdb, sdg);
  __syncthreads();

  // per-sample parameter gradients, and the two group means of pass 3
  float m1 = 0.0f, m2 = 0.0f;
  for (int c = threadIdx.x; c < cg; c += kBwdThreads) {
    const int ch = gi * cg + c;
    dparam[((int64_t)b * 2 + 0) * C + ch] = sdg[c];
    dparam[((int64_t)b * 2 + 1) * C + ch] = sdb[c];
    m1 = fmaf(gamma[ch], sdb[c], m1);
    m2 = fmaf(gamma[ch], sdg[c], m2);
  }
  block_sum2<kBwdThreads>(m1, m2);
  m1 /= nf;
  m2 /= nf;

  // 3. dx over the whole group
  dx_pass<T, N, kBwdThreads, int64_t>(x + base, g + base, dx + base, 0, n, HW, gam_g, bet_g,
                                      mean, inv, m1, m2, act, false);
}

// ------------------------------------------------- the split backward (SP)

// The streaming fallback of gn_bwd_stats (design notes at the top).
// grid (B*C): block bc reduces channel row bc (HW elements of x and g) with
// the forward's statistics mean, inv (B, G) to dparam[b][0][c] = sum dpre *
// xhat and dparam[b][1][c] = sum dpre. The block that finishes its group
// last (a ticket in done, after a fence) adds the group's rows in channel
// order into sums[b][g] = (sum gamma*dpre, sum gamma*dpre*xhat): the same
// bits whichever block comes last.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kSplitThreads)
gn_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ mean, const float* __restrict__ inv,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    float* __restrict__ dparam, float* __restrict__ sums,
                    unsigned* __restrict__ done, int C, int HW, int G, int act) {
  __shared__ bool last;
  const int64_t row = blockIdx.x;
  const int64_t b = row / C;
  const int c = (int)(row % C), cg = C / G, gi = c / cg;
  const int64_t bg = b * G + gi;
  const float mu = mean[bg], iv = inv[bg], gam = gamma[c], bet = beta[c];
  const T* xr = x + row * HW;
  const T* gr = g + row * HW;
  constexpr int N = VEC ? Pack<T>::N : 1;
  float sdg = 0.0f, sdb = 0.0f, v[N], w[N];
  for (int64_t i = (int64_t)threadIdx.x * N; i < HW; i += (int64_t)kSplitThreads * N) {
    load_n<T, N>(xr + i, v);
    load_n<T, N>(gr + i, w);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float xh = (v[j] - mu) * iv;
      const float d = gn_dpre(w[j], xh, gam, bet, act);
      sdb += d;
      sdg = fmaf(d, xh, sdg);
    }
  }
  block_sum2<kSplitThreads>(sdg, sdb);
  if (threadIdx.x == 0) {
    dparam[(b * 2 + 0) * C + c] = sdg;
    dparam[(b * 2 + 1) * C + c] = sdb;
    __threadfence();
    last = atomicAdd(&done[bg], 1u) == (unsigned)cg - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the group's rows, written by other blocks: read at L2 (__ldcg), past L1
  float s1 = 0.0f, s2 = 0.0f;
  for (int k = threadIdx.x; k < cg; k += kSplitThreads) {
    const int ch = gi * cg + k;
    s1 = fmaf(gamma[ch], __ldcg(dparam + (b * 2 + 1) * C + ch), s1);
    s2 = fmaf(gamma[ch], __ldcg(dparam + (b * 2 + 0) * C + ch), s2);
  }
  block_sum2<kSplitThreads>(s1, s2);
  if (threadIdx.x == 0) {
    sums[bg * 2 + 0] = s1;
    sums[bg * 2 + 1] = s2;
  }
}

// The streaming fallback of gn_bwd_apply.
// grid (B*C, x-blocks) as gn_apply's: row bc of HW elements, dx = inv *
// (gamma_c*dpre - m1 - xhat*m2), m1 and m2 the group's sums (all-reduced
// over the slabs) over `count` elements.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kSplitThreads)
gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ mean, const float* __restrict__ inv,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const float* __restrict__ sums, T* __restrict__ dx, int C, int HW, int G,
                    float count, int act) {
  const int64_t row = blockIdx.x;
  const int64_t b = row / C;
  const int c = (int)(row % C);
  const int64_t bg = b * G + c / (C / G);
  const float mu = mean[bg], iv = inv[bg], gam = gamma[c], bet = beta[c];
  const float m1 = sums[bg * 2 + 0] / count, m2 = sums[bg * 2 + 1] / count;
  const int64_t off = row * HW;
  constexpr int N = VEC ? Pack<T>::N : 1;
  float v[N], w[N];
  for (int64_t i = ((int64_t)blockIdx.y * kSplitThreads + threadIdx.x) * N; i < HW;
       i += (int64_t)gridDim.y * kSplitThreads * N) {
    load_n<T, N>(x + off + i, v);
    load_n<T, N>(g + off + i, w);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float xh = (v[j] - mu) * iv;
      w[j] = iv * (gam * gn_dpre(w[j], xh, gam, bet, act) - m1 - xh * m2);
    }
    store_n<T, N>(dx + off + i, w);
  }
}

// ------------------------------------------------------------ cluster body

// CTAs of 256 threads, or 128 where the grid has at least 512 CTAs (about
// four an SM) and a slice fits 45 KB (five an SM): there more CTAs at a time
// on an SM overlap one's copies with another's passes, measured faster (and
// slower with fewer or larger CTAs, where the passes want the threads)
constexpr int kClusterThreads = 256;
constexpr int kSmallCtaThreads = 128;
constexpr int kSmallCtaGrid = 512;
constexpr int64_t kSmallCtaSlice = 45 * 1024;
constexpr int kMaxCluster = 16;                 // non-portable above 8
constexpr int kMinCtas = 132;                   // the H100's SMs
constexpr int64_t kSliceTarget = 72 * 1024;     // three CTAs an SM
constexpr int64_t kSliceMax = 226 * 1024;       // one CTA an SM, beside the static 256 bytes
// the forward's: CTAs a grid should reach, and the least slice worth a CTA
// of a cluster (design notes at the top)
constexpr int kFwdMinCtas = 264;
constexpr int64_t kFwdMinSlice = 16 * 1024;

// Elements of a CTA's slice of an n-element group cut R ways: a whole number
// of 16-byte packets.
int64_t slice_len(int esize, int64_t n, int R) {
  const int N = 16 / esize;
  return ((n + R - 1) / R + N - 1) / N * N;
}

// Dynamic shared memory of a CTA: the slices of x and g, the per-channel sums
// (2 * C/G f32) and the CTA's two statistics.
int64_t cluster_smem(int esize, int64_t n, int cg, int R) {
  return 2 * slice_len(esize, n, R) * esize + 8 * (int64_t)cg + 8;
}

// The cluster size the backward takes for (B, C, HW, G) in elements of
// esize bytes, 0 for the streaming body. gn_bwd_cluster_size in
// ops/gn_silu.py is its twin (the wrappers' counters check the report
// against it).
int gn_bwd_cluster_size(int esize, int B, int C, int HW, int G) {
  if (HW % (16 / esize)) return 0;
  const int cg = C / G;
  const int64_t n = (int64_t)cg * HW, groups = (int64_t)B * G;
  for (int R = 1; R <= kMaxCluster && groups * R <= INT_MAX; R *= 2)
    if (cluster_smem(esize, n, cg, R) <= kSliceTarget &&
        (groups * R >= kMinCtas || R == kMaxCluster))
      return R;
  return cluster_smem(esize, n, cg, 8) <= kSliceMax && groups * 8 <= INT_MAX ? 8 : 0;
}

// Samples a cluster holds: the whole batch where its B*R CTAs make one
// cluster (rank 0 then writes the batch's sums of dgamma and dbeta, so the
// caller sums nothing), else one (gn_bwd_cluster_samples in ops/gn_silu.py).
int gn_bwd_cluster_samples(int B, int R) { return (int64_t)B * R <= kMaxCluster ? B : 1; }

// Dynamic shared memory of a forward CTA: the slice of x, the exchange's
// inbox (a pair of f32 for each of up to 16 ranks) and mbarrier, and the
// affine (a_c, b_c) of each channel (2 * C/G f32).
int64_t fwd_cluster_smem(int esize, int64_t n, int cg, int R) {
  return slice_len(esize, n, R) * esize + 8 * kMaxCluster + 8 + 8 * (int64_t)cg;
}

// The cluster size the forward takes for (B, C, HW, G) in elements of esize
// bytes, 0 for the streaming body: the least R whose slice fits kSliceTarget
// and whose grid has at least kFwdMinCtas CTAs or whose slices would fall
// below kFwdMinSlice at 2R; else the largest R (16, or less where 16 would
// pass INT_MAX CTAs) where the slice fits kSliceMax; else 0.
// gn_fwd_cluster_size in ops/gn_silu.py is its twin.
int gn_fwd_cluster_size(int esize, int B, int C, int HW, int G) {
  if (HW % (16 / esize)) return 0;
  const int cg = C / G;
  const int64_t n = (int64_t)cg * HW, groups = (int64_t)B * G;
  for (int R = 1; R <= kMaxCluster && groups * R <= INT_MAX; R *= 2) {
    const bool last = R == kMaxCluster || 2 * groups * R > INT_MAX;
    if (fwd_cluster_smem(esize, n, cg, R) <= (last ? kSliceMax : kSliceTarget) &&
        (last || groups * R >= kFwdMinCtas ||
         slice_len(esize, n, 2 * R) * esize < kFwdMinSlice))
      return R;
  }
  return 0;
}

// the split backward's sizing (design notes at the top): the CTAs a
// gn_bwd_stats grid reaches where its slices stay at least kStatsMinSlice
// bytes of x and g; the flat gn_bwd_apply's threads a CTA, most packets of x
// (and of g) a thread, and the CTAs its grid aims at (two an SM)
constexpr int kStatsMinCtas = 264;
constexpr int64_t kStatsMinSlice = 16 * 1024;
constexpr int kBwdStatsThreads = 128;
constexpr int kFlatThreads = 256;
constexpr int kFlatMaxPackets = 4;
constexpr int kFlatCtas = 264;

// Dynamic shared memory of a gn_bwd_stats CTA: its per-channel sums (2 *
// C/G f32), the inbox of the R ranks' sums (R * C/G float2, read on rank 0)
// and its mbarrier.
int64_t stats_cluster_smem(int cg, int R) { return 8 * (int64_t)cg * (R + 1) + 8; }

// The cluster size gn_bwd_stats takes for (B, C, HW, G) in elements of esize
// bytes, 0 for the streaming fallback: the least R (a power of two up to 16)
// whose grid has at least kStatsMinCtas CTAs, or at least kMinCtas where the
// slices of x and g at 2R would fall below kStatsMinSlice bytes; 0 where
// that R's shared memory passes kSliceMax (some 1800 channels a group at R =
// 16), where HW is no whole number of packets, and for groups of 2^30
// elements or more. gn_bwd_stats_cluster_size in ops/gn_silu.py is its twin.
int gn_bwd_stats_cluster_size(int esize, int B, int C, int HW, int G) {
  const int cg = C / G;
  const int64_t n = (int64_t)cg * HW, groups = (int64_t)B * G;
  if (HW % (16 / esize) || n >= (1 << 30) || groups > INT_MAX) return 0;
  int R = 1;
  for (; R < kMaxCluster; R *= 2)
    if (groups * R >= kStatsMinCtas ||
        (groups * R >= kMinCtas && 2 * slice_len(esize, n, 2 * R) * esize < kStatsMinSlice))
      break;
  return stats_cluster_smem(cg, R) <= kSliceMax ? R : 0;
}

// The flat gn_bwd_apply's grid over numel elements of esize bytes: K packets
// of x a thread, the least K up to kFlatMaxPackets whose CTAs of
// kFlatThreads*K packets number at most kFlatCtas, and those CTAs.
// gn_bwd_apply_flat_grid in ops/gn_silu.py is its twin.
int64_t gn_bwd_apply_flat_grid(int esize, int64_t numel, int& K) {
  const int64_t packets = numel / (16 / esize);
  for (K = 1;; ++K) {
    const int64_t ctas = (packets + (int64_t)kFlatThreads * K - 1) / ((int64_t)kFlatThreads * K);
    if (ctas <= kFlatCtas || K == kFlatMaxPackets) return ctas;
  }
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// barrier.cluster in two halves: arrive (release: this thread's shared-memory
// writes become visible to the cluster) and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The f32 at shared-memory address p of the cluster's CTA `rank`.
__device__ __forceinline__ float ld_peer(const float* p, uint32_t rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t m;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(m) : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(m) : "memory");
  return v;
}

// The forward's exchange: each CTA pushes its pair into every peer's inbox
// with st.async, which completes bytes on the peer's mbarrier, instead of
// pulling the peers' pairs after a cluster barrier. A CTA then waits only
// for the pairs to land (one one-way trip, not a barrier and a round trip),
// and since no peer touches its shared memory once they have landed, it
// exits without a second barrier.

// The shared::cluster address of p (a shared-memory address of this CTA) in
// the cluster's CTA `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t m;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(m)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))), "r"(rank));
  return m;
}

// barrier.cluster.arrive without release: orders nothing but the mbarrier
// initialisation, which fence.mbarrier_init releases
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// One thread: the mbarrier at bar with one arrival, made now, and `bytes` of
// st.async to come (phase 0 completes when they have landed).
__device__ __forceinline__ void mbar_init_expect(uint64_t* bar, uint32_t bytes) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(a) : "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(a), "r"(bytes)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// (a, b) into the float2 at p of CTA `rank`, completing 8 bytes on its
// mbarrier at bar.
__device__ __forceinline__ void push_peer(const float2* p, const uint64_t* bar, uint32_t rank,
                                          float a, float b) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          peer_addr(p, rank)),
      "f"(a), "f"(b), "r"(peer_addr(bar, rank))
      : "memory");
}

// Wait for phase `parity` of the mbarrier at bar, acquiring at cluster scope
// what the peers' st.async wrote.
__device__ __forceinline__ void mbar_wait(const uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(bar))),
      "r"(parity)
      : "memory");
}

// SiLU with the fast intrinsics: within a few ulps of silu() in f32 (the
// exponential and the division as one multi-function-unit operation each);
// in bf16, x/2 * (1 + tanh(x/2)) on the one-operation tanh, whose error
// (about 2^-11 relative) lies far below a bf16 step. The IEEE exponential
// and division cost some twenty instructions an element, which the apply
// pass of a slice held in shared memory cannot hide behind its stores.
template <typename T>
__device__ __forceinline__ float silu_fast(float y) {
  if constexpr (sizeof(T) == 2) {
    const float h = 0.5f * y;
    float t;
    asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(h));
    return fmaf(h, t, h);
  } else {
    return __fdividef(y, 1.0f + __expf(-y));
  }
}

// grid (B*G*R) in clusters of R: cluster q holds group q % G of sample q / G,
// rank r its slice r (elements [r*L, (r+1)*L), clipped to the group). At R =
// 1 the CTA holds the whole group and skips the exchange. NT threads a CTA.
template <typename T, int NT>
__global__ void __launch_bounds__(NT)
gn_fwd_cluster_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y, int C, int HW, int G,
                      int R, int L, float eps, int act) {
  constexpr int N = Pack<T>::N;
  extern __shared__ __align__(16) uint8_t smem[];
  T* xs = reinterpret_cast<T*>(smem);
  float2* inbox = reinterpret_cast<float2*>(xs + L);  // rank r's sum x, sum x^2 at [r]
  uint64_t* mbar = reinterpret_cast<uint64_t*>(inbox + kMaxCluster);  // their arrival
  float2* ab = reinterpret_cast<float2*>(mbar + 1);  // (a_c, b_c) of the slice's channels
  const int q = blockIdx.x / R, gi = q % G, rank = blockIdx.x % R;  // rank == cluster_rank()
  const int cg = C / G, n = cg * HW;  // at most 16 slices of at most 226 KB here
  const int lo = min(rank * L, n), hi = min(lo + L, n), len = hi - lo;
  const int64_t base = (int64_t)q * n + lo;  // (b*C + gi*cg)*HW + lo
  const int tid = threadIdx.x;
  if (R > 1) {  // the barrier, then the arrive that lets the peers write to it
    if (tid == 0) mbar_init_expect(mbar, 8 * R);
    cluster_arrive_relaxed();
  }

  // the whole slice in flight at once. A thread reads back only the packets
  // it copied itself (the same stride below), so its own wait suffices.
  for (int i = tid * N; i < len; i += NT * N)
    cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(xs + i)), x + base + i, 16);
  cp_async_commit();
  // meanwhile warp 0 fetches gamma_c, beta_c of the slice's channels, so that
  // no load waits between the statistics and the apply pass
  const int c0 = lo / HW, nch = len > 0 ? (hi - 1) / HW - c0 + 1 : 0;
  if (tid < 32)
    for (int c = tid; c < nch; c += 32)
      ab[c] = make_float2(gamma[gi * cg + c0 + c], beta[gi * cg + c0 + c]);
  cp_async_wait<0>();
  float s = 0.0f, ss = 0.0f;
  partial_sums<T, true>(xs, len, s, ss);
  block_sum2<NT>(s, ss);
  // thread r sends the slice's pair to rank r, once every peer has started
  // (and initialised its barrier)
  if (R > 1) {
    cluster_wait();
    if (tid < R) push_peer(inbox + rank, mbar, tid, s, ss);
  }

  // warp 0: the group's sums (once the R pairs have landed, every lane adds
  // them in rank order: the same bits in every CTA), then the affine of the
  // slice's channels
  if (tid < 32) {
    if (R > 1) {
      mbar_wait(mbar, 0);
      const float2 mine = tid < R ? inbox[tid] : make_float2(0.0f, 0.0f);
      s = ss = 0.0f;
      for (int r = 0; r < R; ++r) {
        s += __shfl_sync(0xffffffffu, mine.x, r);
        ss += __shfl_sync(0xffffffffu, mine.y, r);
      }
    }
    const float nf = (float)n;
    const float mean = s / nf;
    const float var = ss / nf - mean * mean;
    const float inv = 1.0f / sqrtf(var + eps);
    for (int c = tid; c < nch; c += 32) {
      const float a = inv * ab[c].x;
      ab[c] = make_float2(a, ab[c].y - mean * a);
    }
  }
  __syncthreads();

  // y = act(x*a_c + b_c) from the shared copy. A packet never straddles two
  // channels (lo and HW are whole packets); a thread steps its channel and
  // offset in the channel by NT*N elements, with no division in the loop.
  constexpr int step = NT * N;
  const int dc = step / HW, doff = step % HW;
  int c = (lo + tid * N) / HW - c0, off = (lo + tid * N) % HW;
  float v[N];
  for (int i = tid * N; i < len; i += step) {
    const float2 p = ab[c];
    load_pack(xs + i, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      v[j] = v[j] * p.x + p.y;
      if (act) v[j] = silu_fast<T>(v[j]);
    }
    store_pack(y + base + i, v);
    c += dc;
    off += doff;
    if (off >= HW) {
      off -= HW;
      ++c;
    }
  }
}

// grid (B*G*R) in clusters of S*R, S samples of one group: cluster q holds
// group q % G of samples (q / G)*S .. (q / G)*S + S - 1, rank s*R + r slice r
// (elements [r*L, (r+1)*L), clipped to the group) of its sample s. It writes
// dx for them and dparam[q / G][0|1][channels of the group] = dgamma, dbeta
// summed over its S samples. NT threads a CTA (registers <= 85 at 256: three
// CTAs an SM).
template <typename T, int NT>
__global__ void __launch_bounds__(NT, NT == kClusterThreads ? 3 : 4)
gn_bwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      T* __restrict__ dx, float* __restrict__ dparam, int C, int HW, int G, int R,
                      int S, int L, float eps, int act) {
  constexpr int N = Pack<T>::N;
  extern __shared__ __align__(16) uint8_t smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = xs + L;
  float* sdg = reinterpret_cast<float*>(gs + L);  // [cg] dgamma, then [cg] dbeta
  const int cg = C / G;
  float* sdb = sdg + cg;
  float* red = sdb + cg;  // this CTA's sum x, sum x^2
  const int rank = cluster_rank(), q = blockIdx.x / (S * R), s0 = rank / R;
  const int b = q / G * S + s0, gi = q % G, peer0 = s0 * R;  // peer0: this sample's rank 0
  const int n = cg * HW;  // at most 16 slices of at most 226 KB here
  const int lo = min(rank % R * L, n), hi = min(lo + L, n), len = hi - lo;
  const int64_t base = ((int64_t)b * C + (int64_t)gi * cg) * HW + lo;
  const int tid = threadIdx.x;

  // the slice of x, then of g, into shared memory: two copy groups
  for (int i = tid * N; i < len; i += NT * N)
    cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(xs + i)), x + base + i, 16);
  cp_async_commit();
  for (int i = tid * N; i < len; i += NT * N)
    cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(gs + i)), g + base + i, 16);
  cp_async_commit();
  for (int i = tid; i < 2 * cg; i += NT) sdg[i] = 0.0f;
  cp_async_wait<1>();
  __syncthreads();

  // 1. statistics: the slice's sums, then the group's, in rank order
  float s = 0.0f, ss = 0.0f;
  partial_sums<T, true>(xs, len, s, ss);
  block_sum2<NT>(s, ss);
  if (tid == 0) {
    red[0] = s;
    red[1] = ss;
  }
  cluster_arrive();
  cluster_wait();
  s = ss = 0.0f;
  for (int r = peer0; r < peer0 + R; ++r) {
    s += ld_peer(red, r);
    ss += ld_peer(red + 1, r);
  }
  const float nf = (float)n;
  const float mean = s / nf;
  const float inv = 1.0f / sqrtf(ss / nf - mean * mean + eps);

  // 2. per-channel sums of the slice. In f32 on the SiLU route dpre replaces
  // g in shared memory (each element belongs to one item), so pass 3 does
  // not recompute the sigmoid.
  const bool keep = sizeof(T) == 4 && act;
  const float* gam_g = gamma + gi * cg;
  const float* bet_g = beta + gi * cg;
  cp_async_wait<0>();
  __syncthreads();
  channel_sums<T, N, NT, int>(xs, gs, keep ? gs : nullptr, lo, hi, HW, gam_g, bet_g, mean, inv,
                              act, sdb, sdg);
  cluster_arrive();
  cluster_wait();

  // the group's per-channel sums, in rank order, for the two group means of
  // dx; rank 0 adds those of the cluster's samples, in order, into dparam
  auto peer_sums = [&](int c, int first, float& db, float& dg) {
    db = dg = 0.0f;
    for (int r = first; r < first + R; ++r) {
      db += ld_peer(sdb + c, r);
      dg += ld_peer(sdg + c, r);
    }
  };
  float m1 = 0.0f, m2 = 0.0f;
  for (int c = tid; c < cg; c += NT) {
    float db, dg;
    peer_sums(c, peer0, db, dg);
    const int ch = gi * cg + c;
    if (rank == 0) {
      float tb = db, tg = dg, pb, pg;
      for (int sp = 1; sp < S; ++sp) {
        peer_sums(c, sp * R, pb, pg);
        tb += pb;
        tg += pg;
      }
      dparam[((int64_t)(q / G) * 2 + 0) * C + ch] = tg;
      dparam[((int64_t)(q / G) * 2 + 1) * C + ch] = tb;
    }
    m1 = fmaf(gamma[ch], db, m1);
    m2 = fmaf(gamma[ch], dg, m2);
  }
  cluster_arrive();  // this CTA reads no peer's shared memory any more
  block_sum2<NT>(m1, m2);
  m1 /= nf;
  m2 /= nf;

  // 3. dx for the slice, from the same copy (the barriers since pass 2 order
  // its dpre writes before these reads)
  dx_pass<T, N, NT, int>(xs, gs, dx + base, lo, len, HW, gam_g, bet_g, mean, inv, m1, m2, act,
                         keep);
  cluster_wait();  // no peer reads this CTA's shared memory any more: it may exit
}

// grid (B*G*R) in clusters of R: cluster q holds group q % G of sample q / G,
// rank r its slice r (elements [r*L, (r+1)*L), clipped to the group). Rank 0
// writes dparam[q / G][0|1][channels of the group] = the slab's dgamma,
// dbeta and sums[q] = (sum gamma*dpre, sum gamma*dpre*xhat), with the
// forward's mean[q], inv[q]. At R = 1 the CTA skips the exchange.
template <typename T, int NT>
__global__ void __launch_bounds__(NT)
gn_bwd_stats_cluster_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            const float* __restrict__ mean, const float* __restrict__ inv,
                            const float* __restrict__ gamma, const float* __restrict__ beta,
                            float* __restrict__ dparam, float* __restrict__ sums, int C, int HW,
                            int G, int R, int L, int act) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int cg = C / G;
  float* sdg = reinterpret_cast<float*>(smem);  // [cg] dgamma, then [cg] dbeta
  float* sdb = sdg + cg;
  float2* inbox = reinterpret_cast<float2*>(sdb + cg);  // rank r's (dbeta_c, dgamma_c): [r*cg + c]
  uint64_t* mbar = reinterpret_cast<uint64_t*>(inbox + R * cg);  // their arrival, on rank 0
  const int q = blockIdx.x / R, gi = q % G, rank = blockIdx.x % R;  // rank == cluster_rank()
  const int n = cg * HW;  // below 2^30 here
  const int lo = min(rank * L, n), hi = min(lo + L, n);
  const int64_t base = (int64_t)q * n + lo;  // (b*C + gi*cg)*HW + lo
  const int tid = threadIdx.x;
  if (R > 1) {  // rank 0's barrier, then the arrive that lets the peers push to it
    if (rank == 0 && tid == 0) mbar_init_expect(mbar, 8 * R * cg);
    cluster_arrive_relaxed();
  }

  for (int i = tid; i < 2 * cg; i += NT) sdg[i] = 0.0f;
  const float mu = mean[q], iv = inv[q];
  // rank 0's gamma of channel tid, fetched now so that its combine waits on no load
  const float gam_tid = rank == 0 && tid < cg ? gamma[gi * cg + tid] : 0.0f;
  __syncthreads();
  // the slice straight from device memory, 8 elements of x and of g a lane
  // a step (one bf16 packet, two f32 ones: 2 and 4 bf16 packets measured
  // slower, one f32 packet level)
  slice_sums<T, NT, sizeof(T) / 2>(x + base, g + base, lo, hi - lo, HW, gamma + gi * cg,
                                   beta + gi * cg, mu, iv, act, sdb, sdg);
  __syncthreads();

  // every rank's partials into rank 0's inbox, in one one-way trip (once
  // every peer has started and rank 0 has initialised its barrier)
  if (R > 1) {
    cluster_wait();
    for (int c = tid; c < cg; c += NT) push_peer(inbox + rank * cg + c, mbar, 0, sdb[c], sdg[c]);
    if (rank != 0) return;
    mbar_wait(mbar, 0);
  }

  // rank 0: each channel's R partials in rank order, then the group's sums
  const int64_t b = q / G;
  float s1 = 0.0f, s2 = 0.0f;
  for (int c = tid; c < cg; c += NT) {
    float db = sdb[c], dg = sdg[c];
    if (R > 1) {
      db = dg = 0.0f;
      for (int r = 0; r < R; ++r) {
        const float2 p = inbox[r * cg + c];
        db += p.x;
        dg += p.y;
      }
    }
    const float gam = c == tid ? gam_tid : gamma[gi * cg + c];
    dparam[(b * 2 + 0) * C + gi * cg + c] = dg;
    dparam[(b * 2 + 1) * C + gi * cg + c] = db;
    s1 = fmaf(gam, db, s1);
    s2 = fmaf(gam, dg, s2);
  }
  block_sum2<NT>(s1, s2);
  if (tid == 0) {
    sums[(int64_t)q * 2 + 0] = s1;
    sums[(int64_t)q * 2 + 1] = s2;
  }
}

// grid (ctas), kFlatThreads threads: CTA j holds packets [j*P, (j+1)*P) of
// the slab, P = kFlatThreads*K, thread t packets j*P + k*kFlatThreads + t
// (k < K: neighbouring threads on neighbouring packets). Row bc of a packet
// at element e is e / HW, its coefficients those of (b, c); dx as gn_bwd_
// apply_kernel's, sums over `count` elements a group. I: the offsets' type,
// int where numel and one CTA more lie below 2^31.
template <typename T, typename I>
__global__ void __launch_bounds__(kFlatThreads)
gn_bwd_apply_flat_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ mean, const float* __restrict__ inv,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         const float* __restrict__ sums, T* __restrict__ dx, int C, int HW, int G,
                         I numel, int K, float count, int act) {
  constexpr int N = Pack<T>::N;
  __shared__ float4 coef[kFlatThreads * kFlatMaxPackets + 1];  // (a, b, k2, k0) of the CTA's rows
  const int tid = threadIdx.x;
  const I e0 = (I)blockIdx.x * kFlatThreads * K * N;
  // 1. every load of the thread first
  uint4 rx[kFlatMaxPackets], rg[kFlatMaxPackets];
#pragma unroll
  for (int k = 0; k < kFlatMaxPackets; ++k) {
    const I e = e0 + ((I)k * kFlatThreads + tid) * N;
    if (k < K && e < numel) {
      rx[k] = *reinterpret_cast<const uint4*>(x + e);
      rg[k] = *reinterpret_cast<const uint4*>(g + e);
    }
  }
  // 2. meanwhile the coefficients of the CTA's rows (at most one a packet,
  // and one more: HW is a whole number of packets)
  const I r0 = e0 / HW;
  const I last = (e0 + (I)kFlatThreads * K * N < numel ? e0 + (I)kFlatThreads * K * N : numel) - 1;
  const int rows = (int)(last / HW - r0) + 1;
  const int cg = C / G;
  for (int i = tid; i < rows; i += kFlatThreads) {
    const I row = r0 + i;
    const int c = (int)(row % C);
    const int64_t bg = (int64_t)(row / C) * G + c / cg;
    const float iv = inv[bg], m1 = sums[bg * 2 + 0] / count, m2 = sums[bg * 2 + 1] / count;
    const float a = iv * gamma[c], k2 = -iv * iv * m2;
    coef[i] = make_float4(a, beta[c] - mean[bg] * a, k2, -mean[bg] * k2 - iv * m1);
  }
  __syncthreads();
  // 3. dx = a*dpre + k2*x + k0, dpre = g*silu'(x*a + b) on the SiLU route
#pragma unroll
  for (int k = 0; k < kFlatMaxPackets; ++k) {
    const I e = e0 + ((I)k * kFlatThreads + tid) * N;
    if (k < K && e < numel) {
      const float4 cf = coef[(int)(e / HW - r0)];
      const T* xv = reinterpret_cast<const T*>(&rx[k]);
      const T* gv = reinterpret_cast<const T*>(&rg[k]);
      float out[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xf = to_f32(xv[j]), gf = to_f32(gv[j]);
        const float d = act ? gf * dsilu_fast<T>(fmaf(xf, cf.x, cf.y)) : gf;
        out[j] = fmaf(cf.x, d, fmaf(cf.z, xf, cf.w));
      }
      store_pack(dx + e, out);
    }
  }
}

// Launches `kernel`, a cluster body, on `ctas` CTAs of NT threads in
// clusters of `cluster`, with `smem` bytes of dynamic shared memory. Its
// attributes (the most dynamic shared memory, non-portable cluster sizes)
// are set at its first launch. All CTAs of a cluster must be resident on one
// GPC at once: the occupancy query is asked once for each (cluster size,
// shared memory) of the kernel, and its refusal is returned.
template <auto kernel, typename... Args>
cudaError_t launch_cluster(int64_t ctas, int NT, int cluster, int smem, cudaStream_t st,
                           Args... args) {
  static const cudaError_t attributes = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSliceMax);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  if (attributes != cudaSuccess) return attributes;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  static int seen[64][2];
  static int n_seen = 0;
  bool known = false;
  for (int i = 0; i < n_seen; ++i) known |= seen[i][0] == cluster && seen[i][1] == smem;
  if (!known) {
    int clusters = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    if (n_seen < 64) {
      seen[n_seen][0] = cluster;
      seen[n_seen][1] = smem;
      ++n_seen;
    }
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, int NT>
cudaError_t launch_bwd_cluster_nt(const void* x, const void* g, const float* gamma,
                                  const float* beta, void* dx, float* dparam, int B, int C,
                                  int HW, int G, int R, float eps, int act, cudaStream_t st) {
  const int64_t n = (int64_t)(C / G) * HW;
  const int L = (int)slice_len(sizeof(T), n, R), S = gn_bwd_cluster_samples(B, R);
  return launch_cluster<gn_bwd_cluster_kernel<T, NT>>(
      (int64_t)B * G * R, NT, S * R, (int)cluster_smem(sizeof(T), n, C / G, R), st,
      static_cast<const T*>(x), static_cast<const T*>(g), gamma, beta, static_cast<T*>(dx),
      dparam, C, HW, G, R, S, L, eps, act);
}

template <typename T>
cudaError_t launch_bwd_cluster(const void* x, const void* g, const float* gamma,
                               const float* beta, void* dx, float* dparam, int B, int C, int HW,
                               int G, int R, float eps, int act, cudaStream_t st) {
  const int64_t n = (int64_t)(C / G) * HW;
  if ((int64_t)B * G * R >= kSmallCtaGrid && cluster_smem(sizeof(T), n, C / G, R) <= kSmallCtaSlice)
    return launch_bwd_cluster_nt<T, kSmallCtaThreads>(x, g, gamma, beta, dx, dparam, B, C, HW,
                                                      G, R, eps, act, st);
  return launch_bwd_cluster_nt<T, kClusterThreads>(x, g, gamma, beta, dx, dparam, B, C, HW, G, R,
                                                   eps, act, st);
}

template <typename T>
cudaError_t launch_fwd_cluster(const void* x, const float* gamma, const float* beta, void* y,
                               int B, int C, int HW, int G, int R, float eps, int act,
                               cudaStream_t st) {
  const int64_t n = (int64_t)(C / G) * HW;
  return launch_cluster<gn_fwd_cluster_kernel<T, kClusterThreads>>(
      (int64_t)B * G * R, kClusterThreads, R, (int)fwd_cluster_smem(sizeof(T), n, C / G, R), st,
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), C, HW, G, R,
      (int)slice_len(sizeof(T), n, R), eps, act);
}

template <typename T>
bool packable(const void* p, int HW) {
  return HW % Pack<T>::N == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
void launch_fwd(const void* x, const float* gamma, const float* beta, void* y, int B, int C,
                int HW, int G, float eps, int act, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (packable<T>(x, HW) && packable<T>(y, HW))
    gn_fwd_kernel<T, true><<<B * G, kFwdThreads, 0, st>>>(xt, gamma, beta, yt, C, HW, G, eps, act);
  else
    gn_fwd_kernel<T, false><<<B * G, kFwdThreads, 0, st>>>(xt, gamma, beta, yt, C, HW, G, eps, act);
}

template <typename T>
void launch_stats(const void* x, float* parts, int B, int C, int HW, int G, int chunks,
                  cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  dim3 grid((unsigned)((int64_t)B * G * chunks));
  // a chunk starts at k * (C/G)*HW/chunks elements: packets line up when
  // that length is a whole number of packets
  const int64_t len = (int64_t)(C / G) * HW / chunks;
  if (packable<T>(x, HW) && len % Pack<T>::N == 0)
    gn_stats_kernel<T, true><<<grid, kStatsThreads, 0, st>>>(xt, parts, C, HW, G, chunks);
  else
    gn_stats_kernel<T, false><<<grid, kStatsThreads, 0, st>>>(xt, parts, C, HW, G, chunks);
}

template <typename T>
void launch_apply(const void* x, const float* a, const float* b, void* y, int B, int C, int HW,
                  int act, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const bool vec = packable<T>(x, HW) && packable<T>(y, HW);
  const int per_block = kApplyThreads * (vec ? Pack<T>::N : 1);
  int xblocks = (HW + per_block - 1) / per_block;
  if (xblocks > 64) xblocks = 64;  // each thread then loops over the row
  dim3 grid((unsigned)((int64_t)B * C), xblocks);
  if (vec)
    gn_apply_kernel<T, true><<<grid, kApplyThreads, 0, st>>>(xt, a, b, yt, HW, act);
  else
    gn_apply_kernel<T, false><<<grid, kApplyThreads, 0, st>>>(xt, a, b, yt, HW, act);
}

template <typename T>
cudaError_t launch_bwd_stats(const void* x, const void* g, const float* mean, const float* inv,
                             const float* gamma, const float* beta, float* dparam, float* sums,
                             unsigned* done, int B, int C, int HW, int G, int act,
                             cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const unsigned grid = (unsigned)((int64_t)B * C);
  if (packable<T>(x, HW) && packable<T>(g, HW))
    gn_bwd_stats_kernel<T, true><<<grid, kSplitThreads, 0, st>>>(
        xt, gt, mean, inv, gamma, beta, dparam, sums, done, C, HW, G, act);
  else
    gn_bwd_stats_kernel<T, false><<<grid, kSplitThreads, 0, st>>>(
        xt, gt, mean, inv, gamma, beta, dparam, sums, done, C, HW, G, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_apply(const void* x, const void* g, const float* mean, const float* inv,
                             const float* gamma, const float* beta, const float* sums, void* dx,
                             int B, int C, int HW, int G, float count, int act,
                             cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  const bool vec = packable<T>(x, HW) && packable<T>(g, HW) && packable<T>(dx, HW);
  const int per_block = kSplitThreads * (vec ? Pack<T>::N : 1);
  int xblocks = (HW + per_block - 1) / per_block;
  if (xblocks > 64) xblocks = 64;  // each thread then loops over the row
  dim3 grid((unsigned)((int64_t)B * C), xblocks);
  if (vec)
    gn_bwd_apply_kernel<T, true><<<grid, kSplitThreads, 0, st>>>(
        xt, gt, mean, inv, gamma, beta, sums, dxt, C, HW, G, count, act);
  else
    gn_bwd_apply_kernel<T, false><<<grid, kSplitThreads, 0, st>>>(
        xt, gt, mean, inv, gamma, beta, sums, dxt, C, HW, G, count, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_stats_cluster(const void* x, const void* g, const float* mean,
                                     const float* inv, const float* gamma, const float* beta,
                                     float* dparam, float* sums, int B, int C, int HW, int G, int R,
                                     int act, cudaStream_t st) {
  const int64_t n = (int64_t)(C / G) * HW;
  return launch_cluster<gn_bwd_stats_cluster_kernel<T, kBwdStatsThreads>>(
      (int64_t)B * G * R, kBwdStatsThreads, R, (int)stats_cluster_smem(C / G, R), st,
      static_cast<const T*>(x), static_cast<const T*>(g), mean, inv, gamma, beta, dparam, sums, C,
      HW, G, R, (int)slice_len(sizeof(T), n, R), act);
}

template <typename T>
cudaError_t launch_bwd_apply_flat(const void* x, const void* g, const float* mean,
                                  const float* inv, const float* gamma, const float* beta,
                                  const float* sums, void* dx, int B, int C, int HW, int G,
                                  float count, int act, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  const int64_t numel = (int64_t)B * C * HW;
  int K;
  const unsigned ctas = (unsigned)gn_bwd_apply_flat_grid(sizeof(T), numel, K);
  if (numel + (int64_t)kFlatThreads * K * Pack<T>::N <= INT_MAX)
    gn_bwd_apply_flat_kernel<T, int><<<ctas, kFlatThreads, 0, st>>>(
        xt, gt, mean, inv, gamma, beta, sums, dxt, C, HW, G, (int)numel, K, count, act);
  else
    gn_bwd_apply_flat_kernel<T, int64_t><<<ctas, kFlatThreads, 0, st>>>(
        xt, gt, mean, inv, gamma, beta, sums, dxt, C, HW, G, numel, K, count, act);
  return cudaGetLastError();
}

// The split backward's entry points for storage type T: the new bodies
// where the rules and alignment let them (reported as kClusterLaunched /
// kFlatLaunched), else the streaming fallback; `rows` launches the fallback
// at any shape and alignment (the yardstick entry points).
template <typename T>
int bwd_stats(const void* x, const void* g, const float* mean, const float* inv,
              const float* gamma, const float* beta, float* dparam, float* sums, unsigned* done,
              int B, int C, int HW, int G, int act, bool rows, cudaStream_t st) {
  const int R = rows ? 0 : gn_bwd_stats_cluster_size(sizeof(T), B, C, HW, G);
  if (R && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g)) % 16 == 0)
    return cluster_result(launch_bwd_stats_cluster<T>(x, g, mean, inv, gamma, beta, dparam, sums,
                                                      B, C, HW, G, R, act, st));
  if (!done) return (int)cudaErrorInvalidValue;  // the fallback's group tickets
  return (int)launch_bwd_stats<T>(x, g, mean, inv, gamma, beta, dparam, sums, done, B, C, HW, G,
                                  act, st);
}

template <typename T>
int bwd_apply(const void* x, const void* g, const float* mean, const float* inv,
              const float* gamma, const float* beta, const float* sums, void* dx, int B, int C,
              int HW, int G, float count, int act, bool rows, cudaStream_t st) {
  if (!rows && packable<T>(x, HW) && packable<T>(g, HW) && packable<T>(dx, HW))
    return flat_result(launch_bwd_apply_flat<T>(x, g, mean, inv, gamma, beta, sums, dx, B, C, HW,
                                                G, count, act, st));
  return (int)launch_bwd_apply<T>(x, g, mean, inv, gamma, beta, sums, dx, B, C, HW, G, count, act,
                                  st);
}

int bwd_stats_entry(const void* x, const void* g, const void* mean, const void* inv,
                    const void* gamma, const void* beta, void* dparam, void* sums, void* done,
                    int B, int C, int HW, int G, int act, int dtype, bool rows, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* dp = static_cast<float*>(dparam);
  float* sm = static_cast<float*>(sums);
  unsigned* dn = static_cast<unsigned*>(done);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return bwd_stats<float>(x, g, f(mean), f(inv), f(gamma), f(beta), dp, sm, dn, B, C, HW, G,
                            act, rows, st);
  if (dtype == kBF16)
    return bwd_stats<__nv_bfloat16>(x, g, f(mean), f(inv), f(gamma), f(beta), dp, sm, dn, B, C,
                                    HW, G, act, rows, st);
  return (int)cudaErrorInvalidValue;
}

int bwd_apply_entry(const void* x, const void* g, const void* mean, const void* inv,
                    const void* gamma, const void* beta, const void* sums, void* dx, int B, int C,
                    int HW, int G, float count, int act, int dtype, bool rows, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return bwd_apply<float>(x, g, f(mean), f(inv), f(gamma), f(beta), f(sums), dx, B, C, HW, G,
                            count, act, rows, st);
  if (dtype == kBF16)
    return bwd_apply<__nv_bfloat16>(x, g, f(mean), f(inv), f(gamma), f(beta), f(sums), dx, B, C,
                                    HW, G, count, act, rows, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, const float* gamma, const float* beta,
                       void* dx, float* dparam, int B, int C, int HW, int G, float eps, int act,
                       cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  const size_t smem = 2 * sizeof(float) * (size_t)(C / G);
  if (packable<T>(x, HW) && packable<T>(g, HW) && packable<T>(dx, HW))
    gn_bwd_kernel<T, true><<<B * G, kBwdThreads, smem, st>>>(xt, gt, gamma, beta, dxt, dparam,
                                                             C, HW, G, eps, act);
  else
    gn_bwd_kernel<T, false><<<B * G, kBwdThreads, smem, st>>>(xt, gt, gamma, beta, dxt, dparam,
                                                              C, HW, G, eps, act);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tt

extern "C" {

// The cluster body where gn_fwd_cluster_size gives a cluster and x, y are
// 16-byte aligned (reported as kClusterLaunched), else the streaming body.
int tt_gn_silu_fwd(const void* x, const void* gamma, const void* beta, void* y, int B, int C,
                   int HW, int G, float eps, int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  if (dtype != tt::kF32 && dtype != tt::kBF16) return (int)cudaErrorInvalidValue;
  const int R = tt::gn_fwd_cluster_size(dtype == tt::kF32 ? 4 : 2, B, C, HW, G);
  if (R && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0)
    return tt::cluster_result(
        dtype == tt::kF32
            ? tt::launch_fwd_cluster<float>(x, ga, be, y, B, C, HW, G, R, eps, act, st)
            : tt::launch_fwd_cluster<__nv_bfloat16>(x, ga, be, y, B, C, HW, G, R, eps, act, st));
  if (dtype == tt::kF32)
    tt::launch_fwd<float>(x, ga, be, y, B, C, HW, G, eps, act, st);
  else
    tt::launch_fwd<__nv_bfloat16>(x, ga, be, y, B, C, HW, G, eps, act, st);
  return (int)cudaGetLastError();
}

int tt_gn_stats(const void* x, void* parts, int B, int C, int HW, int G, int chunks, int dtype,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(parts);
  if (dtype == tt::kF32)
    tt::launch_stats<float>(x, pt, B, C, HW, G, chunks, st);
  else if (dtype == tt::kBF16)
    tt::launch_stats<__nv_bfloat16>(x, pt, B, C, HW, G, chunks, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int tt_gn_apply(const void* x, const void* a, const void* b, void* y, int B, int C, int HW,
                int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  if (dtype == tt::kF32)
    tt::launch_apply<float>(x, af, bf, y, B, C, HW, act, st);
  else if (dtype == tt::kBF16)
    tt::launch_apply<__nv_bfloat16>(x, af, bf, y, B, C, HW, act, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The cluster body where gn_bwd_cluster_size gives a cluster and x, g, dx are
// 16-byte aligned (reported as kClusterLaunched; dparam's first B /
// gn_bwd_cluster_samples rows hold the sums), else the streaming body (all B
// rows). dparam has room for B rows either way.
int tt_gn_silu_bwd(const void* x, const void* g, const void* gamma, const void* beta, void* dx,
                   void* dparam, int B, int C, int HW, int G, float eps, int act, int dtype,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* dp = static_cast<float*>(dparam);
  if (dtype != tt::kF32 && dtype != tt::kBF16) return (int)cudaErrorInvalidValue;
  const int R = tt::gn_bwd_cluster_size(dtype == tt::kF32 ? 4 : 2, B, C, HW, G);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
                        reinterpret_cast<uintptr_t>(dx)) % 16 == 0;
  if (R && aligned)
    return tt::cluster_result(
        dtype == tt::kF32
            ? tt::launch_bwd_cluster<float>(x, g, ga, be, dx, dp, B, C, HW, G, R, eps, act, st)
            : tt::launch_bwd_cluster<__nv_bfloat16>(x, g, ga, be, dx, dp, B, C, HW, G, R, eps,
                                                    act, st));
  if (dtype == tt::kF32)
    return (int)tt::launch_bwd<float>(x, g, ga, be, dx, dp, B, C, HW, G, eps, act, st);
  if (dtype == tt::kBF16)
    return (int)tt::launch_bwd<__nv_bfloat16>(x, g, ga, be, dx, dp, B, C, HW, G, eps, act, st);
  return (int)cudaErrorInvalidValue;
}

// The split backward (sequence parallelism): the per-channel and group sums
// of a slab, then dx from the group sums all-reduced over the slabs. mean,
// inv (B, G) f32; dparam (B, 2, C) f32; sums (B, G, 2) f32. tt_gn_bwd_stats
// takes the cluster body where gn_bwd_stats_cluster_size gives a cluster and
// x, g are 16-byte aligned (reported as kClusterLaunched; done unused, may
// be null), else the streaming fallback, whose group tickets done holds (B*G
// unsigned zeros). tt_gn_bwd_apply takes the flat body where HW is a whole
// number of packets and x, g, dx are 16-byte aligned (reported as
// kFlatLaunched), else the fallback. The _rows entry points launch the
// fallbacks alone.
int tt_gn_bwd_stats(const void* x, const void* g, const void* mean, const void* inv,
                    const void* gamma, const void* beta, void* dparam, void* sums, void* done,
                    int B, int C, int HW, int G, int act, int dtype, void* stream) {
  return tt::bwd_stats_entry(x, g, mean, inv, gamma, beta, dparam, sums, done, B, C, HW, G, act,
                             dtype, false, stream);
}

int tt_gn_bwd_stats_rows(const void* x, const void* g, const void* mean, const void* inv,
                         const void* gamma, const void* beta, void* dparam, void* sums, void* done,
                         int B, int C, int HW, int G, int act, int dtype, void* stream) {
  return tt::bwd_stats_entry(x, g, mean, inv, gamma, beta, dparam, sums, done, B, C, HW, G, act,
                             dtype, true, stream);
}

int tt_gn_bwd_apply(const void* x, const void* g, const void* mean, const void* inv,
                    const void* gamma, const void* beta, const void* sums, void* dx, int B,
                    int C, int HW, int G, float count, int act, int dtype, void* stream) {
  return tt::bwd_apply_entry(x, g, mean, inv, gamma, beta, sums, dx, B, C, HW, G, count, act,
                             dtype, false, stream);
}

int tt_gn_bwd_apply_rows(const void* x, const void* g, const void* mean, const void* inv,
                         const void* gamma, const void* beta, const void* sums, void* dx, int B,
                         int C, int HW, int G, float count, int act, int dtype, void* stream) {
  return tt::bwd_apply_entry(x, g, mean, inv, gamma, beta, sums, dx, B, C, HW, G, count, act,
                             dtype, true, stream);
}

const char* tt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
