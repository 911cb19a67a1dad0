// Fused log-domain Sinkhorn for Hopper (sm_90a).
//
// Replaces: rdmnet_tpu/ops/pallas/sinkhorn.py, sinkhorn_pallas (Pallas TPU
// kernel _sinkhorn_kernel). Per patch p it runs num_iterations of
//   u = log_mu - LSE_j(s + v),   v = log_nu - LSE_i(s + u)
// from u = v = 0, with LSE(t) = max(t) + log(sum(exp(t - max(t)))), then
// writes (s + u) + v once. Masked entries carry -1e12 (not -inf), so fully
// masked rows and patches stay finite exactly as in the JAX version: every
// entry of such a row rounds to the same value, its LSE equals it, and u
// (or v) is 0. The exp-space (scaling) form would underflow there.
//
// What bounds it: operations. At the main-path shape (P=256, K1=129, 100
// iterations) it evaluates 2*100*256*129^2 = 8.5e8 exponentials, ~0.2 ms at
// the SFU rate of 132 SMs x 16/clk; its 34 MB of input and output take
// ~10 us at 3.35 TB/s.
//
// Design: one CTA of 256 threads per patch, as a 16 x 16 grid. Thread
// (a, b) holds rows a + 16 i and columns b + 16 j of the patch (K1 <= 16 N)
// in registers, (N - 1) x N values (72 at K1 = 129), so the K1 x K1 block is
// read from device memory once and its values never pass through shared
// memory again; a thread's last row (a + 16 (N - 1): at K1 = 129 only row
// 128, held by row group 0) is kept in shared memory, where only the warps
// that have such a row read it. The row LSE is a per-thread max and exp-sum
// over the thread's own columns, each followed by a 4-step shuffle reduction
// over the 16 lanes that share the row; a thread's rows go through these
// steps in two batches, so their latencies overlap without running out of
// registers. u stays with the warp that computed it (written to shared
// memory, read back after a __syncwarp), so the row half-step needs no
// barrier. The column LSE is a per-thread (max, exp-sum) partial over the
// thread's own rows, written to a 16 x K1 shared buffer; after one barrier
// thread c merges column c's 16 partials with the online-softmax rescale
// (sum_r s_r 2^(m_r - M)) into v[c], and a second barrier publishes v. Two
// barriers an iteration. Values are kept in log2 units, so each exp is one
// MUFU ex2.approx and each log one lg2.approx, written as inline PTX in this
// source only: the build flags stay those of the kNN kernel (no
// -use_fast_math). Up to N = 9 (K1 <= 144) a thread fits in 128 registers
// without spilling, so two CTAs share an SM and the 256 patches of the main
// path run in one wave on 132 SMs; N = 13 (K1 <= 208) runs one CTA an SM.
//
// 208 < K1 <= 546, the cluster path (sinkhorn_cluster_launch): a patch no
// longer fits in the registers of a CTA (at K1 = 257 it is 264 KB, above the
// 227 KB of shared memory of one SM too), but it fits in the shared memory of
// a thread-block cluster of C = 2, 4 or 8 CTAs on neighbouring SMs, which
// read each other's shared memory. CTA `rank` of a patch's cluster holds the
// band of rows [rank B, rank B + B), B = ceil(K1 / C), read from device
// memory once and kept in log2 units, beside a full copy of v and its rows'
// u. 16 warps; warp a holds rows a + 16 i of the band and lane b columns
// b + 32 j, j < NC, NC = ceil(K1 / 32) a template argument, so every loop
// over a lane's columns unrolls and its loads carry no predicate (only the
// last chunk's is clamped and masked) and a row's loads issue together:
// per-lane predicates and a runtime chunk bound keep them apart and leave
// the sweeps latency-bound, ~2x slower. Row half-step: local to the
// CTA, the register path's LSE (ex2/lg2 PTX) over four rows of a warp at a
// time, their maxima and sums reduced together by a reduce-scatter over the
// lanes (6 shuffles for four rows where four reductions take 20); u stays
// with the warp that computed it, so no barrier. Column half-step: each warp
// writes per-column (max, exp-sum) partials over its rows (two sweeps of the
// band, two rows a step: max, then sum), a barrier, and thread c merges
// column c's 16 partials with the online-softmax rescale into the CTA's
// partial, written into one of two exchange buffers by iteration parity.
// After one cluster.sync() every CTA reads the C partials of each of its
// merge columns through cluster.map_shared_rank (all in flight at once) and
// merges them into v, redundantly, so no second exchange is needed; a
// barrier publishes v. The parity buffers make
// one cluster barrier an iteration enough: a CTA writes buffer it & 1 again
// only after the next iteration's cluster barrier, which every CTA reaches
// after its reads of it. A last cluster.sync() keeps every CTA resident
// until no other CTA reads its shared memory. What bounds it: the function's
// own operations, the exps (at P = 256, K1 = 257, 100 iterations: 3.38e9,
// ~0.81 ms on the SFU); the patch crosses device memory once each way. On
// an H100 it runs at ~3.4x that, as the register path runs at ~3x its own:
// with 16 warps an SM the sweeps are latency-bound, and the merges and the
// cluster barrier take ~30% of an iteration (rdmnet_tpu_torch/tools/
// kernel_probe.py times the parts). The plan (rdmnet_tpu_torch/ops/kernels/sinkhorn.py sinkhorn_plan) takes the
// smallest C whose band, vectors and partials fit in 232,448 bytes a CTA:
// C = 2 to K1 = 304, 4 to 412, 8 to 546.
//
// K1 > 546, the group path (sinkhorn_group_launch): a patch fits in
// no cluster of the portable sizes (C = 16 would end at K1 = 707, and the
// cluster path's 16 warps' partials alone are 37 K1 floats a CTA), so it is
// split over a group of G CTAs that are not a cluster: CTA `rank` holds rows
// [rank B, rank B + B), B = ceil(K1 / G), in shared memory for every
// iteration (read from device memory once, written once), beside v, its
// rows' u and log_mu: B K1p + K1p + 2 B floats (K1p = K1 rounded up to 32),
// no per-warp partials. The plan takes the smallest G whose CTA fits in
// 232,448 bytes: G = 6 at K1 = 547, 7 at 600, 20 at 1025, 132 (one CTA on
// each SM of an H100) at 2640, the last K1 whose 20-row band fits. 32
// warps, one CTA an SM. Row half-step: a warp per row pair, lanes over
// columns (conflict-free), each lane folding its columns in blocks of 8
// with an online (max, sum): block max and sum as trees, one rescale a
// block; the lanes merge by reduce-scatters. Column half-step: a warp per
// 32 columns, a lane per column, the band's rows folded 8 at a time into
// two chains (u read as float4), so the CTA's (max, sum) partial of a
// column comes out of registers and goes straight to device memory (L2).
// Exchange: the group's CTAs are resident together (a cooperative launch
// of as many groups as the card holds, at most P, walking the patches in
// rounds), so they meet at a barrier in device memory (an arrival counter,
// red.release / ld.acquire at gpu scope); CTA `rank` then merges the G
// partials of its slice of ceil(K1 / G) columns (S lanes a column, S x 8 >=
// G, combined by shuffles) into v and publishes each column with its
// iteration's tag in one 8-byte store, and every CTA reads v back through
// L2 as the tags arrive (in place of a second barrier and a read: 6-7%
// faster at K1 600 and 1025). A redundant merge (every CTA merging all K1
// columns from the G partials) was timed beside the reduce-scatter
// (kernel_probe.py): 7% faster at G = 7, 1.3-1.5x slower at G = 20 and
// 40x at G = 132, where its merge grows as G^2. What bounds it: the exps,
// 2 x iters x P x K1^2 (at P = 256, K1 = 600, 100 iterations: 4.41 ms on
// the SFU); the card runs it at ~3-4x that: the sweeps at ~2x their MUFU
// time, the exchange ~20-25% of an iteration.
//
// K1 > 2640, the same group path with spilled rows: a band of ceil(K1 / 132)
// rows no longer fits in one SM's shared memory (at K1 = 2641, 21 rows of
// 2656 floats where 20 fit), so the plan takes B = ceil(K1 / 132) and G =
// ceil(K1 / B) <= 132 CTAs, and each CTA keeps as many of its rows in shared
// memory as fit; the rest (its last spill rows: 1 of 21 at K1 = 2641, 5 of
// 23 at 3000, 19 of 32 at 4096) it reads from the scores in device memory in
// every half-step, scaled to log2 units as the shared rows were when they
// were loaded. While the spilled rows of all the group's CTAs fit in the
// 50 MB L2 (at K1 = 2641 the whole 27.9 MB patch does), they can stay there
// between half-steps.
// Exchange, barrier, merge and tagged v are those of the group path; the
// spill code is a template instance of its own (SPILL), so the group path
// at K1 <= 2640 runs the code it ran before.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

#define SK_THREADS 256
#define SK_GRID 16  // SK_GRID x SK_GRID threads
#define SK_MAX_K1 208  // the register path's largest patch; above it the cluster path
#define SKC_THREADS 512
#define SKC_WARPS (SKC_THREADS / 32)
#define SKC_MAX_CLUSTER 8   // the largest portable cluster
#define SKC_MERGE_COLS 2    // merge columns a thread: K1 <= 2 x SKC_THREADS
#define SKC_SMEM_MAX 232448
#define SKC_NO_CLUSTER (-1)  // returned when no cluster of the plan fits on the card
#define SKG_THREADS 1024  // 32 warps: at most 3 rows a warp, 64 registers a thread
#define SKG_WARPS (SKG_THREADS / 32)
#define SKG_CH 8          // row step: 32-column groups a lane folds at a time
#define SKG_RR 8          // column step: rows a lane folds at a time
#define SKG_MERGE 8       // partials a lane folds at a time in the merge
#define SKG_BAR_STRIDE 32  // words between two groups' counters: one 128-byte line each
#define SKG_NO_GROUP (-2)  // returned when the card cannot hold the groups at once
#define FULL_MASK 0xffffffffu
#define LOG2E 1.4426950408889634f
#define LN2 0.6931471805599453f

// One MUFU instruction each; inputs are never denormal here (an exponent
// <= 0 or -inf; a sum >= 1), so flushing to zero changes nothing.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// All values are kept in log2 units (scores, log_mu, log_nu times log2 e)
// and the plan is scaled back by ln 2 once at the end; a fully masked row
// then still has every entry equal, so its LSE is that entry and u is 0.
// Entries outside the K1 x K1 patch hold -inf and u of a row outside it is
// -inf, so no exp inside the loop needs a predicate. A thread's last row
// (a + 16 (N - 1): the row 128 that K1 = 129 adds to a 16 x 8 layout) lives
// in shared memory, not in registers, and only the warps that have one
// touch it.
template <int N>
__global__ void __launch_bounds__(SK_THREADS, N <= 9 ? 2 : 1)
sinkhorn_kernel(const float* __restrict__ scores, const float* __restrict__ log_mu,
                const float* __restrict__ log_nu, int K1, int iters,
                float* __restrict__ out) {
  constexpr int R = N - 1;                   // register rows a thread holds
  constexpr int W = SK_GRID * N;             // rows or columns the grid covers
  constexpr int STRIDE = SK_GRID * (N | 1);  // odd multiple of 16: conflict-free partials
  constexpr int RB = (R + 1) / 2;            // register rows reduced together
  __shared__ float part_m[SK_GRID * STRIDE];
  __shared__ float part_s[SK_GRID * STRIDE];
  __shared__ float tail[SK_GRID * W];  // row a + 16 R of row group a
  __shared__ float mu[W], nu[W], u_sh[W], v_sh[W];

  const int tid = threadIdx.x;
  const int a = tid >> 4, b = tid & 15;  // rows a + 16 i, columns b + 16 j
  const int warp_a = (tid >> 5) * 2;     // the warp's first row group (it holds two)
  const bool has_tail = warp_a + SK_GRID * R < K1;  // warp-uniform
  const int ra = a + SK_GRID * R;        // this thread's last row
  float* xt = tail + a * W + b;          // xt[SK_GRID * j]: row ra, column b + 16 j
  const int p = blockIdx.x;
  const float* sp = scores + (size_t)p * K1 * K1;

  float x[R][N];
#pragma unroll
  for (int i = 0; i <= R; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int r = a + SK_GRID * i, c = b + SK_GRID * j;
      const float val = (r < K1 && c < K1) ? sp[r * K1 + c] * LOG2E : -CUDART_INF_F;
      if (i < R)
        x[i < R ? i : 0][j] = val;
      else
        xt[SK_GRID * j] = val;
    }
  for (int t = tid; t < W; t += SK_THREADS) {
    mu[t] = t < K1 ? log_mu[(size_t)p * K1 + t] * LOG2E : 0.f;
    nu[t] = t < K1 ? log_nu[(size_t)p * K1 + t] * LOG2E : 0.f;
    u_sh[t] = t < K1 ? 0.f : -CUDART_INF_F;  // a row outside the patch adds nothing
  }
  float v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = 0.f;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // u: row LSE of s + v over the 16 lanes of the row group. RB rows step
    // through the max, the shuffles and the sum together, so their latencies
    // overlap; u goes to shared memory, read back only by the same warp.
#pragma unroll
    for (int i0 = 0; i0 <= R; i0 += RB) {
      float m[RB], sum[RB];
      bool live[RB];  // warp-uniform
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const int i = i0 + k;
        live[k] = i < R ? warp_a + SK_GRID * i < K1 : (i == R && has_tail);
        m[k] = -CUDART_INF_F;
        if (live[k])
#pragma unroll
          for (int j = 0; j < N; ++j)
            m[k] = fmaxf(m[k], (i < R ? x[i < R ? i : 0][j] : xt[SK_GRID * j]) + v[j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
#pragma unroll
        for (int k = 0; k < RB; ++k)
          if (live[k]) m[k] = fmaxf(m[k], __shfl_xor_sync(FULL_MASK, m[k], o));
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const int i = i0 + k;
        sum[k] = 0.f;
        if (live[k])
#pragma unroll
          for (int j = 0; j < N; ++j)
            sum[k] += ex2(((i < R ? x[i < R ? i : 0][j] : xt[SK_GRID * j]) + v[j]) - m[k]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
#pragma unroll
        for (int k = 0; k < RB; ++k)
          if (live[k]) sum[k] += __shfl_xor_sync(FULL_MASK, sum[k], o);
#pragma unroll
      for (int k = 0; k < RB; ++k) {
        const int r = a + SK_GRID * (i0 + k);
        if (live[k] && b == 0 && r < K1) u_sh[r] = mu[r] - (m[k] + lg2(sum[k]));
      }
    }
    __syncwarp();

    // v: per-thread column partials over the thread's rows, merged per column
    float uu[R];
#pragma unroll
    for (int i = 0; i < R; ++i) uu[i] = u_sh[a + SK_GRID * i];
    const float ut = u_sh[ra];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = b + SK_GRID * j;
      float m = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < R; ++i) m = fmaxf(m, x[i][j] + uu[i]);
      const float tj = has_tail ? xt[SK_GRID * j] + ut : -CUDART_INF_F;
      m = fmaxf(m, tj);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) sum += ex2((x[i][j] + uu[i]) - m);
      if (has_tail) sum += ex2(tj - m);
      if (c < K1) {
        part_m[a * STRIDE + c] = m;
        part_s[a * STRIDE + c] = m == -CUDART_INF_F ? 0.f : sum;  // a thread with no row
      }
    }
    __syncthreads();
    if (tid < K1) {
      float pm[SK_GRID], mx = -CUDART_INF_F;
#pragma unroll
      for (int g = 0; g < SK_GRID; ++g) {
        pm[g] = part_m[g * STRIDE + tid];
        mx = fmaxf(mx, pm[g]);
      }
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < SK_GRID; ++g) s += part_s[g * STRIDE + tid] * ex2(pm[g] - mx);
      v_sh[tid] = nu[tid] - (mx + lg2(s));
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = b + SK_GRID * j;
      v[j] = c < K1 ? v_sh[c] : 0.f;
    }
  }

  float* op = out + (size_t)p * K1 * K1;
#pragma unroll
  for (int i = 0; i <= R; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int r = a + SK_GRID * i, c = b + SK_GRID * j;
      const float val = i < R ? x[i < R ? i : 0][j] : xt[SK_GRID * j];
      if (r < K1 && c < K1) op[r * K1 + c] = ((val + u_sh[r]) + v[j]) * LN2;
    }
}

template <int N>
static int launch(const float* scores, const float* log_mu, const float* log_nu, int P, int K1,
                  int iters, float* out, cudaStream_t st) {
  sinkhorn_kernel<N><<<P, SK_THREADS, 0, st>>>(scores, log_mu, log_nu, K1, iters, out);
  return (int)cudaGetLastError();
}

// scores (P, K1, K1), log_mu / log_nu (P, K1), out (P, K1, K1), all float32
// and contiguous; 1 <= K1 <= SK_MAX_K1. Returns cudaGetLastError() after the
// launch.
extern "C" int sinkhorn_launch(const float* scores, const float* log_mu, const float* log_nu,
                               int P, int K1, int iters, float* out, void* stream) {
  if (K1 < 1 || K1 > SK_MAX_K1) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (K1 <= 32) return launch<2>(scores, log_mu, log_nu, P, K1, iters, out, st);
  if (K1 <= 80) return launch<5>(scores, log_mu, log_nu, P, K1, iters, out, st);
  if (K1 <= 144) return launch<9>(scores, log_mu, log_nu, P, K1, iters, out, st);
  return launch<13>(scores, log_mu, log_nu, P, K1, iters, out, st);
}

// ---- 208 < K1 <= 546: the cluster path -----------------------------------------------

// Dynamic shared memory a CTA takes: the two parity exchange buffers (2 x 2 x
// K1), v (K1), its rows' log_mu and u (2 x band_rows), the warps' column
// partials (2 x 16 x K1) and its band (band_rows x K1); floats.
static size_t cluster_smem_bytes(int K1, int band_rows) {
  return sizeof(float) * ((size_t)band_rows * K1 + (2 * SKC_WARPS + 5) * (size_t)K1 +
                          2 * (size_t)band_rows);
}

// A lane's values of one band row: columns lane + 32 j, j < NC. The last
// chunk is the only one that may pass K1; its load is clamped to the row's
// last column (always valid) and masked to -inf, so every load is
// unconditional and the compiler can issue a row's loads together.
template <int NC>
__device__ __forceinline__ void load_row(const float* x, int last_off, bool last_ok,
                                         float (&a)[NC]) {
#pragma unroll
  for (int j = 0; j < NC - 1; ++j) a[j] = x[32 * j];
  const float y = x[last_off];
  a[NC - 1] = last_ok ? y : -CUDART_INF_F;
}

// Reduce RB per-lane values (RB = 1, 2 or 4, one per row) over the warp with
// op, scattering the rows over the lanes: afterwards lane l holds row
// l / (32 / RB)'s result. A reduce-scatter takes RB - 1 + 5 - log2(RB)
// shuffles where RB separate reductions take 5 RB.
template <int RB, typename Op>
__device__ __forceinline__ float reduce_scatter(const float (&x)[RB], int lane, Op op) {
  float y;
  if constexpr (RB == 4) {
    const bool hi = lane & 16;  // keeps rows 2, 3
    const float a0 = op(hi ? x[2] : x[0], __shfl_xor_sync(FULL_MASK, hi ? x[0] : x[2], 16));
    const float a1 = op(hi ? x[3] : x[1], __shfl_xor_sync(FULL_MASK, hi ? x[1] : x[3], 16));
    const bool odd = lane & 8;  // keeps the second of the two
    y = op(odd ? a1 : a0, __shfl_xor_sync(FULL_MASK, odd ? a0 : a1, 8));
  } else if constexpr (RB == 2) {
    const bool hi = lane & 16;
    y = op(hi ? x[1] : x[0], __shfl_xor_sync(FULL_MASK, hi ? x[0] : x[1], 16));
  } else {
    y = x[0];
  }
#pragma unroll
  for (int o = 16 / RB; o > 0; o >>= 1) y = op(y, __shfl_xor_sync(FULL_MASK, y, o));
  return y;
}

// u of rows r + 16 k, k < RB (all in the band): the row LSE of s + v over
// the lanes' columns, the maxima and sums reduced together (reduce_scatter),
// the maxima broadcast back; lane 32 k / RB writes row k's u.
template <int RB, int NC>
__device__ __forceinline__ void row_lse(const float* band, int K1, int r, const float (&v)[NC],
                                        int last_off, bool last_ok, int lane,
                                        const float* mu_sh, float* u_sh) {
  float t[RB][NC], m[RB];
#pragma unroll
  for (int k = 0; k < RB; ++k) load_row(band + (size_t)(r + 16 * k) * K1 + lane, last_off,
                                        last_ok, t[k]);
#pragma unroll
  for (int k = 0; k < RB; ++k) {
    m[k] = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      t[k][j] += v[j];
      m[k] = fmaxf(m[k], t[k][j]);
    }
  }
  const float mine = reduce_scatter<RB>(m, lane, [](float a, float b) { return fmaxf(a, b); });
  float sum[RB];
#pragma unroll
  for (int k = 0; k < RB; ++k) {
    m[k] = __shfl_sync(FULL_MASK, mine, 32 / RB * k);
    sum[k] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) sum[k] += ex2(t[k][j] - m[k]);
  }
  const float tot = reduce_scatter<RB>(sum, lane, [](float a, float b) { return a + b; });
  if (lane % (32 / RB) == 0) {
    const int k = lane / (32 / RB);
    const int row = r + 16 * k;
    u_sh[row] = mu_sh[row] - (mine + lg2(tot));
  }
}

// NC: the column chunks of 32 a lane holds, exactly: 32 (NC - 1) < K1 <= 32 NC.
// PAIR: the column sweeps take two rows a step (registers allowing).
template <int NC>
__global__ void __launch_bounds__(SKC_THREADS, 1)
sinkhorn_cluster_kernel(const float* __restrict__ scores, const float* __restrict__ log_mu,
                        const float* __restrict__ log_nu, int K1, int band_rows, int iters,
                        float* __restrict__ out) {
  constexpr bool PAIR = NC <= 13;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int p = blockIdx.x / C;
  const int r0 = rank * band_rows;
  const int nb = max(0, min(band_rows, K1 - r0));  // rows of this CTA's band
  extern __shared__ float2 xbuf[];  // [parity][K1] (max, sum); then v, log_mu, u, partials, band
  float* v_sh = reinterpret_cast<float*>(xbuf + 2 * K1);
  float* mu_sh = v_sh + K1;
  float* u_sh = mu_sh + band_rows;
  float* part_m = u_sh + band_rows;
  float* part_s = part_m + SKC_WARPS * K1;
  float* band = part_s + SKC_WARPS * K1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool last_ok = 32 * (NC - 1) + lane < K1;
  const int last_off = last_ok ? 32 * (NC - 1) : K1 - 1 - lane;
  const float* sp = scores + ((size_t)p * K1 + r0) * K1;
  for (int t = tid; t < nb * K1; t += SKC_THREADS) band[t] = sp[t] * LOG2E;
  for (int t = tid; t < nb; t += SKC_THREADS) {
    mu_sh[t] = log_mu[(size_t)p * K1 + r0 + t] * LOG2E;
    u_sh[t] = 0.f;  // iters = 0: the output is s
  }
  float nu_r[SKC_MERGE_COLS];
#pragma unroll
  for (int k = 0; k < SKC_MERGE_COLS; ++k) {
    const int c = tid + k * SKC_THREADS;
    nu_r[k] = c < K1 ? log_nu[(size_t)p * K1 + c] * LOG2E : 0.f;
  }
  float v[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) v[j] = 0.f;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // u: row LSE of s + v over the warp's rows, four (registers allowing),
    // then two, then one at a time
    {
      constexpr int RB = NC <= 10 ? 4 : 2;
      const int nr = warp < nb ? (nb - warp + SKC_WARPS - 1) / SKC_WARPS : 0;  // the warp's rows
      int i = 0;
      for (; i + RB <= nr; i += RB)
        row_lse<RB>(band, K1, warp + SKC_WARPS * i, v, last_off, last_ok, lane, mu_sh, u_sh);
      if constexpr (RB == 4) {
        if (i + 2 <= nr) {
          row_lse<2>(band, K1, warp + SKC_WARPS * i, v, last_off, last_ok, lane, mu_sh, u_sh);
          i += 2;
        }
      }
      if (i < nr)
        row_lse<1>(band, K1, warp + SKC_WARPS * i, v, last_off, last_ok, lane, mu_sh, u_sh);
    }
    __syncwarp();

    // v: the warp's column partials over its rows, a sweep for the maxima and
    // one for the sums, two rows a step where registers allow (a row past
    // the band is a copy of the first with u = -inf: it adds nothing)
    float cm[NC], cs[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      cm[j] = -CUDART_INF_F;
      cs[j] = 0.f;
    }
    for (int r = warp; r < nb; r += (PAIR ? 2 : 1) * SKC_WARPS) {
      const int r1 = r + SKC_WARPS;
      const bool live1 = PAIR && r1 < nb;
      const float ur0 = u_sh[r], ur1 = live1 ? u_sh[r1] : -CUDART_INF_F;
      float a0[NC], a1[PAIR ? NC : 1];
      load_row(band + (size_t)r * K1 + lane, last_off, last_ok, a0);
      if constexpr (PAIR) {
        load_row(band + (size_t)(live1 ? r1 : r) * K1 + lane, last_off, last_ok, a1);
#pragma unroll
        for (int j = 0; j < NC; ++j) cm[j] = fmaxf(cm[j], fmaxf(a0[j] + ur0, a1[j] + ur1));
      } else {
#pragma unroll
        for (int j = 0; j < NC; ++j) cm[j] = fmaxf(cm[j], a0[j] + ur0);
      }
    }
    for (int r = warp; r < nb; r += (PAIR ? 2 : 1) * SKC_WARPS) {
      const int r1 = r + SKC_WARPS;
      const bool live1 = PAIR && r1 < nb;
      const float ur0 = u_sh[r], ur1 = live1 ? u_sh[r1] : -CUDART_INF_F;
      float a0[NC], a1[PAIR ? NC : 1];
      load_row(band + (size_t)r * K1 + lane, last_off, last_ok, a0);
      if constexpr (PAIR) {
        load_row(band + (size_t)(live1 ? r1 : r) * K1 + lane, last_off, last_ok, a1);
#pragma unroll
        for (int j = 0; j < NC; ++j)
          cs[j] += ex2((a0[j] + ur0) - cm[j]) + ex2((a1[j] + ur1) - cm[j]);
      } else {
#pragma unroll
        for (int j = 0; j < NC; ++j) cs[j] += ex2((a0[j] + ur0) - cm[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = 32 * j + lane;
      if (c < K1) {  // a warp with no row leaves (-inf, 0)
        part_m[warp * K1 + c] = cm[j];
        part_s[warp * K1 + c] = cs[j];
      }
    }
    __syncthreads();
    float2* xq = xbuf + (it & 1) * K1;
#pragma unroll
    for (int k = 0; k < SKC_MERGE_COLS; ++k) {
      const int c = tid + k * SKC_THREADS;
      if (c < K1) {
        float pm[SKC_WARPS], mx = -CUDART_INF_F;
#pragma unroll
        for (int g = 0; g < SKC_WARPS; ++g) {
          pm[g] = part_m[g * K1 + c];
          mx = fmaxf(mx, pm[g]);
        }
        float tot = 0.f;
#pragma unroll
        for (int g = 0; g < SKC_WARPS; ++g)
          if (pm[g] != -CUDART_INF_F) tot += part_s[g * K1 + c] * ex2(pm[g] - mx);
        xq[c] = make_float2(mx, tot);
      }
    }
    cluster.sync();  // every CTA's partials of this iteration are visible
    // every remote partial of the thread's columns in flight at once
    float2 pq[SKC_MERGE_COLS][SKC_MAX_CLUSTER];
#pragma unroll
    for (int k = 0; k < SKC_MERGE_COLS; ++k) {
      const int c = tid + k * SKC_THREADS;
#pragma unroll
      for (int q = 0; q < SKC_MAX_CLUSTER; ++q)
        pq[k][q] = c < K1 && q < C ? cluster.map_shared_rank(xq, q)[c]
                                   : make_float2(-CUDART_INF_F, 0.f);
    }
#pragma unroll
    for (int k = 0; k < SKC_MERGE_COLS; ++k) {
      const int c = tid + k * SKC_THREADS;
      if (c < K1) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int q = 0; q < SKC_MAX_CLUSTER; ++q) mx = fmaxf(mx, pq[k][q].x);
        float tot = 0.f;
#pragma unroll
        for (int q = 0; q < SKC_MAX_CLUSTER; ++q)
          if (pq[k][q].x != -CUDART_INF_F) tot += pq[k][q].y * ex2(pq[k][q].x - mx);
        v_sh[c] = nu_r[k] - (mx + lg2(tot));
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NC - 1; ++j) v[j] = v_sh[32 * j + lane];
    v[NC - 1] = last_ok ? v_sh[32 * (NC - 1) + lane] : 0.f;
  }
  cluster.sync();  // no CTA leaves while another may still read its partials

  float* op = out + ((size_t)p * K1 + r0) * K1;
  for (int r = warp; r < nb; r += SKC_WARPS) {
    const float ur = u_sh[r];  // written by this warp
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = 32 * j + lane;
      if (c < K1) op[(size_t)r * K1 + c] = ((band[(size_t)r * K1 + c] + ur) + v[j]) * LN2;
    }
  }
}

typedef void (*ClusterKernel)(const float*, const float*, const float*, int, int, int, float*);

static ClusterKernel cluster_kernel(int K1) {
  switch ((K1 + 31) / 32) {
    case 7: return sinkhorn_cluster_kernel<7>;
    case 8: return sinkhorn_cluster_kernel<8>;
    case 9: return sinkhorn_cluster_kernel<9>;
    case 10: return sinkhorn_cluster_kernel<10>;
    case 11: return sinkhorn_cluster_kernel<11>;
    case 12: return sinkhorn_cluster_kernel<12>;
    case 13: return sinkhorn_cluster_kernel<13>;
    case 14: return sinkhorn_cluster_kernel<14>;
    case 15: return sinkhorn_cluster_kernel<15>;
    case 16: return sinkhorn_cluster_kernel<16>;
    case 17: return sinkhorn_cluster_kernel<17>;
    case 18: return sinkhorn_cluster_kernel<18>;
    default: return nullptr;
  }
}

// The launch configuration of one cluster-path call; 0 or the error.
static int cluster_config(int P, int K1, int C, ClusterKernel* kern, int* band_rows,
                          size_t* smem, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                          cudaStream_t st) {
  if (K1 <= 192 || K1 > 576 || (C != 2 && C != 4 && C != 8)) return (int)cudaErrorInvalidValue;
  *band_rows = (K1 + C - 1) / C;
  if (K1 - (C - 1) * *band_rows < 1) return (int)cudaErrorInvalidValue;  // an empty band
  *smem = cluster_smem_bytes(K1, *band_rows);
  if (*smem > SKC_SMEM_MAX) return (int)cudaErrorInvalidValue;
  *kern = cluster_kernel(K1);
  cudaError_t e = cudaFuncSetAttribute(*kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)*smem);
  if (e != cudaSuccess) return (int)e;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(P * C));
  cfg->blockDim = dim3(SKC_THREADS);
  cfg->dynamicSmemBytes = *smem;
  cfg->stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

// How many clusters of C CTAs of the cluster path at this K1 the card holds at
// once (cudaOccupancyMaxActiveClusters) into *clusters. Returns 0 or the error.
extern "C" int sinkhorn_cluster_occupancy(int K1, int C, int* clusters) {
  ClusterKernel kern;
  int band_rows;
  size_t smem;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = cluster_config(1, K1, C, &kern, &band_rows, &smem, &cfg, attr, 0);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
}

// The cluster path: scores (P, K1, K1), log_mu / log_nu (P, K1), out (P, K1,
// K1) float32 and contiguous; a cluster of C (2, 4 or 8) CTAs a patch. Returns
// SKC_NO_CLUSTER when no such cluster fits on the card (nothing is launched:
// the caller raises, it never falls back), else cudaGetLastError() after the
// launch.
extern "C" int sinkhorn_cluster_launch(const float* scores, const float* log_mu,
                                       const float* log_nu, int P, int K1, int iters, int C,
                                       float* out, void* stream) {
  if (iters < 0 || P < 0) return (int)cudaErrorInvalidValue;
  ClusterKernel kern;
  int band_rows;
  size_t smem;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = cluster_config(P > 0 ? P : 1, K1, C, &kern, &band_rows, &smem, &cfg, attr,
                           (cudaStream_t)stream);
  if (err != 0) return err;
  if (P == 0) return 0;
  int clusters = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return SKC_NO_CLUSTER;
  e = cudaLaunchKernelEx(&cfg, kern, scores, log_mu, log_nu, K1, band_rows, iters, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---- K1 > 546: the group path -----------------------------------------------------------

// Dynamic shared memory a CTA takes: its rows' u and log_mu (2 x band_rows),
// v (K1p, K1 rounded up to 32 columns) and the first shared_rows rows of its
// band (shared_rows x K1p); floats.
static size_t group_smem_bytes(int K1, int band_rows, int shared_rows) {
  const size_t k1p = (size_t)(K1 + 31) / 32 * 32;
  return sizeof(float) * ((size_t)shared_rows * k1p + k1p + 2 * (size_t)band_rows);
}

// A band's rows in log2 units, row r column c (c < K1p): those held in
// shared memory (K1p floats a row, -inf past K1), and the spilled ones read
// from the scores in device memory in every half-step (scaled as the shared
// rows were when they were loaded; -inf past K1, where nothing is read).
struct SharedRows {
  static constexpr bool kShared = true;  // the first row is 0: u reads as float4
  const float* band;
  int K1p;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return band[(size_t)r * K1p + c];
  }
};

struct SpilledRows {
  static constexpr bool kShared = false;
  const float* rows;  // the patch's row 0 of this CTA's band
  int K1;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return c < K1 ? __fmul_rn(__ldg(rows + (size_t)r * K1 + c), LOG2E) : -CUDART_INF_F;
  }
};

// Fold N values t (log2 units) into an online (max, sum): the block's max and
// its sum of 2^(t - max) taken as trees, so a block's latency grows with
// log2 N. A state that has seen only -inf stays (-inf, 0), without a branch.
template <int N>
__device__ __forceinline__ void tree_fold(float& m, float& s, const float (&t)[N]) {
  float a[N];
#pragma unroll
  for (int j = 0; j < N; ++j) a[j] = t[j];
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) a[j] = fmaxf(a[j], a[j + w]);
  const float mn = fmaxf(m, a[0]);
  const float base = mn == -CUDART_INF_F ? 0.f : mn;
#pragma unroll
  for (int j = 0; j < N; ++j) a[j] = ex2(t[j] - base);
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) a[j] += a[j + w];
  s = s * ex2(m - base) + a[0];
  m = mn;
}

// tree_fold's (max, sum) with the block's max taken as a chain and the exps
// summed as they come: no copy of the block, so fewer registers, for the
// spilled rows, whose device-memory loads keep more of them live.
template <int N>
__device__ __forceinline__ void chain_fold(float& m, float& s, const float (&t)[N]) {
  float mx = t[0];
#pragma unroll
  for (int j = 1; j < N; ++j) mx = fmaxf(mx, t[j]);
  const float mn = fmaxf(m, mx);
  const float base = mn == -CUDART_INF_F ? 0.f : mn;
  float add = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) add += ex2(t[j] - base);
  s = s * ex2(m - base) + add;
  m = mn;
}

// The fold of a row source: trees on the shared rows, a chain on the
// spilled ones.
template <typename Rows, int N>
__device__ __forceinline__ void rows_fold(float& m, float& s, const float (&t)[N]) {
  if constexpr (Rows::kShared)
    tree_fold<N>(m, s, t);
  else
    chain_fold<N>(m, s, t);
}

// Fold N 32-column groups, from group g, of the RB band rows r + 32 k into
// the lane's online (max, sum) of each row: s + v, log2 units.
template <int RB, int N, typename Rows>
__device__ __forceinline__ void row_fold(const Rows& band, int r, int g, const float* v_sh,
                                         int lane, float (&m)[RB], float (&s)[RB]) {
  float t[RB][N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = 32 * (g + j) + lane;
    const float vv = v_sh[c];
#pragma unroll
    for (int k = 0; k < RB; ++k) t[k][j] = band(r + SKG_WARPS * k, c) + vv;
  }
#pragma unroll
  for (int k = 0; k < RB; ++k) rows_fold<Rows, N>(m[k], s[k], t[k]);
}

// u of the band rows r + 32 k, k < RB: each lane folds its columns (32 g +
// lane) in blocks of SKG_CH groups and a tail of 4, 2 and 1, then the lanes'
// (max, sum) pairs are merged by two reduce-scatters; lane 32 k / RB writes
// row k's u.
template <int RB, typename Rows>
__device__ __forceinline__ void group_row_lse(const Rows& band, int NG, int r, const float* v_sh,
                                              int lane, const float* mu_sh, float* u_sh) {
  float m[RB], s[RB];
#pragma unroll
  for (int k = 0; k < RB; ++k) {
    m[k] = -CUDART_INF_F;
    s[k] = 0.f;
  }
  int g = 0;
  for (; g + SKG_CH <= NG; g += SKG_CH) row_fold<RB, SKG_CH>(band, r, g, v_sh, lane, m, s);
  const int rem = NG - g;  // warp-uniform
  if (rem & 4) {
    row_fold<RB, 4>(band, r, g, v_sh, lane, m, s);
    g += 4;
  }
  if (rem & 2) {
    row_fold<RB, 2>(band, r, g, v_sh, lane, m, s);
    g += 2;
  }
  if (rem & 1) row_fold<RB, 1>(band, r, g, v_sh, lane, m, s);
  const float mine = reduce_scatter<RB>(m, lane, [](float a, float b) { return fmaxf(a, b); });
  float sc[RB];
#pragma unroll
  for (int k = 0; k < RB; ++k) sc[k] = s[k] * ex2(m[k] - __shfl_sync(FULL_MASK, mine, 32 / RB * k));
  const float tot = reduce_scatter<RB>(sc, lane, [](float a, float b) { return a + b; });
  if (lane % (32 / RB) == 0) {
    const int row = r + SKG_WARPS * (lane / (32 / RB));
    u_sh[row] = mu_sh[row] - (mine + lg2(tot));
  }
}

// Fold N band rows from row r of column c into the lane's online (max, sum):
// s + u, log2 units. On the shared rows from N = 4, r is a multiple of 4 and
// u is read as float4 (u_sh is 16-byte aligned).
template <int N, typename Rows>
__device__ __forceinline__ void col_fold(const Rows& band, int r, int c, const float* u_sh,
                                         float& m, float& s) {
  float t[N];
  if constexpr (N >= 4 && Rows::kShared) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 u4 = *reinterpret_cast<const float4*>(u_sh + r + j);
      t[j] = band(r + j, c) + u4.x;
      t[j + 1] = band(r + j + 1, c) + u4.y;
      t[j + 2] = band(r + j + 2, c) + u4.z;
      t[j + 3] = band(r + j + 3, c) + u4.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) t[j] = band(r + j, c) + u_sh[r + j];
  }
  rows_fold<Rows, N>(m, s, t);
}

// Fold band rows [r, r_end) of column c into two online (max, sum) chains,
// RR (8 or 4) rows at a time in alternate blocks, then 8, 4, 2 and 1.
template <int RR, typename Rows>
__device__ __forceinline__ void col_fold_rows(const Rows& band, int r, int r_end, int c,
                                              const float* u_sh, float& ma, float& sa, float& mb,
                                              float& sb) {
  for (; r + 2 * RR <= r_end; r += 2 * RR) {
    col_fold<RR>(band, r, c, u_sh, ma, sa);
    col_fold<RR>(band, r + RR, c, u_sh, mb, sb);
  }
  const int rem = r_end - r;  // < 2 RR
  if constexpr (RR >= 8) {
    if (rem & 8) {
      col_fold<8>(band, r, c, u_sh, ma, sa);
      r += 8;
    }
  }
  if (rem & 4) {
    col_fold<4>(band, r, c, u_sh, mb, sb);
    r += 4;
  }
  if (rem & 2) {
    col_fold<2>(band, r, c, u_sh, ma, sa);
    r += 2;
  }
  if (rem & 1) col_fold<1>(band, r, c, u_sh, mb, sb);
}

// Arrive at the group's barrier and wait until `target` arrivals (G per
// barrier so far) are visible. Every thread's earlier global writes are
// ordered before the release by the first __syncthreads, and the acquire
// before every thread's later reads by the second.
__device__ __forceinline__ void group_barrier(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(counter) : "memory");
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// v of one column published with its tag (the group's iterations so far,
// plus one) in one 8-byte store, so a reader that sees the tag sees the
// value; the scratch starts at zero, which no tag is.
__device__ __forceinline__ void store_tagged(uint2* p, float v, unsigned tag) {
  asm volatile("st.volatile.global.v2.u32 [%0], {%1, %2};" ::"l"(p), "r"(__float_as_uint(v)),
               "r"(tag)
               : "memory");
}

// The value at p once its tag is `tag`: read through L2 until it is.
__device__ __forceinline__ float load_tagged(const uint2* p, unsigned tag) {
  unsigned v, t;
  do {
    asm volatile("ld.volatile.global.v2.u32 {%0, %1}, [%2];" : "=r"(v), "=r"(t) : "l"(p) : "memory");
  } while (t != tag);
  return __uint_as_float(v);
}

// v of columns [c0, c0 + n): log_nu minus the LSE of the group's G partials
// (max, sum) of each column in `part` ([G][K1] float2, read through L2). S
// lanes share a column (S a power of two dividing 32, S x SKG_MERGE >= G):
// each folds up to SKG_MERGE partials, loaded together, then the S lanes
// merge by shuffles; the first of them stores v through st(c, v).
template <typename Store>
__device__ __forceinline__ void merge_columns(const float2* part, const float* nu, int G,
                                              int K1, int S, int c0, int n, Store st) {
  const int lane = threadIdx.x & 31, sub = lane & (S - 1);
  for (int i0 = (threadIdx.x >> 5) * (32 / S); i0 < n; i0 += SKG_THREADS / S) {  // warp-uniform
    const int i = i0 + lane / S;
    const int c = c0 + min(i, n - 1);  // a column past n repeats the last; not stored
    float2 x[SKG_MERGE];
    float m = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < SKG_MERGE; ++j) {
      const int q = sub + S * j;
      x[j] = q < G ? __ldcg(part + (size_t)q * K1 + c) : make_float2(-CUDART_INF_F, 0.f);
      m = fmaxf(m, x[j].x);
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < SKG_MERGE; ++j) s += x[j].y * ex2(x[j].x - m);  // (-inf, 0) adds 0
    for (int o = S >> 1; o > 0; o >>= 1) {
      const float mo = __shfl_xor_sync(FULL_MASK, m, o), so = __shfl_xor_sync(FULL_MASK, s, o);
      const float mn = fmaxf(m, mo);
      s = s * ex2(m - mn) + so * ex2(mo - mn);
      m = mn;
    }
    if (sub == 0 && i < n) st(c, __ldg(nu + c) * LOG2E - (m + lg2(s)));
  }
}

// The group path. A patch's rows are split over a group of G CTAs, band_rows
// each (the last may hold fewer), and each CTA keeps the first shared_rows
// rows of its band in shared memory for every iteration. SPILL (shared_rows
// < band_rows, K1 > 2640): the rest of the band is read from the scores in
// device memory in every half-step (SpilledRows). A persistent grid of
// `gridDim.x / G` groups walks the patches; all its CTAs are resident at once (a cooperative
// launch), so a CTA may wait on the others. Each iteration the CTAs write
// their column partials, meet at the group's barrier, CTA `rank` merges its
// slice of the columns into v and publishes it tagged, and every CTA reads
// all of v once its tags are this iteration's. One buffer of each is
// enough: a CTA writes its partials of the next iteration only after it
// has read all of this iteration's v, so after every merge of them, and a
// CTA publishes the next v only after the next barrier, so after every
// read of this one. scratch: per group, G x K1 column partials (max, sum)
// then K1 tagged v words, zero at the launch; counters: per group, one
// arrival counter every SKG_BAR_STRIDE words, zero at the launch.
template <bool SPILL>
__global__ void __launch_bounds__(SKG_THREADS, 1)
sinkhorn_group_kernel(const float* __restrict__ scores, const float* __restrict__ log_mu,
                      const float* __restrict__ log_nu, int P, int K1, int G, int band_rows,
                      int shared_rows, int iters, float* scratch, unsigned* counters,
                      float* __restrict__ out) {
  const int K1p = (K1 + 31) / 32 * 32, NG = K1p / 32;
  const int groups = gridDim.x / G, grp = blockIdx.x / G, rank = blockIdx.x % G;
  const int r0 = rank * band_rows;
  const int nb = max(0, min(band_rows, K1 - r0));  // rows of this CTA's band
  const int ns = SPILL ? min(nb, shared_rows) : nb;  // of them in shared memory
  extern __shared__ float4 smem4[];
  float* u_sh = reinterpret_cast<float*>(smem4);  // band_rows, 16-byte aligned
  float* mu_sh = u_sh + band_rows;
  float* v_sh = mu_sh + band_rows;  // K1p
  float* band_sh = v_sh + K1p;      // shared_rows x K1p
  const SharedRows band{band_sh, K1p};
  float2* part = reinterpret_cast<float2*>(scratch + (size_t)grp * 2 * ((size_t)G + 1) * K1);
  uint2* vt = reinterpret_cast<uint2*>(part + (size_t)G * K1);
  unsigned* counter = counters + (size_t)grp * SKG_BAR_STRIDE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned arrivals = 0;  // barriers this CTA has passed, in every patch so far
  unsigned step = 0;      // iterations run so far, in every patch (v's tag, less one)
  // merge: S lanes a column, the next power of two of ceil(G / SKG_MERGE), at most 32
  const int S = G <= SKG_MERGE ? 1 : min(32, 1 << (32 - __clz((G - 1) / SKG_MERGE)));
  const int slice = (K1 + G - 1) / G, c0 = rank * slice;  // the columns this CTA merges
  const int n_merge = max(0, min(slice, K1 - c0));

  for (int p = grp; p < P; p += groups) {
    const float* sp = scores + ((size_t)p * K1 + r0) * K1;
    const SpilledRows spill{sp, K1};
    for (int r = warp; r < (SPILL ? shared_rows : band_rows); r += SKG_WARPS)
      for (int c = lane; c < K1p; c += 32)
        band_sh[(size_t)r * K1p + c] =
            r < nb && c < K1 ? sp[(size_t)r * K1 + c] * LOG2E : -CUDART_INF_F;
    for (int t = tid; t < band_rows; t += SKG_THREADS) {
      mu_sh[t] = t < nb ? log_mu[(size_t)p * K1 + r0 + t] * LOG2E : 0.f;
      u_sh[t] = 0.f;  // iters = 0: the output is s
    }
    for (int c = tid; c < K1p; c += SKG_THREADS) v_sh[c] = 0.f;
    __syncthreads();

    for (int it = 0; it < iters; ++it, ++step) {
      // u: row LSE of s + v over the warp's rows, two at a time, then one
      // (SPILL: one at a time, the shared rows, then the spilled ones; the
      // fewer live registers leave room for the spilled rows' loads)
      if constexpr (!SPILL) {
        const int nr = warp < nb ? (nb - warp + SKG_WARPS - 1) / SKG_WARPS : 0;
        int i = 0;
        for (; i + 2 <= nr; i += 2)
          group_row_lse<2>(band, NG, warp + SKG_WARPS * i, v_sh, lane, mu_sh, u_sh);
        if (i < nr) group_row_lse<1>(band, NG, warp + SKG_WARPS * i, v_sh, lane, mu_sh, u_sh);
      } else {
        int r = warp;
        for (; r < ns; r += SKG_WARPS) group_row_lse<1>(band, NG, r, v_sh, lane, mu_sh, u_sh);
        for (; r < nb; r += SKG_WARPS) group_row_lse<1>(spill, NG, r, v_sh, lane, mu_sh, u_sh);
      }
      __syncthreads();

      // v: the CTA's column partials over its band, a warp per 32 columns
      // and lanes over them, the rows folded SKG_RR at a time into two
      // chains (alternate blocks), merged at the end
      for (int g = warp; g < NG; g += SKG_WARPS) {
        const int c = 32 * g + lane;
        float ma = -CUDART_INF_F, sa = 0.f, mb = -CUDART_INF_F, sb = 0.f;
        col_fold_rows<SPILL ? 4 : SKG_RR>(band, 0, ns, c, u_sh, ma, sa, mb, sb);
        if constexpr (SPILL) col_fold_rows<4>(spill, ns, nb, c, u_sh, ma, sa, mb, sb);
        const float m = fmaxf(ma, mb), base = m == -CUDART_INF_F ? 0.f : m;
        if (c < K1)
          __stcg(part + (size_t)rank * K1 + c,
                 make_float2(m, sa * ex2(ma - base) + sb * ex2(mb - base)));
      }

      // the exchange: CTA `rank` merges its slice of the columns into v and
      // publishes it tagged; every CTA reads all of v as its tags arrive
      group_barrier(counter, ++arrivals * G);
      merge_columns(part, log_nu + (size_t)p * K1, G, K1, S, c0, n_merge,
                    [vt, step](int c, float v) { store_tagged(vt + c, v, step + 1); });
      for (int c = tid; c < K1; c += SKG_THREADS) v_sh[c] = load_tagged(vt + c, step + 1);
      __syncthreads();
    }

    float* op = out + ((size_t)p * K1 + r0) * K1;
    for (int r = warp; r < nb; r += SKG_WARPS) {
      const float ur = u_sh[r];
      for (int c = lane; c < K1; c += 32)
        op[(size_t)r * K1 + c] = (((!SPILL || r < ns ? band(r, c) : spill(r, c)) + ur) + v_sh[c]) *
                                 LN2;
    }
    __syncthreads();  // the next patch overwrites the band, u and v
  }
}

typedef void (*GroupKernel)(const float*, const float*, const float*, int, int, int, int, int,
                            int, float*, unsigned*, float*);

// The launch configuration of one group-path call, G CTAs a patch of which
// each reads spill_rows rows of its band from device memory: the kernel, its
// band and shared rows, its shared memory and the CTAs the card holds at
// once. 0 or the error.
static int group_config(int K1, int G, int spill_rows, GroupKernel* kern, int* band_rows,
                        int* shared_rows, size_t* smem, int* resident) {
  if (K1 < 1 || G < 1 || spill_rows < 0) return (int)cudaErrorInvalidValue;
  *band_rows = (K1 + G - 1) / G;
  if (K1 - (G - 1) * *band_rows < 1) return (int)cudaErrorInvalidValue;  // an empty band
  *shared_rows = *band_rows - spill_rows;
  if (*shared_rows < 0) return (int)cudaErrorInvalidValue;
  *smem = group_smem_bytes(K1, *band_rows, *shared_rows);
  if (*smem > SKC_SMEM_MAX) return (int)cudaErrorInvalidValue;
  *kern = spill_rows ? sinkhorn_group_kernel<true> : sinkhorn_group_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(*kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)*smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, *kern, SKG_THREADS, *smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  *resident = per_sm * sms;
  return 0;
}

// How many CTAs of the group path at this K1, G and spill the current card
// holds at once (occupancy x SMs) into *ctas. Returns 0 or the error.
extern "C" int sinkhorn_group_resident(int K1, int G, int spill_rows, int* ctas) {
  GroupKernel kern;
  int band_rows, shared_rows;
  size_t smem;
  return group_config(K1, G, spill_rows, &kern, &band_rows, &shared_rows, &smem, ctas);
}

// The group path: scores (P, K1, K1), log_mu / log_nu (P, K1), out (P, K1,
// K1) float32 and contiguous; G CTAs a patch, the last spill_rows rows of
// each CTA's band read from the scores in every half-step, `groups` groups
// resident at once walking the patches; scratch groups x 2 (G + 1) K1 float32 and
// counters groups x SKG_BAR_STRIDE uint32, both zero and the kernel's alone.
// Returns SKG_NO_GROUP when the card cannot hold `groups` groups at once
// (nothing is launched: the caller raises, it never falls back), else the
// cooperative launch's error or cudaGetLastError() after it.
extern "C" int sinkhorn_group_launch(const float* scores, const float* log_mu,
                                     const float* log_nu, int P, int K1, int iters, int G,
                                     int spill_rows, int groups, float* scratch,
                                     unsigned* counters, float* out, void* stream) {
  if (iters < 0 || P < 0 || groups < 0) return (int)cudaErrorInvalidValue;
  GroupKernel kern;
  int band_rows, shared_rows, resident;
  size_t smem;
  int err = group_config(K1, G, spill_rows, &kern, &band_rows, &shared_rows, &smem, &resident);
  if (err != 0) return err;
  if (P == 0) return 0;
  if (groups < 1 || groups > P || (long long)groups * G > resident) return SKG_NO_GROUP;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(groups * G));
  cfg.blockDim = dim3(SKG_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, scores, log_mu, log_nu, P, K1, G, band_rows,
                                     shared_rows, iters, scratch, counters, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
