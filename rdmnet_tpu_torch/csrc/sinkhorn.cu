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
// K1 > 208, the streaming path (sinkhorn_stream_launch): a patch no longer
// fits in the registers of a CTA (at K1 = 257 it is 264 KB, above the 227 KB
// of shared memory too), so one CTA of 512 threads per patch reads the patch
// from device memory in every half-step. Row half-step: a warp per row, each
// lane an online (max, exp-sum) over its columns, 8 loads in flight a step
// (rescaled once a step), then a 5-step shuffle merge. Column half-step:
// warp g takes rows g + 16 i and lane l column c0 + l, so each load of a
// warp is 32 consecutive floats of one row; each (warp, column) keeps an
// online partial, and after a barrier thread c merges column c's 16
// partials with the online-softmax rescale into v[c]. u, v and the
// partials live in a scratch buffer the wrapper allocates ((2 + 2 x 16) K1
// floats a patch), so K1 is bounded by device memory alone. Three barriers
// an iteration. What bounds this design: bytes, since every half-step
// reads the patch again: at P = 256, K1 = 257, 100 iterations, 200 x 67.6
// MB ~ 4.0 ms at 3.35 TB/s. The function itself stays bound by operations:
// its 3.38e9 exponentials take ~0.81 ms on the SFU (inputs and output once:
// ~0.04 ms).

#include <cuda_runtime.h>
#include <math_constants.h>

#define SK_THREADS 256
#define SK_GRID 16  // SK_GRID x SK_GRID threads
#define SK_MAX_K1 208  // the register path's largest patch; above it the streaming path
#define SK_STREAM_THREADS 512
#define SK_STREAM_WARPS (SK_STREAM_THREADS / 32)
#define SK_STREAM_CH 8  // loads in flight per lane and step
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

// ---- K1 > 208: the streaming path ----------------------------------------------------

// Fold a step's values x (their max cm) into an online (m, sum) in log2
// units: sum of 2^(x - m). Entries outside the patch hold -inf; a state that
// has seen nothing else stays (-inf, 0).
template <int N>
__device__ __forceinline__ void lse_fold(float& m, float& sum, const float (&x)[N], float cm) {
  const float mn = fmaxf(m, cm);
  if (mn == -CUDART_INF_F) return;
  float add = 0.f;
#pragma unroll
  for (int t = 0; t < N; ++t) add += ex2(x[t] - mn);
  sum = sum * ex2(m - mn) + add;  // 2^-inf = 0 while m is -inf
  m = mn;
}

// scratch: per patch u[K1], v[K1], then 16 x K1 partial maxima and sums
__global__ void __launch_bounds__(SK_STREAM_THREADS)
sinkhorn_stream_kernel(const float* __restrict__ scores, const float* __restrict__ log_mu,
                       const float* __restrict__ log_nu, int K1, int iters, float* scratch,
                       float* __restrict__ out) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p = blockIdx.x;
  const float* sp = scores + (size_t)p * K1 * K1;
  const float* mu = log_mu + (size_t)p * K1;
  const float* nu = log_nu + (size_t)p * K1;
  float* u = scratch + (size_t)p * K1 * (2 + 2 * SK_STREAM_WARPS);
  float* v = u + K1;
  float* part_m = v + K1;
  float* part_s = part_m + (size_t)SK_STREAM_WARPS * K1;

  for (int c = tid; c < K1; c += SK_STREAM_THREADS) u[c] = v[c] = 0.f;  // iters = 0: s
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    // u: a warp per row
    for (int r = warp; r < K1; r += SK_STREAM_WARPS) {
      const float* row = sp + (size_t)r * K1;
      float m = -CUDART_INF_F, sum = 0.f;
      for (int c0 = 0; c0 < K1; c0 += 32 * SK_STREAM_CH) {
        float x[SK_STREAM_CH], cm = -CUDART_INF_F;
#pragma unroll
        for (int t = 0; t < SK_STREAM_CH; ++t) {
          const int c = c0 + 32 * t + lane;
          x[t] = c < K1 ? __fmul_rn(row[c], LOG2E) + v[c] : -CUDART_INF_F;
          cm = fmaxf(cm, x[t]);
        }
        lse_fold(m, sum, x, cm);
      }
      float mx = m;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, o));
      float tot = m == -CUDART_INF_F ? 0.f : sum * ex2(m - mx);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) tot += __shfl_xor_sync(FULL_MASK, tot, o);
      if (lane == 0) u[r] = __fmul_rn(mu[r], LOG2E) - (mx + lg2(tot));
    }
    __syncthreads();

    // v: per-(warp, column) partials over rows warp + 16 i, then merged
    for (int c0 = 0; c0 < K1; c0 += 32) {
      const int c = c0 + lane;
      if (c >= K1) break;
      float m = -CUDART_INF_F, sum = 0.f;
      for (int r0 = warp; r0 < K1; r0 += SK_STREAM_WARPS * SK_STREAM_CH) {
        float x[SK_STREAM_CH], cm = -CUDART_INF_F;
#pragma unroll
        for (int t = 0; t < SK_STREAM_CH; ++t) {
          const int r = r0 + SK_STREAM_WARPS * t;
          x[t] = r < K1 ? __fmul_rn(sp[(size_t)r * K1 + c], LOG2E) + u[r] : -CUDART_INF_F;
          cm = fmaxf(cm, x[t]);
        }
        lse_fold(m, sum, x, cm);
      }
      part_m[(size_t)warp * K1 + c] = m;
      part_s[(size_t)warp * K1 + c] = sum;
    }
    __syncthreads();
    for (int c = tid; c < K1; c += SK_STREAM_THREADS) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int g = 0; g < SK_STREAM_WARPS; ++g) mx = fmaxf(mx, part_m[(size_t)g * K1 + c]);
      float tot = 0.f;
#pragma unroll
      for (int g = 0; g < SK_STREAM_WARPS; ++g) {
        const float pm = part_m[(size_t)g * K1 + c];
        if (pm != -CUDART_INF_F) tot += part_s[(size_t)g * K1 + c] * ex2(pm - mx);
      }
      v[c] = __fmul_rn(nu[c], LOG2E) - (mx + lg2(tot));
    }
    __syncthreads();
  }

  float* op = out + (size_t)p * K1 * K1;
  for (int r = warp; r < K1; r += SK_STREAM_WARPS) {
    const float ur = u[r];
    for (int c = lane; c < K1; c += 32)
      op[(size_t)r * K1 + c] = ((__fmul_rn(sp[(size_t)r * K1 + c], LOG2E) + ur) + v[c]) * LN2;
  }
}

// The streaming path, for any K1 >= 1 (the wrapper takes it for K1 > 208):
// scores (P, K1, K1), log_mu / log_nu (P, K1), out (P, K1, K1) float32 and
// contiguous; scratch P x (2 + 2 x 16) x K1 float32, written and read by the
// kernel only. Returns cudaGetLastError() after the launch.
extern "C" int sinkhorn_stream_launch(const float* scores, const float* log_mu,
                                      const float* log_nu, int P, int K1, int iters,
                                      float* scratch, float* out, void* stream) {
  if (K1 < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  sinkhorn_stream_kernel<<<P, SK_STREAM_THREADS, 0, (cudaStream_t)stream>>>(
      scores, log_mu, log_nu, K1, iters, scratch, out);
  return (int)cudaGetLastError();
}
