// Fused log-domain Sinkhorn for Hopper (sm_90a).
//
// Replaces: rdmnet_tpu/ops/pallas/sinkhorn.py, sinkhorn_pallas (Pallas TPU
// kernel _sinkhorn_kernel). Per patch p it runs num_iterations of
//   u = log_mu - LSE_j(s + v),   v = log_nu - LSE_i(s + u)
// with LSE(t) = max(t) + log(sum(exp(t - max(t)))), then writes s + u + v
// once. Masked entries carry -1e12 (not -inf), so fully masked rows and
// patches stay finite exactly as in the JAX version: every entry of such a
// row rounds to the same value, its LSE equals it, and u (or v) is 0.
//
// What bounds it: operations. At the main-path shape (P=256, K1=129, 100
// iterations) it evaluates 2*100*256*129^2 = 8.5e8 expf, ~0.2 ms at the
// SFU rate of 132 SMs x 16/clk; its 34 MB of input and output take ~10 us
// at 3.35 TB/s.
//
// Design: one CTA per patch. The whole K1 x K1 float32 block (66.6 KB at
// K1=129) and u, v live in dynamic shared memory for all iterations, so
// device memory is read once and written once. The row LSE takes one warp
// per row, the column LSE one warp per column, each with shuffle max and
// sum. The row stride K1=129 is odd, so the 32 lanes of a column walk hit
// 32 different banks. K1 need not be a power of two.

#include <cuda_runtime.h>
#include <math_constants.h>

#define SK_THREADS 256

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(SK_THREADS)
sinkhorn_kernel(const float* __restrict__ scores, const float* __restrict__ log_mu,
                const float* __restrict__ log_nu, int K1, int iters,
                float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s = smem;          // K1 * K1
  float* u = s + K1 * K1;   // K1
  float* v = u + K1;        // K1
  const int p = blockIdx.x;
  const size_t base = (size_t)p * K1 * K1;
  const int n = K1 * K1;
  for (int i = threadIdx.x; i < n; i += SK_THREADS) s[i] = scores[base + i];
  for (int i = threadIdx.x; i < K1; i += SK_THREADS) {
    u[i] = 0.f;
    v[i] = 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = SK_THREADS >> 5;
  const float* mu = log_mu + (size_t)p * K1;
  const float* nu = log_nu + (size_t)p * K1;

  for (int it = 0; it < iters; ++it) {
    for (int r = warp; r < K1; r += nw) {  // u: row LSE of s + v
      const float* row = s + r * K1;
      float m = -CUDART_INF_F;
      for (int j = lane; j < K1; j += 32) m = fmaxf(m, row[j] + v[j]);
      m = warp_max(m);
      float acc = 0.f;
      for (int j = lane; j < K1; j += 32) acc += expf((row[j] + v[j]) - m);
      acc = warp_sum(acc);
      if (lane == 0) u[r] = mu[r] - (m + logf(acc));
    }
    __syncthreads();
    for (int c = warp; c < K1; c += nw) {  // v: column LSE of s + u
      float m = -CUDART_INF_F;
      for (int i = lane; i < K1; i += 32) m = fmaxf(m, s[i * K1 + c] + u[i]);
      m = warp_max(m);
      float acc = 0.f;
      for (int i = lane; i < K1; i += 32) acc += expf((s[i * K1 + c] + u[i]) - m);
      acc = warp_sum(acc);
      if (lane == 0) v[c] = nu[c] - (m + logf(acc));
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < n; idx += SK_THREADS) {
    const int i = idx / K1;
    const int j = idx - i * K1;
    out[base + idx] = (s[idx] + u[i]) + v[j];
  }
}

// scores (P, K1, K1), log_mu / log_nu (P, K1), out (P, K1, K1), all float32
// and contiguous. Returns cudaGetLastError() after the launch.
extern "C" int sinkhorn_launch(const float* scores, const float* log_mu,
                               const float* log_nu, int P, int K1, int iters,
                               float* out, void* stream) {
  const size_t smem = (size_t)(K1 * K1 + 2 * K1) * sizeof(float);
  if (K1 < 1 || smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (P == 0) return 0;
  sinkhorn_kernel<<<P, SK_THREADS, smem, (cudaStream_t)stream>>>(
      scores, log_mu, log_nu, K1, iters, out);
  return (int)cudaGetLastError();
}
