// Exact radius-bounded k-nearest-neighbour search for Hopper (sm_90a).
//
// Replaces: rdmnet_tpu/ops/pallas/radius_knn.py, radius_knn_pallas (Pallas
// TPU kernel), and serves every radius search of the graph build
// (rdmnet_tpu/ops/radius_search.py radius_knn / radius_knn_banded).
//
// Semantics: for each query, the K support rows j in the query's window
// with j < s_count and squared distance d <= r^2, in ascending (d, j)
// order, padded with the sentinel S. d is max(|q|^2 - 2 q.s + |s|^2, 0) in
// float32 with each 3-deep dot product rounded as a chain of fused
// multiply-adds, bit for bit the rounding of the port's plain version
// (rdmnet_tpu_torch/ops/geometry.py dot3) and of the JAX package on the CPU.
//
// What bounds it: operations. Every (query, candidate) pair costs ~8 float32
// operations (3 FMA, mul, sub, add, max, compare); inputs and outputs are a
// few MB. The graph build of one pair at the 0.7 bucket evaluates ~4.3e8
// pairs. The top-K merge is data dependent but rare: a candidate enters only
// if it is inside the radius and beats the current K-th.
//
// Design: one thread per query, blocks of 128 (or 64) queries. Support rows
// of the query block's window are streamed through shared memory as
// float4 (x, y, z, |s|^2) tiles that every thread reads as a broadcast.
// Each thread keeps its sorted top-K (distance, index) list in local memory
// and inserts by shifting; candidates arrive in increasing index order, so a
// strict comparison gives the lower index on equal distances (the tie order
// of lax.top_k). The TPU kernel's K-step argmax peeling over every block is
// not carried over. Banded searches pass one window start per query chunk
// (chunk a multiple of the block's query count); blockIdx.y is the cloud of
// the (ref, src) pair, so one launch serves one search of a pair.

#include <cuda_runtime.h>
#include <math_constants.h>

#define KNN_KMAX 128
#define KNN_TILE 256

template <int TQ>
__global__ void __launch_bounds__(TQ)
radius_knn_kernel(const float* __restrict__ q, const float* __restrict__ s,
                  const int* __restrict__ s_count, const int* __restrict__ win,
                  int Q, int S, int K, float r2, int chunk, int band,
                  int n_chunks, int* __restrict__ out) {
  __shared__ float4 tile[KNN_TILE];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int qi = q0 + threadIdx.x;
  const bool active = qi < Q;

  int w = 0, len = S;
  if (win != nullptr) {
    w = win[b * n_chunks + q0 / chunk];
    len = band;
  }
  const int end = min(w + len, s_count[b]);  // rows >= s_count are invalid

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = q + ((size_t)b * Q + qi) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  const float qsq = __fmaf_rn(qz, qz, __fmaf_rn(qy, qy, __fmul_rn(qx, qx)));

  float bd[KNN_KMAX];
  int bi[KNN_KMAX];
  for (int j = 0; j < K; ++j) {
    bd[j] = CUDART_INF_F;
    bi[j] = S;
  }
  float worst = CUDART_INF_F;

  const float* sb = s + (size_t)b * S * 3;
  for (int t0 = w; t0 < end; t0 += KNN_TILE) {
    const int n = min(KNN_TILE, end - t0);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += TQ) {
      const float* sp = sb + (size_t)(t0 + t) * 3;
      const float x = sp[0], y = sp[1], z = sp[2];
      tile[t] = make_float4(x, y, z,
                            __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x))));
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < n; ++t) {
      const float4 p = tile[t];
      const float xy = __fmaf_rn(qz, p.z, __fmaf_rn(qy, p.y, __fmul_rn(qx, p.x)));
      float d = __fadd_rn(__fsub_rn(qsq, __fmul_rn(2.f, xy)), p.w);
      d = fmaxf(d, 0.f);
      if (d <= r2 && d < worst) {
        int j = K - 1;
        while (j > 0 && bd[j - 1] > d) {
          bd[j] = bd[j - 1];
          bi[j] = bi[j - 1];
          --j;
        }
        bd[j] = d;
        bi[j] = t0 + t;
        worst = bd[K - 1];
      }
    }
  }
  if (active) {
    int* op = out + ((size_t)b * Q + qi) * K;
    for (int j = 0; j < K; ++j) op[j] = bd[j] < CUDART_INF_F ? bi[j] : S;
  }
}

// q (B, Q, 3), s (B, S, 3) float32; s_count (B,) int32; win (B, n_chunks)
// int32 window starts or NULL (then every query sees rows [0, S)); out
// (B, Q, K) int32. Returns cudaGetLastError() after the launch.
extern "C" int radius_knn_launch(const float* q, const float* s,
                                 const int* s_count, const int* win, int B,
                                 int Q, int S, int K, float r2, int chunk,
                                 int band, int n_chunks, int* out,
                                 void* stream) {
  if (K < 1 || K > KNN_KMAX) return (int)cudaErrorInvalidValue;
  if (win != nullptr && (chunk <= 0 || chunk % 64 != 0 || band <= 0))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Q == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (win != nullptr && chunk % 128 != 0) {
    dim3 grid((Q + 63) / 64, B);
    radius_knn_kernel<64><<<grid, 64, 0, st>>>(q, s, s_count, win, Q, S, K, r2,
                                               chunk, band, n_chunks, out);
  } else {
    dim3 grid((Q + 127) / 128, B);
    radius_knn_kernel<128><<<grid, 128, 0, st>>>(q, s, s_count, win, Q, S, K,
                                                 r2, chunk, band, n_chunks, out);
  }
  return (int)cudaGetLastError();
}
