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
// What bounds it: operations. Every (query, candidate) pair costs ~9 float32
// operations (3 FMA, mul, sub, add, max); inputs and outputs are a few MB.
// The graph build of one pair at the 0.7 bucket evaluates ~4.3e8 pairs. The
// top-K merge is data dependent: a candidate enters only if it is inside
// the radius and beats the current K-th.
//
// Design: one warp per query. The queries of a block lie in one query chunk
// and so share one support window, which the block stages in shared memory
// as float4 (x, y, z, |s|^2) rows; lanes read consecutive rows, so the
// reads are conflict-free. Each step the 32 lanes evaluate 32 consecutive
// candidates; a ballot picks those inside the radius that beat the K-th,
// and they are inserted one by one in lane order, which is index order.
// The sorted list lives in registers spread over the warp (position
// p = lane * SL + slot, SL = KB / 32 slots a lane, KB the list length
// bucket 32, 64, 128 or 256), so an insertion is the same few instructions on
// every lane: one compare and one select per slot and one __shfl_up_sync to
// carry the last slot of the lane below. Candidates arrive in increasing
// index order, so every index in the list is below the newcomer's and
// comparing distances gives the (d, j) order: an equal distance stays
// behind the earlier index, the tie order of a stable sort and of
// lax.top_k. K = 1 keeps a per-lane best and ends with a (d, j) argmin over
// the warp. A window larger than one tile is swept tile by tile with the
// lists held in registers across tiles; which path runs, the block size and
// the list bucket are chosen per search by the wrapper
// (rdmnet_tpu_torch/ops/kernels/radius_knn.py knn_plan). blockIdx.y is the
// cloud of the (ref, src) pair, so one launch serves one search of a pair.

#include <cuda_runtime.h>
#include <math_constants.h>

#define KNN_KMAX 256
#define KNN_MAX_WARPS 16
#define KNN_SMEM_MAX 232448
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ float knn_dist(float qx, float qy, float qz, float qsq, float4 p) {
  const float xy = __fmaf_rn(qz, p.z, __fmaf_rn(qy, p.y, __fmul_rn(qx, p.x)));
  return fmaxf(__fadd_rn(__fsub_rn(qsq, __fmul_rn(2.f, xy)), p.w), 0.f);
}

// A sorted (distance, index) list of 32 * SL entries spread over a warp:
// entry p lives in lane p / SL, slot p % SL.
template <int SL>
struct WarpList {
  float d[SL];
  int j[SL];

  __device__ __forceinline__ void init(int sentinel) {
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      d[s] = CUDART_INF_F;
      j[s] = sentinel;
    }
  }

  // Insert (nd, nj); nj exceeds every index already in the list.
  __device__ __forceinline__ void insert(float nd, int nj, int lane) {
    float pd = __shfl_up_sync(FULL_MASK, d[SL - 1], 1);
    int pj = __shfl_up_sync(FULL_MASK, j[SL - 1], 1);
    bool pkeep = lane == 0 || pd <= nd;  // the entry before this slot stays
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      const float od = d[s];
      const int oj = j[s];
      const bool keep = od <= nd;
      if (!keep) {
        d[s] = pkeep ? nd : pd;
        j[s] = pkeep ? nj : pj;
      }
      pkeep = keep;
      pd = od;
      pj = oj;
    }
  }

  // Distance of entry k_lane * SL + k_slot, on every lane.
  __device__ __forceinline__ float at(int k_lane, int k_slot) const {
    float w = d[0];
#pragma unroll
    for (int s = 1; s < SL; ++s) w = s == k_slot ? d[s] : w;
    return __shfl_sync(FULL_MASK, w, k_lane);
  }
};

// Offer one step of 32 candidates (lane i holds row row0 + i, distance d,
// inside the radius and the window when ok) to the list.
template <int SL>
__device__ __forceinline__ void offer(WarpList<SL>& list, float& worst, float d, bool ok,
                                      int row0, int lane, int k_lane, int k_slot) {
  unsigned m = __ballot_sync(FULL_MASK, ok && d < worst);
  while (m) {
    const int src = __ffs(m) - 1;
    list.insert(__shfl_sync(FULL_MASK, d, src), row0 + src, lane);
    worst = list.at(k_lane, k_slot);
    m = __ballot_sync(FULL_MASK, ok && d < worst) & ~((2u << src) - 1u);
  }
}

// SL = 0: K = 1, a best (d, j) per lane. Otherwise the list of 32 * SL.
template <int SL>
__global__ void __launch_bounds__(KNN_MAX_WARPS * 32, 2)
radius_knn_kernel(const float* __restrict__ q, const float* __restrict__ s,
                  const int* __restrict__ s_count, const int* __restrict__ win,
                  int Q, int S, int K, float r2, int chunk, int band, int n_chunks,
                  int tile_rows, int* __restrict__ out) {
  extern __shared__ float4 tile[];
  const int b = blockIdx.y;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * warps;  // the block's queries lie in one chunk
  const int qi = q0 + warp;
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

  constexpr int SLOTS = SL > 0 ? SL : 1;
  WarpList<SLOTS> list;
  list.init(S);
  float worst = CUDART_INF_F;
  const int k_lane = (K - 1) / SLOTS, k_slot = (K - 1) % SLOTS;
  float best = CUDART_INF_F;  // SL = 0
  int best_j = S;

  const float* sb = s + (size_t)b * S * 3;
  for (int t0 = w; t0 < end; t0 += tile_rows) {
    const int n = min(tile_rows, end - t0);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const float* sp = sb + (size_t)(t0 + t) * 3;
      const float x = sp[0], y = sp[1], z = sp[2];
      tile[t] = make_float4(x, y, z, __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x))));
    }
    __syncthreads();
    if (!active) continue;
    for (int base = 0; base < n; base += 64) {
      // two steps at once: their loads and distance chains overlap
      const int i0 = base + lane, i1 = i0 + 32;
      const float d0 = knn_dist(qx, qy, qz, qsq, tile[min(i0, n - 1)]);
      const float d1 = knn_dist(qx, qy, qz, qsq, tile[min(i1, n - 1)]);
      const bool ok0 = i0 < n && d0 <= r2, ok1 = i1 < n && d1 <= r2;
      if constexpr (SL == 0) {
        if (ok0 && d0 < best) {
          best = d0;
          best_j = t0 + i0;
        }
        if (ok1 && d1 < best) {
          best = d1;
          best_j = t0 + i1;
        }
      } else {
        offer(list, worst, d0, ok0, t0 + base, lane, k_lane, k_slot);
        offer(list, worst, d1, ok1, t0 + base + 32, lane, k_lane, k_slot);
      }
    }
  }
  if (!active) return;
  int* op = out + ((size_t)b * Q + qi) * K;
  if constexpr (SL == 0) {
    for (int o = 16; o > 0; o >>= 1) {  // (d, j) argmin over the lanes
      const float od = __shfl_xor_sync(FULL_MASK, best, o);
      const int oj = __shfl_xor_sync(FULL_MASK, best_j, o);
      if (od < best || (od == best && oj < best_j)) {
        best = od;
        best_j = oj;
      }
    }
    if (lane == 0) op[0] = best_j;
  } else {
#pragma unroll
    for (int sl = 0; sl < SL; ++sl) {
      const int p = lane * SL + sl;
      if (p < K) op[p] = list.j[sl];  // empty entries hold the sentinel S
    }
  }
}

template <int SL>
static int launch(const float* q, const float* s, const int* s_count, const int* win, int B,
                  int Q, int S, int K, float r2, int chunk, int band, int n_chunks, int warps,
                  int tile_rows, int* out, cudaStream_t st) {
  const int smem = tile_rows * (int)sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(radius_knn_kernel<SL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Q + warps - 1) / warps, B);
  radius_knn_kernel<SL><<<grid, warps * 32, smem, st>>>(q, s, s_count, win, Q, S, K, r2, chunk,
                                                        band, n_chunks, tile_rows, out);
  return (int)cudaGetLastError();
}

// q (B, Q, 3), s (B, S, 3) float32; s_count (B,) int32; win (B, n_chunks)
// int32 window starts or NULL (then every query sees rows [0, S)); out
// (B, Q, K) int32. The launch plan: `warps` queries per block (a divisor of
// chunk), the list bucket `kb` (1 for K = 1, else 32, 64, 128 or 256, >= K) and
// `tile_rows` support rows staged in shared memory at once. Returns
// cudaGetLastError() after the launch.
extern "C" int radius_knn_launch(const float* q, const float* s, const int* s_count,
                                 const int* win, int B, int Q, int S, int K, float r2,
                                 int chunk, int band, int n_chunks, int warps, int kb,
                                 int tile_rows, int* out, void* stream) {
  if (K < 1 || K > KNN_KMAX || K > kb || (kb == 1) != (K == 1)) return (int)cudaErrorInvalidValue;
  if (warps < 1 || warps > KNN_MAX_WARPS || tile_rows < 1 ||
      (size_t)tile_rows * sizeof(float4) > KNN_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (win != nullptr && (chunk <= 0 || chunk % 64 != 0 || chunk % warps != 0 || band <= 0))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Q == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kb) {
    case 1:
      return launch<0>(q, s, s_count, win, B, Q, S, K, r2, chunk, band, n_chunks, warps,
                       tile_rows, out, st);
    case 32:
      return launch<1>(q, s, s_count, win, B, Q, S, K, r2, chunk, band, n_chunks, warps,
                       tile_rows, out, st);
    case 64:
      return launch<2>(q, s, s_count, win, B, Q, S, K, r2, chunk, band, n_chunks, warps,
                       tile_rows, out, st);
    case 128:
      return launch<4>(q, s, s_count, win, B, Q, S, K, r2, chunk, band, n_chunks, warps,
                       tile_rows, out, st);
    case 256:
      return launch<8>(q, s, s_count, win, B, Q, S, K, r2, chunk, band, n_chunks, warps,
                       tile_rows, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
