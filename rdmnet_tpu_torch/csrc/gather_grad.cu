// Gradient of the sentinel gathers (ops/geometry.py, take_padded) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package gathers with
// jnp.take(x, idx, axis=0, mode="fill") (rdmnet_tpu/ops/geometry.py:44-56),
// whose gradient XLA computes as a scatter-add without Pallas. The port's
// forward is an embedding lookup with one appended fill row; PyTorch's
// embedding backward sorts every index, sentinels included, and sums each
// index's run serially, the sentinel's too, only to drop it at the write. In
// the train step's tables the sentinel's run is the longest by far (padded
// query rows and missing neighbours: 40-80% of a table), so that serial sum
// took most of the backward.
//
// What it computes: for every source row n < N, the sum over the positions p
// with idx[p] == n, in increasing p, of grad[p, :], added in float32 from +0
// with round-to-nearest adds (__fadd_rn, never fused) and written once in
// grad's dtype (float32, or bfloat16 rounded once to nearest even). A
// position whose index is >= N (or negative) is a sentinel and is never read.
// A row nothing references is written as 0. No atomics touch the values, so
// the result is bit-identical from run to run and equals the plain version's
// (ops/kernels/gather_grad.py: index_add_ in position order from zeros).
//
// What bounds it: bytes. The non-sentinel gradient rows are read once and
// each source row is written once; the indices (4 bytes an entry, C times
// fewer than the gradient's) are read once and sorted with their positions.
//
// Design, all sizes static so that it captures into a CUDA graph:
// (1) keys: each position's key is its index, sentinels clamped to N;
// (2) a stable radix sort of (key, position) over the key's bits (CUB): each
//     row's positions come out contiguous and in increasing order, for any
//     number of references a row has;
// (3) offsets: row r's run starts at the first key >= r (a binary search a
//     row), so the sentinel's run, keyed N, is never visited;
// (4) sums: G = 2^g lanes a row (the fewest whose GG_SPAN vectors cover the
//     row, at most a warp; several rows a warp when C is small), each lane
//     16-byte loads where C allows, GG_UNROLL positions' rows in flight
//     before their adds, which run in position order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cub/device/device_radix_sort.cuh>

#include <cstring>

#define GG_THREADS 256
#define GG_UNROLL 4  // positions whose rows are loaded before their adds
#define GG_SPAN 2    // vectors a lane sums in one pass over a row's positions

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float v, float* o) { *o = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* o) { *o = __float2bfloat16_rn(v); }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename V>
__device__ __forceinline__ V load(const V* p) {
  V v;
  if constexpr (sizeof(V) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&v, &u, 16);
  } else {
    v = *p;
  }
  return v;
}

__global__ void gather_grad_keys_kernel(const int* __restrict__ idx, int P, unsigned N,
                                        unsigned* __restrict__ keys, int* __restrict__ pos) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const unsigned k = (unsigned)idx[i];
  keys[i] = k < N ? k : N;
  pos[i] = i;
}

__global__ void gather_grad_offsets_kernel(const unsigned* __restrict__ keys, int P, int N,
                                           int* __restrict__ offsets) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r > N) return;
  int lo = 0, hi = P;  // the first i with keys[i] >= r
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < (unsigned)r) lo = mid + 1;
    else hi = mid;
  }
  offsets[r] = lo;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(GG_THREADS)
gather_grad_sum_kernel(const T* __restrict__ grad, const int* __restrict__ pos,
                       const int* __restrict__ offsets, int N, int C, int lanes_log2,
                       T* __restrict__ out) {
  typedef Pack<T, VEC> V;
  const long long t = (long long)blockIdx.x * GG_THREADS + threadIdx.x;
  const long long row = t >> lanes_log2;
  if (row >= N) return;
  const int G = 1 << lanes_log2;
  const int lane = (int)(t & (G - 1));
  const int beg = offsets[row], end = offsets[row + 1];
  const int nvec = C / VEC;
  const V* g = reinterpret_cast<const V*>(grad);
  V* o = reinterpret_cast<V*>(out) + row * nvec;
  for (int v0 = lane; v0 < nvec; v0 += G * GG_SPAN) {
    float acc[GG_SPAN][VEC];
#pragma unroll
    for (int s = 0; s < GG_SPAN; ++s)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[s][e] = 0.0f;
    int j = beg;
    for (; j + GG_UNROLL <= end; j += GG_UNROLL) {
      V r[GG_UNROLL][GG_SPAN];
#pragma unroll
      for (int k = 0; k < GG_UNROLL; ++k) {
        const size_t base = (size_t)__ldg(pos + j + k) * nvec;
#pragma unroll
        for (int s = 0; s < GG_SPAN; ++s)
          if (v0 + s * G < nvec) r[k][s] = load(g + base + v0 + s * G);
      }
#pragma unroll
      for (int k = 0; k < GG_UNROLL; ++k)
#pragma unroll
        for (int s = 0; s < GG_SPAN; ++s)
          if (v0 + s * G < nvec)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[s][e] = __fadd_rn(acc[s][e], widen(r[k][s].v[e]));
    }
    for (; j < end; ++j) {
      const size_t base = (size_t)__ldg(pos + j) * nvec;
#pragma unroll
      for (int s = 0; s < GG_SPAN; ++s)
        if (v0 + s * G < nvec) {
          const V r = load(g + base + v0 + s * G);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[s][e] = __fadd_rn(acc[s][e], widen(r.v[e]));
        }
    }
#pragma unroll
    for (int s = 0; s < GG_SPAN; ++s)
      if (v0 + s * G < nvec) {
        V w;
#pragma unroll
        for (int e = 0; e < VEC; ++e) narrow(acc[s][e], &w.v[e]);
        o[v0 + s * G] = w;
      }
  }
}

template <typename T, int VEC>
cudaError_t launch_sum(const void* grad, const int* pos, const int* offsets, int N, int C,
                       T* out, cudaStream_t stream) {
  const int nvec = C / VEC;
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (GG_SPAN << lanes_log2) < nvec) ++lanes_log2;
  const long long threads = (long long)N << lanes_log2;
  const long long blocks = (threads + GG_THREADS - 1) / GG_THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gather_grad_sum_kernel<T, VEC><<<(unsigned)blocks, GG_THREADS, 0, stream>>>(
      static_cast<const T*>(grad), pos, offsets, N, C, lanes_log2, out);
  return cudaGetLastError();
}

size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

}  // namespace

// grad (P, C) float32 (dtype 0) or bfloat16 (dtype 1); idx (P,) int32; out
// (N, C) of grad's dtype; all contiguous on the stream's card. vec 1 takes
// 16-byte loads (C a multiple of 16 / element bytes, grad 16-byte aligned),
// vec 0 one element a load. workspace NULL: sets *workspace_bytes to the
// bytes the call needs and launches nothing. Returns the first cudaError_t
// of the launches (0 when all were queued).
extern "C" int gather_grad_launch(const void* grad, const int* idx, int P, int N, int C,
                                  int dtype, int vec, void* out, void* workspace,
                                  size_t* workspace_bytes, void* stream) {
  if (P < 0 || N < 0 || C < 1 || (dtype != 0 && dtype != 1) || workspace_bytes == nullptr)
    return (int)cudaErrorInvalidValue;
  const int per = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  if (vec && C % per != 0) return (int)cudaErrorInvalidValue;
  int bits = 1;  // key bits: N itself (the sentinel's key) must fit
  while (bits < 32 && ((unsigned)N >> bits) != 0) ++bits;
  cub::DoubleBuffer<unsigned> keys(nullptr, nullptr);
  cub::DoubleBuffer<int> pos(nullptr, nullptr);
  size_t sort_bytes = 0;
  if (P > 0) {
    cudaError_t err = cub::DeviceRadixSort::SortPairs(nullptr, sort_bytes, keys, pos, P, 0, bits);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t list = align256((size_t)P * 4);
  const size_t need = 4 * list + align256(((size_t)N + 1) * 4) + align256(sort_bytes);
  if (workspace == nullptr) {
    *workspace_bytes = need;
    return 0;
  }
  if (*workspace_bytes < need) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  char* w = static_cast<char*>(workspace);
  keys = cub::DoubleBuffer<unsigned>(reinterpret_cast<unsigned*>(w),
                                     reinterpret_cast<unsigned*>(w + list));
  pos = cub::DoubleBuffer<int>(reinterpret_cast<int*>(w + 2 * list),
                               reinterpret_cast<int*>(w + 3 * list));
  int* offsets = reinterpret_cast<int*>(w + 4 * list);
  void* sort_temp = w + 4 * list + align256(((size_t)N + 1) * 4);
  if (P > 0) {
    gather_grad_keys_kernel<<<(P + GG_THREADS - 1) / GG_THREADS, GG_THREADS, 0, s>>>(
        idx, P, (unsigned)N, keys.Current(), pos.Current());
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cub::DeviceRadixSort::SortPairs(sort_temp, sort_bytes, keys, pos, P, 0, bits, s);
    if (err != cudaSuccess) return (int)err;
  }
  gather_grad_offsets_kernel<<<(N + GG_THREADS) / GG_THREADS, GG_THREADS, 0, s>>>(
      keys.Current(), P, N, offsets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int* sorted = pos.Current();
  if (dtype == 0) {
    float* o = static_cast<float*>(out);
    err = vec ? launch_sum<float, 4>(grad, sorted, offsets, N, C, o, s)
              : launch_sum<float, 1>(grad, sorted, offsets, N, C, o, s);
  } else {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    err = vec ? launch_sum<__nv_bfloat16, 8>(grad, sorted, offsets, N, C, o, s)
              : launch_sum<__nv_bfloat16, 1>(grad, sorted, offsets, N, C, o, s);
  }
  return (int)err;
}
