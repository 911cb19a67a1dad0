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
//
// K > 256, the select paths: a list that long no longer fits in a warp's
// registers, so each query's K nearest are selected rather than kept sorted
// while the window streams by. Below a K the wrapper's plan states
// (rdmnet_tpu_torch/ops/kernels/radius_knn.py BLOCK_K_MIN), the warp select
// path (radius_knn_select_launch): a warp per query and a sort buffer of SR
// = next_pow2(K) keys a warp, so the whole output fits in it. Most of a
// query's window lies outside its radius (at the phase-16 level-0 search,
// ~32 of 5120 rows inside), and the rows are sorted by the x-major voxel
// key, so 32 consecutive rows span a small box: the block keeps each
// 32-row chunk's bounding box in shared memory, not the rows, and a query's
// sweep evaluates only the chunks its radius can reach, reading their rows
// from L1/L2. Two blocks share an SM. One counting sweep fills the buffer;
// when the in-radius rows overflow it, a radix select from the highest
// distance bit they do not share stops at the first digit whose rows fit
// the buffer, and one more sweep collects them (radius_knn_select_kernel
// below). From BLOCK_K_MIN, the block select path
// (radius_knn_block_launch): there a CTA
// of 16 warps takes one query, computes each distance once, keeps the
// in-radius keys in shared memory, selects there with all its threads and
// sorts with a block radix sort (fewer than 257 keys: one warp, in
// registers), and two CTAs share an SM (radius_knn_block_kernel below).

#include <cuda_runtime.h>
#include <math_constants.h>

#define KNN_KMAX 256  // the register list's longest bucket; above it the select path
#define KNN_MAX_WARPS 16
#define KNN_SMEM_MAX 232448
#define KNN_SELECT_BINS 256
#define SEL_CHUNKS 2  // warp select path: 32-row chunks whose rows a warp loads together
#define KNB_THREADS 512           // block select path: a CTA of 16 warps a query
#define KNB_CACHE_KEYS_MAX 8192   // in-radius keys a CTA keeps (64 KB)
#define KNB_SORT_ROWS_MAX 4096    // keys a CTA sorts at once (32 KB)
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

// ---- K > 256: the select paths ---------------------------------------------------------

// The order of a candidate: its squared distance's bits (d >= 0, so the bits
// order as the floats do; -0 folds onto +0), then its index.
__device__ __forceinline__ unsigned dist_bits(float d) { return __float_as_uint(d) & 0x7fffffffu; }

__device__ __forceinline__ unsigned long long knn_key(unsigned bits, int j) {
  return ((unsigned long long)bits << 32) | (unsigned)j;
}

// Compare-exchange of a bitonic network: x (the lower index) keeps the
// smaller key when up.
__device__ __forceinline__ void cmp_swap(unsigned long long& x, unsigned long long& y, bool up) {
  const unsigned long long lo = x < y ? x : y, hi = x < y ? y : x;
  x = up ? lo : hi;
  y = up ? hi : lo;
}

// Sort a[0, n) ascending in place, n <= 32 * R, by one warp in registers:
// v[j] holds element j * 32 + lane (padded with the largest key), and a
// bitonic network's stages of stride 32 or more swap two registers of a
// lane, the smaller ones exchange across lanes by shuffles.
template <int R>
__device__ void warp_register_sort(unsigned long long* a, int n, int lane) {
  unsigned long long v[R];
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = j * 32 + lane < n ? a[j * 32 + lane] : ~0ull;
  for (int size = 2; size <= 32 * R; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {  // registers j and j + stride / 32 of this lane
#pragma unroll
        for (int j = 0; j < R; ++j) {
#pragma unroll
          for (int t = 1; t < R; t <<= 1) {
            if (t == stride >> 5 && !(j & t)) cmp_swap(v[j], v[j | t], ((j * 32) & size) == 0);
          }
        }
      } else {  // lane ^ stride, the same register
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const unsigned long long p = __shfl_xor_sync(FULL_MASK, v[j], stride);
          const bool up = ((j * 32 + lane) & size) == 0;
          const bool take_min = ((lane & stride) == 0) == up;
          v[j] = take_min ? (v[j] < p ? v[j] : p) : (v[j] < p ? p : v[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (j * 32 + lane < n) a[j * 32 + lane] = v[j];
}

// Sort a[0, cnt) ascending in place, the warp's lanes together; a holds at
// least next_pow2(cnt) entries (the tail is padded with the largest key).
__device__ void warp_bitonic_sort(unsigned long long* a, int cnt, int lane) {
  int n = 1;
  while (n < cnt) n <<= 1;
  for (int i = cnt + lane; i < n; i += 32) a[i] = ~0ull;
  __syncwarp();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < (n >> 1); i += 32) {
        const int lo = 2 * i - (i & (stride - 1));
        const bool up = (lo & size) == 0;
        const unsigned long long x = a[lo], y = a[lo + stride];
        if ((x > y) == up) {
          a[lo] = y;
          a[lo + stride] = x;
        }
      }
      __syncwarp();
    }
  }
}

// Sort a[0, n) (n <= sort buffer), the warp's lanes together: in registers
// to 256 keys, else a bitonic network in shared memory.
__device__ void warp_sort(unsigned long long* a, int n, int lane) {
  if (n <= 32)
    warp_register_sort<1>(a, n, lane);
  else if (n <= 64)
    warp_register_sort<2>(a, n, lane);
  else if (n <= 128)
    warp_register_sort<4>(a, n, lane);
  else if (n <= 256)
    warp_register_sort<8>(a, n, lane);
  else
    warp_bitonic_sort(a, n, lane);
  __syncwarp();
}

// A float's bits as an unsigned that orders as the floats do, and back.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float(k ^ ((unsigned)((int)~k >> 31) | 0x80000000u));
}

// The warp select path: a warp per query, its whole output in a sort buffer
// of SR = next_pow2(K) keys of (distance bits << 32 | index). The block
// cuts the window's rows into chunks of 32 consecutive rows and keeps
// each chunk's bounding box in shared memory (two float4: the coordinates'
// minima and the largest |s|^2, the maxima), box_rows rows at a time; the
// rows themselves stay in device memory (L2 / L1). Rows are sorted by the
// x-major voxel key, so a chunk is a small box, and a query's sweep tests a
// chunk a lane (one ballot per 32 chunks) and evaluates only the rows of
// the chunks its radius can reach. A box is skipped only when its distance
// to the query exceeds r^2 by more than 2^-17 (|q|^2 + max |s|^2 + r^2),
// over ten times the rounding error of the kernel's distance (at most
// 10 u (|q|^2 + |s|^2), u = 2^-24), so no row the exact distance would keep
// is skipped. A first sweep counts the query's in-radius rows, keeps the
// first SR of them in the buffer and ANDs / ORs their distance bits. When
// they fit (the common case), the buffer is sorted (registers up to 256
// keys) and the first K written. Otherwise a radix select from the highest
// distance bit the rows do not share, 8 bits a sweep into a 256-bin
// histogram (warp-aggregated increments, __match_any_sync) laid over the
// buffer, stops at the first digit whose keys and those below it fit in the
// buffer: one more sweep collects them, and the sort gives the K nearest.
// Keys at one distance that cannot be split further are counted off in
// index order, the sweep's order. A key's low word is the index, so ties
// come out in index order. A window past box_rows rows is swept box tile by
// box tile by the whole block (barriers); else the block meets once, after
// the boxes, and each warp runs on its own.
__global__ void __launch_bounds__(KNN_MAX_WARPS * 32, 2)
radius_knn_select_kernel(const float* __restrict__ q, const float* __restrict__ s,
                         const int* __restrict__ s_count, const int* __restrict__ win, int Q,
                         int S, int K, float r2, int chunk, int band, int n_chunks,
                         int box_rows, int sort_rows, int* __restrict__ out) {
  extern __shared__ float4 boxes[];  // box_rows / 32 chunks x (lo, hi), then the warps' buffers
  const int b = blockIdx.y;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  unsigned long long* const buf =
      reinterpret_cast<unsigned long long*>(boxes + box_rows / 16) + (size_t)warp * sort_rows;
  unsigned* const hist = reinterpret_cast<unsigned*>(buf);  // radix passes only
  const int q0 = blockIdx.x * warps;  // the block's queries lie in one chunk
  const int qi = q0 + warp;
  const bool active = qi < Q;

  int w = 0, len = S;
  if (win != nullptr) {
    w = win[b * n_chunks + q0 / chunk];
    len = band;
  }
  const int end = min(w + len, s_count[b]);  // rows >= s_count are invalid
  const bool tiled = end - w > box_rows;     // block-uniform

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = q + ((size_t)b * Q + qi) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  const float qsq = __fmaf_rn(qz, qz, __fmaf_rn(qy, qy, __fmul_rn(qx, qx)));
  const float reach = r2 + (qsq + r2) * 0x1p-17f;  // plus the chunk's |s|^2 share
  const float* sb = s + (size_t)b * S * 3;

  // the boxes of the chunks of rows [t0, t0 + n), a warp a chunk, the rows
  // of SEL_CHUNKS chunks loaded together
  auto make_boxes = [&](int t0, int n) {
    const int nch = (n + 31) >> 5;
    for (int c0 = warp; c0 < nch; c0 += SEL_CHUNKS * warps) {
      float x[SEL_CHUNKS], y[SEL_CHUNKS], z[SEL_CHUNKS];
#pragma unroll
      for (int u = 0; u < SEL_CHUNKS; ++u) {
        const int i = 32 * (c0 + u * warps) + lane;
        x[u] = y[u] = z[u] = 0.f;
        if (i < n) {
          const float* sp = sb + (size_t)(t0 + i) * 3;
          x[u] = __ldg(sp);
          y[u] = __ldg(sp + 1);
          z[u] = __ldg(sp + 2);
        }
      }
#pragma unroll
      for (int u = 0; u < SEL_CHUNKS; ++u) {
        const int c = c0 + u * warps;  // warp-uniform
        if (c >= nch) break;
        const bool ok = 32 * c + lane < n;
        const float sq = __fmaf_rn(z[u], z[u], __fmaf_rn(y[u], y[u], __fmul_rn(x[u], x[u])));
        const unsigned inf = ordered(CUDART_INF_F), ninf = ordered(-CUDART_INF_F);
        const float lx = unordered(__reduce_min_sync(FULL_MASK, ok ? ordered(x[u]) : inf));
        const float ly = unordered(__reduce_min_sync(FULL_MASK, ok ? ordered(y[u]) : inf));
        const float lz = unordered(__reduce_min_sync(FULL_MASK, ok ? ordered(z[u]) : inf));
        const float hx = unordered(__reduce_max_sync(FULL_MASK, ok ? ordered(x[u]) : ninf));
        const float hy = unordered(__reduce_max_sync(FULL_MASK, ok ? ordered(y[u]) : ninf));
        const float hz = unordered(__reduce_max_sync(FULL_MASK, ok ? ordered(z[u]) : ninf));
        const float hs =
            __uint_as_float(__reduce_max_sync(FULL_MASK, ok ? __float_as_uint(sq) : 0u));
        if (lane == 0) {
          boxes[2 * c] = make_float4(lx, ly, lz, hs);
          boxes[2 * c + 1] = make_float4(hx, hy, hz, 0.f);
        }
      }
    }
  };
  if (!tiled && end > w) make_boxes(w, end - w);
  __syncthreads();

  // One sweep over the window in index order: f(bits, ok, row) per step of
  // 32 rows of a chunk the radius may reach (lane i: row base + i; ok:
  // inside the window and the radius), the rows of up to SEL_CHUNKS such
  // chunks loaded together. On a tiled window the whole block calls it and
  // rebuilds the boxes tile by tile; a warp with !on keeps only the
  // barriers.
  auto sweep = [&](bool on, auto&& f) {
    for (int t0 = w; t0 < end; t0 += box_rows) {
      const int n = min(box_rows, end - t0);
      if (tiled) {
        __syncthreads();
        make_boxes(t0, n);
        __syncthreads();
      }
      if (!on) continue;
      const int nch = (n + 31) >> 5;
      for (int g0 = 0; g0 < nch; g0 += 32) {
        bool live = false;
        if (g0 + lane < nch) {
          const float4 lo = boxes[2 * (g0 + lane)], hi = boxes[2 * (g0 + lane) + 1];
          const float dx = fmaxf(fmaxf(lo.x - qx, qx - hi.x), 0.f);
          const float dy = fmaxf(fmaxf(lo.y - qy, qy - hi.y), 0.f);
          const float dz = fmaxf(fmaxf(lo.z - qz, qz - hi.z), 0.f);
          live = dx * dx + dy * dy + dz * dz <= reach + lo.w * 0x1p-17f;
        }
        for (unsigned m = __ballot_sync(FULL_MASK, live); m;) {
          int i[SEL_CHUNKS];
          float x[SEL_CHUNKS], y[SEL_CHUNKS], z[SEL_CHUNKS];
#pragma unroll
          for (int u = 0; u < SEL_CHUNKS; ++u) {
            i[u] = m ? 32 * (g0 + __ffs(m) - 1) + lane : -1;  // -1: no chunk (warp-uniform)
            m &= m - 1;
            const float* sp = sb + (size_t)(t0 + min(max(i[u], 0), n - 1)) * 3;
            x[u] = __ldg(sp);
            y[u] = __ldg(sp + 1);
            z[u] = __ldg(sp + 2);
          }
#pragma unroll
          for (int u = 0; u < SEL_CHUNKS; ++u) {
            if (i[u] < 0) break;
            const float d = knn_dist(
                qx, qy, qz, qsq,
                make_float4(x[u], y[u], z[u],
                            __fmaf_rn(z[u], z[u], __fmaf_rn(y[u], y[u], __fmul_rn(x[u], x[u])))));
            f(dist_bits(d), i[u] < n && d <= r2, t0 + i[u]);
          }
        }
      }
    }
  };

  // count the in-radius rows, keeping the first sort_rows of them
  int n_in = 0;
  unsigned and_bits = ~0u, or_bits = 0u;
  sweep(active, [&](unsigned bits, bool ok, int j) {
    const unsigned m = __ballot_sync(FULL_MASK, ok);
    const int pos = n_in + __popc(m & lanes_below);
    if (ok) {
      if (pos < sort_rows) buf[pos] = knn_key(bits, j);
      and_bits &= bits;
      or_bits |= bits;
    }
    n_in += __popc(m);
  });

  // more candidates than the buffer holds (n_in > sort_rows >= K): a radix
  // select of the candidate of rank K - 1 from the highest bit in which the
  // candidates differ, stopping at the first digit whose candidates and all
  // below fit in the buffer (those with bits >> lo_bit <= prefix); when the
  // bits run out first, the K nearest are those with bits < prefix and the
  // first `take` at bits == prefix in index order
  const bool pick = active && n_in > sort_rows;
  int lo_bit = 0, take = -1;
  unsigned prefix = 0u;
  if (pick) {
    and_bits = __reduce_and_sync(FULL_MASK, and_bits);
    or_bits = __reduce_or_sync(FULL_MASK, or_bits);
    prefix = or_bits;  // every candidate at one distance: take K of them
    take = K;
  }
  int hi_bit = pick && and_bits != or_bits ? 32 - __clz(and_bits ^ or_bits) : 0;
  if (hi_bit) {
    prefix = or_bits >> hi_bit;  // the bits every candidate shares
    take = -1;
  }
  int base = 0;  // candidates below the current prefix
  while (tiled ? __syncthreads_or(hi_bit > 0) : hi_bit > 0) {
    const bool on = hi_bit > 0;
    const int lo = max(0, hi_bit - 8);
    const unsigned dmask = (1u << (hi_bit - lo)) - 1u;
    if (on) {
      for (int i = lane; i < KNN_SELECT_BINS; i += 32) hist[i] = 0u;
      __syncwarp();
    }
    sweep(on, [&](unsigned bits, bool ok, int) {
      const bool in = ok && (bits >> hi_bit) == prefix;
      const unsigned digit = (bits >> lo) & dmask;
      const unsigned peers = __match_any_sync(FULL_MASK, in ? digit : ~0u);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], (unsigned)__popc(peers));
    });
    if (on) {
      __syncwarp();
      const int rr = K - 1 - base;  // the rank to place among the prefix's candidates
      unsigned cnt8[8], tot = 0u;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        cnt8[t] = hist[lane * 8 + t];
        tot += cnt8[t];
      }
      unsigned incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned x = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += x;
      }
      unsigned below = incl - tot;
      const int src = __ffs(__ballot_sync(FULL_MASK, below <= (unsigned)rr && (unsigned)rr < incl)) - 1;
      int digit = 0;
      bool found = false;
#pragma unroll
      for (int t = 0; t < 8; ++t) {  // the bin of rank rr in lane src's eight
        if (!found && (unsigned)rr < below + cnt8[t]) {
          digit = lane * 8 + t;
          found = true;
        } else if (!found) {
          below += cnt8[t];
        }
      }
      digit = __shfl_sync(FULL_MASK, digit, src);
      below = __shfl_sync(FULL_MASK, below, src);
      const unsigned at = hist[digit];
      __syncwarp();
      prefix = (prefix << (hi_bit - lo)) | (unsigned)digit;
      lo_bit = lo;
      if (base + (int)(below + at) <= sort_rows) {
        hi_bit = 0;  // collect every candidate with bits >> lo_bit <= prefix
      } else if (lo == 0) {
        hi_bit = 0;  // one distance: take the first of its candidates
        take = K - base - (int)below;
      } else {
        base += (int)below;
        hi_bit = lo;
      }
    }
  }
  if (tiled ? __syncthreads_or(pick) : pick) {
    int cnt = 0, ties = 0;
    sweep(pick, [&](unsigned bits, bool ok, int j) {
      const unsigned top = bits >> lo_bit;
      const bool eq = ok && top == prefix;
      const unsigned m_eq = __ballot_sync(FULL_MASK, eq);
      const bool sel =
          ok && (top < prefix || (eq && (take < 0 || ties + __popc(m_eq & lanes_below) < take)));
      const unsigned m = __ballot_sync(FULL_MASK, sel);
      if (sel) buf[cnt + __popc(m & lanes_below)] = knn_key(bits, j);
      cnt += __popc(m);
      ties += __popc(m_eq);
    });
    if (pick) n_in = cnt;  // every key in the buffer; K or more, the K nearest among them
  }
  if (active) {
    __syncwarp();
    warp_sort(buf, min(n_in, sort_rows), lane);
    const int m_out = min(K, n_in);
    int* op = out + ((size_t)b * Q + qi) * K;
    for (int i = lane; i < m_out; i += 32) op[i] = (int)(unsigned)buf[i];
    for (int i = m_out + lane; i < K; i += 32) op[i] = S;
  }
}

// The warp select path, for 1 <= K <= sort_rows: arguments as
// radius_knn_launch, with box_rows (a multiple of 32) the window rows whose
// chunk boxes a block keeps at once and sort_rows (a power of two >= 128) the
// keys of each warp's sort buffer. Dynamic shared memory: box_rows / 32
// boxes of 32 bytes, then warps x sort_rows 8-byte keys. Returns
// cudaGetLastError() after the launch.
extern "C" int radius_knn_select_launch(const float* q, const float* s, const int* s_count,
                                        const int* win, int B, int Q, int S, int K, float r2,
                                        int chunk, int band, int n_chunks, int warps,
                                        int sort_rows, int box_rows, int* out, void* stream) {
  if (K < 1 || K > sort_rows || sort_rows < 128 || (sort_rows & (sort_rows - 1)))
    return (int)cudaErrorInvalidValue;
  if (warps < 1 || warps > KNN_MAX_WARPS || box_rows < 32 || box_rows % 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)box_rows + (size_t)warps * sort_rows * sizeof(unsigned long long);
  if (smem > KNN_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (win != nullptr && (chunk <= 0 || chunk % 64 != 0 || chunk % warps != 0 || band <= 0))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Q == 0) return 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(radius_knn_select_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Q + warps - 1) / warps, B);
  radius_knn_select_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      q, s, s_count, win, Q, S, K, r2, chunk, band, n_chunks, box_rows, sort_rows, out);
  return (int)cudaGetLastError();
}

// ---- large K: the block select path -------------------------------------------------------

// The lanes whose 8-bit digit equals this lane's, among the lanes with ok
// (eight ballots).
__device__ __forceinline__ unsigned same_digit(unsigned d, bool ok) {
  unsigned same = __ballot_sync(FULL_MASK, ok);
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    const unsigned set = __ballot_sync(FULL_MASK, (d >> bit) & 1u);
    same &= (d >> bit) & 1u ? set : ~set;
  }
  return same;
}

// Sort a[0, n) ascending in place (n <= KNB_SORT_ROWS_MAX); every thread of
// the block calls it, and a barrier follows. n <= 256: warp 0 alone, in
// registers (warp_register_sort). Larger n: a least-significant-digit radix
// sort on the bytes in which the keys differ (found by an AND and an OR over
// all keys; for (distance bits, index) keys ~6 of 8). Each pass is stable:
// the keys are read in position order into registers (warp w holds
// positions [w * seg, (w + 1) * seg), up to 8 a lane), each warp counts its
// keys' digits into its own 256 bins (one increment a group of equal digits
// in a step of 32 keys), 256 threads turn the bins into offsets in (digit,
// warp) order, and every key is written to its offset plus its rank among
// the earlier keys of its warp with that digit. whist: 16 x 256 bins; bits:
// 2 keys; wsum: 8 words. (PERF.md, section 6, times it against two bitonic
// sorts on an H100.)
__device__ void block_sort(unsigned long long* a, int n, unsigned* whist,
                           unsigned long long* bits, unsigned* wsum) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (n <= 1) return;  // block-uniform
  if (n <= 256) {
    if (warp == 0) {
      if (n <= 32)
        warp_register_sort<1>(a, n, lane);
      else if (n <= 64)
        warp_register_sort<2>(a, n, lane);
      else if (n <= 128)
        warp_register_sort<4>(a, n, lane);
      else
        warp_register_sort<8>(a, n, lane);
    }
    return;
  }
  const unsigned lanes_below = (1u << lane) - 1u;
  const int steps = (n + KNB_THREADS - 1) / KNB_THREADS;  // <= 8
  const int seg = 32 * steps;
  if (tid == 0) {
    bits[0] = ~0ull;
    bits[1] = 0ull;
  }
  __syncthreads();
  unsigned long long k_and = ~0ull, k_or = 0ull;
  for (int i = 0; i < steps; ++i) {
    const int p = warp * seg + i * 32 + lane;
    if (p < n) {
      k_and &= a[p];
      k_or |= a[p];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    k_and &= __shfl_xor_sync(FULL_MASK, k_and, o);
    k_or |= __shfl_xor_sync(FULL_MASK, k_or, o);
  }
  if (lane == 0) {
    atomicAnd(&bits[0], k_and);
    atomicOr(&bits[1], k_or);
  }
  __syncthreads();
  const unsigned long long vary = bits[0] ^ bits[1];
  unsigned* const hw = whist + warp * KNN_SELECT_BINS;
  for (int sh = 0; sh < 64; sh += 8) {
    if (((vary >> sh) & 255ull) == 0ull) continue;  // one digit for every key
    for (int d = lane; d < KNN_SELECT_BINS; d += 32) hw[d] = 0u;
    __syncwarp();
    unsigned long long key[8];
    unsigned rank[4];  // two 16-bit ranks a word (n <= 4096)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < steps) {
        const int p = warp * seg + i * 32 + lane;
        const bool ok = p < n;
        key[i] = ok ? a[p] : 0ull;
        const unsigned d = (unsigned)(key[i] >> sh) & 255u;
        const unsigned same = same_digit(d, ok);
        const unsigned base = hw[d];
        __syncwarp();
        if (ok && lane == __ffs(same) - 1) hw[d] = base + __popc(same);
        const unsigned r = base + __popc(same & lanes_below);
        rank[i >> 1] = i & 1 ? rank[i >> 1] | (r << 16) : r;
        __syncwarp();
      }
    }
    __syncthreads();
    // bins -> offsets in (digit, warp) order, thread t < 256 the digit t
    unsigned tot = 0u, incl = 0u;
    if (tid < KNN_SELECT_BINS) {
#pragma unroll
      for (int w = 0; w < KNB_THREADS / 32; ++w) tot += whist[w * KNN_SELECT_BINS + tid];
      incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned x = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += x;
      }
      if (lane == 31) wsum[warp] = incl;
    }
    __syncthreads();
    if (tid < KNN_SELECT_BINS) {
      unsigned run = incl - tot;
      for (int i = 0; i < warp; ++i) run += wsum[i];
#pragma unroll
      for (int w = 0; w < KNB_THREADS / 32; ++w) {
        const unsigned x = whist[w * KNN_SELECT_BINS + tid];
        whist[w * KNN_SELECT_BINS + tid] = run;
        run += x;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < steps && warp * seg + i * 32 + lane < n) {
        const unsigned r = (rank[i >> 1] >> (16 * (i & 1))) & 0xffffu;
        a[hw[(unsigned)(key[i] >> sh) & 255u] + r] = key[i];
      }
    }
    __syncthreads();
  }
}

// One CTA per query (blockIdx.x) of cloud blockIdx.y. One sweep over the
// query's window, split over the block's threads (four rows a thread a step,
// their loads in flight together), computes each row's distance once and
// appends the in-radius rows' 64-bit keys (distance bits, index) to a cache
// in shared memory (warp-aggregated: ballots, one shared counter increment
// a warp a step). Keys are unique (the index is in the low word) and their order
// is the (d, j) order, so which thread appended a key, and when, does not
// matter. When every in-radius key is cached and fits in sort_rows, the
// cache is sorted in place (block_sort) and the first K written. Otherwise
// the output is cut into chunks of sort_rows ranks; the separator of a
// chunk's upper rank hi (a key T with exactly hi keys below it) comes from
// a radix select over the keys, 8 bits a pass from the top, into one shared
// 256-bin histogram with warp-aggregated increments (__match_any_sync: one
// atomicAdd per distinct bin a warp), ending at the first pass whose remaining rank is 0.
// The chunk's keys (T_lo <= key < T_hi) are gathered into the sort buffer
// and sorted there. A query whose in-radius rows overflow the cache (a
// window of more than cache_keys rows) runs the same passes over its window
// instead of the cache, recomputing the distances each pass.
__global__ void __launch_bounds__(KNB_THREADS, 2)
radius_knn_block_kernel(const float* __restrict__ q, const float* __restrict__ s,
                        const int* __restrict__ s_count, const int* __restrict__ win, int Q,
                        int S, int K, float r2, int chunk, int band, int n_chunks, int cache_keys,
                        int sort_rows, int* __restrict__ out) {
  // cache_keys keys, then sort_rows keys, then 16 warps' 256 bins
  extern __shared__ unsigned long long keys[];
  unsigned long long* const sbuf = keys + cache_keys;
  unsigned* const whist = reinterpret_cast<unsigned*>(sbuf + sort_rows);
  unsigned* const hist = whist;  // the separator's bins (not used while sorting)
  __shared__ int n_sh, cnt_sh;
  __shared__ unsigned digit_sh, before_sh;
  __shared__ unsigned long long bits_sh[2];
  __shared__ unsigned wsum_sh[KNN_SELECT_BINS / 32];
  const int b = blockIdx.y, qi = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const unsigned lanes_below = (1u << lane) - 1u;

  int w = 0, len = S;
  if (win != nullptr) {
    w = win[b * n_chunks + qi / chunk];
    len = band;
  }
  const int end = min(w + len, s_count[b]);  // rows >= s_count are invalid
  const float* qp = q + ((size_t)b * Q + qi) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float qsq = __fmaf_rn(qz, qz, __fmaf_rn(qy, qy, __fmul_rn(qx, qx)));
  const float* sb = s + (size_t)b * S * 3;
  // the key of row j and whether it lies inside the radius (j < end)
  auto row_key = [&](int j, bool& ok) -> unsigned long long {
    const float* sp = sb + (size_t)j * 3;
    const float x = sp[0], y = sp[1], z = sp[2];
    const float d = knn_dist(qx, qy, qz, qsq,
                             make_float4(x, y, z, __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)))));
    ok = d <= r2;
    return knn_key(dist_bits(d), j);
  };

  // the in-radius keys, cached while they fit
  if (tid == 0) n_sh = 0;
  __syncthreads();
  for (int base = w; base < end; base += 4 * KNB_THREADS) {
    unsigned long long key[4];
    bool ok[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = base + r * KNB_THREADS + tid;
      ok[r] = false;
      key[r] = j < end ? row_key(j, ok[r]) : 0ull;
    }
    unsigned m[4];
    int total = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      m[r] = __ballot_sync(FULL_MASK, ok[r]);
      total += __popc(m[r]);
    }
    int at = 0;  // one counter increment a warp for its four rows
    if (lane == 0 && total) at = atomicAdd(&n_sh, total);
    at = __shfl_sync(FULL_MASK, at, 0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int pos = at + __popc(m[r] & lanes_below);
      if (ok[r] && pos < cache_keys) keys[pos] = key[r];
      at += __popc(m[r]);
    }
  }
  __syncthreads();
  const int n = n_sh;
  const bool cached = n <= cache_keys;  // block-uniform
  const int m_out = min(K, n);
  int* op = out + ((size_t)b * Q + qi) * K;

  // f(key, ok) for every in-radius key (ok false on padding lanes), each
  // warp's lanes together
  auto each = [&](auto&& f) {
    if (cached) {
      for (int i0 = 0; i0 < n; i0 += KNB_THREADS) {
        const int i = i0 + tid;
        f(i < n ? keys[i] : 0ull, i < n);
      }
    } else {
      for (int base = w; base < end; base += KNB_THREADS) {
        const int j = base + tid;
        bool ok = false;
        unsigned long long key = 0ull;
        if (j < end) key = row_key(j, ok);
        f(key, ok);
      }
    }
  };

  // a separator of rank hi < n: T with exactly hi keys below it
  auto separator = [&](int hi) -> unsigned long long {
    unsigned long long prefix = 0ull;
    int rr = hi;  // the rank still to place among the keys that match the prefix
    for (int shift = 56; shift >= 0; shift -= 8) {
      const unsigned long long above = shift == 56 ? 0ull : ~0ull << (shift + 8);
      for (int i = tid; i < KNN_SELECT_BINS; i += KNB_THREADS) hist[i] = 0u;
      __syncthreads();
      each([&](unsigned long long key, bool ok) {
        const bool in = ok && (key & above) == prefix;
        const unsigned digit = (unsigned)(key >> shift) & 255u;
        const unsigned peers = __match_any_sync(FULL_MASK, in ? digit : ~0u);
        if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], (unsigned)__popc(peers));
      });
      __syncthreads();
      if (tid < 32) {
        unsigned cnt8[8], tot = 0u;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          cnt8[t] = hist[lane * 8 + t];
          tot += cnt8[t];
        }
        unsigned incl = tot;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned x = __shfl_up_sync(FULL_MASK, incl, o);
          if (lane >= o) incl += x;
        }
        unsigned before = incl - tot;
        if (before <= (unsigned)rr && (unsigned)rr < incl) {  // one lane
          int t = 0;
          while ((unsigned)rr >= before + cnt8[t]) before += cnt8[t++];
          digit_sh = lane * 8 + t;
          before_sh = before;
        }
      }
      __syncthreads();
      rr -= (int)before_sh;
      prefix |= (unsigned long long)digit_sh << shift;
      if (rr == 0) break;  // block-uniform: keys below prefix (lower bits 0) number hi
    }
    return prefix;
  };

  if (cached && n <= sort_rows) {
    block_sort(keys, n, whist, bits_sh, wsum_sh);
    __syncthreads();
    for (int i = tid; i < m_out; i += KNB_THREADS) op[i] = (int)(unsigned)keys[i];
  } else {
    unsigned long long lo_t = 0ull;
    for (int lo = 0; lo < m_out; lo += sort_rows) {
      const int hi = min(lo + sort_rows, m_out);
      const unsigned long long hi_t = hi < n ? separator(hi) : ~0ull;
      if (tid == 0) cnt_sh = 0;
      __syncthreads();
      each([&](unsigned long long key, bool ok) {
        const bool sel = ok && key >= lo_t && key < hi_t;
        const unsigned m = __ballot_sync(FULL_MASK, sel);
        int at = 0;
        if (lane == 0 && m) at = atomicAdd(&cnt_sh, __popc(m));
        at = __shfl_sync(FULL_MASK, at, 0) + __popc(m & lanes_below);
        if (sel) sbuf[at] = key;  // at < sort_rows: the chunk's hi - lo keys
      });
      __syncthreads();
      block_sort(sbuf, cnt_sh, whist, bits_sh, wsum_sh);
      __syncthreads();
      for (int i = tid; i < hi - lo; i += KNB_THREADS) op[lo + i] = (int)(unsigned)sbuf[i];
      __syncthreads();
      lo_t = hi_t;
    }
  }
  for (int i = m_out + tid; i < K; i += KNB_THREADS) op[i] = S;
}

// The block select path, for any K >= 1 (the wrapper takes it for large K):
// arguments as radius_knn_launch; cache_keys (a power of two in [32, 8192])
// in-radius keys a CTA keeps, sort_rows (a power of two in [32, 4096]) keys it
// sorts at once. Dynamic shared memory: (cache_keys + sort_rows) 8-byte keys
// and 16 x 256 histogram bins. Returns cudaGetLastError() after the launch.
extern "C" int radius_knn_block_launch(const float* q, const float* s, const int* s_count,
                                       const int* win, int B, int Q, int S, int K, float r2,
                                       int chunk, int band, int n_chunks, int cache_keys,
                                       int sort_rows, int* out, void* stream) {
  if (K < 1 || sort_rows < 32 || sort_rows > KNB_SORT_ROWS_MAX || (sort_rows & (sort_rows - 1)))
    return (int)cudaErrorInvalidValue;
  if (cache_keys < 32 || cache_keys > KNB_CACHE_KEYS_MAX || (cache_keys & (cache_keys - 1)))
    return (int)cudaErrorInvalidValue;
  if (win != nullptr && (chunk <= 0 || band <= 0)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Q == 0) return 0;
  const size_t smem = (size_t)(cache_keys + sort_rows) * sizeof(unsigned long long) +
                      (KNB_THREADS / 32) * KNN_SELECT_BINS * sizeof(unsigned);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(radius_knn_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(Q, B);
  radius_knn_block_kernel<<<grid, KNB_THREADS, smem, (cudaStream_t)stream>>>(
      q, s, s_count, win, Q, S, K, r2, chunk, band, n_chunks, cache_keys, sort_rows, out);
  return (int)cudaGetLastError();
}
