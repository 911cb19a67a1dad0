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
// K > 256, the select path (radius_knn_select_launch): a list that long no
// longer fits in a warp's registers, so each query's K nearest are selected
// rather than kept sorted while the window streams by. Still a warp per
// query over the same staged window. A first sweep counts the query's
// in-radius rows and writes the first SR of them into the warp's sort
// buffer in shared memory (SR = min(next_pow2(K), 2048) keys of (distance
// bits << 32 | index)). When they all fit, a bitonic sort of the buffer
// gives the answer at once: the common case, where far fewer than K rows
// lie in the radius. Otherwise the output is cut into chunks of SR ranks;
// each chunk's upper rank is located by a radix select on the distance
// bits (four sweeps of 8-bit digits into a 256-bin histogram per warp), the
// rows of the chunk's ranks are emitted in one more sweep (those at a
// bounding distance counted off in index order, the sweep's order) and
// sorted. A key's low word is the index, so ties come out in index order,
// as on the register path. A tiled window is restaged tile by tile in every
// sweep, so there the sweeps are block-wide and a warp with nothing to do
// keeps only the barriers.

#include <cuda_runtime.h>
#include <math_constants.h>

#define KNN_KMAX 256  // the register list's longest bucket; above it the select path
#define KNN_MAX_WARPS 16
#define KNN_SMEM_MAX 232448
#define KNN_SORT_ROWS_MAX 2048
#define KNN_SELECT_BINS 256
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

// ---- K > 256: the select path ----------------------------------------------------------

// The order of a candidate: its squared distance's bits (d >= 0, so the bits
// order as the floats do; -0 folds onto +0), then its index.
__device__ __forceinline__ unsigned dist_bits(float d) { return __float_as_uint(d) & 0x7fffffffu; }

__device__ __forceinline__ unsigned long long knn_key(unsigned bits, int j) {
  return ((unsigned long long)bits << 32) | (unsigned)j;
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

// The candidates of rank < r in (d, j) order: bits < t, or bits == t and
// among the first e candidates at t in index order. {0, 0} holds none,
// {~0u, 0} every candidate.
struct RankBound {
  unsigned t;
  int e;
};

__global__ void __launch_bounds__(KNN_MAX_WARPS * 32, 1)
radius_knn_select_kernel(const float* __restrict__ q, const float* __restrict__ s,
                         const int* __restrict__ s_count, const int* __restrict__ win, int Q,
                         int S, int K, float r2, int chunk, int band, int n_chunks,
                         int tile_rows, int sort_rows, int* __restrict__ out) {
  extern __shared__ float4 tile[];  // tile_rows rows, then the warps' buffers and histograms
  __shared__ int block_chunks;
  const int b = blockIdx.y;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  unsigned long long* const bufs = reinterpret_cast<unsigned long long*>(tile + tile_rows);
  unsigned long long* const buf = bufs + (size_t)warp * sort_rows;
  unsigned* const hist =
      reinterpret_cast<unsigned*>(bufs + (size_t)warps * sort_rows) + warp * KNN_SELECT_BINS;
  const int q0 = blockIdx.x * warps;  // the block's queries lie in one chunk
  const int qi = q0 + warp;
  const bool active = qi < Q;

  int w = 0, len = S;
  if (win != nullptr) {
    w = win[b * n_chunks + q0 / chunk];
    len = band;
  }
  const int end = min(w + len, s_count[b]);  // rows >= s_count are invalid
  const bool tiled = end - w > tile_rows;    // block-uniform

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = q + ((size_t)b * Q + qi) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  const float qsq = __fmaf_rn(qz, qz, __fmaf_rn(qy, qy, __fmul_rn(qx, qx)));
  const float* sb = s + (size_t)b * S * 3;
  auto stage = [&](int t0, int n) {
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const float* sp = sb + (size_t)(t0 + t) * 3;
      const float x = sp[0], y = sp[1], z = sp[2];
      tile[t] = make_float4(x, y, z, __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x))));
    }
  };
  if (threadIdx.x == 0) block_chunks = 0;
  if (!tiled && end > w) stage(w, end - w);
  __syncthreads();

  // One sweep over the window in index order: f(bits, ok, row) per step of
  // 32 candidates (lane i: row base + i; ok: inside the window and the
  // radius). Called by the whole block, which restages the tiles of a
  // tiled window; a warp with !on keeps only the barriers.
  auto sweep = [&](bool on, auto&& f) {
    for (int t0 = w; t0 < end; t0 += tile_rows) {
      const int n = min(tile_rows, end - t0);
      if (tiled) {
        __syncthreads();
        stage(t0, n);
        __syncthreads();
      }
      if (!on) continue;
      for (int base = 0; base < n; base += 32) {
        const int i = base + lane;
        const float d = knn_dist(qx, qy, qz, qsq, tile[min(i, n - 1)]);
        f(dist_bits(d), i < n && d <= r2, t0 + i);
      }
    }
  };

  // count the in-radius rows, keeping the first sort_rows of them
  int n_in = 0;
  sweep(active, [&](unsigned bits, bool ok, int j) {
    const unsigned m = __ballot_sync(FULL_MASK, ok);
    const int pos = n_in + __popc(m & lanes_below);
    if (ok && pos < sort_rows) buf[pos] = knn_key(bits, j);
    n_in += __popc(m);
  });
  const int m_out = min(K, n_in);
  int* op = out + ((size_t)b * Q + (active ? qi : 0)) * K;
  if (active && n_in <= sort_rows) {  // every candidate is in the buffer
    __syncwarp();
    warp_bitonic_sort(buf, n_in, lane);
    for (int i = lane; i < m_out; i += 32) op[i] = (int)(unsigned)buf[i];
  }
  const int chunks = active && n_in > sort_rows ? (m_out + sort_rows - 1) / sort_rows : 0;
  if (lane == 0 && chunks > 0) atomicMax(&block_chunks, chunks);
  __syncthreads();
  const int all_chunks = block_chunks;

  RankBound lo_b{0u, 0};
  for (int c = 0; c < all_chunks; ++c) {
    const bool on = c < chunks;
    const int lo = c * sort_rows, hi = min(lo + sort_rows, m_out);
    const bool pick = on && hi < n_in;  // the chunk ends inside the candidates
    RankBound hi_b{~0u, 0};
    if (__syncthreads_or(pick)) {
      // radix select of the candidate of rank hi, 8 bits a sweep
      unsigned prefix = 0u, pmask = 0u;
      int rr = hi;  // its rank among the candidates that match the prefix
      for (int shift = 24; shift >= 0; shift -= 8) {
        for (int i = lane; i < KNN_SELECT_BINS; i += 32) hist[i] = 0u;
        __syncwarp();
        sweep(pick, [&](unsigned bits, bool ok, int) {
          if (ok && (bits & pmask) == prefix) atomicAdd(&hist[(bits >> shift) & 255u], 1u);
        });
        __syncwarp();
        if (pick) {
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
          const unsigned excl = incl - tot;
          const bool mine = excl <= (unsigned)rr && (unsigned)rr < incl;
          const int src = __ffs(__ballot_sync(FULL_MASK, mine)) - 1;
          int digit = 0;
          unsigned before = excl;
          bool found = false;
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            if (!found && (unsigned)rr < before + cnt8[t]) {
              digit = lane * 8 + t;
              found = true;
            } else if (!found) {
              before += cnt8[t];
            }
          }
          digit = __shfl_sync(FULL_MASK, digit, src);
          before = __shfl_sync(FULL_MASK, before, src);
          rr -= (int)before;
          prefix |= (unsigned)digit << shift;
          pmask |= 255u << shift;
        }
        __syncwarp();
      }
      if (pick) hi_b = RankBound{prefix, rr};
    }
    // emit the candidates of ranks [lo, hi), then sort them
    int cnt = 0, tie_lo = 0, tie_hi = 0;
    sweep(on, [&](unsigned bits, bool ok, int j) {
      const bool eq_lo = ok && bits == lo_b.t, eq_hi = ok && bits == hi_b.t;
      const unsigned m_lo = __ballot_sync(FULL_MASK, eq_lo);
      const unsigned m_hi = __ballot_sync(FULL_MASK, eq_hi);
      const bool under_lo =
          bits < lo_b.t || (eq_lo && tie_lo + __popc(m_lo & lanes_below) < lo_b.e);
      const bool under_hi =
          bits < hi_b.t || (eq_hi && tie_hi + __popc(m_hi & lanes_below) < hi_b.e);
      const bool sel = ok && under_hi && !under_lo;
      const unsigned m = __ballot_sync(FULL_MASK, sel);
      const int pos = cnt + __popc(m & lanes_below);
      if (sel && pos < sort_rows) buf[pos] = knn_key(bits, j);
      cnt += __popc(m);
      tie_lo += __popc(m_lo);
      tie_hi += __popc(m_hi);
    });
    if (on) {
      __syncwarp();
      warp_bitonic_sort(buf, min(cnt, sort_rows), lane);  // cnt == hi - lo
      for (int i = lane; i < hi - lo; i += 32) op[lo + i] = (int)(unsigned)buf[i];
      __syncwarp();
    }
    lo_b = hi_b;
  }
  if (active)
    for (int i = m_out + lane; i < K; i += 32) op[i] = S;
}

// The select path, for any K >= 1 (the wrapper takes it for K > 256):
// arguments as radius_knn_launch, with sort_rows (a power of two in
// [32, 2048]) the keys of each warp's sort buffer. Dynamic shared memory:
// tile_rows float4 rows, then warps x sort_rows 8-byte keys and warps x 256
// histogram bins. Returns cudaGetLastError() after the launch.
extern "C" int radius_knn_select_launch(const float* q, const float* s, const int* s_count,
                                        const int* win, int B, int Q, int S, int K, float r2,
                                        int chunk, int band, int n_chunks, int warps,
                                        int sort_rows, int tile_rows, int* out, void* stream) {
  if (K < 1 || sort_rows < 32 || sort_rows > KNN_SORT_ROWS_MAX || (sort_rows & (sort_rows - 1)))
    return (int)cudaErrorInvalidValue;
  if (warps < 1 || warps > KNN_MAX_WARPS || tile_rows < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)tile_rows * sizeof(float4) +
                      (size_t)warps * (sort_rows * sizeof(unsigned long long) +
                                       KNN_SELECT_BINS * sizeof(unsigned));
  if (smem + sizeof(int) > KNN_SMEM_MAX) return (int)cudaErrorInvalidValue;
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
      q, s, s_count, win, Q, S, K, r2, chunk, band, n_chunks, tile_rows, sort_rows, out);
  return (int)cudaGetLastError();
}
