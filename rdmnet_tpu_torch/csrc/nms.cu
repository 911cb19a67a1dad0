// Greedy radius NMS by parallel peeling, the whole loop in one launch, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs the peeling as a
// lax.while_loop on the device (rdmnet_tpu/ops/nms.py:88-101), which XLA
// lowers without Pallas. The port's plain version (ops/kernels/nms.py,
// nms_peel_plain) is a Python loop on active.any(), one host round trip a
// round; this kernel is the while_loop's counterpart, so that the forward
// needs no host check and can be captured in a CUDA graph.
//
// What it computes: per cloud b, from the strict-lower adjacency (bool
// (B, M, M): row i, column j < i set iff nodes i, j suppress each other)
// and the valid nodes, the lexicographically-first maximal independent set,
// keep[b], and the rounds it took. Each round confirms every active node
// with no earlier active neighbour, then deactivates the confirmed nodes and
// the later actives that see a confirmed one, until none is active. The set
// is unique, so keep equals the plain version's exactly, and the rounds too
// (the plain loop runs while any cloud has an active node; the wrapper takes
// the clouds' maximum).
//
// What bounds it: latency. The strict-lower bytes of the adjacency are read
// once (at the 1.0 bucket's M = 640, ~205 KB a cloud); a round is two
// passes of at most ceil(M / 32) word ANDs a node and three barriers, and
// the rounds (the suppression chain's depth, ~10 on scans) run one after
// the other.
//
// Design: one CTA per cloud. First the CTA packs the words a row needs
// (word c of row i, c <= i / 32: columns 32c .. 32c + 31 as bits), a thread
// a word, from 16-byte loads where the rows allow them. The words go to
// shared memory at an odd word stride (the 32 rows a warp reads at one word
// index fall in 32 different banks) when they fit in the CTA's shared
// memory (M <= 1348), else to a scratch buffer in device memory that the
// wrapper allocates; the peeling reads both through one pointer. Then a
// node per thread, a 32-node word per warp, so each pass ends in one
// __ballot_sync that writes the warp's word of the confirmed (or still
// active) set: no atomics. The active, confirmed and kept sets live in
// shared memory as bit words; "any active" is a __syncthreads_or, which also
// makes the packed words (shared or device memory) visible to the CTA.

#include <cuda_runtime.h>
#include <stdint.h>

#define NMS_THREADS 1024

// Bits of the 32 bytes from `col0` of `row` (the bytes past M read as 0):
// bit l set iff byte col0 + l is nonzero. `vec`: the row is 16-byte aligned
// and M a multiple of 16, so the bytes come in 16-byte loads.
__device__ __forceinline__ unsigned pack_word(const unsigned char* row, int col0, int M,
                                              bool vec) {
  unsigned word = 0u;
  if (vec) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (col0 + 16 * h >= M) break;
      const uint4 v = *reinterpret_cast<const uint4*>(row + col0 + 16 * h);
      const unsigned q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          word |= (((q[k] >> (8 * s)) & 0xffu) != 0u ? 1u : 0u) << (16 * h + 4 * k + s);
    }
  } else {
    for (int l = 0; l < 32 && col0 + l < M; ++l) word |= (row[col0 + l] != 0 ? 1u : 0u) << l;
  }
  return word;
}

__global__ void __launch_bounds__(NMS_THREADS)
nms_peel_kernel(const unsigned char* __restrict__ adj, const unsigned char* __restrict__ mask,
                int M, int W, unsigned* scratch, unsigned char* __restrict__ keep_out,
                int* __restrict__ rounds_out) {
  extern __shared__ unsigned smem[];
  unsigned* active = smem;
  unsigned* confirm = smem + W;
  unsigned* kept = smem + 2 * W;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  unsigned* rows = scratch ? scratch + (size_t)b * M * W : smem + 3 * W;
  const int stride = scratch ? W : (W | 1);
  const unsigned char* a = adj + (size_t)b * M * M;
  const bool vec = M % 16 == 0 && (reinterpret_cast<uintptr_t>(adj) & 15u) == 0u;
  for (int idx = threadIdx.x; idx < M * W; idx += blockDim.x) {
    const int i = idx / W, c = idx - i * W;
    if (c <= (i >> 5))
      rows[(size_t)i * stride + c] = pack_word(a + (size_t)i * M, 32 * c, M, vec);
  }
  bool any = false;
  for (int w = warp; w < W; w += nwarps) {
    const int i = w * 32 + lane;
    const unsigned word = __ballot_sync(0xffffffffu, i < M && mask[(size_t)b * M + i]);
    if (lane == 0) {
      active[w] = word;
      kept[w] = 0u;
      any |= word != 0u;
    }
  }
  any = __syncthreads_or(any);
  int r = 0;
  while (any) {
    // confirm: active and no earlier active neighbour
    for (int w = warp; w < W; w += nwarps) {
      const int i = w * 32 + lane;
      const bool act = (active[w] >> lane) & 1u;
      bool hit = false;
      if (act) {
        const unsigned* row = rows + (size_t)i * stride;
        for (int c = 0; c <= w && !hit; ++c) hit = (row[c] & active[c]) != 0u;
      }
      const unsigned word = __ballot_sync(0xffffffffu, act && !hit);
      if (lane == 0) confirm[w] = word;
    }
    __syncthreads();
    // kill: the later actives that see a confirmed node
    any = false;
    for (int w = warp; w < W; w += nwarps) {
      const int i = w * 32 + lane;
      const bool act = (active[w] >> lane) & 1u;
      const bool cf = (confirm[w] >> lane) & 1u;
      bool killed = false;
      if (act && !cf) {
        const unsigned* row = rows + (size_t)i * stride;
        for (int c = 0; c <= w && !killed; ++c) killed = (row[c] & confirm[c]) != 0u;
      }
      const unsigned alive = __ballot_sync(0xffffffffu, act && !cf && !killed);
      if (lane == 0) {
        active[w] = alive;
        kept[w] |= confirm[w];
        any |= alive != 0u;
      }
    }
    ++r;
    any = __syncthreads_or(any);
  }
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    keep_out[(size_t)b * M + i] = (unsigned char)((kept[i >> 5] >> (i & 31)) & 1u);
  if (threadIdx.x == 0) rounds_out[b] = r;
}

// adj (B, M, M) bool (the strict-lower adjacency), mask (B, M) bool (the
// valid nodes); keep (B, M) bool, rounds (B,) int32; all contiguous.
// scratch: null when the packed rows fit in a CTA's shared memory (the
// wrapper's smem_bytes), else (B, M, ceil(M / 32)) 32-bit words of device
// memory for them (not read before the kernel writes them). Returns
// cudaGetLastError() after the launch.
extern "C" int nms_peel_launch(const unsigned char* adj, const unsigned char* mask, int B, int M,
                               unsigned* scratch, unsigned char* keep, int* rounds,
                               void* stream) {
  if (B < 0 || M < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int W = (M + 31) / 32;
  const size_t smem =
      sizeof(unsigned) * (3 * (size_t)W + (scratch ? 0 : (size_t)M * (W | 1)));
  cudaError_t e = cudaFuncSetAttribute(nms_peel_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  nms_peel_kernel<<<B, NMS_THREADS, smem, (cudaStream_t)stream>>>(adj, mask, M, W, scratch,
                                                                  keep, rounds);
  return (int)cudaGetLastError();
}
