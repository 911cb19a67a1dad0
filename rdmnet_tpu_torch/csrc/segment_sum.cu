// Sorted segment sums of the grid subsample for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package sums each voxel's points with
// jax.ops.segment_sum (rdmnet_tpu/ops/grid_subsample.py:141), which XLA
// lowers without Pallas and evaluates in sorted order. The port's plain
// version (ops/kernels/segment_sum.py, segment_sums_plain) adds every
// segment's j-th point in step j, a loop whose trip count is the longest
// segment: on the card it reads that count back to the host once a level.
// This kernel takes the loop's place so that the graph build needs no host
// round trip and can be captured in a CUDA graph.
//
// What it computes: for cloud b and segment s, the float32 sum of the
// sorted rows start[b, s] .. start[b, s] + length[b, s] - 1, added left to
// right from +0 with round-to-nearest adds (__fadd_rn, never fused), so the
// sum is bit-equal to the plain loop's (which adds +0 for j >= length: x + 0
// is x, and +0 + -0 is +0 in both) and through it to XLA's sequential
// segment_sum.
//
// What bounds it: bytes. Each point is read once (12 bytes) and each sum
// written once; at the main path's largest level (B = 2, 21504 rows into
// 8704 segments) that is ~0.9 MB, ~0.26 us at 3.35 TB/s, far below a launch.
//
// Design: one thread per (cloud, segment), 256 threads a block, the blocks
// of a cloud along x and the clouds along y. The adds of a segment form one
// dependent chain (the rounding order is the result), but its loads do not
// depend on the chain: the loop is unrolled by 4 so that four rows are in
// flight before their adds. A long segment (a dense voxel of thousands of
// points) serialises only its own thread.

#include <cuda_runtime.h>

#define SEG_THREADS 256

__global__ void __launch_bounds__(SEG_THREADS)
segment_sum_kernel(const float* __restrict__ points, const int* __restrict__ start,
                   const int* __restrict__ length, int N, int cap, float* __restrict__ out) {
  const int b = blockIdx.y;
  const int s = blockIdx.x * SEG_THREADS + threadIdx.x;
  if (s >= cap) return;
  const size_t seg = (size_t)b * cap + s;
  const int first = start[seg];
  const int n = length[seg];
  const float* p = points + ((size_t)b * N + first) * 3;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  int j = 0;
  for (; j + 4 <= n; j += 4) {
    float r[12];
#pragma unroll
    for (int t = 0; t < 12; ++t) r[t] = __ldg(p + 3 * j + t);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      x = __fadd_rn(x, r[3 * t]);
      y = __fadd_rn(y, r[3 * t + 1]);
      z = __fadd_rn(z, r[3 * t + 2]);
    }
  }
  for (; j < n; ++j) {
    x = __fadd_rn(x, __ldg(p + 3 * j));
    y = __fadd_rn(y, __ldg(p + 3 * j + 1));
    z = __fadd_rn(z, __ldg(p + 3 * j + 2));
  }
  out[seg * 3] = x;
  out[seg * 3 + 1] = y;
  out[seg * 3 + 2] = z;
}

// points (B, N, 3) float32 sorted by segment; start, length (B, cap) int32
// (a segment of length 0 is not read); out (B, cap, 3) float32; all
// contiguous. Returns cudaGetLastError() after the launch.
extern "C" int segment_sum_launch(const float* points, const int* start, const int* length,
                                  int B, int N, int cap, float* out, void* stream) {
  if (B < 0 || N < 0 || cap < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || cap == 0) return 0;
  dim3 grid((cap + SEG_THREADS - 1) / SEG_THREADS, B);
  segment_sum_kernel<<<grid, SEG_THREADS, 0, (cudaStream_t)stream>>>(points, start, length, N,
                                                                      cap, out);
  return (int)cudaGetLastError();
}
