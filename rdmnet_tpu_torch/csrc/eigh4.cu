// Top eigenvector of a batch of symmetric 4 x 4 matrices, for Hopper
// (sm_90a): Horn's quaternion step of the pose solver.
//
// Replaces no TPU kernel: the JAX package's Horn solver calls
// jnp.linalg.eigh on the device (rdmnet_tpu/ops/procrustes.py:49), which
// XLA lowers without Pallas. The port's plain version is
// torch.linalg.eigh (ops/kernels/eigh4.py, top_eigenvector_plain), which on
// CUDA waits for the host (cuSOLVER's info check), and LGR solves 2 +
// num_refinement_steps batches a pair; this kernel takes its place on the
// card so that the pose needs no host round trip and can be captured in a
// CUDA graph. The CPU keeps torch.linalg.eigh.
//
// What it computes: for each symmetric K (its lower triangle read, as
// torch.linalg.eigh reads it), the unit eigenvector of its largest
// eigenvalue, by cyclic Jacobi in float32: sweeps over the six (p, q)
// pairs, each rotation (Golub and Van Loan's symmetric Schur step) zeroing
// a_pq and accumulated into V, until a sweep finds no off-diagonal entry
// above 2^-27 of K's Frobenius norm (at most JACOBI_SWEEPS sweeps). A
// rotation moves the other off-diagonal entries only by their own rounding,
// so they fall to zero quadratically (4-6 sweeps). The vector is defined up
// to its sign, and where the top two eigenvalues lie close only to within
// float32 rounding over the gap; callers compare through the rotation.
//
// What bounds it: latency. A matrix is 64 bytes in and 16 out, ~50 float
// operations a rotation; LGR's largest batch is its P = 256 hypotheses.
//
// Design: one thread per matrix, K and V in registers (every index is a
// compile-time constant: the sweep is unrolled over the six pairs), no
// shared memory, 128 threads a block.

#include <cuda_runtime.h>

#define EIGH4_THREADS 128
#define JACOBI_SWEEPS 16

template <int P, int Q>
__device__ __forceinline__ bool jacobi_rotate(float (&a)[4][4], float (&v)[4][4], float tol) {
  const float apq = a[P][Q];
  if (!(fabsf(apq) > tol)) return false;
  const float app = a[P][P], aqq = a[Q][Q];
  const float tau = (aqq - app) / (2.0f * apq);
  // the smaller root of t^2 + 2 tau t - 1 = 0: |t| <= 1, the rotation <= 45 degrees
  const float t = (tau >= 0.0f ? 1.0f : -1.0f) / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  const float c = 1.0f / sqrtf(1.0f + t * t);
  const float s = t * c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k == P || k == Q) continue;
    const float akp = a[k][P], akq = a[k][Q];
    a[k][P] = a[P][k] = c * akp - s * akq;
    a[k][Q] = a[Q][k] = s * akp + c * akq;
  }
  a[P][P] = app - t * apq;
  a[Q][Q] = aqq + t * apq;
  a[P][Q] = a[Q][P] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float vkp = v[k][P], vkq = v[k][Q];
    v[k][P] = c * vkp - s * vkq;
    v[k][Q] = s * vkp + c * vkq;
  }
  return true;
}

__global__ void __launch_bounds__(EIGH4_THREADS)
eigh4_top_kernel(const float* __restrict__ mats, int n, float* __restrict__ out) {
  const int m = blockIdx.x * EIGH4_THREADS + threadIdx.x;
  if (m >= n) return;
  const float* k = mats + (size_t)m * 16;
  float a[4][4], v[4][4];
  float norm2 = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float x = k[i * 4 + j];  // lower triangle
      a[i][j] = a[j][i] = x;
      norm2 += (i == j ? 1.0f : 2.0f) * x * x;
      v[i][j] = v[j][i] = (i == j) ? 1.0f : 0.0f;
    }
  }
  const float tol = 7.450580596923828e-09f * sqrtf(norm2);  // 2^-27 ||K||_F
  for (int sweep = 0; sweep < JACOBI_SWEEPS; ++sweep) {
    bool turned = jacobi_rotate<0, 1>(a, v, tol);
    turned |= jacobi_rotate<0, 2>(a, v, tol);
    turned |= jacobi_rotate<0, 3>(a, v, tol);
    turned |= jacobi_rotate<1, 2>(a, v, tol);
    turned |= jacobi_rotate<1, 3>(a, v, tol);
    turned |= jacobi_rotate<2, 3>(a, v, tol);
    if (!turned) break;
  }
  // the largest eigenvalue's column of V, normalised
  float best = a[0][0], q0 = v[0][0], q1 = v[1][0], q2 = v[2][0], q3 = v[3][0];
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    if (a[j][j] > best) {
      best = a[j][j];
      q0 = v[0][j];
      q1 = v[1][j];
      q2 = v[2][j];
      q3 = v[3][j];
    }
  }
  const float inv = 1.0f / sqrtf(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3);
  float* o = out + (size_t)m * 4;
  o[0] = q0 * inv;
  o[1] = q1 * inv;
  o[2] = q2 * inv;
  o[3] = q3 * inv;
}

// mats (n, 4, 4) float32 symmetric (the lower triangle is read); out (n, 4)
// float32; both contiguous. Returns cudaGetLastError() after the launch.
extern "C" int eigh4_top_launch(const float* mats, int n, float* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  eigh4_top_kernel<<<(n + EIGH4_THREADS - 1) / EIGH4_THREADS, EIGH4_THREADS, 0,
                     (cudaStream_t)stream>>>(mats, n, out);
  return (int)cudaGetLastError();
}
