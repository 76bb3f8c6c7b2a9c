// Symmetric sweep-operator inverse of an SPD matrix held in shared memory.
//
// Device function of the sweep kernel (sweep.cu); the polish kernel
// (polish.cu) runs the same arithmetic on register-held elements. Sweeping
// pivot j of a symmetric matrix keeps it symmetric (b_jj = -1/d,
// b_jk = a_jk/d, b_ik = a_ik - a_ij a_jk/d), so column j is read as row j
// and no transposed copy is needed; after all n pivots the buffer holds
// -A^{-1}, which the last pass negates. No pivoting: the callers
// Jacobi-scale and ridge the input, so every pivot is positive and bounded
// away from zero.
//
// The arithmetic is written with round-to-nearest intrinsics (no FMA
// contraction) and a correctly rounded reciprocal, so the result equals
// the plain PyTorch version (ops/kernels/sweep.py) operation for
// operation.
#pragma once

#include <cuda_runtime.h>

// A: n*n floats, row-major, in shared memory. row: n floats of scratch in
// shared memory. All threads of the block must call it.
__device__ inline void sweep_inverse_inplace(float* A, float* row, int n) {
  const int nn = n * n;
  for (int j = 0; j < n; ++j) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) row[i] = A[j * n + i];
    __syncthreads();
    const float inv_d = __frcp_rn(row[j]);
    for (int e = threadIdx.x; e < nn; e += blockDim.x) {
      const int r = e / n;
      const int c = e - r * n;
      float v;
      if (r == j && c == j) {
        v = -inv_d;
      } else if (r == j) {
        v = __fmul_rn(row[c], inv_d);
      } else if (c == j) {
        v = __fmul_rn(row[r], inv_d);
      } else {
        v = __fsub_rn(A[e], __fmul_rn(row[r], __fmul_rn(row[c], inv_d)));
      }
      A[e] = v;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < nn; e += blockDim.x) A[e] = -A[e];
  __syncthreads();
}
