// The symmetric sweep operator's arithmetic, shared by the sweep kernels
// (sweep.cu); the polish kernel (polish.cu) runs the same arithmetic in its
// own register layout.
//
// Sweeping pivot j of a symmetric matrix keeps it symmetric (b_jj = -1/d,
// b_jk = a_jk/d, b_ik = a_ik - a_ij a_jk/d), so column j is read as row j
// and no transposed copy is needed; after all n pivots the matrix holds
// -A^{-1}. No pivoting: the caller Jacobi-scales and ridges the input, so
// every pivot is positive and bounded away from zero.
//
// Every operation is a round-to-nearest intrinsic (no FMA contraction) and
// the reciprocal, square root and division are correctly rounded, so the
// kernels equal the plain PyTorch versions (ops/kernels/sweep.py)
// operation for operation.
#pragma once

#include <cuda_runtime.h>

// Element (r, c) after sweeping pivot j. a_rc: its old value; a_jr: the
// pivot row at column r; t = a_jc / d (the pivot row at column c, scaled);
// inv_d = 1 / d. on_row: r == j; on_col: c == j.
__device__ __forceinline__ float sweep_update(float a_rc, float a_jr, float t, float inv_d,
                                              bool on_row, bool on_col) {
  const float downdate = __fsub_rn(a_rc, __fmul_rn(a_jr, t));
  const float col = __fmul_rn(a_jr, inv_d);
  return on_row ? (on_col ? -inv_d : t) : (on_col ? col : downdate);
}

// Jacobi scale of row and column i, 1 / sqrt(|m_ii| + 1e-30).
__device__ __forceinline__ float sweep_jacobi(float m_ii) {
  return __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(fabsf(m_ii), 1e-30f)));
}

// The scaled, ridged element fed to the sweep: (m d_r) d_c, + 1e-7 on the
// diagonal (+ 0 elsewhere, as the plain version adds 1e-7 I).
__device__ __forceinline__ float sweep_scale_in(float m, float d_r, float d_c, bool diag) {
  return __fadd_rn(__fmul_rn(__fmul_rn(m, d_r), d_c), diag ? 1e-7f : 0.0f);
}

// The inverse's element from the swept one (-A^{-1}): (-a d_r) d_c.
__device__ __forceinline__ float sweep_scale_out(float a, float d_r, float d_c) {
  return __fmul_rn(__fmul_rn(-a, d_r), d_c);
}
