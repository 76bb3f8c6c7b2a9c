// One box-eliminating polish candidate solve: one block per scenario.
//
// Replaces neupan_tpu/ops/pallas/polish.py:box_candidate
// (_box_candidate_kernel + _spd_inv_inline). The reduced Hessians Hr and
// Hr_true (k x k) and the normalized acceleration rows DAn (na x k) are read
// once into shared memory. In shared memory the kernel then forms the
// masked Hessian and its inverse, the dual Schur complement over the acc
// rows and its inverse (both inverses through the sweep device function
// after Jacobi scaling and a 1e-7 ridge), one KKT solve and `refine`
// reduced-space refinement passes with w and yn held in shared memory.
// See ops/kernels/polish.py for the bound and the design note.
#include "common.cuh"
#include "sweep.cuh"

namespace {

constexpr int kThreads = 128;

// out[i] = sum_j A[j, i] v[j] for a symmetric (n, n) A: threads read
// neighbouring columns of one row together.
__device__ inline void symv(float* out, const float* A, const float* v, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) acc += A[j * n + i] * v[j];
    out[i] = acc;
  }
  __syncthreads();
}

// out[r] = sum_c A[r, c] v[c] for an (rows, cols) A.
__device__ inline void gemv(float* out, const float* A, const float* v, int rows, int cols) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    float acc = 0.0f;
    for (int c = 0; c < cols; ++c) acc += A[r * cols + c] * v[c];
    out[r] = acc;
  }
  __syncthreads();
}

// out[c] = sum_r A[r, c] u[r] for an (rows, cols) A.
__device__ inline void gemv_t(float* out, const float* A, const float* u, int rows, int cols) {
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r) acc += A[r * cols + c] * u[r];
    out[c] = acc;
  }
  __syncthreads();
}

// In-place inverse of the SPD (n, n) matrix M: Jacobi scaling with
// 1/sqrt(|diag|) (correctly rounded, not rsqrtf), a 1e-7 ridge, the sweep,
// and the unscaling.
__device__ inline void spd_inverse_inplace(float* M, float* dj, float* row, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    dj[i] = 1.0f / sqrtf(fabsf(M[i * n + i]) + 1e-30f);
  __syncthreads();
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int r = e / n, c = e - r * n;
    const float v = __fmul_rn(__fmul_rn(M[e], dj[r]), dj[c]);
    M[e] = r == c ? __fadd_rn(v, 1e-7f) : v;
  }
  __syncthreads();
  sweep_inverse_inplace(M, row, n);
  for (int e = threadIdx.x; e < n * n; e += kThreads) {
    const int r = e / n, c = e - r * n;
    M[e] = __fmul_rn(__fmul_rn(M[e], dj[r]), dj[c]);
  }
  __syncthreads();
}

struct Smem {
  float *hr, *ht, *dan, *hinv, *hd, *s, *c0, *g1r, *bbox, *fix, *free_, *g2n, *d,
      *w, *yn, *t1, *t2, *t3, *u1, *u2, *dj, *row;
};

// dw = dw0 - Hm^{-1} (free * DAn' dyn), dyn = S^{-1}(DAn dw0 - r2n), with
// dw0 = Hm^{-1} (free * (r1 - Hr (fix * r_fix)) + fix * r_fix).
// r1, r_fix (k) and r2n (na) are inputs; dw lands in t1, dyn in u1.
__device__ inline void kkt_solve(const Smem& s, const float* r1, const float* r_fix,
                                 const float* r2n, int k, int na) {
  for (int i = threadIdx.x; i < k; i += kThreads) s.t3[i] = s.fix[i] * r_fix[i];
  __syncthreads();
  symv(s.t2, s.hr, s.t3, k);                        // Hr (fix * r_fix)
  for (int i = threadIdx.x; i < k; i += kThreads)
    s.t3[i] = s.free_[i] * (r1[i] - s.t2[i]) + s.fix[i] * r_fix[i];
  __syncthreads();
  symv(s.t1, s.hinv, s.t3, k);                      // dw0
  gemv(s.u2, s.dan, s.t1, na, k);                   // DAn dw0
  for (int i = threadIdx.x; i < na; i += kThreads) s.u2[i] = s.u2[i] - r2n[i];
  __syncthreads();
  symv(s.u1, s.s, s.u2, na);                        // dyn
  gemv_t(s.t2, s.dan, s.u1, na, k);                 // DAn' dyn
  for (int i = threadIdx.x; i < k; i += kThreads) s.t2[i] = s.free_[i] * s.t2[i];
  __syncthreads();
  symv(s.t3, s.hinv, s.t2, k);
  for (int i = threadIdx.x; i < k; i += kThreads) s.t1[i] = s.t1[i] - s.t3[i];
  __syncthreads();
}

__global__ void box_candidate_kernel(
    const float* __restrict__ Hr, const float* __restrict__ Hr_true,
    const float* __restrict__ DAn, const float* __restrict__ C0,
    const float* __restrict__ g1r, const float* __restrict__ g2n,
    const float* __restrict__ b_box, const float* __restrict__ fix,
    const float* __restrict__ d, float* __restrict__ w_out,
    float* __restrict__ yn_out, int k, int na, int refine) {
  extern __shared__ float sm[];
  const int nm = k > na ? k : na;
  Smem s;
  float* p = sm;
  s.hr = p; p += k * k;
  s.ht = p; p += k * k;
  s.hinv = p; p += k * k;
  s.dan = p; p += na * k;
  s.hd = p; p += na * k;
  s.s = p; p += na * na;
  s.c0 = p; p += k;
  s.g1r = p; p += k;
  s.bbox = p; p += k;
  s.fix = p; p += k;
  s.free_ = p; p += k;
  s.w = p; p += k;
  s.t1 = p; p += k;
  s.t2 = p; p += k;
  s.t3 = p; p += k;
  s.g2n = p; p += na;
  s.d = p; p += na;
  s.yn = p; p += na;
  s.u1 = p; p += na;
  s.u2 = p; p += na;
  s.dj = p; p += nm;
  s.row = p;

  const int b = blockIdx.x;
  const size_t bkk = static_cast<size_t>(b) * k * k;
  const size_t bak = static_cast<size_t>(b) * na * k;
  for (int e = threadIdx.x; e < k * k; e += kThreads) {
    s.hr[e] = Hr[bkk + e];
    s.ht[e] = Hr_true[bkk + e];
  }
  for (int e = threadIdx.x; e < na * k; e += kThreads) s.dan[e] = DAn[bak + e];
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const size_t g = static_cast<size_t>(b) * k + i;
    s.c0[i] = C0[g];
    s.g1r[i] = g1r[g];
    s.bbox[i] = b_box[g];
    s.fix[i] = fix[g];
    s.free_[i] = 1.0f - fix[g];
  }
  for (int i = threadIdx.x; i < na; i += kThreads) {
    const size_t g = static_cast<size_t>(b) * na + i;
    s.g2n[i] = g2n[g];
    s.d[i] = d[g];
  }
  __syncthreads();

  // masked Hessian: identity row/column at the pinned coordinates
  for (int e = threadIdx.x; e < k * k; e += kThreads) {
    const int r = e / k, c = e - r * k;
    const float v = __fmul_rn(__fmul_rn(s.hr[e], s.free_[r]), s.free_[c]);
    s.hinv[e] = r == c ? __fadd_rn(v, s.fix[r]) : v;
  }
  __syncthreads();
  spd_inverse_inplace(s.hinv, s.dj, s.row, k);

  // dual Schur complement over the acc rows: DAn Hm^{-1} DAn' + diag(1-d) + 1e-6
  for (int e = threadIdx.x; e < na * k; e += kThreads) {
    const int r = e / k, i = e - r * k;
    float acc = 0.0f;  // (Hm^{-1} DAn[r]')_i
    for (int j = 0; j < k; ++j) acc += s.hinv[j * k + i] * s.dan[r * k + j];
    s.hd[e] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < na * na; e += kThreads) {
    const int r = e / na, c = e - r * na;
    float acc = 0.0f;
    for (int i = 0; i < k; ++i) acc += s.dan[c * k + i] * s.hd[r * k + i];
    s.s[e] = r == c ? acc + ((1.0f - s.d[r]) + 1e-6f) : acc;
  }
  __syncthreads();
  spd_inverse_inplace(s.s, s.dj, s.row, na);

  kkt_solve(s, s.g1r, s.bbox, s.g2n, k, na);
  for (int i = threadIdx.x; i < k; i += kThreads) s.w[i] = s.t1[i];
  for (int i = threadIdx.x; i < na; i += kThreads) s.yn[i] = s.u1[i];
  __syncthreads();

  // the refinement right-hand sides reuse the sweep's scratch row (3 * nm
  // floats), which kkt_solve does not touch
  float* r1 = s.row;
  float* r_fix = s.row + nm;
  float* r2n = s.row + 2 * nm;
  for (int it = 0; it < refine; ++it) {
    symv(s.t1, s.ht, s.w, k);                        // Hr_true w
    for (int i = threadIdx.x; i < na; i += kThreads) s.u1[i] = s.d[i] * s.yn[i];
    __syncthreads();
    gemv_t(s.t2, s.dan, s.u1, na, k);                // DAn' (d * yn)
    gemv(s.u2, s.dan, s.w, na, k);                   // DAn w
    for (int i = threadIdx.x; i < k; i += kThreads) {
      r1[i] = (s.c0[i] - s.t1[i]) - s.t2[i];
      r_fix[i] = s.fix[i] * (s.bbox[i] - s.w[i]);
    }
    for (int i = threadIdx.x; i < na; i += kThreads)
      r2n[i] = s.g2n[i] - (s.u2[i] + (1.0f - s.d[i]) * s.yn[i]);
    __syncthreads();
    kkt_solve(s, r1, r_fix, r2n, k, na);
    for (int i = threadIdx.x; i < k; i += kThreads) s.w[i] = s.w[i] + s.t1[i];
    for (int i = threadIdx.x; i < na; i += kThreads) s.yn[i] = s.yn[i] + s.u1[i];
    __syncthreads();
  }

  for (int i = threadIdx.x; i < k; i += kThreads) w_out[static_cast<size_t>(b) * k + i] = s.w[i];
  for (int i = threadIdx.x; i < na; i += kThreads)
    yn_out[static_cast<size_t>(b) * na + i] = s.yn[i];
}

}  // namespace

static size_t polish_smem_bytes(int k, int na) {
  const int nm = k > na ? k : na;
  return static_cast<size_t>(3 * k * k + 2 * na * k + na * na + 9 * k + 5 * na + 4 * nm) *
         sizeof(float);
}

extern "C" int box_candidate_launch(
    const void* Hr, const void* Hr_true, const void* DAn, const void* C0, const void* g1r,
    const void* g2n, const void* b_box, const void* fix, const void* d, void* w, void* yn,
    int B, int k, int na, int refine, void* stream) {
  const size_t smem = polish_smem_bytes(k, na);
  cudaError_t err = neupan_allow_smem(box_candidate_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  box_candidate_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Hr), static_cast<const float*>(Hr_true),
      static_cast<const float*>(DAn), static_cast<const float*>(C0),
      static_cast<const float*>(g1r), static_cast<const float*>(g2n),
      static_cast<const float*>(b_box), static_cast<const float*>(fix),
      static_cast<const float*>(d), static_cast<float*>(w), static_cast<float*>(yn), k,
      na, refine);
  return static_cast<int>(cudaGetLastError());
}
