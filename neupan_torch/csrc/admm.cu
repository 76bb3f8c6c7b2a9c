// A fixed count of condensed-ADMM iterations: one block per scenario.
//
// Replaces neupan_tpu/ops/pallas/admm.py:admm_iterate. The scenario's
// scaled constraint operator As (m x k, 17.8 KB at T=10) and the
// normal-matrix inverse Minv (k x k) are read from device memory once into
// shared memory; w, z and y stay in shared memory across all iterations,
// and only the final iterate is written back. Per iteration:
//   t = rho z - y;  w~ = Minv (sigma w - q + As' t);  z~ = As w~;
//   alpha-relaxation; z-prox (clip, plus the one-sided soft penalty);
//   y += rho (z_mix - z_new).
// See ops/kernels/admm.py for the bound and the design note.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void admm_kernel(
    const float* __restrict__ Minv, const float* __restrict__ As,
    const float* __restrict__ qs, const float* __restrict__ ls,
    const float* __restrict__ us, const float* __restrict__ soft,
    const float* __restrict__ rho, const float* __restrict__ w0,
    const float* __restrict__ z0, const float* __restrict__ y0,
    float* __restrict__ w_out, float* __restrict__ z_out, float* __restrict__ y_out,
    int k, int m, int iters, float sigma, float alpha, float one_m_alpha) {
  extern __shared__ float sm[];
  float* sA = sm;               // m * k, row-major (m, k)
  float* sMinv = sA + m * k;    // k * k (symmetric)
  float* sq = sMinv + k * k;    // k
  float* sw = sq + k;           // k
  float* srhs = sw + k;         // k
  float* swt = srhs + k;        // k
  float* sl = swt + k;          // m
  float* su = sl + m;           // m
  float* srho = su + m;         // m
  float* sinv = srho + m;       // m: 1 / rho
  float* sfac = sinv + m;       // m: rho / (rho + soft)
  float* ssoft = sfac + m;      // m
  float* sz = ssoft + m;        // m
  float* sy = sz + m;           // m
  float* st = sy + m;           // m: rho z - y

  const int b = blockIdx.x;
  const float* Ab = As + static_cast<size_t>(b) * m * k;
  const float* Mb = Minv + static_cast<size_t>(b) * k * k;
  for (int e = threadIdx.x; e < m * k; e += kThreads) sA[e] = Ab[e];
  for (int e = threadIdx.x; e < k * k; e += kThreads) sMinv[e] = Mb[e];
  for (int i = threadIdx.x; i < k; i += kThreads) {
    sq[i] = qs[b * k + i];
    sw[i] = w0[b * k + i];
  }
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const size_t g = static_cast<size_t>(b) * m + i;
    const float r = rho[g];
    sl[i] = ls[g];
    su[i] = us[g];
    srho[i] = r;
    sinv[i] = 1.0f / r;
    ssoft[i] = soft[g];
    sfac[i] = r / (r + soft[g]);
    sz[i] = z0[g];
    sy[i] = y0[g];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int it = 0; it < iters; ++it) {
    for (int i = threadIdx.x; i < m; i += kThreads) st[i] = srho[i] * sz[i] - sy[i];
    __syncthreads();
    // rhs = sigma w - q + As' t: one warp per output, lanes stride over m
    for (int c = warp; c < k; c += kWarps) {
      float acc = 0.0f;
      for (int i = lane; i < m; i += 32) acc += sA[i * k + c] * st[i];
      acc = warp_sum(acc);
      if (lane == 0) srhs[c] = (sigma * sw[c] - sq[c]) + acc;
    }
    __syncthreads();
    // w~ = Minv rhs
    for (int r = threadIdx.x; r < k; r += kThreads) {
      float acc = 0.0f;
      for (int c = 0; c < k; ++c) acc += sMinv[c * k + r] * srhs[c];
      swt[r] = acc;
    }
    __syncthreads();
    // z~ = As w~, then the relaxation, prox and dual update of the same row
    for (int i = threadIdx.x; i < m; i += kThreads) {
      float zt = 0.0f;
      for (int c = 0; c < k; ++c) zt += sA[i * k + c] * swt[c];
      const float z = sz[i], y = sy[i];
      const float z_mix = alpha * zt + one_m_alpha * z;
      const float v = z_mix + y * sinv[i];
      const float lo = sl[i], hi = su[i];
      float z_new = fminf(fmaxf(v, lo), hi);
      if (ssoft[i] > 0.0f) {
        const float z_sf = v >= lo ? v : lo + (v - lo) * sfac[i];
        z_new = fminf(z_sf, hi);
      }
      sz[i] = z_new;
      sy[i] = y + srho[i] * (z_mix - z_new);
    }
    for (int c = threadIdx.x; c < k; c += kThreads)
      sw[c] = alpha * swt[c] + one_m_alpha * sw[c];
    __syncthreads();
  }

  for (int i = threadIdx.x; i < k; i += kThreads) w_out[b * k + i] = sw[i];
  for (int i = threadIdx.x; i < m; i += kThreads) {
    z_out[static_cast<size_t>(b) * m + i] = sz[i];
    y_out[static_cast<size_t>(b) * m + i] = sy[i];
  }
}

}  // namespace

static size_t admm_smem_bytes(int k, int m) {
  return static_cast<size_t>(m * k + k * k + 4 * k + 9 * m) * sizeof(float);
}

extern "C" int admm_iterate_launch(
    const void* Minv, const void* As, const void* qs, const void* ls, const void* us,
    const void* soft, const void* rho, const void* w0, const void* z0, const void* y0,
    void* w, void* z, void* y, int B, int k, int m, int iters, float sigma,
    float alpha, float one_m_alpha, void* stream) {
  const size_t smem = admm_smem_bytes(k, m);
  cudaError_t err = neupan_allow_smem(admm_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  admm_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Minv), static_cast<const float*>(As),
      static_cast<const float*>(qs), static_cast<const float*>(ls),
      static_cast<const float*>(us), static_cast<const float*>(soft),
      static_cast<const float*>(rho), static_cast<const float*>(w0),
      static_cast<const float*>(z0), static_cast<const float*>(y0),
      static_cast<float*>(w), static_cast<float*>(z), static_cast<float*>(y),
      k, m, iters, sigma, alpha, one_m_alpha);
  return static_cast<int>(cudaGetLastError());
}
