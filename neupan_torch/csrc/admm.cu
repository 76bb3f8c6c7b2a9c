// A fixed count of condensed-ADMM iterations: one block per scenario.
//
// Replaces neupan_tpu/ops/pallas/admm.py:admm_iterate. Per iteration:
//   t = rho z - y;  w~ = Minv (sigma w - q + As' t);  z~ = As w~;
//   alpha-relaxation; z-prox (clip, plus the one-sided soft penalty);
//   y += rho (z_mix - z_new).
// Only the final w, z, y are written back.
//
// Bound on the H100: neither bytes nor operations but the dependent chain
// of each iteration (~22 kFLOP per scenario at k=30, m=148). Layout, with
// the rows of As cut into tiles of 32 and the columns into chunks of 32:
//   * lane c of the warp that owns a row tile holds column c of it; lane r
//     holds the state of row r of the tile (z, y, bounds, rho);
//   * phase A, As' t: each lane accumulates its column over the tile's rows
//     (t read as shared-memory broadcasts, four partial sums), and writes
//     one partial per warp;                                     __syncthreads
//   * phase B, Minv rhs: warp g sums the partials of rhs and computes the
//     outputs 8g..8g+7 with one reduce-scatter (9 shuffles);    __syncthreads
//   * phase C, As w~: every warp reads w~ and updates w; lane r sums row r
//     of its tile against w~ (float4 broadcasts, four partial sums), runs
//     the prox and dual update of row r and writes t.
// Two barriers per iteration; no thread runs a chain longer than 8 FMAs on
// one accumulator. Registers (nvcc -Xptxas -v, sm_90a): admm_regs_kernel
// 80, the shared-memory instances 62-64, none spilled. No tensor cores: every product is a matrix times one
// vector, and the port keeps float32 (TF32 off).
//
// Two instances, picked by the launcher:
//   * admm_regs_kernel (k <= 32, m <= 224, the main path): the tile of As
//     by column (phase A), the Minv rows of the warp's output group and the
//     row state live in registers; shared memory holds t, the partials, w~
//     and the tile by row for phase C (stride 33: lane r reads row r with
//     no bank conflict), ~22 KB at m=148.
//   * admm_smem_kernel<NC> (everything else the wrapper admits, e.g. T=30's
//     k=90, m=451): the same phases and barriers with As, Minv and the row
//     state in shared memory, read conflict-free; NC is the number of
//     32-column chunks (1-3 unrolled; 0 = a runtime count for k > 96).
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
// the register instance: at most 7 warps, 3 blocks of them per SM (<= 85
// registers a thread; 4 blocks of the main path's 5 warps fit as well)
constexpr int kRegWarps = 7;

__global__ void __launch_bounds__(32 * kRegWarps, 3) admm_regs_kernel(
    const float* __restrict__ Minv, const float* __restrict__ As,
    const float* __restrict__ qs, const float* __restrict__ ls,
    const float* __restrict__ us, const float* __restrict__ soft,
    const float* __restrict__ rho, const float* __restrict__ w0,
    const float* __restrict__ z0, const float* __restrict__ y0,
    float* __restrict__ w_out, float* __restrict__ z_out, float* __restrict__ y_out,
    int k, int m, int iters, float sigma, float alpha, float one_m_alpha) {
  extern __shared__ float sm[];
  const int n_tiles = (m + 31) / 32, n_groups = (k + 7) / 8;
  float* st = sm;                        // 32 * n_tiles: t, zero past m
  float* spart = st + 32 * n_tiles;      // 32 * n_tiles: As' t partials
  float* swt = spart + 32 * n_tiles;     // 32: w~, zero past k

  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool has_tile = warp < n_tiles, has_group = warp < n_groups;
  const size_t bm = static_cast<size_t>(b) * m, bk = static_cast<size_t>(b) * k;

  // the tile of As twice: by column in registers (lane c: column c), by row
  // in shared memory (lane r: row r)
  float a[32];
  const float* Ab = As + bm * k;
  const int my_row = warp * 32 + lane;
  const bool valid = has_tile && my_row < m;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int row = warp * 32 + r;
    a[r] = (has_tile && row < m && lane < k) ? Ab[static_cast<size_t>(row) * k + lane] : 0.0f;
  }
  float* sar = sm + 64 * n_tiles + 32;   // rows of As, stride 33
  if (has_tile) {
#pragma unroll
    for (int c = 0; c < 32; ++c)
      sar[my_row * 33 + c] = (valid && c < k) ? Ab[static_cast<size_t>(my_row) * k + c] : 0.0f;
  }
  // rows 8g..8g+7 of Minv (symmetric: row o is column o), lane c column c
  float mv[8];
  const float* Mb = Minv + bk * k;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int o = warp * 8 + v;
    mv[v] = (has_group && o < k && lane < k) ? Mb[static_cast<size_t>(o) * k + lane] : 0.0f;
  }
  float wl = lane < k ? w0[bk + lane] : 0.0f;   // every warp keeps w, q
  const float ql = lane < k ? qs[bk + lane] : 0.0f;

  // row state of lane r: row warp * 32 + r
  float z = 0.0f, y = 0.0f, lo = 0.0f, hi = 0.0f, r_ = 1.0f, inv = 1.0f, fac = 1.0f;
  bool is_soft = false;
  if (valid) {
    const size_t g = bm + my_row;
    r_ = rho[g];
    z = z0[g];
    y = y0[g];
    lo = ls[g];
    hi = us[g];
    inv = 1.0f / r_;
    fac = r_ / (r_ + soft[g]);
    is_soft = soft[g] > 0.0f;
  }
  if (has_tile) st[my_row] = valid ? r_ * z - y : 0.0f;
  if (warp == 0) swt[lane] = 0.0f;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // A: partial As' t over this warp's tile
    if (has_tile) {
      const float4* t4 = reinterpret_cast<const float4*>(st + warp * 32);
      float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 t = t4[q];
        acc0 += a[4 * q] * t.x;
        acc1 += a[4 * q + 1] * t.y;
        acc2 += a[4 * q + 2] * t.z;
        acc3 += a[4 * q + 3] * t.w;
      }
      spart[warp * 32 + lane] = (acc0 + acc1) + (acc2 + acc3);
    }
    __syncthreads();
    // B: rhs in lane c, then w~[8g..8g+7] by one reduce-scatter
    if (has_group) {
      float at = 0.0f;
      for (int w = 0; w < n_tiles; ++w) at += spart[w * 32 + lane];
      const float rhs = (sigma * wl - ql) + at;
      float p[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) p[v] = mv[v] * rhs;
      const float wt = warp_reduce_scatter<8>(p, lane);
      const int o = warp * 8 + (lane >> 2);
      if ((lane & 3) == 0 && o < k) swt[o] = wt;
    }
    __syncthreads();
    // C: w update, z~ = As w~, prox and dual update of lane r's row
    const float wt = swt[lane];
    wl = alpha * wt + one_m_alpha * wl;
    if (has_tile) {
      const float4* w4 = reinterpret_cast<const float4*>(swt);
      float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 v = w4[q];
        const float* ar = sar + my_row * 33 + 4 * q;
        acc0 += ar[0] * v.x;
        acc1 += ar[1] * v.y;
        acc2 += ar[2] * v.z;
        acc3 += ar[3] * v.w;
      }
      const float zt = (acc0 + acc1) + (acc2 + acc3);
      if (valid) {
        const float z_mix = alpha * zt + one_m_alpha * z;
        const float v = z_mix + y * inv;
        float z_new = fminf(fmaxf(v, lo), hi);
        if (is_soft) z_new = fminf(v >= lo ? v : lo + (v - lo) * fac, hi);
        y = y + r_ * (z_mix - z_new);
        z = z_new;
        st[my_row] = r_ * z - y;
      }
      __syncwarp(kFull);
    }
  }

  if (warp == 0 && lane < k) w_out[bk + lane] = wl;
  if (valid) {
    z_out[bm + my_row] = z;
    y_out[bm + my_row] = y;
  }
}

// NC 32-column chunks (0: a runtime count). Shared memory (floats):
// As m*k, Minv k*k, w, q, w~ k each, the partials n_warps*k, and per row
// l, u, rho, 1/rho, fac (negative on hard rows), z, y, t.
template <int NC>
__global__ void __launch_bounds__(32 * kMaxWarps) admm_smem_kernel(
    const float* __restrict__ Minv, const float* __restrict__ As,
    const float* __restrict__ qs, const float* __restrict__ ls,
    const float* __restrict__ us, const float* __restrict__ soft,
    const float* __restrict__ rho, const float* __restrict__ w0,
    const float* __restrict__ z0, const float* __restrict__ y0,
    float* __restrict__ w_out, float* __restrict__ z_out, float* __restrict__ y_out,
    int k, int m, int iters, float sigma, float alpha, float one_m_alpha) {
  extern __shared__ float sm[];
  const int n_warps = blockDim.x >> 5;
  const int nc = NC > 0 ? NC : (k + 31) / 32;
  const int n_tiles = (m + 31) / 32, n_groups = (k + 7) / 8;
  const int n_part = n_tiles < n_warps ? n_tiles : n_warps;
  float* sA = sm;
  float* sM = sA + m * k;
  float* sw = sM + k * k;
  float* sq = sw + k;
  float* swt = sq + k;
  float* spart = swt + k;
  float* sl = spart + n_warps * k;
  float* su = sl + m;
  float* srho = su + m;
  float* sinv = srho + m;
  float* sfac = sinv + m;
  float* sz = sfac + m;
  float* sy = sz + m;
  float* st = sy + m;

  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t bm = static_cast<size_t>(b) * m, bk = static_cast<size_t>(b) * k;
  for (int e = threadIdx.x; e < m * k; e += blockDim.x) sA[e] = As[bm * k + e];
  for (int e = threadIdx.x; e < k * k; e += blockDim.x) sM[e] = Minv[bk * k + e];
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    sw[i] = w0[bk + i];
    sq[i] = qs[bk + i];
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const size_t g = bm + i;
    const float r = rho[g];
    sl[i] = ls[g];
    su[i] = us[g];
    srho[i] = r;
    sinv[i] = 1.0f / r;
    sfac[i] = soft[g] > 0.0f ? r / (r + soft[g]) : -1.0f;
    sz[i] = z0[g];
    sy[i] = y0[g];
    st[i] = r * z0[g] - y0[g];
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // A: partial As' t over this warp's tiles, one column per lane
    if (warp < n_part) {
#pragma unroll
      for (int ch = 0; ch < nc; ++ch) {
        const int col = ch * 32 + lane;
        if (col < k) {
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int tile = warp; tile < n_tiles; tile += n_warps) {
            const int base = tile * 32, rows = m - base < 32 ? m - base : 32;
            for (int r0 = 0; r0 < rows; r0 += 4) {
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int r = base + r0 + u;
                if (r0 + u < rows) acc[u] += sA[r * k + col] * st[r];
              }
            }
          }
          spart[warp * k + col] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        }
      }
    }
    __syncthreads();
    // B: w~ by groups of 8 outputs, one reduce-scatter each
    for (int g = warp; g < n_groups; g += n_warps) {
      float p[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ch = 0; ch < nc; ++ch) {
        const int col = ch * 32 + lane;
        if (col < k) {
          float at = 0.0f;
          for (int w = 0; w < n_part; ++w) at += spart[w * k + col];
          const float rhs = (sigma * sw[col] - sq[col]) + at;
#pragma unroll
          for (int v = 0; v < 8; ++v) {
            const int o = g * 8 + v;
            if (o < k) p[v] += sM[o * k + col] * rhs;
          }
        }
      }
      const float wt = warp_reduce_scatter<8>(p, lane);
      const int o = g * 8 + (lane >> 2);
      if ((lane & 3) == 0 && o < k) swt[o] = wt;
    }
    __syncthreads();
    // C: z~ = As w~ tile by tile, prox and dual update of lane r's row
    for (int tile = warp; tile < n_tiles; tile += n_warps) {
      const int base = tile * 32;
      float p[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) p[r] = 0.0f;
#pragma unroll
      for (int ch = 0; ch < nc; ++ch) {
        const int col = ch * 32 + lane;
        if (col < k) {
          const float wt = swt[col];
#pragma unroll
          for (int r = 0; r < 32; ++r)
            if (base + r < m) p[r] += sA[(base + r) * k + col] * wt;
        }
      }
      const float zt = warp_reduce_scatter<32>(p, lane);
      const int i = base + lane;
      if (i < m) {
        const float z = sz[i], y = sy[i], lo = sl[i], hi = su[i], f = sfac[i];
        const float z_mix = alpha * zt + one_m_alpha * z;
        const float v = z_mix + y * sinv[i];
        float z_new = fminf(fmaxf(v, lo), hi);
        if (f >= 0.0f) z_new = fminf(v >= lo ? v : lo + (v - lo) * f, hi);
        const float y_new = y + srho[i] * (z_mix - z_new);
        sz[i] = z_new;
        sy[i] = y_new;
        st[i] = srho[i] * z_new - y_new;
      }
      __syncwarp(kFull);
    }
    if (warp == 0) {
      for (int col = lane; col < k; col += 32) sw[col] = alpha * swt[col] + one_m_alpha * sw[col];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < k; i += blockDim.x) w_out[bk + i] = sw[i];
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    z_out[bm + i] = sz[i];
    y_out[bm + i] = sy[i];
  }
}

size_t smem_instance_bytes(int k, int m, int n_warps) {
  return static_cast<size_t>(m) * k * sizeof(float) +
         static_cast<size_t>(k * k + (3 + n_warps) * k + 8 * m) * sizeof(float);
}

}  // namespace

extern "C" int admm_iterate_launch(
    const void* Minv, const void* As, const void* qs, const void* ls, const void* us,
    const void* soft, const void* rho, const void* w0, const void* z0, const void* y0,
    void* w, void* z, void* y, int B, int k, int m, int iters, float sigma,
    float alpha, float one_m_alpha, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto M_ = static_cast<const float*>(Minv);
  const auto A_ = static_cast<const float*>(As);
  const auto q_ = static_cast<const float*>(qs);
  const auto l_ = static_cast<const float*>(ls);
  const auto u_ = static_cast<const float*>(us);
  const auto f_ = static_cast<const float*>(soft);
  const auto r_ = static_cast<const float*>(rho);
  const auto w0_ = static_cast<const float*>(w0);
  const auto z0_ = static_cast<const float*>(z0);
  const auto y0_ = static_cast<const float*>(y0);
  const auto w_ = static_cast<float*>(w);
  const auto z_ = static_cast<float*>(z);
  const auto y_ = static_cast<float*>(y);
  const int n_tiles = (m + 31) / 32, n_groups = (k + 7) / 8;
  if (k <= 32 && n_tiles <= kRegWarps) {
    int n_warps = n_tiles > n_groups ? n_tiles : n_groups;
    if (n_warps < 1) n_warps = 1;
    const size_t smem = static_cast<size_t>(64 * n_tiles + 32 + 33 * 32 * n_tiles) * sizeof(float);
    admm_regs_kernel<<<B, 32 * n_warps, smem, s>>>(M_, A_, q_, l_, u_, f_, r_, w0_, z0_, y0_,
                                                   w_, z_, y_, k, m, iters, sigma, alpha,
                                                   one_m_alpha);
    return static_cast<int>(cudaGetLastError());
  }
  // as many warps as there are row tiles or output groups, at most 8, and
  // fewer where shared memory is short (one warp needs no more than the
  // wrapper's admission rule allows)
  int n_warps = n_tiles > n_groups ? n_tiles : n_groups;
  if (n_warps > kMaxWarps) n_warps = kMaxWarps;
  if (n_warps < 1) n_warps = 1;
  while (n_warps > 1 && smem_instance_bytes(k, m, n_warps) > 232448) --n_warps;
  const size_t smem = smem_instance_bytes(k, m, n_warps);
  const int nc = (k + 31) / 32;
  auto run = [&](auto kernel) {
    cudaError_t err = neupan_allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<B, 32 * n_warps, smem, s>>>(M_, A_, q_, l_, u_, f_, r_, w0_, z0_, y0_, w_, z_, y_,
                                         k, m, iters, sigma, alpha, one_m_alpha);
    return static_cast<int>(cudaGetLastError());
  };
  if (nc == 1) return run(admm_smem_kernel<1>);
  if (nc == 2) return run(admm_smem_kernel<2>);
  if (nc == 3) return run(admm_smem_kernel<3>);
  return run(admm_smem_kernel<0>);
}
