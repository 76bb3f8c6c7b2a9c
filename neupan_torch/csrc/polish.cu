// One box-eliminating polish candidate solve: one block per scenario.
//
// Replaces neupan_tpu/ops/pallas/polish.py:box_candidate
// (_box_candidate_kernel + _spd_inv_inline). Per scenario: the masked
// Hessian Hm and its inverse, the dual Schur complement
// S = DAn Hm^{-1} DAn' + diag(1 - d) + 1e-6 and its inverse (both inverses
// Jacobi-scaled with a 1e-7 ridge), one KKT solve and `refine` refinement
// passes against Hr_true. Only w and yn are written back.
//
// Bound on the H100: neither bytes nor operations (~0.2 MFLOP and ~10 KB
// per scenario at k=30, na=18) but the chain of dependent steps: k + na
// sweep pivots, then 6 + 9 refine dependent matrix-vector products.
// Layout (4 warps, NC = 32-column chunks of max(k, na), 1..4):
//   * the inverses: thread (warp w, lane c) holds rows w, w+4, ... of
//     columns c, c+32, ... in registers (8 NC x NC values). Sweeping pivot
//     j reads row j from a double-buffered shared row (its column j by
//     symmetry) plus 1/pivot, which the owners of row j+1 write for the next
//     pivot: one __syncthreads per pivot, a branch-free update (selects),
//     and no element loop divides by n. The
//     arithmetic is csrc/sweep.cuh's (round-to-nearest intrinsics, correctly
//     rounded reciprocal), the pivot order, scale and ridge the plain
//     version's;
//   * the Schur build: Hm^{-1} DAn' and S by output per thread, with several
//     partial sums per output (chains of k/4 at NC=1); 2 barriers;
//   * the KKT solves and refinement: all warps, each holding every vector in
//     its lanes (element c in lane c % 32). A product A x splits the sum
//     over j between the warps: warp w takes x_j from lane j by shuffle and
//     adds A[j][c] x_j over its 8 NC values of j in lane c (conflict-free:
//     DAn is stored with an odd row stride), then the 4 partials meet in a
//     double-buffered shared array behind one barrier and every warp sums
//     them in the same order. 69 barriers for the 8 solves at refine=7;
//     one warp alone, barrier-free, took 2.3x as long per refinement pass.
// Registers (nvcc -Xptxas -v, sm_90a): 91 at NC=1, no spills, so the ~4
// blocks per SM that B=512 puts there are all resident at once. NC=4 (the
// T=33 horizon, k=99) holds 128 values of each inverse per thread. Above
// n=96 the plain version inverts by Cholesky; the kernel keeps the sweep, as
// the TPU kernel does at every n.
// No tensor cores: every product is a matrix times one vector, and the
// port keeps float32 (TF32 off).
#include "common.cuh"

namespace {

constexpr int kWarps = 4;   // a power of two, at most 32
constexpr int kThreads = 32 * kWarps;

// Inverse of the SPD (n, n) matrix get(r, c) into dst (row-major, stride
// n): Jacobi scaling with 1/sqrt(|diag|) (correctly rounded), a 1e-7 ridge,
// the symmetric sweep, and the unscaling. All threads of the block call it.
// sbuf: 2 (32 NC + 1) floats. dst may be get's storage: every read of it
// happens before the first barrier, every write after the last.
template <int NC, typename Get>
__device__ __forceinline__ void spd_inverse(Get get, float* dst, float* sbuf, int n) {
  constexpr int NR = 32 * NC / kWarps, W = 32 * NC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float a[NR][NC], djr[NR], djc[NC];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) {
    const int c = lane + 32 * cc;
    djc[cc] = c < n ? 1.0f / sqrtf(fabsf(get(c, c)) + 1e-30f) : 0.0f;
  }
#pragma unroll
  for (int rr = 0; rr < NR; ++rr) {
    const int r = warp + kWarps * rr;
    djr[rr] = r < n ? 1.0f / sqrtf(fabsf(get(r, r)) + 1e-30f) : 0.0f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = lane + 32 * cc;
      float v = 0.0f;
      if (r < n && c < n) {
        v = __fmul_rn(__fmul_rn(get(r, c), djr[rr]), djc[cc]);
        if (r == c) v = __fadd_rn(v, 1e-7f);
      }
      a[rr][cc] = v;
    }
  }
  if (warp == 0) {            // row 0 and its reciprocal pivot into buffer 0
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = lane + 32 * cc;
      if (c < n) sbuf[c] = a[0][cc];
      if (c == 0 && n > 0) sbuf[W] = __frcp_rn(a[0][cc]);
    }
  }
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    const float* row = sbuf + (j & 1) * (W + 1);
    float* next = sbuf + ((j + 1) & 1) * (W + 1);
    const float inv_d = row[W];
    float rc[NC];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = lane + 32 * cc;
      rc[cc] = c < n ? row[c] : 0.0f;
    }
#pragma unroll
    for (int rr = 0; rr < NR; ++rr) {
      const int r = warp + kWarps * rr;
      if (r < n) {
        const float rv = row[r];
        const float cj = __fmul_rn(rv, inv_d);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int c = lane + 32 * cc;
          const float t = __fmul_rn(rc[cc], inv_d);
          const float gen = __fsub_rn(a[rr][cc], __fmul_rn(rv, t));
          const float v = r == j ? (c == j ? -inv_d : t) : (c == j ? cj : gen);
          a[rr][cc] = v;
          if (r == j + 1 && c < n) {
            next[c] = v;
            if (c == r) next[W] = __frcp_rn(v);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int rr = 0; rr < NR; ++rr) {
    const int r = warp + kWarps * rr;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = lane + 32 * cc;
      if (r < n && c < n) dst[r * n + c] = __fmul_rn(__fmul_rn(-a[rr][cc], djr[rr]), djc[cc]);
    }
  }
}

// out[r][c] = sum_j X(r, j) Y(j, c) (+ diag(r) on r == c) for r < rows,
// c < cols, by thread (warp w: rows w, w+4, ...; lane: columns), with
// several partial sums per output. X is read as broadcasts, Y along c.
template <int NC, typename X, typename Y, typename Diag>
__device__ __forceinline__ void block_mm(float* out, int ldo, int rows, int cols, int inner,
                                         X x, Y y, Diag diag) {
  constexpr int NR = 32 * NC / kWarps, S = NC == 1 ? 4 : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[NR][NC][S];
#pragma unroll
  for (int rr = 0; rr < NR; ++rr)
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int s = 0; s < S; ++s) acc[rr][cc][s] = 0.0f;
  for (int j0 = 0; j0 < inner; j0 += S) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = j0 + s;
      if (j < inner) {
        float yv[NC];
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int c = lane + 32 * cc;
          yv[cc] = c < cols ? y(j, c) : 0.0f;
        }
#pragma unroll
        for (int rr = 0; rr < NR; ++rr) {
          const int r = warp + kWarps * rr;
          if (r < rows) {
            const float xv = x(r, j);
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) acc[rr][cc][s] += xv * yv[cc];
          }
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < NR; ++rr) {
    const int r = warp + kWarps * rr;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = lane + 32 * cc;
      if (r < rows && c < cols) {
        float v = acc[rr][cc][0];
#pragma unroll
        for (int s = 1; s < S; ++s) v += acc[rr][cc][s];
        out[r * ldo + c] = r == c ? v + diag(r) : v;
      }
    }
  }
}

// y[c] = sum_{j < n_in} A[j * sj + c * sc] x[j] for c < n_out (0 beyond),
// by the whole block; x and y are lane vectors (element c in lane c % 32 of
// chunk c / 32), zero beyond their length and the same in every warp.
// part: 2 x kWarps x 32 NC floats of partial sums, used alternately (buf),
// so one barrier per product suffices.
template <int NC>
__device__ __forceinline__ void block_mv(float (&y)[NC], const float* A, int sj, int sc, int n_in,
                                        int n_out, const float (&x)[NC], float* part, int lane,
                                        int& buf) {
  constexpr int JS = 32 * NC / kWarps;
  const int warp = threadIdx.x >> 5;
  float acc[NC];
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) acc[ch] = 0.0f;
#pragma unroll
  for (int u = 0; u < JS; ++u) {
    const int j = warp * JS + u;
    float xc = x[0];
#pragma unroll
    for (int ch = 1; ch < NC; ++ch)
      if ((j >> 5) == ch) xc = x[ch];
    const float xj = __shfl_sync(0xffffffffu, xc, j & 31);
    if (j < n_in) {
#pragma unroll
      for (int ch = 0; ch < NC; ++ch) {
        const int c = ch * 32 + lane;
        if (c < n_out) acc[ch] += A[j * sj + c * sc] * xj;
      }
    }
  }
  float* p = part + buf * (kWarps * 32 * NC);
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) p[warp * 32 * NC + ch * 32 + lane] = acc[ch];
  __syncthreads();
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) {
    const int c = ch * 32 + lane;
    float ps[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) ps[w] = p[w * 32 * NC + ch * 32 + lane];
#pragma unroll
    for (int h = kWarps / 2; h >= 1; h /= 2)
#pragma unroll
      for (int w = 0; w < h; ++w) ps[w] = ps[2 * w] + ps[2 * w + 1];
    y[ch] = c < n_out ? ps[0] : 0.0f;
  }
  buf ^= 1;
}

// The matrices of the solve in shared memory and the products' partial sums.
struct SolveMats {
  const float *hr, *hi, *dan, *s;
  float* part;
  int k, na, ks, lane;
};

// dw = dw0 - Hm^{-1} (free * DAn' dyn), dyn = S^{-1}(DAn dw0 - r2n), with
// dw0 = Hm^{-1} (free * (r1 - Hr (fix * r_fix)) + fix * r_fix).
template <int NC>
__device__ __forceinline__ void kkt_solve(const SolveMats& M, const float (&fix)[NC],
                                          const float (&free_)[NC], const float (&r1)[NC],
                                          const float (&r_fix)[NC], const float (&r2n)[NC],
                                          float (&dw)[NC], float (&dyn)[NC], int& buf) {
  const int k = M.k, na = M.na;
  float t[NC], u[NC], v[NC];
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) t[ch] = fix[ch] * r_fix[ch];
  block_mv<NC>(u, M.hr, k, 1, k, k, t, M.part, M.lane, buf);            // Hr (fix * r_fix)
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) t[ch] = free_[ch] * (r1[ch] - u[ch]) + fix[ch] * r_fix[ch];
  block_mv<NC>(dw, M.hi, k, 1, k, k, t, M.part, M.lane, buf);           // dw0
  block_mv<NC>(u, M.dan, 1, M.ks, k, na, dw, M.part, M.lane, buf);      // DAn dw0
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) u[ch] = u[ch] - r2n[ch];
  block_mv<NC>(dyn, M.s, na, 1, na, na, u, M.part, M.lane, buf);        // dyn
  block_mv<NC>(v, M.dan, M.ks, 1, na, k, dyn, M.part, M.lane, buf);     // DAn' dyn
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) v[ch] = free_[ch] * v[ch];
  block_mv<NC>(t, M.hi, k, 1, k, k, v, M.part, M.lane, buf);
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) dw[ch] = dw[ch] - t[ch];
}

template <int NC>
__global__ void __launch_bounds__(kThreads) box_candidate_kernel(
    const float* __restrict__ Hr, const float* __restrict__ Hr_true,
    const float* __restrict__ DAn, const float* __restrict__ C0,
    const float* __restrict__ g1r, const float* __restrict__ g2n,
    const float* __restrict__ b_box, const float* __restrict__ fix,
    const float* __restrict__ d, float* __restrict__ w_out,
    float* __restrict__ yn_out, int k, int na, int refine) {
  extern __shared__ float sm[];
  const int ks = k | 1;           // odd row stride: DAn read down a column without conflicts
  float* spart = sm;              // 2 kWarps 32 NC: the products' partial sums
  float* sbuf = spart + 2 * kWarps * 32 * NC;     // 2 (32 NC + 1): the sweep's pivot rows
  float* shr = sbuf + 2 * (32 * NC + 1);
  float* sht = shr + k * k;
  float* shi = sht + k * k;       // Hm^{-1}
  float* sda = shi + k * k;       // DAn, stride ks
  float* shd = sda + na * ks;     // DAn Hm^{-1}, stride ks
  float* ss = shd + na * ks;      // S, then S^{-1}
  float* sfix = ss + na * na;
  float* sd = sfix + k;

  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t bkk = static_cast<size_t>(b) * k * k, bak = static_cast<size_t>(b) * na * k;
  const size_t bk = static_cast<size_t>(b) * k, ba = static_cast<size_t>(b) * na;
#pragma unroll 4
  for (int e = threadIdx.x; e < k * k; e += kThreads) {
    shr[e] = Hr[bkk + e];
    sht[e] = Hr_true[bkk + e];
  }
  for (int r = warp; r < na; r += kWarps)
    for (int c = lane; c < k; c += 32) sda[r * ks + c] = DAn[bak + r * k + c];
  for (int i = threadIdx.x; i < k; i += kThreads) sfix[i] = fix[bk + i];
  for (int i = threadIdx.x; i < na; i += kThreads) sd[i] = d[ba + i];
  __syncthreads();

  // masked Hessian (identity row/column at the pinned coordinates), inverted
  spd_inverse<NC>(
      [=](int r, int c) {
        const float v = __fmul_rn(__fmul_rn(shr[r * k + c], 1.0f - sfix[r]), 1.0f - sfix[c]);
        return r == c ? __fadd_rn(v, sfix[r]) : v;
      },
      shi, sbuf, k);
  __syncthreads();
  // dual Schur complement over the acc rows: DAn Hm^{-1} DAn' + diag(1-d) + 1e-6
  block_mm<NC>(shd, ks, na, k, k, [=](int r, int j) { return sda[r * ks + j]; },
               [=](int j, int c) { return shi[j * k + c]; }, [](int) { return 0.0f; });
  __syncthreads();
  block_mm<NC>(ss, na, na, na, k, [=](int r, int i) { return shd[r * ks + i]; },
               [=](int i, int c) { return sda[c * ks + i]; },
               [=](int r) { return (1.0f - sd[r]) + 1e-6f; });
  __syncthreads();
  spd_inverse<NC>([=](int r, int c) { return ss[r * na + c]; }, ss, sbuf, na);
  __syncthreads();

  // the KKT solve and the refinement passes, every warp on every vector
  const SolveMats mats{shr, shi, sda, ss, spart, k, na, ks, lane};
  float fx[NC], fr[NC], c0[NC], bbox[NC], gr[NC], gn[NC], dd[NC], w[NC], yn[NC];
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) {
    const int i = ch * 32 + lane;
    const bool in_k = i < k, in_a = i < na;
    fx[ch] = in_k ? sfix[i] : 0.0f;
    fr[ch] = in_k ? 1.0f - sfix[i] : 0.0f;
    c0[ch] = in_k ? C0[bk + i] : 0.0f;
    bbox[ch] = in_k ? b_box[bk + i] : 0.0f;
    gr[ch] = in_k ? g1r[bk + i] : 0.0f;
    gn[ch] = in_a ? g2n[ba + i] : 0.0f;
    dd[ch] = in_a ? sd[i] : 0.0f;
  }
  int buf = 0;
  kkt_solve<NC>(mats, fx, fr, gr, bbox, gn, w, yn, buf);
  for (int it = 0; it < refine; ++it) {
    float t1[NC], t2[NC], u[NC], r1[NC], rf[NC], r2[NC], dw[NC], dy[NC];
    block_mv<NC>(t1, sht, k, 1, k, k, w, spart, lane, buf);          // Hr_true w
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) u[ch] = dd[ch] * yn[ch];
    block_mv<NC>(t2, sda, ks, 1, na, k, u, spart, lane, buf);        // DAn' (d * yn)
    block_mv<NC>(u, sda, 1, ks, k, na, w, spart, lane, buf);         // DAn w
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      r1[ch] = (c0[ch] - t1[ch]) - t2[ch];
      rf[ch] = fx[ch] * (bbox[ch] - w[ch]);
      r2[ch] = gn[ch] - (u[ch] + (1.0f - dd[ch]) * yn[ch]);
    }
    kkt_solve<NC>(mats, fx, fr, r1, rf, r2, dw, dy, buf);
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      w[ch] = w[ch] + dw[ch];
      yn[ch] = yn[ch] + dy[ch];
    }
  }
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) {
    const int i = ch * 32 + lane;
    if (warp == 0 && i < k) w_out[bk + i] = w[ch];
    if (warp == 0 && i < na) yn_out[ba + i] = yn[ch];
  }
}

size_t polish_smem_bytes(int k, int na, int nc) {
  const int ks = k | 1;
  return static_cast<size_t>(2 * kWarps * 32 * nc + 2 * (32 * nc + 1) + 3 * k * k +
                             2 * na * ks + na * na + k + na) * sizeof(float);
}

}  // namespace

extern "C" int box_candidate_launch(
    const void* Hr, const void* Hr_true, const void* DAn, const void* C0, const void* g1r,
    const void* g2n, const void* b_box, const void* fix, const void* d, void* w, void* yn,
    int B, int k, int na, int refine, void* stream) {
  const int nm = k > na ? k : na;
  if (nm > 128) return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (nm + 31) / 32;
  const size_t smem = polish_smem_bytes(k, na, nc);
  auto run = [&](auto kernel) {
    cudaError_t err = neupan_allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(Hr), static_cast<const float*>(Hr_true),
        static_cast<const float*>(DAn), static_cast<const float*>(C0),
        static_cast<const float*>(g1r), static_cast<const float*>(g2n),
        static_cast<const float*>(b_box), static_cast<const float*>(fix),
        static_cast<const float*>(d), static_cast<float*>(w), static_cast<float*>(yn), k, na,
        refine);
    return static_cast<int>(cudaGetLastError());
  };
  if (nc == 1) return run(box_candidate_kernel<1>);
  if (nc == 2) return run(box_candidate_kernel<2>);
  if (nc == 3) return run(box_candidate_kernel<3>);
  return run(box_candidate_kernel<4>);
}
