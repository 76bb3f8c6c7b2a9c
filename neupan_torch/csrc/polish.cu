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
// per scenario at k=30, na=18; 4.35 MFLOP and ~100 KB at k=90, na=58) but
// the chain of dependent steps: k + na sweep pivots, the Schur build, then
// 6 + 9 refine dependent matrix-vector products, each behind a barrier.
// Layout: W = 4 NC warps a block, NC = 32-column chunks of max(k, na),
// 1..4 (block_warps): 4 at NC=1, where a block takes 17 KB of shared memory
// and ~5 blocks share an SM; 12 at NC=3, where one block fills an SM (154 KB
// at k=90, na=58). So a thread holds 8 NC values of each inverse, 24 at
// NC=3, within its registers, and at NC=3 three warps a scheduler hide the
// latency of each pivot and product.
//   * the inverses: thread (warp w, lane c) holds rows w, w+W, ... of
//     columns c, c+32, ... in registers. Sweeping pivot j reads row j from a
//     double-buffered shared row (its column j by symmetry) plus 1/pivot:
//     one __syncthreads per pivot, a branch-free update (selects), and no
//     element loop divides by n. The owner of row j+1 keeps it as it updates
//     and writes it and its reciprocal for the next pivot after the update,
//     so the unrolled update holds no store and no reciprocal. The
//     arithmetic is csrc/sweep.cuh's (round-to-nearest intrinsics, correctly
//     rounded reciprocal), the pivot order, scale and ridge the plain
//     version's;
//   * the Schur build: Hm^{-1} DAn' and S by output per thread (rows w,
//     w+W, ...), four partial sums per output at NC=1 (chains of k/4), one
//     chain in order of j above it; 2 barriers;
//   * the KKT solves and refinement: all warps, each holding every vector in
//     its lanes (element c in lane c % 32). A product A x splits its sum
//     over j into 4 groups of 8 NC values of j and its outputs into the NC
//     chunks, one warp a (group, chunk) pair, which adds A[j][c] x_j in
//     order of j in lane c (conflict-free: DAn is stored with an odd row
//     stride), x_j read from the warp's own copy of x in shared memory. The
//     4 partials meet in a double-buffered shared array behind one barrier
//     and every warp sums them in one tree order, with no atomics: a launch
//     repeats bit for bit and a scenario's result does not depend on its
//     batch. 69 barriers for the 8 solves at refine=7. The partials and the
//     copies of x take the place of DAn Hm^{-1}, dead by then.
// So W changes no sum's association: every instance computes what 4 warps
// compute, bit for bit.
// Above n=96 the plain version inverts by Cholesky; the kernel keeps the
// sweep, as the TPU kernel does at every n.
// No tensor cores: every product is a matrix times one vector, and the
// port keeps float32 (TF32 off).
#include <type_traits>

#include "common.cuh"

namespace {

// Warps of one block: one for each (group, chunk) pair of a product, so 8
// rows of each inverse a warp.
__host__ __device__ constexpr int block_warps(int nc) { return 4 * nc; }

// Inverse of the SPD (n, n) matrix get(r, c) into dst (row-major, stride
// n): Jacobi scaling with 1/sqrt(|diag|) (correctly rounded), a 1e-7 ridge,
// the symmetric sweep, and the unscaling. All W warps of the block call it;
// thread (warp w, lane c) holds rows w, w + W, ... of columns c, c + 32, ...
// sbuf: 2 (32 NC + 1) floats. dst may be get's storage: every read of it
// happens before the first barrier, every write after the last.
template <int NC, int W, typename Get>
__device__ __forceinline__ void spd_inverse(Get get, float* dst, float* sbuf, int n) {
  constexpr int NR = 32 * NC / W, L = 32 * NC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float a[NR][NC], djr[NR], djc[NC];
#pragma unroll
  for (int cc = 0; cc < NC; ++cc) {
    const int c = lane + 32 * cc;
    djc[cc] = c < n ? 1.0f / sqrtf(fabsf(get(c, c)) + 1e-30f) : 0.0f;
  }
#pragma unroll
  for (int rr = 0; rr < NR; ++rr) {
    const int r = warp + W * rr;
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
      if (c == 0 && n > 0) sbuf[L] = __frcp_rn(a[0][cc]);
    }
  }
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    const float* row = sbuf + (j & 1) * (L + 1);
    float* next = sbuf + ((j + 1) & 1) * (L + 1);
    const float inv_d = row[L];
    float t[NC], on_row[NC], nv[NC];
    bool on_col[NC];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = lane + 32 * cc;
      t[cc] = __fmul_rn(c < n ? row[c] : 0.0f, inv_d);
      on_col[cc] = c == j;
      on_row[cc] = on_col[cc] ? -inv_d : t[cc];
      nv[cc] = 0.0f;
    }
#pragma unroll
    for (int rr = 0; rr < NR; ++rr) {
      const int r = warp + W * rr;
      if (r < n) {
        const float rv = row[r];
        const float cj = __fmul_rn(rv, inv_d);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const float gen = __fsub_rn(a[rr][cc], __fmul_rn(rv, t[cc]));
          const float v = r == j ? on_row[cc] : (on_col[cc] ? cj : gen);
          a[rr][cc] = v;
          if (r == j + 1) nv[cc] = v;
        }
      }
    }
    // the owner of row j + 1 hands it and its reciprocal pivot to the next
    // pivot, outside the unrolled update: one reciprocal, one store a chunk
    const int jn = j + 1;
    if (jn < n && warp == jn % W) {
      float pv = nv[0];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int c = lane + 32 * cc;
        if (c < n) next[c] = nv[cc];
        if (cc > 0 && (jn >> 5) == cc) pv = nv[cc];
      }
      if (lane == (jn & 31)) next[L] = __frcp_rn(pv);
    }
    __syncthreads();
  }
#pragma unroll
  for (int rr = 0; rr < NR; ++rr) {
    const int r = warp + W * rr;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int c = lane + 32 * cc;
      if (r < n && c < n) dst[r * n + c] = __fmul_rn(__fmul_rn(-a[rr][cc], djr[rr]), djc[cc]);
    }
  }
}

// out[r][c] = sum_j X(r, j) Y(j, c) (+ diag(r) on r == c) for r < rows,
// c < cols, by thread (warp w of W: rows w, w + W, ...; lane: columns), with
// S partial sums per output: 4 at NC = 1 (chains of k/4), else one chain in
// order of j. X is read as broadcasts, Y along c.
template <int NC, int W, typename X, typename Y, typename Diag>
__device__ __forceinline__ void block_mm(float* out, int ldo, int rows, int cols, int inner,
                                         X x, Y y, Diag diag) {
  constexpr int NR = 32 * NC / W, S = NC == 1 ? 4 : 1;
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
          const int r = warp + W * rr;
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
    const int r = warp + W * rr;
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

// The groups of j a product's sum splits into, each summed in order of j.
constexpr int kGroups = 4;

// y[c] = sum_{j < n_in} A[j * sj + c * sc] x[j] for c < n_out (0 beyond),
// by the whole block; x and y are lane vectors (element c in lane c % 32 of
// chunk c / 32), zero beyond their length and the same in every warp. Warp
// w sums group w % kGroups (8 NC values of j) of chunk w / kGroups in order
// of j, reading x_j from its own copy of x in shared memory (a shuffle
// there holds each step of the chain behind it) and A unconditionally: a
// row j >= n_in reads row n_in - 1 and adds nothing, as x_j = 0, and a
// column c >= n_out reads column n_out - 1 and is dropped. The partials
// meet in part (2 x kGroups x 32 NC floats, used alternately by buf, so one
// barrier per product suffices; then W x 32 NC for the copies of x) and
// every warp adds them in the same order, (p0 + p1) + (p2 + p3).
template <int NC, int W>
__device__ __forceinline__ void block_mv(float (&y)[NC], const float* A, int sj, int sc, int n_in,
                                        int n_out, const float (&x)[NC], float* part, int lane,
                                        int& buf) {
  static_assert(kGroups == 4 && W == kGroups * NC, "one warp for each group and chunk");
  constexpr int JS = 32 * NC / kGroups;
  const int warp = threadIdx.x >> 5, g = warp % kGroups, ch = warp / kGroups;
  float* xw = part + (2 * kGroups + warp) * 32 * NC;
#pragma unroll
  for (int h = 0; h < NC; ++h) xw[h * 32 + lane] = x[h];
  __syncwarp();
  const int c = ch * 32 + lane;
  const float* col = A + min(c, n_out - 1) * sc;
  const float* xg = xw + g * JS;
  float acc = 0.0f;
#pragma unroll
  for (int u = 0; u < JS; ++u) acc += col[min(g * JS + u, n_in - 1) * sj] * xg[u];
  float* p = part + buf * (kGroups * 32 * NC);
  p[g * 32 * NC + c] = acc;
  __syncthreads();
#pragma unroll
  for (int h = 0; h < NC; ++h) {
    const float* q = p + h * 32 + lane;
    const float sum = (q[0] + q[32 * NC]) + (q[64 * NC] + q[96 * NC]);
    y[h] = h * 32 + lane < n_out ? sum : 0.0f;
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
template <int NC, int W>
__device__ __forceinline__ void kkt_solve(const SolveMats& M, const float (&fix)[NC],
                                          const float (&free_)[NC], const float (&r1)[NC],
                                          const float (&r_fix)[NC], const float (&r2n)[NC],
                                          float (&dw)[NC], float (&dyn)[NC], int& buf) {
  const int k = M.k, na = M.na;
  float t[NC], u[NC], v[NC];
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) t[ch] = fix[ch] * r_fix[ch];
  block_mv<NC, W>(u, M.hr, k, 1, k, k, t, M.part, M.lane, buf);         // Hr (fix * r_fix)
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) t[ch] = free_[ch] * (r1[ch] - u[ch]) + fix[ch] * r_fix[ch];
  block_mv<NC, W>(dw, M.hi, k, 1, k, k, t, M.part, M.lane, buf);        // dw0
  block_mv<NC, W>(u, M.dan, 1, M.ks, k, na, dw, M.part, M.lane, buf);   // DAn dw0
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) u[ch] = u[ch] - r2n[ch];
  block_mv<NC, W>(dyn, M.s, na, 1, na, na, u, M.part, M.lane, buf);     // dyn
  block_mv<NC, W>(v, M.dan, M.ks, 1, na, k, dyn, M.part, M.lane, buf);  // DAn' dyn
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) v[ch] = free_[ch] * v[ch];
  block_mv<NC, W>(t, M.hi, k, 1, k, k, v, M.part, M.lane, buf);
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) dw[ch] = dw[ch] - t[ch];
}

// Shared memory of a block: the sweep's pivot rows, Hr, Hr_true, Hm^{-1},
// DAn, S, fix, d, then DAn Hm^{-1}, whose place the products' partial sums
// and copies of x take once the Schur build is done.
size_t polish_smem_bytes(int k, int na, int nc) {
  const int ks = k | 1, part = (2 * kGroups + block_warps(nc)) * 32 * nc;
  const int floats = 2 * (32 * nc + 1) + 3 * k * k + na * ks + na * na + k + na +
                     (na * ks > part ? na * ks : part);
  return static_cast<size_t>(floats) * sizeof(float);
}

template <int NC, int W>
__global__ void __launch_bounds__(32 * W) box_candidate_kernel(
    const float* __restrict__ Hr, const float* __restrict__ Hr_true,
    const float* __restrict__ DAn, const float* __restrict__ C0,
    const float* __restrict__ g1r, const float* __restrict__ g2n,
    const float* __restrict__ b_box, const float* __restrict__ fix,
    const float* __restrict__ d, float* __restrict__ w_out,
    float* __restrict__ yn_out, int k, int na, int refine) {
  constexpr int kThreads = 32 * W;
  extern __shared__ float sm[];
  const int ks = k | 1;           // odd row stride: DAn read down a column without conflicts
  float* sbuf = sm;               // 2 (32 NC + 1): the sweep's pivot rows
  float* shr = sbuf + 2 * (32 * NC + 1);
  float* sht = shr + k * k;
  float* shi = sht + k * k;       // Hm^{-1}
  float* sda = shi + k * k;       // DAn, stride ks
  float* ss = sda + na * ks;      // S, then S^{-1}
  float* sfix = ss + na * na;
  float* sd = sfix + k;
  float* shd = sd + na;           // DAn Hm^{-1}, stride ks
  float* spart = shd;             // after the Schur build: the products' partial sums and x

  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t bkk = static_cast<size_t>(b) * k * k, bak = static_cast<size_t>(b) * na * k;
  const size_t bk = static_cast<size_t>(b) * k, ba = static_cast<size_t>(b) * na;
#pragma unroll 4
  for (int e = threadIdx.x; e < k * k; e += kThreads) {
    shr[e] = Hr[bkk + e];
    sht[e] = Hr_true[bkk + e];
  }
  for (int r = warp; r < na; r += W)
    for (int c = lane; c < k; c += 32) sda[r * ks + c] = DAn[bak + r * k + c];
  for (int i = threadIdx.x; i < k; i += kThreads) sfix[i] = fix[bk + i];
  for (int i = threadIdx.x; i < na; i += kThreads) sd[i] = d[ba + i];
  __syncthreads();

  // masked Hessian (identity row/column at the pinned coordinates), inverted
  spd_inverse<NC, W>(
      [=](int r, int c) {
        const float v = __fmul_rn(__fmul_rn(shr[r * k + c], 1.0f - sfix[r]), 1.0f - sfix[c]);
        return r == c ? __fadd_rn(v, sfix[r]) : v;
      },
      shi, sbuf, k);
  __syncthreads();
  // dual Schur complement over the acc rows: DAn Hm^{-1} DAn' + diag(1-d) + 1e-6
  block_mm<NC, W>(shd, ks, na, k, k, [=](int r, int j) { return sda[r * ks + j]; },
                  [=](int j, int c) { return shi[j * k + c]; }, [](int) { return 0.0f; });
  __syncthreads();
  block_mm<NC, W>(ss, na, na, na, k, [=](int r, int i) { return shd[r * ks + i]; },
                  [=](int i, int c) { return sda[c * ks + i]; },
                  [=](int r) { return (1.0f - sd[r]) + 1e-6f; });
  __syncthreads();
  spd_inverse<NC, W>([=](int r, int c) { return ss[r * na + c]; }, ss, sbuf, na);
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
  kkt_solve<NC, W>(mats, fx, fr, gr, bbox, gn, w, yn, buf);
  for (int it = 0; it < refine; ++it) {
    float t1[NC], t2[NC], u[NC], r1[NC], rf[NC], r2[NC], dw[NC], dy[NC];
    block_mv<NC, W>(t1, sht, k, 1, k, k, w, spart, lane, buf);     // Hr_true w
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) u[ch] = dd[ch] * yn[ch];
    block_mv<NC, W>(t2, sda, ks, 1, na, k, u, spart, lane, buf);   // DAn' (d * yn)
    block_mv<NC, W>(u, sda, 1, ks, k, na, w, spart, lane, buf);    // DAn w
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      r1[ch] = (c0[ch] - t1[ch]) - t2[ch];
      rf[ch] = fx[ch] * (bbox[ch] - w[ch]);
      r2[ch] = gn[ch] - (u[ch] + (1.0f - dd[ch]) * yn[ch]);
    }
    kkt_solve<NC, W>(mats, fx, fr, r1, rf, r2, dw, dy, buf);
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

}  // namespace

extern "C" int box_candidate_launch(
    const void* Hr, const void* Hr_true, const void* DAn, const void* C0, const void* g1r,
    const void* g2n, const void* b_box, const void* fix, const void* d, void* w, void* yn,
    int B, int k, int na, int refine, void* stream) {
  const int nm = k > na ? k : na;
  if (nm > 128) return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (nm + 31) / 32;
  const size_t smem = polish_smem_bytes(k, na, nc);
  auto run = [&](auto nc_tag) {
    constexpr int NC = decltype(nc_tag)::value, W = block_warps(NC);
    auto kernel = box_candidate_kernel<NC, W>;
    cudaError_t err = neupan_allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<B, 32 * W, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(Hr), static_cast<const float*>(Hr_true),
        static_cast<const float*>(DAn), static_cast<const float*>(C0),
        static_cast<const float*>(g1r), static_cast<const float*>(g2n),
        static_cast<const float*>(b_box), static_cast<const float*>(fix),
        static_cast<const float*>(d), static_cast<float*>(w), static_cast<float*>(yn), k, na,
        refine);
    return static_cast<int>(cudaGetLastError());
  };
  if (nc == 1) return run(std::integral_constant<int, 1>{});
  if (nc == 2) return run(std::integral_constant<int, 2>{});
  if (nc == 3) return run(std::integral_constant<int, 3>{});
  return run(std::integral_constant<int, 4>{});
}
