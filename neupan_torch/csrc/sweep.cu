// Batched SPD inverse by the symmetric sweep operator, n <= 96.
//
// Replaces neupan_tpu/ops/pallas/sweep.py:sweep_spd_inverse (_sweep_body,
// _sweep_kernel_rolled for n > 64). Two launchers: the sweep of an input
// that is already Jacobi-scaled and ridged (sweep_spd_inverse_launch), and
// the same with the scaling, ridge and unscaling of
// ops/kernels/sweep.py:spd_inverse_scaled done in the kernel
// (sweep_spd_inverse_scaled_launch), which the QP's inverses take.
//
// Two layouts (see ops/kernels/sweep.py for the bound and the choice):
// * sweep_regs_kernel<W, R>, n <= R (W = 1, R = 32; W = 2, R = 40 or 64):
//   W warps per matrix, lane c holds column c in R registers. The pivot
//   loop is rolled, and every register index stays static because the rows
//   rotate: while pivot j runs, register k holds row (j + k) mod R, so the
//   pivot row is always register 0 and each update writes row r into the
//   register below. Per pivot each lane stores its entry of row j + 1
//   first, one __syncwarp (W = 1) or __syncthreads (W = 2: the 64-thread
//   block is the matrix) publishes it, its reciprocal starts, and the other
//   rows' updates run in phases (loads, products, differences) for ILP.
// * sweep_tiled_kernel, 64 < n <= 96: one 256-thread block per matrix;
//   thread (warp w, lane l) holds elements (w + 8 i, l + 32 q) in
//   registers, i < 12, q < 3. The pivot loop is rolled; the thread owning
//   row j + 1 writes its new values into the other half of a double
//   buffer, so each pivot takes one barrier and no division.
#include "common.cuh"
#include "sweep.cuh"

namespace {

constexpr int kRegsThreads = 64;     // sweep_regs_kernel's block: 2 / W matrices
constexpr int kTiledThreads = 256;   // sweep_tiled_kernel's block: one matrix
constexpr int kTiledRows = 12;       // rows per thread: w + 8 i
constexpr int kTiledCols = 3;        // columns per thread: l + 32 q
constexpr int kMaxN = 96;

template <int W, int R, bool SCALED>
__global__ void __launch_bounds__(kRegsThreads) sweep_regs_kernel(
    const float* __restrict__ M, float* __restrict__ out, int B, int n) {
  constexpr int MPB = kRegsThreads / (32 * W);   // matrices per block
  // the pivot row, in three buffers used in turn and written twice (at c and
  // c + R), so that the rows of the rotated slots are one contiguous read
  // from j
  __shared__ float pivot_row[MPB][3][2 * R];
  __shared__ float dj[MPB][R];

  const int s = threadIdx.x / (32 * W);          // matrix slot in the block
  const int c = threadIdx.x - s * 32 * W;        // this lane's column
  const int b = blockIdx.x * MPB + s;
  if (b >= B) return;                            // a whole warp (W = 1) or block (W = 2)
  const float* Mb = M + static_cast<size_t>(b) * n * n;
  const bool live = c < n;

  // a[k] holds row (j + k) mod R of column c while pivot j runs: row j is
  // always a[0], and each pivot's update shifts the rows down by one slot,
  // so the rolled pivot loop indexes its registers statically. Rows and
  // columns beyond n are 0 and stay 0.
  float a[R];
#pragma unroll
  for (int k = 0; k < R; ++k) a[k] = (live && k < n) ? Mb[k * n + c] : 0.0f;
  float dc = 0.0f;
  if constexpr (SCALED) {
    dc = live ? sweep_jacobi(Mb[c * n + c]) : 0.0f;
    if (c < R) dj[s][c] = dc;
    if constexpr (W == 1) __syncwarp(); else __syncthreads();
#pragma unroll
    for (int k = 0; k < R; ++k) a[k] = sweep_scale_in(a[k], dj[s][k], dc, live && k == c);
  }
  float* cur = pivot_row[s][0];                   // row j
  float* next = pivot_row[s][1];                  // row j + 1
  float* spare = pivot_row[s][2];                 // row j - 1, still read while pivot j starts
  if (c < R) cur[c] = cur[c + R] = a[0];
  if constexpr (W == 1) __syncwarp(); else __syncthreads();
  float inv_d = __frcp_rn(cur[0]);

#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const float* row = cur + j;                   // row[k]: row j at column (j + k) mod R
    const float t = __fmul_rn(a[0], inv_d);
    const bool on_col = c == j;
    // row j + 1 first: it is published with one barrier and its reciprocal
    // starts before the other rows' updates, which hide its latency. A
    // buffer is rewritten two pivots after it was read, so one barrier per
    // pivot orders every store after the last reads of the same buffer.
    const float a1 = sweep_update(a[1], row[1], t, inv_d, false, on_col);
    if (c < R) next[c] = next[c + R] = a1;
    if constexpr (W == 1) __syncwarp(); else __syncthreads();
    const float inv_next = __frcp_rn(next[j + 1]);
    // the other rows in phases (all loads, all products, all differences),
    // so that one warp has R independent operations in flight at each
    // step rather than a chain of four per row
    float a_jr[R], prod[R];
#pragma unroll
    for (int k = 2; k < R; ++k) a_jr[k] = row[k];
#pragma unroll
    for (int k = 2; k < R; ++k) prod[k] = __fmul_rn(a_jr[k], t);
#pragma unroll
    for (int k = 2; k < R; ++k) prod[k] = __fsub_rn(a[k], prod[k]);
#pragma unroll
    for (int k = 2; k < R; ++k) a[k - 1] = on_col ? __fmul_rn(a_jr[k], inv_d) : prod[k];
    a[R - 1] = on_col ? -inv_d : t;               // row j: a_jc / d, -1 / d at (j, j)
    a[0] = a1;
    inv_d = inv_next;
    float* const done = spare;
    spare = cur;
    cur = next;
    next = done;
  }

  if (!live) return;
  float* ob = out + static_cast<size_t>(b) * n * n;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = n + k < R ? n + k : n + k - R;  // the row in slot k after n pivots
    if (r < n) {
      if constexpr (SCALED) ob[r * n + c] = sweep_scale_out(a[k], dj[s][r], dc);
      else ob[r * n + c] = -a[k];
    }
  }
}

template <bool SCALED>
__global__ void __launch_bounds__(kTiledThreads) sweep_tiled_kernel(
    const float* __restrict__ M, float* __restrict__ out, int n) {
  __shared__ __align__(16) float pivot_row[2][kMaxN];
  __shared__ float dj[kMaxN];
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float* Mb = M + static_cast<size_t>(blockIdx.x) * n * n;

  if constexpr (SCALED) {
    if (threadIdx.x < n) dj[threadIdx.x] = sweep_jacobi(Mb[threadIdx.x * (n + 1)]);
    __syncthreads();
  }
  float a[kTiledRows][kTiledCols];
#pragma unroll
  for (int i = 0; i < kTiledRows; ++i) {
    const int r = w + 8 * i;
#pragma unroll
    for (int q = 0; q < kTiledCols; ++q) {
      const int c = l + 32 * q;
      float v = 0.0f;
      if (r < n && c < n) {
        v = Mb[r * n + c];
        if constexpr (SCALED) v = sweep_scale_in(v, dj[r], dj[c], r == c);
        if (r == 0) pivot_row[0][c] = v;
      }
      a[i][q] = v;
    }
  }

  for (int j = 0; j < n; ++j) {
    __syncthreads();                   // row j is in pivot_row[j & 1]
    const float* row = pivot_row[j & 1];
    float* next = pivot_row[(j + 1) & 1];
    const float inv_d = __frcp_rn(row[j]);
    float t[kTiledCols];
    bool on_col[kTiledCols];
#pragma unroll
    for (int q = 0; q < kTiledCols; ++q) {
      const int c = l + 32 * q;
      t[q] = __fmul_rn(c < n ? row[c] : 0.0f, inv_d);
      on_col[q] = c == j;
    }
#pragma unroll
    for (int i = 0; i < kTiledRows; ++i) {
      const int r = w + 8 * i;
      if (r < n) {
        const float a_jr = row[r];
#pragma unroll
        for (int q = 0; q < kTiledCols; ++q)
          a[i][q] = sweep_update(a[i][q], a_jr, t[q], inv_d, r == j, on_col[q]);
        if (r == j + 1) {
#pragma unroll
          for (int q = 0; q < kTiledCols; ++q)
            if (l + 32 * q < n) next[l + 32 * q] = a[i][q];
        }
      }
    }
  }

  float* ob = out + static_cast<size_t>(blockIdx.x) * n * n;
#pragma unroll
  for (int i = 0; i < kTiledRows; ++i) {
    const int r = w + 8 * i;
#pragma unroll
    for (int q = 0; q < kTiledCols; ++q) {
      const int c = l + 32 * q;
      if (r < n && c < n) {
        if constexpr (SCALED) ob[r * n + c] = sweep_scale_out(a[i][q], dj[r], dj[c]);
        else ob[r * n + c] = -a[i][q];
      }
    }
  }
}

template <bool SCALED>
int sweep_launch(const void* M, void* out, int B, int n, void* stream) {
  const auto* m = static_cast<const float*>(M);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (n <= 32) {
    sweep_regs_kernel<1, 32, SCALED><<<(B + 1) / 2, kRegsThreads, 0, st>>>(m, o, B, n);
  } else if (n <= 40) {
    sweep_regs_kernel<2, 40, SCALED><<<B, kRegsThreads, 0, st>>>(m, o, B, n);
  } else if (n <= 64) {
    sweep_regs_kernel<2, 64, SCALED><<<B, kRegsThreads, 0, st>>>(m, o, B, n);
  } else if (n <= kMaxN) {
    sweep_tiled_kernel<SCALED><<<B, kTiledThreads, 0, st>>>(m, o, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sweep_spd_inverse_launch(const void* M, void* out, int B, int n,
                                        void* stream) {
  return sweep_launch<false>(M, out, B, n, stream);
}

extern "C" int sweep_spd_inverse_scaled_launch(const void* M, void* out, int B, int n,
                                               void* stream) {
  return sweep_launch<true>(M, out, B, n, stream);
}
