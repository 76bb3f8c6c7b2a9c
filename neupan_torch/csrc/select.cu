// Exact polygon-distance ranking + top-k selection with the point flow
// generated in the kernel: one block per (scenario, horizon frame).
//
// Replaces neupan_tpu/ops/pallas/select.py:select_topk_flow_pallas
// (_select_flow_kernel + _rank_and_extract). Each block reads the raw
// points and velocities of its scenario once, builds the frame's
// robot-frame coordinates in registers (p + t dt v, then R_t'(p - trans_t)),
// keeps one sqrt-free ranking key per point in shared memory (squared
// segment distance outside, normalized face margin inside, 1e9 masked),
// then extracts the K smallest by K block-wide argmin rounds with ties to
// the lower index, as lax.top_k does. See ops/kernels/select.py for the
// bound and the design note.
//
// The key arithmetic uses round-to-nearest intrinsics in the reference's
// expression order, so no FMA contraction can flip a near-tie against the
// plain PyTorch version.
#include "common.cuh"

namespace {

constexpr float kInf = 1e9f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (key, index) order: smaller key first, lower index on ties.
__device__ __forceinline__ bool better(float ka, int ia, float kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

__global__ void select_flow_kernel(
    const float* __restrict__ pts, const float* __restrict__ vels,
    const bool* __restrict__ mask, const float* __restrict__ tf,
    const float* __restrict__ verts, const float* __restrict__ edges,
    const float* __restrict__ Gn, const float* __restrict__ hn,
    float* __restrict__ keys_out, int* __restrict__ idx_out,
    int Tp1, int P, int V, int E, int K) {
  extern __shared__ float skey[];  // P keys
  __shared__ float wk[kWarps];
  __shared__ int wi[kWarps];

  const int b = blockIdx.x / Tp1;
  const int t = blockIdx.x - b * Tp1;
  const float* px = pts + static_cast<size_t>(b) * 2 * P;
  const float* py = px + P;
  const float* vx = vels + static_cast<size_t>(b) * 2 * P;
  const float* vy = vx + P;
  const bool* mk = mask + static_cast<size_t>(b) * P;
  // transform table rows: c, s, tx, ty, step — (5, T+1) per scenario
  const float* tfb = tf + static_cast<size_t>(b) * 5 * Tp1;
  const float c = tfb[0 * Tp1 + t], s = tfb[1 * Tp1 + t];
  const float tx = tfb[2 * Tp1 + t], ty = tfb[3 * Tp1 + t];
  const float step = tfb[4 * Tp1 + t];

  for (int p = threadIdx.x; p < P; p += kThreads) {
    const float pxg = __fadd_rn(px[p], __fmul_rn(step, vx[p]));
    const float pyg = __fadd_rn(py[p], __fmul_rn(step, vy[p]));
    const float dx = __fsub_rn(pxg, tx);
    const float dy = __fsub_rn(pyg, ty);
    const float x = __fadd_rn(__fmul_rn(c, dx), __fmul_rn(s, dy));
    const float y = __fsub_rn(__fmul_rn(c, dy), __fmul_rn(s, dx));

    float d_out_sq = kInf;
    for (int j = 0; j < V; ++j) {
      const float ax = verts[j], ay = verts[V + j];
      const float ex = edges[j], ey = edges[V + j], inv_ee = edges[2 * V + j];
      float tt = __fmul_rn(__fadd_rn(__fmul_rn(__fsub_rn(x, ax), ex),
                                     __fmul_rn(__fsub_rn(y, ay), ey)),
                           inv_ee);
      tt = fminf(fmaxf(tt, 0.0f), 1.0f);
      const float ddx = __fsub_rn(x, __fadd_rn(ax, __fmul_rn(ex, tt)));
      const float ddy = __fsub_rn(y, __fadd_rn(ay, __fmul_rn(ey, tt)));
      d_out_sq = fminf(d_out_sq, __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)));
    }
    float d_in = -kInf;
    for (int e = 0; e < E; ++e) {
      d_in = fmaxf(d_in, __fsub_rn(__fadd_rn(__fmul_rn(Gn[2 * e], x),
                                             __fmul_rn(Gn[2 * e + 1], y)),
                                   hn[e]));
    }
    const float key = d_in <= 0.0f ? d_in : d_out_sq;
    skey[p] = mk[p] ? key : kInf;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* kout = keys_out + static_cast<size_t>(blockIdx.x) * K;
  int* iout = idx_out + static_cast<size_t>(blockIdx.x) * K;
  for (int kk = 0; kk < K; ++kk) {
    // each thread scans its points in ascending order: strict < keeps the
    // lower index on ties
    float bk = INFINITY;
    int bi = 0x7fffffff;
    for (int p = threadIdx.x; p < P; p += kThreads) {
      const float v = skey[p];
      if (v < bk) { bk = v; bi = p; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ok = __shfl_xor_sync(0xffffffffu, bk, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ok, oi, bk, bi)) { bk = ok; bi = oi; }
    }
    if (lane == 0) { wk[warp] = bk; wi[warp] = bi; }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w)
        if (better(wk[w], wi[w], bk, bi)) { bk = wk[w]; bi = wi[w]; }
      kout[kk] = bk;
      iout[kk] = bi;
      if (bi < P) skey[bi] = kInf;  // the winner leaves the race, as in the reference
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int select_topk_flow_launch(
    const void* pts, const void* vels, const void* mask, const void* tf,
    const void* verts, const void* edges, const void* Gn, const void* hn,
    void* keys, void* idx, int B, int Tp1, int P, int V, int E, int K,
    void* stream) {
  const size_t smem = static_cast<size_t>(P) * sizeof(float);
  cudaError_t err = neupan_allow_smem(select_flow_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  select_flow_kernel<<<B * Tp1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(vels),
      static_cast<const bool*>(mask), static_cast<const float*>(tf),
      static_cast<const float*>(verts), static_cast<const float*>(edges),
      static_cast<const float*>(Gn), static_cast<const float*>(hn),
      static_cast<float*>(keys), static_cast<int*>(idx), Tp1, P, V, E, K);
  return static_cast<int>(cudaGetLastError());
}
