// Device code shared by the two selection kernels (select.cu): the
// sqrt-free polygon-distance ranking key of one robot-frame point, and the
// block-wide extraction of the K smallest keys from shared memory.
//
// Replaces neupan_tpu/ops/pallas/select.py:_rank_and_extract, which the two
// TPU selection kernels share in the same way. The key arithmetic uses
// round-to-nearest intrinsics in the reference's expression order, so no
// FMA contraction can flip a near-tie against the plain PyTorch version.
#pragma once

#include "common.cuh"

constexpr float kSelectInf = 1e9f;
constexpr int kSelectThreads = 256;
constexpr int kSelectWarps = kSelectThreads / 32;

// (key, index) order: smaller key first, lower index on ties.
__device__ __forceinline__ bool select_better(float ka, int ia, float kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// Ranking key of the robot-frame point (x, y): the squared distance to the
// nearest edge segment outside the polygon, the largest normalized face
// margin (<= 0) inside. verts (2, V), edges (3, V) rows [ex, ey, 1/|e|^2],
// Gn (E, 2), hn (E,).
__device__ __forceinline__ float select_key(
    float x, float y, const float* __restrict__ verts, const float* __restrict__ edges,
    const float* __restrict__ Gn, const float* __restrict__ hn, int V, int E) {
  float d_out_sq = kSelectInf;
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
  float d_in = -kSelectInf;
  for (int e = 0; e < E; ++e) {
    d_in = fmaxf(d_in, __fsub_rn(__fadd_rn(__fmul_rn(Gn[2 * e], x),
                                           __fmul_rn(Gn[2 * e + 1], y)),
                                 hn[e]));
  }
  return d_in <= 0.0f ? d_in : d_out_sq;
}

// The K smallest of the block's P keys in shared memory `skey`, ascending,
// ties to the lower index, by K block-wide (key, index) argmin rounds; a
// winner's key is refilled with 1e9, as the reference's passes do. Must be
// called by all kSelectThreads threads after a barrier that made `skey`
// visible; `wk`/`wi` are kSelectWarps-sized shared scratch. Overwrites skey.
__device__ __forceinline__ void select_extract_topk(
    float* skey, float* wk, int* wi, float* __restrict__ kout, int* __restrict__ iout,
    int P, int K) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int kk = 0; kk < K; ++kk) {
    // each thread scans its points in ascending order: strict < keeps the
    // lower index on ties
    float bk = INFINITY;
    int bi = 0x7fffffff;
    for (int p = threadIdx.x; p < P; p += kSelectThreads) {
      const float v = skey[p];
      if (v < bk) { bk = v; bi = p; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ok = __shfl_xor_sync(0xffffffffu, bk, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (select_better(ok, oi, bk, bi)) { bk = ok; bi = oi; }
    }
    if (lane == 0) { wk[warp] = bk; wi[warp] = bi; }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kSelectWarps; ++w)
        if (select_better(wk[w], wi[w], bk, bi)) { bk = wk[w]; bi = wi[w]; }
      kout[kk] = bk;
      iout[kk] = bi;
      if (bi < P) skey[bi] = kSelectInf;  // the winner leaves the race
    }
    __syncthreads();
  }
}
