// Device code shared by the two selection kernels (select.cu): the
// sqrt-free polygon-distance ranking key of one robot-frame point, and the
// extraction of the K smallest keys of a block.
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
constexpr unsigned kSelectNone = 0xffffffffu;   // no point: above every key and index

// A float key as an unsigned int of the same order (a < b as floats iff
// the images compare so), so that one warp reduction finds the smallest
// key and a second the lowest index holding it. -0 is first folded onto +0,
// which compares equal to it.
__device__ __forceinline__ unsigned select_order(float key) {
  const unsigned u = __float_as_uint(__fadd_rn(key, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float select_unorder(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Squared distance of (x, y) to the segment from (ax, ay) along (ex, ey);
// iee = 1 / |e|^2.
__device__ __forceinline__ float select_edge_sq(float x, float y, float ax, float ay, float ex,
                                                float ey, float iee) {
  float tt = __fmul_rn(__fadd_rn(__fmul_rn(__fsub_rn(x, ax), ex),
                                 __fmul_rn(__fsub_rn(y, ay), ey)),
                       iee);
  tt = fminf(fmaxf(tt, 0.0f), 1.0f);
  const float ddx = __fsub_rn(x, __fadd_rn(ax, __fmul_rn(ex, tt)));
  const float ddy = __fsub_rn(y, __fadd_rn(ay, __fmul_rn(ey, tt)));
  return __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
}

// Normalized margin of (x, y) past face (gx, gy) . p <= h.
__device__ __forceinline__ float select_face(float x, float y, float gx, float gy, float h) {
  return __fsub_rn(__fadd_rn(__fmul_rn(gx, x), __fmul_rn(gy, y)), h);
}

// The robot polygon as the key reads it: verts (2, V), edges (3, V) rows
// [ex, ey, 1/|e|^2], Gn (E, 2), hn (E,). SelectPolygon<4> (the diff and
// acker robots' rectangles) holds the 32 numbers in registers, loaded once
// per thread; SelectPolygon<0> takes any V and E and reads them through
// the read-only cache.
template <int NV>
struct SelectPolygon {
  float ax[NV], ay[NV], ex[NV], ey[NV], iee[NV], gx[NV], gy[NV], h[NV];

  __device__ __forceinline__ SelectPolygon(const float* __restrict__ verts,
                                           const float* __restrict__ edges,
                                           const float* __restrict__ Gn,
                                           const float* __restrict__ hn, int, int) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      ax[j] = __ldg(verts + j);
      ay[j] = __ldg(verts + NV + j);
      ex[j] = __ldg(edges + j);
      ey[j] = __ldg(edges + NV + j);
      iee[j] = __ldg(edges + 2 * NV + j);
      gx[j] = __ldg(Gn + 2 * j);
      gy[j] = __ldg(Gn + 2 * j + 1);
      h[j] = __ldg(hn + j);
    }
  }

  // The squared distance to the nearest edge segment outside the polygon,
  // the largest normalized face margin (<= 0) inside.
  __device__ __forceinline__ float key(float x, float y) const {
    float d_out_sq = kSelectInf;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      d_out_sq = fminf(d_out_sq, select_edge_sq(x, y, ax[j], ay[j], ex[j], ey[j], iee[j]));
    float d_in = -kSelectInf;
#pragma unroll
    for (int e = 0; e < NV; ++e) d_in = fmaxf(d_in, select_face(x, y, gx[e], gy[e], h[e]));
    return d_in <= 0.0f ? d_in : d_out_sq;
  }
};

template <>
struct SelectPolygon<0> {
  const float *verts, *edges, *Gn, *hn;
  int V, E;

  __device__ __forceinline__ SelectPolygon(const float* __restrict__ verts_,
                                           const float* __restrict__ edges_,
                                           const float* __restrict__ Gn_,
                                           const float* __restrict__ hn_, int V_, int E_)
      : verts(verts_), edges(edges_), Gn(Gn_), hn(hn_), V(V_), E(E_) {}

  __device__ __forceinline__ float key(float x, float y) const {
    float d_out_sq = kSelectInf;
    for (int j = 0; j < V; ++j)
      d_out_sq = fminf(d_out_sq, select_edge_sq(x, y, __ldg(verts + j), __ldg(verts + V + j),
                                                __ldg(edges + j), __ldg(edges + V + j),
                                                __ldg(edges + 2 * V + j)));
    float d_in = -kSelectInf;
    for (int e = 0; e < E; ++e)
      d_in = fmaxf(d_in, select_face(x, y, __ldg(Gn + 2 * e), __ldg(Gn + 2 * e + 1),
                                     __ldg(hn + e)));
    return d_in <= 0.0f ? d_in : d_out_sq;
  }
};

// The lowest key of slots [L, L + N) of a thread's register keys and its
// slot, by a tree (depth log2 N, not a chain of N): the slots hold the
// thread's points in ascending index order, so on equal keys the left one,
// the lower index, wins.
template <int L, int N, int PPT>
__device__ __forceinline__ void select_min_slot(const unsigned (&keys)[PPT], unsigned& bk,
                                                unsigned& bs) {
  if constexpr (N == 1) {
    bk = keys[L];
    bs = L;
  } else {
    unsigned k0, s0, k1, s1;
    select_min_slot<L, N / 2>(keys, k0, s0);
    select_min_slot<L + N / 2, N - N / 2>(keys, k1, s1);
    const bool right = k1 < k0;
    bk = right ? k1 : k0;
    bs = right ? s1 : s0;
  }
}

// Ranks the P points of F frames of a scenario and writes each frame's K
// smallest keys, ascending, ties to the lower index, with their indices; a
// winner's key is refilled with 1e9 and stays in the race, as the
// reference's argmin passes do. Must be called by all kSelectThreads
// threads of the block.
//
// keys_of(p).u[f] is point p's ordered key in frame f (select_order, or
// the 1e9 image for a masked point). Thread t owns points t + 256 i: with
// PPT > 0 their keys stay in registers, with PPT == 0 (F == 1) in `skey`
// (P unsigned ints of shared memory). Each thread keeps the best (key,
// index) of its own points in each frame. A round is, for every frame at
// once, two warp reductions (__reduce_min_sync: the smallest key, then the
// lowest index holding it), the 8 warp winners into a double-buffered
// shared slot, one barrier, and the same two reductions over the 8 in
// every warp; then the thread that owned a winner refills it and finds
// its own best again. The F frames' reductions are independent, so one
// round's latency serves F frames. `slot` is 2 x F x 2 x kSelectWarps
// shared unsigned ints; kout/iout point at the block's first frame, of
// which nf <= F are real (a ragged last block ranks a copy of its last
// frame and writes nothing for it).
// A point's ordered keys in the F frames a block ranks, returned by value
// so that they stay in registers.
template <int F>
struct SelectKeys {
  unsigned u[F];
};

template <int PPT, int F, typename KeysOf>
__device__ __forceinline__ void select_extract(KeysOf keys_of, unsigned* skey, unsigned* slot,
                                               float* __restrict__ kout, int* __restrict__ iout,
                                               int P, int K, int nf) {
  static_assert(PPT > 0 || F == 1, "shared-memory keys hold one frame");
  constexpr int W = kSelectWarps;
  const unsigned tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned refill = select_order(kSelectInf);
  unsigned keys[F][PPT > 0 ? PPT : 1];
  unsigned bk[F], bi[F];
  if constexpr (PPT > 0) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const unsigned p = tid + i * kSelectThreads;
      SelectKeys<F> k;
#pragma unroll
      for (int f = 0; f < F; ++f) k.u[f] = kSelectNone;
      if (p < static_cast<unsigned>(P)) k = keys_of(p);
#pragma unroll
      for (int f = 0; f < F; ++f) keys[f][i] = k.u[f];
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      unsigned slot_i;
      select_min_slot<0, PPT>(keys[f], bk[f], slot_i);
      bi[f] = tid + slot_i * kSelectThreads;
    }
  } else {
    bk[0] = bi[0] = kSelectNone;
    // ascending index order with a strict < keeps the lower index on ties
    for (unsigned p = tid; p < static_cast<unsigned>(P); p += kSelectThreads) {
      const unsigned u = keys_of(p).u[0];
      skey[p] = u;                     // only this thread reads it again
      if (u < bk[0]) { bk[0] = u; bi[0] = p; }
    }
  }

  for (int kk = 0; kk < K; ++kk) {
    unsigned wk[F], wi[F], gk[F], gi[F];
#pragma unroll
    for (int f = 0; f < F; ++f) wk[f] = __reduce_min_sync(0xffffffffu, bk[f]);
#pragma unroll
    for (int f = 0; f < F; ++f)
      wi[f] = __reduce_min_sync(0xffffffffu, bk[f] == wk[f] ? bi[f] : kSelectNone);
    unsigned* s = slot + (kk & 1) * F * 2 * W;
    if (lane == 0) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        s[f * 2 * W + warp] = wk[f];
        s[f * 2 * W + W + warp] = wi[f];
      }
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < F; ++f) {
      wk[f] = lane < W ? s[f * 2 * W + lane] : kSelectNone;
      wi[f] = lane < W ? s[f * 2 * W + W + lane] : kSelectNone;
    }
#pragma unroll
    for (int f = 0; f < F; ++f) gk[f] = __reduce_min_sync(0xffffffffu, wk[f]);
#pragma unroll
    for (int f = 0; f < F; ++f)
      gi[f] = __reduce_min_sync(0xffffffffu, wk[f] == gk[f] ? wi[f] : kSelectNone);
    if (tid == 0) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        if (f < nf) {
          kout[f * K + kk] = select_unorder(gk[f]);
          iout[f * K + kk] = static_cast<int>(gi[f]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      if (bi[f] != gi[f]) continue;    // this thread did not own frame f's winner
      if constexpr (PPT > 0) {
#pragma unroll
        for (int i = 0; i < PPT; ++i)
          if (tid + i * kSelectThreads == gi[f]) keys[f][i] = refill;
        unsigned slot_i;
        select_min_slot<0, PPT>(keys[f], bk[f], slot_i);
        bi[f] = tid + slot_i * kSelectThreads;
      } else {
        skey[gi[f]] = refill;
        bk[f] = bi[f] = kSelectNone;
        for (unsigned p = tid; p < static_cast<unsigned>(P); p += kSelectThreads) {
          const unsigned u = skey[p];
          if (u < bk[f]) { bk[f] = u; bi[f] = p; }
        }
      }
    }
  }
}
