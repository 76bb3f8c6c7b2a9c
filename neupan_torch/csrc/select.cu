// Exact polygon-distance ranking + top-k selection in two kernels that
// share select.cuh, 256-thread blocks over the frames of one scenario:
//
// * select_flow_kernel replaces neupan_tpu/ops/pallas/select.py:
//   select_topk_flow_pallas (_select_flow_kernel). Each block reads the raw
//   points and velocities of its scenario once and builds its frames'
//   robot-frame coordinates in registers (p + t dt v, then
//   R_t'(p - trans_t)), so the per-frame point flow never reaches device
//   memory. It ranks F = 2 frames per block at a large batch, F = 1 below.
// * select_kernel replaces select_topk_pallas (_select_kernel): the same
//   key and extraction on a point flow that is already in device memory,
//   (B, T+1, 2, P); each block streams its frame's two rows once.
//
// Both keep one sqrt-free ranking key per point (squared segment distance
// outside, normalized face margin inside, 1e9 masked), in registers up to
// P = 2048 and in shared memory above, and extract the K smallest by K
// (key, index) argmin rounds with ties to the lower index, as lax.top_k
// does (select.cuh). Instances: PPT keys per thread (1, 8, or 0 for shared
// memory) by P, F frames per block, and the polygon in registers for
// V = E = 4 (NV = 4) or read through the read-only cache for any other V,
// E (NV = 0). See ops/kernels/select.py for the bounds and the design notes.
#include "select.cuh"

namespace {

// A flow-selection block ranks F frames of its scenario: with F = 2 it
// loads each point once for two frames' keys, and one extraction round's
// latency yields two frames' winners. That pays where blocks queue for the
// SMs; at a small batch F = 1 keeps twice the blocks in flight.
constexpr int kFlowFramesMinBlocks = 2 * 132 * 8;   // two full waves of 8 blocks per SM

template <int PPT, int F, int NV>
__global__ void __launch_bounds__(kSelectThreads) select_flow_kernel(
    const float* __restrict__ pts, const float* __restrict__ vels,
    const bool* __restrict__ mask, const float* __restrict__ tf,
    const float* __restrict__ verts, const float* __restrict__ edges,
    const float* __restrict__ Gn, const float* __restrict__ hn,
    float* __restrict__ keys_out, int* __restrict__ idx_out,
    int Tp1, int P, int V, int E, int K) {
  extern __shared__ unsigned skey[];   // P keys when PPT == 0
  __shared__ unsigned slot[2 * F * 2 * kSelectWarps];

  const int groups = (Tp1 + F - 1) / F;
  const int b = blockIdx.x / groups;
  const int t0 = (blockIdx.x - b * groups) * F;
  const int nf = min(F, Tp1 - t0);
  const float* px = pts + static_cast<size_t>(b) * 2 * P;
  const float* py = px + P;
  const float* vx = vels + static_cast<size_t>(b) * 2 * P;
  const float* vy = vx + P;
  const bool* mk = mask + static_cast<size_t>(b) * P;
  // transform table rows: c, s, tx, ty, step — (5, T+1) per scenario; a
  // ragged last block ranks its last frame twice
  const float* tfb = tf + static_cast<size_t>(b) * 5 * Tp1;
  float c[F], s[F], tx[F], ty[F], step[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int t = min(t0 + f, Tp1 - 1);
    c[f] = tfb[0 * Tp1 + t];
    s[f] = tfb[1 * Tp1 + t];
    tx[f] = tfb[2 * Tp1 + t];
    ty[f] = tfb[3 * Tp1 + t];
    step[f] = tfb[4 * Tp1 + t];
  }
  const SelectPolygon<NV> poly(verts, edges, Gn, hn, V, E);
  const unsigned masked = select_order(kSelectInf);

  auto keys_of = [&](unsigned p) {
    const float x0 = px[p], y0 = py[p], vx0 = vx[p], vy0 = vy[p];
    const bool live = mk[p];
    SelectKeys<F> k;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float pxg = __fadd_rn(x0, __fmul_rn(step[f], vx0));
      const float pyg = __fadd_rn(y0, __fmul_rn(step[f], vy0));
      const float dx = __fsub_rn(pxg, tx[f]);
      const float dy = __fsub_rn(pyg, ty[f]);
      const float x = __fadd_rn(__fmul_rn(c[f], dx), __fmul_rn(s[f], dy));
      const float y = __fsub_rn(__fmul_rn(c[f], dy), __fmul_rn(s[f], dx));
      k.u[f] = live ? select_order(poly.key(x, y)) : masked;
    }
    return k;
  };
  const size_t out0 = (static_cast<size_t>(b) * Tp1 + t0) * K;
  select_extract<PPT, F>(keys_of, skey, slot, keys_out + out0, idx_out + out0, P, K, nf);
}

template <int PPT, int NV>
__global__ void __launch_bounds__(kSelectThreads) select_kernel(
    const float* __restrict__ flow, const bool* __restrict__ mask,
    const float* __restrict__ verts, const float* __restrict__ edges,
    const float* __restrict__ Gn, const float* __restrict__ hn,
    float* __restrict__ keys_out, int* __restrict__ idx_out,
    int Tp1, int P, int V, int E, int K) {
  extern __shared__ unsigned skey[];   // P keys when PPT == 0
  __shared__ unsigned slot[2 * 2 * kSelectWarps];

  const int b = blockIdx.x / Tp1;
  // flow is (B, T+1, 2, P): this block's frame is two contiguous rows
  const float* fx = flow + static_cast<size_t>(blockIdx.x) * 2 * P;
  const float* fy = fx + P;
  const bool* mk = mask + static_cast<size_t>(b) * P;
  const SelectPolygon<NV> poly(verts, edges, Gn, hn, V, E);
  const unsigned masked = select_order(kSelectInf);

  auto keys_of = [&](unsigned p) {
    return SelectKeys<1>{{mk[p] ? select_order(poly.key(fx[p], fy[p])) : masked}};
  };
  const size_t out0 = static_cast<size_t>(blockIdx.x) * K;
  select_extract<PPT, 1>(keys_of, skey, slot, keys_out + out0, idx_out + out0, P, K, 1);
}

// Launches the instance for P, the polygon and the batch with the shared
// memory its keys need.
template <typename Kernels, typename... Args>
int select_dispatch(int B, int Tp1, int P, int V, int E, void* stream, Args... args) {
  // keys per thread in registers (one for the facade's P=100 is faster at
  // B=1 than eight), or 0: shared memory
  const int ppt = P <= kSelectThreads ? 1 : P <= 8 * kSelectThreads ? 8 : 0;
  const bool quad = V == 4 && E == 4;
  const bool pairs = Kernels::kPairs && ppt > 0 && B * ((Tp1 + 1) / 2) >= kFlowFramesMinBlocks;
  const int blocks = B * (pairs ? (Tp1 + 1) / 2 : Tp1);
  auto kernel = ppt == 0 ? (quad ? Kernels::template kernel<0, 1, 4>()
                                 : Kernels::template kernel<0, 1, 0>())
              : pairs ? (ppt == 1 ? (quad ? Kernels::template kernel<1, 2, 4>()
                                          : Kernels::template kernel<1, 2, 0>())
                                  : (quad ? Kernels::template kernel<8, 2, 4>()
                                          : Kernels::template kernel<8, 2, 0>()))
                      : (ppt == 1 ? (quad ? Kernels::template kernel<1, 1, 4>()
                                          : Kernels::template kernel<1, 1, 0>())
                                  : (quad ? Kernels::template kernel<8, 1, 4>()
                                          : Kernels::template kernel<8, 1, 0>()));
  const size_t smem = ppt == 0 ? static_cast<size_t>(P) * sizeof(unsigned) : 0;
  cudaError_t err = neupan_allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kSelectThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

struct FlowKernels {
  static constexpr bool kPairs = true;
  template <int PPT, int F, int NV>
  static auto kernel() { return select_flow_kernel<PPT, F, NV>; }
};

struct FrameKernels {           // one frame per block: each frame's rows are its own
  static constexpr bool kPairs = false;
  template <int PPT, int F, int NV>
  static auto kernel() { return select_kernel<PPT, NV>; }
};

}  // namespace

extern "C" int select_topk_flow_launch(
    const void* pts, const void* vels, const void* mask, const void* tf,
    const void* verts, const void* edges, const void* Gn, const void* hn,
    void* keys, void* idx, int B, int Tp1, int P, int V, int E, int K,
    void* stream) {
  return select_dispatch<FlowKernels>(
      B, Tp1, P, V, E, stream, static_cast<const float*>(pts), static_cast<const float*>(vels),
      static_cast<const bool*>(mask), static_cast<const float*>(tf),
      static_cast<const float*>(verts), static_cast<const float*>(edges),
      static_cast<const float*>(Gn), static_cast<const float*>(hn),
      static_cast<float*>(keys), static_cast<int*>(idx), Tp1, P, V, E, K);
}

extern "C" int select_topk_launch(
    const void* flow, const void* mask, const void* verts, const void* edges,
    const void* Gn, const void* hn, void* keys, void* idx,
    int B, int Tp1, int P, int V, int E, int K, void* stream) {
  return select_dispatch<FrameKernels>(
      B, Tp1, P, V, E, stream, static_cast<const float*>(flow), static_cast<const bool*>(mask),
      static_cast<const float*>(verts), static_cast<const float*>(edges),
      static_cast<const float*>(Gn), static_cast<const float*>(hn),
      static_cast<float*>(keys), static_cast<int*>(idx), Tp1, P, V, E, K);
}
