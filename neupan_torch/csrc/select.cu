// Exact polygon-distance ranking + top-k selection, one block per
// (scenario, horizon frame), in two kernels that share select.cuh:
//
// * select_flow_kernel replaces neupan_tpu/ops/pallas/select.py:
//   select_topk_flow_pallas (_select_flow_kernel). Each block reads the raw
//   points and velocities of its scenario once and builds the frame's
//   robot-frame coordinates in registers (p + t dt v, then
//   R_t'(p - trans_t)), so the per-frame point flow never reaches device
//   memory.
// * select_kernel replaces select_topk_pallas (_select_kernel): the same
//   key and extraction on a point flow that is already in device memory,
//   (B, T+1, 2, P); each block streams its frame's two rows once.
//
// Both keep one sqrt-free ranking key per point in shared memory (squared
// segment distance outside, normalized face margin inside, 1e9 masked) and
// extract the K smallest by K block-wide argmin rounds with ties to the
// lower index, as lax.top_k does. See ops/kernels/select.py for the bounds
// and the design notes.
#include "select.cuh"

namespace {

__global__ void select_flow_kernel(
    const float* __restrict__ pts, const float* __restrict__ vels,
    const bool* __restrict__ mask, const float* __restrict__ tf,
    const float* __restrict__ verts, const float* __restrict__ edges,
    const float* __restrict__ Gn, const float* __restrict__ hn,
    float* __restrict__ keys_out, int* __restrict__ idx_out,
    int Tp1, int P, int V, int E, int K) {
  extern __shared__ float skey[];  // P keys
  __shared__ float wk[kSelectWarps];
  __shared__ int wi[kSelectWarps];

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

  for (int p = threadIdx.x; p < P; p += kSelectThreads) {
    const float pxg = __fadd_rn(px[p], __fmul_rn(step, vx[p]));
    const float pyg = __fadd_rn(py[p], __fmul_rn(step, vy[p]));
    const float dx = __fsub_rn(pxg, tx);
    const float dy = __fsub_rn(pyg, ty);
    const float x = __fadd_rn(__fmul_rn(c, dx), __fmul_rn(s, dy));
    const float y = __fsub_rn(__fmul_rn(c, dy), __fmul_rn(s, dx));
    const float key = select_key(x, y, verts, edges, Gn, hn, V, E);
    skey[p] = mk[p] ? key : kSelectInf;
  }
  __syncthreads();
  select_extract_topk(skey, wk, wi, keys_out + static_cast<size_t>(blockIdx.x) * K,
                      idx_out + static_cast<size_t>(blockIdx.x) * K, P, K);
}

__global__ void select_kernel(
    const float* __restrict__ flow, const bool* __restrict__ mask,
    const float* __restrict__ verts, const float* __restrict__ edges,
    const float* __restrict__ Gn, const float* __restrict__ hn,
    float* __restrict__ keys_out, int* __restrict__ idx_out,
    int Tp1, int P, int V, int E, int K) {
  extern __shared__ float skey[];  // P keys
  __shared__ float wk[kSelectWarps];
  __shared__ int wi[kSelectWarps];

  const int b = blockIdx.x / Tp1;
  // flow is (B, T+1, 2, P): this block's frame is two contiguous rows
  const float* fx = flow + static_cast<size_t>(blockIdx.x) * 2 * P;
  const float* fy = fx + P;
  const bool* mk = mask + static_cast<size_t>(b) * P;

  for (int p = threadIdx.x; p < P; p += kSelectThreads) {
    const float key = select_key(fx[p], fy[p], verts, edges, Gn, hn, V, E);
    skey[p] = mk[p] ? key : kSelectInf;
  }
  __syncthreads();
  select_extract_topk(skey, wk, wi, keys_out + static_cast<size_t>(blockIdx.x) * K,
                      idx_out + static_cast<size_t>(blockIdx.x) * K, P, K);
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
  select_flow_kernel<<<B * Tp1, kSelectThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(vels),
      static_cast<const bool*>(mask), static_cast<const float*>(tf),
      static_cast<const float*>(verts), static_cast<const float*>(edges),
      static_cast<const float*>(Gn), static_cast<const float*>(hn),
      static_cast<float*>(keys), static_cast<int*>(idx), Tp1, P, V, E, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int select_topk_launch(
    const void* flow, const void* mask, const void* verts, const void* edges,
    const void* Gn, const void* hn, void* keys, void* idx,
    int B, int Tp1, int P, int V, int E, int K, void* stream) {
  const size_t smem = static_cast<size_t>(P) * sizeof(float);
  cudaError_t err = neupan_allow_smem(select_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<<<B * Tp1, kSelectThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(flow), static_cast<const bool*>(mask),
      static_cast<const float*>(verts), static_cast<const float*>(edges),
      static_cast<const float*>(Gn), static_cast<const float*>(hn),
      static_cast<float*>(keys), static_cast<int*>(idx), Tp1, P, V, E, K);
  return static_cast<int>(cudaGetLastError());
}
