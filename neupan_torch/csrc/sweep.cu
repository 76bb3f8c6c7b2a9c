// Batched SPD inverse by the sweep operator: one block per matrix.
//
// Replaces neupan_tpu/ops/pallas/sweep.py:sweep_spd_inverse. The matrix
// (at most 96 x 96 = 36 KB) is loaded once into shared memory, the n pivot
// steps run there with a barrier between steps, and the inverse is written
// once. See ops/kernels/sweep.py for the bound and the design note.
#include "common.cuh"
#include "sweep.cuh"

namespace {

__global__ void sweep_kernel(const float* __restrict__ M, float* __restrict__ out, int n) {
  extern __shared__ float smem[];
  float* A = smem;          // n * n
  float* row = A + n * n;   // n
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) A[e] = M[base + e];
  __syncthreads();
  sweep_inverse_inplace(A, row, n);
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) out[base + e] = A[e];
}

}  // namespace

extern "C" int sweep_spd_inverse_launch(const void* M, void* out, int B, int n,
                                        void* stream) {
  const size_t smem = static_cast<size_t>(n * n + n) * sizeof(float);
  cudaError_t err = neupan_allow_smem(sweep_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sweep_kernel<<<B, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(M), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
