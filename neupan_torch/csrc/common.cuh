// Shared helpers for the neupan_torch kernels.
//
// All kernels are built into one library with a plain C interface: each
// launcher takes raw device pointers, the sizes and PyTorch's current
// stream, launches on that stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch
// (errors.cu gives the error text).
#pragma once

#include <cuda_runtime.h>

// Dynamic shared memory above the default 48 KB must be opted into per
// kernel; below it nothing is needed.
template <typename Kernel>
static inline cudaError_t neupan_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Sum over the 32 lanes of a warp; every lane gets the total.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

namespace neupan_detail {
template <int H, int N>
__device__ __forceinline__ void reduce_scatter_level(float (&p)[N], int lane) {
  if constexpr (H >= 1) {
    constexpr int off = 32 * H / N;
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? p[i] : p[i + H];
      const float keep = up ? p[i + H] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    reduce_scatter_level<H / 2, N>(p, lane);
  }
}
}  // namespace neupan_detail

// Sums of N values (N a power of two, at most 32) over the 32 lanes of a
// warp: lane l gets the total of value l / (32 / N). Each level sends half
// of what a lane still holds to its partner and keeps the other half, so N
// sums cost N - 1 + log2(32 / N) shuffles (31 for N = 32) instead of 5 N.
template <int N>
__device__ __forceinline__ float warp_reduce_scatter(float (&p)[N], int lane) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N must be a power of two <= 32");
  neupan_detail::reduce_scatter_level<N / 2, N>(p, lane);
  float v = p[0];
#pragma unroll
  for (int off = 16 / N; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
