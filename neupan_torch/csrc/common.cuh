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
