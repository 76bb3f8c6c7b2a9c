// The library's error text, looked up by the Python wrappers for a code
// that a launcher returned.
#include <cuda_runtime.h>

extern "C" const char* neupan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
