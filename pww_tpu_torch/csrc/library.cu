// What the port's kernel library offers as a whole, beside the kernels'
// own entry points: the text of a CUDA error code the entries return.
#include <cuda_runtime.h>

extern "C" const char* pww_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
