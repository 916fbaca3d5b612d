// Helpers shared by the port's kernels. Each csrc/*.cu compiles to an object
// of its own; ops/cuda_build.py links them all into one library.
#pragma once

#include <atomic>
#include <cuda_runtime.h>

namespace pww {

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Raise a kernel's dynamic shared-memory cap to all the card lets one block
// opt in to, once per device (`done` is the caller's flag, one bit per
// device), so that a launch makes no attribute call. A launch that asks for
// more than the card has still fails, with cudaErrorInvalidValue.
inline cudaError_t allow_max_shared_memory(const void* kernel,
                                           std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - static_cast<int>(attr.sharedSizeBytes));
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

}  // namespace pww
