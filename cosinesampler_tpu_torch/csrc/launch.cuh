// Host-side launch helpers shared by the kernel sources.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

namespace csm {

// A block needs no opt-in attribute for this much dynamic shared memory.
constexpr int kStaticSmemBytes = 48 * 1024;

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct DeviceLimits {
  int sms;           // streaming multiprocessors
  int smem_optin;    // shared memory a block may opt in to
  int smem_per_sm;   // shared memory of one SM
};

inline cudaError_t device_limits(DeviceLimits* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&out->sms, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&out->smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&out->smem_per_sm,
                                cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                device);
}

// Lets kernel take `bytes` of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kStaticSmemBytes)) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace csm
