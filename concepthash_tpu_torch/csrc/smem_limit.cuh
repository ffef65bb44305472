// The dynamic shared-memory limit of a kernel, raised once.
//
// cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
// bytes) is a host call that no stream orders. ensure_smem_limit makes it
// only when a kernel is launched on a device with more shared memory than
// any earlier launch of it there asked for, so a launch made again at the
// same size (as inside CUDA graph capture, after an eager run of the same
// shapes) issues no attribute call, only the launch itself.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

template <typename Kernel>
inline cudaError_t ensure_smem_limit(Kernel kernel, int bytes) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, int> limits;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_pair(dev, reinterpret_cast<const void*>(kernel));
  std::lock_guard<std::mutex> lock(mu);
  auto it = limits.find(key);
  if (it != limits.end() && it->second >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) limits[key] = bytes;
  return e;
}
