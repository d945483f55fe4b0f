// Raising a kernel's dynamic shared-memory limit once per process and
// device, shared by the window kernels' launchers. The attribute belongs
// to the function on the current device, so each kernel (the template
// argument) keeps its own flags. Two threads that race on a first launch
// both set the attribute, which is harmless.

#pragma once

#include <cuda_runtime.h>

namespace hm {

constexpr int kMaxDevices = 64;

template <auto kKernel, int kBytes>
cudaError_t allow_dynamic_smem() {
  static bool allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kBytes);
  if (e == cudaSuccess && known) allowed[dev] = true;
  return e;
}

}  // namespace hm
