// Shared pieces of the hand-written Hopper kernels and the error convention
// of their plain C entry points: each returns the cudaError_t of its launch,
// or cudaErrorInvalidValue for a shape or a pointer it does not take, and the
// Python wrapper raises on anything but 0.
//  * the exact GELU of K3/K4 (geglu.cu, on the wgmma pieces of
//    wgmma_tile.cuh);
//  * 16-byte alignment checks of the entries' pointers;
//  * the dynamic shared-memory opt-in, made on every launch (allow_smem) or
//    once per device (allow_smem_once: the K3, K4 and out-projection
//    launchers, on whose host path every microsecond shows).
// The attention kernels' core is proj_attend.cuh, the flash kernels' pieces
// flash_tile.cuh, the TMA/mbarrier/wgmma pieces wgmma_tile.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace mdk {

using bf16 = __nv_bfloat16;

// exact (erf) GELU, as diffusers' GEGLU and the JAX package compute it
static __device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
}

// Whether every non-null pointer is 16-byte aligned (cp.async, uint4).
static inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (p != nullptr && (reinterpret_cast<uintptr_t>(p) & 15) != 0)
      return false;
  return true;
}

// Kernels needing more than 48 KB of dynamic shared memory must opt in.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The dynamic shared-memory opt-in of `kernel`, made once per device (bit d
// of `devices`) rather than on every launch, which would cost host time.
template <typename Kernel>
static cudaError_t allow_smem_once(Kernel kernel, size_t bytes,
                                   unsigned& devices) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (devices >> (dev & 31) & 1u)) return e;
  e = allow_smem(kernel, bytes);
  if (e == cudaSuccess) devices |= 1u << (dev & 31);
  return e;
}

}  // namespace mdk
