// Opt-in to large dynamic shared memory once, not on every launch.
//
// A kernel that needs more than 48 KB of dynamic shared memory must first be
// given cudaFuncAttributeMaxDynamicSharedMemorySize.  The call costs a few
// microseconds of host time, so each kernel instantiation keeps, per device,
// the largest size it has been given: a launch that needs no more skips the
// call.  `Tag` is a type that names one kernel instantiation (each source's
// `Instance<...>`), so that each has a table of its own.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kSmemDevices = 64;           // device ordinals the table covers
constexpr size_t kSmemDefault = 48 * 1024;  // dynamic shared memory without opt-in

template <typename Tag, typename Kernel>
cudaError_t set_smem_once(Kernel kernel, size_t bytes) {
  if (bytes <= kSmemDefault) return cudaSuccess;
  static std::atomic<int> given[kSmemDevices];  // zero-initialised (static storage)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kSmemDevices && int(bytes) <= given[dev].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err == cudaSuccess && dev < kSmemDevices) {
    int cur = given[dev].load(std::memory_order_relaxed);
    while (cur < int(bytes) &&
           !given[dev].compare_exchange_weak(cur, int(bytes), std::memory_order_release)) {
    }
  }
  return err;
}

}  // namespace
