// Delay lines as rings in shared memory, for the spring (bus_kernels.cu),
// and the launch's opt-in to more shared memory than the default (the
// spring, the plate in plate_kernels.cu and the staged bank kernels).
//
// A ring of length L holds a line's last L values; w is the slot the next
// sample writes, which holds the value L samples old.  A sample reads the
// line at its lag, then writes its new value at w and advances w.

#pragma once

#include <cuda_runtime.h>

namespace {

// Slot of a ring of length L that holds the value ``lag`` samples before
// write slot w (1 <= lag <= L).
__device__ __forceinline__ int ring_slot(int w, int lag, int L) {
  const int k = w - lag;
  return k < 0 ? k + L : k;
}

// Above the 48 KB a launch gets by default, dynamic shared memory needs the
// kernel's opt-in (up to 227 KB on Hopper); a size past that is refused here
// or by the launch, and the entry returns the error.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
