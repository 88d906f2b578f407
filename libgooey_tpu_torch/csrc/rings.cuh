// Delay lines as rings in shared memory, shared by the spring
// (bus_kernels.cu) and the plate (plate_kernels.cu), and the launch's
// opt-in to more shared memory than the default.
//
// A ring of length L holds a line's last L values; w is the slot the next
// sample writes, which holds the value L samples old.  A sample reads the
// line at its lag, then writes its new value at w and advances w, so the
// ring stands for the JAX package's right-aligned [.., L] history, which
// it is loaded from (oldest first, w = 0) and unrolled to at the end.

#pragma once

#include <cuda_runtime.h>

namespace {

// Slot of a ring of length L that holds the value ``lag`` samples before
// write slot w (1 <= lag <= L).
__device__ __forceinline__ int ring_slot(int w, int lag, int L) {
  const int k = w - lag;
  return k < 0 ? k + L : k;
}

__device__ __forceinline__ int ring_next(int w, int L) { return w + 1 == L ? 0 : w + 1; }

// A ring's values oldest first: the right-aligned history.
__device__ void unroll_ring(const float* ring, int w, int L, float* out) {
#pragma unroll 8
  for (int m = 0; m < L; ++m) {
    int k = w + m;
    k -= k >= L ? L : 0;
    out[m] = ring[k];
  }
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
