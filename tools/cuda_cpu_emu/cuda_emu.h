// A CPU emulation of the CUDA subset the port's kit, bus, bank, plate,
// oscillator and grain kernels use, for checking a restructured kernel
// against another build of it bit for bit before it goes to the card
// (tools/cuda_cpu_emu/emu_ab.py).
//
// A launch runs its blocks one after another (a 2-D grid row by row); each
// thread of a block is a std::thread, __syncthreads and bar.sync a
// std::barrier of the block (__syncthreads_and too, with a count of the
// threads whose predicate is 0), __syncwarp(mask) a barrier of the mask's
// lanes.  __ldg is a plain load.
// __shared__ variables are function statics (one block at a time); dynamic
// shared memory is a buffer filled with garbage at each block.  cp.async is
// a plain copy, done when it is issued, so its commit and wait_group are
// no-ops (emu_ab.py rewrites the inline PTX into the calls below).  Math is
// the host's libm: two builds agree with each other here, not with the card.
// Compile with -ffp-contract=off (nvcc's -fmad=false).

#pragma once

#include <math.h>

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

using std::isfinite;
using std::max;
using std::min;

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
  dim3() = default;
  dim3(unsigned x_, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct float2 {
  float x, y;
};
struct float3 {
  float x, y, z;
};
struct float4 {
  float x, y, z, w;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float3 make_float3(float x, float y, float z) { return {x, y, z}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }

inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim;
inline std::barrier<>* emu_block_barrier = nullptr;
inline char* emu_dyn_smem = nullptr;
inline std::mutex emu_mutex;
inline std::map<unsigned long long, std::unique_ptr<std::barrier<>>> emu_warp_barriers;
// __syncthreads_and's counts of false predicates: call g of a thread uses
// count g % 3, and resets count (g + 1) % 3 (the one call g + 1 uses, which
// every thread read in call g - 2) before it waits
inline int emu_and_fails[3];
inline thread_local unsigned emu_and_calls = 0;

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __constant__
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

inline int __syncthreads_and(int pred) {
  const unsigned g = emu_and_calls++;
  if (threadIdx.x == 0) emu_and_fails[(g + 1) % 3] = 0;
  if (!pred) {
    std::lock_guard<std::mutex> lock(emu_mutex);
    ++emu_and_fails[g % 3];
  }
  emu_block_barrier->arrive_and_wait();
  return emu_and_fails[g % 3] == 0;
}

inline void __syncwarp(unsigned mask = 0xffffffffu) {
  const unsigned long long key = (static_cast<unsigned long long>(threadIdx.x / 32) << 32) | mask;
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lock(emu_mutex);
    auto& slot = emu_warp_barriers[key];
    if (!slot) slot.reset(new std::barrier<>(__builtin_popcount(mask)));
    b = slot.get();
  }
  b->arrive_and_wait();
}

inline float __int_as_float(int i) {
  float f;
  memcpy(&f, &i, sizeof f);
  return f;
}
inline int __float_as_int(float f) {
  int i;
  memcpy(&i, &f, sizeof i);
  return i;
}

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

inline size_t __cvta_generic_to_shared(const void*) { return 0; }
inline void emu_cp_async(void* smem, const void* gmem, int bytes) { memcpy(smem, gmem, bytes); }
inline void emu_cp_async_commit() {}
inline void emu_cp_async_wait() {}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class Kernel>
inline cudaError_t cudaFuncSetAttribute(Kernel, int, int) {
  return cudaSuccess;
}

// kernel<<<grid, block, smem, stream>>>(args) becomes
// emu_launch(grid, block, smem, stream, [&] { kernel(args); })
template <class F>
void emu_launch(dim3 grid, int block, size_t smem, cudaStream_t, F body) {
  std::vector<char> dyn(smem + 16);
  emu_dyn_smem = dyn.data();
  blockDim.x = block;
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      blockIdx.x = bx;
      blockIdx.y = by;
      std::barrier<> barrier(block);
      emu_block_barrier = &barrier;
      emu_warp_barriers.clear();
      for (int& f : emu_and_fails) f = 0;
      memset(dyn.data(), 0x7f, dyn.size());
      std::vector<std::thread> threads;
      for (int t = 0; t < block; ++t) {
        threads.emplace_back([&body, t] {
          threadIdx.x = t;
          body();
        });
      }
      for (auto& th : threads) th.join();
    }
  }
}
