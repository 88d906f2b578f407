// Buffer-read kernels of the granulator and the sampler for Hopper (sm_90a).
//
//   grain_read_cubic     <- libgooey_tpu/ops/pallas_grain.py:grain_read_cubic (_kernel)
//   sampler_read_linear  <- libgooey_tpu/ops/pallas_grain.py:sampler_read_linear (_kernel_lin)
//
// What they compute is the JAX package's gather path (pallas_grain.py
// gather_read_cubic; instruments/sampler.py's gather branch), not the TPU
// kernels' structure: those build a one-hot selection matrix per output
// chunk and gather on the MXU with a bf16 hi/lo split, because the TPU has
// no fast random gather.  Hopper has one, so each thread computes one output
// sample's position and loads its taps directly.  The TPU wrappers' step and
// increment clips (|step| <= ~7.02, |inc| <= 4) are limits of their window
// tiers and are not applied here.
//
// grain_read_cubic: a block of 128 threads takes a tile of up to 512
// samples of one grain (rows on blockIdx.x, tiles on blockIdx.y: no integer
// division), the grain's start, step and age in registers, and each thread
// four of the tile's samples, 128 apart.  Each load of a warp reads its
// taps for 32 consecutive samples (a window of |step| * 32 + 4 source
// samples, one or two cache lines) and each store writes 32 consecutive
// floats.  Four consecutive samples a thread with float4 stores, and the
// taps as two aligned float4 loads, both measured slower (PERF.md): a
// warp's loads then span four times the source.  The granulator's source (32,768 samples, 128 KB) stays in L1 and
// L2, so the taps cost cache hits, not DRAM traffic.
//
// sampler_read_linear: one thread per (voice, sample), consecutive threads
// on consecutive samples of one voice; the arena stays in L2.
//
// What bounds them: bytes.  At the path's shapes (4,000 grains x 512, 128
// voices x 512 stereo) each writes 8.2 MB / 0.5 MB and reads ~130-260 KB of
// source and per-lane scalars; about 30 and 12 float operations an output
// sample.
//
// Numerics: each step keeps the gather path's op order (position
// p0 + step * f32(age), the Horner combine ((a0 f + a1) f + a2) f + p1, the
// lerp f0 + (f1 - f0) frac), and the build passes -fmad=false, so the
// kernels equal their plain PyTorch versions (ops/grain_kernels.py) bit for
// bit.  Indices never leave the source: a non-finite position reads the
// first sample, and the sampler's arena index is clamped to [0, F-1].
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError(); nothing allocates or synchronizes here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline dim3 grid_for(int64_t n) {
  return dim3(static_cast<unsigned>((n + kThreads - 1) / kThreads));
}

// int32 sums wrap, as XLA's and PyTorch's int32 arithmetic does
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// --- grain_read_cubic: Catmull-Rom reads at clip(p0 + step*age, 0, L-1) ----

constexpr int kGrainThreads = 128;
constexpr int kGrainPer = 4;  // samples a thread
constexpr int kGrainTile = kGrainThreads * kGrainPer;

// One output sample at age `age` (rounded to float32 once, granulator.py:244)
// of a grain that starts at p (made finite) and moves step a sample.
__device__ __forceinline__ float grain_sample(const float* __restrict__ buf, int L, float p,
                                              float step, float age) {
  // fmaxf maps a NaN position (an infinite step at age 0) to the first sample
  const float pos = fminf(fmaxf(p + step * age, 0.0f), static_cast<float>(L - 1));
  const float i1f = floorf(pos);
  const float f = pos - i1f;
  const int i1 = static_cast<int>(i1f);
  const float t0 = __ldg(buf + max(i1 - 1, 0));
  const float t1 = __ldg(buf + i1);
  const float t2 = __ldg(buf + min(i1 + 1, L - 1));
  const float t3 = __ldg(buf + min(i1 + 2, L - 1));
  const float a0 = -0.5f * t0 + 1.5f * t1 - 1.5f * t2 + 0.5f * t3;
  const float a1 = t0 - 2.5f * t1 + 2.0f * t2 - 0.5f * t3;
  const float a2 = -0.5f * t0 + 0.5f * t2;
  return ((a0 * f + a1) * f + a2) * f + t1;
}

// kGrainPer samples a thread, kGrainThreads apart, of a tile of kGrainTile
// samples of one grain.  Every sample's value is computed before any is
// stored (a sample past B takes the row's last age and is dropped), so a
// thread's taps load together.
__global__ void __launch_bounds__(kGrainThreads)
    grain_read_cubic_kernel(const float* __restrict__ buf, int L, const float* __restrict__ p0,
                            const float* __restrict__ step, const int32_t* __restrict__ age0,
                            float* __restrict__ out, int B) {
  const int g = static_cast<int>(blockIdx.x);
  const int n_tile = static_cast<int>(blockIdx.y) * kGrainTile;
  float p = p0[g];
  if (isnan(p)) p = 0.0f;  // pallas_grain.py:237
  if (isinf(p)) p = p > 0.0f ? 3e38f : -3e38f;
  const float st = step[g];
  const int32_t a = age0 != nullptr ? age0[g] : 0;  // age = n without ages
  float* row = out + static_cast<size_t>(g) * B;
  const int n0 = n_tile + static_cast<int>(threadIdx.x);
  float v[kGrainPer];
#pragma unroll
  for (int j = 0; j < kGrainPer; ++j) {
    const int n = min(n0 + j * kGrainThreads, B - 1);
    v[j] = grain_sample(buf, L, p, st, static_cast<float>(wrap_add(a, n)));
  }
#pragma unroll
  for (int j = 0; j < kGrainPer; ++j)
    if (n0 + j * kGrainThreads < B) row[n0 + j * kGrainThreads] = v[j];
}

// --- sampler_read_linear: stereo lerp over an interleaved [F, 2] arena -------

__global__ void sampler_read_linear_kernel(const float2* __restrict__ arena, int F,
                                           const int32_t* __restrict__ base,
                                           const float* __restrict__ frames,
                                           const int32_t* __restrict__ start,
                                           const float* __restrict__ inc,
                                           int block_start, float2* __restrict__ out,
                                           int V, int B) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(V) * B) return;
  const int v = static_cast<int>(i / B);
  const int n = static_cast<int>(i - static_cast<int64_t>(v) * B);
  // sampler.py:111-132: the age as int32, then one rounding
  const float age = static_cast<float>(wrap_sub(wrap_add(block_start, n), start[v]));
  const float em1 = frames[v] - 1.0f;
  const float posc = fminf(fmaxf(age * inc[v], 0.0f), em1);
  const float i0f = floorf(posc);
  const float frac = posc - i0f;
  const int i0 = static_cast<int>(i0f);
  // the second tap stops at the slot's last whole frame, so a fractional
  // end holds f0 on its plateau
  const int i1 = min(i0 + 1, static_cast<int>(em1));
  const int b = base[v];
  const float2 f0 = __ldg(arena + min(max(b + i0, 0), F - 1));
  const float2 f1 = __ldg(arena + min(max(b + i1, 0), F - 1));
  out[i] = make_float2(f0.x + (f1.x - f0.x) * frac, f0.y + (f1.y - f0.y) * frac);
}

}  // namespace

extern "C" {

int grain_read_cubic_launch(const float* buf, const float* p0, const float* step,
                            const int32_t* age0, float* out, int L, int G, int B,
                            void* stream) {
  const dim3 grid(static_cast<unsigned>(G),
                  static_cast<unsigned>((B + kGrainTile - 1) / kGrainTile));
  grain_read_cubic_kernel<<<grid, kGrainThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      buf, L, p0, step, age0, out, B);
  return static_cast<int>(cudaGetLastError());
}

int sampler_read_linear_launch(const float* arena, const int32_t* base, const float* frames,
                               const int32_t* start, const float* inc, float* out,
                               int block_start, int F, int V, int B, void* stream) {
  sampler_read_linear_kernel<<<grid_for(static_cast<int64_t>(V) * B), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(arena), F, base, frames, start, inc, block_start,
      reinterpret_cast<float2*>(out), V, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
