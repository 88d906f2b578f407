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
// sampler_read_linear: a block of 128 threads takes a tile of up to 512
// frames of one voice (voices on blockIdx.x, tiles on blockIdx.y: no
// integer division), the voice's base, frames, start and increment in
// registers, and each thread two pairs of consecutive frames, 128 pairs
// apart; a pair is one float4 store where B is even (16-byte aligned), two
// float2 stores where it is odd.  The arena stays in L2.
//
// What bounds them: bytes.  At the path's shapes (4,000 grains x 512, 128
// voices x 512 stereo) each writes 8.2 MB / 0.5 MB and reads ~130-260 KB of
// source and per-lane scalars; about 30 and 12 float operations an output
// sample.  The sampler's read is over in ~0.6 us more than an empty launch
// of its grid: the voice's scalars, then the taps they locate, then the
// stores (PERF.md).
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

constexpr int kSamplerThreads = 128;
constexpr int kSamplerPairs = 2;   // pairs of frames a thread, kSamplerThreads pairs apart
constexpr int kSamplerTile = 2 * kSamplerThreads * kSamplerPairs;   // frames a block

// One stereo frame at block sample n of a voice whose slot starts at b in
// the arena, holds em1 + 1 frames, and was started at `start`, moving inc
// frames a sample.
__device__ __forceinline__ float2 sampler_frame(const float2* __restrict__ arena, int F, int b,
                                                float em1, int32_t start, float inc,
                                                int block_start, int n) {
  // sampler.py:111-132: the age as int32, then one rounding
  const float age = static_cast<float>(wrap_sub(wrap_add(block_start, n), start));
  const float posc = fminf(fmaxf(age * inc, 0.0f), em1);
  const float i0f = floorf(posc);
  const float frac = posc - i0f;
  const int i0 = static_cast<int>(i0f);
  // the second tap stops at the slot's last whole frame, so a fractional
  // end holds f0 on its plateau
  const int i1 = min(i0 + 1, static_cast<int>(em1));
  const float2 f0 = __ldg(arena + min(max(b + i0, 0), F - 1));
  const float2 f1 = __ldg(arena + min(max(b + i1, 0), F - 1));
  return make_float2(f0.x + (f1.x - f0.x) * frac, f0.y + (f1.y - f0.y) * frac);
}

// A tile of kSamplerTile frames of one voice (voices on blockIdx.x, tiles on
// blockIdx.y: no integer division), the voice's slot and start in
// registers; each thread takes kSamplerPairs pairs of consecutive frames,
// kSamplerThreads pairs apart, computes all of them and then stores each
// pair as one float4 (Vec4: B even, so that every pair starts 16 bytes
// into the output) or as two float2; a pair past B's last frame holds one
// float2 or none.
template <bool Vec4>
__global__ void __launch_bounds__(kSamplerThreads)
    sampler_read_linear_kernel(const float2* __restrict__ arena, int F,
                               const int32_t* __restrict__ base, const float* __restrict__ frames,
                               const int32_t* __restrict__ start, const float* __restrict__ inc,
                               int block_start, float2* __restrict__ out, int B) {
  const int v = static_cast<int>(blockIdx.x);
  const int b = base[v];
  const float em1 = frames[v] - 1.0f;
  const int32_t s0 = start[v];
  const float dv = inc[v];
  float2* row = out + static_cast<size_t>(v) * B;
  const int n0 = static_cast<int>(blockIdx.y) * kSamplerTile + 2 * static_cast<int>(threadIdx.x);
  float2 f[kSamplerPairs][2];
#pragma unroll
  for (int j = 0; j < kSamplerPairs; ++j) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {   // a frame past B takes the last one's and is dropped
      const int n = min(n0 + 2 * kSamplerThreads * j + k, B - 1);
      f[j][k] = sampler_frame(arena, F, b, em1, s0, dv, block_start, n);
    }
  }
#pragma unroll
  for (int j = 0; j < kSamplerPairs; ++j) {
    const int n = n0 + 2 * kSamplerThreads * j;
    if (Vec4 && n < B) {
      *reinterpret_cast<float4*>(row + n) = make_float4(f[j][0].x, f[j][0].y, f[j][1].x, f[j][1].y);
    } else if (!Vec4) {
      if (n < B) row[n] = f[j][0];
      if (n + 1 < B) row[n + 1] = f[j][1];
    }
  }
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
  const dim3 grid(static_cast<unsigned>(V),
                  static_cast<unsigned>((B + kSamplerTile - 1) / kSamplerTile));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = reinterpret_cast<const float2*>(arena);
  auto* o = reinterpret_cast<float2*>(out);
  if (B % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    sampler_read_linear_kernel<true><<<grid, kSamplerThreads, 0, s>>>(
        a, F, base, frames, start, inc, block_start, o, B);
  } else {
    sampler_read_linear_kernel<false><<<grid, kSamplerThreads, 0, s>>>(
        a, F, base, frames, start, inc, block_start, o, B);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
