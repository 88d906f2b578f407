// Oscillator kernels for Hopper (sm_90a).
//
//   triangle_additive_bank <- libgooey_tpu/ops/pallas_voice.py:triangle_additive_bank
//                             (_tri_bank_kernel; body ops/osc.py:130-157)
//
// The reference's band-limited "triangle": a sum over odd harmonics i of
// taper(i)/i^2 * sin(i*theta), theta = idx*f*2pi/sr, with a quadratic Gibbs
// taper over the top 25% of the band and harmonics capped at Nyquist.
// sin(i*theta) comes from the Chebyshev recurrence
// sin((i+2)t) = 2cos(2t) sin(it) - sin((i-2)t): one sinf and one cosf per
// sample, then (max_harmonics+1)/2 steps in registers.
//
// Design: an elementwise pass over [V, B] taken flat, a thread a sample, so
// every load and store of a warp is 32 consecutive floats.  A block of 256
// threads fills the untapered gains' table (triangle.cuh) while its threads
// take their sines, then each thread walks its untapered terms from the
// table (four float operations a term), the tapered band with the plain
// step's two IEEE divisions, and stops at the first inactive term.
// On the snare's traffic a warp's samples share nearly one frequency, so its
// lanes walk and stop together; where every sample's frequency is drawn
// apart (phase 3's first case) the lanes diverge and a warp walks its
// slowest lane's terms.  Two or four samples a thread, their common terms
// walked side by side, measured no faster (PERF.md).
//
// What bounds it: at the snare's 1,024 x 512 and 64 harmonics the three
// [V, B] arrays are 6 MB, 1.9 us at 3.35 TB/s; the ~140 float operations a
// sample that the function needs (four an untapered term) take 1.1 us at
// 67 TFLOP/s.  The kernel is held by issue instead: ~4 instructions an
// untapered term, ~40 a tapered one, ~45 for the full-range sinf/cosf and
// ~40 more a sample (max_h's division, the untapered count).  The build's
// -fmad=false keeps every step in the plain version's rounding order.
//
// The C entry launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "triangle.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    triangle_additive_bank_kernel(const float* __restrict__ idx, const float* __restrict__ freq,
                                  float* __restrict__ out, TriConsts c, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t ic = i < n ? i : n - 1;
  __shared__ __align__(16) float gain[kTriTable];
  TriSample s;
  s.begin(idx[ic], freq[ic], c);
  const int n_gain = tri_fill_gains(gain, c.n_terms);
  s.count_untapered(c, n_gain);
  __syncthreads();
  if (i < n) out[i] = s.finish(0, gain, c);
}

}  // namespace

extern "C" {

int triangle_additive_bank_launch(const float* idx, const float* freq, float* out,
                                  float w, float nyquist, float taper_from, int n_terms, int V,
                                  int B, void* stream) {
  const int64_t n = static_cast<int64_t>(V) * B;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const TriConsts c{w, nyquist, taper_from, n_terms};
  triangle_additive_bank_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, freq, out, c, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
