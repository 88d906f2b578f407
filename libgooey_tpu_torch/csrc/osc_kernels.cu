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
// Design: a pure elementwise pass over [V, B], one thread per (v, n),
// contiguous threads on contiguous samples, so every load and store is
// coalesced and the three [V, B] arrays cross DRAM once.  At the snare's
// 1,024 x 512 and 64 harmonics that is 6 MB and ~17 M recurrence steps: the
// kernel is bound by the serial recurrence's arithmetic latency, not by
// bytes.  idx is samples since the trigger, so theta reaches thousands of
// radians: sinf/cosf are the full-range library functions (never __sinf),
// and the build's -fmad=false keeps every step in the plain version's
// rounding order.
//
// The C entry launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void triangle_additive_bank_kernel(const float* __restrict__ idx,
                                              const float* __restrict__ freq,
                                              float* __restrict__ out, float w,
                                              float nyquist, int n_terms, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float f = freq[i];
  const float theta = idx[i] * f * w;
  const float sin1 = sinf(theta);
  const float cos2x2 = 2.0f * cosf(2.0f * theta);
  // reference loop bound: h <= floor(nyquist / f) and f*h <= nyquist
  const float max_h = floorf(nyquist / fmaxf(f, 1e-6f));
  float prev = -sin1;
  float curr = sin1;  // sin(h*theta) for h = 2k+1
  float acc = 0.0f;
  for (int k = 0; k < n_terms; ++k) {
    const float h = 2.0f * static_cast<float>(k) + 1.0f;
    const float hfreq = f * h;
    const float ratio = hfreq / nyquist;
    const float t = (ratio - 0.75f) * 4.0f;
    const float taper = ratio > 0.75f ? 1.0f - t * t : 1.0f;
    const float gain = taper / (h * h);
    const bool active = (h <= max_h) && (hfreq <= nyquist);
    acc = acc + (active ? gain * curr : 0.0f);
    const float nxt = cos2x2 * curr - prev;
    prev = curr;
    curr = nxt;
  }
  out[i] = acc;
}

}  // namespace

extern "C" {

int triangle_additive_bank_launch(const float* idx, const float* freq, float* out,
                                  float w, float nyquist, int n_terms, int V, int B,
                                  void* stream) {
  const int64_t n = static_cast<int64_t>(V) * B;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  triangle_additive_bank_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, freq, out, w, nyquist, n_terms, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
