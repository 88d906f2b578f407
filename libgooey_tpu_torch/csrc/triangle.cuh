// The additive odd-harmonic triangle of one sample, shared by
// triangle_additive_bank (osc_kernels.cu) and kit_sources' kick and snare
// bodies (voice_kernels.cu).
//
// The plain version (ops/bank_kernels.triangle_additive_bank_plain) sums,
// over k < n_terms with h = 2k+1,
//
//   active_k ? taper_k / (h*h) * sin(h*theta) : 0,
//   taper_k = ratio > 0.75 ? 1 - ((ratio - 0.75)*4)^2 : 1,  ratio = f*h / nyquist,
//   active_k = h <= floor(nyquist / max(f, 1e-6)) && f*h <= nyquist,
//
// with sin(h*theta) from the Chebyshev recurrence, two IEEE divisions a term.
// Three exact rewrites take the divisions out of the untapered band:
//
// - Untapered, the gain is 1.0f / (h*h): the same IEEE division, done once a
//   block into a table in shared memory (tri_fill_gains).
// - x -> RN(x / nyquist) is monotone, so ratio > 0.75 holds exactly where
//   f*h >= T, T the smallest float with RN(T / nyquist) > 0.75, found on the
//   host (bank_kernels.taper_threshold) and passed in.
// - For f >= 0, f*h (rounded) and h grow with k, so a term that is inactive
//   or tapered is followed by no untapered active term; for f < 0 every term
//   is active and none is tapered; a NaN f makes every term inactive.  So the
//   terms are: k < k1 untapered and active (a table gain, four float
//   operations a step), then tapered ones (the plain step), then inactive
//   ones, each of which adds +0.0f.  Adding +0.0f again changes nothing
//   once it has been added (it turns only a -0 into +0), so the walk stops
//   at the first inactive term after one such add.
//
// k1 comes from an estimate from floor(nyquist / f) that two exact tests of
// the condition then correct (the condition is monotone in k, so the walk
// ends at the exact count).  Every operation that reaches the output is the
// plain version's, in its order (the build's -fmad=false keeps each
// multiply and add rounded apart); sinf and cosf are the full-range library
// functions, never __sinf, because theta reaches thousands of radians.

#pragma once

// gains kept in the table; terms past it take the plain step
constexpr int kTriTable = 256;

struct TriConsts {
  float w;        // 2 pi / sample rate, rounded to float32
  float nyquist;  // sample rate / 2, rounded to float32
  float T;        // the taper threshold: ratio > 0.75 <=> f*h >= T
  int n_terms;    // (max_harmonics + 1) / 2
};

// Fill gain[k] = 1.0f / (h*h) for the table's first min(n_terms, kTriTable)
// terms with the block's threads; returns that count.  The caller
// synchronizes the block before reading the table.
__device__ __forceinline__ int tri_fill_gains(float* gain, int n_terms) {
  const int n = min(n_terms, kTriTable);
  for (int k = static_cast<int>(threadIdx.x); k < n; k += static_cast<int>(blockDim.x)) {
    const float h = 2.0f * static_cast<float>(k) + 1.0f;
    gain[k] = 1.0f / (h * h);
  }
  return n;
}

// One sample's walk: the recurrence's two last values, the sum, and what the
// terms test.
struct TriSample {
  float f, cos2x2, prev, curr, acc, max_h;
  int k1 = 0;  // the count of leading terms that are active and untapered

  __device__ __forceinline__ bool untapered(int k, const TriConsts& c) const {
    const float h = 2.0f * static_cast<float>(k) + 1.0f;
    const float hfreq = f * h;
    return (h <= max_h) && (hfreq <= c.nyquist) && (hfreq < c.T);
  }

  __device__ __forceinline__ void begin(float idx, float freq, const TriConsts& c) {
    f = freq;
    const float theta = idx * f * c.w;
    const float sin1 = sinf(theta);
    cos2x2 = 2.0f * cosf(2.0f * theta);
    max_h = floorf(c.nyquist / fmaxf(f, 1e-6f));
    prev = -sin1;
    curr = sin1;
    acc = 0.0f;
  }

  // k1, within the table's n_gain terms: the untapered band ends near
  // h = 0.75 * nyquist / f; NaN and huge estimates clamp, and the tests
  // below make the count exact
  __device__ __forceinline__ void count_untapered(const TriConsts& c, int n_gain) {
    const float est = ceilf((0.75f * max_h - 1.0f) * 0.5f);
    int k = isnan(f) ? 0 : static_cast<int>(fminf(fmaxf(est, 0.0f), static_cast<float>(n_gain)));
    while (k > 0 && !untapered(k - 1, c)) --k;
    while (k < n_gain && untapered(k, c)) ++k;
    k1 = k;
  }

  // an untapered, active term
  __device__ __forceinline__ void step(float gain) {
    acc = acc + gain * curr;
    const float nxt = cos2x2 * curr - prev;
    prev = curr;
    curr = nxt;
  }

  // The terms from k on: the table's gains up to k1, then the plain step
  // until the first inactive term.  Returns the sum.
  __device__ __forceinline__ float finish(int k, const float* gain, const TriConsts& c) {
    for (; k < k1; ++k) step(gain[k]);
    for (; k < c.n_terms; ++k) {
      const float h = 2.0f * static_cast<float>(k) + 1.0f;
      const float hfreq = f * h;
      if (!((h <= max_h) && (hfreq <= c.nyquist))) {
        acc = acc + 0.0f;
        break;
      }
      const float ratio = hfreq / c.nyquist;
      const float t = (ratio - 0.75f) * 4.0f;
      const float taper = ratio > 0.75f ? 1.0f - t * t : 1.0f;
      step(taper / (h * h));
    }
    return acc;
  }
};

// The triangle of one sample, its gain table filled (tri_fill_gains)
__device__ __forceinline__ float triangle(float idx, float f, const TriConsts& c,
                                          const float* gain, int n_gain) {
  TriSample s;
  s.begin(idx, f, c);
  s.count_untapered(c, n_gain);
  return s.finish(0, gain, c);
}
