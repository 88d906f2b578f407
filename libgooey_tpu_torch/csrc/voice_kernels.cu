// The kit kernels for Hopper (sm_90a): every small voice bank's block in two
// launches, whatever families the kit holds.
//
//   kit_sources <- libgooey_tpu/ops/pallas_voice.py:_mega_pallas, the merged
//                  sources call (_kick_a_kernel, _snare_a_kernel,
//                  _hihat2_kernel, _bass_kernel, _tom2_kernel)
//   kit_drive   <- libgooey_tpu/ops/pallas_voice.py:_mega_pallas, the merged
//                  drive call (_kick_b_kernel, _snare_b_kernel)
//
// A launch takes a phase table (Kit) of up to five families, each with its
// body, its bank's V rows and its slots (pointers, scalars, ints), as
// bus_chain takes its phases; each phase owns a range of blocks.
//
// kit_sources gives every voice row a block of kTile (128) threads and cuts
// the row's B samples into tiles of kTile.  The body is uniform within a
// block.  Per tile, each body alternates between per-sample stages, every
// thread one sample (the smoother trajectories, closed form, q^(n+1) from a
// table; the trigger latches, the envelopes, the oscillators' phases and
// waves, the additive triangles, the counter-hash noise, the filters'
// coefficients), kept in shared memory (kSlots arrays of a tile), and
// walks, one lane per independent recurrence stepped in order with its
// carry in registers from one tile to the next: the kick's click high-pass
// and its pink poles with the noise SVF; hihat2's pink poles, envelope
// tracker, then its DF-I biquads and tone SVF; tom2's rand~ ramp; the two
// running sums of every phase accumulator (PhaseBank, split as the plain
// version computes it); the bass's 4x chain (its up-path and down-path
// walked, the drive at each subsample on every thread, ovs4.cuh).  Outputs
// are stored coalesced.  snare_a has no recurrence.  The Pallas bodies solve
// the linear recurrences with lane scans; here they are stepped, not
// scanned.  The state epilogues are written by the lanes that hold the
// carries, after the last tile.  kit_drive also gives every voice row a
// block of 128 threads, and pipelines the row's 32-sample chunks over its
// warps a step apart: the per-sample inputs and the shaper's parameters,
// the 4x chain's up-walk, the shaper at each subsample, the down-walk (with
// the kick's DC blocker and feedback filter) and the finish (drive_row
// below).  The bass's and the drive bodies' 4x chains use the port's packed
// [S, V] state layout (the TPU's [2Vp, K] packing and its row padding to 8
// are layout workarounds of that chip and are not ported).
//
// Each body follows its plain version in ops/voice_kernels.py op for op; the
// build's -fmad=false keeps a*b + c as two roundings there as here, and
// every constant division is a true division on both sides.  Work moves
// between threads but no per-sample operation is reordered, so both kernels
// give their plain versions bit for bit on the card.
//
// What bounds it on the card: at the product kit (64 voices, B = 512) a
// launch moves a few hundred KB and does ~12 M operations (the kick's and
// the snare's additive triangles, 32 harmonics a sample, dominate):
// against 3.35 TB/s and 67 TFLOP/s a fraction of a microsecond.  The
// kernel takes the time of its longest serial walk: 64 blocks on 64 of 132
// SMs, and the bass's 4x chain (its up-path and down-path, a few hundred
// dependent operations a sample) the longest (PERF.md).  kit_drive, whose
// bound is as small, takes its rows' two walks of the 4x chain, each on one
// lane, plus two chunks of pipeline fill (32 blocks on 32 SMs at the
// product kit; 256 blocks, two an SM, at 128 voices a family).
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError(); nothing allocates or synchronizes here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ovs4.cuh"
#include "triangle.cuh"

namespace {

constexpr int kTile = 128;     // kit_sources: threads per block, samples per tile
constexpr int kSlots = 22;     // kit_sources: per-tile arrays in shared memory
constexpr int kIn = 16;
constexpr int kOut = 10;
constexpr int kNF = 24;
constexpr int kNI = 8;
constexpr int kMaxPhases = 5;

enum Body : int {
  kKickA = 0,
  kSnareA = 1,
  kHihat2 = 2,
  kBass = 3,
  kTom2 = 4,
  kKickB = 5,
  kSnareB = 6,
};

struct VoicePhase {
  int body, V, B, block0;
  const void* in[kIn];
  void* out[kOut];
  float f[kNF];
  int iv[kNI];
};

struct Kit {
  int n;
  VoicePhase ph[kMaxPhases];
};

// --- shared per-sample math (ops/voice_kernels.py helpers) ---------------------

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// lo + clip(x, 0, 1) * (hi - lo), the difference taken in double as Python
// takes it
#define DENORM(x, lo, hi) (static_cast<float>(lo) + clamp01(x) * static_cast<float>((hi) - (lo)))

// the smoothers' settle snap
__device__ __forceinline__ float snap(float t, float d) { return t + (fabsf(d) < 1e-4f ? 0.0f : d); }

// torch.remainder(x, 1)
__device__ __forceinline__ float rem1(float x) {
  float m = fmodf(x, 1.0f);
  if (m != 0.0f && m < 0.0f) m += 1.0f;
  return m;
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// core/rng.py white(): the top 24 bits of the counter hash, in [-1, 1];
// smix is the seed half of the hash, folded on the host
__device__ __forceinline__ float white(uint32_t counter, uint32_t smix) {
  const uint32_t bits = mix32(counter ^ smix) >> 8;
  const float norm = static_cast<float>(static_cast<int>(bits)) / 16777215.0f;
  return norm * 2.0f - 1.0f;
}

// EnvelopeCurve::apply shapes: the identity (a constant curve of 1), sqrt (a
// constant 0.5, as PyTorch's pow takes it) and a per-sample curve
struct Lin {
  __device__ __forceinline__ float operator()(float p) const { return fmaxf(p, 0.0f); }
};
struct Sqrt {
  __device__ __forceinline__ float operator()(float p) const { return sqrtf(fmaxf(p, 0.0f)); }
};
struct Pow {
  float c;
  __device__ __forceinline__ float operator()(float p) const {
    return powf(fmaxf(p, 0.0f), clampf(c, 0.1f, 10.0f));
  }
};

// Time-based ADSR amplitude without release (pallas_voice._adsr_amp)
template <class AC, class DC>
__device__ __forceinline__ float adsr(float el, float a, float d, float s, AC ac, DC dc) {
  const float attack_amp = ac(el / a);
  const float decay_prog = dc((el - a) / d);
  const float decay_amp = 1.0f - (1.0f - s) * decay_prog;
  const float held = el < a ? attack_amp : (el < a + d ? decay_amp : s);
  return el >= 0.0f ? held : 0.0f;
}

__device__ __forceinline__ float phase_mod_env(float el, bool active) {
  const float rise = powf(fmaxf(el / 0.001f, 0.0f), 0.3f);
  const float fall = 1.0f - powf(fmaxf((el - 0.001f) / 0.005f, 0.0f), 0.4f);
  const float env = el < 0.001f ? rise : fall;
  return (el >= 0.0f && el <= 0.006f && active) ? env : 0.0f;
}

__device__ __forceinline__ float tuning_mult(float t) {
  return exp2f(((clamp01(t) - 0.5f) * 24.0f) * static_cast<float>(1.0 / 12.0));
}

// Max/MSP curve~ with exp(x) - 1 (pallas_voice._max_curve); fp and den are
// the curve's float32 constants
__device__ __forceinline__ float max_curve(float p, float fp, float den, bool negative) {
  p = clamp01(p);
  if (negative) return 1.0f - (expf(fp * (1.0f - p)) - 1.0f) / den;
  return (expf(fp * p) - 1.0f) / den;
}

// The TPT SVF step with its trigger reset (svf_bank)
__device__ __forceinline__ void svf_step(float& ic1, float& ic2, float x, float g, float h,
                                         bool reset, float& v1, float& v2) {
  if (reset) {
    ic1 = 0.0f;
    ic2 = 0.0f;
  }
  v1 = (g * (x - ic2) + ic1) * h;
  v2 = ic2 + g * v1;
  ic1 = 2.0f * v1 - ic1;
  ic2 = 2.0f * v2 - ic2;
}

// One voice row's trigger context (pallas_voice._Ctx): offsets, latches,
// elapsed samples since the governing trigger (int32, wrapping), and the
// smoother trajectories of its parameters
struct Row {
  const float* cur;
  const float* tgt;
  const float* powq;
  int off, trig, bs, B;
  bool has;
  float qoff;
  __device__ __forceinline__ void init(const float* c, const float* t, const float* pq, int o,
                                       int tr, int b, int nb) {
    cur = c;
    tgt = t;
    powq = pq;
    off = o;
    trig = tr;
    bs = b;
    B = nb;
    has = o < nb;
    qoff = pq[min(max(o, 0), nb)];
  }
  __device__ __forceinline__ bool after(int n) const { return has && n >= off; }
  __device__ __forceinline__ bool at(int n) const { return has && n == off; }
  __device__ __forceinline__ int elapsed_i(int n) const {
    const uint32_t te = after(n) ? static_cast<uint32_t>(bs) + static_cast<uint32_t>(off)
                                 : static_cast<uint32_t>(trig);
    return static_cast<int>(static_cast<uint32_t>(bs) + static_cast<uint32_t>(n) - te);
  }
  __device__ __forceinline__ float traj(int i, int n) const {
    return snap(tgt[i], (cur[i] - tgt[i]) * powq[n + 1]);
  }
  __device__ __forceinline__ float vat(int i) const { return snap(tgt[i], (cur[i] - tgt[i]) * qoff); }
  __device__ __forceinline__ int new_trig() const {
    return has ? static_cast<int>(static_cast<uint32_t>(bs) + static_cast<uint32_t>(off)) : trig;
  }
  // the smoothers at the end of the block, P of them
  __device__ __forceinline__ void advance(float* ncur, int P, float qB) const {
    for (int i = 0; i < P; ++i) ncur[i] = snap(tgt[i], (cur[i] - tgt[i]) * qB);
  }
};

#define IN_F(i) static_cast<const float*>(p.in[i])
#define IN_I(i) static_cast<const int*>(p.in[i])
#define OUT_F(i) static_cast<float*>(p.out[i])
#define OUT_I(i) static_cast<int*>(p.out[i])

// --- the tile walk of kit_sources -------------------------------------------------
//
// A block of kTile threads owns one voice row and cuts its B samples into
// tiles of kTile.  Per tile, every thread computes one sample of the
// per-sample stage into shared memory (kSlots arrays of kTile floats), then
// one lane per independent recurrence walks the tile in sample order with
// its carry in registers, then the threads finish their samples and store
// them coalesced.  The walkers carry their state from one tile to the next
// and write it out after the last tile.

#define SLOT(i) (sh + (i) * kTile)

// K mod-1 phase accumulators with trigger resets in their split-increment
// form (pallas_voice._phase_cumsum_reset), computed as the plain version
// (ops/voice_kernels.py _phase) computes them: per sample, on every thread,
// the split increment's ramp and the two mod-1 wraps; walked, one lane per
// accumulator, the two running sums (the residual increment, and the base
// a trigger resets to the phase before it).  A tile takes start (at sample 0: the first
// increments), walk_resid, ramp, walk_base and wrap, with a barrier after
// each; slots work .. work + 2K hold the sums, out .. out + K the phases.
template <int K>
struct PhaseBank {
  float inc0[K], hi[K], lo[K];   // every thread's, from the block's first increments
  float resid, base, p_prev;     // accumulator k's carry, on lane k
  template <class Inc>
  __device__ __forceinline__ void start(int n0, const float* carry, const Inc& inc) {
    if (n0 != 0) return;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      inc0[k] = inc(k, 0);
      hi[k] = floorf(inc0[k] * 2048.0f) * static_cast<float>(1.0 / 2048.0);
      lo[k] = inc0[k] - hi[k];
    }
    if (threadIdx.x < K) {
      resid = 0.0f;
      base = -carry[threadIdx.x];
      p_prev = 0.0f;
    }
  }
  template <class Inc>
  __device__ __forceinline__ void walk_resid(int len, float* sh, int work, const Inc& inc) {
    const int k = threadIdx.x;
    float i0 = inc0[0];
#pragma unroll
    for (int j = 1; j < K; ++j) i0 = k == j ? inc0[j] : i0;
    float* w = SLOT(work + k);
    for (int i = 0; i < len; ++i) {
      resid = 1.0f * resid + (inc(k, i) - i0);
      w[i] = resid;
    }
  }
  __device__ __forceinline__ void ramp(int n0, int len, float* sh, int work) const {
    const int t = threadIdx.x;
    if (t >= len) return;
    const float n1 = static_cast<float>(n0 + t + 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float ramp_hi = hi[k] * n1;
      ramp_hi = ramp_hi - floorf(ramp_hi);
      const float ramp = ramp_hi + lo[k] * n1;
      SLOT(work + k)[t] = rem1(ramp + SLOT(work + k)[t]);
    }
  }
  __device__ __forceinline__ void walk_base(const Row& r, int n0, int len, float* sh,
                                            int work) {
    const int k = threadIdx.x;
    const float* p = SLOT(work + k);
    float* b = SLOT(work + K + k);
    for (int i = 0; i < len; ++i) {
      const float rr = r.at(n0 + i) ? 1.0f : 0.0f;
      base = (1.0f - rr) * base + rr * p_prev;
      p_prev = p[i];
      b[i] = base;
    }
  }
  __device__ __forceinline__ void wrap(int len, float* sh, int work, int out) const {
    const int t = threadIdx.x;
    if (t >= len) return;
#pragma unroll
    for (int k = 0; k < K; ++k) SLOT(out + k)[t] = rem1(SLOT(work + k)[t] - SLOT(work + K + k)[t]);
  }
};

// --- kick A: sources (pallas_voice.py:431-593) ----------------------------------
//
// in:  cur, tgt [V,19], off [V] i32, vel [V], trig [V] i32, lat [V,6], fst [V,6],
//      bs i32, powq [B+1]
// out: total [V,B], ampsc [V,B], ncur [V,19], nlat [V,6], ntrig [V] i32, nfst [V,6]
// f:   1/sr, 2pi/sr, sr/2, alpha, 1-alpha, max cutoff, sr, q^B, poles[3],
//      gains[3], direct, outg, the triangle's taper threshold;  iv: seed mix,
//      triangle terms (-1: none)
//
// Walks: the click high-pass (thread 0); the pink poles and the noise SVF on
// their sum (thread 32).

enum KickSlot { kKSum, kKClickRaw, kKPinkW, kKG, kKH, kKOscEnv, kKNoiseAmt, kKClickOut, kKNoiseF };

__device__ void kick_a(const VoicePhase& p, int v, float* sh, float* tri_gain) {
  const int B = p.B, t = threadIdx.x;
  Row r;
  r.init(IN_F(0) + v * 19, IN_F(1) + v * 19, IN_F(8), IN_I(2)[v], IN_I(4)[v], *IN_I(7), B);
  const float* lat = IN_F(5) + v * 6;
  const float* fst = IN_F(6) + v * 6;
  float* total = OUT_F(0) + static_cast<size_t>(v) * B;
  float* ampsc = OUT_F(1) + static_cast<size_t>(v) * B;
  const float inv_sr = p.f[0], w = p.f[1], nyq = p.f[2], alpha = p.f[3], oma = p.f[4];
  const float max_cut = p.f[5], sr = p.f[6], qB = p.f[7];
  const uint32_t smix = static_cast<uint32_t>(p.iv[0]);
  const int n_terms = p.iv[1];
  const TriConsts tri{w, nyq, p.f[16], n_terms};
  const int n_gain = tri_fill_gains(tri_gain, n_terms);
  __syncthreads();

  // trigger-time snapshots (kick.rs:971-1086)
  const float vel_new = clamp01(IN_F(3)[v]);
  const float pea = r.vat(5);
  const float psr = DENORM(r.vat(8), 1.0, 10.0);
  const float pitch_mult_new = 1.0f + (psr - 1.0f) * pea;
  const float pc = DENORM(r.vat(6), 0.1, 4.0);
  const float pitch_curve_new = fabsf(pc - 1.0f) < 0.01f ? 1.0f : pc;
  const float decay_scale_new = 1.0f - 0.5f * vel_new * vel_new;
  const float ad = DENORM(r.vat(16), 0.0, 4.0) * decay_scale_new;
  const float ac = DENORM(r.vat(17), 0.1, 10.0);
  const float amp_curve_new = fabsf(ac - 1.0f) < 0.01f ? 1.0f : ac;
  const float pm_active_new = r.vat(9) > 0.001f ? 1.0f : 0.0f;

  float click_y = fst[0], ic1 = fst[1], ic2 = fst[2];
  float pk[3] = {fst[3], fst[4], fst[5]};
  for (int n0 = 0; n0 < B; n0 += kTile) {
    const int len = min(kTile, B - n0);
    if (t < len) {
      const int n = n0 + t;
      const bool after = r.after(n);
      const float vel = after ? vel_new : lat[0];
      const float pitch_mult = after ? pitch_mult_new : lat[1];
      const float pitch_curve = after ? pitch_curve_new : lat[2];
      const float amp_decay_s = after ? ad : lat[3];
      const float amp_curve = after ? amp_curve_new : lat[4];
      const float pm_active = after ? pm_active_new : lat[5];
      const int ei = r.elapsed_i(n);
      const float idx = static_cast<float>(ei);
      const float el = idx * inv_sr;

      // live smoothed params (kick.rs:1097-1232)
      const float decay_scale = 1.0f - 0.5f * vel * vel;
      const float base_decay = DENORM(r.traj(4, n), 0.01, 4.0) * decay_scale;
      const float base_freq = DENORM(r.traj(0, n), 30.0, 120.0) * tuning_mult(r.traj(18, n));
      const float pitch_env = adsr(el, 0.001f, base_decay, 0.0f, Lin{}, Pow{pitch_curve});
      float fmult = 1.0f + (pitch_mult - 1.0f) * pitch_env;
      const float pm_amt = r.traj(9, n);
      const float pm_env = phase_mod_env(el, pm_active > 0.5f);
      fmult = fmult * (pm_amt > 0.001f ? 1.0f + pm_env * pm_amt * 2.0f : 1.0f);

      const float osc_env = adsr(el, 0.001f, base_decay, 0.0f, Lin{}, Lin{});
      const float sub_out = sinf(idx * (base_freq * fmult) * w) * osc_env * r.traj(2, n);
      const float punch_out =
          n_terms >= 0
              ? triangle(idx, base_freq * 2.5f * fmult, tri, tri_gain, n_gain) * osc_env *
                    (r.traj(1, n) * 0.7f)
              : 0.0f;

      const float click_env = adsr(el, 0.001f, base_decay * 0.2f, 0.0f, Lin{}, Lin{});
      const float click_vel_scale = 0.6f + 0.4f * vel;
      const float click_white = white(static_cast<uint32_t>(static_cast<int>(floorf(idx))), smix);
      SLOT(kKPinkW)[t] = white(static_cast<uint32_t>(ei), smix);
      SLOT(kKClickRaw)[t] = click_white * click_env * (r.traj(3, n) * 0.15f * click_vel_scale);
      const float noise_cut = DENORM(r.traj(11, n), 20.0, 10000.0);
      const float noise_res = DENORM(r.traj(12, n), 0.0, 5.0);
      const float g = tanf((3.14159265358979f * clampf(noise_cut, 20.0f, max_cut)) / sr);
      const float inv_q = 1.0f / clampf(noise_res, 0.5f, 10.0f);
      SLOT(kKG)[t] = g;
      SLOT(kKH)[t] = 1.0f / (1.0f + inv_q * g + g * g);
      SLOT(kKOscEnv)[t] = osc_env;
      SLOT(kKNoiseAmt)[t] = r.traj(10, n);
      SLOT(kKSum)[t] = sub_out + punch_out;
      // master amplitude scale (kick.rs:1264-1284)
      const float amp_env =
          adsr(el, 0.001f, fmaxf(amp_decay_s, 0.001f), 0.0f, Sqrt{}, Pow{amp_curve});
      ampsc[n] = amp_env * sqrtf(vel) * r.traj(7, n);
    }
    __syncthreads();
    if (t == 0) {
      // cheap resonant HP at 8 kHz / res 4 (resonant_highpass.rs:22-53)
      for (int i = 0; i < len; ++i) {
        const bool at = r.at(n0 + i);
        const float click_raw = SLOT(kKClickRaw)[i];
        const float s_prev = at ? 0.0f : click_y;
        click_y = (at ? 0.0f : oma) * click_y + alpha * click_raw;
        SLOT(kKClickOut)[i] = (click_raw - s_prev) * 1.4f;
      }
    } else if (t == 32) {
      // pink-noise layer (kick.rs:1174-1193) through the noise SVF
      for (int i = 0; i < len; ++i) {
        const bool at = r.at(n0 + i);
        const float pink_white = SLOT(kKPinkW)[i];
        for (int j = 0; j < 3; ++j)
          pk[j] = (at ? 0.0f : p.f[8 + j]) * pk[j] + p.f[11 + j] * pink_white;
        const float pink = (pk[0] + pk[1] + pk[2] + pink_white * p.f[14]) * p.f[15];
        float v1, v2;
        svf_step(ic1, ic2, pink, SLOT(kKG)[i], SLOT(kKH)[i], at, v1, v2);
        SLOT(kKNoiseF)[i] = fabsf(v2) < 1e-15f ? 0.0f : v2;
      }
    }
    __syncthreads();
    if (t < len) {
      const float noise_amt = SLOT(kKNoiseAmt)[t];
      const float noise_out =
          noise_amt > 0.001f ? SLOT(kKNoiseF)[t] * SLOT(kKOscEnv)[t] * noise_amt * 0.5f : 0.0f;
      total[n0 + t] = SLOT(kKSum)[t] + SLOT(kKClickOut)[t] + noise_out;
    }
    __syncthreads();
  }

  if (t == 0) {
    r.advance(OUT_F(2) + v * 19, 19, qB);
    const float news[6] = {vel_new, pitch_mult_new, pitch_curve_new, ad, amp_curve_new,
                           pm_active_new};
    float* nlat = OUT_F(3) + v * 6;
    for (int i = 0; i < 6; ++i) nlat[i] = r.has ? news[i] : lat[i];
    OUT_I(4)[v] = r.new_trig();
    OUT_F(5)[v * 6] = click_y;
  } else if (t == 32) {
    float* nfst = OUT_F(5) + v * 6;
    nfst[1] = ic1;
    nfst[2] = ic2;
    for (int i = 0; i < 3; ++i) nfst[3 + i] = pk[i];
  }
}

// --- snare A: tonal and crack layers, noise before the Chamberlin ----------------
//
// in:  cur, tgt [V,19], off, vel, trig, lat [V,6], bs, powq
// out: dry [V,B], nraw [V,B], ncur [V,19], nlat [V,6], ntrig [V]
// f:   1/sr, 2pi/sr, sr/2, q^B, the triangle's taper threshold;  iv: seed
//      mix, triangle terms (-1: a sine)
//
// No recurrence: every sample is its own thread's.

__device__ void snare_a(const VoicePhase& p, int v, float* tri_gain) {
  const int B = p.B, t = threadIdx.x;
  Row r;
  r.init(IN_F(0) + v * 19, IN_F(1) + v * 19, IN_F(7), IN_I(2)[v], IN_I(4)[v], *IN_I(6), B);
  const float* lat = IN_F(5) + v * 6;
  float* dry = OUT_F(0) + static_cast<size_t>(v) * B;
  float* nraw = OUT_F(1) + static_cast<size_t>(v) * B;
  const float inv_sr = p.f[0], w = p.f[1], nyq = p.f[2], qB = p.f[3];
  const uint32_t smix = static_cast<uint32_t>(p.iv[0]);
  const int n_terms = p.iv[1];
  const TriConsts tri{w, nyq, p.f[4], n_terms};
  const int n_gain = tri_fill_gains(tri_gain, n_terms);
  __syncthreads();

  // trigger snapshots (snare.rs:873-1027)
  const float vel_new = clamp01(IN_F(3)[v]);
  const float decay_scale_new = 1.0f - 0.45f * vel_new * vel_new;
  const float pitch_mult_new = 1.0f + r.vat(5) * 1.5f;
  const float tc = DENORM(r.vat(8), 0.1, 10.0);
  const float ad = DENORM(r.vat(16), 0.0, 4.0) * decay_scale_new;
  const float ac = DENORM(r.vat(17), 0.1, 10.0);
  const float pm_active_new = r.vat(14) > 0.001f ? 1.0f : 0.0f;

  for (int n = t; n < B; n += kTile) {
    const bool after = r.after(n);
    const float vel = after ? vel_new : lat[0];
    const float pitch_mult = after ? pitch_mult_new : lat[1];
    const float tonal_curve = after ? tc : lat[3];
    const float pm_active = after ? pm_active_new : lat[5];
    const float idx = static_cast<float>(r.elapsed_i(n));
    const float el = idx * inv_sr;

    // live decays (snare.rs:1058-1105)
    const float vel2 = vel * vel;
    const float decay_scale = 1.0f - 0.45f * vel2;
    const float pitch_decay_scale = 1.0f - 0.5f * vel2;
    const float scaled_decay = DENORM(r.traj(4, n), 0.05, 3.5) * decay_scale;
    const float pitch_decay =
        fminf(scaled_decay * 0.3f * pitch_decay_scale, scaled_decay * 0.25f);
    const float base_freq = DENORM(r.traj(0, n), 100.0, 600.0) * tuning_mult(r.traj(18, n));
    const float pitch_env = adsr(el, 0.001f, pitch_decay, 0.0f, Lin{}, Lin{});
    float fmult = 1.0f + (pitch_mult - 1.0f) * pitch_env;
    const float pm_amt = r.traj(14, n);
    const float pm = phase_mod_env(el, pm_active > 0.5f);
    fmult = fmult * (pm_amt > 0.001f ? 1.0f + pm * pm_amt * 1.0f : 1.0f);
    const float hold_env = adsr(el, 0.001f, 0.001f, 1.0f, Lin{}, Lin{});

    const float tonal_raw = n_terms >= 0 ? triangle(idx, base_freq * fmult, tri, tri_gain, n_gain)
                                         : sinf(idx * (base_freq * fmult) * w);
    const float tonal_env = adsr(el, 0.001f, DENORM(r.traj(7, n), 0.0, 3.5) * decay_scale,
                                 0.0f, Lin{}, Pow{tonal_curve});
    const float xfade = r.traj(13, n);
    const float tonal_out =
        tonal_raw * hold_env * r.traj(1, n) * tonal_env * (1.0f - xfade);

    const float wn = white(static_cast<uint32_t>(static_cast<int>(floorf(idx))), smix);
    nraw[n] = wn * hold_env * (r.traj(2, n) * 0.8f);
    const float crack_env = adsr(el, 0.001f, scaled_decay * 0.2f, 0.0f, Lin{}, Lin{});
    const float crack_out = (wn * crack_env) * (r.traj(3, n) * 0.4f * (0.7f + 0.3f * vel));
    dry[n] = tonal_out + crack_out;
  }

  if (t == 0) {
    r.advance(OUT_F(2) + v * 19, 19, qB);
    const float news[6] = {vel_new, pitch_mult_new, ac, tc, ad, pm_active_new};
    float* nlat = OUT_F(3) + v * 6;
    for (int i = 0; i < 6; ++i) nlat[i] = r.has ? news[i] : lat[i];
    OUT_I(4)[v] = r.new_trig();
  }
}

// --- hihat2: the whole block (pallas_voice.py:1439-1549) ---------------------------
//
// in:  cur, tgt [V,6], off, vel, trig, lat [V,1], color [V] i32, slope [V] i32,
//      ph [V,3], hpf [V,8], svf [V,2], pink [V,3], salt [V] i32, bs, powq
// out: out [V,B], ncur [V,6], nlat [V,1], ntrig, nph [V,3], nhpf [V,8],
//      nsvf [V,2], npink [V,3]
// f:   1/sr, sr, q^B, 2pi, pi, 0.45 sr, down, 1-down, the attack curve's fp
//      and den, the decay curve's, poles[3], gains[3], direct, outg;  iv: seed mix
//
// Walks, first: the two phase accumulators (threads 0-1), the pink poles
// (thread 32), the envelope tracker (thread 64); then, on the oscillators'
// output, the two DF-I biquads and the tone SVF (thread 0).

// One DF-I biquad stage with trigger resets (pallas_voice._biquad_df1): the
// raw previous inputs, the feedback side as linrec2_bank steps it.
struct Biquad {
  float xr1, xr2, s1, s2, xp1;
  __device__ __forceinline__ float step(float x, float b0, float b1, float b2, float a1,
                                        float a2, float keep, float rprev) {
    xp1 = xr1 * keep;
    const float xp2 = xr2 * keep * (1.0f - rprev);
    const float w = b0 * x + b1 * xp1 + b2 * xp2;
    const float n1 = fmaf(-a1 * keep, s1, -a2 * keep * s2) + w;
    const float n2 = fmaf(keep, s1, 0.0f * s2) + 0.0f;
    s1 = n1;
    s2 = n2;
    xr2 = xr1;
    xr1 = x;
    return fabsf(s1) < 1e-15f ? 0.0f : s1;
  }
};

enum HihatSlot {
  kHModInc, kHMainInc,   // walked by threads 0-1 into kHModPh, kHMainPh
  kHModPh, kHMainPh,
  kHWhite, kHPinkW, kHPink, kHEnvRaw, kHEnv,
  kHB0, kHB1, kHA1, kHA2, kHToneG, kHToneH, kHVol, kHMainOut, kHOut,
  kHWork   // four slots: the accumulators' sums
};

__device__ void hihat2(const VoicePhase& p, int v, float* sh) {
  const int B = p.B, t = threadIdx.x;
  Row r;
  r.init(IN_F(0) + v * 6, IN_F(1) + v * 6, IN_F(14), IN_I(2)[v], IN_I(4)[v], *IN_I(13), B);
  const float lat0 = IN_F(5)[v];
  const int color = IN_I(6)[v], slope = IN_I(7)[v];
  const float* ph = IN_F(8) + v * 3;
  const float* hpf = IN_F(9) + v * 8;
  const float* svf = IN_F(10) + v * 2;
  const float* pink = IN_F(11) + v * 3;
  const uint32_t salt = static_cast<uint32_t>(IN_I(12)[v]);
  float* out = OUT_F(0) + static_cast<size_t>(v) * B;
  const float inv_sr = p.f[0], sr = p.f[1], qB = p.f[2], two_pi = p.f[3], pi = p.f[4];
  const float max_cut = p.f[5], down = p.f[6], one_m_down = p.f[7];
  const float fa = p.f[8], da = p.f[9], fd = p.f[10], dd = p.f[11];
  const uint32_t smix = static_cast<uint32_t>(p.iv[0]);
  const float vel_new = clamp01(IN_F(3)[v]);

  float pk[3] = {pink[0], pink[1], pink[2]};
  Biquad q1{hpf[0], hpf[1], hpf[2], hpf[3], 0.0f};
  Biquad q2{hpf[4], hpf[5], hpf[6], hpf[7], 0.0f};
  float ic1 = svf[0], ic2 = svf[1], env = ph[2];
  PhaseBank<2> bank;
  const auto inc = [&](int k, int i) { return SLOT(kHModInc + k)[i]; };
  float rprev = 0.0f;
  for (int n0 = 0; n0 < B; n0 += kTile) {
    const int len = min(kTile, B - n0);
    if (t < len) {
      const int n = n0 + t;
      const float el = static_cast<float>(r.elapsed_i(n)) * inv_sr;

      const float attack_s = DENORM(r.traj(2, n), 0.5, 200.0) * 0.001f;
      const float decay_s = DENORM(r.traj(1, n), 0.5, 4000.0) * 0.001f;
      const float pn = r.traj(0, n);
      const float pitch_hz = DENORM(pn * pn, 3500.0, 10000.0) * tuning_mult(r.traj(5, n));

      // noise (never reset; counter = global sample, salted per voice)
      const uint32_t n_glob = static_cast<uint32_t>(r.bs) + static_cast<uint32_t>(n);
      SLOT(kHWhite)[t] = white(n_glob + salt * 0x9E3779B9u, smix);
      SLOT(kHPinkW)[t] = white(n_glob, smix);

      // phase-mod oscillator increments (hihat2.rs:256-285, 497-505)
      SLOT(kHModInc)[t] = (pitch_hz * 0.1f) / sr;
      SLOT(kHMainInc)[t] = pitch_hz / sr;

      // highpass stages at pitch (RBJ, q = 1)
      const float omega = (two_pi * pitch_hz) / sr;
      const float sin_o = sinf(omega), cos_o = cosf(omega);
      const float alpha = sin_o / 2.0f;
      const float a0 = 1.0f + alpha;
      SLOT(kHB0)[t] = ((1.0f + cos_o) / 2.0f) / a0;
      SLOT(kHB1)[t] = -(1.0f + cos_o) / a0;
      SLOT(kHA1)[t] = (-2.0f * cos_o) / a0;
      SLOT(kHA2)[t] = (1.0f - alpha) / a0;

      // MaxCurve envelope, before the asymmetric smoother
      const float attack_prog = attack_s > 0.0f ? el / fmaxf(attack_s, 1e-9f) : 1.0f;
      const float decay_prog =
          decay_s > 0.0f ? (el - attack_s) / fmaxf(decay_s, 1e-9f) : 1.0f;
      const float env_raw = el < attack_s ? max_curve(attack_prog, fa, da, true)
                                          : 1.0f - max_curve(clamp01(decay_prog), fd, dd, true);
      SLOT(kHEnvRaw)[t] = el < 0.0f ? 0.0f : env_raw;

      // tone SVF highpass + volume
      const float tone_hz = DENORM(r.traj(3, n), 500.0, 10000.0);
      const float g = tanf((pi * clampf(tone_hz, 20.0f, max_cut)) / sr);
      SLOT(kHToneG)[t] = g;
      SLOT(kHToneH)[t] = 1.0f / (1.0f + 2.0f * g + g * g);
      SLOT(kHVol)[t] = r.traj(4, n);
    }
    __syncthreads();
    bank.start(n0, ph, inc);
    if (t < 2) {
      bank.walk_resid(len, sh, kHWork, inc);
    } else if (t == 32) {
      for (int i = 0; i < len; ++i) {
        const float pw = SLOT(kHPinkW)[i];
        for (int j = 0; j < 3; ++j) pk[j] = p.f[12 + j] * pk[j] + p.f[15 + j] * pw;
        SLOT(kHPink)[i] = (pk[0] + pk[1] + pk[2] + pw * p.f[18]) * p.f[19];
      }
    } else if (t == 64) {
      for (int i = 0; i < len; ++i) {
        const float env_raw = SLOT(kHEnvRaw)[i];
        env = fmaxf(env_raw, (r.at(n0 + i) ? 0.0f : one_m_down) * env + down * env_raw);
        SLOT(kHEnv)[i] = env;
      }
    }
    __syncthreads();
    bank.ramp(n0, len, sh, kHWork);
    __syncthreads();
    if (t < 2) bank.walk_base(r, n0, len, sh, kHWork);
    __syncthreads();
    bank.wrap(len, sh, kHWork, kHModPh);
    __syncthreads();
    if (t < len) {
      const float noise_sig = color == 1 ? SLOT(kHPink)[t] : SLOT(kHWhite)[t];
      const float mod_out = sinf(two_pi * rem1(SLOT(kHModPh)[t] + noise_sig * 0.25f));
      SLOT(kHMainOut)[t] = sinf(two_pi * rem1(SLOT(kHMainPh)[t] + mod_out * 0.75f));
    }
    __syncthreads();
    if (t == 0) {
      for (int i = 0; i < len; ++i) {
        const int n = n0 + i;
        const bool at = r.at(n);
        const float reset_f = at ? 1.0f : 0.0f;
        const float vel = r.after(n) ? vel_new : lat0;
        const float hb0 = SLOT(kHB0)[i], hb1 = SLOT(kHB1)[i];
        const float ha1 = SLOT(kHA1)[i], ha2 = SLOT(kHA2)[i];
        const float keep = 1.0f - reset_f;
        const float y1 = q1.step(SLOT(kHMainOut)[i], hb0, hb1, hb0, ha1, ha2, keep, rprev);
        const float y2 = q2.step(y1, hb0, hb1, hb0, ha1, ha2, keep, rprev);
        rprev = reset_f;
        const float filtered = slope == 1 ? y2 * 0.8f : y1;
        const float output = filtered * SLOT(kHEnv)[i] * vel * 0.35f;
        float v1, v2;
        svf_step(ic1, ic2, output, SLOT(kHToneG)[i], SLOT(kHToneH)[i], at, v1, v2);
        SLOT(kHOut)[i] = (output - (2.0f * v1 + v2)) * SLOT(kHVol)[i];
      }
    }
    __syncthreads();
    if (t < len) out[n0 + t] = SLOT(kHOut)[t];
    __syncthreads();
  }

  float* nph = OUT_F(4) + v * 3;
  if (t < 2) nph[t] = SLOT(kHModPh + t)[(B - 1) % kTile];
  if (t == 64) nph[2] = env;
  if (t == 32) {
    for (int i = 0; i < 3; ++i) OUT_F(7)[v * 3 + i] = pk[i];
  }
  if (t == 0) {
    r.advance(OUT_F(1) + v * 6, 6, qB);
    OUT_F(2)[v] = r.has ? vel_new : lat0;
    OUT_I(3)[v] = r.new_trig();
    float* nhpf = OUT_F(5) + v * 8;
    const Biquad* qs[2] = {&q1, &q2};
    for (int i = 0; i < 2; ++i) {
      nhpf[4 * i + 0] = qs[i]->xr1;
      nhpf[4 * i + 1] = qs[i]->xp1;
      nhpf[4 * i + 2] = qs[i]->s1;
      nhpf[4 * i + 3] = qs[i]->s2;
    }
    OUT_F(6)[v * 2] = ic1;
    OUT_F(6)[v * 2 + 1] = ic2;
  }
}

// --- bass: oscillators, bleps, 4x drive, the filter's trajectories ---------------
//
// in:  cur, tgt [V,16], off, vel, nf [V], trig, lat [V,6], ph [V,3],
//      packed [52,V], bs, powq
// out: satur, cut, res, ampsc [V,B], ncur [V,16], nlat [V,6], ntrig,
//      nph [V,3], nst [100,V]
// f:   1/sr, sr, q^B, 2pi, tanh(0.5), 18000/20
//
// Walks: the three phase accumulators (threads 0-2), then the 4x chain on
// their mix: its up-path (thread 0), the drive at each subsample (every
// thread), its down-path (thread 0).  The filter's trajectories and the amp
// scale are per sample.

__device__ __forceinline__ float poly_blep(float t, float dt) {
  dt = fmaxf(dt, 1e-12f);
  const float early = t / dt;
  const float late = (t - 1.0f) / dt;
  return t < dt ? 2.0f * early - early * early - 1.0f
                : (t > 1.0f - dt ? late * late + 2.0f * late + 1.0f : 0.0f);
}

enum BassSlot {
  kBInc, kBDetInc,       // the increments: sub and osc, det
  kBSub, kBOsc, kBDet,   // the accumulators' phases
  kBShape, kBT1, kBT2, kBT3, kBOd, kBDrive, kBD, kBCp, kBMix, kBSat,
  kBWork   // six slots: the accumulators' sums; then four: the 4x subsamples
};

__device__ void bass(const VoicePhase& p, const FbwsCoefs& k, int v, float* sh) {
  const int B = p.B, V = p.V, t = threadIdx.x;
  Row r;
  r.init(IN_F(0) + v * 16, IN_F(1) + v * 16, IN_F(10), IN_I(2)[v], IN_I(5)[v], *IN_I(9), B);
  const float* lat = IN_F(6) + v * 6;
  const float* ph = IN_F(7) + v * 3;
  const size_t row = static_cast<size_t>(v) * B;
  float* satur = OUT_F(0) + row;
  float* cut = OUT_F(1) + row;
  float* res = OUT_F(2) + row;
  float* ampsc = OUT_F(3) + row;
  const float inv_sr = p.f[0], sr = p.f[1], qB = p.f[2], two_pi = p.f[3], tanh_half = p.f[4];
  const float cut_span = p.f[5];

  // trigger snapshots (bass.rs:747-791)
  const float vel_new = clamp01(IN_F(3)[v]);
  const float nf = IN_F(4)[v];
  float freq_new = DENORM(r.vat(0), 30.0, 200.0);
  freq_new = nf > 0.0f ? nf : freq_new;
  const float ad_new = DENORM(r.vat(11), 0.05, 4.0);
  const float ac_new = DENORM(r.vat(12), 0.1, 10.0);
  const float fd_new = DENORM(r.vat(9), 0.01, 2.0);
  const float fc_new = DENORM(r.vat(10), 0.1, 8.0);

  PhaseBank<3> bank;
  const auto inc = [&](int k, int i) { return SLOT(k < 2 ? kBInc : kBDetInc)[i]; };
  FbwsState s;
  OvsCaps cap;
  if (t == 0) load_state(s, IN_F(8), v, V);
  for (int n0 = 0; n0 < B; n0 += kTile) {
    const int len = min(kTile, B - n0);
    if (t < len) {
      const int n = n0 + t;
      const bool after = r.after(n);
      const float freq = (after ? freq_new : lat[1]) * tuning_mult(r.traj(15, n));
      const float detune_cents = DENORM(r.traj(4, n), 0.0, 30.0);
      const float det_freq = freq * exp2f(detune_cents / 1200.0f);
      const float inc = freq / sr;
      SLOT(kBInc)[t] = inc;
      SLOT(kBDetInc)[t] = det_freq / sr;
      SLOT(kBShape)[t] = r.traj(5, n);
      SLOT(kBT1)[t] = r.traj(1, n);
      SLOT(kBT2)[t] = r.traj(2, n);
      SLOT(kBT3)[t] = r.traj(3, n);
      // the pre-filter waveshaper at drive 1 + 9*overdrive
      const float od = r.traj(13, n);
      const float drive = 1.0f + od * 9.0f;
      const float d = fmaxf(drive, 1.000001f);
      SLOT(kBOd)[t] = od;
      SLOT(kBDrive)[t] = drive;
      SLOT(kBD)[t] = d;
      SLOT(kBCp)[t] = tanh_half / tanhf(0.5f * d);
      // swept-filter trajectories (the SVF runs after the launch)
      const float el = static_cast<float>(r.elapsed_i(n)) * inv_sr;
      const float fd = after ? fd_new : lat[4];
      const float fc = after ? fc_new : lat[5];
      const float fenv = adsr(el, 0.001f, fd, 0.0f, Lin{}, Pow{fc});
      const float base_cutoff = 20.0f * powf(cut_span, clamp01(r.traj(6, n)));
      const float env_offset = (18000.0f - base_cutoff) * r.traj(8, n) * fenv;
      cut[n] = clampf(base_cutoff + env_offset, 20.0f, 18000.0f);
      res[n] = DENORM(r.traj(7, n), 0.5, 15.0);
      const float adv = after ? ad_new : lat[2];
      const float acv = after ? ac_new : lat[3];
      const float vel = after ? vel_new : lat[0];
      const float amp_env = adsr(el, 0.002f, adv, 0.0f, Lin{}, Pow{acv});
      ampsc[n] = amp_env * sqrtf(vel) * r.traj(14, n);
    }
    __syncthreads();
    // the oscillators: phase accumulators reset at the trigger
    bank.start(n0, ph, inc);
    if (t < 3) bank.walk_resid(len, sh, kBWork, inc);
    __syncthreads();
    bank.ramp(n0, len, sh, kBWork);
    __syncthreads();
    if (t < 3) bank.walk_base(r, n0, len, sh, kBWork);
    __syncthreads();
    bank.wrap(len, sh, kBWork, kBSub);
    __syncthreads();
    if (t < len) {
      const float inc = SLOT(kBInc)[t], det_inc = SLOT(kBDetInc)[t];
      const float osc_phase = SLOT(kBOsc)[t], det_phase = SLOT(kBDet)[t];
      const float sub_out = sinf(SLOT(kBSub)[t] * two_pi);
      const float shape = SLOT(kBShape)[t];
      const float saw_m = (2.0f * osc_phase - 1.0f) - poly_blep(osc_phase, inc);
      const float sq_m = (osc_phase < 0.5f ? 1.0f : -1.0f) + poly_blep(osc_phase, inc) -
                         poly_blep(rem1(osc_phase + 0.5f), inc);
      const float saw_d = (2.0f * det_phase - 1.0f) - poly_blep(det_phase, det_inc);
      const float sq_d = (det_phase < 0.5f ? 1.0f : -1.0f) + poly_blep(det_phase, det_inc) -
                         poly_blep(rem1(det_phase + 0.5f), det_inc);
      const float osc_out = saw_m * (1.0f - shape) + sq_m * shape;
      const float det_out = saw_d * (1.0f - shape) + sq_d * shape;
      SLOT(kBMix)[t] =
          sub_out * SLOT(kBT1)[t] + osc_out * SLOT(kBT2)[t] + det_out * SLOT(kBT3)[t];
    }
    __syncthreads();
    // the 4x chain: its up-path, the drive at every subsample, its down-path
    float* sub = SLOT(kBWork);
    if (t == 0) {
      ovs4_up_span(s, cap, k, n0, n0 + len, B, [&](int n) { return SLOT(kBMix)[n - n0]; },
                   sub);
    }
    __syncthreads();
    for (int j = t; j < 4 * len; j += kTile) {
      sub[j] = DriveShaper{SLOT(kBD)[j >> 2], SLOT(kBCp)[j >> 2]}(sub[j]);
    }
    __syncthreads();
    if (t == 0) {
      ovs4_down_span(s, cap, k, n0, n0 + len, B, sub, [&](int n, float sat) {
        const int i = n - n0;
        const float mix = SLOT(kBMix)[i];
        float ws_out = SLOT(kBDrive)[i] <= 1.0f ? mix : sat;
        ws_out = isfinite(mix) ? ws_out : 0.0f;
        SLOT(kBSat)[i] = SLOT(kBOd)[i] > 0.001f ? ws_out : mix;
      });
    }
    __syncthreads();
    if (t < len) satur[n0 + t] = SLOT(kBSat)[t];
    __syncthreads();
  }

  if (t < 3) OUT_F(7)[v * 3 + t] = SLOT(kBSub + t)[(B - 1) % kTile];
  if (t == 0) {
    store_span_state(s, cap, OUT_F(8), v, V);
    r.advance(OUT_F(4) + v * 16, 16, qB);
    const float news[6] = {vel_new, freq_new, ad_new, ac_new, fd_new, fc_new};
    float* nlat = OUT_F(5) + v * 6;
    for (int i = 0; i < 6; ++i) nlat[i] = r.has ? news[i] : lat[i];
    OUT_I(6)[v] = r.new_trig();
  }
}

// --- tom2: the sources (pallas_voice.py:1646-1810) ----------------------------------
//
// in:  par [V,9], off, trig, dec [V], ph [V,6], seg [V] i32, bs
// out: mixed, env, done, fade, freq [V,B], ntrig [V] i32, ndec [V], nph [V,6],
//      nseg [V] i32
// f:   1/sr, sr, 2pi, 190/sr, the attack curve's fp and den, the decay's;
// iv:  seed mix, rand~ seed mix, triangle on, B
//
// Walks: the five phase accumulators (threads 0-4; the fixed one at a
// constant increment) and the rand~ ramp (thread 32).

__constant__ float kTomImpulse[64] = {
    0.884058f, 0.942029f, 0.913043f, 0.869565f, 0.833333f, 0.797101f, 0.772947f,
    0.748792f, 0.724638f, 0.695652f, 0.666667f, 0.637681f, 0.619565f, 0.601449f,
    0.583333f, 0.565217f, 0.536232f, 0.507246f, 0.478261f, 0.449275f, 0.42029f,
    0.391304f, 0.371981f, 0.352657f, 0.333333f, 0.304348f, 0.275362f, 0.23913f,
    0.202899f, 0.181159f, 0.15942f,  0.137681f, 0.115942f, 0.101449f, 0.086957f,
    0.072464f, 0.057971f, 0.043478f, 0.028986f, 0.014493f, 0.009662f, 0.004831f,
    0.0f,      0.0f,      0.0f,      0.0f,      0.0f,      0.0f,      0.0f,
    0.0f,      0.0f,      0.0f,      0.0f,      0.0f,      0.014493f, 0.0f,
    0.0f,      0.0f,      0.0f,      0.0f,      0.0f,      0.0f,      0.0f,
    0.0f};

__device__ __forceinline__ float tri_wave(float t) { return t < 0.5f ? 4.0f * t - 1.0f : 3.0f - 4.0f * t; }

enum TomSlot {
  kTInc, kTTri, kTMain, kTTri2, kTFixed, kTGated,   // the accumulators' phases
  kTClick, kTWhite, kTFrac, kTSeg,
  kTWork   // ten slots: the accumulators' sums
};

__device__ void tom2(const VoicePhase& p, int v, float* sh) {
  const int B = p.iv[3], t = threadIdx.x;
  const float* par = IN_F(0) + v * 9;
  const int off = IN_I(1)[v], trig = IN_I(2)[v];
  const float dec = IN_F(3)[v];
  const float* ph = IN_F(4) + v * 6;
  const int seg0 = IN_I(5)[v];
  const int bs = *IN_I(6);
  const size_t row = static_cast<size_t>(v) * B;
  const float inv_sr = p.f[0], sr = p.f[1], two_pi = p.f[2], fixed = p.f[3];
  const float fu = p.f[4], du = p.f[5], fdn = p.f[6], ddn = p.f[7];
  const uint32_t smix = static_cast<uint32_t>(p.iv[0]), rmix = static_cast<uint32_t>(p.iv[1]);
  const bool triangle_on = p.iv[2] != 0;
  const bool has = off < B;
  // the walkers' Row: trigger offset and latch only (tom2 has no smoothers)
  Row r;
  r.has = has;
  r.off = off;

  // per-row parameters (plain 0-100 values)
  const float decay_new = (0.5f + (par[4] / 100.0f) * 3999.5f) * 0.001f;
  const float tn = par[0] / 100.0f;
  const float base_freq = (40.0f + tn * tn * 560.0f) * tuning_mult(par[8]);
  const float bend_scaled = (par[1] / 100.0f) * 2.0f;
  const float tone = par[2];
  const float mix_control = (par[2] / 100.0f) * 2.0f - 1.0f;
  const float color_midi = 30.0f + (par[3] / 100.0f) * 20.0f;
  const float cf1 = 440.0f * exp2f((color_midi - 69.0f) / 12.0f);
  const float rand_freq = 440.0f * exp2f((cf1 - 69.0f) / 12.0f);
  const float inc_r = rand_freq / sr + 0.0f;
  const float w1 = clamp01(-mix_control);
  const float w2 = clamp01(1.0f - fabsf(mix_control));
  const float w3 = clamp01(mix_control);
  const float hi_r = floorf(inc_r * 2048.0f) / 2048.0f;
  const float lo_r = inc_r - hi_r;

  PhaseBank<5> bank;
  const auto inc = [&](int k, int i) { return k == 3 ? fixed : SLOT(kTInc)[i]; };
  float resid_r = 0.0f, base_r = -ph[5], pprev_r = 0.0f, frac = 0.0f;
  int seg = seg0;
  for (int n0 = 0; n0 < B; n0 += kTile) {
    const int len = min(kTile, B - n0);
    if (t < len) {
      const int n = n0 + t;
      const bool after = has && n >= off;
      const uint32_t te = after ? static_cast<uint32_t>(bs) + static_cast<uint32_t>(off)
                                : static_cast<uint32_t>(trig);
      const int ei = static_cast<int>(static_cast<uint32_t>(bs) + static_cast<uint32_t>(n) - te);
      const float el = static_cast<float>(ei) * inv_sr;

      // decay latch + envelope [(1, 1 ms, 0.8), (0, decay, -0.83)]
      const float decay_s = after ? decay_new : dec;
      float env = el < 0.001f ? max_curve(el / 0.001f, fu, du, false)
                              : 1.0f - max_curve(clamp01((el - 0.001f) / decay_s), fdn, ddn, true);
      env = el < 0.0f ? 0.0f : env;
      const bool env_complete = el >= (0.001f + decay_s);

      // pitch
      const float pm = env * bend_scaled;
      const float raw_freq = base_freq * (1.0f + pm * pm);
      const bool past_attack = (el >= 0.001f) || (env > 0.9f);
      const bool main_done = env_complete || (past_attack && (raw_freq < 20.0f));
      const float fade =
          (past_attack && (raw_freq < 40.0f)) ? (raw_freq - 20.0f) / 20.0f : 1.0f;
      const float freq = fmaxf(raw_freq, 40.0f);
      OUT_F(1)[row + n] = env;
      OUT_F(2)[row + n] = main_done ? 1.0f : 0.0f;
      OUT_F(3)[row + n] = fade;
      OUT_F(4)[row + n] = freq;

      // ClickOsc; the oscillators' increment
      SLOT(kTClick)[t] = ((ei >= 0 && ei < 64) ? kTomImpulse[ei] : 0.0f) * 1.1f;
      SLOT(kTInc)[t] = freq / sr;
      SLOT(kTWhite)[t] = white(static_cast<uint32_t>(ei), smix) * 0.2f;
    }
    __syncthreads();
    // the standalone triangle and MorphOsc's main, triangle, fixed and gated
    bank.start(n0, ph, inc);
    if (t < 5) {
      bank.walk_resid(len, sh, kTWork, inc);
    } else if (t == 32) {
      // rand~: S&H with linear ramps on the split-increment accumulator
      for (int i = 0; i < len; ++i) {
        const int n = n0 + i;
        const float reset_f = (has && n == off) ? 1.0f : 0.0f;
        const float n1 = static_cast<float>(n + 1);
        resid_r = 1.0f * resid_r + (inc_r - inc_r);
        const float p_r = (hi_r * n1 + lo_r * n1) + resid_r;
        base_r = (1.0f - reset_f) * base_r + reset_f * pprev_r;
        pprev_r = p_r;
        const float total = p_r - base_r;
        const float seg_local = floorf(total);
        frac = total - seg_local;
        seg = ((has && n >= off) ? 0 : seg0) + static_cast<int>(seg_local);
        SLOT(kTFrac)[i] = frac;
        SLOT(kTSeg)[i] = __int_as_float(seg);
      }
    }
    __syncthreads();
    bank.ramp(n0, len, sh, kTWork);
    __syncthreads();
    if (t < 5) bank.walk_base(r, n0, len, sh, kTWork);
    __syncthreads();
    bank.wrap(len, sh, kTWork, kTTri);
    __syncthreads();
    if (t < len) {
      const float inc = SLOT(kTInc)[t];
      const float tri_out = triangle_on ? tri_wave(rem1(SLOT(kTTri)[t] - inc)) * 0.5f : 0.0f;
      const float main_sine = sinf(two_pi * rem1(SLOT(kTMain)[t] - inc)) * 0.5f;
      const float tri_m = tri_wave(rem1(SLOT(kTTri2)[t] - inc)) * 0.5f;
      const float fixed_sine = sinf(two_pi * rem1(SLOT(kTFixed)[t] - fixed)) * 0.5f;
      const float gated_sine =
          tone < 99.0f ? sinf(two_pi * rem1(SLOT(kTGated)[t] - inc)) * 0.2f : 0.0f;
      const int sg = __float_as_int(SLOT(kTSeg)[t]);
      const float tgt_r = sg >= 1 ? white(static_cast<uint32_t>(sg), rmix) : 0.0f;
      const float cur_r = sg >= 2 ? white(static_cast<uint32_t>(sg) - 1u, rmix) : 0.0f;
      const float rand_value = cur_r + (tgt_r - cur_r) * SLOT(kTFrac)[t];

      const float noise_combined = (SLOT(kTWhite)[t] + rand_value) * 0.4f;
      const float ch1 = main_sine * fixed_sine;
      const float ch2 = tri_m + noise_combined;
      const float ch3 = noise_combined + gated_sine;
      OUT_F(0)[row + n0 + t] = SLOT(kTClick)[t] + tri_out + (ch1 * w1 + ch2 * w2 + ch3 * w3);
    }
    __syncthreads();
  }

  float* nph = OUT_F(7) + v * 6;
  if (t < 5) {
    const float last = SLOT(kTTri + t)[(B - 1) % kTile];
    nph[t] = t == 0 ? rem1(last) : last;
  }
  if (t == 32) {
    nph[5] = frac;
    OUT_I(8)[v] = seg;
  }
  if (t == 0) {
    OUT_I(5)[v] = has ? static_cast<int>(static_cast<uint32_t>(bs) + static_cast<uint32_t>(off))
                      : trig;
    OUT_F(6)[v] = has ? decay_new : dec;
  }
}

#undef SLOT

// --- the chunk pipeline of kit_drive ---------------------------------------------
//
// A block of kDrvThreads threads owns one voice row and cuts its B samples
// into chunks of kDrvChunk, a step apart on four warps (ws4_bank's split in
// bank_kernels.cu, for one row).  In step j, warp 2 computes chunk j+1's
// per-sample values (the 4x chain's input, the shaper's parameters, what
// the down-walk and the finish read; a lane a sample) into a ring of
// kDrvRing chunks in shared memory; warps 2-3 shape chunk j-1's subsamples
// in place; warp 3 finishes chunk j-3 and stores it coalesced.  Lane 0 of
// warp 0 walks the up-path of chunk j (ovs4_up_span) into a ring of
// subsample tiles, lane 0 of warp 1 the down-path of chunk j-2
// (ovs4_down_span), with the body's own recurrences beside it (the kick's
// DC blocker and feedback filter), into an output tile.  One __syncthreads
// a step.  The two walks hold disjoint halves of the packed state, each
// loaded and stored by its own lane (load_up_state / store_down_state in
// ovs4.cuh), the DC rows with the down half.

constexpr int kDrvThreads = 128;   // warp 0 up, warp 1 down, warps 2-3 per sample
constexpr int kDrvChunk = 32;      // samples a chunk: a lane each of warps 2 and 3
constexpr int kDrvRing = 5;        // per-sample chunks: written, up, shaped, down, finished
constexpr int kDrvSubRing = 3;     // subsample chunks: walked up, shaped, walked down
constexpr int kDrvSlots = 4;       // per-sample arrays a chunk

using DriveSlots = float[kDrvSlots][kDrvChunk];

struct DriveSmem {
  DriveSlots ps[kDrvRing];
  float sub[kDrvSubRing][4 * kDrvChunk];
  float y[2][kDrvChunk];
};

// One voice row of a drive body through the pipeline.  The body gives
// input(ps, n, i): sample n, lane i of its chunk, into ps[slot][i] (slot 0
// the 4x chain's input); shape(ps, sub, i): subsample i of a chunk (its
// sample i >> 2), in place; down(s, ps, i, y): the down-walk's output y of
// the chunk's sample i, returning what finish reads; finish(ps, y, n, i);
// load_down() and store_down(): the down lane's own state.
template <class Body>
__device__ __forceinline__ void drive_row(Body& b, const FbwsCoefs& k, int B, int V, int v,
                                          const float* st_in, float* st_out, DriveSmem& sm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool up = warp == 0 && lane == 0, down = warp == 1 && lane == 0;
  const int n_chunks = (B + kDrvChunk - 1) / kDrvChunk;
  auto len = [&](int c) { return min(kDrvChunk, B - c * kDrvChunk); };
  FbwsState s;
  OvsCaps cap;
  if (up) load_up_state(s, st_in, v, V);
  if (down) {
    load_down_state(s, st_in, v, V);
    b.load_down();
  }
  if (warp == 2 && lane < len(0)) b.input(sm.ps[0], lane, lane);
  for (int j = 0; j < n_chunks + 2; ++j) {
    __syncthreads();   // step j-1 done everywhere
    if (up) {
      if (j < n_chunks) {
        const int n0 = j * kDrvChunk;
        const float* u = sm.ps[j % kDrvRing][0];
        ovs4_up_span(
            s, cap, k, n0, n0 + len(j), B, [&](int n) { return u[n - n0]; },
            sm.sub[j % kDrvSubRing]);
      }
    } else if (down) {
      if (j >= 2) {
        const int c = j - 2, n0 = c * kDrvChunk;
        const DriveSlots& ps = sm.ps[c % kDrvRing];
        float* y = sm.y[c & 1];
        ovs4_down_span(s, cap, k, n0, n0 + len(c), B, sm.sub[c % kDrvSubRing],
                       [&](int n, float yn) { y[n - n0] = b.down(s, ps, n - n0, yn); });
      }
    } else if (warp >= 2) {
      if (warp == 2) {
        const int c = j + 1;
        if (c < n_chunks && lane < len(c)) b.input(sm.ps[c % kDrvRing], c * kDrvChunk + lane, lane);
      } else if (j >= 3 && lane < len(j - 3)) {
        const int c = j - 3;
        b.finish(sm.ps[c % kDrvRing], sm.y[c & 1], c * kDrvChunk + lane, lane);
      }
      if (j >= 1 && j <= n_chunks) {
        const int c = j - 1;
        for (int i = threadIdx.x - 64; i < 4 * len(c); i += kDrvThreads - 64)
          b.shape(sm.ps[c % kDrvRing], sm.sub[c % kDrvSubRing], i);
      }
    }
  }
  __syncthreads();
  const int c = n_chunks - 1;
  if (warp == 3 && lane < len(c)) {
    b.finish(sm.ps[c % kDrvRing], sm.y[c & 1], c * kDrvChunk + lane, lane);
  }
  if (up) store_up_state(s, cap.u1, cap.u2, st_out, v, V);
  if (down) {
    store_down_state(s, cap.d2, cap.d1, st_out, v, V);
    b.store_down();
  }
}

// --- kick B: 4x tanh drive, makeup gain, DC blocker, amp (pallas_voice.py:599) ----
//
// in:  total, comp_signed, ampsc [V,B], cur, tgt [V,19], packed [52,V],
//      filt0 [V], powq
// out: out [V,B], nst [100,V], nfilt [V]
// f:   sr, -2pi
//
// Per sample: drive*x into the chain, the signed makeup gain, the feedback
// cutoff's coefficient (an expf); walked on the down lane: the gated DC
// blocker and the feedback filter.

enum KickDriveSlot { kKdIn, kKdCs, kKdFbc };

struct KickDrive {
  const float *x, *cs, *amp, *cur, *tgt, *powq, *filt0;
  float *out, *nfilt;
  float sr, m2pi, filt;
  __device__ float traj(int i, int n) const {
    return snap(tgt[i], (cur[i] - tgt[i]) * powq[n + 1]);
  }
  __device__ void input(DriveSlots& ps, int n, int i) const {
    const float od = traj(13, n);
    const float drive = 1.0f + od * od * od * 40.0f;
    ps[kKdIn][i] = drive * x[n];
    ps[kKdCs][i] = cs[n];
    const float fbc_hz = 200.0f + traj(15, n) * 3800.0f;
    ps[kKdFbc][i] = clampf(1.0f - expf((m2pi * fbc_hz) / sr), 0.0f, 0.9f);
  }
  __device__ void shape(const DriveSlots&, float* sub, int i) const {
    sub[i] = TanhShaper{}(sub[i]);
  }
  __device__ float down(FbwsState& s, const DriveSlots& ps, int i, float y) {
    const float c = ps[kKdCs][i];
    const bool byp = c < 0.0f;
    const float dc = gated_dc(s, y, c);
    // feedback-filter bookkeeping (the loop gain is 0 on this path)
    const float fbc = ps[kKdFbc][i];
    filt = (byp ? 1.0f : 1.0f - fbc) * filt + (byp ? 0.0f : fbc * dc);
    return dc;
  }
  __device__ void finish(const DriveSlots& ps, const float* dc, int n, int i) const {
    out[n] = (ps[kKdCs][i] < 0.0f ? x[n] : dc[i]) * amp[n];
  }
  __device__ void load_down() { filt = *filt0; }
  __device__ void store_down() const { *nfilt = fabsf(filt) < 1e-15f ? 0.0f : filt; }
};

__device__ KickDrive kick_b(const VoicePhase& p, int v) {
  const size_t row = static_cast<size_t>(v) * p.B;
  KickDrive b;
  b.x = IN_F(0) + row;
  b.cs = IN_F(1) + row;
  b.amp = IN_F(2) + row;
  b.cur = IN_F(3) + v * 19;
  b.tgt = IN_F(4) + v * 19;
  b.filt0 = IN_F(6) + v;
  b.powq = IN_F(7);
  b.out = OUT_F(0) + row;
  b.nfilt = OUT_F(2) + v;
  b.sr = p.f[0];
  b.m2pi = p.f[1];
  b.filt = 0.0f;
  return b;
}

// --- snare B: noise envelopes, 4x waveshaper, amp (pallas_voice.py:960) ------------
//
// in:  cur, tgt [V,19], off, vel, trig, lat [V,6], dry [V,B], filt [V,B],
//      packed [52,V], bs, powq
// out: out [V,B], nst [100,V]
// f:   1/sr, tanh(0.5)
//
// Per sample: the noise envelopes and the chain's input, the drive and its
// makeup gain (a tanhf), and the finish (the amplitude envelope, a powf).

enum SnareDriveSlot { kSdIn, kSdDrive, kSdD, kSdCp };

struct SnareDrive {
  Row r;
  const float *lat, *dry, *filt;
  float* out;
  float inv_sr, tanh_half, vel_new, ad, ac;
  // sample n's latched velocity, amplitude decay and curve, and seconds
  // since its trigger
  __device__ void latched(int n, float& vel, float& amp_decay_s, float& amp_curve,
                          float& el) const {
    const bool after = r.after(n);
    vel = after ? vel_new : lat[0];
    amp_decay_s = after ? ad : lat[4];
    amp_curve = after ? ac : lat[2];
    el = static_cast<float>(r.elapsed_i(n)) * inv_sr;
  }
  __device__ void input(DriveSlots& ps, int n, int i) const {
    float vel, amp_decay_s, amp_curve, el;
    latched(n, vel, amp_decay_s, amp_curve, el);
    const float decay_scale = 1.0f - 0.45f * vel * vel;
    const float noise_env = adsr(el, 0.001f, DENORM(r.traj(9, n), 0.0, 3.5) * decay_scale,
                                 0.0f, Lin{}, Lin{});
    const float tail_env = adsr(el, 0.001f, DENORM(r.traj(10, n), 0.0, 3.5) * decay_scale,
                                0.0f, Lin{}, Lin{});
    const float xfade = r.traj(13, n);
    ps[kSdIn][i] = dry[n] + filt[n] * (noise_env * 0.7f + tail_env * 0.3f) * xfade;
    const float drive = 1.0f + r.traj(15, n) * 9.0f;
    const float d = fmaxf(drive, 1.000001f);
    ps[kSdDrive][i] = drive;
    ps[kSdD][i] = d;
    ps[kSdCp][i] = tanh_half / tanhf(0.5f * d);
  }
  __device__ void shape(const DriveSlots& ps, float* sub, int i) const {
    sub[i] = DriveShaper{ps[kSdD][i >> 2], ps[kSdCp][i >> 2]}(sub[i]);
  }
  __device__ float down(FbwsState&, const DriveSlots&, int, float sat) const { return sat; }
  __device__ void finish(const DriveSlots& ps, const float* sat, int n, int i) const {
    const float total = ps[kSdIn][i];
    const float wet = total * (1.0f - 1.0f) + sat[i] * 1.0f;
    float shaped = ps[kSdDrive][i] <= 1.0f ? total : wet;
    shaped = isfinite(total) ? shaped : 0.0f;
    float vel, amp_decay_s, amp_curve, el;
    latched(n, vel, amp_decay_s, amp_curve, el);
    const float amp_env =
        adsr(el, 0.001f, fmaxf(amp_decay_s, 0.001f), 0.0f, Lin{}, Pow{amp_curve});
    out[n] = shaped * amp_env * sqrtf(vel) * r.traj(6, n);
  }
  __device__ void load_down() const {}
  __device__ void store_down() const {}
};

__device__ SnareDrive snare_b(const VoicePhase& p, int v) {
  const int B = p.B;
  const size_t row = static_cast<size_t>(v) * B;
  SnareDrive b;
  b.r.init(IN_F(0) + v * 19, IN_F(1) + v * 19, IN_F(10), IN_I(2)[v], IN_I(4)[v], *IN_I(9), B);
  b.lat = IN_F(5) + v * 6;
  b.dry = IN_F(6) + row;
  b.filt = IN_F(7) + row;
  b.out = OUT_F(0) + row;
  b.inv_sr = p.f[0];
  b.tanh_half = p.f[1];
  b.vel_new = clamp01(IN_F(3)[v]);
  b.ad = DENORM(b.r.vat(16), 0.0, 4.0) * (1.0f - 0.45f * b.vel_new * b.vel_new);
  b.ac = DENORM(b.r.vat(17), 0.1, 10.0);
  return b;
}

// --- the kernels ----------------------------------------------------------------------

// The phase of this block and its first row (a block a voice row in both
// kernels).
__device__ __forceinline__ const VoicePhase& phase_of(const Kit& kit, int& v) {
  int i = 0;
  while (i + 1 < kit.n && static_cast<int>(blockIdx.x) >= kit.ph[i + 1].block0) ++i;
  v = static_cast<int>(blockIdx.x) - kit.ph[i].block0;
  return kit.ph[i];
}

__global__ void __launch_bounds__(kTile) kit_sources_kernel(const Kit kit, FbwsCoefs k) {
  __shared__ float sh[kSlots * kTile];
  __shared__ float tri_gain[kTriTable];
  int v;
  const VoicePhase& p = phase_of(kit, v);
  switch (p.body) {
    case kKickA:
      kick_a(p, v, sh, tri_gain);
      break;
    case kSnareA:
      snare_a(p, v, tri_gain);
      break;
    case kHihat2:
      hihat2(p, v, sh);
      break;
    case kBass:
      bass(p, k, v, sh);
      break;
    case kTom2:
      tom2(p, v, sh);
      break;
    default:
      break;
  }
}

__global__ void __launch_bounds__(kDrvThreads) kit_drive_kernel(const Kit kit, FbwsCoefs k) {
  __shared__ DriveSmem sm;
  int v;
  const VoicePhase& p = phase_of(kit, v);
  switch (p.body) {
    case kKickB: {
      KickDrive b = kick_b(p, v);
      drive_row(b, k, p.B, p.V, v, IN_F(5), OUT_F(1), sm);
      break;
    }
    case kSnareB: {
      SnareDrive b = snare_b(p, v);
      drive_row(b, k, p.B, p.V, v, IN_F(8), OUT_F(1), sm);
      break;
    }
    default:
      break;
  }
}

// ops: (body, V, B) per phase; ptrs: in[16], out[10] per phase; f: 24 and
// iv: 8 per phase.  Returns the grid's block count (a block a voice row),
// or -1 for a bad table.
int make_kit(Kit& kit, int n, const int* ops, void* const* ptrs, const float* f, const int* iv,
             int lo, int hi) {
  if (n < 1 || n > kMaxPhases) return -1;
  kit.n = n;
  int blocks = 0;
  for (int i = 0; i < n; ++i) {
    VoicePhase& p = kit.ph[i];
    p.body = ops[3 * i];
    p.V = ops[3 * i + 1];
    p.B = ops[3 * i + 2];
    if (p.body < lo || p.body > hi || p.V < 1 || p.B < 1) return -1;
    p.block0 = blocks;
    blocks += p.V;
    void* const* pp = ptrs + (kIn + kOut) * i;
    for (int j = 0; j < kIn; ++j) p.in[j] = pp[j];
    for (int j = 0; j < kOut; ++j) p.out[j] = pp[kIn + j];
    for (int j = 0; j < kNF; ++j) p.f[j] = f[kNF * i + j];
    for (int j = 0; j < kNI; ++j) p.iv[j] = iv[kNI * i + j];
  }
  return blocks;
}

}  // namespace

extern "C" {

int kit_sources_launch(int n, const int* ops, void* const* ptrs, const float* f, const int* iv,
                       const float* coefs, void* stream) {
  Kit kit{};
  const int blocks = make_kit(kit, n, ops, ptrs, f, iv, kKickA, kTom2);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  kit_sources_kernel<<<blocks, kTile, 0, as_stream(stream)>>>(kit, fbws_coefs(coefs));
  return static_cast<int>(cudaGetLastError());
}

int kit_drive_launch(int n, const int* ops, void* const* ptrs, const float* f, const int* iv,
                     const float* coefs, void* stream) {
  Kit kit{};
  const int blocks = make_kit(kit, n, ops, ptrs, f, iv, kKickB, kSnareB);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  kit_drive_kernel<<<blocks, kDrvThreads, 0, as_stream(stream)>>>(kit, fbws_coefs(coefs));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
