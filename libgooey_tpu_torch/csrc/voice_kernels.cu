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
// bus_chain takes its phases; each phase owns a range of blocks and each
// thread one voice row of it.  The thread walks the row's B samples in
// order with every carry in registers: the smoother trajectories (closed
// form, q^(n+1) from a table), the trigger latches, the envelopes, the
// oscillators and the counter-hash noise are per-sample functions, and the
// linear recurrences the Pallas bodies solve with lane scans (the kick's
// click high-pass, pink poles and noise SVF; hihat2's pink poles, DF-I
// biquads, envelope tracker and tone SVF; every phase accumulator and
// tom2's rand~ ramp) are stepped, not scanned.  The bass's and the drive
// bodies' 4x chains are the shared ovs4.cuh chain, with the port's packed
// [S, V] state layout (the TPU's [2Vp, K] packing and its row padding to 8
// are layout workarounds of that chip and are not ported).
//
// Each body follows its plain version in ops/voice_kernels.py op for op; the
// build's -fmad=false keeps a*b + c as two roundings there as here, and
// every constant division is a true division on both sides.  The kernel
// and its plain version then differ only where a libdevice function and
// PyTorch's differ.
//
// What bounds it on the card: at the product kit (64 voices, B = 512) a
// launch moves a few hundred KB and does ~12 M operations (the kick's and
// the snare's additive triangles, 32 harmonics a sample, dominate):
// against 3.35 TB/s and 67 TFLOP/s a fraction of a microsecond.  The
// kernel takes the time of one thread's serial B-sample walk (2.5 ms for
// kit_sources, 0.38 ms for kit_drive on an H100, PERF.md).  Five families
// fill five blocks of 32 threads (16 of a warp's lanes busy at 16 voices),
// five of 132 SMs.  Splitting each row's block
// across threads (the elementwise part per sample, the recurrences as a
// two-pass scan) is the first thing to improve.  A thread writes its row's
// B samples contiguously, so a warp's stores touch 32 lines per sample; the
// lines fill across the following samples in L2.
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError(); nothing allocates or synchronizes here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ovs4.cuh"

namespace {

constexpr int kThreads = 32;
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

// The additive odd-harmonic triangle of one sample (osc_kernels.cu)
__device__ __forceinline__ float triangle(float idx, float f, float w, float nyquist,
                                          int n_terms) {
  const float theta = idx * f * w;
  const float sin1 = sinf(theta);
  const float cos2x2 = 2.0f * cosf(2.0f * theta);
  const float max_h = floorf(nyquist / fmaxf(f, 1e-6f));
  float prev = -sin1, curr = sin1, acc = 0.0f;
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
  return acc;
}

// Max/MSP curve~ with exp(x) - 1 (pallas_voice._max_curve); fp and den are
// the curve's float32 constants
__device__ __forceinline__ float max_curve(float p, float fp, float den, bool negative) {
  p = clamp01(p);
  if (negative) return 1.0f - (expf(fp * (1.0f - p)) - 1.0f) / den;
  return (expf(fp * p) - 1.0f) / den;
}

// The mod-1 phase accumulator with trigger resets in its split-increment
// form (pallas_voice._phase_cumsum_reset), stepped
struct PhaseAcc {
  float inc0, hi, lo, resid, base, p_prev;
  __device__ __forceinline__ void init(float first_inc, float carry) {
    inc0 = first_inc;
    hi = floorf(inc0 * 2048.0f) * static_cast<float>(1.0 / 2048.0);
    lo = inc0 - hi;
    resid = 0.0f;
    base = -carry;
    p_prev = 0.0f;
  }
  __device__ __forceinline__ float step(int n, float inc, float r) {
    const float n1 = static_cast<float>(n + 1);
    float ramp_hi = hi * n1;
    ramp_hi = ramp_hi - floorf(ramp_hi);
    const float ramp = ramp_hi + lo * n1;
    resid = 1.0f * resid + (inc - inc0);
    const float p = rem1(ramp + resid);
    base = (1.0f - r) * base + r * p_prev;
    p_prev = p;
    return rem1(p - base);
  }
};

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

// --- kick A: sources (pallas_voice.py:431-593) ----------------------------------
//
// in:  cur, tgt [V,19], off [V] i32, vel [V], trig [V] i32, lat [V,6], fst [V,6],
//      bs i32, powq [B+1]
// out: total [V,B], ampsc [V,B], ncur [V,19], nlat [V,6], ntrig [V] i32, nfst [V,6]
// f:   1/sr, 2pi/sr, sr/2, alpha, 1-alpha, max cutoff, sr, q^B, poles[3],
//      gains[3], direct, outg;  iv: seed mix, triangle terms (-1: none)

__device__ void kick_a(const VoicePhase& p, int v) {
  const int B = p.B;
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
  const float news[6] = {vel_new, pitch_mult_new, pitch_curve_new, ad, amp_curve_new,
                         pm_active_new};

  float click_y = fst[0], ic1 = fst[1], ic2 = fst[2];
  float pk[3] = {fst[3], fst[4], fst[5]};
  for (int n = 0; n < B; ++n) {
    const bool after = r.after(n), at = r.at(n);
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
            ? triangle(idx, base_freq * 2.5f * fmult, w, nyq, n_terms) * osc_env *
                  (r.traj(1, n) * 0.7f)
            : 0.0f;

    const float click_env = adsr(el, 0.001f, base_decay * 0.2f, 0.0f, Lin{}, Lin{});
    const float click_vel_scale = 0.6f + 0.4f * vel;
    const float click_white = white(static_cast<uint32_t>(static_cast<int>(floorf(idx))), smix);
    const float pink_white = white(static_cast<uint32_t>(ei), smix);
    const float click_raw = click_white * click_env * (r.traj(3, n) * 0.15f * click_vel_scale);
    // cheap resonant HP at 8 kHz / res 4 (resonant_highpass.rs:22-53)
    const float s_prev = at ? 0.0f : click_y;
    click_y = (at ? 0.0f : oma) * click_y + alpha * click_raw;
    const float click_out = (click_raw - s_prev) * 1.4f;

    // pink-noise layer (kick.rs:1174-1193)
    for (int i = 0; i < 3; ++i) pk[i] = (at ? 0.0f : p.f[8 + i]) * pk[i] + p.f[11 + i] * pink_white;
    const float pink = (pk[0] + pk[1] + pk[2] + pink_white * p.f[14]) * p.f[15];
    const float noise_cut = DENORM(r.traj(11, n), 20.0, 10000.0);
    const float noise_res = DENORM(r.traj(12, n), 0.0, 5.0);
    const float g = tanf((3.14159265358979f * clampf(noise_cut, 20.0f, max_cut)) / sr);
    const float inv_q = 1.0f / clampf(noise_res, 0.5f, 10.0f);
    const float h = 1.0f / (1.0f + inv_q * g + g * g);
    float v1, v2;
    svf_step(ic1, ic2, pink, g, h, at, v1, v2);
    const float noise_filtered = fabsf(v2) < 1e-15f ? 0.0f : v2;
    const float noise_amt = r.traj(10, n);
    const float noise_out =
        noise_amt > 0.001f ? noise_filtered * osc_env * noise_amt * 0.5f : 0.0f;

    total[n] = sub_out + punch_out + click_out + noise_out;
    // master amplitude scale (kick.rs:1264-1284)
    const float amp_env =
        adsr(el, 0.001f, fmaxf(amp_decay_s, 0.001f), 0.0f, Sqrt{}, Pow{amp_curve});
    ampsc[n] = amp_env * sqrtf(vel) * r.traj(7, n);
  }

  r.advance(OUT_F(2) + v * 19, 19, qB);
  float* nlat = OUT_F(3) + v * 6;
  for (int i = 0; i < 6; ++i) nlat[i] = r.has ? news[i] : lat[i];
  OUT_I(4)[v] = r.new_trig();
  float* nfst = OUT_F(5) + v * 6;
  nfst[0] = click_y;
  nfst[1] = ic1;
  nfst[2] = ic2;
  for (int i = 0; i < 3; ++i) nfst[3 + i] = pk[i];
}

// --- snare A: tonal and crack layers, noise before the Chamberlin ----------------
//
// in:  cur, tgt [V,19], off, vel, trig, lat [V,6], bs, powq
// out: dry [V,B], nraw [V,B], ncur [V,19], nlat [V,6], ntrig [V]
// f:   1/sr, 2pi/sr, sr/2, q^B;  iv: seed mix, triangle terms (-1: a sine)

__device__ void snare_a(const VoicePhase& p, int v) {
  const int B = p.B;
  Row r;
  r.init(IN_F(0) + v * 19, IN_F(1) + v * 19, IN_F(7), IN_I(2)[v], IN_I(4)[v], *IN_I(6), B);
  const float* lat = IN_F(5) + v * 6;
  float* dry = OUT_F(0) + static_cast<size_t>(v) * B;
  float* nraw = OUT_F(1) + static_cast<size_t>(v) * B;
  const float inv_sr = p.f[0], w = p.f[1], nyq = p.f[2], qB = p.f[3];
  const uint32_t smix = static_cast<uint32_t>(p.iv[0]);
  const int n_terms = p.iv[1];

  // trigger snapshots (snare.rs:873-1027)
  const float vel_new = clamp01(IN_F(3)[v]);
  const float decay_scale_new = 1.0f - 0.45f * vel_new * vel_new;
  const float pitch_mult_new = 1.0f + r.vat(5) * 1.5f;
  const float tc = DENORM(r.vat(8), 0.1, 10.0);
  const float ad = DENORM(r.vat(16), 0.0, 4.0) * decay_scale_new;
  const float ac = DENORM(r.vat(17), 0.1, 10.0);
  const float pm_active_new = r.vat(14) > 0.001f ? 1.0f : 0.0f;
  const float news[6] = {vel_new, pitch_mult_new, ac, tc, ad, pm_active_new};

  for (int n = 0; n < B; ++n) {
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

    const float tonal_raw = n_terms >= 0 ? triangle(idx, base_freq * fmult, w, nyq, n_terms)
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

  r.advance(OUT_F(2) + v * 19, 19, qB);
  float* nlat = OUT_F(3) + v * 6;
  for (int i = 0; i < 6; ++i) nlat[i] = r.has ? news[i] : lat[i];
  OUT_I(4)[v] = r.new_trig();
}

// --- hihat2: the whole block (pallas_voice.py:1439-1549) ---------------------------
//
// in:  cur, tgt [V,6], off, vel, trig, lat [V,1], color [V] i32, slope [V] i32,
//      ph [V,3], hpf [V,8], svf [V,2], pink [V,3], salt [V] i32, bs, powq
// out: out [V,B], ncur [V,6], nlat [V,1], ntrig, nph [V,3], nhpf [V,8],
//      nsvf [V,2], npink [V,3]
// f:   1/sr, sr, q^B, 2pi, pi, 0.45 sr, down, 1-down, the attack curve's fp
//      and den, the decay curve's, poles[3], gains[3], direct, outg;  iv: seed mix

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

__device__ void hihat2(const VoicePhase& p, int v) {
  const int B = p.B;
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
  PhaseAcc mod_acc, main_acc;
  float rprev = 0.0f, mod_phase = 0.0f, main_phase = 0.0f;
  for (int n = 0; n < B; ++n) {
    const bool after = r.after(n), at = r.at(n);
    const float reset_f = at ? 1.0f : 0.0f;
    const float vel = after ? vel_new : lat0;
    const float el = static_cast<float>(r.elapsed_i(n)) * inv_sr;

    const float attack_s = DENORM(r.traj(2, n), 0.5, 200.0) * 0.001f;
    const float decay_s = DENORM(r.traj(1, n), 0.5, 4000.0) * 0.001f;
    const float pn = r.traj(0, n);
    const float pitch_hz = DENORM(pn * pn, 3500.0, 10000.0) * tuning_mult(r.traj(5, n));

    // noise (never reset; counter = global sample, salted per voice)
    const uint32_t n_glob = static_cast<uint32_t>(r.bs) + static_cast<uint32_t>(n);
    const float wn = white(n_glob + salt * 0x9E3779B9u, smix);
    const float pw = white(n_glob, smix);
    for (int i = 0; i < 3; ++i) pk[i] = p.f[12 + i] * pk[i] + p.f[15 + i] * pw;
    const float pinkn = (pk[0] + pk[1] + pk[2] + pw * p.f[18]) * p.f[19];
    const float noise_sig = color == 1 ? pinkn : wn;

    // phase-mod oscillator chain (hihat2.rs:256-285, 497-505)
    const float mod_inc = (pitch_hz * 0.1f) / sr;
    const float main_inc = pitch_hz / sr;
    if (n == 0) {
      mod_acc.init(mod_inc, ph[0]);
      main_acc.init(main_inc, ph[1]);
    }
    mod_phase = mod_acc.step(n, mod_inc, reset_f);
    main_phase = main_acc.step(n, main_inc, reset_f);
    const float mod_out = sinf(two_pi * rem1(mod_phase + noise_sig * 0.25f));
    const float main_out = sinf(two_pi * rem1(main_phase + mod_out * 0.75f));

    // highpass stages at pitch (RBJ, q = 1)
    const float omega = (two_pi * pitch_hz) / sr;
    const float sin_o = sinf(omega), cos_o = cosf(omega);
    const float alpha = sin_o / 2.0f;
    const float a0 = 1.0f + alpha;
    const float hb0 = ((1.0f + cos_o) / 2.0f) / a0;
    const float hb1 = -(1.0f + cos_o) / a0;
    const float ha1 = (-2.0f * cos_o) / a0;
    const float ha2 = (1.0f - alpha) / a0;
    const float keep = 1.0f - reset_f;
    const float y1 = q1.step(main_out, hb0, hb1, hb0, ha1, ha2, keep, rprev);
    const float y2 = q2.step(y1, hb0, hb1, hb0, ha1, ha2, keep, rprev);
    rprev = reset_f;
    const float filtered = slope == 1 ? y2 * 0.8f : y1;

    // MaxCurve envelope through the asymmetric smoother
    const float attack_prog = attack_s > 0.0f ? el / fmaxf(attack_s, 1e-9f) : 1.0f;
    const float decay_prog =
        decay_s > 0.0f ? (el - attack_s) / fmaxf(decay_s, 1e-9f) : 1.0f;
    float env_raw = el < attack_s ? max_curve(attack_prog, fa, da, true)
                                  : 1.0f - max_curve(clamp01(decay_prog), fd, dd, true);
    env_raw = el < 0.0f ? 0.0f : env_raw;
    env = fmaxf(env_raw, (at ? 0.0f : one_m_down) * env + down * env_raw);
    const float output = filtered * env * vel * 0.35f;

    // tone SVF highpass + volume
    const float tone_hz = DENORM(r.traj(3, n), 500.0, 10000.0);
    const float g = tanf((pi * clampf(tone_hz, 20.0f, max_cut)) / sr);
    const float h = 1.0f / (1.0f + 2.0f * g + g * g);
    float v1, v2;
    svf_step(ic1, ic2, output, g, h, at, v1, v2);
    out[n] = (output - (2.0f * v1 + v2)) * r.traj(4, n);
  }

  r.advance(OUT_F(1) + v * 6, 6, qB);
  OUT_F(2)[v] = r.has ? vel_new : lat0;
  OUT_I(3)[v] = r.new_trig();
  float* nph = OUT_F(4) + v * 3;
  nph[0] = mod_phase;
  nph[1] = main_phase;
  nph[2] = env;
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
  for (int i = 0; i < 3; ++i) OUT_F(7)[v * 3 + i] = pk[i];
}

// --- bass: oscillators, bleps, 4x drive, the filter's trajectories ---------------
//
// in:  cur, tgt [V,16], off, vel, nf [V], trig, lat [V,6], ph [V,3],
//      packed [52,V], bs, powq
// out: satur, cut, res, ampsc [V,B], ncur [V,16], nlat [V,6], ntrig,
//      nph [V,3], nst [100,V]
// f:   1/sr, sr, q^B, 2pi, tanh(0.5), 18000/20

__device__ __forceinline__ float poly_blep(float t, float dt) {
  dt = fmaxf(dt, 1e-12f);
  const float early = t / dt;
  const float late = (t - 1.0f) / dt;
  return t < dt ? 2.0f * early - early * early - 1.0f
                : (t > 1.0f - dt ? late * late + 2.0f * late + 1.0f : 0.0f);
}

__device__ void bass(const VoicePhase& p, const FbwsCoefs& k, int v) {
  const int B = p.B, V = p.V;
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
  const float news[6] = {vel_new, freq_new, ad_new, ac_new, fd_new, fc_new};

  PhaseAcc sub_acc, osc_acc, det_acc;
  float sub_phase = 0.0f, osc_phase = 0.0f, det_phase = 0.0f;
  float mix = 0.0f, od = 0.0f, drive = 0.0f;
  FbwsState s;
  load_state(s, IN_F(8), v, V);
  ovs4_row(
      s, k, B,
      // the oscillators (phase accumulators reset at the trigger) and their mix
      [&](int n) {
        const bool after = r.after(n);
        const float reset_f = r.at(n) ? 1.0f : 0.0f;
        const float freq = (after ? freq_new : lat[1]) * tuning_mult(r.traj(15, n));
        const float detune_cents = DENORM(r.traj(4, n), 0.0, 30.0);
        const float det_freq = freq * exp2f(detune_cents / 1200.0f);
        const float inc = freq / sr;
        const float det_inc = det_freq / sr;
        if (n == 0) {
          sub_acc.init(inc, ph[0]);
          osc_acc.init(inc, ph[1]);
          det_acc.init(det_inc, ph[2]);
        }
        sub_phase = sub_acc.step(n, inc, reset_f);
        osc_phase = osc_acc.step(n, inc, reset_f);
        det_phase = det_acc.step(n, det_inc, reset_f);
        const float sub_out = sinf(sub_phase * two_pi);
        const float shape = r.traj(5, n);
        const float saw_m = (2.0f * osc_phase - 1.0f) - poly_blep(osc_phase, inc);
        const float sq_m = (osc_phase < 0.5f ? 1.0f : -1.0f) + poly_blep(osc_phase, inc) -
                           poly_blep(rem1(osc_phase + 0.5f), inc);
        const float saw_d = (2.0f * det_phase - 1.0f) - poly_blep(det_phase, det_inc);
        const float sq_d = (det_phase < 0.5f ? 1.0f : -1.0f) + poly_blep(det_phase, det_inc) -
                           poly_blep(rem1(det_phase + 0.5f), det_inc);
        const float osc_out = saw_m * (1.0f - shape) + sq_m * shape;
        const float det_out = saw_d * (1.0f - shape) + sq_d * shape;
        mix = sub_out * r.traj(1, n) + osc_out * r.traj(2, n) + det_out * r.traj(3, n);
        return mix;
      },
      // the pre-filter waveshaper at drive 1 + 9*overdrive
      [&](int n) {
        od = r.traj(13, n);
        drive = 1.0f + od * 9.0f;
        const float d = fmaxf(drive, 1.000001f);
        return DriveShaper{d, tanh_half / tanhf(0.5f * d)};
      },
      [&](int n, float sat) {
        const bool after = r.after(n);
        float ws_out = drive <= 1.0f ? mix : sat;
        ws_out = isfinite(mix) ? ws_out : 0.0f;
        satur[n] = od > 0.001f ? ws_out : mix;
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
      },
      OUT_F(8), v, V);

  r.advance(OUT_F(4) + v * 16, 16, qB);
  float* nlat = OUT_F(5) + v * 6;
  for (int i = 0; i < 6; ++i) nlat[i] = r.has ? news[i] : lat[i];
  OUT_I(6)[v] = r.new_trig();
  float* nph = OUT_F(7) + v * 3;
  nph[0] = sub_phase;
  nph[1] = osc_phase;
  nph[2] = det_phase;
}

// --- tom2: the sources (pallas_voice.py:1646-1810) ----------------------------------
//
// in:  par [V,9], off, trig, dec [V], ph [V,6], seg [V] i32, bs
// out: mixed, env, done, fade, freq [V,B], ntrig [V] i32, ndec [V], nph [V,6],
//      nseg [V] i32
// f:   1/sr, sr, 2pi, 190/sr, the attack curve's fp and den, the decay's;
// iv:  seed mix, rand~ seed mix, triangle on, B

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

__device__ void tom2(const VoicePhase& p, int v) {
  const int B = p.iv[3];
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

  PhaseAcc tri_acc, main_acc, tri2_acc, fixed_acc, gated_acc;
  float tri_phase = 0.0f, m_main = 0.0f, m_tri = 0.0f, m_fixed = 0.0f, m_gated = 0.0f;
  float resid_r = 0.0f, base_r = -ph[5], pprev_r = 0.0f, frac = 0.0f;
  int seg = seg0;
  for (int n = 0; n < B; ++n) {
    const bool after = has && n >= off;
    const float reset_f = (has && n == off) ? 1.0f : 0.0f;
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
    const float fade = (past_attack && (raw_freq < 40.0f)) ? (raw_freq - 20.0f) / 20.0f : 1.0f;
    const float freq = fmaxf(raw_freq, 40.0f);

    // ClickOsc, the standalone triangle and MorphOsc
    const float click_out = ((ei >= 0 && ei < 64) ? kTomImpulse[ei] : 0.0f) * 1.1f;
    const float inc = freq / sr;
    if (n == 0) {
      tri_acc.init(inc, ph[0]);
      main_acc.init(inc, ph[1]);
      tri2_acc.init(inc, ph[2]);
      fixed_acc.init(fixed, ph[3]);
      gated_acc.init(inc, ph[4]);
    }
    tri_phase = tri_acc.step(n, inc, reset_f);
    m_main = main_acc.step(n, inc, reset_f);
    m_tri = tri2_acc.step(n, inc, reset_f);
    m_fixed = fixed_acc.step(n, fixed, reset_f);
    m_gated = gated_acc.step(n, inc, reset_f);
    const float tri_out = triangle_on ? tri_wave(rem1(tri_phase - inc)) * 0.5f : 0.0f;
    const float main_sine = sinf(two_pi * rem1(m_main - inc)) * 0.5f;
    const float tri_m = tri_wave(rem1(m_tri - inc)) * 0.5f;
    const float fixed_sine = sinf(two_pi * rem1(m_fixed - fixed)) * 0.5f;
    const float gated_sine = tone < 99.0f ? sinf(two_pi * rem1(m_gated - inc)) * 0.2f : 0.0f;
    const float wn = white(static_cast<uint32_t>(ei), smix) * 0.2f;

    // rand~: S&H with linear ramps on the split-increment accumulator
    const float n1 = static_cast<float>(n + 1);
    resid_r = 1.0f * resid_r + (inc_r - inc_r);
    const float p_r = (hi_r * n1 + lo_r * n1) + resid_r;
    base_r = (1.0f - reset_f) * base_r + reset_f * pprev_r;
    pprev_r = p_r;
    const float total = p_r - base_r;
    const float seg_local = floorf(total);
    frac = total - seg_local;
    seg = (after ? 0 : seg0) + static_cast<int>(seg_local);
    const float tgt_r = seg >= 1 ? white(static_cast<uint32_t>(seg), rmix) : 0.0f;
    const float cur_r = seg >= 2 ? white(static_cast<uint32_t>(seg) - 1u, rmix) : 0.0f;
    const float rand_value = cur_r + (tgt_r - cur_r) * frac;

    const float noise_combined = (wn + rand_value) * 0.4f;
    const float ch1 = main_sine * fixed_sine;
    const float ch2 = tri_m + noise_combined;
    const float ch3 = noise_combined + gated_sine;
    OUT_F(0)[row + n] = click_out + tri_out + (ch1 * w1 + ch2 * w2 + ch3 * w3);
    OUT_F(1)[row + n] = env;
    OUT_F(2)[row + n] = main_done ? 1.0f : 0.0f;
    OUT_F(3)[row + n] = fade;
    OUT_F(4)[row + n] = freq;
  }

  OUT_I(5)[v] = has ? static_cast<int>(static_cast<uint32_t>(bs) + static_cast<uint32_t>(off))
                    : trig;
  OUT_F(6)[v] = has ? decay_new : dec;
  float* nph = OUT_F(7) + v * 6;
  nph[0] = rem1(tri_phase);
  nph[1] = m_main;
  nph[2] = m_tri;
  nph[3] = m_fixed;
  nph[4] = m_gated;
  nph[5] = frac;
  OUT_I(8)[v] = seg;
}

// --- kick B: 4x tanh drive, makeup gain, DC blocker, amp (pallas_voice.py:599) ----
//
// in:  total, comp_signed, ampsc [V,B], cur, tgt [V,19], packed [52,V],
//      filt0 [V], powq
// out: out [V,B], nst [100,V], nfilt [V]
// f:   sr, -2pi

__device__ void kick_b(const VoicePhase& p, const FbwsCoefs& k, int v) {
  const int B = p.B, V = p.V;
  const size_t row = static_cast<size_t>(v) * B;
  const float* x = IN_F(0) + row;
  const float* cs = IN_F(1) + row;
  const float* amp = IN_F(2) + row;
  const float* cur = IN_F(3) + v * 19;
  const float* tgt = IN_F(4) + v * 19;
  const float* powq = IN_F(7);
  float* out = OUT_F(0) + row;
  const float sr = p.f[0], m2pi = p.f[1];
  auto traj = [&](int i, int n) { return snap(tgt[i], (cur[i] - tgt[i]) * powq[n + 1]); };

  float filt = IN_F(6)[v];
  FbwsState s;
  load_state(s, IN_F(5), v, V);
  ovs4_row(
      s, k, B,
      [&](int n) {
        const float od = traj(13, n);
        const float drive = 1.0f + od * od * od * 40.0f;
        return drive * x[n];
      },
      [](int) { return TanhShaper{}; },
      [&](int n, float y) {
        const float c = cs[n];
        const bool byp = c < 0.0f;
        const float dc = gated_dc(s, y, c);
        // feedback-filter bookkeeping (the loop gain is 0 on this path)
        const float fbc_hz = 200.0f + traj(15, n) * 3800.0f;
        const float fbc = clampf(1.0f - expf((m2pi * fbc_hz) / sr), 0.0f, 0.9f);
        filt = (byp ? 1.0f : 1.0f - fbc) * filt + (byp ? 0.0f : fbc * dc);
        out[n] = (byp ? x[n] : dc) * amp[n];
      },
      OUT_F(1), v, V);
  OUT_F(2)[v] = fabsf(filt) < 1e-15f ? 0.0f : filt;
}

// --- snare B: noise envelopes, 4x waveshaper, amp (pallas_voice.py:960) ------------
//
// in:  cur, tgt [V,19], off, vel, trig, lat [V,6], dry [V,B], filt [V,B],
//      packed [52,V], bs, powq
// out: out [V,B], nst [100,V]
// f:   1/sr, tanh(0.5)

__device__ void snare_b(const VoicePhase& p, const FbwsCoefs& k, int v) {
  const int B = p.B, V = p.V;
  Row r;
  r.init(IN_F(0) + v * 19, IN_F(1) + v * 19, IN_F(10), IN_I(2)[v], IN_I(4)[v], *IN_I(9), B);
  const float* lat = IN_F(5) + v * 6;
  const size_t row = static_cast<size_t>(v) * B;
  const float* dry = IN_F(6) + row;
  const float* filt = IN_F(7) + row;
  float* out = OUT_F(0) + row;
  const float inv_sr = p.f[0], tanh_half = p.f[1];

  const float vel_new = clamp01(IN_F(3)[v]);
  const float ad = DENORM(r.vat(16), 0.0, 4.0) * (1.0f - 0.45f * vel_new * vel_new);
  const float ac = DENORM(r.vat(17), 0.1, 10.0);
  float total = 0.0f, drive = 0.0f, vel = 0.0f, el = 0.0f, amp_decay_s = 0.0f, amp_curve = 0.0f;
  FbwsState s;
  load_state(s, IN_F(8), v, V);
  ovs4_row(
      s, k, B,
      [&](int n) {
        const bool after = r.after(n);
        vel = after ? vel_new : lat[0];
        amp_decay_s = after ? ad : lat[4];
        amp_curve = after ? ac : lat[2];
        el = static_cast<float>(r.elapsed_i(n)) * inv_sr;
        const float decay_scale = 1.0f - 0.45f * vel * vel;
        const float noise_env = adsr(el, 0.001f, DENORM(r.traj(9, n), 0.0, 3.5) * decay_scale,
                                     0.0f, Lin{}, Lin{});
        const float tail_env = adsr(el, 0.001f, DENORM(r.traj(10, n), 0.0, 3.5) * decay_scale,
                                    0.0f, Lin{}, Lin{});
        const float xfade = r.traj(13, n);
        total = dry[n] + filt[n] * (noise_env * 0.7f + tail_env * 0.3f) * xfade;
        return total;
      },
      [&](int n) {
        drive = 1.0f + r.traj(15, n) * 9.0f;
        const float d = fmaxf(drive, 1.000001f);
        return DriveShaper{d, tanh_half / tanhf(0.5f * d)};
      },
      [&](int n, float sat) {
        const float wet = total * (1.0f - 1.0f) + sat * 1.0f;
        float shaped = drive <= 1.0f ? total : wet;
        shaped = isfinite(total) ? shaped : 0.0f;
        const float amp_env =
            adsr(el, 0.001f, fmaxf(amp_decay_s, 0.001f), 0.0f, Lin{}, Pow{amp_curve});
        out[n] = shaped * amp_env * sqrtf(vel) * r.traj(6, n);
      },
      OUT_F(1), v, V);
}

// --- the kernels ----------------------------------------------------------------------

__device__ __forceinline__ const VoicePhase& phase_of(const Kit& kit, int& v) {
  int i = 0;
  while (i + 1 < kit.n && static_cast<int>(blockIdx.x) >= kit.ph[i + 1].block0) ++i;
  v = (static_cast<int>(blockIdx.x) - kit.ph[i].block0) * kThreads + static_cast<int>(threadIdx.x);
  return kit.ph[i];
}

__global__ void __launch_bounds__(kThreads) kit_sources_kernel(const Kit kit, FbwsCoefs k) {
  int v;
  const VoicePhase& p = phase_of(kit, v);
  if (v >= p.V) return;
  switch (p.body) {
    case kKickA:
      kick_a(p, v);
      break;
    case kSnareA:
      snare_a(p, v);
      break;
    case kHihat2:
      hihat2(p, v);
      break;
    case kBass:
      bass(p, k, v);
      break;
    case kTom2:
      tom2(p, v);
      break;
    default:
      break;
  }
}

__global__ void __launch_bounds__(kThreads) kit_drive_kernel(const Kit kit, FbwsCoefs k) {
  int v;
  const VoicePhase& p = phase_of(kit, v);
  if (v >= p.V) return;
  switch (p.body) {
    case kKickB:
      kick_b(p, k, v);
      break;
    case kSnareB:
      snare_b(p, k, v);
      break;
    default:
      break;
  }
}

// ops: (body, V, B) per phase; ptrs: in[16], out[10] per phase; f: 24 and
// iv: 8 per phase.  Returns the grid's block count, or -1 for a bad table.
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
    blocks += (p.V + kThreads - 1) / kThreads;
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
  kit_sources_kernel<<<blocks, kThreads, 0, as_stream(stream)>>>(kit, fbws_coefs(coefs));
  return static_cast<int>(cudaGetLastError());
}

int kit_drive_launch(int n, const int* ops, void* const* ptrs, const float* f, const int* iv,
                     const float* coefs, void* stream) {
  Kit kit{};
  const int blocks = make_kit(kit, n, ops, ptrs, f, iv, kKickB, kSnareB);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  kit_drive_kernel<<<blocks, kThreads, 0, as_stream(stream)>>>(kit, fbws_coefs(coefs));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
