// Stereo bus-effect kernels for Hopper (sm_90a): the kit's global bus up to
// the plate, one kernel each, and a run of them in one launch.
//
//   saturation_block   <- libgooey_tpu/ops/pallas_fx.py:saturation_block (_sat4_kernel)
//   lowpass_block      <- libgooey_tpu/ops/pallas_fx.py:lowpass_block (_lowpass_kernel)
//   tilt_block         <- libgooey_tpu/ops/pallas_fx.py:tilt_block (_tilt_kernel)
//   delay_block        <- libgooey_tpu/ops/pallas_fx.py:delay_block (_delay_kernel)
//   env_follower_block <- libgooey_tpu/ops/pallas_fx.py:env_follower_block (_env_kernel)
//   compressor_block   <- libgooey_tpu/ops/pallas_fx.py:compressor_block (_comp_kernel)
//   spring_block       <- libgooey_tpu/ops/pallas_fx.py:spring_block (_spring_kernel)
//   waveshaper_block   <- libgooey_tpu/ops/pallas_fx.py:waveshaper_block (_ws4_kernel)
//   fbws_fast_block    <- libgooey_tpu/ops/pallas_fx.py:fbws_fast_block (_fbws_kernel)
//   bus_chain          <- libgooey_tpu/ops/pallas_chain.py:chain_fused
//
// Design: the bus is one stereo [2, B] signal, and every effect is a
// recurrence through the block's B samples.  So each kernel is one block
// of two threads, one per channel.  The carried state lives in registers,
// the smoothed parameter trajectories are computed in the loop (closed form
// with the settle snap, as the Pallas bodies do) or passed in as [2, B]
// rows where the JAX package computes them outside its kernel (the
// compressor, the spring), and each effect's block is a __device__ row
// function over one channel.  The channels meet only in the delay's
// ping-pong write (each channel's write takes the other channel's filtered
// tap at the same sample): the delay stages its filtered taps in shared
// memory and writes after a __syncthreads.
//
// The spring's twelve allpass delay lines (six a channel, lags 127-797 at
// 44.1 kHz) live in shared memory as rings of the history's length D, one
// per line (csrc/rings.cuh), 12 x D floats (38 KB at 44.1 kHz, independent
// of B): each
// sample reads every line at its lag and writes its new value into the slot
// it frees, the Schroeder allpass in place.  The carried state keeps the
// JAX package's right-aligned [12, D] history, unrolled from the rings at
// the end.  Rings rather than the Pallas body's [12, D+B] work buffer keep
// the launch inside the 48 KB of shared memory a block gets without an
// opt-in at any block size; above 48 KB (sample rates past ~100 kHz) the
// launch opts in to dynamic shared memory, and a refused launch returns its
// error.
//
// bus_chain runs a list of such phases in order, threading the signal
// through its output in place (every row function reads sample n before it
// writes it), as chain_fused threads it through one VMEM ref.  It calls the
// same row functions as the per-effect kernels, so a run gives bit for bit
// what the per-effect kernels give one after the other, with one launch in
// place of one per effect.  The compressor is two phases, as in chain_fused:
// the detector (env) passes the signal through and leaves its envelope in
// its output, which the next phase reads; each channel's envelope feeds
// only its own channel, so no barrier is needed between them; the feedback
// waveshaper is two phases the same way.  The glue
// around each effect (trajectories of the delay time and of the
// compressor's and spring's parameters, the ring gather and scatter, state
// packing, freezes) stays in PyTorch before and after the launch, as it
// stays in XLA around chain_fused.
//
// What bounds them on the card: a few KB to a few tens of KB move per call
// and a few hundred thousand operations are done, so the card's bound is a
// microsecond or less; the time is the serial B-step chain of one thread
// (the 4x allpass chains of the saturation and the compressor, with four
// atan evaluations per sample, the longest) and, for the spring, the copy
// of its 19 KB of history per channel into and out of the rings.  One SM
// of 132 is busy.
//
// Numerics: the Pallas bodies solve the linear recurrences (the tilt's SVF,
// the delay's two-pole, the DC blocker, the compressor's gain smoother, the
// spring's damping loop) with log-depth scans; these kernels and their
// plain versions (ops/bus_kernels.py) step them sample by sample in the same
// per-sample op order, so the two differ at float-noise level.  Built with
// -fmad=false, as bank_kernels.cu: a kernel and its plain version then
// differ only where expf/logf/tanf/tanhf differ from PyTorch's.
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError(); nothing allocates or synchronizes here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ovs4.cuh"
#include "rings.cuh"

namespace {

constexpr float kSettle = 1e-4f;   // smoother settle snap (smoother.rs:131)
constexpr float kDenormal = 1e-15f;

// Closed-form one-pole smoother trajectory at block sample n:
// tgt + snap((cur - tgt) * q^(n+1)), with q^(n+1) = exp(log(q) * (n+1)) as
// the Pallas bodies compute it (_traj, pallas_fx.py:365-373).
__device__ __forceinline__ float traj(float cur, float tgt, float logq, int n) {
  const float d = (cur - tgt) * expf(logq * static_cast<float>(n + 1));
  return tgt + (fabsf(d) < kSettle ? 0.0f : d);
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// One effect's block as the kernels take it (ops/bus_kernels.py _SLOTS):
//
//   op          in[...]                  out[0..1]       f[...]            iv[...]    flag
//   saturation  cur, tgt, packed state   state           logq
//   lowpass     g, fb, stages            stages
//   tilt        cur, tgt, ic             state           logq, lp_log,
//                                                        hp_log, max_cut,
//                                                        pi, 1/sr
//   delay       tap, cur, tgt, z         write, state    logq, -2pi/sr                ping-pong
//   env         att_c, rel_c, byp, env0  env, env_last
//   compressor  env, thr, ratio, mix,    state           20/ln10, -ln10/20,
//               packed state + gain                      2/pi*1.1
//   spring      A, p2, fbgp, hist, damp, hist', d_last   gains[6],          lags[12], D
//               mix, fb0                                 1-gains^2[6],
//                                                        prod(gains)
//   waveshaper  prm [2,2], packed state  state           tanh(0.5)
//   fbws        env, prm [2,4], packed   state           ln(10)*5.1/20
//               state + filter
enum Op : int {
  kSaturation = 0,
  kLowpass = 1,
  kTilt = 2,
  kDelay = 3,
  kEnv = 4,
  kCompressor = 5,
  kSpring = 6,
  kWaveshaper = 7,
  kFbws = 8,
};

constexpr int kPhaseIn = 8;
constexpr int kPhaseOut = 2;
constexpr int kPhaseF = 16;
constexpr int kPhaseI = 16;

struct Phase {
  int op;
  int flag;
  const float* in[kPhaseIn];
  float* out[kPhaseOut];
  float f[kPhaseF];
  int iv[kPhaseI];
};

// The product chain's run is ten phases (the compressor and the feedback
// waveshaper take two each); Chain travels by value, 2.6 KB of the 4 KB a
// kernel's parameters may hold.
constexpr int kMaxPhases = 12;

struct Chain {
  int n;
  Phase ph[kMaxPhases];
};

// --- 1. saturation: the tube saturation at 4x --------------------------------

// Branchless Cephes atanf (pallas_fx.py:350-362), the same polynomial as the
// plain version and the TPU kernel; ~1e-7 from libm.
__device__ __forceinline__ float atan_cephes(float x) {
  const float ax = fabsf(x);
  const bool big = ax > 2.414213562373095f;    // tan(3pi/8)
  const bool mid = ax > 0.41421356237309503f;  // tan(pi/8)
  const float z = big ? -1.0f / fmaxf(ax, 1e-30f) : (mid ? (ax - 1.0f) / (ax + 1.0f) : ax);
  const float zz = z * z;
  const float p =
      ((((8.05374449538e-2f * zz - 1.38776856032e-1f) * zz + 1.99777106478e-1f) * zz -
        3.33329491539e-1f) *
       zz) *
          z +
      z;
  const float y = big ? p + 1.5707963267948966f : (mid ? p + 0.7853981633974483f : p);
  return sign_of(x) * y;
}

// The tube curve (saturation.rs:106-125) with the engine sample's drive and
// bias held across its four subsamples.
struct SatShaper {
  float drive, bias;
  __device__ __forceinline__ float operator()(float v) const {
    const float driven = v * drive;
    const float biased = driven + bias * fabsf(driven);
    const float soft = atan_cephes(biased) * 0.6366197723675814f;  // 2/pi
    return soft + soft * soft * sign_of(soft) * 0.15f * bias;
  }
};

// Smoother rows (drive, warmth, mix) appended to the packed output state.
constexpr int kFbwsRowsOut = 100;

// Channel c of the saturation block (_sat4_kernel): smoothed drive, warmth
// and mix, the 4x chain around the tube curve, the bypass-gated DC blocker
// (_dc_block), the mix and the finite select.
__device__ void saturation_row(const Phase& p, const FbwsCoefs& k, int c, const float* x,
                               float* y, int B) {
  const float* cur = p.in[0];
  const float* tgt = p.in[1];
  float* st_out = p.out[0];
  const float logq = p.f[0];
  const size_t row = static_cast<size_t>(c) * B;
  const float cd = cur[3 * c + 0], cw = cur[3 * c + 1], cm = cur[3 * c + 2];
  const float td = tgt[3 * c + 0], tw = tgt[3 * c + 1], tm = tgt[3 * c + 2];

  FbwsState s;
  load_state(s, p.in[2], c, 2);
  ovs4_row(
      s, k, B, [&](int n) { return x[row + n]; },
      [&](int n) {
        return SatShaper{1.0f + traj(cd, td, logq, n) * 7.0f, traj(cw, tw, logq, n) * 0.4f};
      },
      [&](int n, float v) {
        const float mix = traj(cm, tm, logq, n);
        const bool byp = mix < 1e-4f;
        const float v1 = gated_dc(s, v, byp ? -1.0f : 1.0f);
        const float xn = x[row + n];
        const float o = byp ? xn : xn * (1.0f - mix) + v1 * mix;
        y[row + n] = isfinite(o) ? o : 0.0f;
      },
      st_out, c, 2);
  st_out[(kFbwsRowsOut + 0) * 2 + c] = traj(cd, td, logq, B - 1);
  st_out[(kFbwsRowsOut + 1) * 2 + c] = traj(cw, tw, logq, B - 1);
  st_out[(kFbwsRowsOut + 2) * 2 + c] = traj(cm, tm, logq, B - 1);
}

// --- 2. lowpass: Moog-style 2-pole LP with tanh'd resonance ------------------

// One sample of the nonlinear recurrence (lowpass_filter.rs); returns the
// raw stage-2 value, whose tanh is the effect's output.
__device__ __forceinline__ float lowpass_step(float& s1, float& s2, float xn, float gn,
                                              float fbn) {
  const float infb = xn - tanhf(s2 * fbn) * fminf(fbn, 1.0f);
  s1 = s1 + gn * (infb - s1);
  s2 = s2 + gn * (s1 - s2);
  if (fabsf(s1) < kDenormal) s1 = 0.0f;
  if (fabsf(s2) < kDenormal) s2 = 0.0f;
  if (s2 != s2) {  // a NaN resets the filter (the output tanh of +-inf is finite)
    s1 = 0.0f;
    s2 = 0.0f;
  }
  return s2;
}

__device__ void lowpass_row(const Phase& p, int c, const float* x, float* y, int B) {
  const float* g = p.in[0];
  const float* fb = p.in[1];
  const size_t row = static_cast<size_t>(c) * B;
  float s1 = p.in[2][2 * c], s2 = p.in[2][2 * c + 1];
  for (int n = 0; n < B; ++n) {
    const size_t i = row + n;
    y[i] = tanhf(lowpass_step(s1, s2, x[i], g[i], fb[i]));
  }
  p.out[0][2 * c] = s1;
  p.out[0][2 * c + 1] = s2;
}

// --- 3. tilt: one-knob LP<->HP sweep through a TPT SVF -----------------------

struct TiltConsts {
  float logq;      // log(1 - coeff), float32
  float lp_log;    // log(20000/80)
  float hp_log;    // log(8000/20)
  float max_cut;   // 0.45 sr
  float pi;
  float inv_sr;
};

// One sample of the tilt filter (tilt_filter.rs:99-125) at knob/res values
// ``knob``/``res``: the frequency maps, the SVF coefficients, the SVF step
// with its pre-update taps, and the crossfade.  Returns the output sample.
__device__ __forceinline__ float tilt_step(float& ic1, float& ic2, float xn, float knob,
                                           float res, const TiltConsts& t) {
  const float lp_mix = 1.0f - knob * 2.0f;
  const float lp_freq = 80.0f * expf(t.lp_log * (knob * 2.0f));
  const float hp_mix = (knob - 0.5f) * 2.0f;
  const float hp_freq = 20.0f * expf(t.hp_log * ((knob - 0.5f) * 2.0f));
  const bool use_lp = knob < 0.5f;
  const float mix = use_lp ? lp_mix : hp_mix;
  const float freq = use_lp ? lp_freq : hp_freq;
  const float q = 0.5f + res * 8.0f;
  const bool passthrough = mix < 0.001f;
  const float cutoff = fminf(fmaxf(freq, 20.0f), t.max_cut);
  const float g = tanf(t.pi * cutoff * t.inv_sr);
  const float r = 1.0f / fmaxf(q, 0.5f);
  const float h = 1.0f / (1.0f + r * g + g * g);
  const float v1 = (g * (xn - ic2) + ic1) * h;
  const float v2 = ic2 + g * v1;
  ic1 = 2.0f * v1 - ic1;
  ic2 = 2.0f * v2 - ic2;
  const float wet = use_lp ? v2 : xn - (r * v1 + v2);
  float o = passthrough ? xn : xn * (1.0f - mix) + wet * mix;
  o = isfinite(o) ? o : 0.0f;
  return fabsf(o) < kDenormal ? 0.0f : o;
}

__device__ void tilt_row(const Phase& p, int c, const float* x, float* y, int B) {
  const TiltConsts t{p.f[0], p.f[1], p.f[2], p.f[3], p.f[4], p.f[5]};
  const float* cur = p.in[0];
  const float* tgt = p.in[1];
  float* st_out = p.out[0];
  const size_t row = static_cast<size_t>(c) * B;
  const float ck = cur[2 * c], cr = cur[2 * c + 1];
  const float tk = tgt[2 * c], tr = tgt[2 * c + 1];
  float ic1 = p.in[2][2 * c], ic2 = p.in[2][2 * c + 1];
  for (int n = 0; n < B; ++n) {
    y[row + n] = tilt_step(ic1, ic2, x[row + n], traj(ck, tk, t.logq, n),
                           traj(cr, tr, t.logq, n), t);
  }
  st_out[4 * c + 0] = ic1;
  st_out[4 * c + 1] = ic2;
  st_out[4 * c + 2] = traj(ck, tk, t.logq, B - 1);
  st_out[4 * c + 3] = traj(cr, tr, t.logq, B - 1);
}

// --- 4. delay: the delay's post-read filter, feedback write and mix ----------

constexpr float kDelayRes = 0.3f;  // FILTER_RESONANCE (delay.rs)

// One sample of the darkening two-pole low-pass on the gathered tap
// (delay.rs:370-384), in the affine form the Pallas body scans:
// z' = A z + b with the old state on both rows.  Returns the filtered tap.
__device__ __forceinline__ float delay_filter_step(float& z1, float& z2, float tap,
                                                   float cut, float gk) {
  const float g = 1.0f - expf(gk * cut);
  const float a11 = 1.0f - g + g * kDelayRes;
  const float a12 = -g * kDelayRes;
  const float b1 = g * tap;
  const float a21 = g * a11;
  const float a22 = (1.0f - g) + g * a12;
  const float b2 = g * b1;
  const float n1 = a11 * z1 + a12 * z2 + b1;
  const float n2 = a21 * z1 + a22 * z2 + b2;
  z1 = n1;
  z2 = n2;
  return n2;
}

// The ring write: inject + tap*feedback, zeroed if not finite or denormal.
__device__ __forceinline__ float delay_write(float inject, float tap, float fb) {
  const float w = inject + tap * fb;
  return (isfinite(w) && fabsf(w) > kDenormal) ? w : 0.0f;
}

// Channel c of the delay block.  ``stage`` ([2, B] shared) holds both
// channels' filtered taps, so called by both threads of the block.
__device__ void delay_row(const Phase& p, int c, const float* x, float* y, float* stage,
                          int B) {
  const float* tap = p.in[0];
  const float* cur = p.in[1];
  const float* tgt = p.in[2];
  float* write = p.out[0];
  float* st_out = p.out[1];
  const float logq = p.f[0], gk = p.f[1];
  const bool pingpong = p.flag != 0;
  const size_t row = static_cast<size_t>(c) * B;
  const float cf = cur[3 * c + 0], cm = cur[3 * c + 1], cc = cur[3 * c + 2];
  const float tf = tgt[3 * c + 0], tm = tgt[3 * c + 1], tc = tgt[3 * c + 2];
  float z1 = p.in[3][2 * c], z2 = p.in[3][2 * c + 1];
  __syncthreads();  // the stage is free (a chain may hold an earlier delay)
  for (int n = 0; n < B; ++n) {
    const float mix = traj(cm, tm, logq, n);
    const float filt = delay_filter_step(z1, z2, tap[row + n], traj(cc, tc, logq, n), gk);
    const float xn = x[row + n];
    stage[row + n] = filt;
    // the injection; with ping-pong the dry signal feeds the left channel
    // only (delay.rs:460-491)
    write[row + n] = (pingpong && c == 1) ? 0.0f : xn;
    const float o = xn * (1.0f - mix) + filt * mix;
    y[row + n] = isfinite(o) ? o : xn;
  }
  __syncthreads();
  // with ping-pong each channel's write takes the other channel's filtered
  // tap at the same sample
  const size_t tap_row = static_cast<size_t>(pingpong ? 1 - c : c) * B;
  for (int n = 0; n < B; ++n) {
    write[row + n] = delay_write(write[row + n], stage[tap_row + n], traj(cf, tf, logq, n));
  }
  st_out[5 * c + 0] = z1;
  st_out[5 * c + 1] = z2;
  st_out[5 * c + 2] = traj(cf, tf, logq, B - 1);
  st_out[5 * c + 3] = traj(cm, tm, logq, B - 1);
  st_out[5 * c + 4] = traj(cc, tc, logq, B - 1);
}

// --- 5. env: the compressor's attack/release peak detector --------------------

// Channel c of the detector (_env_kernel): e = c*env + (1-c)*|x| with
// c = att if |x| > env else rel, flushed below 1e-15; a bypassed sample
// (byp > 0.5) takes c = 1, which holds the envelope exactly (the Pallas
// wrapper folds the bypass into the coefficients the same way).  The signal
// passes through (y = x); the envelope goes to out[0].  The bank follower
// (bank_kernels.cu env_follow_bank) steps env + (1-c)*(r - env), its own TPU
// kernel's op order, so the two steps round differently and are not shared.
__device__ void env_row(const Phase& p, int c, const float* x, float* y, int B) {
  const float* att = p.in[0];
  const float* rel = p.in[1];
  const float* byp = p.in[2];
  float* env_out = p.out[0];
  const size_t row = static_cast<size_t>(c) * B;
  float env = p.in[3][c];
  for (int n = 0; n < B; ++n) {
    const size_t i = row + n;
    const float xn = x[i];
    const float r = fabsf(xn);
    const bool frozen = byp[i] > 0.5f;
    const float cf = frozen ? 1.0f : (r > env ? att[i] : rel[i]);
    const float e = cf * env + (1.0f - cf) * r;
    env = e < kDenormal ? 0.0f : e;
    env_out[i] = env;
    y[i] = xn;
  }
  p.out[1][c] = env;
}

// --- 6. compressor: knee gain, gain smoother, 4x tube colour, DC, mix -------

// The tube colour (compressor.rs:185-199): atan(v) * (2/pi * 1.1), the
// Cephes polynomial of the saturation.
struct AtanShaper {
  float k;
  __device__ __forceinline__ float operator()(float v) const { return atan_cephes(v) * k; }
};

// Rows of the compressor's packed state: the 52 input rows of the 4x chain
// and DC blocker, then the smoothed gain; the 100 output rows, then the gain.
constexpr int kFbwsRowsIn = 52;

// Channel c of the compressor block (_comp_kernel) on the detector's
// envelope: the knee's gain reduction, the one-pole gain smoother (frozen on
// bypass), x*g through the 4x chain with the atan tube colour (engaged when
// g < 0.99, always fed so its history stays warm), the bypass-gated DC
// blocker, the mix and the finite select.
__device__ void compressor_row(const Phase& p, const FbwsCoefs& k, int c, const float* x,
                               float* y, int B) {
  const float* env = p.in[0];
  const float* thr = p.in[1];
  const float* ratio = p.in[2];
  const float* mix = p.in[3];
  const float* packed = p.in[4];
  float* st_out = p.out[0];
  const float db_per_ln = p.f[0];    // 20 / ln 10
  const float ln_per_db = p.f[1];    // -ln 10 / 20
  const AtanShaper shape{p.f[2]};
  const size_t row = static_cast<size_t>(c) * B;

  FbwsState s;
  load_state(s, packed, c, 2);
  float g = packed[kFbwsRowsIn * 2 + c];
  float compressed = 0.0f;
  bool byp = false;
  ovs4_row(
      s, k, B,
      // called once per sample, before that sample's finish: steps the gain
      [&](int n) {
        const size_t i = row + n;
        byp = mix[i] < 1e-4f;
        const float env_db = db_per_ln * logf(env[i] + 1e-20f);
        const float over = env_db - thr[i];
        const float slope = 1.0f - 1.0f / ratio[i];
        const float kv = over + 3.0f;
        const float knee = kv * kv / 12.0f * slope;
        const float gr = over <= -3.0f ? 0.0f : (over >= 3.0f ? over * slope : knee);
        const float gain_lin = expf(ln_per_db * gr);
        g = byp ? g : 0.95f * g + 0.05f * gain_lin;
        compressed = x[i] * g;
        return compressed;
      },
      [&](int) { return shape; },
      [&](int n, float v) {
        const size_t i = row + n;
        const float colored = g < 0.99f ? v : compressed;
        const float y1 = gated_dc(s, colored, byp ? -1.0f : 1.0f);
        const float xn = x[i];
        const float m = mix[i];
        const float o = byp ? xn : xn * (1.0f - m) + y1 * m;
        y[i] = isfinite(o) ? o : 0.0f;
      },
      st_out, c, 2);
  st_out[kFbwsRowsOut * 2 + c] = g;
}

// --- 7. spring: six allpasses a channel in a damped feedback loop ------------

constexpr int kSpringAps = 6;

__host__ __device__ __forceinline__ size_t spring_ring_bytes(int D) {
  return 2 * kSpringAps * static_cast<size_t>(D) * sizeof(float);
}

// Channel c of the spring block (_spring_kernel, stepped sample by sample):
// the six delayed reads, beta = their allpass chain's affine offset, the
// damping recurrence d = A*d + p2*(alpha*xeff + beta), the chain input
// xeff + fbgp*d_prev, the six allpass writes, and the dry/wet mix of
// reverb_spring.py.  xeff is x with the carried feedback fb0 added at n = 0.
// Every lag is at least 127 samples, the chunk the Pallas body runs, so its
// chunked reads see the same values.  ``rings``: 2 x 6 x D shared floats.
__device__ void spring_row(const Phase& p, int c, const float* x, float* y, float* rings,
                           int B) {
  const float* A = p.in[0];
  const float* p2 = p.in[1];
  const float* fbgp = p.in[2];
  const float* mix = p.in[5];
  float* hist_out = p.out[0];
  const int D = p.iv[2 * kSpringAps];
  const float alpha = p.f[2 * kSpringAps];
  const size_t row = static_cast<size_t>(c) * B;
  const size_t span = static_cast<size_t>(kSpringAps) * D;
  float* ring = rings + c * span;
  const float* hist = p.in[3] + c * span;
  float g[kSpringAps], omg[kSpringAps];
  int lag[kSpringAps];
#pragma unroll
  for (int j = 0; j < kSpringAps; ++j) {
    g[j] = p.f[j];
    omg[j] = p.f[kSpringAps + j];
    lag[j] = p.iv[c * kSpringAps + j];
  }
  __syncthreads();  // the shared memory is free (a chain may hold an earlier phase's)
  // unrolled so that many independent loads are in flight at once
#pragma unroll 16
  for (size_t k = 0; k < span; ++k) ring[k] = hist[k];
  int w = 0;  // every ring's write slot
  float d = p.in[4][c];
  for (int n = 0; n < B; ++n) {
    const size_t i = row + n;
    float rd[kSpringAps];
#pragma unroll
    for (int j = 0; j < kSpringAps; ++j) rd[j] = ring[j * D + ring_slot(w, lag[j], D)];
    float beta = 0.0f;
#pragma unroll
    for (int j = 0; j < kSpringAps; ++j) beta = g[j] * beta + omg[j] * rd[j];
    const float xn = x[i];
    const float xe = n == 0 ? xn + p.in[6][c] : xn;
    const float bv = p2[i] * (alpha * xe + beta);
    const float d_prev = d;
    d = A[i] * d + bv;
    float sig = xe + fbgp[i] * d_prev;
#pragma unroll
    for (int j = 0; j < kSpringAps; ++j) {
      const float v = sig - g[j] * rd[j];
      ring[j * D + w] = v;
      sig = g[j] * v + rd[j];
    }
    const float m = mix[i];
    y[i] = xn * (1.0f - m) + sig * m;
    w = ring_next(w, D);
  }
  for (int j = 0; j < kSpringAps; ++j) {
    unroll_ring(ring + j * D, w, D, hist_out + c * span + static_cast<size_t>(j) * D);
  }
  p.out[1][c] = d;
}

// --- 8. waveshaper: tanh(v*d)*comp at 4x, wet/dry, bypass select ------------

// Channel c of the waveshaper block (_ws4_kernel): block-scalar drive and mix
// per channel (the chain's staged targets), the 4x chain around
// tanh(v*d)*tanh(0.5)/tanh(0.5d), the mix, the bypass select and the finite
// guard.  The packed DC rows pass through.
__device__ void waveshaper_row(const Phase& p, const FbwsCoefs& k, int c, const float* x,
                               float* y, int B) {
  const float drive = p.in[0][2 * c], mix = p.in[0][2 * c + 1];
  const float d = fmaxf(drive, 1.000001f);
  const DriveShaper shape{d, p.f[0] / tanhf(0.5f * d)};
  const bool bypass = mix <= 1e-4f || drive <= 1.0f;
  const size_t row = static_cast<size_t>(c) * B;
  FbwsState s;
  load_state(s, p.in[1], c, 2);
  ovs4_row(
      s, k, B, [&](int n) { return x[row + n]; }, [&](int) { return shape; },
      [&](int n, float v) {
        const float xn = x[row + n];
        const float o = bypass ? xn : xn * (1.0f - mix) + v * mix;
        y[row + n] = isfinite(xn) ? o : 0.0f;
      },
      p.out[0], c, 2);
}

// --- 9. fbws: the feedback waveshaper's zero-feedback path at 4x ---------------

// Envelope-referenced makeup gain (feedback_waveshaper.rs:247-259) in the
// TPU kernel's exp/log form; makeup_ln = ln(10) * 5.1 / 20.
__device__ __forceinline__ float fbws_gain(float env, float drive, float feedback,
                                           float makeup_ln) {
  const float reference = fmaxf(env, 0.05f);
  const float driven_ref = fmaxf(fabsf(tanhf(reference * drive)), 1e-6f);
  const float comp_no_fb = tanhf(reference) / driven_ref;
  const float drive_norm = fminf(fmaxf((drive - 1.0f) / 99.0f, 0.0f), 1.0f);
  const float feedback_norm = fminf(fmaxf(feedback / 0.98f, 0.0f), 1.0f);
  float high_end = expf(1.35f * logf(fmaxf(drive_norm, 1e-30f))) * (feedback_norm * feedback_norm);
  high_end = drive_norm <= 0.0f ? 0.0f : high_end;
  const float makeup = expf(makeup_ln * high_end);
  const float taming = 1.0f / (1.0f + comp_no_fb * feedback * 0.25f);
  return fminf(comp_no_fb * taming * makeup, 3.0f);
}

// Channel c of the zero-feedback block (_fbws_kernel) on the detector's
// envelope: drive*x through the 4x tanh chain, the makeup gain, the
// bypass-gated DC blocker, the feedback filter's bookkeeping (its state
// rides the packed state's last row, as the compressor's gain does) and the
// mix.  drive, feedback, the filter coefficient and mix are block scalars.
__device__ void fbws_row(const Phase& p, const FbwsCoefs& k, int c, const float* x, float* y,
                         int B) {
  const float* env = p.in[0];
  const float* prm = p.in[1] + 4 * c;
  const float* packed = p.in[2];
  const float drive = prm[0], feedback = prm[1], fbc = prm[2], mix = prm[3];
  const bool bypass = mix <= 1e-4f || drive <= 1.0f;
  const float a1 = bypass ? 1.0f : 0.0f;
  const size_t row = static_cast<size_t>(c) * B;
  FbwsState s;
  load_state(s, packed, c, 2);
  float filt = packed[kFbwsRowsIn * 2 + c];
  ovs4_row(
      s, k, B, [&](int n) { return x[row + n] * drive; }, [](int) { return TanhShaper{}; },
      [&](int n, float v) {
        const float comp = fbws_gain(env[row + n], drive, feedback, p.f[0]);
        const float dc = gated_dc(s, v, bypass ? -1.0f : comp);
        filt = (bypass ? 1.0f : 1.0f - fbc) * filt + (1.0f - a1) * fbc * dc;
        const float xn = x[row + n];
        y[row + n] = bypass ? xn : xn * (1.0f - mix) + dc * mix;
      },
      p.out[0], c, 2);
  p.out[0][kFbwsRowsOut * 2 + c] = fabsf(filt) < kDenormal ? 0.0f : filt;
}

// --- the kernels -----------------------------------------------------------------

__device__ __forceinline__ void run_phase(const Phase& p, const FbwsCoefs& k, int c,
                                          const float* x, float* y, float* smem, int B) {
  switch (p.op) {
    case kSaturation:
      saturation_row(p, k, c, x, y, B);
      break;
    case kLowpass:
      lowpass_row(p, c, x, y, B);
      break;
    case kTilt:
      tilt_row(p, c, x, y, B);
      break;
    case kDelay:
      delay_row(p, c, x, y, smem, B);
      break;
    case kEnv:
      env_row(p, c, x, y, B);
      break;
    case kCompressor:
      compressor_row(p, k, c, x, y, B);
      break;
    case kSpring:
      spring_row(p, c, x, y, smem, B);
      break;
    case kWaveshaper:
      waveshaper_row(p, k, c, x, y, B);
      break;
    case kFbws:
      fbws_row(p, k, c, x, y, B);
      break;
  }
}

// One thread per channel; blockDim.x is 2 in every launch below.
__global__ void saturation_block_kernel(const float* x, float* y, Phase p, FbwsCoefs k,
                                        int B) {
  saturation_row(p, k, threadIdx.x, x, y, B);
}

__global__ void lowpass_block_kernel(const float* x, float* y, Phase p, int B) {
  lowpass_row(p, threadIdx.x, x, y, B);
}

__global__ void tilt_block_kernel(const float* x, float* y, Phase p, int B) {
  tilt_row(p, threadIdx.x, x, y, B);
}

__global__ void delay_block_kernel(const float* x, float* y, Phase p, int B) {
  extern __shared__ float stage[];
  delay_row(p, threadIdx.x, x, y, stage, B);
}

__global__ void env_follower_block_kernel(const float* x, float* y, Phase p, int B) {
  env_row(p, threadIdx.x, x, y, B);
}

__global__ void compressor_block_kernel(const float* x, float* y, Phase p, FbwsCoefs k,
                                        int B) {
  compressor_row(p, k, threadIdx.x, x, y, B);
}

__global__ void spring_block_kernel(const float* x, float* y, Phase p, int B) {
  extern __shared__ float rings[];
  spring_row(p, threadIdx.x, x, y, rings, B);
}

__global__ void waveshaper_block_kernel(const float* x, float* y, Phase p, FbwsCoefs k,
                                        int B) {
  waveshaper_row(p, k, threadIdx.x, x, y, B);
}

__global__ void fbws_fast_block_kernel(const float* x, float* y, Phase p, FbwsCoefs k, int B) {
  fbws_row(p, k, threadIdx.x, x, y, B);
}

// A run of effects: x is copied to y, then every phase rewrites y in place.
__global__ void bus_chain_kernel(const float* x, float* y, Chain ch, FbwsCoefs k, int B) {
  extern __shared__ float smem[];
  const int c = threadIdx.x;
  const size_t row = static_cast<size_t>(c) * B;
  for (int n = 0; n < B; ++n) y[row + n] = x[row + n];
  for (int i = 0; i < ch.n; ++i) run_phase(ch.ph[i], k, c, y, y, smem, B);
}

// ops: (op, flag) per phase; ptrs: in[0..7], out[0..1] per phase; f: 16 and
// iv: 16 per phase
Phase make_phase(const int* ops, void* const* ptrs, const float* f, const int* iv) {
  Phase p{};
  p.op = ops[0];
  p.flag = ops[1];
  for (int j = 0; j < kPhaseIn; ++j) p.in[j] = static_cast<const float*>(ptrs[j]);
  for (int j = 0; j < kPhaseOut; ++j) p.out[j] = static_cast<float*>(ptrs[kPhaseIn + j]);
  for (int j = 0; j < kPhaseF; ++j) p.f[j] = f[j];
  for (int j = 0; j < kPhaseI; ++j) p.iv[j] = iv[j];
  return p;
}

// Dynamic shared memory of a phase: the delay's staged taps, the spring's
// rings.
size_t phase_smem(const Phase& p, int B) {
  switch (p.op) {
    case kDelay:
      return 2 * static_cast<size_t>(B) * sizeof(float);
    case kSpring:
      return spring_ring_bytes(p.iv[2 * kSpringAps]);
    default:
      return 0;
  }
}

}  // namespace

extern "C" {

// One effect's block through its own kernel.
int bus_block_launch(const float* x, float* y, const int* ops, void* const* ptrs,
                     const float* f, const int* iv, const float* coefs, int B, void* stream) {
  const Phase p = make_phase(ops, ptrs, f, iv);
  const cudaStream_t s = as_stream(stream);
  const size_t smem = phase_smem(p, B);
  cudaError_t err = cudaSuccess;
  switch (p.op) {
    case kSaturation:
      saturation_block_kernel<<<1, 2, 0, s>>>(x, y, p, fbws_coefs(coefs), B);
      break;
    case kLowpass:
      lowpass_block_kernel<<<1, 2, 0, s>>>(x, y, p, B);
      break;
    case kTilt:
      tilt_block_kernel<<<1, 2, 0, s>>>(x, y, p, B);
      break;
    case kDelay:
      err = allow_smem(delay_block_kernel, smem);
      if (err == cudaSuccess) delay_block_kernel<<<1, 2, smem, s>>>(x, y, p, B);
      break;
    case kEnv:
      env_follower_block_kernel<<<1, 2, 0, s>>>(x, y, p, B);
      break;
    case kCompressor:
      compressor_block_kernel<<<1, 2, 0, s>>>(x, y, p, fbws_coefs(coefs), B);
      break;
    case kSpring:
      err = allow_smem(spring_block_kernel, smem);
      if (err == cudaSuccess) spring_block_kernel<<<1, 2, smem, s>>>(x, y, p, B);
      break;
    case kWaveshaper:
      waveshaper_block_kernel<<<1, 2, 0, s>>>(x, y, p, fbws_coefs(coefs), B);
      break;
    case kFbws:
      fbws_fast_block_kernel<<<1, 2, 0, s>>>(x, y, p, fbws_coefs(coefs), B);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// n effects' blocks, in order, in one launch.
int bus_chain_launch(const float* x, float* y, int n, const int* ops, void* const* ptrs,
                     const float* f, const int* iv, const float* coefs, int B,
                     void* stream) {
  if (n < 1 || n > kMaxPhases) return static_cast<int>(cudaErrorInvalidValue);
  Chain ch{};
  ch.n = n;
  size_t smem = 0;
  for (int i = 0; i < n; ++i) {
    ch.ph[i] = make_phase(ops + 2 * i, ptrs + (kPhaseIn + kPhaseOut) * i, f + kPhaseF * i,
                          iv + kPhaseI * i);
    if (ch.ph[i].op < kSaturation || ch.ph[i].op > kFbws) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t need = phase_smem(ch.ph[i], B);
    smem = need > smem ? need : smem;
  }
  const cudaError_t err = allow_smem(bus_chain_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bus_chain_kernel<<<1, 2, smem, as_stream(stream)>>>(x, y, ch, fbws_coefs(coefs), B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
