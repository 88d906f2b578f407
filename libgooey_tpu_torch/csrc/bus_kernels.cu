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
// recurrence through the block's B samples.  Each effect's block is a row
// struct over one channel that resumes (begin, run over a span of samples,
// end; below), run by one warp in bus_chain.  What does not depend on the
// carried state (a sample's smoother trajectories, closed form with the
// settle snap as the Pallas bodies compute them; the tilt's coefficients;
// the compressor's knee gain; the feedback waveshaper's makeup gain; the
// spring's ring reads and their allpass offset, its allpass writes and
// mix) is computed per sample on all 32 lanes into the phase's shared
// scratch; lanes 0 and 1
// walk the two channels' recurrences on it, with the carried state in
// registers.  The compressor's and the spring's parameter trajectories come
// in as [2, B] rows, computed outside as the JAX package computes them
// outside its kernels.  The 4x phases (saturation, compressor, waveshaper,
// feedback waveshaper) split their chain: lanes 0 and 1 walk the up-path
// and the down-path four samples at a time, the 32 lanes evaluate the
// shaper (an atan or a tanh a 4x subsample) between them (split_4x).  The
// channels meet only in the delay's ping-pong write (each channel's write
// takes the other channel's filtered tap at the same sample): the delay
// stages its filtered taps in shared memory and the two lanes meet at a
// __syncwarp.  That one-warp row is what bus_chain runs; each effect's own
// kernel spreads its block over a block of warps instead: the lone 4x
// effects, the saturation, compressor, waveshaper and feedback waveshaper
// (bus4x_split_kernel, below): their chain's stages walk on warps of their
// own, a polyphase branch a lane, chunks pipelined a step apart; the lone
// detector and spring (env_lone_kernel, spring_lone_kernel, below) and the
// lone lowpass, tilt and delay (walk_lone_kernel, below): each channel's
// walk on a warp of its own, the per-sample work and the copies on the rest
// of the block.
//
// The spring's twelve allpass delay lines (six a channel, lags 127-797 at
// 44.1 kHz) live in shared memory as rings of the history's length D, one
// per line (csrc/rings.cuh), 12 x D floats (38 KB at 44.1 kHz, independent
// of B), filled from the history and unrolled back to it by the whole warp
// (the whole block in the lone kernel): each sample reads every line at its
// lag and writes its new value into the slot it frees, the Schroeder
// allpass in place.  The carried state keeps
// the JAX package's right-aligned [12, D] history.  Rings rather than the
// Pallas body's [12, D+B] work buffer keep the spring's shared memory
// independent of B; past 48 KB a launch opts in to dynamic shared memory,
// and a refused launch returns its error.
//
// bus_chain runs a list of such phases, phase i on warp i, the signal in
// shared memory threaded in place (every row function reads sample n before
// it writes it), as chain_fused threads it through one VMEM ref.  The phases
// are pipelined: the block is cut into 32-sample chunks and at step s warp i
// runs chunk s - i, one block barrier a step, so a launch takes (phases +
// chunks - 1) steps of the slowest phase's chunk instead of the sum of the
// phases.  Each phase has its own shared memory (the delay's taps, the
// spring's rings, the 4x phases' scratch).  It calls the same row structs as
// the per-effect kernels, so a run gives bit for bit what the per-effect
// kernels give one after the other, with one launch in place of one per
// effect.  The compressor is two phases, as in chain_fused: the detector
// (env) passes the signal through and leaves its envelope in its output,
// which the next phase reads at the same chunk a step later; the feedback
// waveshaper is two phases the same way.  The glue around each effect
// (trajectories of the delay time and of the compressor's and spring's
// parameters, the ring gather and scatter, state packing, freezes) stays in
// PyTorch before and after the launch, as it stays in XLA around
// chain_fused.
//
// What bounds them on the card: a few KB to a few tens of KB move per call
// and a few hundred thousand operations are done, so the card's bound is a
// microsecond or less; the time is the channels' serial walks, the 4x
// chains' up- and down-paths the longest (~7 us a 32-sample chunk on one
// warp, on an H100 80GB HBM3 at 700 W, PERF.md), and one SM of 132 is
// busy.  A bus_chain step takes the slowest phase's chunk and a block
// barrier, a lone 4x kernel's step its slowest walk's chunk (a walk's lane
// runs ~20 instructions a sample).
//
// Numerics: the Pallas bodies solve the linear recurrences (the tilt's SVF,
// the delay's two-pole, the DC blocker, the compressor's gain smoother, the
// spring's damping loop) with log-depth scans; these kernels and their
// plain versions (ops/bus_kernels.py) step them sample by sample in the same
// per-sample op order, so the two differ at float-noise level.  Built with
// -fmad=false, as bank_kernels.cu: a kernel and its plain version then give
// the same bits on the card.
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError(); nothing allocates or synchronizes here.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "ovs4.cuh"
#include "rings.cuh"
#include "row_stage.cuh"

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

// Every effect's block is a row struct over one channel c that resumes:
// begin() loads the channel's carried state into registers, run(n0, n1)
// steps samples [n0, n1) of the block, end() stores the state.  run() is
// called by all 32 lanes of the phase's warp: what does not depend on the
// carried state (a sample's trajectories, coefficients, gains, ring reads)
// is computed per sample on every lane into the phase's shared scratch,
// and lanes 0 and 1 walk the channels' recurrences on it in sample order.
// fill() and drain() run on every lane, before begin() and after end() (the
// spring's rings; a no-op elsewhere).  bus_chain runs a row chunk by
// chunk; the effects' own kernels call its per-sample pieces.
struct RowBase {
  __device__ __forceinline__ void fill(const Phase&, int, float*) {}
  __device__ __forceinline__ void drain(const Phase&, int, int, float*) {}
};

// The span a warp runs at a time: bus_chain's chunk.
constexpr int kChainChunk = 32;

// Sample j of a span of len samples on both channels, as every lane takes
// them: channel c, sample i of the span.
__device__ __forceinline__ void both_channels(int j, int len, int& c, int& i) {
  c = j >= len ? 1 : 0;
  i = j - len * c;
}

// A 4x phase's shared scratch, per channel: 4C subsamples, C shapers (two
// floats each at most), four values a sample ([4][C]).
constexpr int kSub = 4 * kChainChunk;
constexpr int kShapers = 2 * kChainChunk;
constexpr int kValues = 4 * kChainChunk;
constexpr int kScratch4x = 2 * (kSub + kShapers + kValues);

__device__ __forceinline__ float* values_of(float* scratch, int c) {
  return scratch + 2 * (kSub + kShapers) + c * kValues;
}

// The 4x chain of a span, split over the warp (ovs4_up_span,
// ovs4_down_span): every lane evaluates each sample's shaper and the row's
// own per-sample values (prep(c, n, v): value m of the sample at
// v[m * kChainChunk]); lanes 0 and 1 walk their channel's up-path; every
// lane applies the shapers (an atan or a tanh a 4x subsample); lanes 0 and
// 1 walk the down-path and finish.  The channels' serial chains keep their
// op order.  Called by every lane of the warp.
template <class Prep, class Input, class ShaperAt, class Finish>
__device__ __forceinline__ void split_4x(FbwsState& s, OvsCaps& cap, const FbwsCoefs& k,
                                         int lane, int n0, int n1, int B, float* scratch,
                                         const Prep& prep, const Input& input,
                                         const ShaperAt& shaper_at, const Finish& finish) {
  using Shaper = decltype(shaper_at(0, 0));
  static_assert(sizeof(Shaper) <= 2 * sizeof(float), "a shaper is two floats at most");
  Shaper* shapers = reinterpret_cast<Shaper*>(scratch + 2 * kSub);   // [2][C]
  const int len = n1 - n0;
  for (int j = lane; j < 2 * len; j += 32) {
    int c, i;
    both_channels(j, len, c, i);
    shapers[c * kChainChunk + i] = shaper_at(c, n0 + i);
    prep(c, n0 + i, values_of(scratch, c) + i);
  }
  __syncwarp();
  if (lane < 2) ovs4_up_span(s, cap, k, n0, n1, B, input, scratch + lane * kSub);
  __syncwarp();
  const auto shape = [&](int j) {
    int c, i;
    both_channels(j, 4 * len, c, i);
    float& v = scratch[c * kSub + i];
    v = shapers[c * kChainChunk + (i >> 2)](v);
  };
  if (len == kChainChunk) {   // eight a lane, unrolled so that they overlap
#pragma unroll
    for (int t = 0; t < 8 * kChainChunk / 32; ++t) shape(lane + 32 * t);
  } else {
    for (int j = lane; j < 8 * len; j += 32) shape(j);
  }
  __syncwarp();
  if (lane < 2) ovs4_down_span(s, cap, k, n0, n1, B, scratch + lane * kSub, finish);
}

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

// The saturation's per-sample pieces, shared by SaturationRow and the lone
// kernel: the mix trajectory, the shaper (drive and warmth trajectories) and
// the finish of a down-walk's output v on input xn at mix m (the
// bypass-gated DC blocker, _dc_block, the mix and the finite select).
__device__ __forceinline__ float sat_mix(const Phase& p, int c, int n) {
  return traj(p.in[0][3 * c + 2], p.in[1][3 * c + 2], p.f[0], n);
}

__device__ __forceinline__ SatShaper sat_shaper(const Phase& p, int c, int n) {
  return SatShaper{1.0f + traj(p.in[0][3 * c], p.in[1][3 * c], p.f[0], n) * 7.0f,
                   traj(p.in[0][3 * c + 1], p.in[1][3 * c + 1], p.f[0], n) * 0.4f};
}

__device__ __forceinline__ float sat_finish(FbwsState& s, float v, float m, float xn) {
  const bool byp = m < 1e-4f;
  const float v1 = gated_dc(s, v, byp ? -1.0f : 1.0f);
  const float o = byp ? xn : xn * (1.0f - m) + v1 * m;
  return isfinite(o) ? o : 0.0f;
}

// The smoothers' values at the block's last sample, after the packed state.
__device__ __forceinline__ void sat_end(const Phase& p, int c, int B) {
  for (int j = 0; j < 3; ++j) {
    p.out[0][(kFbwsRowsOut + j) * 2 + c] =
        traj(p.in[0][3 * c + j], p.in[1][3 * c + j], p.f[0], B - 1);
  }
}

// Channel c of the saturation block (_sat4_kernel): smoothed drive, warmth
// and mix, the 4x chain around the tube curve, the bypass-gated DC blocker,
// the mix and the finite select.
struct SaturationRow : RowBase {
  FbwsState s;
  OvsCaps cap;
  __device__ __forceinline__ void begin(const Phase& p, int c, int, float*) {
    load_state(s, p.in[2], c, 2);
  }
  __device__ __forceinline__ void run(const Phase& p, const FbwsCoefs& k, int lane,
                                      const float* x, float* y, int n0, int n1, int B,
                                      float* scratch) {
    const int c = min(lane, 1);
    const size_t row = static_cast<size_t>(c) * B;
    const float* mix = values_of(scratch, c);   // the mix trajectory
    split_4x(
        s, cap, k, lane, n0, n1, B, scratch,
        [&](int ch, int n, float* v) { v[0] = sat_mix(p, ch, n); },
        [&](int n) { return x[row + n]; }, [&](int ch, int n) { return sat_shaper(p, ch, n); },
        [&](int n, float v) { y[row + n] = sat_finish(s, v, mix[n - n0], x[row + n]); });
  }
  __device__ __forceinline__ void end(const Phase& p, int c, int B) {
    store_span_state(s, cap, p.out[0], c, 2);
    sat_end(p, c, B);
  }
};

// --- 2. lowpass: Moog-style 2-pole LP with tanh'd resonance ------------------

// One sample of the nonlinear recurrence (lowpass_filter.rs) on the
// feedback fbn and its clip mn = min(fbn, 1), which a walk takes computed
// ahead; returns the raw stage-2 value, whose tanh is the effect's output.
// (The flushes and the NaN reset as one select give the same bits and a
// lone walk ~0.8 us faster, but bus_chain's one-warp lowpass row slower;
// PERF.md.)
__device__ __forceinline__ float lowpass_step(float& s1, float& s2, float xn, float gn, float fbn,
                                              float mn) {
  const float infb = xn - tanhf(s2 * fbn) * mn;
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

struct LowpassRow : RowBase {
  float s1, s2;
  __device__ __forceinline__ void begin(const Phase& p, int c, int, float*) {
    s1 = p.in[2][2 * c];
    s2 = p.in[2][2 * c + 1];
  }
  __device__ __forceinline__ void run(const Phase& p, const FbwsCoefs&, int lane,
                                      const float* x, float* y, int n0, int n1, int B, float*) {
    if (lane >= 2) return;
    const int c = lane;
    const float* g = p.in[0];
    const float* fb = p.in[1];
    const size_t row = static_cast<size_t>(c) * B;
    for (int n = n0; n < n1; ++n) {
      const size_t i = row + n;
      y[i] = tanhf(lowpass_step(s1, s2, x[i], g[i], fb[i], fminf(fb[i], 1.0f)));
    }
  }
  __device__ __forceinline__ void end(const Phase& p, int c, int) {
    p.out[0][2 * c] = s1;
    p.out[0][2 * c + 1] = s2;
  }
};

// --- 3. tilt: one-knob LP<->HP sweep through a TPT SVF -----------------------

// A tilt phase's shared scratch: six values a sample a channel.
constexpr int kScratchTilt = 2 * 6 * kChainChunk;

// The tilt filter's coefficients at knob/res values ``knob``/``res``
// (tilt_filter.rs:99-125): the frequency maps and the SVF's g, h and r, the
// mix, low-pass or not, passthrough or not (the flags as 1 or 0).
struct TiltCoefs {
  float g, h, r, mix, lp, pass;
};

__device__ __forceinline__ TiltCoefs tilt_coefs(const Phase& p, float knob, float res) {
  const float lp_log = p.f[1];    // log(20000/80)
  const float hp_log = p.f[2];    // log(8000/20)
  const float max_cut = p.f[3];   // 0.45 sr
  const float pi = p.f[4], inv_sr = p.f[5];
  const float lp_mix = 1.0f - knob * 2.0f;
  const float lp_freq = 80.0f * expf(lp_log * (knob * 2.0f));
  const float hp_mix = (knob - 0.5f) * 2.0f;
  const float hp_freq = 20.0f * expf(hp_log * ((knob - 0.5f) * 2.0f));
  const bool use_lp = knob < 0.5f;
  const float mix = use_lp ? lp_mix : hp_mix;
  const float freq = use_lp ? lp_freq : hp_freq;
  const float q = 0.5f + res * 8.0f;
  const float cutoff = fminf(fmaxf(freq, 20.0f), max_cut);
  const float g = tanf(pi * cutoff * inv_sr);
  const float r = 1.0f / fmaxf(q, 0.5f);
  return TiltCoefs{g, 1.0f / (1.0f + r * g + g * g), r, mix, use_lp ? 1.0f : 0.0f,
                   mix < 0.001f ? 1.0f : 0.0f};
}

// The coefficients of channel c at block sample n: the knob's and the
// resonance's trajectories (in[0], in[1]: cur, tgt [2, 2]; f[0]: log q).
__device__ __forceinline__ TiltCoefs tilt_coefs_at(const Phase& p, int c, int n) {
  const float* cur = p.in[0];
  const float* tgt = p.in[1];
  return tilt_coefs(p, traj(cur[2 * c], tgt[2 * c], p.f[0], n),
                    traj(cur[2 * c + 1], tgt[2 * c + 1], p.f[0], n));
}

// One step of the TPT SVF on input x: its pre-update taps v1 and v2.
__device__ __forceinline__ void tilt_svf(float& ic1, float& ic2, float x, float g, float h,
                                         float& v1, float& v2) {
  v1 = (g * (x - ic2) + ic1) * h;
  v2 = ic2 + g * v1;
  ic1 = 2.0f * v1 - ic1;
  ic2 = 2.0f * v2 - ic2;
}

// A sample's output from its taps: the low- or high-pass, the crossfade (x
// itself in passthrough), the finite select and the 1e-15 flush.
__device__ __forceinline__ float tilt_out(float x, float v1, float v2, float r, float mix,
                                          float lp, float pass) {
  const float wet = lp != 0.0f ? v2 : x - (r * v1 + v2);
  float o = pass != 0.0f ? x : x * (1.0f - mix) + wet * mix;
  o = isfinite(o) ? o : 0.0f;
  return fabsf(o) < kDenormal ? 0.0f : o;
}

// The carried state after the block: (ic1, ic2, knob, res) of channel c.
__device__ __forceinline__ void tilt_end(const Phase& p, int c, int B, float ic1, float ic2) {
  const float logq = p.f[0];
  float* st_out = p.out[0];
  st_out[4 * c + 0] = ic1;
  st_out[4 * c + 1] = ic2;
  st_out[4 * c + 2] = traj(p.in[0][2 * c], p.in[1][2 * c], logq, B - 1);
  st_out[4 * c + 3] = traj(p.in[0][2 * c + 1], p.in[1][2 * c + 1], logq, B - 1);
}

struct TiltRow : RowBase {
  float ic1, ic2;
  __device__ __forceinline__ void begin(const Phase& p, int c, int, float*) {
    ic1 = p.in[2][2 * c];
    ic2 = p.in[2][2 * c + 1];
  }
  __device__ __forceinline__ void run(const Phase& p, const FbwsCoefs&, int lane,
                                      const float* x, float* y, int n0, int n1, int B,
                                      float* scratch) {
    // each sample's coefficients at v[m * kChainChunk], in TiltCoefs' order
    const int len = n1 - n0;
    for (int j = lane; j < 2 * len; j += 32) {
      int c, i;
      both_channels(j, len, c, i);
      const TiltCoefs k = tilt_coefs_at(p, c, n0 + i);
      float* v = scratch + c * 6 * kChainChunk + i;
      v[0] = k.g;
      v[kChainChunk] = k.h;
      v[2 * kChainChunk] = k.r;
      v[3 * kChainChunk] = k.mix;
      v[4 * kChainChunk] = k.lp;
      v[5 * kChainChunk] = k.pass;
    }
    __syncwarp();
    if (lane >= 2) return;
    const int c = lane;
    const size_t row = static_cast<size_t>(c) * B;
    const float* v = scratch + c * 6 * kChainChunk;
    for (int i = 0; i < len; ++i) {
      const float xn = x[row + n0 + i];
      float v1, v2;
      tilt_svf(ic1, ic2, xn, v[i], v[kChainChunk + i], v1, v2);
      y[row + n0 + i] = tilt_out(xn, v1, v2, v[2 * kChainChunk + i], v[3 * kChainChunk + i],
                                 v[4 * kChainChunk + i], v[5 * kChainChunk + i]);
    }
  }
  __device__ __forceinline__ void end(const Phase& p, int c, int B) {
    tilt_end(p, c, B, ic1, ic2);
  }
};

// --- 4. delay: the delay's post-read filter, feedback write and mix ----------

constexpr float kDelayRes = 0.3f;  // FILTER_RESONANCE (delay.rs)

// One sample of the darkening two-pole low-pass on the gathered tap
// (delay.rs:370-384), in the affine form the Pallas body scans:
// z' = A z + b with the old state on both rows.  Split for a walk: the
// coefficients of a sample (delay_coefs: the cutoff's g, A and b), which do
// not depend on the state, then the affine step (delay_affine), which
// returns the filtered tap.
struct DelayCoefs {
  float a11, a12, b1, a21, a22, b2;
};

__device__ __forceinline__ DelayCoefs delay_coefs(float tap, float cut, float gk) {
  const float g = 1.0f - expf(gk * cut);
  const float a11 = 1.0f - g + g * kDelayRes;
  const float a12 = -g * kDelayRes;
  const float b1 = g * tap;
  const float a21 = g * a11;
  const float a22 = (1.0f - g) + g * a12;
  const float b2 = g * b1;
  return DelayCoefs{a11, a12, b1, a21, a22, b2};
}

__device__ __forceinline__ float delay_affine(float& z1, float& z2, const DelayCoefs& k) {
  const float n1 = k.a11 * z1 + k.a12 * z2 + k.b1;
  const float n2 = k.a21 * z1 + k.a22 * z2 + k.b2;
  z1 = n1;
  z2 = n2;
  return n2;
}

// The ring write: inject + tap*feedback, zeroed if not finite or denormal.
__device__ __forceinline__ float delay_write(float inject, float tap, float fb) {
  const float w = inject + tap * fb;
  return (isfinite(w) && fabsf(w) > kDenormal) ? w : 0.0f;
}

// Channel c of the delay block.  ``stage`` ([2, B] shared, the phase's own)
// holds both channels' filtered taps: with ping-pong each channel's write
// takes the other channel's tap at the same sample, so the two channels
// (lanes 0 and 1 of one warp) meet at a __syncwarp after each span's taps.
struct DelayRow : RowBase {
  float cf, cm, cc, tf, tm, tc, z1, z2;
  float* stage;
  __device__ __forceinline__ void begin(const Phase& p, int c, int, float* smem) {
    cf = p.in[1][3 * c + 0];
    cm = p.in[1][3 * c + 1];
    cc = p.in[1][3 * c + 2];
    tf = p.in[2][3 * c + 0];
    tm = p.in[2][3 * c + 1];
    tc = p.in[2][3 * c + 2];
    z1 = p.in[3][2 * c];
    z2 = p.in[3][2 * c + 1];
    stage = smem;
  }
  __device__ __forceinline__ void run(const Phase& p, const FbwsCoefs&, int lane,
                                      const float* x, float* y, int n0, int n1, int B, float*) {
    if (lane >= 2) return;
    const int c = lane;
    const float* tap = p.in[0];
    float* write = p.out[0];
    const float logq = p.f[0], gk = p.f[1];
    const bool pingpong = p.flag != 0;
    const size_t row = static_cast<size_t>(c) * B;
    for (int n = n0; n < n1; ++n) {
      const float mix = traj(cm, tm, logq, n);
      const float filt =
          delay_affine(z1, z2, delay_coefs(tap[row + n], traj(cc, tc, logq, n), gk));
      const float xn = x[row + n];
      stage[row + n] = filt;
      // the injection; with ping-pong the dry signal feeds the left channel
      // only (delay.rs:460-491)
      write[row + n] = (pingpong && c == 1) ? 0.0f : xn;
      const float o = xn * (1.0f - mix) + filt * mix;
      y[row + n] = isfinite(o) ? o : xn;
    }
    __syncwarp(0x3u);
    const size_t tap_row = static_cast<size_t>(pingpong ? 1 - c : c) * B;
    for (int n = n0; n < n1; ++n) {
      write[row + n] = delay_write(write[row + n], stage[tap_row + n], traj(cf, tf, logq, n));
    }
  }
  __device__ __forceinline__ void end(const Phase& p, int c, int B) {
    const float logq = p.f[0];
    float* st_out = p.out[1];
    st_out[5 * c + 0] = z1;
    st_out[5 * c + 1] = z2;
    st_out[5 * c + 2] = traj(cf, tf, logq, B - 1);
    st_out[5 * c + 3] = traj(cm, tm, logq, B - 1);
    st_out[5 * c + 4] = traj(cc, tc, logq, B - 1);
  }
};

// --- 5. env: the compressor's attack/release peak detector --------------------

// The detector's step (_env_kernel): e = c*env + (1-c)*|x| with c = att if
// |x| > env else rel, flushed below 1e-15; a bypassed sample (byp > 0.5)
// takes c = 1, which holds the envelope exactly (the Pallas wrapper folds
// the bypass into the coefficients the same way).  Split for a walk: a
// sample's values that do not depend on the envelope (r = |x| and, with the
// bypass folded in, c_a = att or 1, (1 - c_a)*r, c_r = rel or 1,
// (1 - c_r)*r), then the step, which forms both candidates c_a*env +
// (1 - c_a)*r and c_r*env + (1 - c_r)*r, each the plain version's own
// expression, and selects by r > env, so the compare leaves the chain.  The
// bank follower (bank_kernels.cu env_follow_bank) steps env + (1-c)*(r -
// env), its own TPU kernel's op order, so the two steps round differently
// and are not shared.
struct EnvVals {
  float r, ca, pa, cr, pr;
};

__device__ __forceinline__ EnvVals env_values(float x, float att, float rel, float byp) {
  const float r = fabsf(x);
  const bool frozen = byp > 0.5f;
  const float ca = frozen ? 1.0f : att;
  const float cr = frozen ? 1.0f : rel;
  return EnvVals{r, ca, (1.0f - ca) * r, cr, (1.0f - cr) * r};
}

__device__ __forceinline__ float env_step(float& env, float r, float ca, float pa, float cr,
                                          float pr) {
  const float ea = ca * env + pa;
  const float er = cr * env + pr;
  const float e = r > env ? ea : er;
  env = e < kDenormal ? 0.0f : e;
  return env;
}

// Channel c of the detector.  The signal passes through (y = x); the
// envelope goes to out[0].
struct EnvRow : RowBase {
  float env;
  __device__ __forceinline__ void begin(const Phase& p, int c, int, float*) { env = p.in[3][c]; }
  __device__ __forceinline__ void run(const Phase& p, const FbwsCoefs&, int lane,
                                      const float* x, float* y, int n0, int n1, int B, float*) {
    if (lane >= 2) return;
    const int c = lane;
    const float* att = p.in[0];
    const float* rel = p.in[1];
    const float* byp = p.in[2];
    float* env_out = p.out[0];
    const size_t row = static_cast<size_t>(c) * B;
    for (int n = n0; n < n1; ++n) {
      const size_t i = row + n;
      const float xn = x[i];
      const EnvVals v = env_values(xn, att[i], rel[i], byp[i]);
      env_out[i] = env_step(env, v.r, v.ca, v.pa, v.cr, v.pr);
      y[i] = xn;
    }
  }
  __device__ __forceinline__ void end(const Phase& p, int c, int) { p.out[1][c] = env; }
};

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

// The compressor's per-sample pieces, shared by CompressorRow and the lone
// kernel: the bypass flag (1 where mix < 1e-4), the knee's target gain on
// the envelope, one step of the gain smoother (frozen on bypass), and the
// finish of a down-walk's output u (the tube colour where g < 0.99, else
// x*g; the bypass-gated DC blocker, the mix and the finite select).
__device__ __forceinline__ float comp_bypass(float mix) { return mix < 1e-4f ? 1.0f : 0.0f; }

__device__ __forceinline__ float comp_target(const Phase& p, float env, float thr,
                                             float ratio) {
  const float env_db = p.f[0] * logf(env + 1e-20f);   // 20 / ln 10
  const float over = env_db - thr;
  const float slope = 1.0f - 1.0f / ratio;
  const float kv = over + 3.0f;
  const float knee = kv * kv / 12.0f * slope;
  const float gr = over <= -3.0f ? 0.0f : (over >= 3.0f ? over * slope : knee);
  return expf(p.f[1] * gr);   // -ln 10 / 20
}

__device__ __forceinline__ float comp_gain(float g, float byp, float target) {
  return byp != 0.0f ? g : 0.95f * g + 0.05f * target;
}

__device__ __forceinline__ float comp_finish(FbwsState& s, float u, float byp, float g,
                                             float xg, float xn, float m) {
  const bool bp = byp != 0.0f;
  const float colored = g < 0.99f ? u : xg;
  const float y1 = gated_dc(s, colored, bp ? -1.0f : 1.0f);
  const float o = bp ? xn : xn * (1.0f - m) + y1 * m;
  return isfinite(o) ? o : 0.0f;
}

// Channel c of the compressor block (_comp_kernel) on the detector's
// envelope: the knee's gain reduction (per sample, on every lane), the
// one-pole gain smoother (stepped by the up-path's walk, which keeps each
// sample's gain and x*g for the down-path), x*g through the 4x chain with
// the atan tube colour (engaged when g < 0.99, always fed so its history
// stays warm), the bypass-gated DC blocker, the mix and the finite select.
struct CompressorRow : RowBase {
  FbwsState s;
  OvsCaps cap;
  float g;
  __device__ __forceinline__ void begin(const Phase& p, int c, int, float*) {
    load_state(s, p.in[4], c, 2);
    g = p.in[4][kFbwsRowsIn * 2 + c];
  }
  __device__ __forceinline__ void run(const Phase& p, const FbwsCoefs& k, int lane,
                                      const float* x, float* y, int n0, int n1, int B,
                                      float* scratch) {
    const float* env = p.in[0];
    const float* thr = p.in[1];
    const float* ratio = p.in[2];
    const float* mix = p.in[3];
    const AtanShaper shape{p.f[2]};
    const int c = min(lane, 1);
    const size_t row = static_cast<size_t>(c) * B;
    // a sample's bypass, target gain, smoothed gain and x*g
    float* v = values_of(scratch, c);
    constexpr int C = kChainChunk;
    split_4x(
        s, cap, k, lane, n0, n1, B, scratch,
        [&](int ch, int n, float* w) {
          const size_t i = static_cast<size_t>(ch) * B + n;
          w[0] = comp_bypass(mix[i]);
          w[C] = comp_target(p, env[i], thr[i], ratio[i]);
        },
        [&](int n) {
          const int i = n - n0;
          g = comp_gain(g, v[i], v[C + i]);
          const float compressed = x[row + n] * g;
          v[2 * C + i] = g;
          v[3 * C + i] = compressed;
          return compressed;
        },
        [&](int, int) { return shape; },
        [&](int n, float u) {
          const int j = n - n0;
          y[row + n] = comp_finish(s, u, v[j], v[2 * C + j], v[3 * C + j], x[row + n],
                                   mix[row + n]);
        });
  }
  __device__ __forceinline__ void end(const Phase& p, int c, int) {
    store_span_state(s, cap, p.out[0], c, 2);
    p.out[0][kFbwsRowsOut * 2 + c] = g;
  }
};

// --- 7. spring: six allpasses a channel in a damped feedback loop ------------

constexpr int kSpringAps = 6;

__host__ __device__ __forceinline__ size_t spring_ring_bytes(int D) {
  return 2 * kSpringAps * static_cast<size_t>(D) * sizeof(float);
}

// A spring phase's shared scratch after its rings: a sample's six ring
// reads, its beta and its d_prev, a channel each.
constexpr int kScratchSpring = 2 * (kSpringAps + 2) * kChainChunk;

// The spring's per-sample pieces, shared by SpringRow and the lone kernel
// (spring_lone_kernel), on channel c's six rings (``rings``: 2 x 6 x D, the
// slot sample n writes is w = n mod D): the six delayed reads (into rd[a *
// stride]) and beta, their allpass chain's affine offset; the damping
// loop's input bv; the six allpass writes from the chain input sig, which
// give the wet sample; the dry/wet mix.  Each piece does its six shared
// loads before its stores (the compiler does not move a shared load past a
// shared store).
__device__ __forceinline__ float spring_reads(const Phase& p, const float* rings, int c, int w,
                                              int D, float* rd, int stride) {
  const float* ring = rings + c * static_cast<size_t>(kSpringAps) * D;
  float v[kSpringAps];
#pragma unroll
  for (int a = 0; a < kSpringAps; ++a) {
    v[a] = ring[a * D + ring_slot(w, p.iv[c * kSpringAps + a], D)];
  }
  float beta = 0.0f;
#pragma unroll
  for (int a = 0; a < kSpringAps; ++a) {
    rd[a * stride] = v[a];
    beta = p.f[a] * beta + p.f[kSpringAps + a] * v[a];
  }
  return beta;
}

// x with the carried feedback fb0 added at n = 0
__device__ __forceinline__ float spring_xe(const Phase& p, int c, int n, float xn) {
  return n == 0 ? xn + p.in[6][c] : xn;
}

__device__ __forceinline__ float spring_input(float p2, float alpha, float xe, float beta) {
  return p2 * (alpha * xe + beta);
}

__device__ __forceinline__ float spring_writes(const Phase& p, float* rings, int c, int w, int D,
                                               float sig, const float* rd, int stride) {
  float* ring = rings + c * static_cast<size_t>(kSpringAps) * D;
  float r[kSpringAps];
#pragma unroll
  for (int a = 0; a < kSpringAps; ++a) r[a] = rd[a * stride];
#pragma unroll
  for (int a = 0; a < kSpringAps; ++a) {
    const float u = sig - p.f[a] * r[a];
    ring[a * D + w] = u;
    sig = p.f[a] * u + r[a];
  }
  return sig;
}

__device__ __forceinline__ float spring_mix(float xn, float wet, float m) {
  return xn * (1.0f - m) + wet * m;
}

// Channel c of the spring block (_spring_kernel, stepped sample by sample):
// the six delayed reads, beta = their allpass chain's affine offset, the
// damping recurrence d = A*d + p2*(alpha*xeff + beta), the chain input
// xeff + fbgp*d_prev, the six allpass writes, and the dry/wet mix of
// reverb_spring.py.  xeff is x with the carried feedback fb0 added at n = 0.
// Every lag is at least 127 samples at 44.1 kHz, the chunk the Pallas body
// runs, so its chunked reads see the same values.  ``rings``: 2 x 6 x D
// shared floats, the phase's own, filled from the history and unrolled back
// to it by the whole warp; the slot sample n writes is n mod D.  A span
// runs in parts no longer than the shortest lag, so that no read of a part
// sees a write of the same part: every lane reads the rings and sums beta
// for the part's samples, lanes 0 and 1 walk the damping loop, every lane
// runs the allpass writes and the mix.
struct SpringRow {
  float d;
  __device__ __forceinline__ void fill(const Phase& p, int lane, float* rings) {
    const size_t n = 2 * kSpringAps * static_cast<size_t>(p.iv[2 * kSpringAps]);
    const float* hist = p.in[3];
#pragma unroll 4
    for (size_t i = lane; i < n; i += 32) rings[i] = hist[i];
  }
  __device__ __forceinline__ void begin(const Phase& p, int c, int, float*) { d = p.in[4][c]; }
  __device__ __forceinline__ void run(const Phase& p, const FbwsCoefs&, int lane,
                                      const float* x, float* y, int n0, int n1, int B,
                                      float* rings) {
    const float* A = p.in[0];
    const float* p2 = p.in[1];
    const float* fbgp = p.in[2];
    const float* mix = p.in[5];
    const int D = p.iv[2 * kSpringAps];
    const float alpha = p.f[2 * kSpringAps];
    float* scratch = rings + 2 * kSpringAps * D;
    constexpr int C = kChainChunk;
    int min_lag = D;
    for (int j = 0; j < 2 * kSpringAps; ++j) min_lag = min(min_lag, p.iv[j]);
    for (int s0 = n0; s0 < n1; s0 += min_lag) {
      const int len = min(n1 - s0, min_lag);
      const int w0 = s0 % D;
      // the ring reads and beta, every lane
      for (int j = lane; j < 2 * len; j += 32) {
        int c, i;
        both_channels(j, len, c, i);
        int w = w0 + i;
        w -= w >= D ? D : 0;
        float* v = scratch + c * (kSpringAps + 2) * C + i;
        v[kSpringAps * C] = spring_reads(p, rings, c, w, D, v, C);
      }
      __syncwarp();
      // the damping loop, lanes 0 and 1
      if (lane < 2) {
        const size_t row = static_cast<size_t>(lane) * B;
        float* v = scratch + lane * (kSpringAps + 2) * C;
        for (int i = 0; i < len; ++i) {
          const int n = s0 + i;
          const float xe = spring_xe(p, lane, n, x[row + n]);
          const float bv = spring_input(p2[row + n], alpha, xe, v[kSpringAps * C + i]);
          v[(kSpringAps + 1) * C + i] = d;
          d = A[row + n] * d + bv;
        }
      }
      __syncwarp();
      // the allpass writes and the mix, every lane
      for (int j = lane; j < 2 * len; j += 32) {
        int c, i;
        both_channels(j, len, c, i);
        const int n = s0 + i;
        const size_t at = static_cast<size_t>(c) * B + n;
        int w = w0 + i;
        w -= w >= D ? D : 0;
        const float* v = scratch + c * (kSpringAps + 2) * C + i;
        const float xn = x[at];
        const float sig = spring_xe(p, c, n, xn) + fbgp[at] * v[(kSpringAps + 1) * C];
        y[at] = spring_mix(xn, spring_writes(p, rings, c, w, D, sig, v, C), mix[at]);
      }
      __syncwarp();
    }
  }
  __device__ __forceinline__ void end(const Phase& p, int c, int) { p.out[1][c] = d; }
  __device__ __forceinline__ void drain(const Phase& p, int lane, int B, float* rings) {
    const int D = p.iv[2 * kSpringAps];
    const int wB = B % D;
    for (int j = 0; j < 2 * kSpringAps; ++j) {
      const float* r = rings + static_cast<size_t>(j) * D;
      float* out = p.out[0] + static_cast<size_t>(j) * D;
      for (int m = lane; m < D; m += 32) {
        int k = wB + m;
        k -= k >= D ? D : 0;
        out[m] = r[k];
      }
    }
  }
};

// --- 8. waveshaper: tanh(v*d)*comp at 4x, wet/dry, bypass select ------------

// Channel c of the waveshaper block (_ws4_kernel): block-scalar drive and mix
// per channel (the chain's staged targets), the 4x chain around
// tanh(v*d)*tanh(0.5)/tanh(0.5d), the mix, the bypass select and the finite
// guard.  The packed DC rows pass through.
__device__ __forceinline__ DriveShaper ws_shaper(const Phase& p, int c) {
  const float d = fmaxf(p.in[0][2 * c], 1.000001f);
  return DriveShaper{d, p.f[0] / tanhf(0.5f * d)};
}

// The waveshaper's per-sample pieces, shared by WaveshaperRow and the lone
// kernel: channel c's bypass, and the finish of a down-walk's output v on
// input xn (the mix, the bypass select, the finite guard).
__device__ __forceinline__ bool ws_bypass(const Phase& p, int c) {
  return p.in[0][2 * c + 1] <= 1e-4f || p.in[0][2 * c] <= 1.0f;
}

__device__ __forceinline__ float ws_finish(float v, float xn, float mix, bool bypass) {
  const float o = bypass ? xn : xn * (1.0f - mix) + v * mix;
  return isfinite(xn) ? o : 0.0f;
}

struct WaveshaperRow : RowBase {
  FbwsState s;
  OvsCaps cap;
  __device__ __forceinline__ void begin(const Phase& p, int c, int, float*) {
    load_state(s, p.in[1], c, 2);
  }
  __device__ __forceinline__ void run(const Phase& p, const FbwsCoefs& k, int lane,
                                      const float* x, float* y, int n0, int n1, int B,
                                      float* scratch) {
    const int c = min(lane, 1);
    const float mix = p.in[0][2 * c + 1];
    const bool bypass = ws_bypass(p, c);
    const size_t row = static_cast<size_t>(c) * B;
    split_4x(
        s, cap, k, lane, n0, n1, B, scratch, [](int, int, float*) {},
        [&](int n) { return x[row + n]; }, [&](int ch, int) { return ws_shaper(p, ch); },
        [&](int n, float v) { y[row + n] = ws_finish(v, x[row + n], mix, bypass); });
  }
  __device__ __forceinline__ void end(const Phase& p, int c, int) {
    store_span_state(s, cap, p.out[0], c, 2);
  }
};

// --- 9. fbws: the feedback waveshaper's zero-feedback path at 4x ---------------

// Envelope-referenced makeup gain (feedback_waveshaper.rs:247-259) in the
// TPU kernel's exp/log form: fbws_makeup, the high end's part of a
// channel's block scalars prm = (drive, feedback, filter coefficient, mix)
// (p.f[0] = ln(10) * 5.1 / 20), and fbws_gain, a sample's gain on the
// envelope with it.
__device__ __forceinline__ float fbws_makeup(const Phase& p, const float* prm) {
  const float drive = prm[0], feedback = prm[1];
  const float drive_norm = fminf(fmaxf((drive - 1.0f) / 99.0f, 0.0f), 1.0f);
  const float feedback_norm = fminf(fmaxf(feedback / 0.98f, 0.0f), 1.0f);
  float high_end = expf(1.35f * logf(fmaxf(drive_norm, 1e-30f))) * (feedback_norm * feedback_norm);
  high_end = drive_norm <= 0.0f ? 0.0f : high_end;
  return expf(p.f[0] * high_end);
}

__device__ __forceinline__ float fbws_gain(float env, float drive, float feedback,
                                           float makeup) {
  const float reference = fmaxf(env, 0.05f);
  const float driven_ref = fmaxf(fabsf(tanhf(reference * drive)), 1e-6f);
  const float comp_no_fb = tanhf(reference) / driven_ref;
  const float taming = 1.0f / (1.0f + comp_no_fb * feedback * 0.25f);
  return fminf(comp_no_fb * taming * makeup, 3.0f);
}

// The feedback waveshaper's per-sample pieces, shared by FbwsRow and the
// lone kernel, on a channel's block scalars prm: its bypass; the DC
// blocker's gain of a sample on the envelope (-1 on a bypassed channel:
// gated_dc then holds); one step of the feedback filter on the DC blocker's
// output; the mix; the filter's flush at the block's end.
__device__ __forceinline__ bool fbws_bypass(const float* prm) {
  return prm[3] <= 1e-4f || prm[0] <= 1.0f;
}

__device__ __forceinline__ float fbws_cs(const float* prm, float env, float makeup) {
  return fbws_bypass(prm) ? -1.0f : fbws_gain(env, prm[0], prm[1], makeup);
}

__device__ __forceinline__ float fbws_filter(float filt, bool bypass, float fbc, float dc) {
  const float a1 = bypass ? 1.0f : 0.0f;
  return (bypass ? 1.0f : 1.0f - fbc) * filt + (1.0f - a1) * fbc * dc;
}

__device__ __forceinline__ float fbws_out(float xn, float dc, float mix, bool bypass) {
  return bypass ? xn : xn * (1.0f - mix) + dc * mix;
}

__device__ __forceinline__ float flushed(float v) { return fabsf(v) < kDenormal ? 0.0f : v; }

// Channel c of the zero-feedback block (_fbws_kernel) on the detector's
// envelope: drive*x through the 4x tanh chain, the makeup gain (per sample,
// on every lane), the bypass-gated DC blocker, the feedback filter's
// bookkeeping (its state rides the packed state's last row, as the
// compressor's gain does) and the mix.  drive, feedback, the filter
// coefficient and mix are block scalars.
struct FbwsRow : RowBase {
  FbwsState s;
  OvsCaps cap;
  float filt;
  __device__ __forceinline__ void begin(const Phase& p, int c, int, float*) {
    load_state(s, p.in[2], c, 2);
    filt = p.in[2][kFbwsRowsIn * 2 + c];
  }
  __device__ __forceinline__ void run(const Phase& p, const FbwsCoefs& k, int lane,
                                      const float* x, float* y, int n0, int n1, int B,
                                      float* scratch) {
    const float* env = p.in[0];
    const int c = min(lane, 1);
    const float* prm = p.in[1] + 4 * c;
    const float drive = prm[0], fbc = prm[2], mix = prm[3];
    const bool bypass = fbws_bypass(prm);
    const size_t row = static_cast<size_t>(c) * B;
    const float* cs = values_of(scratch, c);
    split_4x(
        s, cap, k, lane, n0, n1, B, scratch,
        [&](int ch, int n, float* w) {
          const float* q = p.in[1] + 4 * ch;
          w[0] = fbws_cs(q, env[static_cast<size_t>(ch) * B + n], fbws_makeup(p, q));
        },
        [&](int n) { return x[row + n] * drive; }, [](int, int) { return TanhShaper{}; },
        [&](int n, float v) {
          const float dc = gated_dc(s, v, cs[n - n0]);
          filt = fbws_filter(filt, bypass, fbc, dc);
          y[row + n] = fbws_out(x[row + n], dc, mix, bypass);
        });
  }
  __device__ __forceinline__ void end(const Phase& p, int c, int) {
    store_span_state(s, cap, p.out[0], c, 2);
    p.out[0][kFbwsRowsOut * 2 + c] = flushed(filt);
  }
};

// --- the kernels -----------------------------------------------------------------

// One barrier of the whole block, reached by the warps of a chain from
// their own phases' code (bar.sync counts threads, wherever they wait).
__device__ __forceinline__ void step_barrier() { asm volatile("bar.sync 0;" ::: "memory"); }

// --- the lone 4x effects: saturation_block, compressor_block,
// --- waveshaper_block and fbws_fast_block -------------------------------------
//
// A lone 4x effect (a run of one effect, a sidechained compressor, the
// unmerged bus or chain) runs its 4x chain as five walks, each on a
// warp of its own, its 32-sample chunks pipelined a step apart as
// split4x_rows pipelines ws4_bank's two walks.  The four stages of the
// chain (ovs4.cuh) each put their two polyphase branches on lanes of their
// own, four lanes a walk (lane = 2 * branch + channel): a branch is the same
// allpass code on its own coefficients and memories, and the branches meet
// only in the down stages' half-sums, which the next walk takes in the
// plain version's order.  At step j:
//   warp 0  walks chunk j's stage-1 up (the compressor's gain smoother
//           rides it, on both branches' lanes alike, and keeps each
//           sample's g and x*g),
//   warp 1  chunk j-1's stage-2 up into a ring of subsample tiles,
//   warp 2  chunk j-3's stage-2 down,
//   warp 3  chunk j-4's stage-1 down,
//   warp 4  chunk j-5's finish on lanes 0 and 1 (the stage-1 half-sum, the
//           gated DC blocker, the mix, the finite select; the feedback
//           waveshaper's filter) into an output tile;
//   warps 5 on (the workers: five warps for the saturation, three for the
//           compressor and the two waveshapers, as the probes chose) copy
//           chunk j+2's inputs in with cp.async, compute chunk j+1's
//           per-sample values (what does not depend on the carried state:
//           the saturation's mix, drive and bias trajectories; the
//           compressor's bypass and target gain; the feedback
//           waveshaper's drive*x and makeup gain), shape chunk j-2's
//           2 x 128 subsamples (an atan or a tanh each) and store chunk
//           j-6's output, coalesced.
// One barrier a step: a step costs the longest part, where a one-warp
// row's span (bus_chain's) costs their sum, and a walk's lane steps 4
// allpass sections a sample where a row's lane steps 32.  Each lane
// loads and stores only its branch's part of the packed state (the DC rows
// with the finish, the compressor's g with stage-1 up).  A chunk's inputs
// and values live in a ring of kLoneRing chunks from their copy (step j-2)
// to the finish (step j+5).  Every per-channel operation keeps the plain
// version's order, so the kernel gives bus_chain's row's bits.

constexpr int kLoneWalks = 5;
// steps behind the up-walk: each walk (stage-1 up, stage-2 up, stage-2
// down, stage-1 down, the finish), the shaping
__device__ __forceinline__ constexpr int lone_lag(int walk) { return walk <= 1 ? walk : walk + 1; }
constexpr int kLagShape = 2;
constexpr int kLagFinish = 5;
constexpr int kLoneRing = 8;      // chunks of inputs and values (copied j+2 ... finished j-5)
constexpr int kLoneSubRing = 4;   // subsample tiles (written j-1, shaped j-2, walked down j-3)
constexpr int kLonePitch = kChainChunk + 4;        // floats a row of a chunk tile
constexpr int kLoneSubPitch = 4 * kChainChunk + 4;
constexpr int kLoneArr = 2 * kLonePitch;           // floats an array's two channels

// A lone 4x effect's body.  The chunk's per-sample arrays: kIn inputs
// copied in (source(a, x)), kVals values computed ahead (prep; the
// compressor's last two kept by the walk, up).  A sample's element e points
// into array 0 of its channel; array a is at e[a * kLoneArr].  up_in / up:
// stage-1 up's input; shaper(c, e): a subsample's shaper; down_in / finish:
// the finish of a sample; begin_up / end_up and begin_finish / end_finish
// load and store what the stage-1 up lanes and the finish lanes carry
// besides the chain and the DC blocker (the compressor's gain, the
// feedback waveshaper's filter).
struct SatLone {
  static constexpr int kThreads = 320;   // five worker warps
  static constexpr int kIn = 1;     // x
  static constexpr int kVals = 3;   // the mix, the shaper's drive and bias
  const Phase& p;
  __device__ __forceinline__ const float* source(int, const float* x) const { return x; }
  __device__ __forceinline__ const float* packed() const { return p.in[2]; }
  __device__ __forceinline__ void prep(int c, int n, float* e) const {
    const SatShaper f = sat_shaper(p, c, n);
    e[kLoneArr] = sat_mix(p, c, n);
    e[2 * kLoneArr] = f.drive;
    e[3 * kLoneArr] = f.bias;
  }
  __device__ __forceinline__ float up_in(const float* e) const { return e[0]; }
  __device__ __forceinline__ float up(float in, float*) const { return in; }
  __device__ __forceinline__ SatShaper shaper(int, const float* e) const {
    return SatShaper{e[2 * kLoneArr], e[3 * kLoneArr]};
  }
  __device__ __forceinline__ float2 down_in(const float* e) const {
    return make_float2(e[0], e[kLoneArr]);
  }
  __device__ __forceinline__ float finish(FbwsState& s, float v, float2 in) const {
    return sat_finish(s, v, in.y, in.x);
  }
  __device__ __forceinline__ void begin_up(int) {}
  __device__ __forceinline__ void end_up(int c, int B) const { sat_end(p, c, B); }
  __device__ __forceinline__ void begin_finish(int) {}
  __device__ __forceinline__ void end_finish(int) const {}
};

struct CompLone {
  static constexpr int kThreads = 256;   // three worker warps
  static constexpr int kIn = 5;     // x, env, thr, ratio, mix
  static constexpr int kVals = 4;   // the bypass, the target gain, g, x*g
  const Phase& p;
  float g;
  struct Down {
    float xn, m, byp, g, xg;
  };
  __device__ __forceinline__ const float* source(int a, const float* x) const {
    return a == 0 ? x : p.in[a - 1];
  }
  __device__ __forceinline__ const float* packed() const { return p.in[4]; }
  __device__ __forceinline__ void prep(int, int, float* e) const {
    e[5 * kLoneArr] = comp_bypass(e[4 * kLoneArr]);
    e[6 * kLoneArr] = comp_target(p, e[kLoneArr], e[2 * kLoneArr], e[3 * kLoneArr]);
  }
  __device__ __forceinline__ float3 up_in(const float* e) const {
    return make_float3(e[0], e[5 * kLoneArr], e[6 * kLoneArr]);
  }
  __device__ __forceinline__ float up(float3 in, float* e) {
    g = comp_gain(g, in.y, in.z);
    const float compressed = in.x * g;
    e[7 * kLoneArr] = g;
    e[8 * kLoneArr] = compressed;
    return compressed;
  }
  __device__ __forceinline__ AtanShaper shaper(int, const float*) const {
    return AtanShaper{p.f[2]};
  }
  __device__ __forceinline__ Down down_in(const float* e) const {
    return Down{e[0], e[4 * kLoneArr], e[5 * kLoneArr], e[7 * kLoneArr], e[8 * kLoneArr]};
  }
  __device__ __forceinline__ float finish(FbwsState& s, float u, const Down& in) const {
    return comp_finish(s, u, in.byp, in.g, in.xg, in.xn, in.m);
  }
  __device__ __forceinline__ void begin_up(int c) { g = p.in[4][kFbwsRowsIn * 2 + c]; }
  __device__ __forceinline__ void end_up(int c, int) const {
    p.out[0][kFbwsRowsOut * 2 + c] = g;
  }
  __device__ __forceinline__ void begin_finish(int) {}
  __device__ __forceinline__ void end_finish(int) const {}
};

// The waveshaper: x up, each subsample through its channel's
// tanh(v*d)*comp (ws_shaper, once a thread: drive and mix are block
// scalars), the finish's mix, bypass select and finite guard.  It has no DC
// blocker: lone_finish loads the packed DC rows and stores them unchanged.
struct WsLone {
  static constexpr int kThreads = 256;   // the waveshaper: three worker warps
  static constexpr int kIn = 1;     // x
  static constexpr int kVals = 0;
  const Phase& p;
  DriveShaper sh0, sh1;   // each channel's shaper
  float mix;              // the finish lane's channel's
  bool bypass;
  __device__ explicit WsLone(const Phase& p_)
      : p(p_), sh0(ws_shaper(p_, 0)), sh1(ws_shaper(p_, 1)), mix(0.0f), bypass(false) {}
  __device__ __forceinline__ const float* source(int, const float* x) const { return x; }
  __device__ __forceinline__ const float* packed() const { return p.in[1]; }
  __device__ __forceinline__ void prep(int, int, float*) const {}
  __device__ __forceinline__ float up_in(const float* e) const { return e[0]; }
  __device__ __forceinline__ float up(float in, float*) const { return in; }
  __device__ __forceinline__ DriveShaper shaper(int c, const float*) const {
    return c ? sh1 : sh0;
  }
  __device__ __forceinline__ float down_in(const float* e) const { return e[0]; }
  __device__ __forceinline__ float finish(FbwsState&, float v, float xn) const {
    return ws_finish(v, xn, mix, bypass);
  }
  __device__ __forceinline__ void begin_up(int) {}
  __device__ __forceinline__ void end_up(int, int) const {}
  __device__ __forceinline__ void begin_finish(int c) {
    mix = p.in[0][2 * c + 1];
    bypass = ws_bypass(p, c);
  }
  __device__ __forceinline__ void end_finish(int) const {}
};

// The feedback waveshaper's zero-feedback path: drive*x up (computed ahead
// with the DC blocker's gain on the envelope, fbws_cs, on each channel's
// makeup, fbws_makeup, once a thread), tanh at each subsample, the
// finish's gated DC blocker, the feedback filter carried on the finish lane
// (loaded and stored, flushed, by begin_finish and end_finish) and the mix.
struct FbwsLone {
  static constexpr int kThreads = 256;   // the feedback waveshaper: three worker warps
  static constexpr int kIn = 2;     // x, env
  static constexpr int kVals = 2;   // drive*x, the DC blocker's gain (-1: bypassed)
  const Phase& p;
  float mk0, mk1;         // each channel's makeup
  float fbc, mix, filt;   // the finish lane's channel's
  bool bypass;
  struct Down {
    float xn, cs;
  };
  __device__ explicit FbwsLone(const Phase& p_)
      : p(p_), mk0(fbws_makeup(p_, p_.in[1])), mk1(fbws_makeup(p_, p_.in[1] + 4)), fbc(0.0f),
        mix(0.0f), filt(0.0f), bypass(false) {}
  __device__ __forceinline__ const float* source(int a, const float* x) const {
    return a == 0 ? x : p.in[0];
  }
  __device__ __forceinline__ const float* packed() const { return p.in[2]; }
  __device__ __forceinline__ void prep(int c, int, float* e) const {
    const float* prm = p.in[1] + 4 * c;
    e[2 * kLoneArr] = e[0] * prm[0];
    e[3 * kLoneArr] = fbws_cs(prm, e[kLoneArr], c ? mk1 : mk0);
  }
  __device__ __forceinline__ float up_in(const float* e) const { return e[2 * kLoneArr]; }
  __device__ __forceinline__ float up(float in, float*) const { return in; }
  __device__ __forceinline__ TanhShaper shaper(int, const float*) const { return TanhShaper{}; }
  __device__ __forceinline__ Down down_in(const float* e) const {
    return Down{e[0], e[3 * kLoneArr]};
  }
  __device__ __forceinline__ float finish(FbwsState& s, float v, const Down& in) {
    const float dc = gated_dc(s, v, in.cs);
    filt = fbws_filter(filt, bypass, fbc, dc);
    return fbws_out(in.xn, dc, mix, bypass);
  }
  __device__ __forceinline__ void begin_up(int) {}
  __device__ __forceinline__ void end_up(int, int) const {}
  __device__ __forceinline__ void begin_finish(int c) {
    const float* prm = p.in[1] + 4 * c;
    fbc = prm[2];
    mix = prm[3];
    bypass = fbws_bypass(prm);
    filt = p.in[2][kFbwsRowsIn * 2 + c];
  }
  __device__ __forceinline__ void end_finish(int c) const {
    p.out[0][kFbwsRowsOut * 2 + c] = flushed(filt);
  }
};

// Samples [0, len) of a chunk through step(i, in, last), in = load(i),
// four at a time with their loads first (so that their chains overlap); the
// block's last sample (last: true) peeled, for its captures.
template <class Load, class Step>
__device__ __forceinline__ void walk_chunk(int len, bool has_last, const Load& load,
                                           const Step& step) {
  using In = decltype(load(0));
  const int stop = has_last ? len - 1 : len;
  int i = 0;
  for (; i + kOvsGroup <= stop; i += kOvsGroup) {
    In in[kOvsGroup];
#pragma unroll
    for (int j = 0; j < kOvsGroup; ++j) in[j] = load(i + j);
#pragma unroll
    for (int j = 0; j < kOvsGroup; ++j) step(i + j, in[j], false);
  }
  for (; i < stop; ++i) step(i, load(i), false);
  if (has_last) step(stop, load(stop), true);
}

// The shared memory of a lone 4x kernel: the ring of chunks' inputs and
// values ([kLoneRing][arrays][2 ch][pitch]); the tiles between the walks,
// two chunks each: stage-1 up's outputs e1, o1 ([branch][ch][pitch]),
// stage-2 down's ([branch][first, second][ch][pitch]: what stage-1 down's
// lanes sum), stage-1 down's ([branch][ch][pitch]); the subsample tiles
// ([kLoneSubRing][ch][sub pitch]); the output tiles ([ch][pitch]).
template <class Body>
struct LoneTiles {
  static constexpr int kSlot = (Body::kIn + Body::kVals) * kLoneArr;
  static constexpr int kRing = kLoneRing * kSlot;
  static constexpr int kUp = kRing, kDown = kUp + 2 * 2 * kLoneArr;
  static constexpr int kEnds = kDown + 2 * 4 * kLoneArr, kOut = kEnds + 2 * 2 * kLoneArr;
  static constexpr int kSub = kOut + 2 * kLoneArr;
  static constexpr int kFloats = kSub + kLoneSubRing * 2 * kLoneSubPitch;
  float* smem;
  int B, n_chunks;
  __device__ LoneTiles(float* smem_, int B_)
      : smem(smem_), B(B_), n_chunks((B_ + kChainChunk - 1) / kChainChunk) {}
  __device__ int len(int j) const { return min(kChainChunk, B - j * kChainChunk); }
  __device__ float* slot(int j) const { return smem + (j % kLoneRing) * kSlot; }
  // stage-1 up's output of branch b (e1: 0, o1: 1), channel c
  __device__ float* up(int j, int b, int c) const {
    return smem + kUp + (j & 1) * 2 * kLoneArr + b * kLoneArr + c * kLonePitch;
  }
  // stage-2 down's output of branch b, its first or second (r) of a sample
  __device__ float* down(int j, int b, int r, int c) const {
    return smem + kDown + (j & 1) * 4 * kLoneArr + (2 * b + r) * kLoneArr + c * kLonePitch;
  }
  // stage-1 down's output of branch b
  __device__ float* ends(int j, int b, int c) const {
    return smem + kEnds + (j & 1) * 2 * kLoneArr + b * kLoneArr + c * kLonePitch;
  }
  __device__ float* out(int j, int c) const {
    return smem + kOut + (j & 1) * kLoneArr + c * kLonePitch;
  }
  __device__ float* sub(int j, int c) const {
    return smem + kSub + ((j % kLoneSubRing) * 2 + c) * kLoneSubPitch;
  }
};

// One polyphase branch of a stage: its N sections' output and input
// memories, in the packed layout at row r0 + 2N * branch (y) and N rows on
// (x); the stages' first rows and their captures' (ovs4.cuh).
template <int N>
struct BranchState {
  float y[N], x[N];
  __device__ __forceinline__ void load(const float* st, int r0, int b, int c) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      y[j] = st[(r0 + 2 * N * b + j) * 2 + c];
      x[j] = st[(r0 + 2 * N * b + N + j) * 2 + c];
    }
  }
  __device__ __forceinline__ void store(float* st, int r0, int b, int c) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      st[(r0 + 2 * N * b + j) * 2 + c] = y[j];
      st[(r0 + 2 * N * b + N + j) * 2 + c] = x[j];
    }
  }
  __device__ __forceinline__ float step(float u, const float (&a)[N]) { return ap_chain(u, y, x, a); }
};

__device__ __forceinline__ constexpr int stage_rows(int stage) {
  return stage == 0 ? 0 : stage == 1 ? kPackedUp2Rows : stage == 2 ? kPackedUpRows : kPackedDown1Rows;
}
__device__ __forceinline__ constexpr int stage_caps(int stage) {
  return stage == 0   ? kPackedCoreRows
         : stage == 1 ? kPackedUp2Caps
         : stage == 2 ? kPackedDownCaps
                      : kPackedDown1Caps;
}
constexpr int kRowD2x1d = kPackedDown1Rows - 1;   // stage-2 down's delayed input
constexpr int kRowD1x1d = kPackedDown1Rows + 16;  // stage-1 down's
constexpr int kRowDc = kRowD1x1d + 1;             // dcx, dcy

// The steps of a walk: every thread of the block meets at each step's
// barrier; on the walk's lanes (`on`), walk(q) runs chunk q, `lag` steps
// behind the up-walk.
template <class Walk>
__device__ __forceinline__ void lone_steps(int n_chunks, int lag, bool on, const Walk& walk) {
  step_barrier();   // the workers' first chunk
  for (int j = 0; j < n_chunks + kLagFinish; ++j) {
    step_barrier();   // step j-1 done everywhere
    const int q = j - lag;
    if (on && q >= 0 && q < n_chunks) walk(q);
  }
  step_barrier();   // the last output tile is done
}

// Stage `kStage` of the chain (0: stage-1 up, 1: stage-2 up, 2: stage-2
// down, 3: stage-1 down) on lanes 0-3 of its warp: branch b = lane / 2 of
// channel c = lane % 2, its sections' memories in registers; for branch 1
// of the down stages also the delayed input (the previous sample's second
// value).  Every thread of the block meets at each step's barrier.
template <int kStage, class Body>
__device__ __forceinline__ void lone_stage(Body& body, const LoneTiles<Body>& t,
                                           const FbwsCoefs& k, float* st_out, int lane) {
  constexpr int N = kStage == 0 || kStage == 3 ? 4 : 2;
  const bool on = lane < 4;
  const int c = lane & 1, b = (lane >> 1) & 1;
  BranchState<N> s, cap;
  float a[N];
  float carry = 0.0f;   // branch 1's delayed input (the down stages)
  const int carry_row = kStage == 2 ? kRowD2x1d : kRowD1x1d;
  if (on) {
    const float* st_in = body.packed();
    s.load(st_in, stage_rows(kStage), b, c);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if constexpr (N == 4) {
        a[j] = b ? k.c1_1[j] : k.c1_0[j];
      } else {
        a[j] = b ? k.c2_1[j] : k.c2_0[j];
      }
    }
    if (kStage >= 2 && b == 1) carry = st_in[carry_row * 2 + c];
    if (kStage == 0) body.begin_up(c);
  }
  lone_steps(t.n_chunks, lone_lag(kStage), on, [&](int q) {
    float* e = t.slot(q) + c * kLonePitch;
    const float* sub = t.sub(q, c);
    if constexpr (kStage == 0) {
      // x (or x*g) -> e1 (branch 0) or o1 (branch 1)
      float* out = t.up(q, b, c);
      walk_chunk(
          t.len(q), q == t.n_chunks - 1, [&](int i) { return body.up_in(e + i); },
          [&](int i, auto in, bool last) {
            const float u = body.up(in, e + i);
            if (last) cap = s;
            out[i] = s.step(u, a);
          });
    } else if constexpr (kStage == 1) {
      // e1, o1 -> subsamples b and 2 + b
      const float* e1 = t.up(q, 0, c);
      const float* o1 = t.up(q, 1, c);
      float* out = t.sub(q, c) + b;
      walk_chunk(
          t.len(q), q == t.n_chunks - 1, [&](int i) { return make_float2(e1[i], o1[i]); },
          [&](int i, float2 in, bool last) {
            out[4 * i] = s.step(in.x, a);
            if (last) cap = s;
            out[4 * i + 2] = s.step(in.y, a);
          });
    } else if constexpr (kStage == 2) {
      // branch 0: q0, q2; branch 1: the previous q3, q1 (q3 carried on)
      const float* qa = sub + (b ? 3 : 0);
      const float* qb = sub + (b ? 1 : 2);
      float* first = t.down(q, b, 0, c);
      float* second = t.down(q, b, 1, c);
      walk_chunk(
          t.len(q), q == t.n_chunks - 1,
          [&](int i) { return make_float2(qa[4 * i], qb[4 * i]); },
          [&](int i, float2 in, bool last) {
            const float u = b ? carry : in.x;
            carry = in.x;
            first[i] = s.step(u, a);
            if (last) cap = s;
            second[i] = s.step(in.y, a);
          });
    } else {
      // branch 0: d0 = (a0 + a1) / 2; branch 1: the previous d1 (d1 =
      // (b0 + b1) / 2 carried on)
      const float* p0 = t.down(q, 0, b, c);
      const float* p1 = t.down(q, 1, b, c);
      float* out = t.ends(q, b, c);
      walk_chunk(
          t.len(q), q == t.n_chunks - 1, [&](int i) { return make_float2(p0[i], p1[i]); },
          [&](int i, float2 in, bool last) {
            const float d = 0.5f * (in.x + in.y);
            const float u = b ? carry : d;
            carry = d;
            if (last) cap = s;
            out[i] = s.step(u, a);
          });
    }
  });
  if (!on) return;
  s.store(st_out, stage_rows(kStage), b, c);
  cap.store(st_out, stage_caps(kStage), b, c);
  if (kStage >= 2 && b == 1) st_out[carry_row * 2 + c] = carry;
  if (kStage == 0 && b == 0) body.end_up(c, t.B);
}

// A finish's inputs of a sample: stage-1 down's branches' outputs and what
// the body's finish reads.
template <class R>
struct FinishIn {
  float e0, e1;
  R r;
};

// The finish on lanes 0 and 1 (channel c): stage-1 down's half-sum, then
// the body's finish (the gated DC blocker, the mix, the finite select; the
// feedback waveshaper's filter) into the output tile.  The DC rows are
// loaded and stored here whether the body steps them or not, and the body's
// own carried values by its begin_finish and end_finish.
template <class Body>
__device__ __forceinline__ void lone_finish(Body& body, const LoneTiles<Body>& t,
                                            float* st_out, int lane) {
  const bool on = lane < 2;
  const int c = lane & 1;
  FbwsState st;
  if (on) {
    st.dcx = body.packed()[kRowDc * 2 + c];
    st.dcy = body.packed()[(kRowDc + 1) * 2 + c];
    body.begin_finish(c);
  }
  lone_steps(t.n_chunks, kLagFinish, on, [&](int q) {
    const float* e = t.slot(q) + c * kLonePitch;
    const float* e0 = t.ends(q, 0, c);
    const float* e1 = t.ends(q, 1, c);
    float* out = t.out(q, c);
    walk_chunk(
        t.len(q), false,
        [&](int i) {
          return FinishIn<decltype(body.down_in(e))>{e0[i], e1[i], body.down_in(e + i)};
        },
        [&](int i, auto in, bool) { out[i] = body.finish(st, 0.5f * (in.e0 + in.e1), in.r); });
  });
  if (!on) return;
  st_out[kRowDc * 2 + c] = st.dcx;
  st_out[(kRowDc + 1) * 2 + c] = st.dcy;
  body.end_finish(c);
}

// The workers (thread w of kWorkers): at step j, chunk j+2's inputs in
// with cp.async, chunk j+1's values, chunk j - kLagShape's subsamples
// shaped in place, the output tile of the chunk finished a step before
// stored.
template <class Body>
__device__ __forceinline__ void lone_workers(const Body& body, const LoneTiles<Body>& t,
                                             const float* x, float* y, int w) {
  constexpr int kWorkers = Body::kThreads - 32 * kLoneWalks;
  const int n_chunks = t.n_chunks, B = t.B;
  // chunk j's inputs into its slot (a group committed even past the last
  // chunk, so that every wait below finds the chunk before it landed)
  const auto copy_in = [&](int j) {
    if (j < n_chunks) {
      const int n0 = j * kChainChunk, l = t.len(j);
      float* sl = t.slot(j);
      for (int u = w; u < Body::kIn * 2 * l; u += kWorkers) {
        const int a = u / (2 * l), r = u - a * 2 * l;
        const int ch = r >= l ? 1 : 0, i = r - l * ch;
        cp_async4(sl + a * kLoneArr + ch * kLonePitch + i,
                  body.source(a, x) + static_cast<size_t>(ch) * B + n0 + i);
      }
    }
    cp_async_commit();
  };
  const auto prep = [&](int j) {
    if (j >= n_chunks) return;
    const int n0 = j * kChainChunk, l = t.len(j);
    float* sl = t.slot(j);
    for (int u = w; u < 2 * l; u += kWorkers) {
      int ch, i;
      both_channels(u, l, ch, i);
      body.prep(ch, n0 + i, sl + ch * kLonePitch + i);
    }
  };
  const auto shape = [&](int q) {
    if (q < 0 || q >= n_chunks) return;
    const int l = t.len(q);
    const float* sl = t.slot(q);
    for (int u = w; u < 8 * l; u += kWorkers) {
      int ch, i;
      both_channels(u, 4 * l, ch, i);
      float& v = t.sub(q, ch)[i];
      v = body.shaper(ch, sl + ch * kLonePitch + (i >> 2))(v);
    }
  };
  const auto store_out = [&](int o) {
    const int l = t.len(o);
    for (int u = w; u < 2 * l; u += kWorkers) {
      int ch, i;
      both_channels(u, l, ch, i);
      y[static_cast<size_t>(ch) * B + o * kChainChunk + i] = t.out(o, ch)[i];
    }
  };
  copy_in(0);
  copy_in(1);
  cp_async_wait<0>();
  step_barrier();
  prep(0);
  for (int j = 0; j < n_chunks + kLagFinish; ++j) {
    cp_async_wait<0>();   // chunk j+1 has landed (this worker's part)
    step_barrier();        // ... all of it; step j-1 done everywhere
    copy_in(j + 2);
    prep(j + 1);
    shape(j - kLagShape);
    if (j > kLagFinish) store_out(j - kLagFinish - 1);
  }
  step_barrier();
  store_out(n_chunks - 1);
}

template <class Body>
__global__ void __launch_bounds__(Body::kThreads)
    bus4x_split_kernel(const float* __restrict__ x, float* __restrict__ y, Phase p,
                       FbwsCoefs k, int B) {
  extern __shared__ float4 lone_smem4[];
  const LoneTiles<Body> t(reinterpret_cast<float*>(lone_smem4), B);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Body body{p};
  switch (warp) {
    case 0:
      lone_stage<0>(body, t, k, p.out[0], lane);
      break;
    case 1:
      lone_stage<1>(body, t, k, p.out[0], lane);
      break;
    case 2:
      lone_stage<2>(body, t, k, p.out[0], lane);
      break;
    case 3:
      lone_stage<3>(body, t, k, p.out[0], lane);
      break;
    case 4:
      lone_finish(body, t, p.out[0], lane);
      break;
    default:
      lone_workers(body, t, x, y, threadIdx.x - 32 * kLoneWalks);
  }
}

template <class Body>
constexpr size_t lone_smem_bytes() {
  return static_cast<size_t>(LoneTiles<Body>::kFloats) * sizeof(float);
}

// --- the lone detector and spring: env_follower_block and spring_block -------
//
// A lone detector (a sidechained compressor's, the unmerged bus's) and a lone
// spring keep their channels' walks serial, one lane a channel on warps of
// their own, and move everything else off the walk onto the rest of the
// block.
//
// env_lone_kernel: 128 threads, the block in 64-sample chunks a step apart.
// At step j, lane 0 of warp c walks chunk j of channel c; warps 2 and 3 copy
// chunk j+3's x, att, rel and byp in with cp.async (16 bytes a copy where
// B % 4 == 0 and every array is 16-byte aligned, else 4), compute chunk
// j+1's values that do not depend on the carried envelope (env_values),
// store chunk j+1's y = x, and store chunk j-1's envelope from its tile,
// coalesced.  The walk (env_step) keeps a multiply, an add, a select and the
// flush's compare and select on its chain.
//
// spring_lone_kernel: 256 threads fill the rings from the history
// (cp.async, 16 bytes a copy where the history is 16-byte aligned: 12 x D
// floats, a multiple of four), then walk the block in parts of P = the
// shortest lag (at most kSpringPart) samples, in order, since part k+1 reads
// what part k wrote: (a) a thread a (channel, sample) does the six ring
// reads, beta and bv = p2*(alpha*xe + beta); (b) lane 0 of warp c walks
// channel c's d = A*d + bv and keeps each sample's d_prev, while the other
// warps copy the five trajectories (x, A, p2, fbgp, mix) of part k+2 in (16
// bytes a copy where B % 4 == 0 and the arrays are 16-byte aligned, from
// the part's first sample rounded down to a multiple of 4; else 4); (c) a
// thread a (channel, sample) runs the six allpass writes and the mix and
// stores y, coalesced.  The trajectories' tiles hold kSpringPart samples,
// so shared memory stays 12 x D floats and ~24 KB, whatever B.  Then the
// whole block drains the rotated rings.

constexpr int kEnvThreads = 128;   // warps 0 and 1 walk, warps 2 and 3 work
constexpr int kEnvWalkers = 64;
constexpr int kEnvWorkers = kEnvThreads - kEnvWalkers;
constexpr int kEnvChunk = 64;
constexpr int kEnvPitch = kEnvChunk + 4;   // floats a row of a chunk tile
constexpr int kEnvArr = 2 * kEnvPitch;     // floats an array's two channels
constexpr int kEnvIn = 4;                  // x, att, rel, byp
constexpr int kEnvVals = 5;                // r, c_a, (1 - c_a)*r, c_r, (1 - c_r)*r
constexpr int kEnvRing = 4;                // input chunks (copied j+3, prepared j+1)

// The detector's tiles: the inputs' ring ([kEnvRing][kEnvIn][2 ch][pitch]),
// the values ([2][kEnvVals][2 ch][pitch]) and the envelope's output
// ([2][2 ch][pitch]), chunks alternating.
struct EnvTiles {
  static constexpr int kVals = kEnvRing * kEnvIn * kEnvArr;
  static constexpr int kOut = kVals + 2 * kEnvVals * kEnvArr;
  static constexpr int kFloats = kOut + 2 * kEnvArr;
  float* smem;
  int B, n_chunks;
  __device__ EnvTiles(float* smem_, int B_)
      : smem(smem_), B(B_), n_chunks((B_ + kEnvChunk - 1) / kEnvChunk) {}
  __device__ int len(int j) const { return min(kEnvChunk, B - j * kEnvChunk); }
  __device__ float* in(int j, int a, int c) const {
    return smem + ((j % kEnvRing) * kEnvIn + a) * kEnvArr + c * kEnvPitch;
  }
  __device__ float* val(int j, int v, int c) const {
    return smem + kVals + ((j & 1) * kEnvVals + v) * kEnvArr + c * kEnvPitch;
  }
  __device__ float* out(int j, int c) const {
    return smem + kOut + (j & 1) * kEnvArr + c * kEnvPitch;
  }
};

// A group of four samples' values, as the walk loads them.
struct EnvGroup {
  float4 r, ca, pa, cr, pr;
};

// Lane 0 of warp c: channel c's walk through chunk j, four samples at a
// time, each group's values loaded a group ahead, before the group ahead of
// them stores its envelope (the compiler does not move a shared load past
// a shared store).  A load past the chunk stays inside the tiles and is not
// used.
__device__ __forceinline__ void env_walk(const EnvTiles& t, int j, int c, float& env) {
  const float* r = t.val(j, 0, c);
  const float* ca = t.val(j, 1, c);
  const float* pa = t.val(j, 2, c);
  const float* cr = t.val(j, 3, c);
  const float* pr = t.val(j, 4, c);
  float* out = t.out(j, c);
  const int len = t.len(j);
  const auto load = [&](int i) {
    return EnvGroup{ld4(r + i), ld4(ca + i), ld4(pa + i), ld4(cr + i), ld4(pr + i)};
  };
  EnvGroup g = load(0);
  const auto group = [&](int i) {
    const EnvGroup next = load(i + 4);
    float4 o;
    o.x = env_step(env, g.r.x, g.ca.x, g.pa.x, g.cr.x, g.pr.x);
    o.y = env_step(env, g.r.y, g.ca.y, g.pa.y, g.cr.y, g.pr.y);
    o.z = env_step(env, g.r.z, g.ca.z, g.pa.z, g.cr.z, g.pr.z);
    o.w = env_step(env, g.r.w, g.ca.w, g.pa.w, g.cr.w, g.pr.w);
    st4(out + i, o);
    g = next;
  };
  if (len == kEnvChunk) {
#pragma unroll
    for (int i = 0; i < kEnvChunk; i += 4) group(i);
  } else {
    int i = 0;
    for (; i + 4 <= len; i += 4) group(i);
    for (; i < len; ++i) out[i] = env_step(env, r[i], ca[i], pa[i], cr[i], pr[i]);
  }
}

__global__ void __launch_bounds__(kEnvThreads)
    env_lone_kernel(const float* __restrict__ x, float* __restrict__ y, Phase p, int B, int vec) {
  extern __shared__ float4 env_smem4[];
  const EnvTiles t(reinterpret_cast<float*>(env_smem4), B);
  const int tid = threadIdx.x;
  const int n_chunks = t.n_chunks;
  if (tid < kEnvWalkers) {
    const int c = tid >> 5;
    const bool walker = (tid & 31) == 0;
    float env = walker ? p.in[3][c] : 0.0f;
    step_barrier();   // chunk 0's inputs landed
    for (int j = 0; j <= n_chunks; ++j) {
      step_barrier();   // chunk j's values ready; walk j-1 stored
      if (walker && j < n_chunks) env_walk(t, j, c, env);
    }
    if (walker) p.out[1][c] = env;
    return;
  }
  // the workers
  const int w = tid - kEnvWalkers;
  const int width = vec ? 4 : 1;
  const auto copy_in = [&](int j) {
    if (j < n_chunks) {
      const int n0 = j * kEnvChunk, units = vec ? t.len(j) >> 2 : t.len(j);
#pragma unroll
      for (int a = 0; a < kEnvIn; ++a) {
        const float* src = a == 0 ? x : p.in[a - 1];
        for (int u = w; u < 2 * units; u += kEnvWorkers) {
          int ch, i;
          both_channels(u, units, ch, i);
          float* d = t.in(j, a, ch) + width * i;
          const float* g = src + static_cast<size_t>(ch) * B + n0 + width * i;
          if (vec) {
            cp_async16(d, g);
          } else {
            cp_async4(d, g);
          }
        }
      }
    }
    cp_async_commit();
  };
  // chunk j of a tile (row(ch): channel ch's row) to the [2, B] array dst,
  // coalesced
  const auto store = [&](float* dst, int j, const auto& row) {
    const int n0 = j * kEnvChunk, units = vec ? t.len(j) >> 2 : t.len(j);
    for (int u = w; u < 2 * units; u += kEnvWorkers) {
      int ch, i;
      both_channels(u, units, ch, i);
      float* g = dst + static_cast<size_t>(ch) * B + n0 + width * i;
      const float* s = row(ch) + width * i;
      if (vec) {
        st4(g, ld4(s));
      } else {
        *g = *s;
      }
    }
  };
  // chunk j's values, and its y = x
  const auto prep = [&](int j) {
    if (j >= n_chunks) return;
    const int l = t.len(j);
    for (int u = w; u < 2 * l; u += kEnvWorkers) {
      int ch, i;
      both_channels(u, l, ch, i);
      const EnvVals v = env_values(t.in(j, 0, ch)[i], t.in(j, 1, ch)[i], t.in(j, 2, ch)[i],
                                   t.in(j, 3, ch)[i]);
      t.val(j, 0, ch)[i] = v.r;
      t.val(j, 1, ch)[i] = v.ca;
      t.val(j, 2, ch)[i] = v.pa;
      t.val(j, 3, ch)[i] = v.cr;
      t.val(j, 4, ch)[i] = v.pr;
    }
    store(y, j, [&](int ch) { return t.in(j, 0, ch); });
  };
  copy_in(0);
  copy_in(1);
  copy_in(2);
  cp_async_wait<2>();
  step_barrier();
  prep(0);
  for (int j = 0; j <= n_chunks; ++j) {
    cp_async_wait<1>();   // chunk j+1 has landed (this worker's part)
    step_barrier();       // ... all of it; chunk j's values ready; walk j-1 done
    copy_in(j + 3);
    prep(j + 1);
    if (j > 0) store(p.out[0], j - 1, [&](int ch) { return t.out(j - 1, ch); });
  }
}

constexpr int kSpringThreads = 256;   // warps 0 and 1 walk, all run the parts' steps
constexpr int kSpringWalkers = 64;
constexpr int kSpringPart = 128;                // samples a part at most
constexpr int kSpringPitch = kSpringPart + 4;   // floats a trajectory tile's row
constexpr int kSpringTraj = 5;                  // x, A, p2, fbgp, mix
constexpr int kSpringTiles = 3;                 // parts' trajectories in flight (k, k+1, k+2)

// The lone spring's shared memory after its rings (12 x D floats): the
// trajectories of three parts ([kSpringTiles][kSpringTraj][2 ch]
// [kSpringPitch]: a part's samples from offset o, its first sample % 4
// where the copies take 16 bytes, else 0), a part's ring reads ([2 ch][6]
// [kSpringPart]), its bv and its d_prev ([2 ch][kSpringPart] each).
constexpr int kSpringTrajTile = kSpringTraj * 2 * kSpringPitch;
constexpr int kSpringLoneScratch =
    kSpringTiles * kSpringTrajTile + 2 * (kSpringAps + 2) * kSpringPart;

__host__ __device__ __forceinline__ size_t spring_lone_smem_bytes(int D) {
  return spring_ring_bytes(D) + kSpringLoneScratch * sizeof(float);
}

// The lone spring's part: the shortest lag, at most kSpringPart samples.
inline int spring_part(const Phase& p) {
  int min_lag = p.iv[2 * kSpringAps];
  for (int j = 0; j < 2 * kSpringAps; ++j) min_lag = p.iv[j] < min_lag ? p.iv[j] : min_lag;
  return min_lag < kSpringPart ? min_lag : kSpringPart;
}

// Four floats from shared memory at any float offset.
__device__ __forceinline__ float4 ld4u(const float* q) {
  return make_float4(q[0], q[1], q[2], q[3]);
}

__global__ void __launch_bounds__(kSpringThreads)
    spring_lone_kernel(const float* __restrict__ x, float* __restrict__ y, Phase p, int B, int P,
                       int vec_hist, int vec_traj) {
  extern __shared__ float4 spring_smem4[];
  float* rings = reinterpret_cast<float*>(spring_smem4);
  const int D = p.iv[2 * kSpringAps];
  float* traj = rings + 2 * kSpringAps * D;      // 12 * D: a multiple of 4
  float* rd = traj + kSpringTiles * kSpringTrajTile;   // [2 ch][6][part]
  float* bv = rd + 2 * kSpringAps * kSpringPart;  // [2 ch][part]
  float* dprev = bv + 2 * kSpringPart;            // [2 ch][part]
  const int tid = threadIdx.x;
  const float alpha = p.f[2 * kSpringAps];
  const int n_parts = (B + P - 1) / P;
  // sample i of part k's trajectory a of channel c: tile(k, a, c)[off(k) + i]
  const auto tile = [&](int k, int a, int c) {
    return traj + (k % kSpringTiles) * kSpringTrajTile + (a * 2 + c) * kSpringPitch;
  };
  const auto off = [&](int k) { return vec_traj ? (k * P) & 3 : 0; };
  // part k's trajectories, copied by the threads that do not walk (one
  // copy group on every thread, so that every wait counts the same groups):
  // 16 bytes a copy from the part's first sample rounded down to a multiple
  // of 4 where B % 4 == 0 and the five arrays are 16-byte aligned, else 4
  const auto copy_part = [&](int k) {
    if (k < n_parts && tid >= kSpringWalkers) {
      const int s0 = k * P, len = min(P, B - s0);
      const int o = off(k), w = vec_traj ? 4 : 1;
      const int units = vec_traj ? (o + len + 3) >> 2 : len;
#pragma unroll
      for (int a = 0; a < kSpringTraj; ++a) {
        // x, A (in[0]), p2 (in[1]), fbgp (in[2]), mix (in[5])
        const float* src = a == 0 ? x : p.in[a == 4 ? 5 : a - 1];
        for (int u = tid - kSpringWalkers; u < 2 * units; u += kSpringThreads - kSpringWalkers) {
          int c, i;
          both_channels(u, units, c, i);
          float* d = tile(k, a, c) + w * i;
          const float* g = src + static_cast<size_t>(c) * B + s0 - o + w * i;
          if (vec_traj) {
            cp_async16(d, g);
          } else {
            cp_async4(d, g);
          }
        }
      }
    }
    cp_async_commit();
  };
  // the fill, with part 0's trajectories in the same group
  const float* hist = p.in[3];
  const int n_hist = 2 * kSpringAps * D;
  if (vec_hist) {
    for (int u = tid; u < n_hist / 4; u += kSpringThreads) cp_async16(rings + 4 * u, hist + 4 * u);
  } else {
    for (int u = tid; u < n_hist; u += kSpringThreads) cp_async4(rings + u, hist + u);
  }
  copy_part(0);
  copy_part(1);
  const int walker = (tid & 31) == 0 && tid < kSpringWalkers ? tid >> 5 : -1;
  float d = walker >= 0 ? p.in[4][walker] : 0.0f;
  for (int k = 0; k < n_parts; ++k) {
    const int s0 = k * P, len = min(P, B - s0), o = off(k);
    const int w0 = s0 % D;
    cp_async_wait<1>();   // part k's trajectories (and the fill) landed
    __syncthreads();      // ... everywhere; part k-1's writes done
    // (a) the ring reads, beta and bv, a thread a (channel, sample)
    for (int u = tid; u < 2 * len; u += kSpringThreads) {
      int c, i;
      both_channels(u, len, c, i);
      int w = w0 + i;
      w -= w >= D ? D : 0;
      const float beta = spring_reads(p, rings, c, w, D, rd + c * kSpringAps * kSpringPart + i,
                                      kSpringPart);
      const float xe = spring_xe(p, c, s0 + i, tile(k, 0, c)[o + i]);
      bv[c * kSpringPart + i] = spring_input(tile(k, 2, c)[o + i], alpha, xe, beta);
    }
    __syncthreads();
    // (b) the damping loop, lane 0 of warps 0 and 1, four samples at a
    //     time, each group's A and bv loaded two groups ahead (before the
    //     stores of the two groups ahead of them; past the part they stay
    //     inside shared memory and are not used); meanwhile the other
    //     warps copy part k+2's trajectories into part k-1's tiles
    copy_part(k + 2);
    if (walker >= 0) {
      const float* A = tile(k, 1, walker) + o;
      const float* b = bv + walker * kSpringPart;
      float* dp = dprev + walker * kSpringPart;
      float4 a0 = ld4u(A), b0 = ld4(b), a1 = ld4u(A + 4), b1 = ld4(b + 4);
      int i = 0;
#pragma unroll 4
      for (; i + 4 <= len; i += 4) {
        const float4 a2 = ld4u(A + i + 8), b2 = ld4(b + i + 8);
        float4 q;
        q.x = d;
        d = a0.x * d + b0.x;
        q.y = d;
        d = a0.y * d + b0.y;
        q.z = d;
        d = a0.z * d + b0.z;
        q.w = d;
        d = a0.w * d + b0.w;
        st4(dp + i, q);
        a0 = a1;
        b0 = b1;
        a1 = a2;
        b1 = b2;
      }
      for (; i < len; ++i) {
        dp[i] = d;
        d = A[i] * d + b[i];
      }
    }
    __syncthreads();
    // (c) the allpass writes and the mix, a thread a (channel, sample)
    for (int u = tid; u < 2 * len; u += kSpringThreads) {
      int c, i;
      both_channels(u, len, c, i);
      const int n = s0 + i;
      int w = w0 + i;
      w -= w >= D ? D : 0;
      const float xn = tile(k, 0, c)[o + i];
      const float sig = spring_xe(p, c, n, xn) + tile(k, 3, c)[o + i] * dprev[c * kSpringPart + i];
      const float wet = spring_writes(p, rings, c, w, D, sig,
                                      rd + c * kSpringAps * kSpringPart + i, kSpringPart);
      y[static_cast<size_t>(c) * B + n] = spring_mix(xn, wet, tile(k, 4, c)[o + i]);
    }
  }
  __syncthreads();
  if (walker >= 0) p.out[1][walker] = d;
  // the drain: hist'[j][m] = the ring's value m samples after B - D
  const int wB = B % D;
  for (int j = 0; j < 2 * kSpringAps; ++j) {
    const float* r = rings + static_cast<size_t>(j) * D;
    float* out = p.out[0] + static_cast<size_t>(j) * D;
    for (int m = tid; m < D; m += kSpringThreads) {
      int k = wB + m;
      k -= k >= D ? D : 0;
      out[m] = r[k];
    }
  }
}

// --- the lone walks: lowpass_block, tilt_block and delay_block ---------------
//
// walk_lone_kernel<Body>: a lone effect whose serial work is one short
// recurrence a channel, laid out as env_lone_kernel: Body::kThreads
// threads, the block in chunks of Body::kChunk samples a step apart.  At
// step j, lane 0 of warp c walks chunk j of channel c (Body::step, the
// carried state in registers), four samples at a time, each group's values
// loaded from shared memory a group ahead, and writes its outputs to a tile;
// the other warps (the workers) copy chunk j+3's inputs into a ring slot
// with cp.async (16 bytes a copy where B % 4 == 0 and every array the
// kernel reads or writes is 16-byte aligned, else 4), compute chunk j+1's
// values that do not depend on the carried state into the same slot
// (Body::prep), and finish chunk j-1 from its slot and the walks' tile
// (Body::finish: what a sample's outputs take besides the walk, which may
// read the other channel's walk), storing them coalesced.  One barrier a
// step, n_chunks + 1 steps.  A slot lives from its copy (step j-3) to its
// finish (step j+1): a ring of kWalkRing.  Every per-channel operation
// keeps the plain version's order, so the kernel gives bus_chain's row's
// bits.  What bounds it on the card is the walk: the lowpass's dependent
// chain is 20 instructions a sample (tanhf 8 of them, two on the ex2 and
// rcp unit), ~120 cycles; the tilt's SVF is eight float operations; the
// delay's is three, and its step's fixed cost (the barrier, the workers'
// four expf a sample) weighs as much as its walk.
//
// A body: kIn inputs copied in (source(a, x)) and kVals values computed
// ahead, arrays of a slot; the walk reads kWalkN of them from kWalkFirst on
// and writes kOuts arrays of the tile; finish writes kRes outputs
// (dest(r, y)).  A sample's element e points into array 0 of its channel,
// array a at e[a * kArr]; a tile element o into channel 0's first output,
// channel c's output m at o[c * pitch + m * kArr].
//
//   LowpassLone: x, g, fb in; min(fb, 1) ahead; the walk (lowpass_step:
//     the feedback's tanh, two one-poles, the flush and NaN reset) keeps the
//     raw stage-2 value; the finish takes its tanh.
//   TiltLone: x in; the knob's and the resonance's trajectories and the
//     coefficients (tilt_coefs: g, h, r, the mix, the low-pass and the
//     passthrough flags) ahead, g and h beside x; the walk steps the SVF
//     (tilt_svf) and keeps its taps v1 and v2; the finish (tilt_out) mixes
//     them.
//   DelayLone: x and the gathered tap in; the feedback, mix and cutoff
//     trajectories and the filter's coefficients (delay_coefs) ahead; the
//     walk steps the affine two-pole (delay_affine) and keeps the filtered
//     tap; the finish mixes it and forms the ring write from the partner
//     channel's filtered tap under ping-pong.

// Whether every pointer is 16-byte aligned.
__host__ inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* q : ptrs) {
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return false;
  }
  return true;
}

constexpr int kWalkWalkers = 64;   // warps 0 and 1: lane 0 of each walks a channel
constexpr int kWalkAhead = 3;      // chunks copied ahead of the walk
constexpr int kWalkRing = kWalkAhead + 2;

__host__ __device__ __forceinline__ constexpr int walk_pitch(int chunk) { return chunk + 4; }
__host__ __device__ __forceinline__ constexpr int walk_arr(int chunk) {
  return 2 * walk_pitch(chunk);
}

struct LowpassLone {
  static constexpr int kThreads = 160;   // the lowpass: three worker warps (by probe)
  static constexpr int kChunk = 128;     // the lowpass's chunk (by probe)
  static constexpr int kIn = 3;          // x, g, fb
  static constexpr int kVals = 1;        // min(fb, 1)
  static constexpr int kWalkFirst = 0, kWalkN = 4;
  static constexpr int kOuts = 1;        // the raw stage-2 value
  static constexpr int kRes = 1;         // y
  static constexpr int kArr = walk_arr(kChunk);
  const Phase& p;
  float s1, s2;
  __host__ static bool aligned(const float* x, const float* y, const Phase& p) {
    return aligned16({x, y, p.in[0], p.in[1]});
  }
  __device__ __forceinline__ const float* source(int a, const float* x) const {
    return a == 0 ? x : p.in[a - 1];
  }
  __device__ __forceinline__ float* dest(int, float* y) const { return y; }
  __device__ __forceinline__ void begin(int c) {
    s1 = p.in[2][2 * c];
    s2 = p.in[2][2 * c + 1];
  }
  __device__ __forceinline__ void prep(int, int, float* e) const {
    e[3 * kArr] = fminf(e[2 * kArr], 1.0f);
  }
  __device__ __forceinline__ void step(const float (&v)[kWalkN], float (&o)[kOuts]) {
    o[0] = lowpass_step(s1, s2, v[0], v[1], v[2], v[3]);
  }
  __device__ __forceinline__ void finish(const float*, const float* o, int c,
                                         float (&r)[kRes]) const {
    r[0] = tanhf(o[c * walk_pitch(kChunk)]);
  }
  __device__ __forceinline__ void end(int c, int) const {
    p.out[0][2 * c] = s1;
    p.out[0][2 * c + 1] = s2;
  }
};

struct TiltLone {
  static constexpr int kThreads = 128;   // the tilt: two worker warps (by probe)
  static constexpr int kChunk = 64;      // the tilt's chunk (by probe)
  static constexpr int kIn = 1;          // x
  static constexpr int kVals = 6;        // g, h, r, mix, low-pass, passthrough
  static constexpr int kWalkFirst = 0, kWalkN = 3;
  static constexpr int kOuts = 2;        // the SVF's taps v1, v2
  static constexpr int kRes = 1;         // y
  static constexpr int kArr = walk_arr(kChunk);
  const Phase& p;
  float ic1, ic2;
  __host__ static bool aligned(const float* x, const float* y, const Phase&) {
    return aligned16({x, y});
  }
  __device__ __forceinline__ const float* source(int, const float* x) const { return x; }
  __device__ __forceinline__ float* dest(int, float* y) const { return y; }
  __device__ __forceinline__ void begin(int c) {
    ic1 = p.in[2][2 * c];
    ic2 = p.in[2][2 * c + 1];
  }
  __device__ __forceinline__ void prep(int c, int n, float* e) const {
    const TiltCoefs k = tilt_coefs_at(p, c, n);
    e[kArr] = k.g;
    e[2 * kArr] = k.h;
    e[3 * kArr] = k.r;
    e[4 * kArr] = k.mix;
    e[5 * kArr] = k.lp;
    e[6 * kArr] = k.pass;
  }
  __device__ __forceinline__ void step(const float (&v)[kWalkN], float (&o)[kOuts]) {
    tilt_svf(ic1, ic2, v[0], v[1], v[2], o[0], o[1]);
  }
  __device__ __forceinline__ void finish(const float* e, const float* o, int c,
                                         float (&r)[kRes]) const {
    constexpr int P = walk_pitch(kChunk);
    r[0] = tilt_out(e[0], o[c * P], o[c * P + kArr], e[3 * kArr], e[4 * kArr], e[5 * kArr],
                    e[6 * kArr]);
  }
  __device__ __forceinline__ void end(int c, int B) const { tilt_end(p, c, B, ic1, ic2); }
};

struct DelayLone {
  static constexpr int kThreads = 128;   // the delay: two worker warps (by probe)
  static constexpr int kChunk = 64;      // the delay's chunk (by probe)
  static constexpr int kIn = 2;          // x, the tap
  static constexpr int kVals = 8;        // feedback, mix, a11, a12, b1, a21, a22, b2
  static constexpr int kWalkFirst = 4, kWalkN = 6;
  static constexpr int kOuts = 1;        // the filtered tap
  static constexpr int kRes = 2;         // y, the ring write
  static constexpr int kArr = walk_arr(kChunk);
  const Phase& p;
  float z1, z2;
  __host__ static bool aligned(const float* x, const float* y, const Phase& p) {
    return aligned16({x, y, p.in[0], p.out[0]});
  }
  __device__ __forceinline__ const float* source(int a, const float* x) const {
    return a == 0 ? x : p.in[0];
  }
  __device__ __forceinline__ float* dest(int r, float* y) const { return r == 0 ? y : p.out[0]; }
  __device__ __forceinline__ void begin(int c) {
    z1 = p.in[3][2 * c];
    z2 = p.in[3][2 * c + 1];
  }
  __device__ __forceinline__ void prep(int c, int n, float* e) const {
    const float* cur = p.in[1] + 3 * c;
    const float* tgt = p.in[2] + 3 * c;
    const float logq = p.f[0];
    e[2 * kArr] = traj(cur[0], tgt[0], logq, n);
    e[3 * kArr] = traj(cur[1], tgt[1], logq, n);
    const DelayCoefs k = delay_coefs(e[kArr], traj(cur[2], tgt[2], logq, n), p.f[1]);
    e[4 * kArr] = k.a11;
    e[5 * kArr] = k.a12;
    e[6 * kArr] = k.b1;
    e[7 * kArr] = k.a21;
    e[8 * kArr] = k.a22;
    e[9 * kArr] = k.b2;
  }
  __device__ __forceinline__ void step(const float (&v)[kWalkN], float (&o)[kOuts]) {
    o[0] = delay_affine(z1, z2, DelayCoefs{v[0], v[1], v[2], v[3], v[4], v[5]});
  }
  // y = the mix, x where it is not finite; the write: the injection (with
  // ping-pong the dry signal feeds the left channel only, delay.rs:460-491)
  // plus the partner's filtered tap (its own without ping-pong) times the
  // feedback
  __device__ __forceinline__ void finish(const float* e, const float* o, int c,
                                         float (&r)[kRes]) const {
    constexpr int P = walk_pitch(kChunk);
    const bool pingpong = p.flag != 0;
    const float xn = e[0], mix = e[3 * kArr];
    const float out = xn * (1.0f - mix) + o[c * P] * mix;
    r[0] = isfinite(out) ? out : xn;
    r[1] = delay_write((pingpong && c == 1) ? 0.0f : xn, o[(pingpong ? 1 - c : c) * P],
                       e[2 * kArr]);
  }
  __device__ __forceinline__ void end(int c, int B) const {
    const float* cur = p.in[1] + 3 * c;
    const float* tgt = p.in[2] + 3 * c;
    const float logq = p.f[0];
    float* st_out = p.out[1];
    st_out[5 * c + 0] = z1;
    st_out[5 * c + 1] = z2;
    st_out[5 * c + 2] = traj(cur[0], tgt[0], logq, B - 1);
    st_out[5 * c + 3] = traj(cur[1], tgt[1], logq, B - 1);
    st_out[5 * c + 4] = traj(cur[2], tgt[2], logq, B - 1);
  }
};

// A lone walk's shared memory: the ring of chunks' inputs and values
// ([kWalkRing][kIn + kVals][2 ch][pitch]) and the walks' output tiles
// ([2][kOuts][2 ch][pitch]), chunks alternating.
template <class Body>
struct WalkTiles {
  static constexpr int C = Body::kChunk, kArr = Body::kArr;
  static constexpr int kSlot = (Body::kIn + Body::kVals) * kArr;
  static constexpr int kOut = kWalkRing * kSlot;
  static constexpr int kFloats = kOut + 2 * Body::kOuts * kArr;
  float* smem;
  int B, n_chunks;
  __device__ WalkTiles(float* smem_, int B_) : smem(smem_), B(B_), n_chunks((B_ + C - 1) / C) {}
  __device__ int len(int j) const { return min(C, B - j * C); }
  __device__ float* slot(int j) const { return smem + (j % kWalkRing) * kSlot; }
  __device__ float* out(int j) const { return smem + kOut + (j & 1) * Body::kOuts * kArr; }
};

__device__ __forceinline__ float lane_of(const float4& q, int k) {
  return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
}

// Lane 0 of warp c: channel c's walk through a chunk of len samples (e: its
// slot's channel-c element 0; o: its tile's), four samples at a time, each
// group's values loaded a group ahead, before the group ahead of them stores
// its outputs (the compiler does not move a shared load past a shared
// store).  A load past the chunk stays inside the slot and is not used.
template <class Body>
__device__ __forceinline__ void walk_lone_chunk(Body& body, const float* e, float* o, int len) {
  constexpr int N = Body::kWalkN, M = Body::kOuts, A = Body::kArr;
  const float* v = e + Body::kWalkFirst * A;
  float4 q[N];
#pragma unroll
  for (int a = 0; a < N; ++a) q[a] = ld4(v + a * A);
  const auto group = [&](int i) {
    float4 next[N];
#pragma unroll
    for (int a = 0; a < N; ++a) next[a] = ld4(v + a * A + i + 4);
    float r[M][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float s[N], out[M];
#pragma unroll
      for (int a = 0; a < N; ++a) s[a] = lane_of(q[a], k);
      body.step(s, out);
#pragma unroll
      for (int m = 0; m < M; ++m) r[m][k] = out[m];
    }
#pragma unroll
    for (int m = 0; m < M; ++m) st4(o + m * A + i, make_float4(r[m][0], r[m][1], r[m][2], r[m][3]));
#pragma unroll
    for (int a = 0; a < N; ++a) q[a] = next[a];
  };
  if (len == Body::kChunk) {
#pragma unroll
    for (int i = 0; i < Body::kChunk; i += 4) group(i);
  } else {
    int i = 0;
    for (; i + 4 <= len; i += 4) group(i);
    for (; i < len; ++i) {
      float s[N], out[M];
#pragma unroll
      for (int a = 0; a < N; ++a) s[a] = v[a * A + i];
      body.step(s, out);
#pragma unroll
      for (int m = 0; m < M; ++m) o[m * A + i] = out[m];
    }
  }
}

template <class Body>
__global__ void __launch_bounds__(Body::kThreads)
    walk_lone_kernel(const float* __restrict__ x, float* __restrict__ y, Phase p, int B, int vec) {
  extern __shared__ float4 walk_smem4[];
  const WalkTiles<Body> t(reinterpret_cast<float*>(walk_smem4), B);
  constexpr int P = walk_pitch(Body::kChunk), A = Body::kArr;
  const int tid = threadIdx.x;
  const int n_chunks = t.n_chunks;
  Body body{p};
  if (tid < kWalkWalkers) {
    const int c = tid >> 5;
    const bool walker = (tid & 31) == 0;
    if (walker) body.begin(c);
    step_barrier();   // chunk 0's inputs landed
    for (int j = 0; j <= n_chunks; ++j) {
      step_barrier();   // chunk j's values ready; walk j-1 finished
      if (walker && j < n_chunks) walk_lone_chunk(body, t.slot(j) + c * P, t.out(j) + c * P, t.len(j));
    }
    if (walker) body.end(c, B);
    return;
  }
  // the workers
  constexpr int kWorkers = Body::kThreads - kWalkWalkers;
  const int w = tid - kWalkWalkers;
  const int width = vec ? 4 : 1;
  const auto copy_in = [&](int j) {
    if (j < n_chunks) {
      const int n0 = j * Body::kChunk, units = vec ? t.len(j) >> 2 : t.len(j);
#pragma unroll
      for (int a = 0; a < Body::kIn; ++a) {
        const float* src = body.source(a, x);
        for (int u = w; u < 2 * units; u += kWorkers) {
          int ch, i;
          both_channels(u, units, ch, i);
          float* d = t.slot(j) + a * A + ch * P + width * i;
          const float* g = src + static_cast<size_t>(ch) * B + n0 + width * i;
          if (vec) {
            cp_async16(d, g);
          } else {
            cp_async4(d, g);
          }
        }
      }
    }
    cp_async_commit();
  };
  const auto prep = [&](int j) {
    if (j >= n_chunks) return;
    const int n0 = j * Body::kChunk, l = t.len(j);
    float* e = t.slot(j);
    for (int u = w; u < 2 * l; u += kWorkers) {
      int ch, i;
      both_channels(u, l, ch, i);
      body.prep(ch, n0 + i, e + ch * P + i);
    }
  };
  // chunk j's outputs, a sample (four where the copies take 16 bytes) a
  // worker at a time, stored coalesced
  const auto finish = [&](int j) {
    constexpr int R = Body::kRes;
    const int n0 = j * Body::kChunk, units = vec ? t.len(j) >> 2 : t.len(j);
    const float* e = t.slot(j);
    const float* o = t.out(j);
    for (int u = w; u < 2 * units; u += kWorkers) {
      int ch, i;
      both_channels(u, units, ch, i);
      const size_t at = static_cast<size_t>(ch) * B + n0 + width * i;
      if (vec) {
        float r[R][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float s[R];
          body.finish(e + ch * P + 4 * i + k, o + 4 * i + k, ch, s);
#pragma unroll
          for (int m = 0; m < R; ++m) r[m][k] = s[m];
        }
#pragma unroll
        for (int m = 0; m < R; ++m) {
          st4(body.dest(m, y) + at, make_float4(r[m][0], r[m][1], r[m][2], r[m][3]));
        }
      } else {
        float s[R];
        body.finish(e + ch * P + i, o + i, ch, s);
#pragma unroll
        for (int m = 0; m < R; ++m) body.dest(m, y)[at] = s[m];
      }
    }
  };
  for (int j = 0; j < kWalkAhead; ++j) copy_in(j);
  cp_async_wait<kWalkAhead - 1>();   // chunk 0 has landed (this worker's part)
  step_barrier();
  prep(0);
  for (int j = 0; j <= n_chunks; ++j) {
    cp_async_wait<kWalkAhead - 2>();   // chunk j+1 has landed (this worker's part)
    step_barrier();   // ... all of it; chunk j's values ready; walk j-1 done
    copy_in(j + kWalkAhead);
    prep(j + 1);
    if (j > 0) finish(j - 1);
  }
}

// bus_chain: phase i on warp i (lanes 0 and 1 the channels), the [2, B]
// signal in shared memory, threaded in place.  The block is cut into chunks
// of kChainChunk samples; at step s warp i runs chunk s - i, so phase i
// reads chunk s - i after phase i - 1 wrote it a step before, and warps on
// different chunks never touch the same samples.  One block barrier a step:
// n + ceil(B / C) - 1 steps, each as long as the slowest phase's chunk.

struct Chain {
  int n;
  Phase ph[kMaxPhases];
  int smem_off[kMaxPhases];   // each phase's own shared memory, in floats
};

template <class Row>
__device__ __forceinline__ void pipelined(const Phase& p, const FbwsCoefs& k, int i,
                                          float* sig, float* smem, int B, int n_steps) {
  const int lane = threadIdx.x & 31;
  const int n_chunks = (B + kChainChunk - 1) / kChainChunk;
  Row row;
  row.fill(p, lane, smem);
  __syncwarp();
  if (lane < 2) row.begin(p, lane, B, smem);
  for (int s = 0; s < n_steps; ++s) {
    const int kc = s - i;
    if (kc >= 0 && kc < n_chunks) {
      const int n0 = kc * kChainChunk;
      row.run(p, k, lane, sig, sig, n0, min(n0 + kChainChunk, B), B, smem);
    }
    step_barrier();
  }
  if (lane < 2) row.end(p, lane, B);
  __syncwarp();
  row.drain(p, lane, B, smem);
}

__global__ void __launch_bounds__(kMaxPhases * 32)
    bus_chain_kernel(const float* x, float* y, Chain ch, FbwsCoefs k, int B) {
  extern __shared__ float4 chain_smem4[];
  float* smem = reinterpret_cast<float*>(chain_smem4);
  float* sig = smem;   // [2, B]
  const int tid = threadIdx.x;
  const int n_threads = ch.n * 32;
  for (int i = tid; i < 2 * B; i += n_threads) sig[i] = x[i];
  __syncthreads();
  const int i = tid >> 5;
  const Phase& p = ch.ph[i];
  float* own = smem + ch.smem_off[i];
  const int n_steps = ch.n + (B + kChainChunk - 1) / kChainChunk - 1;
  switch (p.op) {
    case kSaturation:
      pipelined<SaturationRow>(p, k, i, sig, own, B, n_steps);
      break;
    case kLowpass:
      pipelined<LowpassRow>(p, k, i, sig, own, B, n_steps);
      break;
    case kTilt:
      pipelined<TiltRow>(p, k, i, sig, own, B, n_steps);
      break;
    case kDelay:
      pipelined<DelayRow>(p, k, i, sig, own, B, n_steps);
      break;
    case kEnv:
      pipelined<EnvRow>(p, k, i, sig, own, B, n_steps);
      break;
    case kCompressor:
      pipelined<CompressorRow>(p, k, i, sig, own, B, n_steps);
      break;
    case kSpring:
      pipelined<SpringRow>(p, k, i, sig, own, B, n_steps);
      break;
    case kWaveshaper:
      pipelined<WaveshaperRow>(p, k, i, sig, own, B, n_steps);
      break;
    default:
      pipelined<FbwsRow>(p, k, i, sig, own, B, n_steps);
      break;
  }
  __syncthreads();
  for (int j = tid; j < 2 * B; j += n_threads) y[j] = sig[j];
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
// rings and scratch, the tilt's and the 4x phases' scratch.
size_t phase_smem(const Phase& p, int B) {
  switch (p.op) {
    case kDelay:
      return 2 * static_cast<size_t>(B) * sizeof(float);
    case kSpring:
      return spring_ring_bytes(p.iv[2 * kSpringAps]) + kScratchSpring * sizeof(float);
    case kTilt:
      return kScratchTilt * sizeof(float);
    case kSaturation:
    case kCompressor:
    case kWaveshaper:
    case kFbws:
      return kScratch4x * sizeof(float);
    default:
      return 0;
  }
}

// A lone detector: 16-byte copies where B % 4 == 0 and every array is
// 16-byte aligned (bank_kernels.copies_16b's test).
cudaError_t launch_env(const float* x, float* y, const Phase& p, int B, cudaStream_t s) {
  const int vec = B % 4 == 0 && aligned16({x, y, p.in[0], p.in[1], p.in[2], p.out[0]});
  constexpr size_t smem = EnvTiles::kFloats * sizeof(float);
  const cudaError_t err = allow_smem(env_lone_kernel, smem);
  if (err != cudaSuccess) return err;
  env_lone_kernel<<<1, kEnvThreads, smem, s>>>(x, y, p, B, vec);
  return cudaGetLastError();
}

// A lone lowpass, tilt or delay: 16-byte copies where B % 4 == 0 and every array
// the kernel reads or writes is 16-byte aligned.
template <class Body>
cudaError_t launch_walk(const float* x, float* y, const Phase& p, int B, cudaStream_t s) {
  const int vec = B % 4 == 0 && Body::aligned(x, y, p);
  constexpr size_t smem = WalkTiles<Body>::kFloats * sizeof(float);
  const cudaError_t err = allow_smem(walk_lone_kernel<Body>, smem);
  if (err != cudaSuccess) return err;
  walk_lone_kernel<Body><<<1, Body::kThreads, smem, s>>>(x, y, p, B, vec);
  return cudaGetLastError();
}

// A lone spring: its rings and ~24 KB, opted in past 48 KB.
cudaError_t launch_spring(const float* x, float* y, const Phase& p, int B, cudaStream_t s) {
  const int P = spring_part(p);
  const size_t smem = spring_lone_smem_bytes(p.iv[2 * kSpringAps]);
  const cudaError_t err = allow_smem(spring_lone_kernel, smem);
  if (err != cudaSuccess) return err;
  const int vec_traj = B % 4 == 0 && aligned16({x, p.in[0], p.in[1], p.in[2], p.in[5]});
  spring_lone_kernel<<<1, kSpringThreads, smem, s>>>(x, y, p, B, P, aligned16({p.in[3]}),
                                                     vec_traj);
  return cudaGetLastError();
}

// A lone 4x effect (saturation, compressor, waveshaper, feedback
// waveshaper) through the four-walk kernel.
template <class Body>
cudaError_t launch_lone(const float* x, float* y, const Phase& p, const float* coefs, int B,
                        cudaStream_t s) {
  constexpr size_t smem = lone_smem_bytes<Body>();
  const cudaError_t err = allow_smem(bus4x_split_kernel<Body>, smem);
  if (err != cudaSuccess) return err;
  bus4x_split_kernel<Body><<<1, Body::kThreads, smem, s>>>(x, y, p, fbws_coefs(coefs), B);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One effect's block through its own kernel.
int bus_block_launch(const float* x, float* y, const int* ops, void* const* ptrs,
                     const float* f, const int* iv, const float* coefs, int B, void* stream) {
  const Phase p = make_phase(ops, ptrs, f, iv);
  const cudaStream_t s = as_stream(stream);
  switch (p.op) {
    case kSaturation:
      return static_cast<int>(launch_lone<SatLone>(x, y, p, coefs, B, s));
    case kLowpass:
      return static_cast<int>(launch_walk<LowpassLone>(x, y, p, B, s));
    case kTilt:
      return static_cast<int>(launch_walk<TiltLone>(x, y, p, B, s));
    case kDelay:
      return static_cast<int>(launch_walk<DelayLone>(x, y, p, B, s));
    case kEnv:
      return static_cast<int>(launch_env(x, y, p, B, s));
    case kCompressor:
      return static_cast<int>(launch_lone<CompLone>(x, y, p, coefs, B, s));
    case kSpring:
      return static_cast<int>(launch_spring(x, y, p, B, s));
    case kWaveshaper:
      return static_cast<int>(launch_lone<WsLone>(x, y, p, coefs, B, s));
    case kFbws:
      return static_cast<int>(launch_lone<FbwsLone>(x, y, p, coefs, B, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// n effects' blocks, in order, in one launch: the signal and each phase's
// own shared memory (16-byte aligned regions, one after another).
int bus_chain_launch(const float* x, float* y, int n, const int* ops, void* const* ptrs,
                     const float* f, const int* iv, const float* coefs, int B,
                     void* stream) {
  if (n < 1 || n > kMaxPhases) return static_cast<int>(cudaErrorInvalidValue);
  Chain ch{};
  ch.n = n;
  size_t floats = (2 * static_cast<size_t>(B) + 3) & ~static_cast<size_t>(3);
  for (int i = 0; i < n; ++i) {
    ch.ph[i] = make_phase(ops + 2 * i, ptrs + (kPhaseIn + kPhaseOut) * i, f + kPhaseF * i,
                          iv + kPhaseI * i);
    if (ch.ph[i].op < kSaturation || ch.ph[i].op > kFbws) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    ch.smem_off[i] = static_cast<int>(floats);
    floats += ((phase_smem(ch.ph[i], B) / sizeof(float)) + 3) & ~static_cast<size_t>(3);
  }
  const size_t smem = floats * sizeof(float);
  const cudaError_t err = allow_smem(bus_chain_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bus_chain_kernel<<<1, 32 * n, smem, as_stream(stream)>>>(x, y, ch, fbws_coefs(coefs), B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
