// The 4x polyphase half-band chain shared by the kernels that shape a signal
// at four times the engine rate: fbws_bank and ws4_bank (bank_kernels.cu),
// saturation_block, compressor_block, waveshaper_block and fbws_fast_block
// (bus_kernels.cu), and the bass and drive bodies of the kit kernels
// (voice_kernels.cu).
//
// A row (a voice, or a channel of the stereo bus) steps its base-rate
// samples through stage-1 up, stage-2 up, the nonlinearity at each 4x
// subsample, stage-2 down and stage-1 down, with every allpass memory in
// registers: the up-path and the down-path as two walks (the split form
// below), on one thread or on two.  The packed state is the port's [S, V]
// layout (ops/bank_kernels.py FBWS_CORE_LAYOUT in, + FBWS_Y2_LAYOUT out):
// row-major by field, one column per row of the signal.

#pragma once

#include <cuda_runtime.h>

namespace {

// Phase-split half-band coefficients (ops/oversample.py STAGE1/STAGE2 cast
// once to float32): stage 1 has 4 + 4 sections, stage 2 has 2 + 2.
struct FbwsCoefs {
  float c1_0[4];
  float c1_1[4];
  float c2_0[2];
  float c2_1[2];
};

// Carried state, one row, in registers (names follow the packed layout of
// ops/bank_kernels.py FBWS_CORE_LAYOUT: u/d = up/down, 1/2 = stage,
// y/x = section output/input memories, trailing 0/1 = polyphase branch).
struct FbwsState {
  float u1y0[4], u1x0[4], u1y1[4], u1x1[4];
  float u2y0[2], u2x0[2], u2y1[2], u2x1[2];
  float d2y0[2], d2x0[2], d2y1[2], d2x1[2], d2x1d;
  float d1y0[4], d1x0[4], d1y1[4], d1x1[4], d1x1d;
  float dcx, dcy;
};

constexpr float kDcCoeff = 0.995f;

// One sample through a chain of first-order allpasses: y = a*(x - y1) + x1.
template <int N>
__device__ __forceinline__ float ap_chain(float u, float (&ys)[N], float (&xs)[N],
                                          const float (&a)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float y = a[j] * (u - ys[j]) + xs[j];
    xs[j] = u;
    ys[j] = y;
    u = y;
  }
  return u;
}

// The memoryless nonlinearities evaluated at each 4x subsample: plain tanh
// (the kick's fbws, the bus feedback waveshaper) or the waveshaper's
// tanh(v*d)*comp with the enclosing engine sample's drive and makeup gain
// (ws4, the snare's and the bass's drives, the bus waveshaper).
struct TanhShaper {
  __device__ __forceinline__ float operator()(float s) const { return tanhf(s); }
};

struct DriveShaper {
  float d, cp;
  __device__ __forceinline__ float operator()(float s) const { return tanhf(s * d) * cp; }
};

// The bypass-gated DC blocker (the kick's fbws, the bus saturation).
// cs < 0 marks a bypassed sample: DC state frozen, output 0; otherwise the
// input is y * cs.  Returns the DC-blocked output.
__device__ __forceinline__ float gated_dc(FbwsState& s, float y, float cs) {
  const bool byp = cs < 0.0f;
  const float compensated = y * fmaxf(cs, 0.0f);
  const float x1_prev = s.dcx;
  const float y1_new = kDcCoeff * s.dcy + (compensated - x1_prev);
  if (!byp) {
    s.dcx = compensated;
    s.dcy = y1_new;
  }
  return byp ? 0.0f : s.dcy;
}

template <int N>
__device__ __forceinline__ void load_rows(float (&dst)[N], const float* st, int& k,
                                          int v, int V) {
#pragma unroll
  for (int j = 0; j < N; ++j) dst[j] = st[static_cast<size_t>(k + j) * V + v];
  k += N;
}

template <int N>
__device__ __forceinline__ void store_rows(const float (&src)[N], float* st, int& k,
                                           int v, int V) {
#pragma unroll
  for (int j = 0; j < N; ++j) st[static_cast<size_t>(k + j) * V + v] = src[j];
  k += N;
}

__device__ __forceinline__ void load_row(float& dst, const float* st, int& k, int v,
                                         int V) {
  dst = st[static_cast<size_t>(k) * V + v];
  k += 1;
}

__device__ __forceinline__ void store_row(float src, float* st, int& k, int v, int V) {
  st[static_cast<size_t>(k) * V + v] = src;
  k += 1;
}

// Second-to-last captures (HalfbandState.*y2 / *x2) of one half-band stage.
template <int N>
struct Caps {
  float y0[N], x0[N], y1[N], x1[N];
};

template <int N>
__device__ __forceinline__ void capture(Caps<N>& c, const float (&y0)[N],
                                        const float (&x0)[N], const float (&y1)[N],
                                        const float (&x1)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c.y0[j] = y0[j];
    c.x0[j] = x0[j];
    c.y1[j] = y1[j];
    c.x1[j] = x1[j];
  }
}

template <int N>
__device__ __forceinline__ void store_caps(const Caps<N>& c, float* st, int& k, int v,
                                           int V) {
  store_rows(c.y0, st, k, v, V);
  store_rows(c.x0, st, k, v, V);
  store_rows(c.y1, st, k, v, V);
  store_rows(c.x1, st, k, v, V);
}

// The packed layout's halves: the up-path's rows (0-23; captures 52-75)
// and the down-path's with the DC rows (24-51; captures 76-99), so that the
// two walks of the split form (ws4_bank, kit_drive) each load and store
// their own.
constexpr int kPackedUpRows = 24;
constexpr int kPackedCoreRows = 52;
constexpr int kPackedDownCaps = kPackedCoreRows + 24;
// Within the halves, by stage (the lone 4x bus kernels walk each stage on
// its own): stage-2 up's rows start at 16 (captures 68), stage-1 down's at
// 33 after stage-2 down's delayed input (captures 84).
constexpr int kPackedUp2Rows = 16;
constexpr int kPackedDown1Rows = 33;
constexpr int kPackedUp2Caps = kPackedCoreRows + 16;
constexpr int kPackedDown1Caps = kPackedDownCaps + 8;

__device__ __forceinline__ void load_up_state(FbwsState& s, const float* st, int v, int V) {
  int r = 0;
  load_rows(s.u1y0, st, r, v, V);
  load_rows(s.u1x0, st, r, v, V);
  load_rows(s.u1y1, st, r, v, V);
  load_rows(s.u1x1, st, r, v, V);
  load_rows(s.u2y0, st, r, v, V);
  load_rows(s.u2x0, st, r, v, V);
  load_rows(s.u2y1, st, r, v, V);
  load_rows(s.u2x1, st, r, v, V);
}

__device__ __forceinline__ void load_down_state(FbwsState& s, const float* st, int v, int V) {
  int r = kPackedUpRows;
  load_rows(s.d2y0, st, r, v, V);
  load_rows(s.d2x0, st, r, v, V);
  load_rows(s.d2y1, st, r, v, V);
  load_rows(s.d2x1, st, r, v, V);
  load_row(s.d2x1d, st, r, v, V);
  load_rows(s.d1y0, st, r, v, V);
  load_rows(s.d1x0, st, r, v, V);
  load_rows(s.d1y1, st, r, v, V);
  load_rows(s.d1x1, st, r, v, V);
  load_row(s.d1x1d, st, r, v, V);
  load_row(s.dcx, st, r, v, V);
  load_row(s.dcy, st, r, v, V);
}

// packed input layout: 52 rows (ops/bank_kernels.py FBWS_CORE_LAYOUT)
__device__ __forceinline__ void load_state(FbwsState& s, const float* st, int v, int V) {
  load_up_state(s, st, v, V);
  load_down_state(s, st, v, V);
}

__device__ __forceinline__ void store_up_state(const FbwsState& s, const Caps<4>& cu1,
                                               const Caps<2>& cu2, float* st, int v, int V) {
  int r = 0;
  store_rows(s.u1y0, st, r, v, V);
  store_rows(s.u1x0, st, r, v, V);
  store_rows(s.u1y1, st, r, v, V);
  store_rows(s.u1x1, st, r, v, V);
  store_rows(s.u2y0, st, r, v, V);
  store_rows(s.u2x0, st, r, v, V);
  store_rows(s.u2y1, st, r, v, V);
  store_rows(s.u2x1, st, r, v, V);
  r = kPackedCoreRows;
  store_caps(cu1, st, r, v, V);
  store_caps(cu2, st, r, v, V);
}

__device__ __forceinline__ void store_down_state(const FbwsState& s, const Caps<2>& cd2,
                                                 const Caps<4>& cd1, float* st, int v, int V) {
  int r = kPackedUpRows;
  store_rows(s.d2y0, st, r, v, V);
  store_rows(s.d2x0, st, r, v, V);
  store_rows(s.d2y1, st, r, v, V);
  store_rows(s.d2x1, st, r, v, V);
  store_row(s.d2x1d, st, r, v, V);
  store_rows(s.d1y0, st, r, v, V);
  store_rows(s.d1x0, st, r, v, V);
  store_rows(s.d1y1, st, r, v, V);
  store_rows(s.d1x1, st, r, v, V);
  store_row(s.d1x1d, st, r, v, V);
  store_row(s.dcx, st, r, v, V);
  store_row(s.dcy, st, r, v, V);
  r = kPackedDownCaps;
  store_caps(cd2, st, r, v, V);
  store_caps(cd1, st, r, v, V);
}

// packed output layout: the 52 core rows, then 48 capture rows
__device__ __forceinline__ void store_state(const FbwsState& s, const Caps<4>& cu1,
                                            const Caps<2>& cu2, const Caps<2>& cd2,
                                            const Caps<4>& cd1, float* st, int v, int V) {
  store_up_state(s, cu1, cu2, st, v, V);
  store_down_state(s, cd2, cd1, st, v, V);
}

// The 4x chain in spans (kit_sources' bass, the 4x phases of bus_chain and
// of their own kernels; ws4_bank, fbws_bank and kit_drive, whose up- and
// down-walks run on two warps).  ovs4_up_span walks the up-path (stage-1
// and stage-2 upsamplers) of samples [n0, n1) of a B-sample block and
// leaves sample n's four 4x subsamples at sub[4 (n - n0) ..]; the caller
// applies the sample's shaper to each in place, on any threads;
// ovs4_down_span walks the down-path (stage-2 and stage-1 downsamplers) on
// them and calls finish.  The state carries in ``s`` from one span to the
// next.  The span that holds the block's last sample takes the
// second-to-last captures into ``cap`` (stage-1 memories hold the step-(B-2)
// section IO before it, stage-2 memories hold 2x-rate index 2B-2 after its
// first subsample, pallas_fx.py:1697-1713), and store_span_state stores
// the state after the last span (or each walk its half, store_up_state /
// store_down_state, where they run on other threads).  The up-path and the
// down-path hold disjoint parts of the state and every allpass steps its
// samples in order, so any cut of a block into spans gives the same bits.
struct OvsCaps {
  Caps<4> u1, d1;
  Caps<2> u2, d2;
};

__device__ __forceinline__ void store_span_state(const FbwsState& s, const OvsCaps& cap,
                                                 float* st, int v, int V) {
  store_state(s, cap.u1, cap.u2, cap.d2, cap.d1, st, v, V);
}

// One sample's up-path: its four 4x subsamples into q; cu2, where given,
// takes the stage-2 memories between the first and the second pair.
__device__ __forceinline__ void ovs4_up_step(FbwsState& s, const FbwsCoefs& k, float u,
                                             float* q, Caps<2>* cu2) {
  const float e1 = ap_chain(u, s.u1y0, s.u1x0, k.c1_0);
  const float o1 = ap_chain(u, s.u1y1, s.u1x1, k.c1_1);
  q[0] = ap_chain(e1, s.u2y0, s.u2x0, k.c2_0);
  q[1] = ap_chain(e1, s.u2y1, s.u2x1, k.c2_1);
  if (cu2 != nullptr) capture(*cu2, s.u2y0, s.u2x0, s.u2y1, s.u2x1);
  q[2] = ap_chain(o1, s.u2y0, s.u2x0, k.c2_0);
  q[3] = ap_chain(o1, s.u2y1, s.u2x1, k.c2_1);
}

// One sample's down-path on its four shaped subsamples; cd2, where given,
// takes the stage-2 memories between the two pairs.  Returns the base-rate
// output.
__device__ __forceinline__ float ovs4_down_step(FbwsState& s, const FbwsCoefs& k,
                                                const float* q, Caps<2>* cd2) {
  const float a0 = ap_chain(q[0], s.d2y0, s.d2x0, k.c2_0);
  const float a1 = ap_chain(s.d2x1d, s.d2y1, s.d2x1, k.c2_1);
  const float d0 = 0.5f * (a0 + a1);
  s.d2x1d = q[1];
  if (cd2 != nullptr) capture(*cd2, s.d2y0, s.d2x0, s.d2y1, s.d2x1);
  const float b0 = ap_chain(q[2], s.d2y0, s.d2x0, k.c2_0);
  const float b1 = ap_chain(s.d2x1d, s.d2y1, s.d2x1, k.c2_1);
  const float d1 = 0.5f * (b0 + b1);
  s.d2x1d = q[3];
  const float e0 = ap_chain(d0, s.d1y0, s.d1x0, k.c1_0);
  const float e1 = ap_chain(s.d1x1d, s.d1y1, s.d1x1, k.c1_1);
  s.d1x1d = d1;
  return 0.5f * (e0 + e1);
}

// The walks take four samples at a time, their inputs read first, so that
// the four samples' chains overlap (each allpass still steps them in order);
// the block's last sample is peeled for its captures.
constexpr int kOvsGroup = 4;

template <class Input>
__device__ __forceinline__ void ovs4_up_span(FbwsState& s, OvsCaps& cap, const FbwsCoefs& k,
                                             int n0, int n1, int B, const Input& input,
                                             float* sub) {
  const int stop = n1 < B - 1 ? n1 : B - 1;
  int n = n0;
  for (; n + kOvsGroup <= stop; n += kOvsGroup) {
    float u[kOvsGroup];
#pragma unroll
    for (int j = 0; j < kOvsGroup; ++j) u[j] = input(n + j);
#pragma unroll
    for (int j = 0; j < kOvsGroup; ++j) ovs4_up_step(s, k, u[j], sub + 4 * (n + j - n0), nullptr);
  }
  for (; n < stop; ++n) ovs4_up_step(s, k, input(n), sub + 4 * (n - n0), nullptr);
  if (n1 == B) {
    capture(cap.u1, s.u1y0, s.u1x0, s.u1y1, s.u1x1);
    ovs4_up_step(s, k, input(B - 1), sub + 4 * (B - 1 - n0), &cap.u2);
  }
}

template <class Finish>
__device__ __forceinline__ void ovs4_down_span(FbwsState& s, OvsCaps& cap, const FbwsCoefs& k,
                                               int n0, int n1, int B, const float* sub,
                                               const Finish& finish) {
  const int stop = n1 < B - 1 ? n1 : B - 1;
  int n = n0;
  for (; n + kOvsGroup <= stop; n += kOvsGroup) {
    float q[4 * kOvsGroup], y[kOvsGroup];
#pragma unroll
    for (int j = 0; j < 4 * kOvsGroup; ++j) q[j] = sub[4 * (n - n0) + j];
#pragma unroll
    for (int j = 0; j < kOvsGroup; ++j) y[j] = ovs4_down_step(s, k, q + 4 * j, nullptr);
#pragma unroll
    for (int j = 0; j < kOvsGroup; ++j) finish(n + j, y[j]);
  }
  for (; n < stop; ++n) finish(n, ovs4_down_step(s, k, sub + 4 * (n - n0), nullptr));
  if (n1 == B) {
    capture(cap.d1, s.d1y0, s.d1x0, s.d1y1, s.d1x1);
    finish(B - 1, ovs4_down_step(s, k, sub + 4 * (B - 1 - n0), &cap.d2));
  }
}

// coefs (host): c1_0[4], c1_1[4], c2_0[2], c2_1[2]
inline FbwsCoefs fbws_coefs(const float* coefs) {
  FbwsCoefs k;
  for (int i = 0; i < 4; ++i) {
    k.c1_0[i] = coefs[i];
    k.c1_1[i] = coefs[4 + i];
  }
  for (int i = 0; i < 2; ++i) {
    k.c2_0[i] = coefs[8 + i];
    k.c2_1[i] = coefs[10 + i];
  }
  return k;
}

inline cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace
