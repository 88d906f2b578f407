// Voice-bank recurrence kernels for Hopper (sm_90a): the seven Pallas bank
// kernels that the five-family kit runs on the engine's main path, and the
// engine's fused mix.
//
//   affine1_bank     <- libgooey_tpu/ops/pallas_fx.py:affine1_bank (_affine1_bank_kernel)
//   pink_bank        <- libgooey_tpu/ops/pallas_fx.py:pink_bank (_pink_bank_kernel)
//   svf_bank         <- libgooey_tpu/ops/pallas_fx.py:svf_bank (_svf_bank_kernel)
//   env_follow_bank  <- libgooey_tpu/ops/pallas_fx.py:env_follow_bank (_env_bank_kernel)
//   fbws_bank        <- libgooey_tpu/ops/pallas_fx.py:fbws_bank (_fbws_bank_kernel)
//   ws4_bank         <- libgooey_tpu/ops/pallas_fx.py:ws4_bank (_ws4_bank_kernel)
//   linrec2_bank     <- libgooey_tpu/ops/pallas_fx.py:linrec2_bank (_linrec2_bank_kernel)
//   mix_bank         <- libgooey_tpu/ops/pallas_fx.py:mix_bank (_mix_bank_kernel), below
//
// affine1_bank also computes pallas_scan.py:linrec1_pallas's function, the
// first-order recurrence y[n] = a[n]*y[n-1] + b[n], with the floor a = -3e38.
//
// Design.  Each of the seven is a per-row recurrence stepping through the B
// samples of a block, with the carried state in registers: the recurrences
// are not reassociated (a two-pass scan of linrec2 drifts on high-Q
// resonators, libgooey_tpu/ops/scan.py:49-58, and affine1's max composes
// only for b >= 0).  Arrays are the port's logical [V, B] layout, row-major.
//
// affine1_bank, pink_bank, svf_bank, env_follow_bank and linrec2_bank (26,
// 2, 3, 1 and 5 launches a block in full_kit_4096_bus7, at 512-2,560 rows;
// env_follow_bank also at 4,096 in the kick slice and 16 on the product
// kit's path) are staged (row_stage.cuh): a block of 128 threads owns rc <=
// 32 rows, the wrapper picks rc so that a launch spreads over the SMs (4
// rows a block at 512 rows, 8 at 1,024, 20 at 2,560, 32 at 4,096 on 132
// SMs; one block a row below 133 rows), warp 0 walks the rows from shared
// memory four samples at a time, and warps 1-3 stream 64-sample chunks in
// with cp.async (pink_bank's and svf_bank's reset masks and
// env_follow_bank's freeze mask as a byte tile) and the outputs out,
// coalesced, ahead of and behind the walk.  They are bound by the serial
// chain at 1-1,024 rows (512 dependent steps of ~12 cycles for pink, ~18
// for affine1 and linrec2, ~24 for the follower, ~35 for the SVF) and near
// their bytes bound at 2,560-4,096.
//
// ws4_bank (2 launches a block in bus7, at 1,024 and 512 rows, and one at
// one row in the granulator) and fbws_bank (one launch a block: the kick's
// 4,096 rows in the kick slice, 1,024 in the kit cells) split their 4x
// chain over warps: the up-walk on one, the down-walk (fbws_bank's with the
// gated DC blocker) on another, the shaper and the copies on the rest, a
// chunk apart (their section below).
//
// Numerics: every step keeps the Pallas body's op order, and the build
// passes -fmad=false so that a*b + c rounds twice, exactly as the plain
// PyTorch versions in ops/bank_kernels.py do.  The kernels then agree with
// their plain versions to the last bit except where tanhf differs.
//
// Each C entry launches on the caller's stream and returns
// cudaGetLastError(); nothing allocates or synchronizes here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ovs4.cuh"
#include "rings.cuh"
#include "row_stage.cuh"

namespace {

constexpr int kThreads = 128;

// --- 1. affine1_bank: y[n] = max(a[n], b[n]*y[n-1] + c[n]) ------------------
//
// Staged (row_stage.cuh): a walker steps its row four samples at a time from
// the float4s of a, b and c, with the next four already in registers.  With
// no floor array (a == nullptr, kFloor false) the same fmaxf takes the
// constant -3e38f, so the bits equal those of an explicit floor row of it.

constexpr float kNoFloor = -3.0e38f;   // ops/bank_kernels.py NO_FLOOR

template <bool kFloor>
__global__ void __launch_bounds__(kStageThreads)
    affine1_bank_kernel(const float* __restrict__ a, const float* __restrict__ b,
                        const float* __restrict__ c, const float* __restrict__ y0,
                        float* __restrict__ y, float* __restrict__ y_last, int V, int B,
                        int rc, int vec) {
  constexpr int NIN = kFloor ? 3 : 2;
  float* const dst[1] = {y};
  const RowSpan s = row_span(V, B, rc, vec);
  const int v = s.row0 + threadIdx.x;
  float yv = threadIdx.x < s.rows ? y0[v] : 0.0f;
  auto walk = [&](const auto& in, const auto& out, int len) {
    const float* tb = in[0];
    const float* tc = in[1];
    const float* ta = in[NIN - 1];   // a's row where there is one, else unused
    const float4 floor4 = make_float4(kNoFloor, kNoFloor, kNoFloor, kNoFloor);
    float4 bq = ld4(tb), cq = ld4(tc), aq = kFloor ? ld4(ta) : floor4;
    // four samples, the next four loaded first (unit q+1 is at most the
    // row's padding unit)
    auto group = [&](int q) {
      const float4 bn = ld4(tb + 4 * q + 4), cn = ld4(tc + 4 * q + 4);
      const float4 an = kFloor ? ld4(ta + 4 * q + 4) : floor4;
      float4 o;
      yv = fmaxf(aq.x, bq.x * yv + cq.x);
      o.x = yv;
      yv = fmaxf(aq.y, bq.y * yv + cq.y);
      o.y = yv;
      yv = fmaxf(aq.z, bq.z * yv + cq.z);
      o.z = yv;
      yv = fmaxf(aq.w, bq.w * yv + cq.w);
      o.w = yv;
      st4(out[0] + 4 * q, o);
      aq = an;
      bq = bn;
      cq = cn;
    };
    const int full = len >> 2;
    walk_groups(full, group);
    const int rem = len & 3;   // only where B % 4 != 0: the last chunk's tail
    float* o = out[0] + 4 * full;
    if (rem > 0) o[0] = yv = fmaxf(aq.x, bq.x * yv + cq.x);
    if (rem > 1) o[1] = yv = fmaxf(aq.y, bq.y * yv + cq.y);
    if (rem > 2) o[2] = yv = fmaxf(aq.z, bq.z * yv + cq.z);
  };
  if constexpr (kFloor) {
    const float* const src[3] = {b, c, a};
    staged_rows(src, dst, s, walk);
  } else {
    const float* const src[2] = {b, c};
    staged_rows(src, dst, s, walk);
  }
  if (threadIdx.x < s.rows) y_last[v] = yv;
}

// --- 2. pink_bank: Kellet 3-pole pink filter + direct term -----------------
//
// Staged (row_stage.cuh) with its reset mask as a byte tile, as svf_bank: a
// walker steps its row four samples at a time from the float4s of w and one
// 32-bit word of four reset flags, the three poles in registers, and writes
// pink four at a time.  Without a mask (reset == nullptr, kReset false) no
// flag is read.  The poles are independent; each carries a multiply, the
// reset's select and an add a sample.

struct PinkCoefs {
  float pole[3];
  float gain[3];
  float direct;
  float outg;
};

template <bool kReset>
__global__ void __launch_bounds__(kStageThreads)
    pink_bank_kernel(const float* __restrict__ w, const uint8_t* __restrict__ reset,
                     const float* __restrict__ fstate, float* __restrict__ pink,
                     float* __restrict__ fstate_out, PinkCoefs k, int V, int B, int rc,
                     int vec) {
  const float* const src[1] = {w};
  float* const dst[1] = {pink};
  const RowSpan s = row_span(V, B, rc, vec);
  const int v = s.row0 + threadIdx.x;
  const bool live = threadIdx.x < s.rows;
  float y0 = live ? fstate[3 * v + 0] : 0.0f;
  float y1 = live ? fstate[3 * v + 1] : 0.0f;
  float y2 = live ? fstate[3 * v + 2] : 0.0f;
  auto walk = [&](const auto& in, const auto& out, const uint8_t* m, int len) {
    // one sample: a trigger reset zeroes the incoming state (ops/noise.py
    // pink_block), then the three poles and the direct term
    auto step = [&](uint32_t rst, float wn) {
      const bool r = kReset && rst != 0;
      y0 = (r ? 0.0f : k.pole[0] * y0) + k.gain[0] * wn;
      y1 = (r ? 0.0f : k.pole[1] * y1) + k.gain[1] * wn;
      y2 = (r ? 0.0f : k.pole[2] * y2) + k.gain[2] * wn;
      return (y0 + y1 + y2 + k.direct * wn) * k.outg;
    };
    float4 wq = ld4(in[0]);
    uint32_t fq = kReset ? ld_flags(m) : 0u;
    // four samples, the next four loaded first (unit q+1 is at most the
    // row's padding unit)
    auto group = [&](int q) {
      const float4 wn = ld4(in[0] + 4 * q + 4);
      const uint32_t fn = kReset ? ld_flags(m + 4 * q + 4) : 0u;
      float4 o;
      o.x = step(fq & 0xffu, wq.x);
      o.y = step(fq & 0xff00u, wq.y);
      o.z = step(fq & 0xff0000u, wq.z);
      o.w = step(fq & 0xff000000u, wq.w);
      st4(out[0] + 4 * q, o);
      wq = wn;
      fq = fn;
    };
    const int full = len >> 2;
    walk_groups(full, group);
    const int rem = len & 3;   // only where B % 4 != 0: the last chunk's tail
    float* o = out[0] + 4 * full;
    if (rem > 0) o[0] = step(fq & 0xffu, wq.x);
    if (rem > 1) o[1] = step(fq & 0xff00u, wq.y);
    if (rem > 2) o[2] = step(fq & 0xff0000u, wq.z);
  };
  staged_rows_masked<kReset>(src, dst, reset, s, walk);
  if (live) {
    fstate_out[3 * v + 0] = y0;
    fstate_out[3 * v + 1] = y1;
    fstate_out[3 * v + 2] = y2;
  }
}

// --- 3. svf_bank: TPT (Simper) SVF with per-sample g, h and reset ----------
//
// Staged (row_stage.cuh) with its reset mask as a byte tile: a walker steps
// its row four samples at a time from the float4s of x, g and h and one
// 32-bit word of four reset flags, the next four already in registers, and
// writes v1 and v2 four at a time.  Without a mask (reset == nullptr,
// kReset false) no flag is read.  The carried chain is ~8 dependent float
// operations a sample (ic2 -> x - ic2 -> *g -> +ic1 -> *h -> g*v1 -> +ic2
// -> 2*v2 - ic2), in the plain version's order.

template <bool kReset>
__global__ void __launch_bounds__(kStageThreads)
    svf_bank_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ h, const uint8_t* __restrict__ reset,
                    const float* __restrict__ ic1_in, const float* __restrict__ ic2_in,
                    float* __restrict__ v1_out, float* __restrict__ v2_out,
                    float* __restrict__ ic1_out, float* __restrict__ ic2_out, int V, int B,
                    int rc, int vec) {
  const float* const src[3] = {x, g, h};
  float* const dst[2] = {v1_out, v2_out};
  const RowSpan s = row_span(V, B, rc, vec);
  const int v = s.row0 + threadIdx.x;
  const bool live = threadIdx.x < s.rows;
  float ic1 = live ? ic1_in[v] : 0.0f;
  float ic2 = live ? ic2_in[v] : 0.0f;
  auto walk = [&](const auto& in, const auto& out, const uint8_t* m, int len) {
    // one sample: a reset zeroes the incoming state, then the TPT step
    auto step = [&](uint32_t rst, float xn, float gn, float hn, float& o1, float& o2) {
      if (kReset && rst != 0) {
        ic1 = 0.0f;
        ic2 = 0.0f;
      }
      const float v1 = (gn * (xn - ic2) + ic1) * hn;
      const float v2 = ic2 + gn * v1;
      o1 = v1;
      o2 = v2;
      ic1 = 2.0f * v1 - ic1;
      ic2 = 2.0f * v2 - ic2;
    };
    float4 xq = ld4(in[0]), gq = ld4(in[1]), hq = ld4(in[2]);
    uint32_t fq = kReset ? ld_flags(m) : 0u;
    // four samples, the next four loaded first (unit q+1 is at most the
    // row's padding unit)
    auto group = [&](int q) {
      const float4 xn = ld4(in[0] + 4 * q + 4), gn = ld4(in[1] + 4 * q + 4),
                   hn = ld4(in[2] + 4 * q + 4);
      const uint32_t fn = kReset ? ld_flags(m + 4 * q + 4) : 0u;
      float4 o1, o2;
      step(fq & 0xffu, xq.x, gq.x, hq.x, o1.x, o2.x);
      step(fq & 0xff00u, xq.y, gq.y, hq.y, o1.y, o2.y);
      step(fq & 0xff0000u, xq.z, gq.z, hq.z, o1.z, o2.z);
      step(fq & 0xff000000u, xq.w, gq.w, hq.w, o1.w, o2.w);
      st4(out[0] + 4 * q, o1);
      st4(out[1] + 4 * q, o2);
      xq = xn;
      gq = gn;
      hq = hn;
      fq = fn;
    };
    const int full = len >> 2;
    walk_groups(full, group);
    const int rem = len & 3;   // only where B % 4 != 0: the last chunk's tail
    float* o1 = out[0] + 4 * full;
    float* o2 = out[1] + 4 * full;
    if (rem > 0) step(fq & 0xffu, xq.x, gq.x, hq.x, o1[0], o2[0]);
    if (rem > 1) step(fq & 0xff00u, xq.y, gq.y, hq.y, o1[1], o2[1]);
    if (rem > 2) step(fq & 0xff0000u, xq.z, gq.z, hq.z, o1[2], o2[2]);
  };
  staged_rows_masked<kReset>(src, dst, reset, s, walk);
  if (live) {
    ic1_out[v] = ic1;
    ic2_out[v] = ic2;
  }
}

// --- 4. env_follow_bank: attack/release follower with freeze ---------------
//
// Staged (row_stage.cuh) with its freeze mask as a byte tile, as pink_bank's
// resets are, but a set flag holds the state: a walker steps its row four
// samples at a time from the float4s of rect and one 32-bit word of four
// freeze flags, the next four already in registers, and writes env four at
// a time.  1 - c is a select between 1 - att and 1 - rel, each rounded once
// as the plain version rounds 1 - c, so the compare r > env and that select
// run beside r - env.  The carried chain is ~6 dependent operations a
// sample: r - env, the multiply, the add, the flush's compare and select,
// the freeze select.

__global__ void __launch_bounds__(kStageThreads)
    env_follow_bank_kernel(const float* __restrict__ rect, const uint8_t* __restrict__ freeze,
                           const float* __restrict__ env0, float* __restrict__ env_out,
                           float* __restrict__ env_last, float att, float rel, int V, int B,
                           int rc, int vec) {
  const float* const src[1] = {rect};
  float* const dst[1] = {env_out};
  const RowSpan s = row_span(V, B, rc, vec);
  const int v = s.row0 + threadIdx.x;
  const bool live = threadIdx.x < s.rows;
  const float keep_att = 1.0f - att, keep_rel = 1.0f - rel;
  float env = live ? env0[v] : 0.0f;
  auto walk = [&](const auto& in, const auto& out, const uint8_t* m, int len) {
    // one sample: the follower's step, flushed below 1e-15, held where frozen
    auto step = [&](uint32_t frozen, float r) {
      float nv = env + (r > env ? keep_att : keep_rel) * (r - env);
      nv = fabsf(nv) < 1e-15f ? 0.0f : nv;
      env = frozen != 0 ? env : nv;
      return env;
    };
    float4 rq = ld4(in[0]);
    uint32_t fq = ld_flags(m);
    // four samples, the next four loaded first (unit q+1 is at most the
    // row's padding unit)
    auto group = [&](int q) {
      const float4 rn = ld4(in[0] + 4 * q + 4);
      const uint32_t fn = ld_flags(m + 4 * q + 4);
      float4 o;
      o.x = step(fq & 0xffu, rq.x);
      o.y = step(fq & 0xff00u, rq.y);
      o.z = step(fq & 0xff0000u, rq.z);
      o.w = step(fq & 0xff000000u, rq.w);
      st4(out[0] + 4 * q, o);
      rq = rn;
      fq = fn;
    };
    const int full = len >> 2;
    walk_groups(full, group);
    const int rem = len & 3;   // only where B % 4 != 0: the last chunk's tail
    float* o = out[0] + 4 * full;
    if (rem > 0) o[0] = step(fq & 0xffu, rq.x);
    if (rem > 1) o[1] = step(fq & 0xff00u, rq.y);
    if (rem > 2) o[2] = step(fq & 0xff0000u, rq.z);
  };
  staged_rows_masked<true>(src, dst, freeze, s, walk);
  if (live) env_last[v] = env;
}

// --- 5-6. fbws_bank and ws4_bank: the 4x chain split over warps -------------
//
// fbws_bank, the kick's zero-feedback feedback waveshaper: the 4x chain of
// ovs4.cuh around tanh, then the signed makeup gain and the bypass-gated DC
// blocker on each base-rate output.  ws4_bank, the plain waveshaper
// tanh(v*d)*comp: the same chain with the waveshaper's nonlinearity and no
// DC blocker; the packed DC rows pass through unchanged, the oversampler
// history advances at every sample (the caller applies the bypass select
// and the block-granular freeze, as on the TPU).  d = max(drive, 1 + 1e-6)
// and comp = tanh(0.5) / tanh(0.5 d) are per engine sample and held across
// its four subsamples.
//
// Both split the 4x chain over warps (ovs4.cuh's split form): a block owns
// rc rows (the staged kernels' rows per block), cut into chunks of 32
// samples.  In step j, warp 0's lanes (a lane per row) walk the up-path of
// chunk j from its staged input into a ring of subsample tiles; the warps
// past the first two (two in ws4_bank's blocks of 128 threads, six in
// fbws_bank's of 256) shape chunk j-1's subsamples in place (ws4_bank with
// each sample's drive gain), copy chunk j+2 of the input and
// of the second array (ws4_bank's drive, fbws_bank's comp_signed) in with
// cp.async and store chunk j-3 of the output; warp 1's lanes walk the
// down-path of chunk j-2 into an output tile, fbws_bank's through the gated
// DC blocker with chunk j-2's comp_signed from the ring, as kit_drive's
// down lane carries the kick's (so the ring holds five chunks, j-2 to j+2).
// One __syncthreads a step.  The two walks hold disjoint halves of the
// state (the DC rows in the down half), each loaded and stored by its own
// warp, coalesced across the rows.  A walk is ~50-60 float operations a
// sample on one warp; its carried chains are short (a stage-2 section steps
// twice a sample: 6 dependent operations; the DC blocker's 2 run beside
// them), so a step is bound by the walks' issue while the shaping warps
// keep up: ws4_bank's two with its five tanhf a row-sample at rc <= ~16
// (8 at 1,024 rows), fbws_bank's six with four at its 32 rows a block at
// 4,096 rows (on two warps they set the pace there: ~41 us alone on an
// H100).

constexpr int kSplitChunk = 32;      // samples a chunk
constexpr int kSplitRing = 5;        // input chunks: down / shaped / up / two in flight
constexpr int kSplitSubRing = 3;     // subsample chunks: walked up / shaped / walked down
constexpr int kSplitSubPitch = 4 * kSplitChunk + 4;   // floats per row of subsamples
constexpr float kDriveFloor = 1.000001f;              // 1 + 1e-6 in float32

// The staging of a split kernel of kThreads threads: warps 0 and 1 walk,
// the rest shape and copy.
template <int kThreads>
using SplitStage = StageGeom<kSplitChunk, kThreads - 64>;

constexpr size_t split4x_smem_bytes(int rc) {
  constexpr int pitch = SplitStage<128>::kPitch;
  return static_cast<size_t>(rc) *
         (kSplitRing * 2 * pitch + kSplitSubRing * kSplitSubPitch + 2 * pitch) * sizeof(float);
}

// ws4_bank's nonlinearity, with its sample's drive gain; its down-walk's
// output is the kernel's.
struct Ws4Body {
  static constexpr int kThreads = 128;
  float tanh_half;
  __device__ __forceinline__ void shape(float dv, float4& t) const {
    const float d = dv < kDriveFloor ? kDriveFloor : dv;   // NaN stays NaN
    const DriveShaper f{d, tanh_half / tanhf(0.5f * d)};
    t.x = f(t.x);
    t.y = f(t.y);
    t.z = f(t.z);
    t.w = f(t.w);
  }
  __device__ __forceinline__ float down(FbwsState&, float, float y) const { return y; }
};

// fbws_bank's: tanh at each subsample; the down-walk's output through the
// gated DC blocker with its sample's comp_signed.
struct FbwsBody {
  static constexpr int kThreads = 256;
  __device__ __forceinline__ void shape(float, float4& t) const {
    const TanhShaper f;
    t.x = f(t.x);
    t.y = f(t.y);
    t.z = f(t.z);
    t.w = f(t.w);
  }
  __device__ __forceinline__ float down(FbwsState& s, float cs, float y) const {
    return gated_dc(s, y, cs);
  }
};

// The block's rows of x (with the second array `aux`) through the split
// chain into y_out; the packed state from st_in to st_out.
template <class Body>
__device__ __forceinline__ void split4x_rows(const float* __restrict__ x,
                                             const float* __restrict__ aux,
                                             const float* __restrict__ st_in,
                                             float* __restrict__ y_out,
                                             float* __restrict__ st_out, const FbwsCoefs& k,
                                             const Body& body, int V, int B, int rc, int vec) {
  using G = SplitStage<Body::kThreads>;
  extern __shared__ float4 split_smem4[];
  const RowSpanG<G> s = row_span<G>(V, B, rc, vec);
  float* ring = reinterpret_cast<float*>(split_smem4);   // [kSplitRing][x, aux][rc][pitch]
  float* subs = ring + kSplitRing * 2 * s.tile();        // [kSplitSubRing][rc][kSplitSubPitch]
  float* outs = subs + kSplitSubRing * rc * kSplitSubPitch;   // [2][rc][pitch]
  const float* const src[2] = {x, aux};
  float* const dst[1] = {y_out};
  const int n_chunks = s.chunks();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool walks = warp < 2 && lane < s.rows;
  const int v = s.row0 + lane;
  const int p = threadIdx.x - 64;   // shaper / copier index (the warps past 1)

  FbwsState st;
  OvsCaps cap;
  if (walks) {
    if (warp == 0) {
      load_up_state(st, st_in, v, V);
    } else {
      load_down_state(st, st_in, v, V);
    }
  }
  if (warp >= 2) {
    for (int c = 0; c < 2; ++c) stage_in(src, ring + c * 2 * s.tile(), s, c, n_chunks, p);
  }
  for (int j = 0; j < n_chunks + 2; ++j) {
    if (warp >= 2) cp_async_wait<kStageRing - 2>();   // chunk j has landed (this copier's part)
    __syncthreads();                       // ... all of it; step j-1 done everywhere
    if (warp == 0) {
      if (walks && j < n_chunks) {
        const int n0 = s.start(j);
        const float* xr = ring + (j % kSplitRing) * 2 * s.tile() + lane * G::kPitch;
        float* sub = subs + ((j % kSplitSubRing) * rc + lane) * kSplitSubPitch;
        ovs4_up_span(
            st, cap, k, n0, n0 + s.len(j), B, [&](int n) { return xr[n - n0]; }, sub);
      }
    } else if (warp == 1) {
      if (walks && j >= 2) {
        const int c = j - 2, n0 = s.start(c);
        const float* sub = subs + ((c % kSplitSubRing) * rc + lane) * kSplitSubPitch;
        const float* ar = ring + ((c % kSplitRing) * 2 + 1) * s.tile() + lane * G::kPitch;
        float* yr = outs + (c & 1) * s.tile() + lane * G::kPitch;
        ovs4_down_span(st, cap, k, n0, n0 + s.len(c), B, sub, [&](int n, float y) {
          yr[n - n0] = body.down(st, ar[n - n0], y);
        });
      }
    } else {
      stage_in(src, ring + ((j + 2) % kSplitRing) * 2 * s.tile(), s, j + 2, n_chunks, p);
      if (j >= 3) stage_out(dst, outs + ((j - 3) & 1) * s.tile(), s, j - 3, p);
      if (j >= 1 && j <= n_chunks) {
        // chunk j-1's subsamples, shaped in place (with their sample's aux)
        const int c = j - 1, len = s.len(c);
        const float* ar = ring + ((c % kSplitRing) * 2 + 1) * s.tile();
        float* sub = subs + (c % kSplitSubRing) * rc * kSplitSubPitch;
        for (int i = p; i < s.rows * len; i += G::kCopiers) {
          const int r = len == kSplitChunk ? i / kSplitChunk : i / len;
          const int n = i - r * len;
          float* q = sub + r * kSplitSubPitch + 4 * n;
          float4 t = ld4(q);
          body.shape(ar[r * G::kPitch + n], t);
          st4(q, t);
        }
      }
    }
  }
  __syncthreads();
  if (warp >= 2) stage_out(dst, outs + ((n_chunks - 1) & 1) * s.tile(), s, n_chunks - 1, p);
  if (walks) {
    if (warp == 0) {
      store_up_state(st, cap.u1, cap.u2, st_out, v, V);
    } else {
      store_down_state(st, cap.d2, cap.d1, st_out, v, V);
    }
  }
}

__global__ void __launch_bounds__(FbwsBody::kThreads)
    fbws_bank_kernel(const float* __restrict__ u, const float* __restrict__ cs,
                     const float* __restrict__ st_in, float* __restrict__ dc_out,
                     float* __restrict__ st_out, FbwsCoefs k, int V, int B, int rc, int vec) {
  split4x_rows(u, cs, st_in, dc_out, st_out, k, FbwsBody{}, V, B, rc, vec);
}

__global__ void __launch_bounds__(Ws4Body::kThreads)
    ws4_bank_kernel(const float* __restrict__ x, const float* __restrict__ drive,
                    const float* __restrict__ st_in, float* __restrict__ y_out,
                    float* __restrict__ st_out, FbwsCoefs k, float tanh_half, int V, int B,
                    int rc, int vec) {
  split4x_rows(x, drive, st_in, y_out, st_out, k, Ws4Body{tanh_half}, V, B, rc, vec);
}

// --- 7. linrec2_bank: s[n] = A[n] s[n-1] + b[n], 2-vector state -------------
//
// The biquads, the 2x-iterated Chamberlin and the membrane bands (R = V*5
// rows).  Both updates read the old state, in the Pallas body's order
// (a11*s1 + a12*s2) + b1, with the first multiply-add fused as XLA fuses it
// (fma(a11, s1, a12*s2) + b1, bit-exact against the JAX wrapper on the CPU;
// rounded twice it drifts by ~2e-5 of the signal in a high-Q band).  The
// explicit fmaf is kept by the -fmad=false build, which only stops the
// compiler from contracting on its own.  High-Q resonators ring across
// blocks, so the order is kept exactly.  Returns the post-update
// trajectories.
//
// Staged (row_stage.cuh): a walker steps its row four samples at a time from
// the float4s of the six coefficient rows, the next four in registers ahead
// of the chain, and writes s1 and s2 four at a time.

__global__ void __launch_bounds__(kStageThreads)
    linrec2_bank_kernel(const float* __restrict__ a11, const float* __restrict__ a12,
                        const float* __restrict__ a21, const float* __restrict__ a22,
                        const float* __restrict__ b1, const float* __restrict__ b2,
                        const float* __restrict__ s1_0, const float* __restrict__ s2_0,
                        float* __restrict__ s1_out, float* __restrict__ s2_out,
                        float* __restrict__ s1_last, float* __restrict__ s2_last, int R,
                        int B, int rc, int vec) {
  const float* const src[6] = {a11, a12, a21, a22, b1, b2};
  float* const dst[2] = {s1_out, s2_out};
  const RowSpan s = row_span(R, B, rc, vec);
  const int r = s.row0 + threadIdx.x;
  const bool live = threadIdx.x < s.rows;
  float s1 = live ? s1_0[r] : 0.0f;
  float s2 = live ? s2_0[r] : 0.0f;
  staged_rows(src, dst, s, [&](const auto& in, const auto& out, int len) {
    float4 q[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) q[i] = ld4(in[i]);
    // one step from the old state, in the Pallas body's order
    auto step = [&](float m11, float m12, float m21, float m22, float c1, float c2) {
      const float n1 = fmaf(m11, s1, m12 * s2) + c1;
      const float n2 = fmaf(m21, s1, m22 * s2) + c2;
      s1 = n1;
      s2 = n2;
    };
    // four samples, the next four loaded first (unit u+1 is at most the
    // row's padding unit)
    auto group = [&](int u) {
      float4 nq[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) nq[i] = ld4(in[i] + 4 * u + 4);
      float4 o1, o2;
      step(q[0].x, q[1].x, q[2].x, q[3].x, q[4].x, q[5].x);
      o1.x = s1;
      o2.x = s2;
      step(q[0].y, q[1].y, q[2].y, q[3].y, q[4].y, q[5].y);
      o1.y = s1;
      o2.y = s2;
      step(q[0].z, q[1].z, q[2].z, q[3].z, q[4].z, q[5].z);
      o1.z = s1;
      o2.z = s2;
      step(q[0].w, q[1].w, q[2].w, q[3].w, q[4].w, q[5].w);
      o1.w = s1;
      o2.w = s2;
      st4(out[0] + 4 * u, o1);
      st4(out[1] + 4 * u, o2);
#pragma unroll
      for (int i = 0; i < 6; ++i) q[i] = nq[i];
    };
    const int full = len >> 2;
    walk_groups(full, group);
    const int rem = len & 3;   // only where B % 4 != 0: the last chunk's tail
    float* o1 = out[0] + 4 * full;
    float* o2 = out[1] + 4 * full;
    if (rem > 0) {
      step(q[0].x, q[1].x, q[2].x, q[3].x, q[4].x, q[5].x);
      o1[0] = s1;
      o2[0] = s2;
    }
    if (rem > 1) {
      step(q[0].y, q[1].y, q[2].y, q[3].y, q[4].y, q[5].y);
      o1[1] = s1;
      o2[1] = s2;
    }
    if (rem > 2) {
      step(q[0].z, q[1].z, q[2].z, q[3].z, q[4].z, q[5].z);
      o1[2] = s1;
      o2[2] = s2;
    }
  });
  if (live) {
    s1_last[r] = s1;
    s2_last[r] = s2;
  }
}

// --- 8. mix_bank: smoothed pan/gain, equal-power pan, sums over voices -------
//
// No recurrence: per (voice, sample) the smoothers' closed form tgt +
// snap((cur - tgt) * q^(k+1)) for pan and gain, then x*gain*cos(ang),
// x*gain*sin(ang) and x*gain with ang = clip(pan, 0, 1)*pi/2, summed over
// the voices.  Float atomics would sum in a different order every run, so
// the sums are ordered: each 256-voice chunk's voices in order, then the
// chunks in order.  The plain version (ops/bank_kernels.py) repeats that
// order.
//
// A block of kMixThreads threads owns one chunk and a tile of kMixTile
// samples: 16 chunks x 16 tiles = 256 blocks at the kit's 4,096 voices and
// B = 512, two to an SM.  Its threads copy the tile of x into shared memory
// with cp.async and, meanwhile, find the largest |w| of the block's powers
// and take the chunk's voices, a thread each.  A voice whose pan is settled
// for the whole block, |(cur - tgt) * w| < 1e-4 at that largest w (the
// product's rounding is monotone in |w|, so the test covers every sample;
// a NaN settles nothing), has the pan tgt + 0 at every sample: its cosf and
// sinf are taken once, bit for bit those of every sample (the JAX engine's
// settled-pan branch, engine.py:408-422, taken per voice).  Then a thread
// per (voice, four samples) computes the tile's three terms into shared
// memory as float4s, the unsettled voices' cosf and sinf per sample; then a
// thread per (term, sample) adds the chunk's terms in voice order, a
// 256-step chain, its loads eight ahead.  A second kernel adds the chunks'
// partial sums in order (with one chunk the first kernel writes 0 + its
// sum itself).  Bound by bytes: V*B*4 read once (8.4 MB at the kit's 4,096
// voices); each block's phases run one after another (the copy, the terms,
// the chain), and an unsettled voice's cosf and sinf cost ~50
// instructions a (voice, sample), so the kernel stays well above that
// bound, least where the pans are settled (in every kit cell they are
// fixed).

constexpr int kMixChunk = 256;
constexpr int kMixTile = 32;                 // samples a block
constexpr int kMixQuads = kMixTile / 4;      // four samples a thread: a warp takes four rows
constexpr int kMixThreads = 256;             // a voice of the chunk each, then (voice, quad)s
constexpr int kMixTerm = kMixChunk * kMixTile;   // floats of one term's tile
constexpr size_t kMixSmem = 3 * kMixTerm * sizeof(float);
constexpr float kSettleEps = 1e-4f;  // core/constants.py SMOOTHER_SETTLE_EPS
constexpr float kHalfPi = static_cast<float>(3.14159265358979323846 / 2.0);

// The larger of a and b, a NaN in either kept.
__device__ __forceinline__ float nan_max(float a, float b) { return a != a || a > b ? a : b; }

// A smoother's value at power w: tgt + snap((cur - tgt) * w).
__device__ __forceinline__ float snapped(float cur, float tgt, float w) {
  const float d = (cur - tgt) * w;
  return tgt + (fabsf(d) < kSettleEps ? 0.0f : d);
}

__device__ __forceinline__ float pan_angle(float pan) {
  return fminf(fmaxf(pan, 0.0f), 1.0f) * kHalfPi;
}

__global__ void __launch_bounds__(kMixThreads)
    mix_bank_partial_kernel(const float* __restrict__ x, const float* __restrict__ pan_cur,
                            const float* __restrict__ pan_tgt,
                            const float* __restrict__ gain_cur,
                            const float* __restrict__ gain_tgt, const float* __restrict__ pw,
                            float* __restrict__ part, float* __restrict__ out_l,
                            float* __restrict__ out_r, float* __restrict__ out_m, int V,
                            int B) {
  extern __shared__ float4 mix_smem4[];
  float* terms = reinterpret_cast<float*>(mix_smem4);   // [3][kMixChunk][kMixTile]
  float* xs = terms + 2 * kMixTerm;                     // x, then x*gain in place
  __shared__ float wmax[kMixThreads];
  __shared__ float4 ws[kMixQuads];           // the tile's powers, 0 past B
  __shared__ float4 gains[kMixChunk];        // gain cur, tgt; a settled pan's cos, sin
  __shared__ float2 pans[kMixChunk];         // pan cur, tgt
  __shared__ int settled[kMixChunk];
  const int t = threadIdx.x, c = blockIdx.y, k0 = blockIdx.x * kMixTile;
  const int v0 = c * kMixChunk, nv = min(kMixChunk, V - v0), len = min(kMixTile, B - k0);

  // the tile of x, 16 bytes a copy where every row allows it
  const bool vec = B % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int wid = vec ? 4 : 1, n = vec ? len >> 2 : len;   // floats a copy, copies a row
  for (int u = t; u < nv * n; u += kMixThreads) {
    const int r = u / n, j = u - r * n;
    const float* g = x + static_cast<size_t>(v0 + r) * B + k0 + wid * j;
    if (vec) {
      cp_async16(xs + r * kMixTile + wid * j, g);
    } else {
      cp_async4(xs + r * kMixTile + j, g);
    }
  }
  cp_async_commit();

  // the largest |w| of the block's powers; the tile's
  if (t < kMixTile) reinterpret_cast<float*>(ws)[t] = t < len ? pw[k0 + t] : 0.0f;
  float m = 0.0f;
  for (int i = t; i < B; i += kMixThreads) m = nan_max(m, fabsf(pw[i]));
  wmax[t] = m;
  __syncthreads();
  for (int h = kMixThreads / 2; h > 0; h >>= 1) {
    if (t < h) wmax[t] = nan_max(wmax[t], wmax[t + h]);
    __syncthreads();
  }
  // the chunk's voices; a settled pan's cosine and sine (0 for the others)
  if (t < nv) {
    const float pc = pan_cur[v0 + t], pt = pan_tgt[v0 + t];
    const bool still = fabsf((pc - pt) * wmax[0]) < kSettleEps;
    const float ang = pan_angle(pt + 0.0f);
    gains[t] = make_float4(gain_cur[v0 + t], gain_tgt[v0 + t], still ? cosf(ang) : 0.0f,
                           still ? sinf(ang) : 0.0f);
    pans[t] = make_float2(pc, pt);
    settled[t] = still;
  }
  cp_async_wait<0>();
  __syncthreads();

  // the tile's terms, a thread per (voice, four samples); past len they are
  // never summed
  const int nq = (len + 3) >> 2;
  for (int u = t; u < nv * kMixQuads; u += kMixThreads) {
    const int i = u / kMixQuads, q = u - i * kMixQuads;
    if (q >= nq) continue;
    const float4 g = gains[i], w = ws[q];
    float* xq = xs + i * kMixTile + 4 * q;
    float4 sh = ld4(xq);
    sh.x = sh.x * snapped(g.x, g.y, w.x);
    sh.y = sh.y * snapped(g.x, g.y, w.y);
    sh.z = sh.z * snapped(g.x, g.y, w.z);
    sh.w = sh.w * snapped(g.x, g.y, w.w);
    float4 l, r;
    if (settled[i]) {
      l = make_float4(sh.x * g.z, sh.y * g.z, sh.z * g.z, sh.w * g.z);
      r = make_float4(sh.x * g.w, sh.y * g.w, sh.z * g.w, sh.w * g.w);
    } else {
      const float2 p = pans[i];
      const float a0 = pan_angle(snapped(p.x, p.y, w.x));
      const float a1 = pan_angle(snapped(p.x, p.y, w.y));
      const float a2 = pan_angle(snapped(p.x, p.y, w.z));
      const float a3 = pan_angle(snapped(p.x, p.y, w.w));
      l = make_float4(sh.x * cosf(a0), sh.y * cosf(a1), sh.z * cosf(a2), sh.w * cosf(a3));
      r = make_float4(sh.x * sinf(a0), sh.y * sinf(a1), sh.z * sinf(a2), sh.w * sinf(a3));
    }
    st4(xq - 2 * kMixTerm, l);
    st4(xq - kMixTerm, r);
    st4(xq, sh);
  }
  __syncthreads();

  // a thread per (term, sample): the chunk's voices in order, eight at a
  // time with the next eight loaded ahead of the adds
  const int warp = t >> 5, lane = t & 31;
  if (warp < 3 && lane < len) {
    const float* q = terms + warp * kMixTerm + lane;
    const int full = nv & ~7;
    float sum = 0.0f, a[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) a[u] = u < full ? q[u * kMixTile] : 0.0f;
    for (int i = 8; i < full; i += 8) {
      float b[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) b[u] = q[(i + u) * kMixTile];
#pragma unroll
      for (int u = 0; u < 8; ++u) sum = sum + a[u];
#pragma unroll
      for (int u = 0; u < 8; ++u) a[u] = b[u];
    }
    if (full > 0) {
#pragma unroll
      for (int u = 0; u < 8; ++u) sum = sum + a[u];
    }
    for (int i = full; i < nv; ++i) sum = sum + q[i * kMixTile];
    if (V <= kMixChunk) {   // one chunk: its sum is the mix
      (warp == 0 ? out_l : warp == 1 ? out_r : out_m)[k0 + lane] = 0.0f + sum;
    } else {
      part[(static_cast<size_t>(c) * 3 + warp) * B + k0 + lane] = sum;
    }
  }
}

__global__ void mix_bank_sum_kernel(const float* __restrict__ part, int n_chunks,
                                    float* __restrict__ out_l, float* __restrict__ out_r,
                                    float* __restrict__ out_m, int B) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= B) return;
  float sl = 0.0f, sr = 0.0f, sm = 0.0f;
#pragma unroll 8
  for (int c = 0; c < n_chunks; ++c) {
    const float* p = part + static_cast<size_t>(c) * 3 * B;
    sl = sl + p[k];
    sr = sr + p[B + k];
    sm = sm + p[2 * B + k];
  }
  out_l[k] = sl;
  out_r[k] = sr;
  out_m[k] = sm;
}

template <bool kFloor>
int launch_affine1(const float* a, const float* b, const float* c, const float* y0,
                   float* y, float* y_last, int V, int B, int rc, int vec, void* stream) {
  const size_t smem = stage_smem_bytes(kFloor ? 3 : 2, 1, rc);
  const cudaError_t err = allow_smem(affine1_bank_kernel<kFloor>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  affine1_bank_kernel<kFloor><<<dim3((V + rc - 1) / rc), kStageThreads, smem,
                                 as_stream(stream)>>>(a, b, c, y0, y, y_last, V, B, rc, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool kReset>
int launch_pink(const float* w, const uint8_t* reset, const float* fstate, float* pink,
                float* fstate_out, const PinkCoefs& k, int V, int B, int rc, int vec,
                void* stream) {
  const size_t smem = stage_smem_bytes(1, 1, rc, kReset);
  const cudaError_t err = allow_smem(pink_bank_kernel<kReset>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pink_bank_kernel<kReset><<<dim3((V + rc - 1) / rc), kStageThreads, smem, as_stream(stream)>>>(
      w, reset, fstate, pink, fstate_out, k, V, B, rc, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool kReset>
int launch_svf(const float* x, const float* g, const float* h, const uint8_t* reset,
               const float* ic1, const float* ic2, float* v1, float* v2, float* ic1_out,
               float* ic2_out, int V, int B, int rc, int vec, void* stream) {
  const size_t smem = stage_smem_bytes(3, 2, rc, kReset);
  const cudaError_t err = allow_smem(svf_bank_kernel<kReset>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  svf_bank_kernel<kReset><<<dim3((V + rc - 1) / rc), kStageThreads, smem, as_stream(stream)>>>(
      x, g, h, reset, ic1, ic2, v1, v2, ic1_out, ic2_out, V, B, rc, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rc: rows per block (1..kStageMaxRows, the wrapper's choice); vec: 16-byte
// copies (B % 4 == 0 and every array 16-byte aligned).  a == nullptr: no
// floor.
int affine1_bank_launch(const float* a, const float* b, const float* c,
                        const float* y0, float* y, float* y_last, int V, int B, int rc,
                        int vec, void* stream) {
  if (rc < 1 || rc > kStageMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  return a != nullptr
             ? launch_affine1<true>(a, b, c, y0, y, y_last, V, B, rc, vec, stream)
             : launch_affine1<false>(a, b, c, y0, y, y_last, V, B, rc, vec, stream);
}

// coefs (host): pole[3], gain[3], direct, outg; rc, vec as
// affine1_bank_launch's; reset == nullptr: no resets.
int pink_bank_launch(const float* w, const uint8_t* reset, const float* fstate,
                     float* pink, float* fstate_out, const float* coefs, int V,
                     int B, int rc, int vec, void* stream) {
  if (rc < 1 || rc > kStageMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  PinkCoefs k;
  for (int i = 0; i < 3; ++i) {
    k.pole[i] = coefs[i];
    k.gain[i] = coefs[3 + i];
  }
  k.direct = coefs[6];
  k.outg = coefs[7];
  return reset != nullptr
             ? launch_pink<true>(w, reset, fstate, pink, fstate_out, k, V, B, rc, vec, stream)
             : launch_pink<false>(w, reset, fstate, pink, fstate_out, k, V, B, rc, vec, stream);
}

// rc, vec as affine1_bank_launch's; reset == nullptr: no resets.
int svf_bank_launch(const float* x, const float* g, const float* h,
                    const uint8_t* reset, const float* ic1, const float* ic2,
                    float* v1, float* v2, float* ic1_out, float* ic2_out, int V,
                    int B, int rc, int vec, void* stream) {
  if (rc < 1 || rc > kStageMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  return reset != nullptr
             ? launch_svf<true>(x, g, h, reset, ic1, ic2, v1, v2, ic1_out, ic2_out, V, B, rc,
                                vec, stream)
             : launch_svf<false>(x, g, h, reset, ic1, ic2, v1, v2, ic1_out, ic2_out, V, B, rc,
                                 vec, stream);
}

// rc, vec as affine1_bank_launch's; the freeze mask is required.
int env_follow_bank_launch(const float* rect, const uint8_t* freeze,
                           const float* env0, float* env, float* env_last,
                           float att, float rel, int V, int B, int rc, int vec,
                           void* stream) {
  if (rc < 1 || rc > kStageMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = stage_smem_bytes(1, 1, rc, true);
  const cudaError_t err = allow_smem(env_follow_bank_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  env_follow_bank_kernel<<<dim3((V + rc - 1) / rc), kStageThreads, smem, as_stream(stream)>>>(
      rect, freeze, env0, env, env_last, att, rel, V, B, rc, vec);
  return static_cast<int>(cudaGetLastError());
}

// coefs (host): the 4x chain's 12; rc: rows per block (1..kStageMaxRows);
// vec: 16-byte copies of u, comp_signed and dc.
int fbws_bank_launch(const float* u, const float* cs, const float* st_in,
                     float* dc, float* st_out, const float* coefs, int V, int B, int rc, int vec,
                     void* stream) {
  if (rc < 1 || rc > kStageMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = split4x_smem_bytes(rc);
  const cudaError_t err = allow_smem(fbws_bank_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fbws_bank_kernel<<<dim3((V + rc - 1) / rc), FbwsBody::kThreads, smem, as_stream(stream)>>>(
      u, cs, st_in, dc, st_out, fbws_coefs(coefs), V, B, rc, vec);
  return static_cast<int>(cudaGetLastError());
}

// coefs (host): the 4x chain's 12, then tanh(0.5) as the plain version
// rounds it; rc: rows per block (1..kStageMaxRows); vec: 16-byte copies of x,
// drive and y.
int ws4_bank_launch(const float* x, const float* drive, const float* st_in, float* y,
                    float* st_out, const float* coefs, int V, int B, int rc, int vec,
                    void* stream) {
  if (rc < 1 || rc > kStageMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = split4x_smem_bytes(rc);
  const cudaError_t err = allow_smem(ws4_bank_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ws4_bank_kernel<<<dim3((V + rc - 1) / rc), Ws4Body::kThreads, smem, as_stream(stream)>>>(
      x, drive, st_in, y, st_out, fbws_coefs(coefs), coefs[12], V, B, rc, vec);
  return static_cast<int>(cudaGetLastError());
}

int linrec2_bank_launch(const float* a11, const float* a12, const float* a21,
                        const float* a22, const float* b1, const float* b2,
                        const float* s1_0, const float* s2_0, float* s1, float* s2,
                        float* s1_last, float* s2_last, int R, int B, int rc, int vec,
                        void* stream) {
  if (rc < 1 || rc > kStageMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = stage_smem_bytes(6, 2, rc);
  const cudaError_t err = allow_smem(linrec2_bank_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  linrec2_bank_kernel<<<dim3((R + rc - 1) / rc), kStageThreads, smem, as_stream(stream)>>>(
      a11, a12, a21, a22, b1, b2, s1_0, s2_0, s1, s2, s1_last, s2_last, R, B, rc, vec);
  return static_cast<int>(cudaGetLastError());
}

// part: [n_chunks, 3, B] scratch from the wrapper (unused with one chunk)
int mix_bank_launch(const float* x, const float* pan_cur, const float* pan_tgt,
                    const float* gain_cur, const float* gain_tgt, const float* pw,
                    float* part, float* out_l, float* out_r, float* out_m, int V, int B,
                    void* stream) {
  const int n_chunks = (V + kMixChunk - 1) / kMixChunk;
  cudaError_t err = allow_smem(mix_bank_partial_kernel, kMixSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mix_bank_partial_kernel<<<dim3((B + kMixTile - 1) / kMixTile, n_chunks), kMixThreads,
                            kMixSmem, as_stream(stream)>>>(x, pan_cur, pan_tgt, gain_cur,
                                                           gain_tgt, pw, part, out_l, out_r,
                                                           out_m, V, B);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  mix_bank_sum_kernel<<<dim3((B + kThreads - 1) / kThreads), kThreads, 0, as_stream(stream)>>>(
      part, n_chunks, out_l, out_r, out_m, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
