// The plate reverb's sub-block recurrences for Hopper (sm_90a).
//
//   plate_block <- libgooey_tpu/ops/pallas_fx.py:plate_block (_plate_kernel)
//
// What it computes, per block of B samples of the mono plate input: the
// input-bandwidth one-pole, the four input-diffusion allpasses (static
// fractional lags of 158-562 samples at 44.1 kHz), the two damping
// one-poles on the tank's gathered d1 reads, and the two LFO-modulated
// allpasses (gain 0.70) at per-sample fractional lags.  The tank's own delay
// lines are feed-forward at block level and stay in PyTorch
// (effects/reverb_plate.py), as they stay in XLA around the TPU kernel.
//
// Design: one block of 512 threads on the plain version's own layout
// (ops/plate_kernels.py): work rows W_in [4, DIN+B] and W_mod [2, DMOD+B]
// in shared memory, the history on the left and the block's new values on
// the right, so that a read at lag L of sample n is column D+n-L and the new
// histories are W[:, B:B+D].
//
//  1. Load.  Every thread copies the histories into the rows' left parts
//     with cp.async (16 bytes a copy where the device row and the shared
//     row sit alike against a 16-byte boundary: each shared row has the
//     pitch D + B rounded up to 4, so it does where B % 4 == 0 and D % 4
//     matches, 4 bytes otherwise).
//  2. The one-poles, the only state carried from sample to sample, while
//     the copies land: warp 0 stages bw_b * x, then its lane 0 walks the
//     bandwidth filter in place (a multiply and an add a sample); warp 1
//     stages the damping and d1 * (1 - damping), its lane 0 walks both
//     damping filters and the warp stores them.  The walks read four
//     samples at a time, the next four ahead of the chain.
//  3. The chunks.  The host passes C: the smallest whole diffusion lag,
//     capped at 256 (158 at 44.1 kHz), so a sample of a chunk reads only
//     columns written before the chunk began.  Step j runs chunk j's input
//     diffusion (a thread a sample: its four lerped reads, the affine chain
//     and the four writes, in the plain version's order) and chunk j-1's
//     modulated allpasses (a thread a (branch, sample)), then one barrier.
//     The modulated lags move per sample and may legally fall to 1, so
//     chunk j's parallel form is valid only where every sample n has whole
//     lag >= n - c0 + 1; the barrier that ends step j is a
//     __syncthreads_and of that test, and where it fails, step j+1 walks
//     chunk j serially, one lane a branch, in this kernel.  In the engine
//     the lags never fall below ~225 samples (the size knob at 0).
//  4. Store.  Every thread copies W[:, B:B+D] to the new histories; the
//     allpasses' outputs went out coalesced as they were computed.
//
// What bounds it on the card: ~50 KB move per call and ~40 k operations are
// done, so the card's bound is tens of nanoseconds; the time is the latency
// of one SM: the copies in (~1-2 us), the bandwidth filter's chain (2
// dependent operations a sample, ~2.1 us at 512 samples and 1.98 GHz, run
// while the copies land), ceil(B/C) + 1 steps of a few hundred cycles and
// the copies out.  One SM of 132 is busy.  Shared memory is the work rows
// plus five [B] rows: 53 KB at 44.1 kHz and B = 512, 90 KB at 96 kHz (opt-in
// past 48 KB, rings.cuh); the wrapper refuses a shape past Hopper's 227 KB.
//
// Numerics: the Pallas body solves the one-poles with log-depth scans and
// the diffusion chain in its affine form per chunk; this kernel and its
// plain version step the one-poles sample by sample and evaluate the same
// affine form per sample, in the same op order, so they differ from the
// Pallas body at float-noise level.  Built with -fmad=false, the kernel and
// its plain version do the same roundings: they are bit-equal.
//
// The C entry launches on the caller's stream and returns
// cudaGetLastError(); nothing allocates or synchronizes here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rings.cuh"
#include "row_stage.cuh"

namespace {

constexpr int kInAps = 4;
constexpr int kPlateThreads = 512;
// a chunk's modulated allpasses take a thread a (branch, sample)
constexpr int kPlateMaxChunk = kPlateThreads / 2;

// Constants of the plate's sub-block path (ops/plate_kernels.py
// plate_constants), each rounded once to float32 on the host.
struct PlateConsts {
  float bw_a;            // 1 - bandwidth, the one-pole's feedback
  float bw_b;            // bandwidth, its input gain
  float g1;              // the modulated allpasses' gain (0.70)
  float alpha;           // product of the diffusion gains
  float g[kInAps];       // diffusion gains
  float omg[kInAps];     // 1 - g^2
  float sdir[kInAps];    // product of the gains before section i
  float frac[kInAps];    // fractional part of each diffusion lag
  int lag[kInAps];       // whole part of each diffusion lag
};

struct PlateArgs {
  const float* delayed_in;
  const float* fb_a;
  const float* fb_b;
  const float* damping;
  const float* d1a;
  const float* d1b;
  const float* mod_off;  // [2, B]
  const float* in_hist;  // [4, DIN]
  const float* mod_hist; // [2, DMOD]
  const float* seeds;    // [3] bandwidth, damp_a, damp_b
  float* a1;
  float* b1;
  float* da;
  float* db;
  float* in_hist_out;
  float* mod_hist_out;
  float* seeds_out;
  int din;
  int dmod;
};

// Offsets (floats) of the shared arrays: the work rows, then the
// bandwidth, the diffused signal and the damping rows.  A work row's pitch
// is D + B rounded up to 4, so row r starts at the same offset against a
// 16-byte boundary as row r of the [rows, D] history in device memory; the
// other arrays start 16-byte aligned, the walked rows with a float4 of
// padding for the walks' read-ahead.
struct PlateLayout {
  int pin, pmod;                 // work-row pitches
  int mod, bw, sig, dm, da, db;  // array offsets
  int total;                     // floats

  __host__ __device__ PlateLayout(int din, int dmod, int B) {
    const int b4 = (B + 3) & ~3;
    pin = din + b4;
    pmod = dmod + b4;
    mod = kInAps * pin;
    bw = (mod + 2 * pmod + 3) & ~3;
    sig = bw + b4 + 4;
    dm = sig + b4;
    da = dm + b4 + 4;
    db = da + b4 + 4;
    total = db + b4 + 4;
  }
};

// Threads t of n copy `len` floats from `src` to `dst`, one side in shared
// memory: 16 bytes a copy where both sit alike against a 16-byte boundary
// (after up to three single floats), 4 bytes otherwise.  kIn: device to
// shared with cp.async (committed by the caller); else shared to device.
template <bool kIn>
__device__ void copy_span(float* dst, const float* src, int len, int t, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const bool alike = ((a ^ reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const int head = alike ? min(len, static_cast<int>(((16 - (a & 15)) & 15) >> 2)) : len;
  const int body = (len - head) >> 2;
  auto one = [&](int i) {
    if (kIn) {
      cp_async4(dst + i, src + i);
    } else {
      dst[i] = src[i];
    }
  };
  for (int i = t; i < head; i += n) one(i);
  for (int i = t; i < body; i += n) {
    const int e = head + 4 * i;
    if (kIn) {
      cp_async16(dst + e, src + e);
    } else {
      st4(dst + e, ld4(src + e));
    }
  }
  for (int i = head + 4 * body + t; i < len; i += n) one(i);
}

// y = bw_a * y + u[n] over the staged u, in place, four samples at a time
// with the next four read ahead of the chain; returns the last y.
__device__ float walk_bandwidth(float* u, int B, float bw_a, float y) {
  const int full = B >> 2;
  float4 q = ld4(u);
#pragma unroll 4
  for (int g = 0; g < full; ++g) {
    const float4 nx = ld4(u + 4 * g + 4);
    float* o = u + 4 * g;
    o[0] = y = bw_a * y + q.x;
    o[1] = y = bw_a * y + q.y;
    o[2] = y = bw_a * y + q.z;
    o[3] = y = bw_a * y + q.w;
    q = nx;
  }
  const float r[3] = {q.x, q.y, q.z};
  for (int i = 0; i < (B & 3); ++i) u[4 * full + i] = y = bw_a * y + r[i];
  return y;
}

// The two damping one-poles y = dm[n] * y + c[n] over the staged rows, in
// place in ca / cb, four samples at a time.
__device__ void walk_damping(const float* dm, float* ca, float* cb, int B, float& ya,
                             float& yb) {
  const int full = B >> 2;
  float4 d = ld4(dm), qa = ld4(ca), qb = ld4(cb);
  auto one = [&](float dn, float an, float bn, int n) {
    ca[n] = ya = dn * ya + an;
    cb[n] = yb = dn * yb + bn;
  };
#pragma unroll 4
  for (int g = 0; g < full; ++g) {
    const int n = 4 * g;
    const float4 dn = ld4(dm + n + 4), an = ld4(ca + n + 4), bn = ld4(cb + n + 4);
    one(d.x, qa.x, qb.x, n);
    one(d.y, qa.y, qb.y, n + 1);
    one(d.z, qa.z, qb.z, n + 2);
    one(d.w, qa.w, qb.w, n + 3);
    d = dn;
    qa = an;
    qb = bn;
  }
  const float rd[3] = {d.x, d.y, d.z}, ra[3] = {qa.x, qa.y, qa.z}, rb[3] = {qb.x, qb.y, qb.z};
  for (int i = 0; i < (B & 3); ++i) one(rd[i], ra[i], rb[i], 4 * full + i);
}

// Sample m of the input diffusion, in the Pallas body's affine form: sig =
// alpha*bw + beta, section i's write (sdir_i*bw + sadd_i) - g_i*delayed_i.
__device__ __forceinline__ void diffuse(float* w_in, int pin, int din, const float* bw,
                                        float* sig, const PlateConsts& k, int m) {
  const float b = bw[m];
  float dv[kInAps], sadd[kInAps];
  float beta = 0.0f;
#pragma unroll
  for (int i = 0; i < kInAps; ++i) {
    const float* row = w_in + i * pin + din + m;
    const float av = row[-k.lag[i]];
    const float bv = row[-k.lag[i] - 1];
    dv[i] = av + k.frac[i] * (bv - av);
    sadd[i] = beta;
    beta = k.g[i] * beta + k.omg[i] * dv[i];
  }
  sig[m] = k.alpha * b + beta;
#pragma unroll
  for (int i = 0; i < kInAps; ++i) {
    w_in[i * pin + din + m] = (k.sdir[i] * b + sadd[i]) - k.g[i] * dv[i];
  }
}

// Sample m of one modulated allpass: its row of W_mod read at the lag `o`,
// the input sig + fb, the output to `out`.
__device__ __forceinline__ void mod_step(float* row, int dmod, const float* sig, float* out,
                                         float g1, int m, float o, float f) {
  const float whole = floorf(o);
  const float fr = o - whole;
  const int lag = static_cast<int>(whole);
  const float av = row[dmod + m - lag];
  const float bv = row[dmod + m - lag - 1];
  const float delayed = av + fr * (bv - av);
  const float v = (sig[m] + f) - g1 * delayed;
  out[m] = g1 * v + delayed;
  row[dmod + m] = v;
}

__global__ void __launch_bounds__(kPlateThreads)
    plate_block_kernel(PlateArgs a, PlateConsts k, int B, int C) {
  extern __shared__ float4 plate_smem4[];
  float* smem = reinterpret_cast<float*>(plate_smem4);
  const int DIN = a.din, DMOD = a.dmod;
  const PlateLayout lay(DIN, DMOD, B);
  float* w_in = smem;
  float* w_mod = smem + lay.mod;
  float* bw = smem + lay.bw;
  float* sig = smem + lay.sig;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  // 1. the histories into the work rows' left parts
  for (int r = 0; r < kInAps; ++r) {
    copy_span<true>(w_in + r * lay.pin, a.in_hist + static_cast<size_t>(r) * DIN, DIN, t,
                    kPlateThreads);
  }
  for (int r = 0; r < 2; ++r) {
    copy_span<true>(w_mod + r * lay.pmod, a.mod_hist + static_cast<size_t>(r) * DMOD, DMOD, t,
                    kPlateThreads);
  }
  cp_async_commit();

  // 2. the one-poles while the copies land
  if (warp == 0) {
    for (int n = lane; n < B; n += 32) bw[n] = k.bw_b * a.delayed_in[n];
    __syncwarp();
    if (lane == 0) a.seeds_out[0] = walk_bandwidth(bw, B, k.bw_a, a.seeds[0]);
  } else if (warp == 1) {
    float* dm = smem + lay.dm;
    float* ca = smem + lay.da;
    float* cb = smem + lay.db;
    for (int n = lane; n < B; n += 32) {
      const float d = a.damping[n];
      const float keep = 1.0f - d;
      dm[n] = d;
      ca[n] = a.d1a[n] * keep;
      cb[n] = a.d1b[n] * keep;
    }
    __syncwarp();
    if (lane == 0) {
      float ya = a.seeds[1], yb = a.seeds[2];
      walk_damping(dm, ca, cb, B, ya, yb);
      a.seeds_out[1] = ya;
      a.seeds_out[2] = yb;
    }
    __syncwarp();
    for (int n = lane; n < B; n += 32) {
      a.da[n] = ca[n];
      a.db[n] = cb[n];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. step j: chunk j's diffusion, chunk j-1's modulated allpasses
  const int nc = (B + C - 1) / C;
  const int br = t >= C ? 1 : 0;   // this thread's allpass branch and sample in a chunk
  const int mn = t - br * C;
  const bool mod_thread = t < 2 * C;
  float* mrow = w_mod + br * lay.pmod;
  float* out = br ? a.b1 : a.a1;
  const float* fb = br ? a.fb_a : a.fb_b;   // branch a takes the b feedback
  float o_prev = 0.0f, f_prev = 0.0f;
  bool serial_prev = false;
  for (int j = 0; j <= nc; ++j) {
    const int c0 = j * C;
    float o = 0.0f, f = 0.0f;
    bool parallel = true;
    if (j < nc) {
      const int len = min(C, B - c0);
      if (mod_thread && mn < len) {
        o = a.mod_off[static_cast<size_t>(br) * B + c0 + mn];
        f = fb[c0 + mn];
        parallel = static_cast<int>(floorf(o)) >= mn + 1;
      }
      if (t < len) diffuse(w_in, lay.pin, DIN, bw, sig, k, c0 + t);
    }
    if (j > 0) {
      const int p0 = c0 - C, plen = min(C, B - p0);
      if (!serial_prev) {
        if (mod_thread && mn < plen) mod_step(mrow, DMOD, sig, out, k.g1, p0 + mn, o_prev, f_prev);
      } else if (t == 0 || t == 32) {   // one lane a branch, in two warps
        const int sb = t == 32;
        float* row = w_mod + sb * lay.pmod;
        float* so = sb ? a.b1 : a.a1;
        const float* sf = sb ? a.fb_a : a.fb_b;
        const float* off = a.mod_off + static_cast<size_t>(sb) * B;
        for (int m = p0; m < p0 + plen; ++m) mod_step(row, DMOD, sig, so, k.g1, m, off[m], sf[m]);
      }
    }
    if (j < nc) {
      serial_prev = __syncthreads_and(parallel) == 0;
    } else {
      __syncthreads();
    }
    o_prev = o;
    f_prev = f;
  }

  // 4. the new histories: the work rows' last D columns
  for (int r = 0; r < kInAps; ++r) {
    copy_span<false>(a.in_hist_out + static_cast<size_t>(r) * DIN, w_in + r * lay.pin + B, DIN,
                     t, kPlateThreads);
  }
  for (int r = 0; r < 2; ++r) {
    copy_span<false>(a.mod_hist_out + static_cast<size_t>(r) * DMOD, w_mod + r * lay.pmod + B,
                     DMOD, t, kPlateThreads);
  }
}

}  // namespace

extern "C" {

// ptrs: the 10 inputs then the 7 outputs in PlateArgs order; consts: the
// 20 floats of PlateConsts before its lags; lags: the 4 diffusion lags' whole
// parts; C: samples a chunk, 1..256 and at most the smallest of lags.
int plate_block_launch(void* const* ptrs, const float* consts, const int* lags, int din,
                       int dmod, int B, int C, void* stream) {
  PlateArgs a;
  const float** in[] = {&a.delayed_in, &a.fb_a, &a.fb_b, &a.damping, &a.d1a,
                        &a.d1b, &a.mod_off, &a.in_hist, &a.mod_hist, &a.seeds};
  float** out[] = {&a.a1, &a.b1, &a.da, &a.db, &a.in_hist_out, &a.mod_hist_out,
                   &a.seeds_out};
  for (int i = 0; i < 10; ++i) *in[i] = static_cast<const float*>(ptrs[i]);
  for (int i = 0; i < 7; ++i) *out[i] = static_cast<float*>(ptrs[10 + i]);
  a.din = din;
  a.dmod = dmod;
  PlateConsts k;
  k.bw_a = consts[0];
  k.bw_b = consts[1];
  k.g1 = consts[2];
  k.alpha = consts[3];
  int min_lag = lags[0];
  for (int i = 0; i < kInAps; ++i) {
    k.g[i] = consts[4 + i];
    k.omg[i] = consts[8 + i];
    k.sdir[i] = consts[12 + i];
    k.frac[i] = consts[16 + i];
    k.lag[i] = lags[i];
    min_lag = lags[i] < min_lag ? lags[i] : min_lag;
  }
  if (B < 1 || C < 1 || C > kPlateMaxChunk || C > min_lag) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(PlateLayout(din, dmod, B).total) * sizeof(float);
  const cudaError_t err = allow_smem(plate_block_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  plate_block_kernel<<<1, kPlateThreads, smem, static_cast<cudaStream_t>(stream)>>>(a, k, B, C);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
