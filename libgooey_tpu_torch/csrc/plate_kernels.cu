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
// Design: one block of two threads.  The input diffusion feeds both tank
// branches, so thread 0 runs the bandwidth filter and the diffusion chain
// and stages the diffused signal in shared memory while thread 1 runs the
// two damping one-poles; after a __syncthreads thread b runs branch b's
// modulated allpass.  Each delay line is a ring in shared memory of its
// history's length (4 x DIN + 2 x DMOD floats, 30 KB at 44.1 kHz, plus the
// B-sample stage; csrc/rings.cuh), read at its lag and written in the slot
// it frees; the carried state keeps the JAX package's right-aligned
// [4, DIN] and [2, DMOD] histories, unrolled from the rings at the end.  The TPU kernel's
// window bases and one-hot matmuls (a gather on the MXU) have no
// counterpart: a thread reads its ring at the lag directly.
//
// What bounds it on the card: ~50 KB move per call and ~40 k operations are
// done, so the card's bound is tens of nanoseconds; the time is the serial
// B-step chain of thread 0 (four lerped reads and the allpass chain per
// sample) plus the copy of the histories into and out of the rings.  One SM
// of 132 is busy.
//
// Numerics: the Pallas body solves the one-poles with log-depth scans and
// the diffusion chain in its affine form per chunk; this kernel and its
// plain version (ops/plate_kernels.py) step the one-poles sample by sample
// and evaluate the same affine form per sample, in the same op order, so
// they differ from the Pallas body at float-noise level.  Built with
// -fmad=false; the kernel and its plain version do the same roundings.
//
// The C entry launches on the caller's stream and returns
// cudaGetLastError(); nothing allocates or synchronizes here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rings.cuh"

namespace {

constexpr int kInAps = 4;

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

__global__ void plate_block_kernel(PlateArgs a, PlateConsts k, int B) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int DIN = a.din;
  const int DMOD = a.dmod;
  float* in_ring = smem;                          // [4][DIN]
  float* mod_ring = in_ring + kInAps * DIN;       // [2][DMOD]
  float* sig = mod_ring + 2 * DMOD;               // [B]
  // unrolled so that many independent loads are in flight at once
#pragma unroll 16
  for (int i = t; i < kInAps * DIN; i += 2) in_ring[i] = a.in_hist[i];
#pragma unroll 16
  for (int i = t; i < 2 * DMOD; i += 2) mod_ring[i] = a.mod_hist[i];
  __syncthreads();

  if (t == 0) {
    // the bandwidth one-pole and the input diffusion, in the Pallas body's
    // affine form: sig = alpha*bw + beta, section i's write
    // (sdir_i*bw + sadd_i) - g_i*delayed_i
    float bw = a.seeds[0];
    int w = 0;
    for (int n = 0; n < B; ++n) {
      bw = k.bw_a * bw + k.bw_b * a.delayed_in[n];
      float dv[kInAps], sadd[kInAps];
      float beta = 0.0f;
#pragma unroll
      for (int i = 0; i < kInAps; ++i) {
        const float* ring = in_ring + i * DIN;
        const float av = ring[ring_slot(w, k.lag[i], DIN)];
        const float bv = ring[ring_slot(w, k.lag[i] + 1, DIN)];
        dv[i] = av + k.frac[i] * (bv - av);
        sadd[i] = beta;
        beta = k.g[i] * beta + k.omg[i] * dv[i];
      }
      sig[n] = k.alpha * bw + beta;
#pragma unroll
      for (int i = 0; i < kInAps; ++i) {
        in_ring[i * DIN + w] = (k.sdir[i] * bw + sadd[i]) - k.g[i] * dv[i];
      }
      w = ring_next(w, DIN);
    }
    a.seeds_out[0] = bw;
    for (int i = 0; i < kInAps; ++i) {
      unroll_ring(in_ring + i * DIN, w, DIN, a.in_hist_out + static_cast<size_t>(i) * DIN);
    }
  } else {
    // the two damping one-poles on the tank's d1 reads
    float da = a.seeds[1], db = a.seeds[2];
    for (int n = 0; n < B; ++n) {
      const float dm = a.damping[n];
      da = dm * da + a.d1a[n] * (1.0f - dm);
      db = dm * db + a.d1b[n] * (1.0f - dm);
      a.da[n] = da;
      a.db[n] = db;
    }
    a.seeds_out[1] = da;
    a.seeds_out[2] = db;
  }
  __syncthreads();

  // branch t's modulated allpass: branch a takes the b feedback, b the a
  float* ring = mod_ring + t * DMOD;
  const float* off = a.mod_off + static_cast<size_t>(t) * B;
  const float* fb = t == 0 ? a.fb_b : a.fb_a;
  float* out = t == 0 ? a.a1 : a.b1;
  int w = 0;
  for (int n = 0; n < B; ++n) {
    const float o = off[n];
    const float whole = floorf(o);
    const float fr = o - whole;
    const int lag = static_cast<int>(whole);
    const float av = ring[ring_slot(w, lag, DMOD)];
    const float bv = ring[ring_slot(w, lag + 1, DMOD)];
    const float delayed = av + fr * (bv - av);
    const float v = (sig[n] + fb[n]) - k.g1 * delayed;
    out[n] = k.g1 * v + delayed;
    ring[w] = v;
    w = ring_next(w, DMOD);
  }
  unroll_ring(ring, w, DMOD, a.mod_hist_out + static_cast<size_t>(t) * DMOD);
}

}  // namespace

extern "C" {

// ptrs: the 10 inputs then the 7 outputs in PlateArgs order; consts: the
// 20 floats of PlateConsts before its lags; lags: the 4 diffusion lags.
int plate_block_launch(void* const* ptrs, const float* consts, const int* lags, int din,
                       int dmod, int B, void* stream) {
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
  for (int i = 0; i < kInAps; ++i) {
    k.g[i] = consts[4 + i];
    k.omg[i] = consts[8 + i];
    k.sdir[i] = consts[12 + i];
    k.frac[i] = consts[16 + i];
    k.lag[i] = lags[i];
  }
  const size_t smem =
      (static_cast<size_t>(kInAps) * din + 2 * static_cast<size_t>(dmod) + B) * sizeof(float);
  const cudaError_t err = allow_smem(plate_block_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  plate_block_kernel<<<1, 2, smem, static_cast<cudaStream_t>(stream)>>>(a, k, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
