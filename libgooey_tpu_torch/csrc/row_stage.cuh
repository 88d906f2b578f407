// Row tiles staged through shared memory, for the bank kernels whose rows
// are sample-sequential recurrences over row-major [R, B] arrays
// (affine1_bank, svf_bank and linrec2_bank in bank_kernels.cu; ws4_bank
// takes the copies, with its own geometry).
//
// A block of kStageThreads threads owns `rc` consecutive rows (rc <= 32,
// chosen per launch by the wrapper so that a launch spreads over the SMs).
// Warp 0 holds the walkers, one lane per row, each stepping its row's
// recurrence with the carried state in registers.  Warps 1-3 are the
// copiers: they cut the sample axis into chunks of kStageChunk samples,
// copy each input's [rc, C] tile into a ring of kStageRing stages with
// cp.async (16-byte copies in coalesced rows where B % 4 == 0 and every
// pointer is 16-byte aligned, 4-byte copies otherwise), and store the
// walkers' output tiles (double-buffered) back to device memory, coalesced.
// One __syncthreads a chunk hands a landed chunk to the walkers and their
// finished outputs to the copiers, so the copies of the next chunks and the
// stores of the last one overlap the walk of this one.  The copiers' work
// for a chunk must stay short of the walk's: a copier finds an element's
// row and column once and issues every array's copy back to back.
//
// Staged rows have a pitch of kStagePitch = C + 4 floats: 16-byte aligned
// for cp.async and float4 accesses, and one 16-byte unit longer than the
// chunk, so that the eight lanes of a quarter-warp reading unit q of rows
// r..r+7 hit the eight distinct 16-byte bank groups (r + q) % 8.  Walkers
// read four samples as one float4, the next four ahead of the dependent
// chain, and write their outputs four at a time.
//
// A byte mask (svf_bank's trigger resets, bool [R, B]) may ride along: its
// [rc, C] tile goes into a ring of its own, rows kMaskPitch bytes apart, in
// the same copy groups, 16 bytes a copy where B % 16 == 0 and the mask is
// 16-byte aligned, 4 where B % 4 == 0 and it is 4-byte aligned, and with
// plain loads otherwise; a walker reads four samples' flags as one 32-bit
// word.  A kernel without a mask instantiates none of it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStageChunk = 64;                 // samples per chunk (C)
constexpr int kStagePitch = kStageChunk + 4;    // floats per staged row
constexpr int kStageRing = 3;                   // input chunks in the ring
constexpr int kStageThreads = 128;              // warp 0 walks, warps 1-3 copy
constexpr int kStageMaxRows = 32;               // walkers per block
constexpr int kStageCopiers = kStageThreads - 32;
constexpr int kMaskPitch = kStageChunk + 16;    // bytes per staged mask row

// A staging geometry: samples a chunk, floats a staged row (one 16-byte unit
// past the chunk) and the threads that copy.  The staged kernels above use
// RowStage; ws4_bank its own.
template <int kChunk_, int kCopiers_>
struct StageGeom {
  static constexpr int kChunk = kChunk_;
  static constexpr int kPitch = kChunk_ + 4;
  static constexpr int kCopiers = kCopiers_;
};
using RowStage = StageGeom<kStageChunk, kStageCopiers>;

// Dynamic shared memory of a block: the input ring, two output tiles and,
// with a mask, its ring.
constexpr size_t stage_smem_bytes(int n_in, int n_out, int rc, bool mask = false) {
  return static_cast<size_t>(kStageRing * n_in + 2 * n_out) * rc * kStagePitch *
             sizeof(float) +
         (mask ? static_cast<size_t>(kStageRing) * rc * kMaskPitch : 0);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's copy groups are pending (0: all
// have landed).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// Four samples' mask bytes (4-byte aligned in a staged row): byte i is
// sample i's flag.
__device__ __forceinline__ uint32_t ld_flags(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// This block's rows and the sample range of one chunk.
template <class G>
struct RowSpanG {
  int row0;   // first row of the block
  int rows;   // rows of the block that exist (the last block may have fewer)
  int rc;     // rows per block: the staged tiles' row count
  int B;      // samples per row
  bool vec;   // 16-byte copies

  __device__ int start(int k) const { return k * G::kChunk; }
  __device__ int len(int k) const { return min(G::kChunk, B - k * G::kChunk); }
  __device__ int chunks() const { return (B + G::kChunk - 1) / G::kChunk; }
  __device__ int tile() const { return rc * G::kPitch; }   // floats per array tile
};
using RowSpan = RowSpanG<RowStage>;

template <class G = RowStage>
__device__ __forceinline__ RowSpanG<G> row_span(int R, int B, int rc, int vec) {
  RowSpanG<G> s;
  s.row0 = blockIdx.x * rc;
  s.rows = min(rc, R - s.row0);
  s.rc = rc;
  s.B = B;
  s.vec = vec != 0;
  return s;
}

// Element i of a chunk's [rows, n] tile (n 16-byte units, or floats):
// row r, column j; a whole chunk divides by a constant, a shift.
template <int C>
__device__ __forceinline__ void tile_index(int i, int n, int& r, int& j) {
  r = n == C / 4 ? i / (C / 4) : n == C ? i / C : i / n;
  j = i - r * n;
}

// Copier `p` of G::kCopiers: start the copies of chunk k of each input into
// `slot` ([N][rc][pitch]) and commit them as one group (an empty group past
// the last chunk, so that every copier counts the same groups) with any
// copies issued before it (a mask's).  A copier finds an element's row and
// column once and copies it from every array, so the copies go out back to
// back.
template <int N, class G>
__device__ void stage_in(const float* const (&src)[N], float* slot, const RowSpanG<G>& s,
                         int k, int n_chunks, int p) {
  if (k < n_chunks) {
    const int n0 = s.start(k), len = s.len(k);
    const int w = s.vec ? 4 : 1;                 // floats a copy
    const int n = s.vec ? len >> 2 : len;        // len % 4 == 0 where vec
    for (int i = p; i < s.rows * n; i += G::kCopiers) {
      int r, j;
      tile_index<G::kChunk>(i, n, r, j);
      float* d = slot + r * G::kPitch + w * j;
      const size_t g = static_cast<size_t>(s.row0 + r) * s.B + n0 + w * j;
#pragma unroll
      for (int arr = 0; arr < N; ++arr) {
        if (s.vec) {
          cp_async16(d + arr * s.tile(), src[arr] + g);
        } else {
          cp_async4(d + arr * s.tile(), src[arr] + g);
        }
      }
    }
  }
  cp_async_commit();
}

// Copier `p`: store chunk k of each output tile (`tiles`: [N][rc][pitch])
// to device memory.
template <int N, class G>
__device__ void stage_out(float* const (&dst)[N], const float* tiles, const RowSpanG<G>& s,
                          int k, int p) {
  const int n0 = s.start(k), len = s.len(k);
  const int w = s.vec ? 4 : 1;
  const int n = s.vec ? len >> 2 : len;
  for (int i = p; i < s.rows * n; i += G::kCopiers) {
    int r, j;
    tile_index<G::kChunk>(i, n, r, j);
    const float* t = tiles + r * G::kPitch + w * j;
    const size_t g = static_cast<size_t>(s.row0 + r) * s.B + n0 + w * j;
#pragma unroll
    for (int arr = 0; arr < N; ++arr) {
      if (s.vec) {
        st4(dst[arr] + g, ld4(t + arr * s.tile()));
      } else {
        dst[arr][g] = t[arr * s.tile()];
      }
    }
  }
}

// A mask's bytes a copy: 16, 4 or 1 (see the header).
__device__ __forceinline__ int mask_width(const uint8_t* mask, int B) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(mask);
  return B % 16 == 0 && a % 16 == 0 ? 16 : B % 4 == 0 && a % 4 == 0 ? 4 : 1;
}

// Copier `p`: chunk k of the mask's rows into `slot` ([rc][kMaskPitch]
// bytes), in the group that the next stage_in commits; one-byte elements are
// loaded and stored here (they are visible after the next barrier).
__device__ void stage_mask(const uint8_t* mask, uint8_t* slot, const RowSpan& s, int k,
                           int n_chunks, int width, int p) {
  if (k >= n_chunks) return;
  const int n0 = s.start(k);
  const int n = s.len(k) / width;   // B % width == 0 where width > 1
  for (int i = p; i < s.rows * n; i += kStageCopiers) {
    int r, j;
    tile_index<kStageChunk / 4>(i, n, r, j);   // whole chunks of 16- and 4-byte copies
    uint8_t* d = slot + r * kMaskPitch + width * j;
    const uint8_t* g = mask + static_cast<size_t>(s.row0 + r) * s.B + n0 + width * j;
    if (width == 16) {
      cp_async16(d, g);
    } else if (width == 4) {
      cp_async4(d, g);
    } else {
      *d = *g;
    }
  }
}

// A walker's `full` groups of four samples: unrolled whole for a whole
// chunk, so that the registers of the next group rename instead of moving.
template <class Group>
__device__ __forceinline__ void walk_groups(int full, Group&& group) {
  if (full == kStageChunk / 4) {
#pragma unroll
    for (int q = 0; q < kStageChunk / 4; ++q) group(q);
  } else {
    for (int q = 0; q < full; ++q) group(q);
  }
}

// The chunk loop shared by the staged kernels.  `walk(in, out, m, len)` runs
// on each walker of a row that exists: `in[i]` and `out[i]` point at its row
// in input / output tile i, `m` at its row of the mask tile (kMask; nullptr
// otherwise), `len` is the chunk's sample count.  The walker's carried
// state lives in the caller's lambda captures.
template <bool kMask, int NIN, int NOUT, class Walk>
__device__ __forceinline__ void staged_rows_masked(const float* const (&src)[NIN],
                                                   float* const (&dst)[NOUT],
                                                   const uint8_t* mask, const RowSpan& s,
                                                   Walk&& walk) {
  extern __shared__ float4 stage_smem4[];
  float* ring = reinterpret_cast<float*>(stage_smem4);     // [S][NIN][rc][pitch]
  float* outs = ring + kStageRing * NIN * s.tile();        // [2][NOUT][rc][pitch]
  uint8_t* masks = reinterpret_cast<uint8_t*>(outs + 2 * NOUT * s.tile());   // [S][rc][mpitch]
  const int n_chunks = s.chunks();
  const int tid = threadIdx.x;
  const bool walker = tid < 32;
  const int p = tid - 32;
  const int width = kMask ? mask_width(mask, s.B) : 0;
  auto copy_in = [&](int k) {
    if (kMask) stage_mask(mask, masks + (k % kStageRing) * s.rc * kMaskPitch, s, k, n_chunks,
                          width, p);
    stage_in(src, ring + (k % kStageRing) * NIN * s.tile(), s, k, n_chunks, p);
  };

  if (!walker) {
    for (int k = 0; k < kStageRing - 1; ++k) copy_in(k);
  }
  for (int k = 0; k < n_chunks; ++k) {
    if (!walker) cp_async_wait<kStageRing - 2>();   // chunk k has landed (this copier's part)
    __syncthreads();                     // ... all of it; walk k-1 and its outputs done
    if (walker) {
      if (tid < s.rows) {
        const float* in = ring + (k % kStageRing) * NIN * s.tile() + tid * kStagePitch;
        float* out = outs + (k & 1) * NOUT * s.tile() + tid * kStagePitch;
        const uint8_t* m =
            kMask ? masks + ((k % kStageRing) * s.rc + tid) * kMaskPitch : nullptr;
        const float* ins[NIN];
        float* outp[NOUT];
#pragma unroll
        for (int i = 0; i < NIN; ++i) ins[i] = in + i * s.tile();
#pragma unroll
        for (int i = 0; i < NOUT; ++i) outp[i] = out + i * s.tile();
        walk(ins, outp, m, s.len(k));
      }
    } else {
      // the slot of chunk k-1, whose walk ended before the barrier
      copy_in(k + kStageRing - 1);
      if (k > 0) stage_out(dst, outs + ((k - 1) & 1) * NOUT * s.tile(), s, k - 1, p);
    }
  }
  __syncthreads();
  if (!walker) stage_out(dst, outs + ((n_chunks - 1) & 1) * NOUT * s.tile(), s, n_chunks - 1, p);
}

// The same without a mask: `walk(in, out, len)`.
template <int NIN, int NOUT, class Walk>
__device__ __forceinline__ void staged_rows(const float* const (&src)[NIN],
                                            float* const (&dst)[NOUT], const RowSpan& s,
                                            Walk&& walk) {
  staged_rows_masked<false>(src, dst, nullptr, s,
                            [&](const auto& in, const auto& out, const uint8_t*, int len) {
                              walk(in, out, len);
                            });
}

}  // namespace
