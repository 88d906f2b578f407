#!/usr/bin/env python3
"""Copies of the kernel sources with parts of ``ws4_bank`` and ``fbws_bank``,
``kit_drive``, ``plate_block``, ``mix_bank``, ``triangle_additive_bank``,
``grain_read_cubic``, ``sampler_read_linear`` or the lone bus kernels cut
out or changed, for timing
those parts alone on the card with ``tools/torch_kernel_ab.py``.

    python3 tools/kernel_probes.py OUT_DIR [CSRC]

Writes one directory per probe under ``OUT_DIR`` (inside the copied repo,
e.g. ``chip_checkout/``), each a copy of ``CSRC`` (default: this tree's
``libgooey_tpu_torch/csrc``) with lines of one kernel replaced.
The split 4x chain that ``ws4_bank`` and ``fbws_bank`` share
(``split4x_rows``, ``bank_kernels.cu``): ``walks_only`` (no copies, no
shaper: the up- and down-walks, ``fbws_bank``'s down-walk with its DC
blocker, on whatever shared memory holds), ``up_only`` and ``down_only``
(one walk), and ``shape_copy`` (no walks: the shaper, ``ws4_bank``'s with
the drive's gain, and the copies); ``fbws_rows16`` (nothing cut:
``fbws_bank`` at 16 rows a block at most, bit-equal).
``mix_bank_partial_kernel``: ``mix_partial_only`` (no second kernel: the
chunks' partial sums only), ``mix_terms_only`` (no sums either: the copy
of x, the settled test and the terms) and ``mix_loads_only`` (the copy
and the settled test alone).  ``kit_drive``'s
``drive_row`` (``voice_kernels.cu``): ``drive_walks`` (no per-sample
inputs, shaper or finish: the two walks, with the kick's DC blocker and
feedback filter) and ``drive_stages`` (no walks: the per-sample inputs,
the shaper and the finish).  ``plate_block_kernel`` (``plate_kernels.cu``):
``plate_copies`` (the histories' copies in and out alone),
``plate_onepoles`` (the bandwidth and damping walks alone) and
``plate_chunks`` (the diffusion and modulated allpass steps alone).  The
additive triangle (``triangle.cuh``, ``osc_kernels.cu``): ``tri_untapered``
(the table's untapered steps alone: no tapered band, no break),
``tri_no_break`` (nothing cut: every term past the first inactive one
tested, as the plain loop does, and skipped), ``tri_no_walk`` (no term:
the table, loads and stores alone: the sines fall dead with it),
``tri_no_sines`` (each sine a multiply) and ``tri_copy`` (each output its
inputs' sum: loads, stores, the table and its barrier).
``grain_read_cubic`` (``grain_kernels.cu``): ``grain_positions`` (each
output its position: no taps) and ``grain_stores`` (each output its age: no
position, no taps).  The lone 4x bus kernel (``bus4x_split_kernel``:
``saturation_block``, ``compressor_block``, ``waveshaper_block``,
``fbws_fast_block``): ``lone_walks_only`` (no copies,
values, shaping or stores: the five walks on whatever shared memory holds),
``lone_up1_only``, ``lone_up2_only``, ``lone_down2_only``,
``lone_down1_only`` and ``lone_finish_only`` (one walk), ``lone_walks_123``
(the walks of warps 1-3, each on a scheduler of its own) and
``lone_walks_04`` (warps 0 and 4, which share one), ``lone_workers_only``
(no walks: the copies, the values, the shaping and the stores);
``lone_sat_256`` and ``lone_comp_320`` (nothing cut: the saturation on three
worker warps, the compressor on five, bit-equal); ``lone_ws_224``,
``lone_ws_320``, ``lone_fbws_224`` and ``lone_fbws_320`` (nothing cut: the
waveshaper and the feedback waveshaper on two and on five worker warps,
bit-equal).  The lone detector
(``env_lone_kernel``: ``env_follower_block``): ``env_staging`` (no walk: the
copies, the values and the stores) and ``env_walk`` (the walk alone, on
whatever shared memory holds), ``env_chunk32`` and ``env_chunk128``
(nothing cut: chunks of 32 and 128 samples, bit-equal).  The lone spring
(``spring_lone_kernel``: ``spring_block``): ``spring_fill_drain`` (no
parts: the rings' fill and drain), ``spring_walk`` (the damping walk
alone: no fill, drain, copies, reads or writes), ``spring_workers``
(everything but the walk), ``spring_no_traj``, ``spring_no_a`` and
``spring_no_c`` (the trajectories' copies, the parts' reads or their
writes cut) and ``spring_512`` (nothing cut: 512 threads, bit-equal).  The
lone walks (``walk_lone_kernel``: ``lowpass_block``, ``delay_block``):
``walk_walks_only`` (no copies, values or finishes: the walks on whatever
shared memory holds), ``walk_workers_only`` (no walks: the copies, the
values and the finishes), ``walk_lowpass_128`` and ``walk_delay_160``
(nothing cut: the lowpass on two worker warps, the delay on three,
bit-equal), ``walk_lowpass_chunk32``, ``walk_lowpass_chunk64``,
``walk_delay_chunk32`` and ``walk_delay_chunk128`` (nothing cut: the
lowpass's 128-sample chunks cut to 32 and 64, the delay's 64 to 32 or
grown to 128, bit-equal); ``walk_tilt_160``, ``walk_tilt_chunk32`` and
``walk_tilt_chunk128`` (nothing cut: the tilt on three worker warps, its
64-sample chunks cut to 32 or grown to 128, bit-equal).
``sampler_read_linear`` (``grain_kernels.cu``): ``sampler_pairs1`` and
``sampler_pairs4`` (nothing cut: one pair of frames a thread, tiles of
256 frames, or four, tiles of 1,024; bit-equal), ``sampler_empty`` (every
block returns at once: the launch of its grid) and ``launch_floor`` (one
block of 128 threads that returns at once: the card's cost of an empty
kernel).
Outputs of the probes that cut are wrong; only their times mean anything.
Pass the directories to ``tools/torch_kernel_ab.py --only
ws4_bank,fbws_bank``, ``--only mix_bank``, ``--only kit_drive``, ``--only
plate_block``, ``--only triangle_additive_bank``, ``--only
grain_read_cubic``, ``--only saturation_block,compressor_block``, ``--only
env_follower_block,spring_block``, ``--only
lowpass_block,delay_block,tilt_block`` or ``--only sampler_read_linear``.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

NO_COPIES = [
    ("for (int c = 0; c < 2; ++c) stage_in(src, ring + c * 2 * s.tile(), s, c, n_chunks, p);",
     ";"),
    ("stage_in(src, ring + ((j + 2) % kSplitRing) * 2 * s.tile(), s, j + 2, n_chunks, p);",
     ";"),
    ("if (j >= 3) stage_out(dst, outs + ((j - 3) & 1) * s.tile(), s, j - 3, p);", ";"),
    ("if (warp >= 2) stage_out(dst, outs + ((n_chunks - 1) & 1) * s.tile(), s, n_chunks - 1, p);",
     ";"),
]
NO_SHAPER = [("if (j >= 1 && j <= n_chunks) {", "if (false) {")]
NO_UP = [("if (walks && j < n_chunks) {", "if (false) {")]
NO_DOWN = [("if (walks && j >= 2) {", "if (false) {")]
FBWS_ROWS16 = [("float* dc, float* st_out, const float* coefs, int V, int B, int rc, int vec,\n"
                "                     void* stream) {\n",
                "float* dc, float* st_out, const float* coefs, int V, int B, int rc, int vec,\n"
                "                     void* stream) {\n  rc = rc > 16 ? 16 : rc;\n")]
NO_DRIVE_STAGES = [
    ("if (warp == 2 && lane < len(0)) b.input(sm.ps[0], lane, lane);", ";"),
    ("if (c < n_chunks && lane < len(c)) b.input(", "if (false) b.input("),
    ("} else if (j >= 3 && lane < len(j - 3)) {", "} else if (false) {"),
    ("if (warp == 3 && lane < len(c)) {", "if (false) {"),
    ("if (j >= 1 && j <= n_chunks) {", "if (false) {"),
]
NO_DRIVE_WALKS = [("if (j < n_chunks) {", "if (false) {"), ("if (j >= 2) {", "if (false) {")]
MIX_NO_CHUNK_PASS = [("  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);",
                      "  return static_cast<int>(err);")]
MIX_NO_SUMS = [("  if (warp < 3 && lane < len) {", "  if (false) {")]
MIX_NO_TERMS = [("  for (int u = t; u < nv * kMixQuads; u += kMixThreads) {",
                 "  for (int u = t; u < 0; u += kMixThreads) {")]
PLATE_NO_COPIES = [
    ("for (int r = 0; r < kInAps; ++r) {\n    copy_span<true>(",
     "for (int r = 0; r < 0; ++r) {\n    copy_span<true>("),
    ("for (int r = 0; r < 2; ++r) {\n    copy_span<true>(",
     "for (int r = 0; r < 0; ++r) {\n    copy_span<true>("),
    ("for (int r = 0; r < kInAps; ++r) {\n    copy_span<false>(",
     "for (int r = 0; r < 0; ++r) {\n    copy_span<false>("),
    ("for (int r = 0; r < 2; ++r) {\n    copy_span<false>(",
     "for (int r = 0; r < 0; ++r) {\n    copy_span<false>("),
]
PLATE_NO_ONEPOLES = [("if (warp == 0) {", "if (false) {"),
                     ("} else if (warp == 1) {", "} else if (false) {")]
PLATE_NO_CHUNKS = [("for (int j = 0; j <= nc; ++j) {", "for (int j = 0; j < 0; ++j) {")]
TRI_UNTAPERED = [("    for (; k < c.n_terms; ++k) {", "    for (; k < 0; ++k) {")]
TRI_NO_BREAK = [("        acc = acc + 0.0f;\n        break;",
                 "        acc = acc + 0.0f;\n        continue;")]
#: the triangle's sines made a multiply each (the walk then runs on other
#: values), and its loads and stores alone (every term and sine dead)
TRI_NO_SINES = [("    const float sin1 = sinf(theta);", "    const float sin1 = theta * 0.5f;"),
                ("    cos2x2 = 2.0f * cosf(2.0f * theta);", "    cos2x2 = 2.0f * (0.5f * theta);")]
TRI_COPY = [("  if (i < n) out[i] = s.finish(0, gain, c);",
             "  if (i < n) out[i] = idx[ic] + freq[ic];")]
#: the triangle with no walk: the table, loads and stores (the sines and
#: max_h fall dead with the walk)
TRI_NO_WALK = [("    k1 = k;", "    k1 = 0;"),
               ("    for (; k < k1; ++k) step(gain[k]);", "    return acc;")]
#: the lone 4x bus kernel (bus4x_split_kernel: saturation_block,
#: compressor_block, waveshaper_block, fbws_fast_block): the workers'
#: copies, values, shaping and stores cut, or the walks; one walk alone;
#: other numbers of worker warps
LONE_NO_WORKERS = [("    copy_in(j + 2);\n    prep(j + 1);\n    shape(j - kLagShape);\n"
                    "    if (j > kLagFinish) store_out(j - kLagFinish - 1);\n", "")]
LONE_WALK = "    if (on && q >= 0 && q < n_chunks) walk(q);"
LONE_NO_WALKS = [(LONE_WALK, "    if (false) walk(q);")]


def lone_walks(cond):
    """The walks whose warp ``cond`` (a C expression of ``warp``) holds,
    alone: no workers."""
    return LONE_NO_WORKERS + [(LONE_WALK, LONE_WALK.replace(
        ") walk(q);", f" && ([](int warp) {{ return {cond}; }})(threadIdx.x / 32)) walk(q);"))]


LONE_SAT_256 = [("  static constexpr int kThreads = 320;   // five worker warps",
                 "  static constexpr int kThreads = 256;")]
LONE_COMP_320 = [("  static constexpr int kThreads = 256;   // three worker warps",
                  "  static constexpr int kThreads = 320;")]


def lone_threads(body, threads):
    """The waveshaper's (``body`` "the waveshaper") or the feedback
    waveshaper's lone kernel on ``threads`` threads."""
    return [(f"  static constexpr int kThreads = 256;   // {body}: three worker warps",
             f"  static constexpr int kThreads = {threads};")]


#: the lone detector (env_lone_kernel: env_follower_block): the walk cut,
#: or the workers' copies, values and stores
ENV_NO_WALK = [("      if (walker && j < n_chunks) env_walk(t, j, c, env);",
                "      if (false) env_walk(t, j, c, env);")]
ENV_NO_WORKERS = [("  copy_in(0);\n  copy_in(1);\n  copy_in(2);\n", ""),
                  ("  cp_async_wait<2>();\n  step_barrier();\n  prep(0);\n",
                   "  cp_async_wait<2>();\n  step_barrier();\n"),
                  ("    copy_in(j + 3);\n    prep(j + 1);\n    if (j > 0) store(", "    if (false) store(")]
#: the lone spring (spring_lone_kernel: spring_block): the fill, the
#: drain, the trajectories' copies, the parts' reads (a) and writes (c),
#: the walk; its threads
SPRING_NO_FILL = [("  const int n_hist = 2 * kSpringAps * D;", "  const int n_hist = 0;")]
SPRING_NO_DRAIN = [("    for (int m = tid; m < D; m += kSpringThreads) {",
                    "    for (int m = tid; m < 0; m += kSpringThreads) {")]
SPRING_NO_PARTS = [("  const int n_parts = (B + P - 1) / P;", "  const int n_parts = 0;")]
SPRING_NO_TRAJ = [("    if (k < n_parts && tid >= kSpringWalkers) {", "    if (false) {")]
SPRING_STEP = "a thread a (channel, sample)\n    for (int u = tid; u < 2 * len; u += kSpringThreads) {"
SPRING_NO_A = [("// (a) the ring reads, beta and bv, " + SPRING_STEP,
                "// (a) the ring reads, beta and bv, " + SPRING_STEP.replace("2 * len", "0"))]
SPRING_NO_C = [("// (c) the allpass writes and the mix, " + SPRING_STEP,
                "// (c) the allpass writes and the mix, " + SPRING_STEP.replace("2 * len", "0"))]
SPRING_NO_WALK = [("    if (walker >= 0) {\n      const float* A", "    if (false) {\n      const float* A")]
SPRING_512 = [("constexpr int kSpringThreads = 256;", "constexpr int kSpringThreads = 512;")]
ENV_CHUNK = "constexpr int kEnvChunk = 64;"
#: the lone walks (walk_lone_kernel: lowpass_block, delay_block): the
#: workers' copies, values and finishes cut, or the walks; each body's
#: worker warps and chunk
WALK_NO_WORKERS = [("  for (int j = 0; j < kWalkAhead; ++j) copy_in(j);\n", ""),
                   ("  prep(0);\n  for (int j = 0; j <= n_chunks; ++j) {\n"
                    "    cp_async_wait<kWalkAhead - 2>();",
                    "  for (int j = 0; j <= n_chunks; ++j) {\n    cp_async_wait<kWalkAhead - 2>();"),
                   ("    copy_in(j + kWalkAhead);\n    prep(j + 1);\n    if (j > 0) finish(j - 1);\n",
                    "")]
WALK_NO_WALK = [("      if (walker && j < n_chunks) walk_lone_chunk(",
                 "      if (false) walk_lone_chunk(")]


def walk_body(body, what, old, new):
    """``body``'s (the lowpass, the delay) ``kThreads`` or ``kChunk``
    (``what``: "threads" or "chunk") from ``old`` to ``new``."""
    if what == "chunk":
        line = f"  static constexpr int kChunk = {old};{' ' * (8 - len(str(old)))}// {body}'s chunk"
    else:
        line = f"  static constexpr int kThreads = {old};   // {body}: "
    return [(line, line.replace(f"= {old};", f"= {new};"))]


#: the sampler read: its pairs of frames a thread; its blocks returning at
#: once, on its grid or on one block
SAMPLER_PAIRS = "constexpr int kSamplerPairs = 2;"
SAMPLER_EMPTY = [("  const int v = static_cast<int>(blockIdx.x);\n  const int b = base[v];",
                  "  if (B > 0) return;\n  const int v = static_cast<int>(blockIdx.x);\n"
                  "  const int b = base[v];")]
ONE_BLOCK = [("  const dim3 grid(static_cast<unsigned>(V),\n"
              "                  static_cast<unsigned>((B + kSamplerTile - 1) / kSamplerTile));",
              "  const dim3 grid(1u, 1u);")]
GRAIN_POSITIONS = [("  const float i1f = floorf(pos);",
                    "  return pos;\n  const float i1f = floorf(pos);")]
GRAIN_STORES = [("  // fmaxf maps a NaN position", "  return age;\n  // fmaxf maps a NaN position")]
#: probe -> (the source it edits, its edits)
PROBES = {
    "walks_only": ("bank_kernels.cu", NO_COPIES + NO_SHAPER),
    "up_only": ("bank_kernels.cu", NO_COPIES + NO_SHAPER + NO_DOWN),
    "down_only": ("bank_kernels.cu", NO_COPIES + NO_SHAPER + NO_UP),
    "shape_copy": ("bank_kernels.cu", NO_UP + NO_DOWN),
    "fbws_rows16": ("bank_kernels.cu", FBWS_ROWS16),
    "mix_partial_only": ("bank_kernels.cu", MIX_NO_CHUNK_PASS),
    "mix_terms_only": ("bank_kernels.cu", MIX_NO_CHUNK_PASS + MIX_NO_SUMS),
    "mix_loads_only": ("bank_kernels.cu", MIX_NO_CHUNK_PASS + MIX_NO_SUMS + MIX_NO_TERMS),
    "drive_walks": ("voice_kernels.cu", NO_DRIVE_STAGES),
    "drive_stages": ("voice_kernels.cu", NO_DRIVE_WALKS),
    "plate_copies": ("plate_kernels.cu", PLATE_NO_ONEPOLES + PLATE_NO_CHUNKS),
    "plate_onepoles": ("plate_kernels.cu", PLATE_NO_COPIES + PLATE_NO_CHUNKS),
    "plate_chunks": ("plate_kernels.cu", PLATE_NO_COPIES + PLATE_NO_ONEPOLES),
    "tri_untapered": ("triangle.cuh", TRI_UNTAPERED),
    "tri_no_break": ("triangle.cuh", TRI_NO_BREAK),
    "tri_no_walk": ("triangle.cuh", TRI_NO_WALK),
    "tri_no_sines": ("triangle.cuh", TRI_NO_SINES),
    "tri_copy": ("osc_kernels.cu", TRI_COPY),
    "grain_positions": ("grain_kernels.cu", GRAIN_POSITIONS),
    "lone_walks_only": ("bus_kernels.cu", LONE_NO_WORKERS),
    "lone_up1_only": ("bus_kernels.cu", lone_walks("warp == 0")),
    "lone_up2_only": ("bus_kernels.cu", lone_walks("warp == 1")),
    "lone_down2_only": ("bus_kernels.cu", lone_walks("warp == 2")),
    "lone_down1_only": ("bus_kernels.cu", lone_walks("warp == 3")),
    "lone_finish_only": ("bus_kernels.cu", lone_walks("warp == 4")),
    "lone_walks_123": ("bus_kernels.cu", lone_walks("warp >= 1 && warp <= 3")),
    "lone_walks_04": ("bus_kernels.cu", lone_walks("warp == 0 || warp == 4")),
    "lone_workers_only": ("bus_kernels.cu", LONE_NO_WALKS),
    "lone_sat_256": ("bus_kernels.cu", LONE_SAT_256),
    "lone_comp_320": ("bus_kernels.cu", LONE_COMP_320),
    "lone_ws_224": ("bus_kernels.cu", lone_threads("the waveshaper", 224)),
    "lone_ws_320": ("bus_kernels.cu", lone_threads("the waveshaper", 320)),
    "lone_fbws_224": ("bus_kernels.cu", lone_threads("the feedback waveshaper", 224)),
    "lone_fbws_320": ("bus_kernels.cu", lone_threads("the feedback waveshaper", 320)),
    "env_staging": ("bus_kernels.cu", ENV_NO_WALK),
    "env_walk": ("bus_kernels.cu", ENV_NO_WORKERS),
    "spring_fill_drain": ("bus_kernels.cu", SPRING_NO_PARTS),
    "spring_walk": ("bus_kernels.cu", SPRING_NO_FILL + SPRING_NO_DRAIN + SPRING_NO_TRAJ
                    + SPRING_NO_A + SPRING_NO_C),
    "spring_workers": ("bus_kernels.cu", SPRING_NO_WALK),
    "spring_no_traj": ("bus_kernels.cu", SPRING_NO_TRAJ),
    "spring_no_a": ("bus_kernels.cu", SPRING_NO_A),
    "spring_no_c": ("bus_kernels.cu", SPRING_NO_C),
    "spring_512": ("bus_kernels.cu", SPRING_512),
    "env_chunk32": ("bus_kernels.cu", [(ENV_CHUNK, ENV_CHUNK.replace("64", "32"))]),
    "env_chunk128": ("bus_kernels.cu", [(ENV_CHUNK, ENV_CHUNK.replace("64", "128"))]),
    "walk_walks_only": ("bus_kernels.cu", WALK_NO_WORKERS),
    "walk_workers_only": ("bus_kernels.cu", WALK_NO_WALK),
    "walk_lowpass_128": ("bus_kernels.cu", walk_body("the lowpass", "threads", 160, 128)),
    "walk_delay_160": ("bus_kernels.cu", walk_body("the delay", "threads", 128, 160)),
    "walk_lowpass_chunk32": ("bus_kernels.cu", walk_body("the lowpass", "chunk", 128, 32)),
    "walk_lowpass_chunk64": ("bus_kernels.cu", walk_body("the lowpass", "chunk", 128, 64)),
    "walk_delay_chunk32": ("bus_kernels.cu", walk_body("the delay", "chunk", 64, 32)),
    "walk_delay_chunk128": ("bus_kernels.cu", walk_body("the delay", "chunk", 64, 128)),
    "walk_tilt_160": ("bus_kernels.cu", walk_body("the tilt", "threads", 128, 160)),
    "walk_tilt_chunk32": ("bus_kernels.cu", walk_body("the tilt", "chunk", 64, 32)),
    "walk_tilt_chunk128": ("bus_kernels.cu", walk_body("the tilt", "chunk", 64, 128)),
    "sampler_pairs1": ("grain_kernels.cu", [(SAMPLER_PAIRS, SAMPLER_PAIRS.replace("2", "1"))]),
    "sampler_pairs4": ("grain_kernels.cu", [(SAMPLER_PAIRS, SAMPLER_PAIRS.replace("2", "4"))]),
    "sampler_empty": ("grain_kernels.cu", SAMPLER_EMPTY),
    "launch_floor": ("grain_kernels.cu", SAMPLER_EMPTY + ONE_BLOCK),
}


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if not 1 <= len(args) <= 2:
        print("usage: kernel_probes.py OUT_DIR [CSRC]", file=sys.stderr)
        return 2
    out_root = Path(args[0])
    src = Path(args[1]) if len(args) > 1 else ROOT / "libgooey_tpu_torch/csrc"
    for name, (source, edits) in PROBES.items():
        text = (src / source).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {source} no longer holds {old!r} once")
            text = text.replace(old, new)
        out = out_root / name
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(src, out)
        (out / source).write_text(text)
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
