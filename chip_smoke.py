#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--profile PATH]

Phases (any failure exits non-zero):

1. device: require a CUDA card; print its name and power limit (nvidia-smi);
2. build: compile the kernels (libgooey_tpu_torch/csrc, one nvcc per source
   in parallel);
3. kernels: each of the twenty-four kernels against its plain PyTorch
   version on the card, at the main path's shapes (B = 512; V = 4,096 for
   the kick's env and fbws, V = 1,024 for the triangle, the stereo bus
   [2, B] for the nine bus kernels, the
   mono plate input [B] with its [4, 566] and [2, 2719] histories,
   ``bus_chain`` running the kit's seven bus phases, the first four, and
   the product chain's ten in one launch, which must also equal the kernels
   in turn bit for bit, ``kit_sources`` at the 64-voice product kit and
   ``kit_drive`` at its kick 16 + snare 16, ``mix_bank`` at the kit's 4,096
   voices with pan and gain moving (then every pan and gain settled, as in
   the kit cells' traffic, with the matmul yardstick beside it; half
   settled; half at the settle snap's float32 edge; the product block's 64
   voices; 130 voices of 100 and 99 samples, a partial chunk; bit-equal),
   ``grain_read_cubic`` at 4,000 grains on
   a 32,768-sample source with and without ages (then its tails: one grain,
   three of 100 and 33 samples on a 4-sample source with steps of +-8.7 and
   infinite ones, 37 of 99 on 1 and 3 samples; bit-equal),
   ``triangle_additive_bank`` at 1,024 voices with every sample's frequency
   drawn apart, on the snare's own traffic (bus7's launch at block 48) and
   at the edge frequencies with 0, 1, 64 and 192 harmonics (bit-equal),
   ``sampler_read_linear``
   at 128 voices on a 32,768-frame arena (then its tails: one voice, 130
   voices of 512, 100 and 33 samples with fractional ends, negative, inf
   and NaN increments, ages before the start, bases at the arena's end and
   ages wrapping past 2^31; bit-equal); the two staged kernels at every
   shape full_kit_4096_bus7 launches them at, ``affine1_bank`` at 512 and
   1,024 rows with no floor array and at 1,024 with a live one, at the
   kick's 4,096 with an explicit floor row, at
   ``pallas_scan.linrec1_pallas``'s [4,096, 512] with none (the function
   of that TPU kernel) and at the granulator's one row, ``linrec2_bank`` at
   1,024, 512 and 2,560 (tom2's membrane) rows, both at 515 rows of 100
   and 99 samples (tails of rows per block and of the 64-sample chunk,
   4-byte copies), each bit-equal to its plain version, and
   ``affine1_bank(None, ...)`` bit-equal to the explicit -3e38 floor with
   NaN, +-inf and below-floor values; ``pink_bank`` (staged, its reset
   mask as bytes) at bus7's 1,024 rows with resets (the kick) and without
   a mask (hihat2) and at the kick slice's 4,096 with resets, ``svf_bank``
   (staged likewise) at 1,024, 512, 8 and 4,096 rows with resets and at
   1,024 without, ``ws4_bank`` (its 4x chain split over warps) at 1,024
   and 512 rows and the granulator's one row, all three at 515 rows of 100
   and 99 samples and with inputs 4 bytes past a 16-byte boundary,
   bit-equal; ``fbws_bank`` (its 4x chain split over warps as ``ws4_bank``'s,
   the gated DC blocker on the down-walk) at the kick slice's 4,096 rows,
   the kit's 1,024, 515 rows of 100 and 99 samples and unaligned, with rows
   bypassed for the whole block and from mid-block on, bit-equal;
   ``env_follow_bank`` (staged, its freeze mask as bytes) at
   the kick slice's 4,096 rows, bus7's 1,024, the product kit's 16, 515
   rows of 100 and 99 samples and unaligned, bit-equal; ``plate_block``
   (a block of 512 threads, chunks of samples a thread each) at the main
   path's block, at 100 and 33 samples, with its modulated lags falling to
   1 (serial chunks), at 22,050 and 96,000 Hz, bit-equal;
   ``saturation_block``, ``compressor_block``, ``waveshaper_block`` and
   ``fbws_fast_block`` (their 4x chains' stages on warps of their own, a
   polyphase branch a lane) also at 512, 100 and 33 samples with the
   saturation's and the compressor's bypass gates crossed inside chunks and
   the compressor's gain through 0.99, each waveshaper with a channel
   bypassed by its mix and the other by its drive, both engaged, the
   waveshaper with +-inf samples, the feedback waveshaper on an envelope
   under its 0.05 floor, with feedback 0.5, at drives 150 and 100 and with a
   filter of 1e-16 flushed (``lone_edge_cases``), bit-equal;
   ``env_follower_block`` (its channels' walks on warps of their own, on
   values computed ahead) and ``spring_block`` (parts of the shortest lag,
   its walks on warps of their own) there too, the detector's bypass span
   ending inside its 64-sample chunks, the spring also at 22,050 and 96,000
   Hz, with its history 4 bytes past a 16-byte boundary and with its
   shortest lag cut to 3 samples (``spring_cases``), bit-equal;
   ``lowpass_block`` and ``delay_block`` (each channel's walk on a warp of
   its own, on values computed ahead) there too, the lowpass's feedback
   across 1, its stages flushed under 1e-15 inside a chunk and +-inf in
   x, the delay's smoothers settling inside chunks, its writes flushed, a
   NaN tap, both ping-pong settings and an unaligned tap
   (``walk_edge_cases``), bit-equal; ``tilt_block`` (on the same lone walk
   kernel) there too, the knob through the center inside a chunk, a
   passthrough span inside the block, Q at its top, +-inf in x and x
   unaligned (``tilt_edge_cases``), bit-equal;
   ``kit_sources``, ``kit_drive`` and ``bus_chain``, bit-equal too, at
   their tails: ``bus_chain`` at B with one phase, twelve (two
   delays, one after the spring) and nine (two delays, the spring last),
   and at 100 and 33 samples with 1, 4, 7, 9, 10 and 12; the kit kernels
   with one voice a family, 5/3/7/1/2 voices at 100 and 37 samples and
   128 a family),
   inputs from a numpy seed; with each
   kernel's device time per call (torch.profiler; CUDA events behind a
   sleep where the trace holds nothing), its wrapper's wall between CUDA
   events, its plain version's (the one compared call's), its bound (the larger of bytes over 3.35
   TB/s and operations over 67 TFLOP/s) and, for the recurrences and the
   bus kernels, its chain floor; also the counter hash, bit for bit
   against the CPU;
4. the kick slice through ``render_many``: 4,096 kick voices, tight preset,
   ``max_harmonics=0, feedback_path=False``, the default bus (mix, master,
   soft limiter; the mix is one ``mix_bank`` launch a block, here and in
   every later phase that runs the engine), 64 blocks of 512 at 44.1 kHz with sequenced staggered
   triggers; checks the output, the launch counts, and the first 2 blocks
   against the same render with every kernel swapped for its plain version;
   reports the aggregate real-time factor (voices x audio seconds / wall s)
   from the median of 3 timed renders;
5. the five-family kit through ``render_many`` (the voice half of
   ``bench_configs.build_full_kit``, with the default bus): kick, snare and
   hihat2 at 1,024 voices, tom2 and bass at 512, default presets, kick
   ``max_harmonics=0, feedback_path=False``, snare ``max_harmonics=64``,
   the kit's sequenced traffic, 64 blocks; the same checks with all eight
   bank kernels, median of 3 renders;
6. full_kit_4096_bus4: the same kit with the first four effects of
   ``build_full_kit``'s global bus (saturation, lowpass, tilt, delay; fresh
   effect states, ``FX_DEFAULT_TARGETS`` every block), median of 3 renders;
   the eight bank kernels launched and the bus as one ``bus_chain`` launch
   a block, as the engine runs a run of effects; then again with the tilt
   at [0.3, 0.4] (the default knob 0.5 is passthrough), so the SVF runs.
   The kernel-vs-plain comparison of each runs its 2 blocks with a 0.005 s
   delay, so the second block reads the ring the first wrote.  (Its
   ``fuse_bus=False`` render went when phase 7's came to launch every
   kernel it launched.);
7. full_kit_4096 with its whole bus, ``bench_configs.build_full_kit``
   with nothing cut (full_kit_4096_bus7): the kit through saturation,
   lowpass, tilt, delay, compressor, spring and plate, fresh effect states,
   ``FX_DEFAULT_TARGETS`` every block, median of 5 renders; all seventeen
   kernels launched, the six effects before the plate as one ``bus_chain``
   launch and ``plate_block`` once a block each; its kernel-vs-plain
   comparison runs 4 blocks with the delay at 0.005 s, the compressor at
   [-60, 8, 1, 50, 1] (over the threshold at the kit's level) and the plate
   initialised and held at size 0.0 (its tank reads 2.3-3.2 blocks back);
   then the render with ``fuse_bus=False`` (median of 3), each of the eight
   single bus kernels once a block, ``bus_chain`` never; 26 ``affine1_bank``
   and 5 ``linrec2_bank`` launches a block, with the rows of each printed;
8. product_block_64v_chain9, ``bench_configs.bench_onchip_product_block``:
   the kit of ``__graft_entry__.entry`` (kick 16 ``max_harmonics=64,
   feedback_path=False``, snare 16 ``max_harmonics=64``, hihat2 16, tom2 8,
   bass 8: 64 voices; default presets, pan 0.5, gain 1/64, master 0.25)
   with the kit's sequenced traffic, 64 blocks, through ``_render_all``
   (every bank on the kit path: one ``kit_sources`` and one ``kit_drive``
   a block), then each block's limited stereo through
   ``mixer.chain.process_chain`` of the nine
   entries in that config's order (lowpass, delay, saturation, compressor,
   tilt, spring, waveshaper, feedback waveshaper, plate) at their default
   targets with fresh states: one ten-phase ``bus_chain`` and one
   ``plate_block`` a block; median of 5 renders; then once with
   ``fuse_runs=False`` (each entry's own kernels, the two waveshapers'
   among them); its kernel-vs-plain comparison runs 4 blocks with both
   waveshapers engaged and every voice also struck at the first sample;
9. the ``Engine`` API with its default statics (kick and snare additive
   triangles at 128 and 192 harmonics): 16 named kicks and one sequenced
   instrument of each other family (all on the kit path), through
   saturation, lowpass, tilt [0.3, 0.4], delay [0.015, 0.5, 0.4, 6000],
   compressor, spring and plate added with ``add_global_effect``, 1 s; then
   1 s more with the compressor keyed from the first kick
   (``set_sidechain_source``), which splits the bus: the first four in one
   launch, the compressor's and the spring's own kernels, the plate's; its
   first 2 blocks against the same blocks with every kernel swapped for its
   plain version (a copy of the engine taken before the render);
10. granulator_lfo_sampler_4k_lanes, ``bench_configs.bench_granulator_sampler_4k``
   without importing it: the granulator's 80-lane state on
   ``RandomState(0).randn(32768)*0.3`` tiled to 4,000 lanes, every lane
   seeded active from ``RandomState(1)`` in the bench's draw order
   (duration, src_pos, step, shape, vel; then the sampler's increment and
   velocity), plus the reference's full sampler capacity, 4 racks x 32
   voices as one 128-voice state on a 32,768-frame arena; 64 blocks of no
   events through ``granulator.render_block`` and ``sampler.render_block``,
   output ``gout + sout[0]``; one ``grain_read_cubic``, one
   ``sampler_read_linear``, one ``ws4_bank`` (the drive, one row) and one
   ``affine1_bank`` (the 1/sqrt(N) smoother, one row) a block; aggregate
   RTF over the 4,128 lanes, median of 3 renders.  The bench's arena is
   zeros, so its kernel-vs-plain comparison (4 blocks) fills the arena
   from a seed, starts the voices at mixed offsets and engages the drive
   (0.5).  Then 1 s driven by the hosts: a ``GranulatorHost`` cloud
   (dense, with spray and timing jitter, so grains are stolen into the
   release pool) and a ``SamplerRackHost`` with two slots and a running
   pattern, each block on the kernels, its first blocks against the plain
   versions;
11. the whole ``Engine``: (a) at a host's scale, through the API a C-API
   host calls: kick, snare, hihat (8 closed, 8 open) and hihat2 16 each,
   tom (two of each preset), tom2 and bass 8, poly 4 synths (24 lanes),
   pan 0.5, gain 1/96, each on a 120 BPM sequencer staggered as phase 9's
   (the snares with per-step ``PresetBlender`` blends), the seven effects
   (the delay with an extra keyword option), LFO 0 at 1/8 and 140 BPM on
   the basses' cutoff, LFO 1 at 0.8 Hz on kicks 0-3's pitch, LFO 2 on hihat
   0's decay, LFO 3 on poly 0's cutoff, a chord on each poly synth held
   0.5 s, 1 s in all; checks that the routed kick and bass left the kit
   path (one ``kit_sources`` and ``kit_drive`` a block for the snare,
   hihat2 and tom2; the kick's ``fbws_bank`` and the bass's ``ws4_bank``
   once a block) and that each routed family's scan is one
   ``affine1_bank`` a routed parameter a block, its first 2 blocks against
   a copy rendered on the plain versions, then ``bounce_to_buffer`` of 0.5 s
   from two copies of the engine, bit for bit; (b) every family at the
   full kit's widths through ``render_many`` (kick, snare, hihat, hihat2
   1,024; tom, tom2, bass 512; poly 85 synths, 510 lanes: 6,142 voices,
   all on the stage path) with ``build_full_kit``'s traffic and its
   seven-effect bus and three routes (LFO 0 on bass 0's cutoff, LFO 1 on
   kick 0's pitch, LFO 2 on hihat 0's decay), median of 3 renders of 64
   blocks, wall ms/block and aggregate RTF, its first 2 blocks against the
   plain versions, and the kernels at the shapes the cell adds (the poly
   lanes' ``affine1_bank`` and ``svf_bank`` at 510 rows, the tom's
   triangle at [512, B] and 128 harmonics) timed with their bounds;
12. the loops and the submix graph, in the order of
   ``bench_configs.bench_preserve_pitch_loops``: ``Mixer(44100, bpm=180,
   block_size=512)`` at its default capacity (four [2, 2^22] buffers), its
   four channels each an 8 s stereo loop (four bars at 120 BPM: warp 1.5;
   noise bursts on the beats over a low sine, from the seed) in
   PreservePitch; (a) the host search and (b) the device search
   (``search_hop`` a hop), 32 ``render_block`` calls each; the stem render
   of channel 0 twice, bit for bit; (c) the streamed hop loop,
   ``render_blocks(128)`` three times, every channel streamed, three
   ``grain_read_cubic`` launches a hop, the WSOLA reads' shapes (four
   channels' 65 coarse and 31 fine candidates of a hop, 882 samples, and
   their 12 grain rows of 1,764) timed with their bounds, bit-equal to the
   plain version; its first 8 blocks against (b)'s within 1.5e-3; (d) the
   loops in row 0 of the clip grid, the transport running, launched at beat
   0, ``render_blocks(2)`` then ``render_blocks(128)`` streamed; (e)
   ``MixerGraph.with_default_layout`` for 64 blocks fed by (d)'s output and
   an ``Engine`` of phase 9's 16 kicks, a lowpass, a delay and the plate on
   the Loops track (one ``bus_chain`` and one ``plate_block`` a block), the
   Drums track at pan 0.2, the Loops track soloed from block 32, each
   track's ``take_peak``; each part's wall ms/block (and (a)-(d)'s
   aggregate RTF over the 4 channels) and launches a block; the first 4
   blocks of (a), (b) and (e) and (c)'s and (d)'s first calls against a
   copy rendered on the plain versions;
13. ``GooeyEngine``, the product engine behind the C API, at its full width
   (4 kit channels x 5 kinds, the bass strip, the poly): (a)
   ``bench_configs.bench_sequenced_submix``'s session (four strips on
   ``x.x.x.x.x.x.x.x.``, pans 0.2-0.8, strip 3 muted), 16 blocks through
   ``_render_one_block``, then ``render(K * 512)`` through the span at K =
   16 and 64; (b) ``bench_interactive_pipelined``'s (swing 0.6, saturation,
   delay and spring: one ``bus_chain`` a block), 64 blocks enqueued before
   one synchronize (median of 3), then a depth-1 loop for the worst block;
   (c) a whole session at 180 BPM: (b)'s strips, the kick and the tom struck
   on their first step as well (a multi-trigger block: the span takes their
   stage path), the granulator on phase 10's source, triggered, a rack of
   two slots with its pattern, phase 12's four loops in PreservePitch
   (streamed), a chord on the poly, saturation -> lowpass -> delay -> plate
   and a compressor keyed from strip 0; ``render(64 * 512)`` through the
   span (every kernel of ``SESSION_PATH`` launched), then 64 callbacks of
   ``EngineOutput.fill`` paced at 11.61 ms with a prefetch of 4, with its
   overrun count.  Each render's wall ms/block and RTF (audio s over wall
   s); its first 2 blocks against a copy on the plain versions; (a)'s and
   (c)'s spans against a second engine's per-block path; the span's block
   loop under ``torch.cuda.set_sync_debug_mode("warn")``, no synchronizing
   call allowed;
14. the C API, ``libgooey_tpu_torch.capi`` (never the JAX package's),
   driven as a C host drives it (``capi_session``: integer ids only; four
   strips and the bass on patterns with swing, pans, the snare's filter
   type, the kick's and the tom's strips struck by hand on their first
   step, saturation -> delay -> plate and a compressor keyed from strip 0,
   a rack of two seeded slots with its pattern, the granulator on phase
   10's source, a chord on the poly): (a) 64 calls of
   ``engine_render(h, 512)``, each timed as the host sees it (ms per call
   against the 11.61 ms limit, the median and the worst, RTF, launches a
   block; every kernel of ``CAPI_PATH`` launched), its first 2 calls
   against a copy on the plain versions, then one
   ``engine_render(h, 64 * 512)`` through the span (after two hand strikes
   of the kick's and the tom's strips) with no synchronizing call in its
   block loop; (b) ``dsl.build_engine`` of ``tests/test_dsl_capi.py``'s
   program on the card, 16 blocks against a copy on the plain versions;
   the seconds each part took;
15. ``os_mode`` 1 and 2 and the examples (``phase_os_modes``, alone after
   ``_build.build(); _build.load_library()``): (a) full_kit_4096_bus7 with
   the kick, the snare and the bass at ``os_mode`` 2 through
   ``family_static`` (their drive on ``ops/oversample.process``: no
   ``fbws_bank`` or ``ws4_bank`` launch, 52 ``affine1_bank`` launches a
   block, the rows of each printed), 16 blocks timed (wall ms/block, RTF),
   then at ``os_mode`` 1 (28 a block) for one block; each one's first
   blocks, with every voice of the three struck at the first sample,
   against the plain versions within 1e-4; (b) the saturation, the
   compressor (self-keyed and keyed) and the feedback waveshaper's
   zero-feedback path on [2, 512] and ``waveshaper.process_bank`` on 512
   rows, at 1 and 2, each one block against the plain versions, output and
   state; (c) ``affine1_bank`` at the oversampler's 2,048, 1,024 and 4 rows
   of 512 (an allpass section's arguments), bit-equal, with its device
   time, its plain version's, its bound and its launches a block on (a)'s
   and (b)'s paths; (d) the 29 examples of ``libgooey_tpu_torch.examples``
   at their JAX ``quick`` lengths (the themed tours at 0.5 s) into a
   temporary directory, each WAV finite and audible (``loops_and_clips``'
   clip waits for the next bar, past 0.5 s), the scope's frame drawn, each
   one's wall seconds, ``antialias_validation``'s 2x and 4x alias
   reduction (at least 20 dB) beside its ns/sample;
16. the sharded render over ``torch.distributed``
   (``libgooey_tpu_torch.parallel.mesh``; ``phase_mesh``, alone after
   ``_build.build(); _build.load_library()``): (a) full_kit_4096_bus7 at
   full width on two gloo ranks (``torch.multiprocessing.spawn``,
   ``file://`` init in a temporary directory, ``GLOO_SOCKET_IFNAME=lo``
   unless set) sharing the card, each holding half of every family (512 /
   512 / 512 / 256 / 256 voices), the seven-effect bus and the limiter
   replicated after one [3, B] all-reduce of the mix and the mono sum a
   block, 16 blocks timed (wall ms/block of each rank beside the
   single-process render's), then 4 more of rank 0 under torch.profiler
   (the all-reduces' share of its wall, its device ops and its
   hand-written kernels by name); (b) on the same ranks 4 blocks of the
   full product scope (an LFO route on kick 768 and the compressor keyed
   from kick 640, both rank 1's rows, the compressor over the kit's level)
   and 4 of ``collect_sources`` into four buses, every voice also struck at
   the first sample; (c) (a)'s 16 blocks on a one-rank NCCL group in this
   process; (d) phase 11(b)'s eight families at their widths on the two
   ranks through ``engine._render_all(..., mesh=...)`` (the JAX package's
   GSPMD render, every bank off the kit path), poly at 86 synths (516
   lanes; 85 do not halve) placed by synth, the three routes and LFO 3 on
   synth 60's filter cutoff (rank 1's), a chord on synths 0 and 60 at the
   first sample and synth 60 released at block 2, 8 blocks timed and
   compared, then 4 of rank 0 under torch.profiler; (e) phase 10's
   granulator (4,000 lanes, drive engaged) and sampler (128 voices, arena
   filled) split by lanes (``shard_rack_state``), each block a steal of a
   rank-0 lane into a rank-1 release lane (one all-reduce of the victim's
   fields), a spawn on each rank and a sampler start on each, the lane
   sums all-reduced, 16 blocks timed and compared, then 4 traced.  The
   ranks' outputs equal each other bit for bit, rank 0's lie within 1e-5
   of the single-process render of the same inputs and its state gathered
   (to family order) within 1e-4 (relative where it exceeds 1), the
   sources' gathered voices and peaks within 1e-5, (c) equals the
   single-process render bit for bit, and rank 0's launch counts (and
   (c)'s) show every kernel of the path launched, ``mix_bank``,
   ``bus_chain`` and ``plate_block`` once a block; in (d) the poly's four
   ``affine1_bank`` and one ``svf_bank`` a block at its 258 local lanes
   and its route's scan at its 43 synths (calls by rows, ``last_calls``),
   in (e) ``grain_read_cubic``, ``sampler_read_linear``,
   ``ws4_bank`` and ``affine1_bank`` once a block.  A rank that raises ends
   the script with its traceback.  To rehearse on the CPU: shrink ``B``,
   ``KIT``, ``WHOLE_KIT`` with ``MESH_POLY``, ``MESH_POLY_SLOT`` and
   ``MESH_CHORD``, ``G_LANES``, ``S_VOICES`` and the ``N_MESH_*`` counts
   (the ranks take them from the parent, ``MESH_SIZES``) and let ``check``
   pass the launch-count and silence checks (the plain versions count
   nothing; ~3 min at 8-voice banks, 320 lanes, 3 blocks);
   ``phase_mesh(torch.device("cpu"), ...)`` then runs the ranks and (c) on
   gloo.

The last line is ``{"ok": true, "device": {...}}``; the line before holds
the card's name and power limit, and the one before that the per-kernel
JSON summary (launches from the first full_kit_4096_bus7 render, the
eight single bus kernels' from its ``fuse_bus=False`` render, the kit
kernels' from the product render and the two waveshapers' from its
``fuse_runs=False`` render, the grain and sampler reads' from phase 10's
render, each raised to phase 13 (c)'s span count and then to phase 14's
64 calls' count and to phase 15 (a)'s where that is larger;
``ms`` the device time per call of each kernel's first phase-3
case, timed with CUDA events where the profiler traces nothing;
``library_ms`` ``mix_bank``'s matmul yardstick at the kit cells' settled
traffic (printed at the product block's 64 voices too), null elsewhere).  ``--profile PATH``
also writes torch.profiler tables of 4 steady-state blocks of the kick
slice, the kit, each kit-with-bus render, the product block (fused and
with ``fuse_runs=False``), phase 9's sidechained ``Engine`` render,
phase 10's render, phase 11(b)'s render, 4 blocks of phase 12's (c)
and (e), 4 blocks of phase 13's (a) per-block and span, (b) and (c), and 4 of
phase 14's calls and of its span to PATH.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import json
import subprocess
import sys
import time

import numpy as np

SR = 44100.0
B = 512
V = 4096
#: the kit's banks (bench_configs.build_full_kit), in the engine's family order
KIT = {"kick": 1024, "snare": 1024, "hihat2": 1024, "tom2": 512, "bass": 512}
N_BLOCKS = 64
N_COMPARE = 2
#: timed repeats of the 64-block render (the host clock is shared and noisy):
#: the bus phase's; the kick and kit phases before it take 3
N_REPEATS = 5
N_REPEATS_EARLIER = 3
SEED = 0
#: audio the Engine phase renders each way, seconds
ENGINE_SECONDS = 1.0
#: the bus of full_kit_4096_bus4: the first four effects of build_full_kit's
FX_ORDER = ("saturation", "lowpass", "tilt", "delay")
#: build_full_kit's whole bus, in its order (full_kit_4096_bus7)
FX_ORDER_FULL = FX_ORDER + ("compressor", "spring", "plate")

#: kernel vs plain version: tanhf/expf/tanf and the order of a few roundings
#: differ.  State is compared relative to its magnitude where that exceeds 1
#: (the delay's cutoff smoother holds Hz).
OUT_TOL = 1e-5
STATE_TOL = 1e-4

#: the redesigned kernels: bit-equal to their plain versions at every case
EXACT = ("affine1_bank", "pink_bank", "svf_bank", "ws4_bank", "linrec2_bank", "kit_sources",
         "kit_drive", "bus_chain", "plate_block", "env_follow_bank", "fbws_bank", "mix_bank",
         "triangle_additive_bank", "grain_read_cubic", "saturation_block", "compressor_block",
         "env_follower_block", "spring_block", "waveshaper_block", "fbws_fast_block",
         "lowpass_block", "delay_block", "tilt_block", "sampler_read_linear")

#: the card's published peaks (H100 SXM, dense, at 700 W): device memory
#: bytes/s and float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

#: arithmetic operations per row-sample, read off each kernel's body (add,
#: subtract, multiply, divide, min/max: 1 each; a fused multiply-add 2; a
#: transcendental 1; compares, selects and loads not counted)
OPS_PER_ROW_SAMPLE = {
    "affine1_bank": 3, "pink_bank": 14, "svf_bank": 10, "env_follow_bank": 4,
    # 32 allpass sections x 3, three half-sums, the shaper at 4 subsamples
    "fbws_bank": 111, "ws4_bank": 114, "linrec2_bank": 8,
    # 4 trajectories, the 4x chain, 4 atan shapers, DC blocker, mix
    "saturation_block": 226, "lowpass_block": 12, "tilt_block": 54, "delay_block": 43,
    # |x|, the attack/release blend
    "env_follower_block": 5,
    # knee (log, exp, 13), gain smoother 3, x*g, the 4x chain 99, 4 atan
    # shapers 64, DC blocker 3, mix 3
    "compressor_block": 188,
    # beta 18, the damping loop 6, six allpasses 24, mix 3
    "spring_block": 51,
    # per sample of the mono block: the one-poles 9, four lerped reads 12,
    # the diffusion's affine chain 22, two modulated allpasses 2 x 9
    "plate_block": 61,
    # the 4x chain 99, four tanh shapers 12, the mix 3
    "waveshaper_block": 114,
    # drive 1, the 4x chain 99, four tanh 4, the makeup gain 20, DC 3, the
    # feedback filter 4, the mix 3
    "fbws_fast_block": 134,
    # per (voice, sample): the two smoothers 6, the clip and angle 3, cos
    # and sin 2, x*gain 1, two products 2, three sums 3
    "mix_bank": 17,
    # per output sample: age 1, the position 4 (multiply, add, clip), the
    # fraction 1, the Catmull-Rom coefficients 16, the Horner form 6
    "grain_read_cubic": 28,
    # per (voice, sample), both channels: age 2, position 3, the fraction
    # 1, end - 1 1, two lerps 3 each
    "sampler_read_linear": 13,
}
#: the row recurrences' carried chains: dependent operations a sample on the
#: path from one sample's state to the next's (svf_bank: ic2 -> x - ic2 ->
#: *g -> +ic1 -> *h -> g*v1 -> +ic2 -> 2*v2 -> -ic2, and the reset select;
#: ws4_bank and fbws_bank: a stage-2 allpass section, stepped twice a
#: sample, 3 each (fbws_bank's DC blocker, 2, runs beside it);
#: affine1_bank: multiply, add, max; linrec2_bank: fma, add; pink_bank: a
#: pole's multiply, the reset's select, the add; kit_drive: its 4x chain's,
#: as ws4_bank's; env_follow_bank: r - env, the multiply, the add, the
#: flush's compare and select, the freeze select; plate_block: the
#: bandwidth filter's multiply and add; the bus kernels' channel walks
#: (bus_kernels.cu): the 4x chain's 6 of saturation_block,
#: compressor_block (its gain smoother beside it), waveshaper_block and
#: fbws_fast_block, lowpass_block's s2 -> s2*fb -> tanh -> *min(fb, 1) ->
#: x - -> - s1 -> *g -> + s1 -> s1 - s2 -> *g -> + s2, the NaN compare,
#: the flush's compare and the select, 20 instructions in the walk's SASS
#: (cuobjdump -sass of walk_lone_kernel<LowpassLone>), tanhf 8 of them
#: (|v|*2log2(e), ex2, + 1, rcp, 1 - 2r, the select past 9.01, the sign and
#: the small-argument polynomial's last fma); tilt_block's SVF (ic2 -> x -
#: ic2 -> *g -> + ic1 -> *h -> g*v1 -> + ic2 -> 2*v2 -> - ic2), delay_block's two-pole filter
#: (a multiply, two adds), env_follower_block's compare, select, multiply,
#: add, flush compare and select, spring_block's damping loop (multiply,
#: add); bus_chain: its longest phase's, the phases running side by side),
#: and the latency of one float32 operation on the card, in cycles
CHAIN_OPS_PER_SAMPLE = {"svf_bank": 9, "ws4_bank": 6, "affine1_bank": 3, "linrec2_bank": 2,
                        "pink_bank": 3, "kit_drive": 6, "env_follow_bank": 6, "plate_block": 2,
                        "fbws_bank": 6, "saturation_block": 6, "lowpass_block": 20,
                        "tilt_block": 8, "delay_block": 3, "env_follower_block": 6,
                        "compressor_block": 6, "spring_block": 2, "waveshaper_block": 6,
                        "fbws_fast_block": 6}
CHAIN_CYCLES_PER_OP = 4
#: the additive triangle's operations (csrc/triangle.cuh, the work its
#: function needs): a sample's phase, sines and harmonic limit 10 (idx * f,
#: * w, 2 * theta, sinf, cosf, 2 * cos, fmaxf, nyquist / f, floorf,
#: -sin1); an active untapered term 4 (gain * curr, + acc, cos2x2 * curr,
#: - prev); a tapered term 10 more (h, f * h, the ratio's division, t,
#: t * t, 1 - t * t, h * h, the gain's division); the +0.0f of a walk that
#: stops at an inactive term 1
TRI_OPS_SAMPLE, TRI_OPS_TERM, TRI_OPS_TAPERED = 10, 4, 10
#: the kit kernels' operations per row-sample, by body, without the kick's
#: and the snare's additive triangles (``kit_body_ops``): the trajectories,
#: envelopes (a pow each), oscillators, hashes and recurrences ~130-150;
#: the bass's and the drives' 4x chains ~110
OPS_PER_BODY_SAMPLE = {"kick_a": 150, "snare_a": 130, "hihat2": 220, "bass": 260, "tom2": 200,
                       "kick_b": 130, "snare_b": 140}
#: the product kit (__graft_entry__.entry), in the engine's family order
PRODUCT_KIT = {"kick": 16, "snare": 16, "hihat2": 16, "tom2": 8, "bass": 8}
#: phase 3's tails of the redesigned kernels: bus_chain's and plate_block's
#: block sizes past the main path's, and kit_sources' kits (one voice a family, odd counts,
#: the kit path's most, ops/voice.py MAX_FUSED_VOICES) with their block sizes
TAIL_BLOCKS = (100, 33)
ODD_KIT = {"kick": 5, "snare": 3, "hihat2": 7, "tom2": 1, "bass": 2}
TAIL_KITS = ((dict.fromkeys(PRODUCT_KIT, 1), B), (ODD_KIT, 100), (ODD_KIT, 37),
             (dict.fromkeys(PRODUCT_KIT, 128), B))
#: bench_onchip_product_block's chain: lowpass, delay, saturation,
#: compressor, tilt, spring, waveshaper, feedback waveshaper, plate
CHAIN9 = (0, 1, 2, 3, 4, 6, 7, 8, 9)
#: the product comparison's blocks, with both waveshapers engaged
N_COMPARE_PRODUCT = 4
PRODUCT_ENGAGED = {6: [4.0, 0.5], 7: [4.0, 0.0, 2000.0, 1.0]}
#: the 2-block render with kernels vs with plain versions, on the card
RENDER_TOL = 1e-4
#: granulator_lfo_sampler_4k_lanes (bench_configs.py:465-537): grain lanes,
#: sampler voices (4 racks x 32), the granulator's source and the arena
G_LANES = 4000
S_VOICES = 128
GRAIN_SOURCE = 1 << 15
ARENA_FRAMES = 1 << 15
#: its comparison's blocks and drive; the host-driven render's length
N_COMPARE_GRAIN = 4
GRAIN_DRIVE = 0.5
HOST_SECONDS = 1.0


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), for the chain floors."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(res.stdout.strip().splitlines()[0]) * 1e6


def chain_floor_ms(name, args, clock_hz):
    """The least time of a row's carried chain: its dependent operations a
    sample (``CHAIN_OPS_PER_SAMPLE``) at ``CHAIN_CYCLES_PER_OP`` cycles each,
    over the B samples of a block, at the maximum SM clock (``bus_chain``:
    its longest phase's); None for a kernel not listed."""
    if name == "bus_chain":   # (x, phases): the longest phase's chain
        ops = max(CHAIN_OPS_PER_SAMPLE[ph.name] for ph in args[1])
        return ops * CHAIN_CYCLES_PER_OP * args[0].shape[-1] / clock_hz * 1e3
    if name not in CHAIN_OPS_PER_SAMPLE:
        return None
    if name == "kit_drive":   # a list of phases: their block size
        from libgooey_tpu_torch.ops import voice_kernels

        b = voice_kernels._vb_of(args[0][0])[1]
    else:
        b = next(a for a in args if a is not None).shape[-1]
    return CHAIN_OPS_PER_SAMPLE[name] * CHAIN_CYCLES_PER_OP * b / clock_hz * 1e3


def cuda_ms(fn, iters):
    """Mean device milliseconds per call over ``iters`` calls (CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """Device milliseconds per call over ``iters`` calls: the CUDA time that
    torch.profiler traces (the kernels, and any fill or copy the wrapper
    launches), so a kernel shorter than its wrapper's host work is timed as
    itself.  Each device op counts the median of its traced durations times
    its launches per call (its count in the trace over ``iters``, rounded):
    a trace now and then holds one op less than the calls launched, or one
    of the session before it, which this reads past.  None where no trace
    holds a device op."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        durations = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                durations.setdefault(e.name, []).append(e.self_device_time_total)
        total = sum(float(np.median(d)) * round(len(d) / iters) for d in durations.values())
        if total > 0:
            return total / 1e3
    return None


def event_ms(fn, iters):
    """Device milliseconds per call between two CUDA events, the calls
    queued behind a ~2 ms ``torch.cuda._sleep`` so that the events time the
    device's work and not the host's enqueue (for a call whose kernel the
    profiler's trace misses)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e6))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    import torch

    if isinstance(a, (tuple, list)):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


# --- phase 3: kernels against their plain versions ---------------------------


def case_err(a, b) -> float:
    """:func:`max_err` of an ``EXACT`` kernel's outputs against its plain
    version's, where a NaN or an infinity on both sides at one place agrees
    (the triangle's edge cases give NaN for an infinite frequency; the bits
    are held by :func:`same_bits`); a NaN on one side only is a NaN
    error."""
    import torch

    if isinstance(a, (tuple, list)):
        return max(case_err(x, y) for x, y in zip(a, b))
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    d = torch.where((a == b) | (torch.isnan(a) & torch.isnan(b)), 0.0, d)
    return float(d.max())


def same_bits(a, b) -> bool:
    """Every tensor of two nested outputs equal bit for bit (floats by their
    int32 view, so NaNs and signed zeros count)."""
    import torch

    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def kernel_cases(dev):
    """(name, shape label, args, kwargs, n_outputs) at the main path's
    shapes; a kernel may have more than one case."""
    import torch

    from libgooey_tpu_torch.core.smoother import smoothing_coeff
    from libgooey_tpu_torch.effects import feedback_waveshaper as fbws
    from libgooey_tpu_torch.ops import bank_kernels as bk

    rs = np.random.RandomState(SEED)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    def mask(p, rows=V):
        return t(rs.rand(rows, B) < p, torch.bool)

    kick_shape = f"V={V}, B={B}"
    cases = []
    # 1. affine1 at the main path's shapes (full_kit_4096_bus7: 19 launches a
    #    block at 512 rows, tom2's and the bass's phase accumulators and
    #    filters, through linrec1 with no floor array; 7 at 1,024, hihat2's
    #    trackers with a live floor among them), the first case's times
    #    going to the kernel line
    def one_pole(rows, b=B):
        return (t(np.where(rs.rand(rows, b) < 0.002, 0.0, 0.9 + 0.0999 * rs.rand(rows, b))),
                t(0.01 * rs.randn(rows, b)), t(0.1 * rs.randn(rows)))

    def tracker(rows, b=B):   # scan.asym_smooth: instant up, one-pole down, resets
        target = np.abs(0.5 * rs.randn(rows, b))
        return (t(target), t(np.where(rs.rand(rows, b) < 0.002, 0.0, 1.0 - 0.0005)),
                t(0.0005 * target), t(np.abs(0.1 * rs.randn(rows))))

    for rows in (512, 1024):
        cases.append(("affine1_bank", f"V={rows}, B={B}, no floor", (None, *one_pole(rows)), {}, 1))
    cases.append(("affine1_bank", f"V=1024, B={B}, live floor (maxlin)", tracker(1024), {}, 1))
    #    the kick's 4,096 rows, an explicit floor row, as before
    cases.append(("affine1_bank", f"{kick_shape}, explicit -3e38 floor", (
        t(np.full((V, B), bk.NO_FLOOR, np.float32)), *one_pole(V)), {}, 1))
    #    pallas_scan.linrec1_pallas's y[n] = a[n]*y[n-1] + b[n], |a| < 1, as
    #    every port linrec1 runs it
    cases.append(("affine1_bank", f"{kick_shape}, no floor: linrec1_pallas's function", (
        None, t(rs.uniform(-0.99, 0.99, (V, B))), t(rs.randn(V, B)), t(rs.randn(V))), {}, 1))
    #    the granulator's 1/sqrt(N) smoother: one row
    cases.append(("affine1_bank", f"V=1, B={B}, no floor", (None, *one_pole(1)), {}, 1))
    #    tails: 515 rows (not a multiple of rows per block), 100 samples (not a
    #    multiple of the 64-sample chunk), 99 (4-byte copies)
    cases.append(("affine1_bank", "V=515, B=100, live floor", tracker(515, 100), {}, 1))
    cases.append(("affine1_bank", "V=515, B=99, no floor", (None, *one_pole(515, 99)), {}, 1))
    # 2. pink over white noise at the main path's shapes (full_kit_4096_bus7:
    #    the kick's 1,024 rows with trigger resets, hihat2's 1,024 with no
    #    mask; the kick slice's 4,096 with resets), the first case's times
    #    going to the kernel line
    cases.append(("pink_bank", f"V=1024, B={B}, resets (the kit's kick)",
                  *pink_rows(rs, t, 1024, B), 1))
    cases.append(("pink_bank", f"V=1024, B={B}, no reset mask (hihat2)",
                  *pink_rows(rs, t, 1024, B, resets=False), 1))
    cases.append(("pink_bank", f"{kick_shape}, resets (the kick slice)",
                  *pink_rows(rs, t, V, B), 1))
    # 3. the TPT SVF at the main path's shapes (full_kit_4096_bus7: the
    #    kick's noise low-pass and hihat2's tone filter at 1,024 rows, the
    #    bass's at 512; the product kit's bass at 8; the kick slice's 4,096)
    #    with per-sample cutoff sweeps and trigger resets, the first case's
    #    times going to the kernel line; then without a reset mask
    for rows in (1024, 512, 8, V):
        cases.append(("svf_bank", f"V={rows}, B={B}, resets", svf_rows(rs, t, rows, B), {}, 2))
    cases.append(("svf_bank", f"V=1024, B={B}, no reset mask",
                  svf_rows(rs, t, 1024, B, resets=False), {}, 2))
    # 4. envelope follower with bypass freezes
    att, rel = fbws.env_coeffs(SR)
    cases.append(("env_follow_bank", kick_shape, (
        t(np.abs(0.5 * rs.randn(V, B))), mask(0.1), t(np.abs(0.1 * rs.randn(V)))),
        dict(att=att, rel=rel), 1))
    # 5. the 4x waveshaper chain: kick-range drive, makeup gain, some bypass
    cases.append(("fbws_bank", kick_shape, (
        t((1.0 + 40.0 * rs.rand(V, 1) ** 3) * 0.3 * rs.randn(V, B)),
        t(np.where(rs.rand(V, B) < 0.05, -1.0, 0.2 + 2.8 * rs.rand(V, B))),
        t(0.1 * rs.randn(bk.FBWS_S_IN, V))), {}, 1))
    # 6. the 4x overdrive at the main path's shapes (bus7: the snare's 1,024
    #    rows, the bass's 512, drive 1-10 per voice, some rows bypassed; the
    #    granulator's one row at its drive of 4), the first case's times
    #    going to the kernel line
    Vs = KIT["snare"]
    for rows in (Vs, KIT["bass"]):
        cases.append(("ws4_bank", f"V={rows}, B={B}", ws4_rows(rs, t, rows, B), {}, 1))
    cases.append(("ws4_bank", f"V=1, B={B}, drive 4 (the granulator's)",
                  ws4_rows(rs, t, 1, B, drive=4.0), {}, 1))
    # 7. linrec2 at the main path's shapes (full_kit_4096_bus7: 1 launch a
    #    block at 512 rows, 3 at 1,024, 1 at 2,560, tom2's 512 voices x 5
    #    membrane bands), high-Q band-pass rows with resets, the first
    #    case's times going to the kernel line; then the tails
    def resonators(rows, b=B):
        wr = 2 * np.pi * rs.uniform(160.0, 330.0, (rows, 1)) / SR
        alpha = np.sin(wr) / (2 * rs.uniform(1.0, 7.5, (rows, 1)))
        keep = np.where(rs.rand(rows, b) < 0.002, 0.0, 1.0)
        return (t(2 * np.cos(wr) / (1 + alpha) * keep), t(-(1 - alpha) / (1 + alpha) * keep),
                t(keep), t(np.zeros((rows, b))), t(0.002 * rs.randn(rows, b)),
                t(np.zeros((rows, b))), t(0.01 * rs.randn(rows)), t(0.01 * rs.randn(rows)))

    for rows, b in ((1024, B), (512, B), (5 * KIT["tom2"], B), (515, 100), (515, 99)):
        cases.append(("linrec2_bank", f"R={rows}, B={b}", resonators(rows, b), {}, 2))
    # 8. the snare's tonal triangle: up to 2 s after the trigger, 40-2,000 Hz
    cases.append(("triangle_additive_bank", f"V={Vs}, B={B}, 64 harmonics", (
        t(rs.randint(0, 2 * int(SR), (Vs, 1)) + np.arange(B)[None, :]),
        t(rs.uniform(40.0, 2000.0, (Vs, B)))), dict(sample_rate=SR, max_harmonics=64), 1))
    #    the snare's own traffic: the launch of the kit's snare bank (bus7's)
    #    at block SNARE_BLOCK of the kit's sequenced traffic
    cases.append(("triangle_additive_bank", f"V={Vs}, B={B}, 64 harmonics, the snare's traffic "
                  f"(block {SNARE_BLOCK})", snare_triangle_args(dev),
                  dict(sample_rate=SR, max_harmonics=64), 1))

    # 9-20. the bus at the main path's block: the single kernels, then the
    #     runs of bus_chain (the kit's seven phases, the first four, the
    #     product chain's ten), each against its phases' own kernels too
    bus_single, runs = bus_cases(dev, rs, B)
    cases += bus_single
    for label, run in list(runs.items())[:3]:
        cases.append(("bus_chain", label, run, {}, 1))
    # 21-22. the kit kernels at the product kit's shapes
    sources, drive = kit_phases(dev)
    cases.append(("kit_sources", kit_label(PRODUCT_KIT, B), (sources,), {}, None))
    cases.append(("kit_drive", f"kick {PRODUCT_KIT['kick']} + snare {PRODUCT_KIT['snare']}, "
                  f"B={B}", (drive,), {}, None))
    # 23. the engine's fused mix over the kit's 4,096 voices: pans sweeping to
    #     their mirror image, gains falling from 1.5/V to 1/V
    Vk = sum(KIT.values())
    pan = np.linspace(0.2, 0.8, Vk)
    cases.append(("mix_bank", f"V={Vk}, B={B}", (
        t(0.3 * rs.randn(Vk, B)), t(pan), t(pan[::-1]), t(np.full(Vk, 1.5 / Vk)),
        t(np.full(Vk, 1.0 / Vk))), dict(coeff=smoothing_coeff(SR)), 3))
    # 24. the granulator's reads at the 4k bench's lanes and source: steps
    #     ±[0.5, 2] and every 50th at ±8, starts across and beyond the
    #     source, ages up to 60,000 samples and never-spawned lanes (2^30);
    #     then without ages (age = n)
    G = G_LANES
    step = rs.uniform(0.5, 2.0, G) * rs.choice([-1.0, 1.0], G)
    step[::50] = 8.0 * np.sign(step[::50])
    age0 = rs.randint(-B, 60000, G)
    age0[::97] = 2**30
    grain = (t(0.3 * np.random.RandomState(0).randn(GRAIN_SOURCE)),
             t(rs.uniform(-300.0, GRAIN_SOURCE + 300.0, G)), t(step))
    grain_shape = f"G={G}, L={GRAIN_SOURCE}, B={B}"
    cases.append(("grain_read_cubic", grain_shape + ", ages", grain,
                  dict(B=B, age0=t(age0, torch.int32)), 1))
    cases.append(("grain_read_cubic", grain_shape + ", age = n", grain, dict(B=B), 1))
    # 25. the sampler's reads: 128 voices, slots of 2,000-30,000 frames with
    #     fractional ends, bases spread over the arena (those running past
    #     its end clamp), voices started up to 30,000 samples back
    S = S_VOICES
    cases.append(("sampler_read_linear", f"V={S}, F={ARENA_FRAMES}, B={B}", (
        t(0.3 * rs.randn(ARENA_FRAMES, 2)), t(rs.randint(0, ARENA_FRAMES, S), torch.int32),
        t(rs.uniform(2000.0, 30000.0, S) + rs.choice([0.0, 0.25, 0.5], S)),
        t(rs.randint(-30000, 2 * B, S), torch.int32), t(rs.uniform(0.5, 2.0, S)), 3 * B),
        dict(B=B), 1))
    # 26. the redesigned kernels' tails: bus_chain at B with one phase,
    #     twelve, and nine with two delays and the spring last, then at 100
    #     and 33 samples (not whole chunks) with 1, 4, 7, 9, 10 and 12;
    #     kit_sources with one voice a family, 5/3/7/1/2 voices at 100 and 37
    #     samples (not whole tiles), and MAX_FUSED_VOICES a family
    for label, run in list(runs.items())[3:]:
        cases.append(("bus_chain", label, run, {}, 1))
    for b in TAIL_BLOCKS:
        for label, run in bus_cases(dev, np.random.RandomState(SEED + b), b)[1].items():
            cases.append(("bus_chain", label, run, {}, 1))
    #     saturation_block, compressor_block, waveshaper_block and
    #     fbws_fast_block (their four walks pipelined over warps) at B, 100
    #     and 33 samples with their bypass gates crossed inside chunks (and
    #     the compressor's gain through 0.99; the waveshapers bypassed by
    #     mix and by drive, engaged, +-inf in x, the envelope under the
    #     floor, the drive_norm clip, the filter's flush);
    #     env_follower_block with its bypass span's ends inside chunks and
    #     spring_block there too, then the spring at 22,050 and 96,000 Hz,
    #     with its history 4 bytes past a 16-byte boundary and with its
    #     shortest lag cut to 4 and 3 samples
    #     lowpass_block, delay_block and tilt_block (each channel's walk on
    #     a warp of its own) there too: the lowpass's feedback across 1, its
    #     stages flushed, +-inf in x; the delay's smoothers settling, its
    #     writes flushed, a NaN tap, both ping-pong settings, an unaligned
    #     tap; the tilt's knob through the center, a passthrough span, Q at
    #     its top, +-inf in x, x unaligned
    for b in LONE_BLOCKS:
        for name, label, args, kw in lone_edge_cases(dev, b):
            cases.append((name, label, args, kw, 2 if name == "delay_block" else 1))
    for label, args, kw in spring_cases(dev):
        cases.append(("spring_block", label, args, kw, 1))
    #     kit_sources and kit_drive at the same kits (kit_drive: a block a
    #     voice row, 32-sample chunks; at 100 and 37 samples a tail chunk)
    for kit, b in TAIL_KITS:
        sources, drive = kit_phases(dev, kit, b)
        cases.append(("kit_sources", kit_label(kit, b), (sources,), {}, None))
        cases.append(("kit_drive", f"kick {kit['kick']} + snare {kit['snare']}, B={b}",
                      (drive,), {}, None))
    #     pink_bank, svf_bank and ws4_bank at 515 rows (not a multiple of
    #     rows per block) of 100 samples (a tail chunk; the masks 4 bytes a
    #     copy) and 99 (4-byte copies; the masks byte by byte), then with
    #     every input 4 bytes past a 16-byte boundary
    for b in (100, 99):
        cases.append(("pink_bank", f"V=515, B={b}, resets", *pink_rows(rs, t, 515, b), 1))
        cases.append(("svf_bank", f"V=515, B={b}, resets", svf_rows(rs, t, 515, b), {}, 2))
        cases.append(("ws4_bank", f"V=515, B={b}", ws4_rows(rs, t, 515, b), {}, 1))
    #     env_follow_bank at bus7's 1,024 rows and the product kit's 16, at
    #     515 rows of 100 and 99 samples, and unaligned
    for rows, b in ((1024, B), (16, B), (515, 100), (515, 99)):
        cases.append(("env_follow_bank", f"V={rows}, B={b}, freezes",
                      *env_rows(rs, t, rows, b), 1))
    args, kw = env_rows(rs, t, 515, 128)
    cases.append(("env_follow_bank", "V=515, B=128, freezes, unaligned", unaligned(args), kw,
                  1))
    #     plate_block at 100 and 33 samples, with its modulated lags falling
    #     to 1, at 22,050 and 96,000 Hz
    for label, args, kw in plate_cases(dev):
        cases.append(("plate_block", label, args, kw, 4))
    args, kw = pink_rows(rs, t, 515, 128)
    cases.append(("pink_bank", "V=515, B=128, resets, unaligned", unaligned(args), kw, 1))
    cases.append(("svf_bank", "V=515, B=128, resets, unaligned",
                  unaligned(svf_rows(rs, t, 515, 128)), {}, 2))
    cases.append(("ws4_bank", "V=515, B=128, unaligned", unaligned(ws4_rows(rs, t, 515, 128)),
                  {}, 1))
    #     fbws_bank at the kit cells' kick (1,024 rows), at 515 rows of 100
    #     and 99 samples, and unaligned, with rows bypassed for the whole
    #     block and from mid-block on
    cases.append(("fbws_bank", f"V=1024, B={B}, bypassed rows (the kit's kick)",
                  fbws_rows(rs, t, 1024, B), {}, 1))
    for b in (100, 99):
        cases.append(("fbws_bank", f"V=515, B={b}, bypassed rows", fbws_rows(rs, t, 515, b), {},
                      1))
    cases.append(("fbws_bank", "V=515, B=128, bypassed rows, unaligned",
                  unaligned(fbws_rows(rs, t, 515, 128)), {}, 1))
    #     mix_bank with every pan and gain settled at the kit's 4,096 voices
    #     (the kit cells' traffic), with half of them settled, with the
    #     other half's pans at the settle snap's edge, at the product
    #     block's 64 voices (pan 0.5), and at 130 voices (a partial chunk)
    #     of 100 and 99 samples
    cases.append(("mix_bank", MIX_SETTLED, *mix_rows(rs, t, Vk, B), 3))
    cases.append(("mix_bank", f"V={Vk}, B={B}, half settled", *mix_rows(rs, t, Vk, B, half=True),
                  3))
    cases.append(("mix_bank", f"V={Vk}, B={B}, half at the settle snap's edge",
                  *mix_rows(rs, t, Vk, B, half=True, edge=True), 3))
    cases.append(("mix_bank", MIX_PRODUCT,
                  *mix_rows(rs, t, sum(PRODUCT_KIT.values()), B, pan=0.5), 3))
    for b in (100, 99):
        cases.append(("mix_bank", f"V=130, B={b}, half settled",
                      *mix_rows(rs, t, 130, b, half=True), 3))
    #     triangle_additive_bank at the edge frequencies (NaN, +-inf, +-0,
    #     negative, subnormal, T/h, nyquist/h, the max_h steps) at 0, 1, 64
    #     and 192 harmonics, in rows of 512 and 100; grain_read_cubic with
    #     one grain, three of 100 and 33 samples on a 4-sample source, steps
    #     of +-8.7 and infinite ones, and 37 of 99 on 1 and 3 samples
    for label, args, kw in triangle_tail_cases(dev):
        cases.append(("triangle_additive_bank", label, args, kw, 1))
    for label, args, kw in grain_tail_cases(dev):
        cases.append(("grain_read_cubic", label, args, kw, 1))
    #     sampler_read_linear with one voice, at 130 voices of 100 and 33
    #     samples, fractional ends, negative and non-finite increments, ages
    #     before the start, bases at the arena's end and ages wrapping
    for label, args, kw in sampler_tail_cases(dev):
        cases.append(("sampler_read_linear", label, args, kw, 1))
    return cases


def pink_rows(rs, t, rows, b, resets=True):
    """pink_bank ``(arguments, keywords)``: white noise, trigger resets (p =
    0.002, and on the first and the last sample of every 7th row) unless
    ``resets`` is False, a random carried state, the filter's coefficients
    at ``SR``."""
    import torch

    from libgooey_tpu_torch.ops import noise

    poles, gains = noise.coefficients(SR)
    kw = dict(poles=tuple(map(float, poles)), gains=tuple(map(float, gains)),
              direct=float(noise.DIRECT_GAIN), outg=float(noise.OUTPUT_GAIN))
    reset = rs.rand(rows, b) < 0.002
    reset[::7, 0] = reset[::7, -1] = True
    return (t(rs.uniform(-1, 1, (rows, b))), t(reset, torch.bool) if resets else None,
            t(0.1 * rs.randn(rows, 3))), kw


def svf_rows(rs, t, rows, b, resets=True):
    """svf_bank arguments: noise through 20-9,020 Hz cutoff sweeps at Q 0.9,
    trigger resets (p = 0.002, and on the first and the last sample of every
    7th row) unless ``resets`` is False."""
    import torch

    from libgooey_tpu_torch.ops import filters

    g, h = filters.svf_coeffs(t(20.0 + 9000.0 * rs.rand(rows, b)), 0.9, SR)
    reset = rs.rand(rows, b) < 0.002
    reset[::7, 0] = reset[::7, -1] = True
    return (t(0.3 * rs.randn(rows, b)), g.contiguous(), h.contiguous(),
            t(reset, torch.bool) if resets else None, t(0.1 * rs.randn(rows)),
            t(0.1 * rs.randn(rows)))


def ws4_rows(rs, t, rows, b, drive=None):
    """ws4_bank arguments: noise, a drive of 1-10 per row (a tenth of the
    rows at 1, bypassed) or ``drive`` everywhere, a random packed state."""
    from libgooey_tpu_torch.ops import bank_kernels as bk

    if drive is None:
        d = np.where(rs.rand(rows, 1) < 0.1, 1.0, 1.0 + 9.0 * rs.rand(rows, 1)) * np.ones(b)
    else:
        d = np.full((rows, b), drive)
    return t(0.5 * rs.randn(rows, b)), t(d), t(0.05 * rs.randn(bk.FBWS_S_IN, rows))


def fbws_rows(rs, t, rows, b):
    """fbws_bank arguments: noise at the kick's drive (1-41 a row), a makeup
    gain of 0.2-3 with 5% of the samples bypassed (< 0), every 5th row
    bypassed for the whole block and every 7th (from the 4th) from
    mid-block on, a random packed state."""
    from libgooey_tpu_torch.ops import bank_kernels as bk

    u = (1.0 + 40.0 * rs.rand(rows, 1) ** 3) * 0.3 * rs.randn(rows, b)
    cs = np.where(rs.rand(rows, b) < 0.05, -1.0, 0.2 + 2.8 * rs.rand(rows, b))
    cs[::5] = -1.0
    cs[3::7, b // 2:] = -1.0
    return t(u), t(cs), t(0.1 * rs.randn(bk.FBWS_S_IN, rows))


#: mix_bank's case at the kit cells' traffic, which also times its library
#: yardstick
MIX_SETTLED = f"V={sum(KIT.values())}, B={B}, every pan and gain settled"
#: the product block's mix case, whose yardstick is printed beside it
MIX_PRODUCT = f"V={sum(PRODUCT_KIT.values())}, B={B}, settled (the product block's)"


def mix_rows(rs, t, voices, b, half=False, edge=False, pan=None):
    """mix_bank ``(arguments, keywords)`` at ``SR``'s smoothing: voices of
    noise, pans over [0.2, 0.8] (``pan`` everywhere where given), gains
    1/V, every pan and gain at its target (the kit cells' traffic); with
    ``half``, every other voice's pan sweeping to its mirror image and its
    gain falling from 1.5/V, or with ``edge`` its pan as close to the
    settle snap's edge as float32 allows (:func:`snap_edge_pans`)."""
    from libgooey_tpu_torch.core.smoother import smoothing_coeff
    from libgooey_tpu_torch.ops import bank_kernels as bk

    coeff = smoothing_coeff(SR)
    pt = (np.linspace(0.2, 0.8, voices) if pan is None else np.full(voices, pan)).astype(np.float32)
    gt = np.full(voices, 1.0 / voices, np.float32)
    pc, gc = pt.copy(), gt.copy()
    if half and edge:
        q = np.float32(bk._mix_powers(coeff, b, "cpu").abs().max())
        pc[1::2] = snap_edge_pans(pt[1::2], q)
    elif half:
        pc[1::2] = pt[::-1][1::2]
        gc[1::2] = 1.5 / voices
    return (t(0.3 * rs.randn(voices, b)), t(pc), t(pt), t(gc), t(gt)), dict(coeff=coeff)


def snap_edge_pans(pt, q):
    """Current pans ``d`` away from targets ``pt`` with ``|d*q|`` (float32)
    one float32 step below the settle snap's 1e-4 (voices 0, 1 of every 4:
    settled for the block) or the first at or over it (voices 2, 3: their
    first samples unsnapped), above and below their targets in turn."""
    eps, q = np.float32(1e-4), np.float32(q)

    def over(c, p):
        return abs(np.float32(np.float32(c - p) * q)) >= eps

    out = np.empty_like(pt)
    for i, p in enumerate(pt.astype(np.float32)):
        away = np.float32(np.inf if i % 2 == 0 else -np.inf)
        c = np.float32(p + (eps / q if i % 2 == 0 else -eps / q))
        while over(c, p):
            c = np.nextafter(c, p)
        while not over(np.nextafter(c, away), p):
            c = np.nextafter(c, away)
        out[i] = np.nextafter(c, away) if i % 4 >= 2 else c
    return out


#: the triangle's case on the snare's own traffic: the launch of the kit's
#: snare bank at this block of the kit's sequenced traffic (every voice has
#: been struck: the lags are under 0.5 s, 43 blocks)
SNARE_BLOCK = 48
#: the triangle's edge cases: harmonics (0, 1 and 96 terms; the path's 32)
TRI_EDGE_HARMONICS = (64, 0, 1, 192)


def snare_triangle_args(dev, voices=None, block=SNARE_BLOCK):
    """``(idx, freq)`` of the additive triangle's launch that the kit's
    snare bank (``voices``, default the kit's 1,024, default preset,
    ``max_harmonics=64``) makes at ``block`` of the kit's sequenced traffic
    (:func:`kit_inputs`' draws), after rendering the blocks before it (with
    the triangle's plain version)."""
    import torch

    from libgooey_tpu_torch.core.smoother import smoothing_coeff
    from libgooey_tpu_torch.instruments import snare
    from libgooey_tpu_torch.ops import bank_kernels as bk

    voices = voices or KIT["snare"]
    rng = np.random.RandomState(0)
    sequenced_events(rng, KIT["kick"], block + 1)   # the kit draws the kick's lags first
    offs, vels = sequenced_events(rng, voices, block + 1)
    state, seen = snare.init_state(voices, device=dev), []

    def capture(idx, freq, sample_rate, max_harmonics):
        seen.append((idx.clone(), freq.clone()))
        return bk.triangle_additive_bank_plain(idx, freq, sample_rate, max_harmonics)

    real, bk.triangle_additive_bank = bk.triangle_additive_bank, capture
    try:
        for i in range(block + 1):
            state, _ = snare.render_block(
                state, torch.as_tensor(offs[i], device=dev), torch.as_tensor(vels[i], device=dev),
                np.int32(i * B), sample_rate=SR, block_size=B, smooth_coeff=smoothing_coeff(SR),
                max_harmonics=64, fused=False)
    finally:
        bk.triangle_additive_bank = real
    return seen[-1]


def triangle_edge_freqs(sr=SR):
    """Frequencies at the triangle's edges: NaN, +-inf, +-0, negative,
    subnormal, below the 1e-6 clamp, huge; and for every odd h up to 191,
    within two float32 steps of T/h (the taper's threshold), nyquist/h (the
    last active harmonic) and of the f where floor(nyquist/f) steps to h."""
    from libgooey_tpu_torch.ops import bank_kernels as bk

    f32 = np.float32
    nyq = f32(sr / 2.0)
    T = f32(bk.taper_threshold(float(nyq)))
    out = [np.nan, np.inf, -np.inf, 0.0, -0.0, -300.0, -1e-3, 1e-40, -1e-40, 1e-7, 1e-6,
           float(nyq), float(T), 1e30, -1e30, float(np.finfo(np.float32).max)]
    up, down = f32(np.inf), f32(-np.inf)
    for h in range(1, 192, 2):
        for edge in (f32(T / f32(h)), f32(nyq / f32(h)), np.nextafter(f32(nyq / f32(h)), up)):
            x = np.nextafter(np.nextafter(edge, down), down)
            for _ in range(5):
                out.append(float(x))
                x = np.nextafter(x, up)
    return np.array(out, np.float32)


def triangle_edge_args(dev, b, sr=SR, seed=SEED):
    """``(idx, freq)`` ``[V, b]`` holding :func:`triangle_edge_freqs` in
    order, the rest 40-2,000 Hz; ``idx`` up to 2 s after the trigger, with
    0, -0 and 1 among them."""
    import torch

    rs = np.random.RandomState(seed)
    edge = triangle_edge_freqs(sr)
    rows = -(-edge.size // b)
    freq = rs.uniform(40.0, 2000.0, rows * b).astype(np.float32)
    freq[:edge.size] = edge
    idx = rs.randint(0, 2 * int(sr), rows * b).astype(np.float32)
    idx[::13], idx[5::13], idx[7::13] = 0.0, -0.0, 1.0
    return tuple(torch.as_tensor(a.reshape(rows, b), device=dev) for a in (idx, freq))


def triangle_tail_cases(dev):
    """``(label, arguments, keywords)`` of the triangle past the main path:
    the edge frequencies at 64 harmonics (32 terms), 0, 1 and 192 (96
    terms), in rows of 512 and of 100 samples."""
    cases = []
    for b in (B, 100):
        args = triangle_edge_args(dev, b)
        for mh in TRI_EDGE_HARMONICS:
            cases.append((f"V={args[0].shape[0]}, B={b}, edge frequencies, {mh} harmonics", args,
                          dict(sample_rate=SR, max_harmonics=mh)))
    return cases


def grain_tail_cases(dev):
    """``(label, arguments, keywords)`` of grain_read_cubic past the main
    path: one grain; three of 100 and of 33 samples on a 4-sample source,
    steps of +-8.7 and an infinite one, starts NaN, +-inf and in range,
    ages wrapping past 2^31 and never-spawned (2^30); 37 grains of 99 on 1
    and 3 samples with age = n."""
    import torch

    rs = np.random.RandomState(SEED + 3)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    src = t(0.3 * rs.randn(GRAIN_SOURCE))
    cases = [(f"G=1, L={GRAIN_SOURCE}, B={B}, ages", (src, t([1234.5]), t([1.25])),
              dict(B=B, age0=t([700], torch.int32)))]
    for b in (100, 33):
        for p0, step, age0 in (([np.nan, np.inf, 2.5], [8.7, -8.7, np.inf], [2**31 - 50, 2**30, 0]),
                               ([-np.inf, 0.5, 3.0], [-np.inf, -8.7, 8.7], [-5, 3, 2**31 - 1])):
            cases.append((f"G=3, L=4, B={b}, steps {step}, starts {p0}", (
                t(rs.randn(4)), t(p0), t(step)), dict(B=b, age0=t(age0, torch.int32))))
    for L in (1, 3):
        cases.append((f"G=37, L={L}, B=99, age = n", (
            t(rs.randn(L)), t(rs.uniform(-2.0, L + 2.0, 37)), t(rs.uniform(-8.7, 8.7, 37))),
            dict(B=99)))
    return cases


def sampler_tail_cases(dev):
    """``(label, arguments, keywords)`` of sampler_read_linear past the main
    path, on a 32,768-frame arena: one voice; 130 voices of 512, 100 and 33
    samples (an odd B stores a frame at a time), slots of 1-3,000 frames
    ending on a fraction (the hold plateau; one frame and half of one too),
    increments of +-[0.25, 3], [4, 6), 6, inf and NaN, voices started up to
    4,000 samples back and after the block's end (a negative age, read
    forward by a negative increment), every tenth slot's base at the
    arena's end (the index clamp); then the block's start 50 samples short
    of 2^31, so that the ages wrap."""
    import torch

    rs = np.random.RandomState(SEED + 4)
    F = ARENA_FRAMES

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    arena = t(0.3 * rs.randn(F, 2))
    cases = [(f"V=1, F={F}, B={B}", (arena, t([F // 3], torch.int32), t([5000.25]),
                                      t([-700], torch.int32), t([1.5]), 3 * B), dict(B=B))]
    V = 130
    for b, block_start in ((B, 3 * B), (100, 3 * B), (33, 3 * B), (B, 2**31 - 50)):
        base = rs.randint(0, F, V)
        base[::10] = F - rs.randint(1, 40, len(base[::10]))
        frames = rs.randint(2, 3000, V) + rs.choice([0.0, 0.25, 0.5, 0.75], V)
        frames[1], frames[2] = 1.0, 0.5
        start = block_start + rs.randint(-4000, b + 200, V)
        inc = rs.uniform(0.25, 3.0, V) * rs.choice([-1.0, 1.0], V)
        inc[3::7] = rs.uniform(4.0, 6.0, len(inc[3::7]))
        inc[::7] = 6.0
        inc[5], inc[6] = np.inf, np.nan
        cases.append((f"V={V}, F={F}, B={b}, block start {block_start}, tails", (
            arena, t(base, torch.int32), t(frames), t(start.astype(np.int64).astype(np.int32), torch.int32),
            t(inc), block_start), dict(B=b)))
    return cases


def unaligned(args):
    """The same tensors, each a contiguous view 4 bytes past a 16-byte
    boundary (``None`` stays)."""
    import torch

    return tuple(None if a is None else torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape)
                 for a in args)


def env_rows(rs, t, rows, b):
    """env_follow_bank ``(arguments, keywords)``: a rectified signal, freezes
    (p = 0.1, and on the first and the last sample of every 7th row), a
    random carried envelope, the feedback waveshaper's coefficients at
    ``SR``."""
    import torch

    from libgooey_tpu_torch.effects import feedback_waveshaper as fbws

    att, rel = fbws.env_coeffs(SR)
    freeze = rs.rand(rows, b) < 0.1
    freeze[::7, 0] = freeze[::7, -1] = True
    return ((t(np.abs(0.5 * rs.randn(rows, b))), t(freeze, torch.bool),
             t(np.abs(0.1 * rs.randn(rows)))), dict(att=att, rel=rel))


def plate_args(dev, rs, b, sr=SR, to_floor=False):
    """plate_block ``(arguments, keywords)`` on filled histories at ``sr``:
    the size knob moving 1.0 -> 0.0 in the block (the modulated lags
    sweep); with ``to_floor`` the lags then fall to the clamp's floor of
    1.0 over the block (the kernel walks such chunks serially)."""
    import torch

    from libgooey_tpu_torch.core.smoother import smoothing_coeff
    from libgooey_tpu_torch.effects import reverb_plate

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(torch.float32)

    srs = sr / reverb_plate.DATTORRO_SR
    DIN, DMOD = reverb_plate.in_hist_len(sr), reverb_plate.mod_hist_len(sr)
    q = np.float32(1.0 - smoothing_coeff(sr))
    size = reverb_plate.size_to_scale(torch.as_tensor(
        q ** np.arange(1, b + 1, dtype=np.float32))).numpy()
    lfo = np.sin(2 * np.pi * (np.arange(1, b + 1) * np.array([[0.5], [0.71]]) / sr
                              + [[0.2], [0.7]]))
    mod_off = np.array([[672.0], [908.0]]) * srs * size + lfo * 16.0 * srs
    if to_floor:
        mod_off = mod_off * np.linspace(1.0, -0.2, b)
    mod_off = np.clip(mod_off, 1.0, DMOD - 2.0)
    rows = [rs.uniform(-0.5, 0.5, b) for _ in range(6)]
    rows[3] = 0.95 * np.linspace(0.1, 0.6, b)
    return ((*map(t, rows), t(mod_off), t(0.2 * rs.randn(4, DIN)), t(0.2 * rs.randn(2, DMOD)),
             t([0.1, -0.05, 0.02])), dict(sample_rate=sr))


def plate_label(args, kw, note="") -> str:
    (b,), (_, DIN), (_, DMOD) = args[0].shape, args[7].shape, args[8].shape
    sr = "" if kw["sample_rate"] == SR else f", {kw['sample_rate']:g} Hz"
    return f"[{b}], in_hist [4, {DIN}], mod_hist [2, {DMOD}]{sr}{note}"


#: plate_block's tails (samples, rate, lags falling to 1): a block size past
#: whole chunks, one of a chunk's fraction, the serial chunks, 22,050 Hz (a
#: chunk of 79) and 96,000 Hz (256, the longest histories)
PLATE_TAILS = ((100, SR, False), (33, SR, False), (B, SR, True), (256, 22050.0, False),
               (B, 96000.0, False))


def plate_cases(dev):
    """``(label, arguments, keywords)`` of plate_block at ``PLATE_TAILS``."""
    rs = np.random.RandomState(SEED + 2)
    cases = []
    for b, sr, to_floor in PLATE_TAILS:
        args, kw = plate_args(dev, rs, b, sr, to_floor)
        note = ", modulated lags falling to 1 (serial chunks)" if to_floor else ""
        cases.append((plate_label(args, kw, note), args, kw))
    return cases


def bus_cases(dev, rs, b):
    """The bus kernels' cases on one stereo block [2, b] (the plate's on its
    mono [b]), inputs drawn from ``rs`` in a fixed order, and the runs of
    ``bus_chain``: ``(cases, runs)``, ``runs`` ``{label: (x, phases)}``:
    the kit's seven phases, the first four, the product chain's ten, then
    the tails (one phase; twelve; nine with two delays and the spring last)."""
    import torch

    from libgooey_tpu_torch.core.smoother import smoothing_coeff
    from libgooey_tpu_torch.effects import compressor, delay
    from libgooey_tpu_torch.effects import feedback_waveshaper as fbws
    from libgooey_tpu_torch.effects import saturation
    from libgooey_tpu_torch.ops import bank_kernels as bk
    from libgooey_tpu_torch.ops import bus_kernels as bus
    from libgooey_tpu_torch.ops import ringbuf

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    cases = []
    bus_shape = f"[2, {b}]"
    coeff = smoothing_coeff(SR, 30.0)
    xb = t(rs.uniform(-0.9, 0.9, (2, b)))
    # 9. saturation: drive and warmth moving; the left mix falls under the
    #    bypass gate mid-block, the right one fades from 0.6
    sat = saturation.init_state(SR, device=dev)
    cases.append(("saturation_block", bus_shape, (
        xb, t([[0.6, 0.5, 1.2e-4], [0.6, 0.5, 0.6]]), t([[0.2, 0.9, 0.0]] * 2),
        bus.pack_saturation(sat.ovs, sat.dc)), dict(coeff=coeff), 1))
    # 10. lowpass: cutoff sweeping 2-12 kHz at resonance 0.8 (the effect's maps)
    cut = np.minimum(np.linspace(2000.0, 12000.0, b), 0.4 * SR)[None, :].repeat(2, 0)
    ratio = np.minimum(cut / 5000.0, 1.0)
    cases.append(("lowpass_block", bus_shape, (
        xb, t(np.clip(1.0 - np.exp(-2.0 * np.pi * cut / SR), 0.0, 0.9)),
        t(0.8 * (1.0 - ratio * ratio * 0.7) * 3.5), t(0.1 * rs.randn(2, 2))), {}, 1))
    # 11. tilt: the knob sweeping towards 0.75 at rising resonance, the left
    #     channel across the center
    cases.append(("tilt_block", bus_shape, (
        xb, t([[0.45, 0.3], [0.25, 0.3]]), t([[0.75, 0.6]] * 2), t(0.05 * rs.randn(2, 2))),
        dict(coeff=coeff, sample_rate=SR), 1))
    # 12. delay: a 0.015 s tap gathered from a filled ring, feedback, mix and
    #     cutoff moving; both ping-pong settings
    ring = ringbuf.Ring(buf=t(rs.uniform(-0.5, 0.5, (2, delay.ring_length(SR)))),
                        pos=torch.tensor(98765, device=dev))
    tap = ringbuf.read_frac(ring, t(np.full((2, b), 0.015 * SR)))
    dl = (xb, tap, t([[0.6, 0.8, 4000.0]] * 2), t([[0.5, 0.4, 6000.0]] * 2),
          t(0.1 * rs.randn(2, 2)))
    for pingpong in (False, True):
        cases.append(("delay_block", f"{bus_shape}, pingpong={pingpong}", dl,
                      dict(coeff=coeff, sample_rate=SR, pingpong=pingpong), 2))
    first_four = [bus.Phase(name, args[1:], kw) for name, _, args, kw, _ in cases[-5:-1]]
    # 13. the compressor's detector on loud bursts: a 1 ms attack, a 100 ms
    #     release, a bypass span that holds the envelope
    bursts = t((rs.uniform(-1.0, 1.0, (2, b)) * (np.sin(np.arange(b) * 2 * np.pi / 97.0) > 0.3)
                * 1.5))
    byp = np.zeros((2, b))
    byp[:, 200:260] = 1.0
    env_args = (bursts, t(np.full((2, b), np.exp(-1.0 / (1.0 * 0.001 * SR)))),
                t(np.full((2, b), np.exp(-1.0 / (100.0 * 0.001 * SR)))), t(byp), t([0.3, 0.0]))
    cases.append(("env_follower_block", bus_shape, env_args, {}, 1))
    # 14. its gain stage on that envelope: threshold -30 dB, ratio 8, the
    #     smoothed gain falling from 1 through 0.99 (the tube colour engages)
    env = bus.env_follower_block_plain(*env_args)[0]
    comp = compressor.init_state(SR, device=dev)
    comp_args = (bursts, env, t(np.full((2, b), -30.0)), t(np.full((2, b), 8.0)),
                 t(np.ones((2, b))), bus.pack_compressor(comp.ovs, comp.dc, comp.gain))
    cases.append(("compressor_block", bus_shape, comp_args, {}, 1))
    # 15. the spring on a filled history, decay 0.3 -> 0.9 and damping
    #     0.6 -> 0.2 across the block
    spring_args, spring_kw = spring_block_args(dev, rs, xb)
    cases.append(("spring_block", spring_label(spring_args, spring_kw), spring_args, spring_kw,
                  1))
    # 16. the plate's sub-block path on filled histories, the size knob
    #     moving 1.0 -> 0.0 in the block (the modulated lags sweep)
    plate, plate_kw = plate_args(dev, rs, b)
    cases.append(("plate_block", plate_label(plate, plate_kw), plate, plate_kw, 4))
    # the kit's seven bus phases as one run, each on the signal the one
    #     before it left (the delay without ping-pong, as the engine runs
    #     it; the gain stage on the detector's envelope), then the first
    #     four alone (full_kit_4096_bus4)
    seven = first_four + [
        bus.Phase("env_follower_block", env_args[1:], {}),
        bus.Phase("compressor_block", (None,) + comp_args[2:], {}),
        bus.Phase("spring_block", spring_args[1:], spring_kw)]
    # 18. the chain's waveshaper engaged, drive 4 and 6, mixes 0.5 and 0.8
    ws_args = (xb, t([[4.0, 0.5], [6.0, 0.8]]), t(0.05 * rs.randn(bk.FBWS_S_IN, 2)))
    cases.append(("waveshaper_block", bus_shape, ws_args, {}, 1))
    # 19. the feedback waveshaper engaged (feedback 0) on its detector's
    #     envelope: drive 4 at 2 kHz full wet, drive 8 at 500 Hz mix 0.7
    att, rel = fbws.env_coeffs(SR)
    fenv_args = (bursts, t(np.full((2, b), att)), t(np.full((2, b), rel)), t(np.zeros((2, b))),
                 t([0.2, 0.0]))
    fb_env = bus.env_follower_block_plain(*fenv_args)[0]
    fbc = [float(np.clip(1.0 - np.exp(-2.0 * np.pi * f / SR), 0.0, 0.9)) for f in (2000.0, 500.0)]
    fb_args = (bursts, fb_env, t([[4.0, 0.0, fbc[0], 1.0], [8.0, 0.0, fbc[1], 0.7]]),
               t(0.05 * rs.randn(bus.COMP_S_IN, 2)))
    cases.append(("fbws_fast_block", bus_shape, fb_args, {}, 1))
    # 20. the product chain's first eight entries as one run: ten phases
    #     (mixer/chain.py; the compressor and the feedback waveshaper two each)
    sat, lp, tilt, dly = first_four
    ten = [lp, dly, sat, bus.Phase("env_follower_block", env_args[1:], {}),
           bus.Phase("compressor_block", (None,) + comp_args[2:], {}), tilt,
           bus.Phase("spring_block", spring_args[1:], spring_kw),
           bus.Phase("waveshaper_block", ws_args[1:], {}),
           bus.Phase("env_follower_block", fenv_args[1:], {}),
           bus.Phase("fbws_fast_block", (None,) + fb_args[2:], {})]
    # tails: one phase; twelve (the ten, then a ping-pong delay after the
    #     spring and a second saturation: two delays); nine with two delays
    #     and the spring last
    dly_pp = bus.Phase("delay_block", dly.args, dict(dly.kwargs, pingpong=True))
    det, comp = ten[3:5]
    runs = {
        f"{' -> '.join(FX_ORDER_FULL[:-1])} (7 phases)": seven,
        " -> ".join(FX_ORDER) + " (4 phases)": first_four,
        "the product chain's run (10 phases)": ten,
        "saturation alone (1 phase)": [sat],
        "the product's ten, a ping-pong delay, saturation (12 phases)": ten + [dly_pp, sat],
        "two delays, the spring last (9 phases)": [lp, dly, sat, det, comp, dly_pp, tilt,
                                                   ten[7], ten[6]],
    }
    return cases, {f"{bus_shape}, {label}": (xb, phases) for label, phases in runs.items()}


def spring_block_args(dev, rs, x, sr=SR):
    """spring_block ``(arguments, keywords)`` on the stereo block ``x`` at
    ``sr``: a filled history drawn from ``rs``, decay 0.3 -> 0.9 and damping
    0.6 -> 0.2 across the block (reverb_spring.py's rows), a carried damping
    state and feedback sample, the mix moving 0.2 -> 0.5 (left) and 0.3 ->
    0.45 (right)."""
    import torch

    from libgooey_tpu_torch.effects import reverb_spring
    from libgooey_tpu_torch.ops import bus_kernels as bus

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(torch.float32)

    b = x.shape[1]
    dl, dr = reverb_spring.delay_lengths(sr)
    D = max(dl + dr)
    damping = np.linspace(0.6, 0.2, b)[None].repeat(2, 0)
    fb_gain = 0.95 * np.linspace(0.3, 0.9, b)[None].repeat(2, 0) ** 0.4
    fbgp = np.concatenate([np.zeros((2, 1)), fb_gain[:, :-1]], axis=-1)
    A = damping + (1.0 - damping) * np.prod(reverb_spring.GAINS) * fbgp
    A[:, 0] = damping[:, 0]
    mix = np.linspace([0.2, 0.3], [0.5, 0.45], b).T
    return ((x, t(A), t(1.0 - damping), t(fbgp), t(0.3 * rs.randn(2 * bus.SPRING_APS, D)),
             t([0.05, -0.02]), t(mix), t([0.01, -0.03])),
            dict(delays=dl + dr, gains=reverb_spring.GAINS))


def spring_label(args, kw, note="") -> str:
    (_, b), (_, D) = args[0].shape, args[4].shape
    dl = kw["delays"]
    return f"[2, {b}], hist [12, {D}], shortest lag {min(dl)}{note}"


#: the spring's rates past the main path's (D = 398 and 1,734; the shortest
#: lag 63 and 276)
SPRING_RATES = (22050.0, 96000.0)


#: the lone spring's shortest lag below any audio rate's: parts of 3 samples
SPRING_SHORT_LAG = 3


def spring_cases(dev, seed=SEED):
    """``(label, arguments, keywords)`` of spring_block at ``[2, B]`` at
    ``SPRING_RATES``; at ``SR`` with every input 4 bytes past a 16-byte
    boundary (the history copied in 4 bytes at a time), and with the
    shortest lag (127) cut to ``SPRING_SHORT_LAG``."""
    import torch

    rs = np.random.RandomState(seed + 3)

    def block(sr=SR):
        x = torch.as_tensor(rs.uniform(-0.9, 0.9, (2, B)), device=dev).to(torch.float32)
        return spring_block_args(dev, rs, x, sr)

    cases = []
    for sr in SPRING_RATES:
        args, kw = block(sr)
        cases.append((spring_label(args, kw, f", {sr:g} Hz"), args, kw))
    args, kw = block()
    cases.append((spring_label(args, kw, ", unaligned"), unaligned(args), kw))
    args, kw = block()
    delays = list(kw["delays"])
    delays[delays.index(min(delays))] = SPRING_SHORT_LAG
    kw = dict(kw, delays=tuple(delays))
    cases.append((spring_label(args, kw, f", parts of {SPRING_SHORT_LAG} samples"), args, kw))
    return cases


#: the lone bus kernels' edge cases' blocks: the main path's, then a tail
#: chunk of 4 samples and one of 1 (32-sample chunks; the detector's 64-sample
#: chunks: 36 and 33 samples)
LONE_BLOCKS = (B,) + TAIL_BLOCKS


def lone_edges(b):
    """The samples of a ``[2, b]`` block at which the lone 4x kernels' edge
    cases cross their bypass gate: ``(left, right)``, each inside a
    32-sample chunk (13 and 7 past a chunk's start)."""
    return 32 * (b // 64) + 13, 32 * (b // 128) + 7


def env_edges(b):
    """The bypass span ``[left, right)`` of the detector's edge case at
    ``[2, b]``: both ends inside its 64-sample chunks, across a chunk's end
    where the block has two."""
    left = 64 * (b // 256) + (37 if b > 64 else b // 6)
    return left, min(b - 3, left + 40 + 64 * (b // 256))


def lone_edge_cases(dev, b, seed=SEED):
    """The lone bus kernels' cases at ``[2, b]`` with their edges inside
    chunks, on carried states drawn from ``seed``: ``[(name, label, args,
    kwargs)]``.  ``saturation_block``'s and ``compressor_block``'s at
    :func:`lone_edges`, on carried 4x and DC states: the saturation's left
    mix falls under the bypass gate at the left edge and its right one
    rises out of it at the right edge (the DC blocker freezes and resumes
    mid-chunk), drive and warmth moving; the compressor over its knee on
    loud bursts, its left mix falling to 0 at the left edge and its right
    one rising to 1 at the right edge, so that the smoothed gain crosses
    0.99 mid-chunk (the tube colour engages).  ``env_follower_block`` on
    those bursts from a carried envelope, attack 0.5-2 ms and release 50-150
    ms moving, bypassed over :func:`env_edges` (the right channel's span 9
    samples later); ``spring_block`` on a filled history
    (:func:`spring_block_args`); ``waveshaper_block`` and
    ``fbws_fast_block`` from :func:`waveshaper_edge_cases`."""
    import torch

    from libgooey_tpu_torch.core.smoother import smoothing_coeff
    from libgooey_tpu_torch.ops import bank_kernels as bk
    from libgooey_tpu_torch.ops import bus_kernels as bus

    rs = np.random.RandomState(seed + b)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    coeff = smoothing_coeff(SR, 30.0)
    logq = np.log(1.0 - coeff)
    left, right = lone_edges(b)
    # the mix trajectories: tgt + snap((cur - tgt) q^(n+1)) crosses 1e-4 at
    # n = left falling from cur to 0, and at n = right rising from 0 to tgt
    fall = 1e-4 * np.exp(-logq * (left + 0.5))
    rise = 1e-4 / (1.0 - np.exp(logq * (right + 0.5)))
    x = t(rs.uniform(-0.9, 0.9, (2, b)))
    state = 0.05 * rs.randn(bk.FBWS_S_IN, 2)
    sat = (x, t([[0.6, 0.5, fall], [0.3, 0.2, 0.0]]), t([[0.2, 0.9, 0.0], [0.7, 0.6, rise]]),
           t(state))
    bursts = (rs.uniform(-1.0, 1.0, (2, b)) * (np.sin(np.arange(b) * 2 * np.pi / 97.0) > 0.3)
              * 1.5)
    env = bus.env_follower_block_plain(
        t(bursts), t(np.full((2, b), np.exp(-1.0 / (1.0 * 0.001 * SR)))),
        t(np.full((2, b), np.exp(-1.0 / (100.0 * 0.001 * SR)))), t(np.zeros((2, b))),
        t([0.0, 0.0]))[0]
    mix = np.ones((2, b))
    mix[0, left:] = 0.0
    mix[1, :right] = 0.0
    comp = (t(bursts), env, t(np.full((2, b), -30.0)), t(np.full((2, b), 8.0)), t(mix),
            t(np.concatenate([state, np.ones((1, 2))])))
    shape = f"[2, {b}], the bypass gate crossed at samples {left} and {right}"
    lo, hi = env_edges(b)
    byp = np.zeros((2, b))
    byp[0, lo:hi] = 1.0
    byp[1, lo + 9:hi] = 1.0
    ms = np.linspace([0.5, 50.0], [2.0, 150.0], b).T[:, None, :].repeat(2, 1)
    env_args = (t(bursts), *(t(np.exp(-1.0 / (m * 0.001 * SR))) for m in ms), t(byp),
                t([0.3, 0.05]))
    spring, spring_kw = spring_block_args(dev, rs, x)
    return [("saturation_block", shape, sat, dict(coeff=coeff)),
            ("compressor_block", shape + ", the gain through 0.99", comp, {}),
            ("env_follower_block", f"[2, {b}], bypassed over samples {lo}-{hi - 1}", env_args,
             {}),
            ("spring_block", spring_label(spring, spring_kw), spring, spring_kw)] + [
                (name, label, args, {})
                for name, label, args in waveshaper_edge_cases(t, b, x, bursts, state)] + (
                    walk_edge_cases(t, b, rs, coeff))


def walk_edge_cases(t, b, rs, coeff):
    """``[(name, label, args, kwargs)]`` of ``lowpass_block``, ``delay_block``
    and ``tilt_block`` at ``[2, b]`` on carried states drawn from ``rs`` (``t``:
    numpy to a device tensor), their edges at :func:`lone_edges` (inside the
    lone walk's chunks of 32, 64 and 128 samples).  The lowpass: a burst
    that falls silent at the first edge, the left channel's feedback rising
    0.4 -> 1.6 across 1 (the ``min`` clip) at g 0.5, the right one's at 0
    at g 0.9 (the effect's clip), so that both stages flush under 1e-15
    inside a chunk; then +inf (left) and -inf (right) at the edges, feedback
    1.5 and 0, which reset the filter a sample later.  The delay, with and
    without ping-pong: each channel's feedback and mix settling (the 1e-4
    snap) at the edges, the left cutoff sweeping 3-8 kHz, the right one
    settling at 20 Hz (inside a chunk: at 20 Hz its float32 steps are
    ~1e-6); the taps (and the right channel's x) at 1e-16-2e-15
    up to the first edge, so that the writes fall under the 1e-15 flush; a
    NaN tap (left) at the second edge, after which the left output falls
    back to x and its writes (the right ones' under ping-pong) to 0; then
    with the tap a view 4 bytes past a 16-byte boundary (4-byte copies).
    The tilt (:func:`tilt_edge_cases`): the knob crossing the center inside
    a chunk, a passthrough span inside the block, Q at its top, +-inf in x
    and an unaligned x."""
    left, right = lone_edges(b)
    first, second = min(left, right), max(left, right)
    shape = f"[2, {b}]"
    x = rs.uniform(-0.9, 0.9, (2, b))
    burst = x.copy()
    burst[:, first:] = 0.0
    fb = np.stack([np.minimum(np.linspace(0.4, 1.6 * b / first, b), 1.6), np.zeros(b)])
    g = np.stack([np.full(b, 0.5), np.full(b, 0.9)])
    x_inf = x.copy()
    x_inf[0, left], x_inf[1, right] = np.inf, -np.inf
    cases = [
        ("lowpass_block", f"{shape}, a burst silent from sample {first}, feedback across 1 "
         "(left) and 0 at g 0.9 (right): both stages flushed",
         (t(burst), t(g), t(fb), t(0.1 * rs.randn(2, 2))), {}),
        ("lowpass_block", f"{shape}, inf at sample {left} (left), -inf at {right} (right)",
         (t(x_inf), t(g), t([[1.5] * b, [0.0] * b]), t(0.1 * rs.randn(2, 2))), {}),
    ]
    logq = np.log(1.0 - coeff)
    snap = lambda n: 1e-4 * np.exp(-logq * (n + 0.5))   # |cur - tgt| snapping at n
    tgt = np.asarray([[0.6, 0.5, 8000.0], [0.45, 0.7, 20.0]], np.float32)
    cur = tgt + np.asarray([[snap(left), -snap(right), -5000.0],
                            [-snap(right), snap(left), snap(left)]])
    xd = x.copy()
    xd[1, :first] = 2e-15 * rs.uniform(-1.0, 1.0, first)
    tap = 0.5 * rs.uniform(-1.0, 1.0, (2, b))
    tap[:, :first] = 1e-16 * rs.uniform(-1.0, 1.0, (2, first))
    tap[0, second] = np.nan
    z = [[1e-17, -2e-17], [2e-17, 1e-17]]
    args = (t(xd), t(tap), t(cur), t(tgt), t(z))
    label = (f"{shape}, feedback and mix settling at samples {left} and {right}, the right "
             f"cutoff at 20 Hz, writes flushed before {first}, a NaN tap (left) at {second}")
    for pingpong in (False, True):
        kw = dict(coeff=coeff, sample_rate=SR, pingpong=pingpong)
        cases.append(("delay_block", f"{label}, pingpong={pingpong}", args, kw))
    cases.append(("delay_block", f"{label}, the tap unaligned",
                  args[:1] + unaligned(args[1:2]) + args[2:], dict(kw, pingpong=False)))
    return cases + tilt_edge_cases(t, b, rs, coeff)


def tilt_edge_cases(t, b, rs, coeff):
    """``[(name, label, args, kwargs)]`` of ``tilt_block`` at ``[2, b]`` on
    carried SVF states drawn from ``rs``, its edges at :func:`lone_edges`
    (inside the lone walk's chunks): the left knob rising through the
    center (0.5: the low-pass hands over to the high-pass, its cutoff
    jumping from ~20 kHz to 20 Hz, inside a passthrough span of a few
    samples) at the first edge and the right one falling through it at the
    second, the right channel's resonance at 1 (Q 8.5, the top); then both
    knobs crawling through the center (targets 0.52 and 0.48), so that the
    passthrough (mix < 0.001) holds for ~60 samples around the edges,
    resonance 1 on both; +inf (left) and -inf (right) in x at the edges,
    after which the SVF's state is not finite and the outputs flush to 0;
    then the first case with x a view 4 bytes past a 16-byte boundary
    (4-byte copies)."""
    left, right = lone_edges(b)
    logq = np.log(1.0 - coeff)
    # the knob's trajectory tgt + (cur - tgt) q^(n+1) crosses 0.5 at sample n
    through = lambda tgt, n: tgt + (0.5 - tgt) * np.exp(-logq * (n + 0.5))
    x = rs.uniform(-0.9, 0.9, (2, b))
    ic = 0.05 * rs.randn(2, 2)
    shape = f"[2, {b}]"
    kw = dict(coeff=coeff, sample_rate=SR)
    cross = (t(x), t([[through(0.9, left), 0.3], [through(0.1, right), 1.0]]),
             t([[0.9, 0.6], [0.1, 1.0]]), t(ic))
    x_inf = x.copy()
    x_inf[0, left], x_inf[1, right] = np.inf, -np.inf
    return [
        ("tilt_block", f"{shape}, the knob through the center at samples {left} (rising, left) "
         f"and {right} (falling, right, res 1)", cross, kw),
        ("tilt_block", f"{shape}, passthrough around samples {left} (left) and {right} "
         "(right), res 1", (t(x), t([[through(0.52, left), 1.0], [through(0.48, right), 1.0]]),
                            t([[0.52, 1.0], [0.48, 1.0]]), t(ic)), kw),
        ("tilt_block", f"{shape}, inf at sample {left} (left), -inf at {right} (right)",
         (t(x_inf), t([[0.3, 0.5], [0.8, 0.9]]), t([[0.35, 0.5], [0.75, 0.9]]), t(ic)), kw),
        ("tilt_block", f"{shape}, the knob through the center, x unaligned",
         unaligned(cross[:1]) + cross[1:], kw),
    ]


#: the feedback filter's coefficients of the feedback waveshaper's edge cases
#: (2 kHz and 500 Hz at 44.1 kHz, as the chain maps its cutoff)
FBWS_EDGE_FBC = tuple(float(np.clip(1.0 - np.exp(-2.0 * np.pi * f / SR), 0.0, 0.9))
                      for f in (2000.0, 500.0))


def waveshaper_edge_cases(t, b, x, bursts, state):
    """``[(name, label, args)]`` of ``waveshaper_block`` and
    ``fbws_fast_block`` at ``[2, b]`` (``x``, ``bursts``: its inputs; ``state``:
    a carried 4x and DC state; ``t``: numpy to a device tensor): each with one
    channel bypassed by its mix at 0 and the other by its drive at 1.0; both
    channels engaged; the waveshaper with an inf sample (left) and a -inf
    (right) at :func:`lone_edges` (the finite guard); the feedback
    waveshaper on an envelope dipping under the makeup gain's 0.05 floor
    inside chunks, with feedback 0.5 on its right channel (the makeup's
    high end), and at drives 150 and 100 (the drive_norm clip); its bypassed
    left channel carries a feedback filter of 1e-16 (the flush)."""
    left, right = lone_edges(b)
    xn = x.cpu().numpy()
    x_inf = xn.copy()
    x_inf[0, left], x_inf[1, right] = np.inf, -np.inf
    n = np.arange(b)
    env = np.stack([0.3 + 0.3 * np.sin(2.0 * np.pi * n / 37.0),
                    0.3 + 0.3 * np.sin(2.0 * np.pi * n / 29.0 + 1.0)])
    fb_state = lambda filt: t(np.concatenate([state, np.asarray([filt], np.float32)]))
    fbc0, fbc1 = FBWS_EDGE_FBC
    shape = f"[2, {b}]"
    return [
        ("waveshaper_block", f"{shape}, bypassed by mix 0 (left) and drive 1.0 (right)",
         (x, t([[4.0, 0.0], [1.0, 0.5]]), t(state))),
        ("waveshaper_block", f"{shape}, drives 4 and 150 engaged on a carried state",
         (x, t([[4.0, 0.5], [150.0, 0.8]]), t(state))),
        ("waveshaper_block", f"{shape}, inf at sample {left} (left), -inf at {right} (right)",
         (t(x_inf), t([[4.0, 1.0], [6.0, 0.8]]), t(state))),
        ("fbws_fast_block", f"{shape}, bypassed by mix 0 (left, filter 1e-16) and drive 1.0 "
         "(right)", (t(bursts), t(env), t([[4.0, 0.0, fbc0, 0.0], [1.0, 0.0, fbc1, 0.7]]),
                     fb_state([1e-16, 0.02]))),
        ("fbws_fast_block", f"{shape}, engaged, the envelope under 0.05 inside chunks, "
         "feedback 0.5 (right)", (t(bursts), t(env), t([[4.0, 0.0, fbc0, 1.0],
                                                        [8.0, 0.5, fbc1, 0.7]]),
                                  fb_state([0.01, -0.02]))),
        ("fbws_fast_block", f"{shape}, drives 150 and 100, feedback 0.5 and 0.98",
         (t(bursts), t(env), t([[150.0, 0.5, fbc0, 0.6], [100.0, 0.98, fbc1, 1.0]]),
          fb_state([0.01, -0.02]))),
    ]


#: the snare's Chamberlin at full cutoff and resonance rings up to inf (the
#: reference's math), so random snare targets stay under these
SNARE_CLAMPS = (("filter_cutoff", 0.5), ("filter_resonance", 0.3))


def kit_label(kit, b) -> str:
    return ", ".join(f"{k} {v}" for k, v in kit.items()) + f" voices, B={b}"


def kit_phases(dev, kit=None, b=None):
    """The kit kernels' phases for ``kit`` ``{family: voices}`` at block
    size ``b`` (the product kit's shapes by default): random parameter
    targets with the smoothers moving (the snare's Chamberlin kept off its
    unstable corner), after 3 blocks of staggered triggers through the kit
    path; the drive phases from the plain sources' outputs."""
    import torch

    kit, b = kit or PRODUCT_KIT, b or B

    from libgooey_tpu_torch.core.smoother import SmootherBank, smoothing_coeff
    from libgooey_tpu_torch.engine import engine
    from libgooey_tpu_torch.ops import voice

    rs = np.random.RandomState(SEED + 1)
    state = {}
    for kind, nv in kit.items():
        mod = engine.FAMILIES[kind]
        if kind == "tom2":
            state[kind] = mod.init_state(nv, device=dev)
            continue
        tg = rs.uniform(0, 1, (nv, mod.NUM_PARAMS)).astype(np.float32)
        cur = np.clip(tg + 0.2 * rs.randn(*tg.shape), 0, 1).astype(np.float32)
        if kind == "snare":
            for p, hi in SNARE_CLAMPS:
                tg[:, mod.PARAM_INDEX[p]] = np.minimum(tg[:, mod.PARAM_INDEX[p]], hi)
                cur[:, mod.PARAM_INDEX[p]] = np.minimum(cur[:, mod.PARAM_INDEX[p]], hi)
        st = mod.init_state(nv, targets=tg, device=dev)
        state[kind] = st._replace(params=SmootherBank(current=torch.as_tensor(cur, device=dev),
                                                      target=st.params.target))
    coeff = smoothing_coeff(SR)

    def events():
        return ({k: np.where(rs.rand(v) < 0.5, rs.randint(0, b, v), b).astype(np.int32)
                 for k, v in kit.items()},
                {k: rs.uniform(0.3, 1.0, v).astype(np.float32) for k, v in kit.items()})

    for i in range(3):
        offs, vels = events()
        res = voice.kit_render_fused(state, offs, vels, np.int32(i * b), kinds=tuple(kit),
                                     sample_rate=SR, block_size=b, smooth_coeff=coeff,
                                     kick_max_harmonics=64, snare_max_harmonics=64)
        state = {k: r[0] for k, r in res.items()}
    offs, vels = events()
    blk = voice._Block(dev, np.int32(3 * b), b, SR, coeff)
    off = {k: blk.ints(offs[k]) for k in kit}
    vel = {k: blk.floats(vels[k]) for k in kit}
    sources = [voice._kick_phase_a(state["kick"], off["kick"], vel["kick"], blk, 64),
               voice._snare_phase_a(state["snare"], off["snare"], vel["snare"], blk, 64),
               voice._hihat2_phase_a(state["hihat2"], off["hihat2"], vel["hihat2"], blk),
               voice._tom2_phase_a(state["tom2"], off["tom2"], blk, True),
               voice._bass_phase_a(state["bass"], off["bass"], vel["bass"], None, blk)]
    from libgooey_tpu_torch.ops import voice_kernels

    plain = voice_kernels.kit_sources_plain(sources)
    drive = [voice._kick_phase_m(state["kick"], plain[0], blk)[0],
             voice._snare_phase_m(state["snare"], off["snare"], vel["snare"], plain[1], blk)[0]]
    return sources, drive


def nbytes(obj) -> int:
    """Bytes of every tensor in ``obj``, through tuples and lists (a
    ``bus_chain`` phase is a tuple of its name, arguments and keywords)."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(nbytes(a) for a in obj)
    return 0


def triangle_ops(freq, sample_rate, max_harmonics) -> int:
    """The operations that the additive triangle's function needs on this
    ``freq`` ([V, B]): every sample's ``TRI_OPS_SAMPLE``, ``TRI_OPS_TERM``
    for each of its active terms (h <= floor(nyquist / max(f, 1e-6)) and
    f * h <= nyquist, up to the first inactive one), ``TRI_OPS_TAPERED`` more
    for each active term at or past the taper threshold, and one add where
    its walk stops at an inactive term."""
    import torch

    from libgooey_tpu_torch.ops import bank_kernels

    nyq = float(np.float32(sample_rate / 2.0))
    taper_from = bank_kernels.taper_threshold(nyq)
    n_terms = (int(max_harmonics) + 1) // 2
    max_h = torch.floor(nyq / torch.clamp(freq, min=1e-6))
    active = torch.ones_like(freq, dtype=torch.bool)
    n_active = torch.zeros_like(freq, dtype=torch.int64)
    n_tapered = torch.zeros_like(freq, dtype=torch.int64)
    for k in range(n_terms):
        h = 2.0 * k + 1.0
        hf = freq * h
        active &= (h <= max_h) & (hf <= nyq)
        n_active += active
        n_tapered += active & (hf >= taper_from)
    return int(TRI_OPS_SAMPLE * freq.numel() + TRI_OPS_TERM * n_active.sum()
               + TRI_OPS_TAPERED * n_tapered.sum() + (n_active < n_terms).sum())


def kit_body_ops(ph) -> int:
    """Operations a row-sample of a kit phase: ``OPS_PER_BODY_SAMPLE``, and
    for the kick's and the snare's bodies with harmonics their triangle's,
    every term counted active and untapered (the frequency it sees is made
    inside the kernel)."""
    ops = OPS_PER_BODY_SAMPLE[ph.name]
    mh = int(ph.kwargs.get("max_harmonics", 0)) if ph.name in ("kick_a", "snare_a") else 0
    if mh > 0:
        ops += TRI_OPS_SAMPLE + TRI_OPS_TERM * ((mh + 1) // 2)
    return ops


def bound_ms(name, args, kw, outs):
    """The least time the card could take: each input read once and each
    output written once at 3.35 TB/s, or the body's operations at 67
    TFLOP/s, whichever is larger (``bus_chain``: the sum of its phases'
    operations; the kit kernels: each phase's body over its rows,
    ``kit_body_ops``; the triangle: what this run's frequencies need,
    ``triangle_ops``; the reads: per output sample, a stereo frame for the
    sampler).
    Returns ``(ms, "bytes"|"operations")``."""
    if name in ("kit_sources", "kit_drive"):   # each phase's rows, B samples
        from libgooey_tpu_torch.ops import voice_kernels

        ops = sum(kit_body_ops(ph) * int(np.prod(voice_kernels._vb_of(ph))) for ph in args[0])
    elif name == "triangle_additive_bank":
        ops = triangle_ops(args[1], kw["sample_rate"], kw["max_harmonics"])
    elif name in ("grain_read_cubic", "sampler_read_linear"):
        ops = int(np.prod(outs[0].shape[:2])) * OPS_PER_ROW_SAMPLE[name]
    else:
        shape = next(a for a in args if a is not None).shape   # affine1's a may be None
        rows, b = (1, shape[0]) if len(shape) == 1 else shape
        ops = rows * b * (sum(OPS_PER_ROW_SAMPLE[ph.name] for ph in args[1])
                          if name == "bus_chain" else OPS_PER_ROW_SAMPLE[name])
    t_bytes = (nbytes(args) + nbytes(list(kw.values())) + nbytes(outs)) / PEAK_BYTES_S
    t_ops = ops / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(a, b) -> float:
    """Worst ``|a-b| / max(1, |b|)``."""
    import torch

    if isinstance(a, (tuple, list)):
        return max((rel_err(x, y) for x, y in zip(a, b)), default=0.0)
    a, b = a.to(torch.float64), b.to(torch.float64)
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


def case_rel_err(a, b) -> float:
    """:func:`rel_err` of an ``EXACT`` kernel's state against its plain
    version's, where a NaN or an infinity on both sides at one place agrees
    (a waveshaper's 4x state after an infinite input sample; the bits are
    held by :func:`same_bits`), as :func:`case_err` for the outputs."""
    import torch

    if isinstance(a, (tuple, list)):
        return max((case_rel_err(x, y) for x, y in zip(a, b)), default=0.0)
    a, b = a.to(torch.float64), b.to(torch.float64)
    d = ((a - b).abs() / b.abs().clamp(min=1.0))
    return float(torch.where((a == b) | (torch.isnan(a) & torch.isnan(b)), 0.0, d).max())


def phase_kernels(dev):
    import torch

    from libgooey_tpu_torch.ops import kernels

    results = {}
    clock_hz = max_sm_clock_hz()
    print(f"chain floors at the maximum SM clock, {clock_hz / 1e6:.0f} MHz, "
          f"{CHAIN_CYCLES_PER_OP} cycles a dependent operation")
    for name, shape, args, kw, n_out in kernel_cases(dev):
        mod = kernels.module_of(name)
        kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
        got = as_tuple(kern(*args, **kw))
        torch.cuda.synchronize()
        # the plain version's one call, timed between CUDA events as it is compared
        want = []
        plain_ms = cuda_ms(lambda: want.append(as_tuple(plain(*args, **kw))), 1)
        want = want[0]
        # NaN and +-inf may agree only where same_bits holds the bits too
        err_of = case_err if name in EXACT else max_err
        rel_of = case_rel_err if name in EXACT else rel_err
        if n_out is None:   # a kit kernel: per phase, its signals then its state
            got, want = got[0], want[0]
            nsig = [mod.SIGNALS[ph.name] for ph in args[0]]
            out_err = err_of([g[:k] for g, k in zip(got, nsig)],
                               [w[:k] for w, k in zip(want, nsig)])
            state_err = rel_of([g[k:] for g, k in zip(got, nsig)],
                               [w[k:] for w, k in zip(want, nsig)])
        else:
            out_err = err_of(got[:n_out], want[:n_out])
            state_err = rel_of(got[n_out:], want[n_out:])
        for _ in range(3):
            kern(*args, **kw)
        wall_ms = cuda_ms(lambda: kern(*args, **kw), 20)
        dev_ms = device_ms(lambda: kern(*args, **kw), 20)
        ev_ms = event_ms(lambda: kern(*args, **kw), 20) if dev_ms is None else None
        ms = ev_ms if dev_ms is None else dev_ms
        bms, bound_by = bound_ms(name, args, kw, got)
        floor = chain_floor_ms(name, args, clock_hz)
        dev_text = (f"{ev_ms * 1e3:.1f} us (CUDA events behind a sleep: the trace held "
                    "nothing)" if dev_ms is None else f"{dev_ms * 1e3:.1f} us")
        floor_text = "" if floor is None else f", chain floor {floor * 1e3:.2f} us"
        print(f"kernel {name}: out err {out_err:.3e} (tol {OUT_TOL:g}), state err "
              f"{state_err:.3e} (tol {STATE_TOL:g}); device {dev_text}/call, wrapper "
              f"{wall_ms * 1e3:.1f} us/call vs plain {plain_ms * 1e3:.1f} us/call, bound "
              f"{bms * 1e3:.4f} us ({bound_by}){floor_text} at {shape}")
        check(np.isfinite(out_err) and out_err <= OUT_TOL, f"{name}: output error {out_err}")
        check(np.isfinite(state_err) and state_err <= STATE_TOL,
              f"{name}: state error {state_err}")
        check(name not in EXACT or same_bits(got, want),
              f"{name} at {shape}: not bit-equal to its plain version")
        if name == "bus_chain":   # one launch gives what the kernels give in turn
            same = max_err(mod.run_phases(*args), got) == 0.0
            print(f"kernel bus_chain ({len(args[1])} phases): equal to its phases' own "
                  f"kernels in turn: {same}")
            check(same, "bus_chain differs from its phases' own kernels")
        err = max(out_err, state_err)
        lib_ms = mix_library_ms(args, got) if (name == "mix_bank"
                                                and shape in (MIX_SETTLED, MIX_PRODUCT)) else None
        if name in results:   # a second case of one kernel: keep the first's times
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
            if shape == MIX_SETTLED:   # the line's yardstick: the kit cells' traffic
                results[name]["library_ms"] = lib_ms
            continue
        # no single PyTorch call computes any of these recurrences, gathers
        # four clamped taps into a Horner form, or sums a bank whose pans move
        # within the block (mix_bank's settled case: mix_library_ms)
        results[name] = dict(name=name, route="cuda", source=mod.SOURCES[name],
                             replaces=mod.REPLACES[name], launches=0, max_abs_err=err,
                             ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bound_by,
                             library_ms=None)
    check_no_floor(dev)
    return results


def mix_library_ms(args, got):
    """The library yardstick of ``mix_bank`` with every pan and gain settled:
    one ``torch.matmul`` of ``W = [g cos, g sin, g]`` ([3, V], from the
    settled pans and gains as the plain version computes them) by the
    voices, float32 with TF32 off; the same three sums up to their rounding
    order.  Prints its device time and its largest difference from the
    kernel's sums; returns the time (ms a call)."""
    import torch

    from libgooey_tpu_torch.ops import bank_kernels as bk

    voices, _pan_cur, pan_tgt, _gain_cur, gain_tgt = args
    torch.backends.cuda.matmul.allow_tf32 = False
    gain = gain_tgt + 0.0
    ang = torch.clamp(pan_tgt + 0.0, 0.0, 1.0) * bk._HALF_PI
    W = torch.stack([gain * torch.cos(ang), gain * torch.sin(ang), gain])
    ref = torch.matmul(W, voices)
    ms = device_ms(lambda: torch.matmul(W, voices), 20)
    diff = max_err(tuple(ref), got)
    print(f"library yardstick torch.matmul(W [3, {voices.shape[0]}], voices): device "
          f"{'not measured' if ms is None else f'{ms * 1e3:.1f} us'}/call, max |diff| from "
          f"the kernel's sums {diff:.3e} (rounding order)")
    return ms


def check_no_floor(dev):
    """``affine1_bank(None, ...)`` against the explicit -3e38 floor row, bit
    for bit, with NaN, +-inf and values below the floor in ``c``, at a tail
    of rows and chunks with 16- and 4-byte copies."""
    import torch

    from libgooey_tpu_torch.ops import bank_kernels as bk

    rs = np.random.RandomState(SEED + 1)
    for rows, b in ((515, 100), (515, 99), (512, B)):
        bb = rs.uniform(-0.99, 0.99, (rows, b)).astype(np.float32)
        c = rs.randn(rows, b).astype(np.float32)
        for value, p in ((np.nan, 0.002), (np.inf, 0.002), (-np.inf, 0.002), (-3.2e38, 0.004),
                         (-3.4e38, 0.002)):
            c[rs.rand(rows, b) < p] = value
        args = [torch.as_tensor(x, device=dev) for x in (bb, c, rs.randn(rows).astype(np.float32))]
        floor = torch.full((rows, b), bk.NO_FLOOR, dtype=torch.float32, device=dev)
        got, want = bk.affine1_bank(None, *args), bk.affine1_bank(floor, *args)
        torch.cuda.synchronize()
        same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want))
        print(f"kernel affine1_bank at V={rows}, B={b}: a=None vs the explicit -3e38 floor, "
              f"bit for bit with NaN, +-inf and below-floor c: {same}")
        check(same, f"affine1_bank(None) differs from the explicit floor at V={rows}, B={b}")


def phase_rng(dev):
    import torch

    from libgooey_tpu_torch.core import rng

    counters = torch.arange(-(2**20), 2**20, dtype=torch.int32)
    counters = torch.cat([counters, counters + 2**30, counters - 2**30])
    cpu = rng.white(counters)
    gpu = rng.white(counters.to(dev)).cpu()
    same = bool(torch.equal(cpu.view(torch.int32), gpu.view(torch.int32)))
    print(f"rng.white: CUDA vs CPU bit-exact over {counters.numel()} counters: {same}")
    check(same, "rng.white differs between CUDA and the CPU")


# --- phases 4 and 5: the kick slice and the kit through render_many ----------


def sequenced_events(rng, nv: int, n_blocks: int):
    """``(offs, vels)`` ``[n_blocks, nv]`` of ``bench_configs.build_full_kit``'s
    traffic for one bank: a 120 BPM 16-step sequencer with every step on,
    each voice lagged by ``rng.randint(0, sr/2)``, velocity
    ``0.5 + 0.5·((v%7)/6)``."""
    from libgooey_tpu_torch.engine.sequencer import Sequencer

    seq = Sequencer(120.0, SR, 16)
    seq.set_pattern([True] * 16)
    seq.start()
    hits = []
    for b in range(n_blocks):
        hits += [b * B + trig.offset for trig in seq.tick_block(B)]
    lags = rng.randint(0, int(SR * 0.5), size=nv)
    offs = np.full((n_blocks, nv), B, np.int32)
    vels = np.zeros((n_blocks, nv), np.float32)
    vel_of = (0.5 + 0.5 * ((np.arange(nv) % 7) / 6.0)).astype(np.float32)
    for h in hits:
        s = h + lags
        ok = s < n_blocks * B
        offs[s[ok] // B, np.nonzero(ok)[0]] = s[ok] % B
        vels[s[ok] // B, np.nonzero(ok)[0]] = vel_of[ok]
    return offs, vels


def mixer_state(nv: int, dev) -> dict:
    """The bench kit's mixer: pans ``linspace(0.2, 0.8)``, gains ``1/V``,
    master 0.25."""
    from libgooey_tpu_torch.core.smoother import SmootherBank

    return {"pan": SmootherBank.init(np.linspace(0.2, 0.8, nv), dev),
            "gain": SmootherBank.init(np.full(nv, 1.0 / nv), dev),
            "master": SmootherBank.init(np.float32(0.25), dev)}


def slice_inputs(dev, n_blocks):
    """State, stacked events and statics of the 4,096-voice kick slice, with
    the kick part of bench_configs.build_full_kit's traffic."""
    from libgooey_tpu_torch.core.smoother import smoothing_coeff
    from libgooey_tpu_torch.instruments import kick

    state = {"kick": kick.init_state(V, kick.KickConfig.tight(), device=dev),
             **mixer_state(V, dev)}
    offs, vels = sequenced_events(np.random.RandomState(0), V, n_blocks)
    events = {"kick_off": offs, "kick_vel": vels,
              "block_start": (np.arange(n_blocks) * B).astype(np.int32)}
    static = dict(kinds=("kick",), sample_rate=SR, block_size=B,
                  smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
                  family_static=(("kick", (("feedback_path", False),
                                           ("max_harmonics", 0))),))
    return state, events, static


def kit_inputs(dev, n_blocks):
    """State, stacked events and statics of the five-family kit: the voice
    half of bench_configs.build_full_kit (default presets, the per-family
    lag draws from one ``RandomState(0)`` in family order) with
    ``fx_order=()``."""
    from libgooey_tpu_torch.core.smoother import smoothing_coeff
    from libgooey_tpu_torch.engine import engine

    state = {kind: engine.FAMILIES[kind].init_state(nv, device=dev)
             for kind, nv in KIT.items()}
    state.update(mixer_state(sum(KIT.values()), dev))
    rng = np.random.RandomState(0)
    events = {"block_start": (np.arange(n_blocks) * B).astype(np.int32)}
    for kind, nv in KIT.items():
        events[kind + "_off"], events[kind + "_vel"] = sequenced_events(rng, nv, n_blocks)
    static = dict(kinds=tuple(KIT), sample_rate=SR, block_size=B,
                  smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
                  family_static=(("kick", (("feedback_path", False), ("max_harmonics", 0))),
                                 ("snare", (("max_harmonics", 64),))))
    return state, events, static


def bus_inputs(dev, n_blocks, tilt=None, delay_time=None, order=FX_ORDER, over=None):
    """The kit of :func:`kit_inputs` with ``order``, effects of
    build_full_kit's bus in its order (full_kit_4096_bus4: the first four),
    fresh effect states and ``FX_DEFAULT_TARGETS`` staged every block
    (``tilt`` overrides the tilt's targets, ``delay_time`` the delay's
    initial and target time, ``over`` any effect's, its state initialised
    with them)."""
    from libgooey_tpu_torch.engine import engine

    state, events, static = kit_inputs(dev, n_blocks)
    over = dict(over or {})
    init = set(over)   # the effects whose state starts at their targets
    if tilt is not None:
        over["tilt"] = tilt
    if delay_time is not None:
        over["delay"] = [delay_time, *engine.FX_DEFAULT_TARGETS["delay"][1:]]
        init.add("delay")
    for name in order:
        targets = over.get(name, engine.FX_DEFAULT_TARGETS[name])
        args = targets if name in init else ()
        state["fx_" + name] = engine.FX_MODULES[name].init_state(SR, *args, device=dev)
        events["fx_" + name] = np.tile(np.asarray(targets, np.float32), (n_blocks, 1))
    return state, events, dict(static, fx_order=order)


@contextlib.contextmanager
def plain_versions():
    """Swap every kernel wrapper for its plain version (comparison runs only)."""
    from libgooey_tpu_torch.ops import kernels

    saved = {n: getattr(kernels.module_of(n), n) for n in kernels.KERNELS}
    for n in saved:
        setattr(kernels.module_of(n), n, getattr(kernels.module_of(n), n + "_plain"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(kernels.module_of(n), n, fn)


def drive_path(label, card, state, events, static, n_voices, path_kernels, repeats,
               prof_file=None, compare=None):
    """Render one path: warm up, then with every launch count at 0 time
    ``repeats`` renders of ``N_BLOCKS`` and read the counts after the
    first; check the output, that each of ``path_kernels`` launched and
    ``mix_bank`` once a block, and the first blocks against the all-plain render (``compare``: the state and
    events of that comparison, else the path's own first blocks).  Returns
    the counts."""
    import torch

    from libgooey_tpu_torch.engine import engine
    from libgooey_tpu_torch.ops import kernels

    head_state, head = compare or (state, {k: v[:N_COMPARE] for k, v in events.items()})

    # warm-up (first launches, allocator) on the first blocks
    _, out_k = engine.render_many(head_state, head, **static)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    _, out = engine.render_many(state, events, **static)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    counts = kernels.launch_counts()
    for _ in range(repeats - 1):
        t0 = time.perf_counter()
        engine.render_many(state, events, **static)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))

    peak = float(out.abs().max())
    check(bool(torch.isfinite(out).all()), f"{label} output is not finite")
    check(tuple(out.shape) == (N_BLOCKS, 2, B), f"{label} output shape {tuple(out.shape)}")
    check(peak > 1e-3, f"{label} output is silent (peak {peak})")
    check(all(counts[n] > 0 for n in path_kernels) and counts["mix_bank"] == N_BLOCKS,
          f"{label}: a kernel never launched, or the mix not once a block: {counts}")
    audio_s = N_BLOCKS * B / SR
    rtf = n_voices * audio_s / wall
    print(f"{label}: {n_voices} voices x {N_BLOCKS} blocks, median of {repeats} renders "
          f"{wall:.4f} s ({wall / N_BLOCKS * 1e3:.3f} ms/block; min "
          f"{min(walls) / N_BLOCKS * 1e3:.3f}, max {max(walls) / N_BLOCKS * 1e3:.3f}), "
          f"peak {peak:.4f}; aggregate RTF {rtf:.1f} on {card}")
    print(f"{label} launches: {json.dumps(counts)}")
    print(f"{label} launches per block: "
          f"{json.dumps({n: c / N_BLOCKS for n, c in counts.items()})}")

    with plain_versions():
        _, out_p = engine.render_many(head_state, head, **static)
    torch.cuda.synchronize()
    err = max_err(out_k, out_p)
    print(f"{label}: {out_k.shape[0]} blocks, kernels vs plain versions: max err "
          f"{err:.3e} (tol {RENDER_TOL:g}), peak {float(out_k.abs().max()):.4f}")
    check(err <= RENDER_TOL, f"{label}: kernel render differs from the plain render by {err}")

    if prof_file is not None:
        prof_events = {k: v[:4] for k, v in events.items()}
        profile_blocks(f"{label} ({n_voices} voices)", card, prof_file, wall,
                       lambda: engine.render_many(state, prof_events, **static))
    return counts


def phase_slice(dev, card, prof_file=None):
    state, events, static = slice_inputs(dev, N_BLOCKS)
    return drive_path("kick slice", card, state, events, static, V,
                      ("affine1_bank", "pink_bank", "svf_bank", "env_follow_bank",
                       "fbws_bank", "mix_bank"), N_REPEATS_EARLIER, prof_file)


def phase_kit(dev, card, prof_file=None):
    from libgooey_tpu_torch.ops import bank_kernels as bk

    state, events, static = kit_inputs(dev, N_BLOCKS)
    drive_path("kit", card, state, events, static, sum(KIT.values()), bk.KERNELS,
               N_REPEATS_EARLIER, prof_file)


#: the bus's single kernels: an effect alone, or every effect with
#: ``fuse_bus=False``; a run of two or more mergeable effects takes bus_chain
#: (the plate always launches its own)
BUS_SINGLES = ("saturation_block", "lowpass_block", "tilt_block", "delay_block",
               "env_follower_block", "compressor_block", "spring_block", "plate_block")
#: the delay time of the bus renders' kernel-vs-plain comparison: shorter
#: than a block, so the second block reads what the first wrote
COMPARE_DELAY_S = 0.005
#: full_kit_4096_bus7's comparison: blocks, and the compressor over the
#: threshold at the kit's level and the plate at its smallest size (its
#: tank reads 2.3-3.2 blocks back), initialised and staged so
N_COMPARE_FULL = 4
COMPARE_FULL = {"compressor": [-60.0, 8.0, 1.0, 50.0, 1.0],
                "plate": [0.5, 0.3, 0.5, 0.0, 1.0, 0.0]}


def check_bus_counts(label, counts, launched, idle):
    check(all(counts[n] == N_BLOCKS for n in launched) and all(counts[n] == 0 for n in idle),
          f"{label}: a bus kernel did not launch once per block: {counts}")


def phase_bus(dev, card, prof_file=None):
    """full_kit_4096_bus4 with the default targets (the tilt passthrough),
    then with the tilt at [0.3, 0.4]: the bus as one ``bus_chain`` launch a
    block, as the engine runs it."""
    from libgooey_tpu_torch.ops import bank_kernels as bk

    for label, tilt in (("full_kit_4096_bus4", None),
                        ("full_kit_4096_bus4, tilt [0.3, 0.4]", [0.3, 0.4])):
        state, events, static = bus_inputs(dev, N_BLOCKS, tilt)
        compare = bus_inputs(dev, N_COMPARE, tilt, COMPARE_DELAY_S)[:2]
        c = drive_path(label, card, state, events, static, sum(KIT.values()),
                       bk.KERNELS + ("bus_chain",), N_REPEATS_EARLIER, prof_file, compare)
        check_bus_counts(label, c, ("bus_chain",), BUS_SINGLES)


def phase_full_bus(dev, card, prof_file=None):
    """full_kit_4096_bus7, build_full_kit whole: the six effects before the
    plate as one ``bus_chain`` launch and the plate's own a block; then with
    ``fuse_bus=False``, each effect through its own kernels (the path of a
    lone effect).  Returns the first render's counts, with the single bus
    kernels' from the second."""
    from libgooey_tpu_torch.engine import engine
    from libgooey_tpu_torch.ops import bank_kernels as bk

    compare = bus_inputs(dev, N_COMPARE_FULL, None, COMPARE_DELAY_S, FX_ORDER_FULL,
                         COMPARE_FULL)[:2]
    counts = None
    for label, fuse, repeats in (("full_kit_4096_bus7", True, N_REPEATS),
                                 ("full_kit_4096_bus7, fuse_bus=False", False,
                                  N_REPEATS_EARLIER)):
        state, events, static = bus_inputs(dev, N_BLOCKS, order=FX_ORDER_FULL)
        static = dict(static, fuse_bus=fuse)
        launched = ("bus_chain", "plate_block") if fuse else BUS_SINGLES
        c = drive_path(label, card, state, events, static, sum(KIT.values()),
                       bk.KERNELS + launched, repeats, prof_file, compare)
        check_bus_counts(label, c, launched,
                         BUS_SINGLES[:-1] if fuse else ("bus_chain",))
        if counts is None:
            counts = c
            rows = launch_rows(lambda: engine.render_many(
                state, {k: v[:1] for k, v in events.items()}, **static))
            print(f"{label}: rows of each launch in one block: {json.dumps(rows)}")
            check(c["affine1_bank"] == 26 * N_BLOCKS and c["linrec2_bank"] == 5 * N_BLOCKS
                  and sum(rows["affine1_bank"].values()) == 26
                  and sum(rows["linrec2_bank"].values()) == 5,
                  f"{label}: not 26 affine1_bank and 5 linrec2_bank launches a block")
    counts.update((n, c[n]) for n in BUS_SINGLES[:-1])
    return counts


def launch_rows(render):
    """``{kernel: {rows: launches}}`` of the staged kernels while ``render()``
    runs, recorded where their wrappers launch (the wrappers themselves
    stay: each counts into its own module-level name)."""
    from libgooey_tpu_torch.ops import bank_kernels as bk

    seen = {"affine1_bank": [], "linrec2_bank": []}
    real = bk._launch

    def recording(name, device, entry, *args):
        if name in seen:
            seen[name].append(args[-4])   # ..., R, B, rows per block, 16-byte copies
        return real(name, device, entry, *args)

    bk._launch = recording
    try:
        render()
    finally:
        bk._launch = real
    return {n: {str(r): rs.count(r) for r in sorted(set(rs))} for n, rs in seen.items()}


# --- phase 8: the product block -----------------------------------------------


def product_inputs(dev, n_blocks, engaged=False):
    """The product block of bench_configs.bench_onchip_product_block: the
    kit of __graft_entry__.entry (64 voices, default presets, pan 0.5, gain 1/64,
    master 0.25) with the kit's sequenced traffic (the per-family lags
    drawn from one ``RandomState(0)`` in family order), and the nine-entry
    chain with fresh states at its default targets.  ``engaged``: both
    waveshapers on, and every voice also struck at the first sample with
    velocity 0.8 (__graft_entry__.entry's events), so that the comparison's
    first blocks are loud.  Returns ``(state, events, static, chain)``."""
    from libgooey_tpu_torch.core.smoother import SmootherBank, smoothing_coeff
    from libgooey_tpu_torch.engine import engine
    from libgooey_tpu_torch.mixer import chain

    nv = sum(PRODUCT_KIT.values())
    state = {k: engine.FAMILIES[k].init_state(v, device=dev) for k, v in PRODUCT_KIT.items()}
    state["pan"] = SmootherBank.init(np.full(nv, 0.5), dev)
    state["gain"] = SmootherBank.init(np.full(nv, 1.0 / nv), dev)
    state["master"] = SmootherBank.init(np.float32(0.25), dev)
    rng = np.random.RandomState(0)
    events = {"block_start": (np.arange(n_blocks) * B).astype(np.int32)}
    for kind, v in PRODUCT_KIT.items():
        events[kind + "_off"], events[kind + "_vel"] = sequenced_events(rng, v, n_blocks)
        if engaged:
            events[kind + "_off"][0], events[kind + "_vel"][0] = 0, 0.8
    static = dict(kinds=tuple(PRODUCT_KIT), sample_rate=SR, block_size=B,
                  smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
                  family_static=(("kick", (("feedback_path", False), ("max_harmonics", 64))),
                                 ("snare", (("max_harmonics", 64),)), ("tom2", ())))
    fx = chain.EffectChain(SR, 120.0, device=dev)
    for eid in CHAIN9:
        fx.add(eid)
    for i, vals in (PRODUCT_ENGAGED.items() if engaged else ()):
        for p, v in enumerate(vals):
            fx.set_param(i, p, v)
    return state, events, static, fx


def render_product(state, events, static, fx, fuse_runs=True):
    """Each block through ``_render_all`` (the kit kernels), then its
    limited stereo through ``process_chain``; events and staged targets go
    to the card once, up front.  Returns ``stereo[N, 2, B]``."""
    import torch

    from libgooey_tpu_torch.engine import engine
    from libgooey_tpu_torch.mixer import chain

    dev = state["pan"].current.device
    ev = engine._events_to(events, dev)
    targets = [torch.as_tensor(t, device=dev) for t in fx.targets_list()]
    key, states, outs = fx.static_key(), list(fx.states), []
    for i in range(ev["block_start"].shape[0]):
        state, stereo, _ = engine._render_all(state, {k: v[i] for k, v in ev.items()}, **static)
        states, y = chain.process_chain(states, stereo, targets, key, sample_rate=SR,
                                        fuse_runs=fuse_runs)
        outs.append(y)
    return torch.stack(outs)


def profile_blocks(label, card, prof_file, wall, render4):
    """torch.profiler over ``render4()``, 4 blocks: print device ops and
    busy ms per block and the idle share of ``wall`` (the timed renders'
    median, ``N_BLOCKS`` blocks), and write the table to ``prof_file``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render4()
        torch.cuda.synchronize()
    table = prof.key_averages()
    device = [e for e in table if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 4e3
    h2d = sum(e.count for e in device if "HtoD" in e.key) / 4
    summary = (f"{label} (traced): {sum(e.count for e in device) / 4:.0f} device ops per "
               f"block (kernels and copies; {h2d:.0f} host-to-device), device busy "
               f"{busy_ms:.3f} ms/block, idle share "
               f"{1.0 - busy_ms / (wall / N_BLOCKS * 1e3):.3f} of the timed renders' "
               f"{wall / N_BLOCKS * 1e3:.3f} ms/block")
    print(summary)
    prof_file.write(f"# 4 blocks of the {label} on {card}\n# {summary}\n")
    prof_file.write(table.table(sort_by="cuda_time_total", row_limit=90))
    prof_file.write("\n\n")


def phase_product(dev, card, prof_file=None):
    """product_block_64v_chain9: the kit kernels once a block, the chain's
    first eight entries as one ten-phase ``bus_chain`` and the plate's own
    kernel once a block; again with ``fuse_runs=False``; the first blocks,
    both waveshapers engaged, against the all-plain render.  Returns the
    kit kernels' counts and the two waveshapers' from the unfused render."""
    import torch

    from libgooey_tpu_torch.ops import bus_kernels, kernels

    label = "product_block_64v_chain9"
    nv = sum(PRODUCT_KIT.values())
    inputs = product_inputs(dev, N_BLOCKS)
    head = product_inputs(dev, N_COMPARE_PRODUCT, engaged=True)
    out_k = render_product(*head)          # warm-up
    torch.cuda.synchronize()

    # the phases of each bus_chain launch, seen where it packs them
    phases_seen = []
    real = bus_kernels._launch_phases

    def recording(name, x, phases, *, fused):
        if fused:
            phases_seen.append(len(phases))
        return real(name, x, phases, fused=fused)

    bus_kernels._launch_phases = recording
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = render_product(*inputs)
        torch.cuda.synchronize()
        walls = [time.perf_counter() - t0]
    finally:
        bus_kernels._launch_phases = real
    counts = kernels.launch_counts()
    for _ in range(N_REPEATS - 1):
        t0 = time.perf_counter()
        render_product(*inputs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    peak = float(out.abs().max())
    check(bool(torch.isfinite(out).all()), f"{label} output is not finite")
    check(tuple(out.shape) == (N_BLOCKS, 2, B), f"{label} output shape {tuple(out.shape)}")
    check(peak > 1e-3, f"{label} output is silent (peak {peak})")
    once = ("kit_sources", "kit_drive", "mix_bank", "bus_chain", "plate_block")
    check(all(counts[n] == N_BLOCKS for n in once) and phases_seen == [10] * N_BLOCKS
          and all(counts[n] == 0 for n in ("waveshaper_block", "fbws_fast_block")),
          f"{label}: not one kit_sources, kit_drive, mix_bank, ten-phase bus_chain and "
          f"plate_block a block: {counts}, phases {sorted(set(phases_seen))}")
    audio_s = N_BLOCKS * B / SR
    print(f"{label}: {nv} voices x {N_BLOCKS} blocks through the nine-entry chain, median of "
          f"{N_REPEATS} renders {wall:.4f} s ({wall / N_BLOCKS * 1e3:.3f} ms/block; min "
          f"{min(walls) / N_BLOCKS * 1e3:.3f}, max {max(walls) / N_BLOCKS * 1e3:.3f}), peak "
          f"{peak:.4f}; aggregate RTF {nv * audio_s / wall:.1f} on {card}")
    print(f"{label} launches per block: {json.dumps({n: c / N_BLOCKS for n, c in counts.items()})}")
    print(f"{label} bank kernels between the kit launches, per block: " + json.dumps(
        {n: counts[n] / N_BLOCKS for n in ("env_follow_bank", "linrec2_bank", "svf_bank",
                                           "affine1_bank")}))

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    render_product(*inputs, fuse_runs=False)
    torch.cuda.synchronize()
    wall_unfused = time.perf_counter() - t0
    unfused = kernels.launch_counts()
    singles = ("lowpass_block", "delay_block", "saturation_block", "compressor_block",
               "tilt_block", "spring_block", "waveshaper_block", "fbws_fast_block", "plate_block")
    check(all(unfused[n] == N_BLOCKS for n in singles) and unfused["bus_chain"] == 0
          and unfused["env_follower_block"] == 2 * N_BLOCKS,
          f"{label}, fuse_runs=False: an entry's kernel not once a block: {unfused}")
    print(f"{label}, fuse_runs=False: one render {wall_unfused:.4f} s "
          f"({wall_unfused / N_BLOCKS * 1e3:.3f} ms/block); launches per block: "
          f"{json.dumps({n: c / N_BLOCKS for n, c in unfused.items()})}")

    with plain_versions():
        out_p = render_product(*head)
    torch.cuda.synchronize()
    err = max_err(out_k, out_p)
    print(f"{label}: {N_COMPARE_PRODUCT} blocks with both waveshapers engaged, kernels vs plain "
          f"versions: max err {err:.3e} (tol {RENDER_TOL:g}), peak {float(out_k.abs().max()):.4f}")
    check(err <= RENDER_TOL, f"{label}: kernel render differs from the plain render by {err}")

    if prof_file is not None:
        short = product_inputs(dev, 4)
        profile_blocks(f"{label} ({nv} voices)", card, prof_file, wall,
                       lambda: render_product(*short))
        profile_blocks(f"{label}, fuse_runs=False ({nv} voices)", card, prof_file,
                       wall_unfused, lambda: render_product(*short, fuse_runs=False))
    return {**{n: counts[n] for n in ("kit_sources", "kit_drive")},
            **{n: unfused[n] for n in ("waveshaper_block", "fbws_fast_block")}}


# --- phase 9: the Engine API -------------------------------------------------

#: the bank kernels the Engine's kit path runs between its two launches
#: (the kick's follower, the snare's Chamberlin and tom2's resonators, the
#: bass's swept SVF), and those only the stage path runs
ENGINE_MIDDLES = ("env_follow_bank", "linrec2_bank", "svf_bank")
STAGE_ONLY = ("pink_bank", "fbws_bank", "ws4_bank", "triangle_additive_bank",
              "waveshaper_block", "fbws_fast_block")


def engine_kit(dev, others=("snare", "hihat2", "tom2", "bass")):
    """Phase 9's instruments in an ``Engine`` with no effect: 16 sequenced
    kicks of the four presets and one sequenced instrument of each family
    in ``others`` (the bass with a note on one step), pans spread, 120 BPM,
    master 0.5.  Returns ``(engine, names)``."""
    from libgooey_tpu_torch.engine.engine import FAMILIES, Engine
    from libgooey_tpu_torch.instruments import kick

    eng = Engine(SR, B, device=dev)
    presets = ("tight", "punch", "loose", "dirt")
    names = []
    for i in range(16):
        names.append(f"kick{i}")
        eng.add_kick(names[-1], kick.PRESETS[presets[i % 4]]())
    for kind in others:
        names.append(kind)
        eng.add_instrument(kind, kind, FAMILIES[kind].PRESETS["default"]())
    for i, name in enumerate(names):
        eng.set_pan(name, i / (len(names) - 1))
        seq = eng.new_sequencer(name, 120.0)
        seq.set_pattern([(s + i) % 4 == 0 for s in range(16)])
        if name == "bass":
            seq.set_step_note(1, 40)
        seq.start()
    eng.set_master_gain(0.5)
    return eng, names


def phase_engine(dev, card, prof_file=None):
    """The Engine with its default statics: 16 sequenced kicks (additive
    triangle at 128 harmonics) and one sequenced instrument of each other
    family, the bass with a note on one step, all on the kit path (the kit
    kernels and the bank kernels between them; no stage-path kernel),
    through the seven global effects; then a second second with the
    compressor keyed from the first kick (with ``prof_file``, then 4 more
    of its blocks under the profiler)."""
    from libgooey_tpu_torch.ops import kernels

    eng, names = engine_kit(dev)
    eng.add_global_effect("saturation")
    eng.add_global_effect("lowpass")
    eng.add_global_effect("tilt", [0.3, 0.4])
    eng.add_global_effect("delay", [0.015, 0.5, 0.4, 6000.0])
    for name in ("compressor", "spring", "plate"):
        eng.add_global_effect(name)
    n_samples = int(SR * ENGINE_SECONDS)
    n_blocks = -(-n_samples // B)
    # self-keyed: one run before the plate; keyed from a kick: the
    # compressor leaves the run, and the spring is left alone
    for label, source, launched in (
            ("engine", None, ("bus_chain", "plate_block")),
            ("engine, sidechain kick0", "kick0",
             ("bus_chain", "env_follower_block", "compressor_block", "spring_block",
              "plate_block"))):
        eng.set_sidechain_source(source)
        twin = copy.deepcopy(eng) if source is not None else None
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = eng.render(n_samples)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = float(np.abs(out).max())
        if twin is not None:
            # the sidechained render's first blocks against the same blocks
            # with every kernel swapped for its plain version
            with plain_versions():
                want = twin.render(N_COMPARE * B)
            err = float(np.abs(out[:, :N_COMPARE * B].astype(np.float64) - want).max())
            print(f"{label}: {N_COMPARE} blocks, kernels vs plain versions: max err "
                  f"{err:.3e} (tol {RENDER_TOL:g}), peak {float(np.abs(want).max()):.4f}")
            check(err <= RENDER_TOL,
                  f"{label}: kernel render differs from the plain render by {err}")
        check(out.shape == (2, n_samples), f"{label}: output shape {out.shape}")
        check(bool(np.isfinite(out).all()), f"{label}: output is not finite")
        check(peak > 1e-3, f"{label}: output is silent (peak {peak})")
        check(all(counts[k] == n_blocks for k in ("kit_sources", "kit_drive", "mix_bank"))
              and all(counts[k] > 0 for k in ENGINE_MIDDLES)
              and all(counts[k] == 0 for k in STAGE_ONLY)
              and all(counts[k] == (n_blocks if k in launched else 0)
                      for k in BUS_SINGLES + ("bus_chain",)),
              f"{label}: the kit kernels or the mix not once a block, a middle kernel never "
              f"launched, a stage-path kernel launched, or a bus kernel not once a block: "
              f"{counts}")
        print(f"{label}: {len(names)} sequenced instruments of 5 families through "
              f"{'/'.join(eng.fx_order)}, {ENGINE_SECONDS:g} s rendered in {wall:.3f} s, "
              f"peak {peak:.4f}; "
              f"launches {json.dumps(counts)}")
        if prof_file is not None and source is not None:
            # the idle share against this render's wall a block
            profile_blocks(f"Engine render, {label}", card, prof_file,
                           wall * N_BLOCKS / n_blocks, lambda: eng.render(4 * B))


# --- phase 10: the granulator and the sampler racks -------------------------

#: the kernels of phase 10's render, each once a block
GRAIN_PATH = ("grain_read_cubic", "sampler_read_linear", "ws4_bank", "affine1_bank")


def grain_inputs(dev, compare=False):
    """The states of bench_configs.bench_granulator_sampler_4k: the
    granulator's 80-lane state on ``RandomState(0).randn(32768)*0.3`` widened
    to ``G_LANES`` lanes, every lane seeded active from ``RandomState(1)``
    in the bench's order (duration, src_pos, step, shape, vel; then the
    sampler's increment and velocity), the sampler as one ``S_VOICES``-voice
    state on a zero arena.  ``compare``: the arena filled from a seed, the
    voices started at mixed offsets and bases, the drive at
    ``GRAIN_DRIVE``.  Returns ``(grain_state, sampler_state)``."""
    import torch

    from libgooey_tpu_torch.instruments import granulator as gran
    from libgooey_tpu_torch.instruments import sampler as samp

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    G, S = G_LANES, S_VOICES
    buf = np.random.RandomState(0).randn(GRAIN_SOURCE).astype(np.float32) * 0.3
    cfg = gran.GranulatorConfig(drive=GRAIN_DRIVE if compare else 0.0)
    rng = np.random.RandomState(1)

    def uniform(lo, hi, n):
        return t(rng.uniform(lo, hi, n).astype(np.float32))

    gs = gran.init_state(buf, SR, cfg, device=dev)._replace(
        spawn_sample=t(np.zeros(G), torch.int32), duration=uniform(20000, 60000, G),
        src_pos=uniform(0, 1 << 14, G), step=uniform(0.5, 2.0, G), shape=uniform(0.5, 4.0, G),
        vel=uniform(0.3, 1.0, G), rel_start=t(np.full(G, -1), torch.int32),
        rel_total=t(np.zeros(G)))
    ss = samp.init_state(ARENA_FRAMES, device=dev)._replace(
        start_sample=t(np.zeros(S), torch.int32), base=t(np.zeros(S), torch.int32),
        frames=t(np.full(S, 30000.0)), increment=uniform(0.5, 2.0, S),
        velocity=uniform(0.3, 1.0, S))
    if compare:
        rs = np.random.RandomState(2)
        ss = ss._replace(arena=t(0.3 * rs.randn(ARENA_FRAMES, 2)),
                         start_sample=t(rs.randint(0, 4 * B, S), torch.int32),
                         base=t(rs.randint(0, ARENA_FRAMES - 30000, S), torch.int32))
    return gs, ss


def render_grain(gs, ss, n_blocks):
    """``n_blocks`` of the bench's step with no events: ``gout + sout[0]``
    a block, ``[n_blocks, B]``."""
    import torch

    from libgooey_tpu_torch.core.smoother import smoothing_coeff
    from libgooey_tpu_torch.instruments import granulator as gran
    from libgooey_tpu_torch.instruments import sampler as samp

    coeff = smoothing_coeff(SR)
    gev, sev = gran.SpawnEvents.empty(), samp.StartEvents.empty()
    outs = []
    for i in range(n_blocks):
        gs, gout = gran.render_block(gs, gev, i * B, sample_rate=SR, block_size=B,
                                     smooth_coeff=coeff)
        ss, sout = samp.render_block(ss, sev, i * B, sample_rate=SR, block_size=B)
        outs.append(gout + sout[0])
    return torch.stack(outs)


def render_hosts(dev, n_blocks):
    """The instruments through their hosts: a dense granulator cloud on a
    4 s noise source (80 grains/s of up to 3 s with spray, timing jitter and
    random amplitude: the 64 main lanes fill and grains are stolen into the
    release pool) and a rack of two slots (mono 44.1 kHz, stereo 96 kHz)
    with a pattern started at beat 0.  Returns ``(grain out, sampler out,
    steals)``, the outputs ``[n_blocks, B]`` and ``[n_blocks, 2, B]``."""
    import torch

    from libgooey_tpu_torch.core.smoother import smoothing_coeff
    from libgooey_tpu_torch.instruments import granulator as gran
    from libgooey_tpu_torch.instruments import sampler as samp

    rs = np.random.RandomState(3)
    buf = (0.3 * rs.randn(4 * int(SR))).astype(np.float32)
    cfg = gran.GranulatorConfig(density=1.0, grain_length=1.0, spray=0.3, random_timing=0.5,
                                random_amp=0.4, cloud_duration=0.5)
    cloud = gran.GranulatorHost(SR, buf, SR, cfg, seed=0x2468ACE)
    cloud.trigger(0.0, 0.9)
    gs = gran.init_state(buf, SR, cfg, device=dev)
    rack = samp.SamplerRackHost(SR, 120.0, arena_frames=1 << 16)
    rack.set_buffer(0, (0.5 * rs.randn(6000)).astype(np.float32), SR)
    rack.set_buffer(1, (0.5 * rs.randn(9000, 2)).astype(np.float32), 96000.0)
    for step in range(16):
        rack.set_step(step, step % 2 == 0, step % 4 // 2, 0.8)
    rack.schedule_start(0.0)
    rack.activate_start_if_due(0.0)
    ss = samp.init_state(1 << 16, device=dev)
    coeff = smoothing_coeff(SR)
    gouts, souts, steals = [], [], 0
    for i in range(n_blocks):
        gev = cloud.collect_events(i * B, B)
        steals += int((gev.copy_from >= 0).sum())
        if rack.arena_dirty:
            ss = ss._replace(arena=torch.as_tensor(rack.arena, device=dev))
            rack.arena_dirty = False
        gs, g = gran.render_block(gs, gev, i * B, sample_rate=SR, block_size=B,
                                  smooth_coeff=coeff)
        ss, sv = samp.render_block(ss, rack.collect_events(i * B, B), i * B, sample_rate=SR,
                                   block_size=B)
        gouts.append(g)
        souts.append(sv)
    return torch.stack(gouts), torch.stack(souts), steals


def phase_grain(dev, card, prof_file=None):
    """granulator_lfo_sampler_4k_lanes: the bench's 64 blocks (median of 3
    renders), each kernel of ``GRAIN_PATH`` once a block; the comparison's
    blocks against the plain versions; then the hosts for
    ``HOST_SECONDS``.  Returns the render's counts."""
    import torch

    from libgooey_tpu_torch.ops import kernels

    label = "granulator_lfo_sampler_4k_lanes"
    lanes = G_LANES + S_VOICES
    head = grain_inputs(dev, compare=True)
    out_k = render_grain(*head, N_COMPARE_GRAIN)        # warm-up
    torch.cuda.synchronize()
    inputs = grain_inputs(dev)
    walls = []
    for r in range(N_REPEATS_EARLIER):
        if r == 0:
            kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = render_grain(*inputs, N_BLOCKS)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if r == 0:
            counts = kernels.launch_counts()
    wall = float(np.median(walls))
    peak = float(out.abs().max())
    check(bool(torch.isfinite(out).all()) and tuple(out.shape) == (N_BLOCKS, B),
          f"{label}: output not finite or of shape {tuple(out.shape)}")
    check(peak > 1e-3, f"{label} output is silent (peak {peak})")
    check(all(counts[n] == N_BLOCKS for n in GRAIN_PATH)
          and sum(counts.values()) == len(GRAIN_PATH) * N_BLOCKS,
          f"{label}: not each of {GRAIN_PATH} once a block and nothing else: {counts}")
    audio_s = N_BLOCKS * B / SR
    print(f"{label}: {G_LANES} grain lanes + {S_VOICES} sampler voices x {N_BLOCKS} blocks, "
          f"median of {N_REPEATS_EARLIER} renders {wall:.4f} s ({wall / N_BLOCKS * 1e3:.3f} "
          f"ms/block; min {min(walls) / N_BLOCKS * 1e3:.3f}, max "
          f"{max(walls) / N_BLOCKS * 1e3:.3f}), peak {peak:.4f}; aggregate RTF "
          f"{lanes * audio_s / wall:.1f} ({lanes} lanes) on {card}")
    print(f"{label} launches per block: "
          f"{json.dumps({n: c / N_BLOCKS for n, c in counts.items() if c})}")

    with plain_versions():
        out_p = render_grain(*head, N_COMPARE_GRAIN)
    torch.cuda.synchronize()
    err = max_err(out_k, out_p)
    print(f"{label}: {N_COMPARE_GRAIN} blocks, seeded arena, mixed starts, drive "
          f"{GRAIN_DRIVE}: kernels vs plain versions: max err {err:.3e} (tol {RENDER_TOL:g}), "
          f"peak {float(out_k.abs().max()):.4f}")
    check(err <= RENDER_TOL, f"{label}: kernel render differs from the plain render by {err}")

    n_host = int(np.ceil(HOST_SECONDS * SR / B))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    g_out, s_out, steals = render_hosts(dev, n_host)
    torch.cuda.synchronize()
    host_wall = time.perf_counter() - t0
    host_counts = kernels.launch_counts()
    g_peak, s_peak = float(g_out.abs().max()), float(s_out.abs().max())
    with plain_versions():
        g_p, s_p, _ = render_hosts(dev, N_COMPARE_GRAIN)
    torch.cuda.synchronize()
    host_err = max(max_err(g_out[:N_COMPARE_GRAIN], g_p), max_err(s_out[:N_COMPARE_GRAIN], s_p))
    print(f"{label}, hosts: GranulatorHost cloud and SamplerRackHost pattern, {HOST_SECONDS:g} s "
          f"({n_host} blocks) in {host_wall:.3f} s, peaks {g_peak:.4f} / {s_peak:.4f}, "
          f"{steals} grains stolen; first {N_COMPARE_GRAIN} blocks vs plain versions: max err "
          f"{host_err:.3e}; launches {json.dumps({n: c for n, c in host_counts.items() if c})}")
    check(bool(torch.isfinite(g_out).all() and torch.isfinite(s_out).all())
          and g_peak > 1e-3 and s_peak > 1e-3 and steals > 0,
          f"{label}, hosts: not finite, silent or no steal ({g_peak}, {s_peak}, {steals})")
    check(all(host_counts[n] == n_host for n in GRAIN_PATH) and host_err <= RENDER_TOL,
          f"{label}, hosts: a kernel not once a block, or {host_err} off the plain versions: "
          f"{host_counts}")

    if prof_file is not None:
        profile_blocks(f"{label} ({lanes} lanes)", card, prof_file, wall,
                       lambda: render_grain(*inputs, 4))
    return counts


# --- phase 11: the whole Engine ------------------------------------------------

#: phase 11(a), the Engine at a host's scale: named instruments per family
#: (poly: synths of six lanes), each on a sequencer
WHOLE_ENGINE = {"kick": 16, "snare": 16, "hihat": 16, "hihat2": 16, "tom": 8, "tom2": 8,
                "bass": 8, "poly": 4}
WHOLE_GAIN = 1.0 / 96.0
WHOLE_SECONDS = 1.0
#: how long each poly synth holds its chord, and the bounce's length, seconds
CHORD_SECONDS = 0.5
BOUNCE_SECONDS = 0.5
TOM_PRESETS = ("high", "mid", "low", "floor")
CHORDS = (("C", "major7"), ("A", "minor9"), ("F", "dominant7"), ("G", "major"))
#: phase 11(b), every family at the full kit's widths (poly: 85 synths,
#: 510 lanes), each bank over MAX_FUSED_VOICES
WHOLE_KIT = {"kick": 1024, "snare": 1024, "hihat": 1024, "hihat2": 1024, "tom": 512,
             "tom2": 512, "bass": 512, "poly": 85}
#: (b)'s routes, ``(lfo, kind, slot, param, depth)``: each one affine1_bank
#: scan over its whole bank a block
WHOLE_ROUTES = ((0, "bass", 0, "filter_cutoff", 0.8), (1, "kick", 0, "frequency", 1.0),
                (2, "hihat", 0, "decay", 1.0))
#: the kernels at the shapes phase 11(b) adds, by (name, rows): what runs there
NEW_SHAPES = {
    "affine1_bank": {("affine1_bank", 510): "the poly lanes' phases"},
    "svf_bank": {("svf_bank", 510): "the poly lanes' filter"},
    "triangle_additive_bank": {("triangle_additive_bank", 512): "the tom's punch, 128 "
                                                                 "harmonics"},
}


@contextlib.contextmanager
def route_scans():
    """Record ``(kind, routed params, affine1_bank launches)`` of every
    routed family's one-pole scan (``engine._lfo_overrides``)."""
    from libgooey_tpu_torch.engine import engine
    from libgooey_tpu_torch.ops import kernels

    real = engine._lfo_overrides
    seen = []

    def recording(kind, *args):
        before = kernels.launch_counts()["affine1_bank"]
        out = real(kind, *args)
        seen.append((kind, len(out), kernels.launch_counts()["affine1_bank"] - before))
        return out

    engine._lfo_overrides = recording
    try:
        yield seen
    finally:
        engine._lfo_overrides = real


@contextlib.contextmanager
def last_calls(names, rows_of=None):
    """Keep each named wrapper's arguments at its last launch of each row
    count and its calls of that count, ``{(name, rows): (args, kw, calls)}``
    (the triangle's sample rate and harmonics as keywords, as
    ``kernel_cases`` passes them).  ``rows_of(args, kw)``: the key's second
    part, by default the first argument's rows."""
    from libgooey_tpu_torch.ops import kernels

    seen = {}
    saved = {n: getattr(kernels.module_of(n), n) for n in names}

    def recorder(name, fn):
        def recording(*args, **kw):
            rows = (next(a for a in args if a is not None).shape[0] if rows_of is None
                    else rows_of(args, kw))
            if name == "triangle_additive_bank":
                args, kw = args[:2], dict(sample_rate=args[2], max_harmonics=args[3])
            seen[(name, rows)] = (args, kw, seen.get((name, rows), (0, 0, 0))[2] + 1)
            # the wrapper counts its launch on its module's name for itself,
            # which is this function while recording: carry the count over
            recording.launches = fn.launches
            try:
                return fn(*args, **kw)
            finally:
                fn.launches = recording.launches
        return recording

    for n, fn in saved.items():
        setattr(kernels.module_of(n), n, recorder(n, fn))
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(kernels.module_of(n), n, fn)


def check_route_scans(label, seen, n_blocks, kinds):
    """One affine1_bank launch per routed parameter, for each routed family
    in ``kinds`` a block."""
    per_block = [(k, n, n) for k, n, _ in seen[:len(kinds)]]
    check([k for k, _, _ in per_block] == list(kinds) and seen == per_block * n_blocks,
          f"{label}: the routes' scans were not one affine1_bank per routed parameter a "
          f"block: {seen[:2 * len(kinds)]}")
    print(f"{label}: LFO routes on {', '.join(kinds)}: one affine1_bank a routed parameter, "
          f"{sum(n for _, _, n in per_block)} a block")


def whole_engine(dev):
    """The Engine of phase 11(a): ``WHOLE_ENGINE``'s instruments (kicks
    through phase 9's four presets, the hihats 8 closed and 8 open, the toms
    two of each preset, the others their defaults), pan 0.5, gain 1/96,
    each on a 120 BPM sequencer staggered as phase 9's (the bass with a
    note on a step, the snares with preset blends on two steps); the seven
    global effects (the delay's with an extra keyword option); four LFOs
    (1/8 at 140 BPM on the basses' cutoff, 0.8 Hz on kicks 0-3's pitch, 4 Hz
    on hihat 0's decay, 1.5 Hz on poly 0's cutoff); a chord struck on each
    poly synth."""
    from libgooey_tpu_torch.core.blendable import PresetBlender
    from libgooey_tpu_torch.engine.engine import FAMILIES, Engine

    eng = Engine(SR, B, device=dev)
    kick_presets = ("tight", "punch", "loose", "dirt")
    names = []
    for kind, n in WHOLE_ENGINE.items():
        presets = FAMILIES[kind].PRESETS
        for i in range(n):
            if kind == "kick":
                cfg = presets[kick_presets[i % 4]]()
            elif kind == "hihat":
                cfg = presets["closed_default" if i < n // 2 else "open_default"]()
            elif kind == "tom":
                cfg = presets[TOM_PRESETS[i // 2]]()
            else:
                cfg = presets["default"]()
            names.append(f"{kind}{i}")
            eng.add_instrument(names[-1], kind, cfg)
    snare = FAMILIES["snare"].PRESETS
    for i, name in enumerate(names):
        eng.set_gain(name, WHOLE_GAIN)
        seq = eng.new_sequencer(name, 120.0)
        seq.set_pattern([(s + i) % 4 == 0 for s in range(16)])
        if name.startswith("bass"):
            seq.set_step_note(1, 40)
        if name.startswith("snare"):
            eng.blenders[name] = PresetBlender(*(snare[p]() for p in sorted(snare)[:4]))
            seq.set_step_blend((2 - i) % 4, 0.8, 0.3)
            seq.set_step_blend((2 - i) % 4 + 8, 0.2, 0.9)
        seq.start()
    eng.set_master_gain(0.5)
    eng.add_global_effect("saturation")
    eng.add_global_effect("lowpass")
    eng.add_global_effect("tilt", [0.3, 0.4])
    eng.add_global_effect("delay", [0.015, 0.5, 0.4, 6000.0], pingpong=True)
    for name in ("compressor", "spring", "plate"):
        eng.add_global_effect(name)
    eng.set_lfo(0, division=5, bpm=140.0)
    for i in range(WHOLE_ENGINE["bass"]):
        eng.add_lfo_route(0, f"bass{i}", "filter_cutoff", depth=0.8)
    eng.set_lfo(1, frequency_hz=0.8)
    for i in range(4):
        eng.add_lfo_route(1, f"kick{i}", "frequency", depth=0.5)
    eng.set_lfo(2, frequency_hz=4.0)
    eng.add_lfo_route(2, "hihat0", "decay")
    eng.set_lfo(3, frequency_hz=1.5, offset=0.2)
    eng.add_lfo_route(3, "poly0", "filter_cutoff")
    for i, (root, quality) in enumerate(CHORDS):
        eng.poly_chord_on(f"poly{i}", root, quality, "root", 3 + i % 2, 0.9)
    return eng, names


def phase_whole_engine(dev, card):
    """Phase 11(a): the whole Engine API at a host's scale for
    ``WHOLE_SECONDS`` (each poly synth's chord released after
    ``CHORD_SECONDS``); the routed kick and bass leave the kit path, the
    snare, hihat2 and tom2 stay on it; its first blocks against a copy of
    the engine rendered on the plain versions; then ``bounce_to_buffer``
    of ``BOUNCE_SECONDS`` from two copies of the engine, bit for bit."""
    from libgooey_tpu_torch.ops import kernels

    label = "whole engine"
    eng, names = whole_engine(dev)
    twin = copy.deepcopy(eng)
    n_chord = int(SR * CHORD_SECONDS)   # rounded up to whole blocks
    n_total = int(SR * WHOLE_SECONDS)
    kernels.reset_launch_counts()
    with route_scans() as seen:
        t0 = time.perf_counter()
        n_head = -(-n_chord // B)
        head = eng.render(n_head * B)
        for i, (root, quality) in enumerate(CHORDS):
            eng.poly_chord_off(f"poly{i}", root, quality, "root", 3 + i % 2)
        tail = eng.render(n_total - n_head * B)
        wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n_blocks = n_head + -(-(n_total - n_head * B) // B)
    out = np.concatenate([head, tail], axis=1)
    peak = float(np.abs(out).max())
    midi = len(eng.drain_midi_out())

    with plain_versions():
        want = twin.render(N_COMPARE * B)
    err = float(np.abs(out[:, :N_COMPARE * B].astype(np.float64) - want).max())
    print(f"{label}: {N_COMPARE} blocks, kernels vs plain versions: max err {err:.3e} "
          f"(tol {RENDER_TOL:g}), peak {float(np.abs(want).max()):.4f}")
    check(err <= RENDER_TOL, f"{label}: kernel render differs from the plain render by {err}")
    check(out.shape == (2, n_total) and bool(np.isfinite(out).all())
          and peak > 1e-3, f"{label}: output shape {out.shape}, not finite or silent ({peak})")
    check_route_scans(label, seen, n_blocks, ("kick", "hihat", "bass", "poly"))
    # the kit: snare, hihat2 and tom2 (one kit_sources and one kit_drive a
    # block); the routed kick and bass on their stage paths (the kick's
    # fbws_bank, the bass's ws4_bank; the kick's and the tom's triangles)
    once = ("kit_sources", "kit_drive", "mix_bank", "fbws_bank", "ws4_bank", "bus_chain",
            "plate_block")
    check(all(counts[n] == n_blocks for n in once)
          and counts["triangle_additive_bank"] == 2 * n_blocks
          and all(counts[n] > 0 for n in ("affine1_bank", "svf_bank", "pink_bank",
                                          "env_follow_bank", "linrec2_bank")),
          f"{label}: the kit (snare, hihat2, tom2), the routed kick's and bass's stage paths "
          f"or the bus not as expected over {n_blocks} blocks: {counts}")
    print(f"{label}: {len(names)} sequenced instruments of 8 families "
          f"({json.dumps(WHOLE_ENGINE)}; poly chords held {CHORD_SECONDS:g} s) through "
          f"{'/'.join(eng.fx_order)}, {WHOLE_SECONDS:g} s ({n_blocks} blocks) rendered in "
          f"{wall:.3f} s ({wall / n_blocks * 1e3:.3f} ms/block), peak {peak:.4f}, "
          f"{midi} MIDI-out events drained; on {card}")
    print(f"{label} launches per block: "
          f"{json.dumps({n: c / n_blocks for n, c in counts.items() if c})}")

    other = copy.deepcopy(eng)
    n_bounce = int(SR * BOUNCE_SECONDS)
    t0 = time.perf_counter()
    buf = eng.bounce_to_buffer(n_bounce)
    bounce_wall = time.perf_counter() - t0
    again = other.bounce_to_buffer(n_bounce)
    b_peak = float(np.abs(buf).max())
    print(f"{label}: bounce_to_buffer {BOUNCE_SECONDS:g} s in {bounce_wall:.3f} s, peak "
          f"{b_peak:.4f}, equal to a second bounce from a copy: {np.array_equal(buf, again)}")
    check(buf.shape == (n_bounce,) and bool(np.isfinite(buf).all()) and b_peak > 1e-3,
          f"{label}: bounce of shape {buf.shape}, not finite or silent ({b_peak})")
    check(np.array_equal(buf, again), f"{label}: two bounces from one state differ")


def whole_kit_inputs(dev, n_blocks, kit=None):
    """State, stacked events and statics of phase 11(b): ``kit``'s
    (``WHOLE_KIT`` when None) banks at default presets with
    build_full_kit's sequenced traffic (one
    ``RandomState(0)`` drawing each bank's lags in family order; the poly
    lanes at MIDI 36-83, never released), LFO 0 at 1/8 and 140 BPM, LFO 1
    at 0.8 Hz and LFO 2 at 4 Hz on ``WHOLE_ROUTES``, and the seven-effect
    bus at ``FX_DEFAULT_TARGETS`` with fresh states."""
    from libgooey_tpu_torch import music
    from libgooey_tpu_torch.core.smoother import smoothing_coeff
    from libgooey_tpu_torch.engine import engine, lfo

    kit = WHOLE_KIT if kit is None else kit
    state = {kind: engine.FAMILIES[kind].init_state(nv, device=dev)
             for kind, nv in kit.items()}
    state.update(mixer_state(sum(kit.values()), dev))
    rng = np.random.RandomState(0)
    events = {"block_start": (np.arange(n_blocks) * B).astype(np.int32)}
    for kind, nv in kit.items():
        lanes = nv * engine._lanes_per_slot(kind)
        events[kind + "_off"], events[kind + "_vel"] = sequenced_events(rng, lanes, n_blocks)
    lanes = events["poly_off"].shape[1]
    freqs = np.array([music.midi_to_freq(36 + n % 48) for n in range(lanes)], np.float32)
    events["poly_freq"] = np.tile(freqs, (n_blocks, 1))
    events["poly_rel"] = np.full((n_blocks, lanes), B, np.int32)
    lfos = [lfo.LfoConfig() for _ in range(8)]
    lfos[0].division, lfos[0].bpm = 5, 140.0
    lfos[1].frequency_hz = 0.8
    lfos[2].frequency_hz = 4.0
    events["lfo_phase"] = np.array([[c.advance(B, SR) for c in lfos] for _ in range(n_blocks)],
                                   np.float32)
    events["lfo_inc"] = np.tile(np.array([c.freq() / SR for c in lfos], np.float32),
                                (n_blocks, 1))
    events["lfo_amount"] = np.ones((n_blocks, 8), np.float32)
    events["lfo_offset"] = np.zeros((n_blocks, 8), np.float32)
    for name in FX_ORDER_FULL:
        state["fx_" + name] = engine.FX_MODULES[name].init_state(SR, device=dev)
        events["fx_" + name] = np.tile(
            np.asarray(engine.FX_DEFAULT_TARGETS[name], np.float32), (n_blocks, 1))
    statics = dict(engine.FAMILY_STATIC, kick=dict(feedback_path=False, max_harmonics=0),
                   snare=dict(max_harmonics=64))
    static = dict(kinds=tuple(kit), sample_rate=SR, block_size=B,
                  smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
                  family_static=tuple((k, tuple(sorted(statics[k].items())))
                                      for k in kit if k in statics),
                  lfo_routes=WHOLE_ROUTES, fx_order=FX_ORDER_FULL)
    return state, events, static


def phase_whole_kit(dev, card, prof_file=None):
    """Phase 11(b): every family at the full kit's widths through
    ``render_many`` with three LFO routes and the seven-effect bus, all on
    the stage path; then the routes' scans checked over ``SNARE_BLOCK``
    blocks, and the kernels at the shapes this cell adds timed on that
    render's last launch."""
    from libgooey_tpu_torch.engine import engine
    from libgooey_tpu_torch.ops import bank_kernels as bk
    from libgooey_tpu_torch.ops import kernels

    label = "whole_kit_6142_routes_bus7"
    state, events, static = whole_kit_inputs(dev, N_BLOCKS)
    n_voices = sum(nv * engine._lanes_per_slot(k) for k, nv in WHOLE_KIT.items())
    counts = drive_path(label, card, state, events, static, n_voices,
                        tuple(n for n in bk.KERNELS) + ("bus_chain", "plate_block"),
                        N_REPEATS_EARLIER, prof_file)
    check(counts["kit_sources"] == 0 and counts["bus_chain"] == N_BLOCKS
          and counts["plate_block"] == N_BLOCKS,
          f"{label}: a bank on the kit path, or the bus not one bus_chain and one plate_block "
          f"a block: {counts}")
    # the routes' scans, and the kernels at the shapes this cell adds (the
    # poly's 510 rows, the tom's 512-row triangle at 128 harmonics; the
    # routes' and the hihat's one-poles run at phase 3's 512 and 1,024
    # rows), read at the last of SNARE_BLOCK blocks, when most voices have
    # struck
    n = SNARE_BLOCK
    with route_scans() as seen, last_calls(NEW_SHAPES) as calls:
        engine.render_many(state, {k: v[:n] for k, v in events.items()}, **static)
    check_route_scans(label, seen, n, ("kick", "hihat", "bass"))
    for (name, rows), (args, kw, _) in sorted(calls.items()):
        if (name, rows) not in NEW_SHAPES[name]:
            continue
        mod = kernels.module_of(name)
        kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
        got = as_tuple(kern(*args, **kw))
        err = max_err(got, as_tuple(plain(*args, **kw)))
        ms = device_ms(lambda: kern(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), 1)
        bms, bound_by = bound_ms(name, args, kw, got)
        print(f"{label}: kernel {name} at {NEW_SHAPES[name][(name, rows)]} "
              f"[{rows}, {B}] (the last of {n} blocks): device {ms * 1e3:.1f} us/call, plain "
              f"{plain_ms * 1e3:.1f} us/call, bound {bms * 1e3:.4f} us ({bound_by}), "
              f"max err vs plain {err:.3e}")
        check(err <= OUT_TOL, f"{label}: {name} at {rows} rows differs from its plain "
              f"version by {err}")


# --- phase 12: the loops and the submix graph -----------------------------------

#: each channel's loop: four bars at LOOP_BPM (352,800 frames)
LOOP_SECONDS = 8.0
LOOP_BPM = 120.0
#: the mixer's tempo, warp 1.5 (bench_configs.bench_preserve_pitch_loops)
LOOP_MIXER_BPM = 180.0
N_LOOP_BLOCKS = 32        # (a), (b): render_block calls
LOOP_K = 128              # (c), (d): blocks a render_blocks call
N_LOOP_BATCHES = 3        # (c): render_blocks calls
N_GRAPH_BLOCKS = 64       # (e)
N_COMPARE_LOOPS = 4       # (a), (b), (e): first blocks against the plain versions
#: (b) against (c): blocks, and the JAX package's streamed-vs-host bound
#: (tests/test_wsola_stream.py)
N_STREAM_VS_HOST = 8
STREAM_TOL = 1.5e-3
#: the WSOLA reads' shapes, (grains, samples): the four channels' 65 coarse
#: and 31 fine candidates a hop (a hop is 882 samples) and their 12 grain
#: rows (mono, left, right) of win_n = 1,764
WSOLA_READS = {(260, 882): "the coarse candidates, 4 x 65",
               (124, 882): "the fine candidates, 4 x 31",
               (12, 1764): "the grains, 4 x 3 rows"}


def loop_buffers(seed=SEED):
    """Four 8 s stereo loops from ``seed``: on each beat at ``LOOP_BPM`` a
    noise burst decaying at 8/s over a low sine (55, 110, 165, 220 Hz), the
    left and right noise drawn apart.  Returns ``[(left, right)] * 4``."""
    rs = np.random.RandomState(seed)
    n = int(LOOP_SECONDS * SR)
    t = np.arange(n) / SR
    env = np.exp(-8.0 * (t % (60.0 / LOOP_BPM)))
    out = []
    for c in range(4):
        sine = 0.1 * np.sin(2.0 * np.pi * 55.0 * (c + 1) * t)
        out.append(tuple((sine + 0.25 * env * rs.randn(n)).astype(np.float32)
                         for _ in range(2)))
    return out


def loop_mixer(dev, bufs, grid=False):
    """``Mixer(44100, bpm=180, block_size=512)`` at its default capacity
    (four ``[2, 2^22]`` buffers) with the loops (source BPM 120: warp 1.5) in
    PreservePitch on its four channels, playing; or, with ``grid``, loaded
    into row 0 of its clip grid, the transport started, each launched at
    beat 0."""
    from libgooey_tpu_torch.mixer.loop_channel import PITCH_PRESERVE
    from libgooey_tpu_torch.mixer.mixer import Mixer
    from libgooey_tpu_torch.mixer.stereo_buffer import StereoSampleBuffer

    m = Mixer(SR, bpm=LOOP_MIXER_BPM, block_size=B, device=dev)
    m.set_bpm(LOOP_MIXER_BPM)
    for c, (left, right) in enumerate(bufs):
        buf = StereoSampleBuffer.from_channels(left, right, SR, LOOP_BPM)
        if grid:
            m.clip_grid.load(c, 0, buf, LOOP_BPM)
        else:
            ch = m.channels[c]
            ch.set_buffer(buf)
            ch.pitch_mode = PITCH_PRESERVE
            ch.set_playing(True)
    if grid:
        m.clip_grid.transport_start(m.channels)
        for c in range(len(bufs)):
            m.clip_grid.launch_at(c, 0, 0.0)
    return m


@contextlib.contextmanager
def wsola_search_on_device(on):
    """``mixer.wsola.USE_DEVICE_SEARCH`` set to ``on`` for new stretchers."""
    from libgooey_tpu_torch.mixer import wsola

    saved = wsola.USE_DEVICE_SEARCH
    wsola.USE_DEVICE_SEARCH = on
    try:
        yield
    finally:
        wsola.USE_DEVICE_SEARCH = saved


def stream_hops_due(m, K):
    """The hops ``render_blocks(K)`` runs for channel 0's stretcher (every
    channel of these mixers runs the same), counted on the host before the
    call: ``ceil((K·B - r0) / hop)`` with ``r0`` the current hop's rest."""
    from libgooey_tpu_torch.mixer import wsola

    host = m.channels[0]._stretcher
    hop = max(int(round(wsola.HOP_MS / 1000.0 * SR)), 1)
    r0 = hop - host.drain_idx if host is not None and host.drain_idx < hop else 0
    return -(-(K * B - r0) // hop)


def check_loop_render(label, out, n_blocks):
    import torch

    peak = float(out.abs().max())
    check(tuple(out.shape) == (2, n_blocks * B) and bool(torch.isfinite(out).all()),
          f"{label}: output of shape {tuple(out.shape)} or not finite")
    check(peak > 1e-3, f"{label}: output is silent (peak {peak})")
    return peak


def check_streamed(label, m, counts, hops):
    """Every channel on the device hop loop, three grain reads a hop (one
    wrap group)."""
    check(m.streamed_channels == 4 and counts["grain_read_cubic"] == 3 * hops,
          f"{label}: {m.streamed_channels} of 4 channels streamed, or grain_read_cubic "
          f"{counts['grain_read_cubic']} times, not 3 x {hops} hops")


def loops_line(label, card, walls, n_blocks, counts, peak, extra=""):
    wall = float(np.median(walls))
    rtf = 4 * n_blocks * B / SR / wall
    print(f"{label}: 4 channels x {n_blocks} blocks, {wall / n_blocks * 1e3:.3f} ms/block "
          f"(median of {len(walls)}: " + ", ".join(f"{w / n_blocks * 1e3:.3f}" for w in walls)
          + f"), aggregate RTF {rtf:.1f} (4 channels), peak {peak:.4f}{extra} on {card}")
    print(f"{label} launches per block: "
          f"{json.dumps({n: c / n_blocks for n, c in counts.items() if c})}")
    return wall


def compare_plain(label, got, want, tol=RENDER_TOL):
    err = max_err(got, want)
    print(f"{label}: kernels vs plain versions: max err {err:.3e} (tol {tol:g})")
    check(err <= tol, f"{label}: kernel render differs from the plain render by {err}")


def phase_loops(dev, card, prof_file=None):
    """Phase 12: the loop mixer in the order of
    ``bench_configs.bench_preserve_pitch_loops``, (a) the host search and
    (b) the device search through ``render_block``, (c) the streamed hop
    loop through ``render_blocks``, (d) the clip grid with its transport
    running; then (e) the submix graph fed by (d) and an ``Engine`` kit.
    Returns (d)'s output, for (e)."""
    import torch

    from libgooey_tpu_torch.ops import kernels

    bufs = loop_buffers()
    outs = {}
    for label, on_device in (("loops (a) PreservePitch, host search", False),
                             ("loops (b) PreservePitch, device search", True)):
        with wsola_search_on_device(on_device):
            m = loop_mixer(dev, bufs)
            twin = copy.deepcopy(m)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = torch.cat([m.render_block() for _ in range(N_LOOP_BLOCKS)], dim=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            with plain_versions():
                want = torch.cat([twin.render_block() for _ in range(N_COMPARE_LOOPS)], dim=1)
        peak = check_loop_render(label, out, N_LOOP_BLOCKS)
        loops_line(label, card, [wall], N_LOOP_BLOCKS, counts, peak)
        compare_plain(f"{label}, {N_COMPARE_LOOPS} blocks", out[:, :N_COMPARE_LOOPS * B], want)
        outs[on_device] = (m, out)

    # the stem render of channel 0, twice from one state
    m = outs[False][0]
    t0 = time.perf_counter()
    stem = m.render_channel_to_buffer(0, int(SR))
    stem_wall = time.perf_counter() - t0
    again = m.render_channel_to_buffer(0, int(SR))
    print(f"loops: render_channel_to_buffer(0, {int(SR)}) in {stem_wall:.3f} s, peak "
          f"{float(np.abs(stem).max()):.4f}, equal to a second call: "
          f"{np.array_equal(stem, again)}")
    check(stem.shape == (2, int(SR)) and bool(np.isfinite(stem).all())
          and float(np.abs(stem).max()) > 1e-3, "loops: the stem render is silent or wrong")
    check(np.array_equal(stem, again), "loops: two stem renders from one state differ")

    label = "loops (c) PreservePitch, streamed hop loop"
    with wsola_search_on_device(True):
        m = loop_mixer(dev, bufs)
        twin = copy.deepcopy(m)
        walls = []
        for r in range(N_LOOP_BATCHES):
            hops = stream_hops_due(m, LOOP_K)
            kernels.reset_launch_counts()
            recording = (last_calls(("grain_read_cubic",),
                                    rows_of=lambda args, kw: (args[1].shape[0], kw["B"]))
                         if r == 0 else contextlib.nullcontext({}))
            with recording as reads:
                t0 = time.perf_counter()
                out = m.render_blocks(LOOP_K)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            counts = kernels.launch_counts()
            check_streamed(f"{label}, call {r}", m, counts, hops)
            print(f"{label}, call {r}: {m.streamed_channels} channels streamed, {hops} hops, "
                  f"{counts['grain_read_cubic']} grain_read_cubic launches")
            if r == 0:
                first, first_counts, wsola_reads = out, counts, reads
        with plain_versions():
            want = twin.render_blocks(LOOP_K)
    peak = check_loop_render(label, first, LOOP_K)
    wall_c = loops_line(label, card, walls, LOOP_K, first_counts, peak)
    compare_plain(f"{label}, first call ({LOOP_K} blocks)", first, want)
    n = N_STREAM_VS_HOST * B
    err = max_err(first[:, :n], outs[True][1][:, :n])
    print(f"{label}: first {N_STREAM_VS_HOST} blocks vs (b)'s per-block render: max err "
          f"{err:.3e} (tol {STREAM_TOL:g})")
    check(err <= STREAM_TOL, f"{label}: the streamed render differs from (b)'s by {err}")
    wsola_read_rows(wsola_reads, first_counts)
    if prof_file is not None:
        profile_blocks(f"{label} (4 channels)", card, prof_file,
                       wall_c / LOOP_K * N_BLOCKS, lambda: m.render_blocks(4))

    label = "loops (d) clip grid, transport running"
    with wsola_search_on_device(True):
        m = loop_mixer(dev, bufs, grid=True)
        twin = copy.deepcopy(m)
        head = m.render_blocks(2)       # lands the launches (the host path)
        hops = stream_hops_due(m, LOOP_K)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = m.render_blocks(LOOP_K)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        check_streamed(label, m, counts, hops)
        with plain_versions():
            want = torch.cat([twin.render_blocks(2), twin.render_blocks(LOOP_K)], dim=1)
    peak = check_loop_render(label, out, LOOP_K)
    loops_line(label, card, [wall], LOOP_K, counts, peak,
               f", transport at beat {m.clip_grid.transport_beat:.4f}")
    compare_plain(f"{label}, 2 + {LOOP_K} blocks", torch.cat([head, out], dim=1), want)
    return out


def wsola_read_rows(reads, counts):
    """The grain reads at the WSOLA shapes (``WSOLA_READS``), from (c)'s
    first call: each bit-equal to its plain version, its device time, its
    plain version's, its bound."""
    from libgooey_tpu_torch.ops import grain_kernels as gk

    check(set(k[1] for k in reads) == set(WSOLA_READS),
          f"loops: the grain reads ran at {sorted(reads)}, not {sorted(WSOLA_READS)}")
    per_block = counts["grain_read_cubic"] / 3 / LOOP_K
    for (_name, shape), (args, kw, _) in sorted(reads.items()):
        got = gk.grain_read_cubic(*args, **kw)
        want = gk.grain_read_cubic_plain(*args, **kw)
        ms = device_ms(lambda: gk.grain_read_cubic(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: gk.grain_read_cubic_plain(*args, **kw), 1)
        bms, bound_by = bound_ms("grain_read_cubic", args, kw, (got,))
        print(f"kernel grain_read_cubic at {WSOLA_READS[shape]} [{shape[0]}, {shape[1]}] from "
              f"a {args[0].shape[0]}-sample union: device {ms * 1e3:.1f} us/call, plain "
              f"{plain_ms * 1e3:.1f} us/call, bound {bms * 1e3:.4f} us ({bound_by}), "
              f"{per_block:.3f} launches a block, bit-equal: {same_bits(got, want)}")
        check(same_bits(got, want), f"grain_read_cubic at {shape} not bit-equal to its plain "
              f"version")


def phase_graph(dev, card, loops, prof_file=None):
    """Phase 12(e): ``MixerGraph.with_default_layout`` fed for
    ``N_GRAPH_BLOCKS`` blocks by (d)'s loop output (``SOURCE_LOOPMIXER``, the
    Loops track) and an ``Engine`` of phase 9's 16 kicks
    (``SOURCE_DRUMKIT``, the Drums track; rendered first, off the clock), a
    lowpass, a delay and the plate on the Loops track's rack (one two-phase
    ``bus_chain`` and one ``plate_block`` a block), the Drums track panned
    to 0.2, the Loops track soloed from the middle block on; the first
    blocks against a copy rendered on the plain versions; ``take_peak`` of
    every track at the end."""
    import torch

    from libgooey_tpu_torch.mixer import chain as chain_mod
    from libgooey_tpu_torch.mixer import graph as graph_mod
    from libgooey_tpu_torch.ops import kernels

    label = "graph (e) default layout, drums and loops"
    n = N_GRAPH_BLOCKS
    eng, _ = engine_kit(dev, others=())
    frames = torch.zeros((n, graph_mod.SOURCE_CAPACITY, 2, B), dtype=torch.float32, device=dev)
    for k in range(n):
        frames[k, graph_mod.SOURCE_DRUMKIT] = eng.render_block()[0]
        frames[k, graph_mod.SOURCE_LOOPMIXER] = loops[:, k * B:(k + 1) * B]
    g = graph_mod.MixerGraph.with_default_layout(SR, LOOP_MIXER_BPM, device=dev)
    loops_track = 3
    rack = g.tracks[loops_track].rack
    for eid in (chain_mod.EFFECT_LOWPASS_FILTER, chain_mod.EFFECT_DELAY,
                chain_mod.EFFECT_PLATE_REVERB):
        rack.add(eid)
    rack.set_param(0, 0, 5000.0)        # cutoff
    rack.set_param(1, 2, 0.4)           # the delay's mix
    g.set_track_pan(0, 0.2)

    def render(graph, blocks):
        out = []
        for k in blocks:
            if k == n // 2:
                graph.set_track_solo(loops_track, True)
            master, peaks = graph.render(frames[k], B)
            graph.record_peaks(peaks)
            out.append(master)
        return torch.cat(out, dim=1)

    twin = copy.deepcopy(g)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = render(g, range(n))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    with plain_versions():
        want = render(twin, range(N_COMPARE_LOOPS))
    peak = check_loop_render(label, out, n)
    peaks = [g.take_peak(t) for t in range(len(g.tracks))]
    print(f"{label}: {len(g.tracks)} tracks x {n} blocks, {wall / n * 1e3:.3f} ms/block "
          f"(sources rendered beforehand), peak {peak:.4f}, take_peak "
          f"{json.dumps(dict(zip((t.name for t in g.tracks), peaks)))} on {card}")
    print(f"{label} launches per block: "
          f"{json.dumps({k: c / n for k, c in counts.items() if c})}")
    compare_plain(f"{label}, {N_COMPARE_LOOPS} blocks", out[:, :N_COMPARE_LOOPS * B], want)
    check(counts["bus_chain"] == n and counts["plate_block"] == n,
          f"{label}: the Loops rack not one bus_chain and one plate_block a block: {counts}")
    check(peaks[0] > 1e-3 and peaks[loops_track] > 1e-3 and peaks[1] == peaks[2] == 0.0,
          f"{label}: track peaks {peaks}")
    if prof_file is not None:
        profile_blocks(f"{label} ({len(g.tracks)} tracks)", card, prof_file, wall / n * N_BLOCKS,
                       lambda: render(g, range(n - 4, n)))


# --- phase 13: GooeyEngine, the product engine behind the C API ------------------

GOOEY_PANS = (0.2, 0.4, 0.6, 0.8, 0.5)
N_GOOEY_BLOCKS = 16       # (a): _render_one_block calls
GOOEY_SPANS = (16, 64)    # (a): render(K * B) through the span
N_PIPELINED = 64          # (b): blocks enqueued before one synchronize
N_SESSION = 64            # (c): the span render and the EngineOutput fills
N_PREFETCH = 4            # (c): EngineOutput's prefetch depth
N_COMPARE_GOOEY = 2       # first blocks of each render against the plain versions
GOOEY_TOL = 1e-4
#: the kernels (c)'s span launches: the kit path (snare, hihat2, bass), the
#: kick's and the tom's stage path (their multi-trigger first block widens
#: the span), the poly, the granulator, the rack, the streamed loops, the
#: global run, the plate and the keyed compressor
SESSION_PATH = ("kit_sources", "kit_drive", "affine1_bank", "svf_bank", "pink_bank",
                "env_follow_bank", "fbws_bank", "linrec2_bank", "triangle_additive_bank",
                "ws4_bank", "grain_read_cubic", "sampler_read_linear", "bus_chain",
                "plate_block", "env_follower_block", "compressor_block")


def stereo(inter):
    """An interleaved render as ``[2, frames]``."""
    return np.asarray(inter).reshape(-1, 2).T


def gooey_strips(g, swing=None):
    for ch in range(4):
        seq = g.sequencers[ch]
        seq.set_pattern_string("x.x.x.x.x.x.x.x.")
        if swing is not None:
            seq.set_swing(swing)
        seq.start()


def submix_engine(dev, span=True):
    """(a) ``bench_configs.bench_sequenced_submix``'s session."""
    from libgooey_tpu_torch.gooey import GooeyEngine

    g = GooeyEngine(SR, B, device=dev)
    gooey_strips(g)
    g.strip_pan[:] = GOOEY_PANS
    g.strip_mute[3] = True
    g.span_rendering = span
    return g


def interactive_engine(dev):
    """(b) ``bench_configs.bench_interactive_pipelined``'s session."""
    from libgooey_tpu_torch.gooey import GooeyEngine
    from libgooey_tpu_torch.mixer import chain as chain_mod

    g = GooeyEngine(SR, B, device=dev)
    gooey_strips(g, swing=0.6)
    for eid in (chain_mod.EFFECT_SATURATION, chain_mod.EFFECT_DELAY, chain_mod.EFFECT_REVERB):
        g.set_effect_enabled(eid, True)
    return g


def session_engine(dev, span=True):
    """(c) the whole session: (b)'s strips at phase 12's 180 BPM (the loops
    at warp 1.5), the kick's and the tom's strips struck by hand on their
    first step (a multi-trigger block), the granulator on phase 10's source,
    triggered, a rack of two slots with a pattern started at beat 0, phase
    12's four loops in PreservePitch, a chord on the poly, and the global
    chain saturation -> lowpass -> delay -> plate, then a compressor keyed
    from strip 0."""
    from libgooey_tpu_torch.gooey import GooeyEngine
    from libgooey_tpu_torch.mixer import chain as chain_mod
    from libgooey_tpu_torch.mixer.loop_channel import PITCH_PRESERVE
    from libgooey_tpu_torch.mixer.stereo_buffer import StereoSampleBuffer

    g = GooeyEngine(SR, B, device=dev)
    g.span_rendering = span
    g.set_bpm(LOOP_MIXER_BPM)
    gooey_strips(g, swing=0.6)
    g.trigger_channel(0, 0.9)
    g.trigger_channel(3, 0.9)
    g.granulator_load(np.random.RandomState(0).randn(GRAIN_SOURCE).astype(np.float32) * 0.3, SR)
    g.granulator_set_param("density", 0.6)
    g.granulator_trigger(0.9)
    rs = np.random.RandomState(3)
    g.register_sampler_rack(0, arena_frames=1 << 16)
    rack = g.racks[0]
    rack.set_buffer(0, (0.5 * rs.randn(6000)).astype(np.float32), SR)
    rack.set_buffer(1, (0.5 * rs.randn(9000, 2)).astype(np.float32), 96000.0)
    for step in range(16):
        rack.set_step(step, step % 2 == 0, step % 4 // 2, 0.8)
    rack.schedule_start(0.0)
    for c, (left, right) in enumerate(loop_buffers()):
        ch = g.mixer.channels[c]
        ch.set_buffer(StereoSampleBuffer.from_channels(left, right, SR, LOOP_BPM))
        ch.pitch_mode = PITCH_PRESERVE
        ch.set_playing(True)
    g.perf_chord_on(0, 0, 0, 0, 1, 4, 0.8)
    for eid in (chain_mod.EFFECT_SATURATION, chain_mod.EFFECT_LOWPASS_FILTER,
                chain_mod.EFFECT_DELAY, chain_mod.EFFECT_PLATE_REVERB,
                chain_mod.EFFECT_COMPRESSOR):
        g.set_effect_enabled(eid, True)
    g.set_effect_order([chain_mod.EFFECT_SATURATION, chain_mod.EFFECT_LOWPASS_FILTER,
                        chain_mod.EFFECT_DELAY, chain_mod.EFFECT_PLATE_REVERB,
                        chain_mod.EFFECT_COMPRESSOR, chain_mod.EFFECT_TILT_FILTER,
                        chain_mod.EFFECT_WAVESHAPER, chain_mod.EFFECT_FEEDBACK_WAVESHAPER,
                        chain_mod.EFFECT_REVERB])
    g.set_effect_param(chain_mod.EFFECT_LOWPASS_FILTER, 0, 6000.0)
    g.sidechain_strip = 0
    return g


@contextlib.contextmanager
def strict_span():
    """Catch the synchronizing CUDA calls inside the span's block loop
    (``torch.cuda.set_sync_debug_mode("warn")`` around ``_span_render``);
    yields the list of their Python call sites, innermost last."""
    import os
    import traceback
    import warnings

    import torch

    from libgooey_tpu_torch import gooey

    real, seen = gooey._span_render, []

    def note(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            seen.append(" > ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                                   for f in traceback.extract_stack()[-7:-1]))

    def watched(*args, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return real(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")

    gooey._span_render = watched
    try:
        yield seen
    finally:
        gooey._span_render = real


def check_syncs(label, syncs):
    sites = collections.Counter(syncs).most_common(4)
    check(not syncs, f"{label}: {len(syncs)} synchronizing calls in the span's block loop, "
          f"most at {sites}")


def timed_render(render):
    """``render()`` with every launch count at 0 and the card synchronised
    before and after: ``(output, wall s, counts)``."""
    import torch

    from libgooey_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = render()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, kernels.launch_counts()


def per_block(g, n):
    """``n`` blocks through ``_render_one_block``, enqueued, as one tensor."""
    import torch

    return torch.cat([g._render_one_block() for _ in range(n)], dim=1)


def gooey_line(label, card, wall, n_blocks, counts, out, extra=""):
    """Print a render's wall ms/block, its real-time factor (audio seconds
    over wall seconds) and launches a block; check the output.  Returns
    ``(ms/block, launches a block)``."""
    out = np.asarray(out)
    peak = float(np.abs(out).max())
    check(out.shape == (2, n_blocks * B) and bool(np.isfinite(out).all()),
          f"{label}: output of shape {out.shape} or not finite")
    check(peak > 1e-3, f"{label}: output is silent (peak {peak})")
    ms = wall / n_blocks * 1e3
    per = {k: c / n_blocks for k, c in counts.items() if c}
    print(f"{label}: {n_blocks} blocks, {ms:.3f} ms/block, RTF {n_blocks * B / SR / wall:.3f} "
          f"(audio s / wall s), peak {peak:.4f}{extra} on {card}")
    print(f"{label} launches per block: {json.dumps(per)}")
    return ms, per


def gooey_compare(label, got, want, what="the plain versions", tol=GOOEY_TOL):
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    print(f"{label}: vs {what}: max err {err:.3e} (tol {tol:g})")
    check(err <= tol, f"{label}: differs from {what} by {err}")


def plain_head(twin, span):
    """The first ``N_COMPARE_GOOEY`` blocks of ``twin`` (a copy taken before
    a render) on the plain versions, through the span or block by block."""
    with plain_versions():
        if span:
            return stereo(twin.render(N_COMPARE_GOOEY * B))
        return per_block(twin, N_COMPARE_GOOEY).cpu().numpy()


def gooey_profile(label, card, prof_file, ms, render4):
    if prof_file is not None:
        profile_blocks(label, card, prof_file, ms * N_BLOCKS / 1e3, render4)


def phase_gooey_submix(dev, card, prof_file=None):
    """(a) 16 blocks through ``_render_one_block``, then ``render(K * B)``
    through the span at K = 16 and 64, each against a second engine's
    per-block path and its first blocks against a copy on the plain
    versions.  Returns each render's launches a block."""
    import torch

    label = "gooey (a) sequenced submix"
    g, ref = submix_engine(dev), submix_engine(dev, span=False)
    for e in (g, ref):
        e.render(2 * B)     # first launches, the allocator
    launches = {}
    twin = copy.deepcopy(g)
    out, wall, counts = timed_render(lambda: per_block(g, N_GOOEY_BLOCKS))
    out = out.cpu().numpy()
    want = ref.render(N_GOOEY_BLOCKS * B)
    ms, launches["per-block"] = gooey_line(f"{label}, per-block", card, wall, N_GOOEY_BLOCKS,
                                           counts, out)
    gooey_compare(f"{label}, per-block", out, stereo(want), "a second engine's per-block path")
    gooey_compare(f"{label}, per-block, {N_COMPARE_GOOEY} blocks", out[:, :N_COMPARE_GOOEY * B],
                  plain_head(twin, False))
    walls = {"per-block": ms}
    for K in GOOEY_SPANS:
        twin = copy.deepcopy(g)
        with strict_span() as syncs:
            out, wall, counts = timed_render(lambda: g.render(K * B))
        check(g.error is None, f"{label}: {g.error}")
        out = stereo(out)
        want = stereo(ref.render(K * B))
        ms, launches[f"span {K}"] = gooey_line(
            f"{label}, span {K}", card, wall, K, counts, out,
            f", {len(syncs)} synchronizing calls in the block loop")
        gooey_compare(f"{label}, span {K}", out, want, "a second engine's per-block path")
        gooey_compare(f"{label}, span {K}, first {N_COMPARE_GOOEY} blocks",
                      out[:, :N_COMPARE_GOOEY * B], plain_head(twin, True))
        check_syncs(f"{label}, span {K}", syncs)
        walls[K] = ms
    # traced last: the profiles' blocks advance only this engine
    gooey_profile(f"{label}, per-block", card, prof_file, walls["per-block"],
                  lambda: per_block(g, 4))
    gooey_profile(f"{label}, span", card, prof_file, walls[GOOEY_SPANS[0]],
                  lambda: g.render(4 * B))
    torch.cuda.synchronize()
    return launches


def phase_gooey_interactive(dev, card, prof_file=None):
    """(b) 64 blocks enqueued through ``_render_one_block``, one
    synchronize (three times: the median and the best), the first blocks
    against a copy on the plain versions; then a depth-1 loop (block N+1
    enqueued, block N read back) for the worst block."""
    import torch

    label = "gooey (b) interactive, pipelined"
    g = interactive_engine(dev)
    g.render(4 * B)
    twin = copy.deepcopy(g)
    walls = []
    for r in range(3):
        out, wall, c = timed_render(lambda: per_block(g, N_PIPELINED))
        walls.append(wall)
        if r == 0:
            first, counts = out.cpu().numpy(), c
    wall = float(np.median(walls))
    ms, launches = gooey_line(
        label, card, wall, N_PIPELINED, counts, first,
        f"; median of 3 (best {min(walls) / N_PIPELINED * 1e3:.3f} ms/block)")
    gooey_compare(f"{label}, {N_COMPARE_GOOEY} blocks", first[:, :N_COMPARE_GOOEY * B],
                  plain_head(twin, False))
    prev = g._render_one_block()
    worst, lat = 0.0, []
    for _ in range(N_PIPELINED):
        t0 = time.perf_counter()
        nxt = g._render_one_block()
        prev.cpu()
        lat.append(time.perf_counter() - t0)
        prev = nxt
    torch.cuda.synchronize()
    worst = max(lat)
    print(f"{label}, depth 1: worst block {worst * 1e3:.3f} ms, median "
          f"{float(np.median(lat)) * 1e3:.3f} ms (limit {B / SR * 1e3:.2f} ms) on {card}")
    gooey_profile(label, card, prof_file, ms, lambda: per_block(g, 4))
    return {"pipelined": launches}


def phase_gooey_session(dev, card, prof_file=None):
    """(c) the whole session: ``render(64 * B)`` through the span, against a
    second engine's per-block path and, its first blocks, a copy on the
    plain versions, every kernel of ``SESSION_PATH`` launched; then 64
    blocks through ``EngineOutput.fill`` with a prefetch of 4, paced at the
    card's real-time cadence, with its overrun count.  Returns the span's
    counts and its launches a block."""
    import torch

    from libgooey_tpu_torch.engine.output import EngineOutput

    label = "gooey (c) whole session"
    with wsola_search_on_device(True):
        g, ref = session_engine(dev), session_engine(dev, span=False)
        twin = copy.deepcopy(g)
        # the paths' constant tables reach the card at their first use, once
        # a process: a copy's short span lands them before the timed one
        copy.deepcopy(g).render(2 * B)
        with strict_span() as syncs:
            out, wall, counts = timed_render(lambda: g.render(N_SESSION * B))
        check(g.error is None, f"{label}: {g.error}")
        out = stereo(out)
        want = stereo(ref.render(N_SESSION * B))
        check(ref.error is None, f"{label}: {ref.error}")
        ms, launches = gooey_line(f"{label}, span {N_SESSION}", card, wall, N_SESSION, counts,
                                  out, f", {len(syncs)} synchronizing calls in the block loop")
        missing = [n for n in SESSION_PATH if not counts[n]]
        check(not missing, f"{label}: never launched: {missing}")
        gooey_compare(f"{label}, span {N_SESSION}", out, want, "a second engine's per-block path")
        gooey_compare(f"{label}, first {N_COMPARE_GOOEY} blocks", out[:, :N_COMPARE_GOOEY * B],
                      plain_head(twin, True))
        check_syncs(label, syncs)

        # the realtime adapter: a prefetch thread renders block by block
        twin = copy.deepcopy(g)
        o = EngineOutput(prefetch_blocks=N_PREFETCH)
        o.initialize(SR)
        o.create_stream_with_engine(g)
        o.start()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 120.0:
            with o._lock:
                if len(o._queue) >= N_PREFETCH:
                    break
            time.sleep(0.005)
        primed = time.perf_counter() - t0
        period = B / SR
        got, late = [], 0
        t0 = time.perf_counter()
        for i in range(N_SESSION):
            buf = np.zeros(B * 2, np.float32)
            o.fill(buf, 2)
            got.append(stereo(buf))
            delay = t0 + (i + 1) * period - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            else:
                late += 1
        wall = time.perf_counter() - t0
        o.stop()
        torch.cuda.synchronize()
        overruns = o.overrun_count()
        filled = np.concatenate(got, axis=1)
        check(bool(np.isfinite(filled).all()) and float(np.abs(filled).max()) > 1e-3,
              f"{label}, EngineOutput: the filled audio is silent or not finite")
        print(f"{label}, EngineOutput.fill: {N_SESSION} callbacks of {B} frames paced at "
              f"{period * 1e3:.2f} ms, prefetch {N_PREFETCH} (primed in {primed:.3f} s), "
              f"{wall / N_SESSION * 1e3:.3f} ms/callback, {late} late, overruns {overruns}, "
              f"silent callbacks {sum(float(np.abs(x).max()) == 0.0 for x in got)} on {card}")
        with plain_versions():
            want = np.concatenate([per_block(twin, 1).cpu().numpy()
                                   for _ in range(N_COMPARE_GOOEY)], axis=1)
        gooey_compare(f"{label}, EngineOutput, first {N_COMPARE_GOOEY} callbacks",
                      filled[:, :N_COMPARE_GOOEY * B], want)
        gooey_profile(f"{label}, span", card, prof_file, ms, lambda: g.render(4 * B))
    return counts, {"span": launches}


def phase_gooey(dev, card, prof_file=None):
    """Phase 13: ``GooeyEngine`` (22 instrument slots and the poly), (a)-(c).
    Returns (c)'s span counts, each merged with the largest count a render
    of (a) and (b) gave per 64 blocks."""
    launches = phase_gooey_submix(dev, card, prof_file)
    launches.update(phase_gooey_interactive(dev, card, prof_file))
    counts, per = phase_gooey_session(dev, card, prof_file)
    launches.update(per)
    print(f"gooey launches per block by render: {json.dumps(launches)}")
    return counts


N_CAPI_CALLS = 64         # 14: engine_render(h, 512) calls, one a host callback
N_CAPI_SPAN = 64          # 14: blocks of the one engine_render(h, 64 * 512)
N_DSL_BLOCKS = 16         # 14: blocks of the DSL engine, all against the plain versions
CAPI_PANS = (0.2, 0.4, 0.6, 0.8)
#: the kernels the C-API session launches: 13 (c)'s, the granulator's reads
#: in place of the loops'
CAPI_PATH = SESSION_PATH
#: tests/test_dsl_capi.py's program
DSL_PROGRAM = """
bpm 130
master 0.5
inst kick kick tight
inst hat hihat2 short
seq kick x...x...x...x...
seq hat 9.5.9.5.9.5.9.5. swing=0.2
lfo 1bar kick.frequency amt=0.4
fx lowpass 2000 0.3
fx delay 0.5 0.4 0.25 6000
"""


def capi_session(capi):
    """Phase 14's session, made as a C host makes it, through the integer
    ids of ``libgooey_tpu_torch.capi`` alone: the four kit strips and the
    bass on patterns with swing, pans, the kick's and the tom's strips also
    struck by hand (their first block has two triggers), the global chain
    saturation -> delay -> plate and a compressor keyed from strip 0, a rack
    of two slots from a seeded buffer with its pattern, routed to the Drums
    track, the granulator on phase 10's source, triggered, and a chord on
    the poly.  Returns the handle."""
    h = capi.engine_new(SR)
    capi.engine_set_bpm(h, LOOP_MIXER_BPM)
    for ch, bits in enumerate((0x5555, 0x1111, 0x5555, 0x0101, 0x1111)):
        capi.engine_sequencer_set_instrument_pattern(h, ch, bits)
        capi.engine_sequencer_set_swing(h, ch, 0.6)
    for ch, pan in enumerate(CAPI_PANS):
        check(capi.engine_set_instrument_pan(h, ch, pan) == 1, "capi: a strip pan refused")
    check(capi.engine_set_snare_param(h, 1, 10, 0.4) == 1, "capi: the snare cutoff refused")
    check(capi.engine_set_channel_param(h, 1, 12, 1) == 1, "capi: the snare filter type refused")
    for eid in (2, 1, 9, 3):     # saturation, delay, plate, compressor
        capi.engine_set_global_effect_enabled(h, eid, 1)
    check(capi.engine_set_effect_order_list(h, [2, 1, 9, 3, 0, 4, 7, 8, 6]) == 1,
          "capi: the effect order refused")
    check(capi.engine_set_global_effect_param(h, 1, 0, 0.02) == 1, "capi: the delay time refused")
    capi.engine_set_compressor_sidechain(h, 0)
    rs = np.random.RandomState(3)
    rack = capi.engine_sampler_register(h)
    check(rack == 0, f"capi: sampler_register gave {rack}")
    check(capi.engine_sampler_set_slot_buffer(
        h, rack, 0, (0.5 * rs.randn(6000)).astype(np.float32), 1, SR) == 1,
        "capi: rack slot 0 refused")
    check(capi.engine_sampler_set_slot_buffer(
        h, rack, 1, (0.5 * rs.randn(9000 * 2)).astype(np.float32), 2, 96000.0) == 1,
        "capi: rack slot 1 refused")
    for step in range(16):
        capi.engine_sampler_set_step(h, rack, step, int(step % 2 == 0), step % 4 // 2, 0.8)
    capi.engine_mixer_route_source(h, capi.engine_sampler_get_source_id(h, rack), 0)
    capi.engine_sampler_start_pattern(h, rack, 0.0)
    noise = np.random.RandomState(0).randn(GRAIN_SOURCE).astype(np.float32) * 0.3
    check(capi.engine_granulator_set_buffer(h, noise, SR) == 1, "capi: granulator buffer refused")
    capi.engine_granulator_set_param(h, 4, 0.6)      # density
    capi.engine_granulator_trigger(h, 0.9)
    capi.engine_poly_trigger_chord(h, 0, 0, 0, 0, 1, 4, 0.8)
    for ch in range(5):
        capi.engine_sequencer_start(h, ch)
    capi.engine_transport_start(h)
    capi.engine_trigger_channel_with_velocity(h, 0, 0.9)
    capi.engine_trigger_channel_with_velocity(h, 3, 0.9)
    return h


def capi_calls(render, n):
    """``n`` calls of ``render(B)`` (``engine_render(h, B)``, or the
    ``GooeyEngine.render`` it calls), each timed as a host callback sees it
    (the call returns the block on the host): ``([2, n * B], each call's
    wall s)``."""
    outs, walls = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        outs.append(stereo(render(B)))
        walls.append(time.perf_counter() - t0)
    return np.concatenate(outs, axis=1), walls


def phase_capi(dev, card, prof_file=None):
    """Phase 14: the C API (``libgooey_tpu_torch.capi``) driven as a host
    drives it.  (a) ``capi_session``: 64 calls of ``engine_render(h, 512)``,
    then one ``engine_render(h, 64 * 512)`` through the span (the kick's and
    the tom's strips struck twice by hand before it), each with its
    wall ms/block against the block's real-time limit, its RTF and its
    launches a block; every kernel of ``CAPI_PATH`` launched by each; the
    first 2 calls against a copy on the plain versions; the span's block
    loop with no synchronizing call.  (b) ``dsl.build_engine`` of
    ``DSL_PROGRAM`` on the card, 16 blocks against a copy on the plain
    versions.  Returns (a)'s per-call counts."""
    import torch

    from libgooey_tpu_torch import capi, dsl
    from libgooey_tpu_torch.ops import kernels

    label = "capi (a) session"
    limit = B / SR * 1e3
    parts, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        parts[name] = round(now - t_part, 1)
        t_part = now

    h = capi_session(capi)
    check(capi._e(h).device.type == "cuda", f"{label}: engine_new gave {capi._e(h).device}")
    # the paths' constant tables reach the card at their first use: a copy's
    # short render lands them before the timed calls
    copy.deepcopy(capi._e(h)).render(2 * B)
    twin = copy.deepcopy(capi._e(h))
    part("set-up")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out, walls = capi_calls(lambda n: capi.engine_render(h, n), N_CAPI_CALLS)
    counts = kernels.launch_counts()
    part("per call")
    check(capi.engine_has_error(h) == 0, f"{label}: {capi.engine_last_error(h)}")
    wall = sum(walls)
    ms, per = gooey_line(
        f"{label}, per call", card, wall, N_CAPI_CALLS, counts, out,
        f"; limit {limit:.2f} ms, calls over it {sum(w * 1e3 > limit for w in walls)}, "
        f"median {float(np.median(walls)) * 1e3:.3f} ms, worst {max(walls) * 1e3:.3f} ms")
    missing = [n for n in CAPI_PATH if not counts[n]]
    check(not missing, f"{label}, per call: never launched: {missing}")
    with plain_versions():
        want, _ = capi_calls(twin.render, N_COMPARE_GOOEY)
    part("per call, plain versions")
    gooey_compare(f"{label}, first {N_COMPARE_GOOEY} calls", out[:, :N_COMPARE_GOOEY * B], want)
    peaks = capi.engine_get_channel_peaks(h)
    check(peaks.dtype == np.float32 and float(peaks.max()) > 1e-3,
          f"{label}: strip peaks {peaks}")
    print(f"{label}: strip peaks {np.round(peaks, 4).tolist()}, track peaks "
          f"{[round(capi.engine_mixer_get_track_peak(h, t), 4) for t in range(4)]}")

    # two hand strikes of the kick's and the tom's strips: the span's first
    # block has two triggers of each, so the span takes their stage path
    for ch in (0, 0, 3, 3):
        capi.engine_trigger_channel_with_velocity(h, ch, 0.8)
    with strict_span() as syncs:
        span, wall_span, span_counts = timed_render(
            lambda: capi.engine_render(h, N_CAPI_SPAN * B))
    check(capi.engine_has_error(h) == 0, f"{label}: {capi.engine_last_error(h)}")
    check(span.dtype == np.float32 and span.flags["C_CONTIGUOUS"],
          f"{label}: engine_render gave {span.dtype}")
    ms_span, per_span = gooey_line(
        f"{label}, span {N_CAPI_SPAN}", card, wall_span, N_CAPI_SPAN, span_counts,
        stereo(span), f"; limit {limit:.2f} ms, {len(syncs)} synchronizing calls in the "
        f"block loop")
    missing = [n for n in CAPI_PATH if not span_counts[n]]
    check(not missing, f"{label}, span: never launched: {missing}")
    check_syncs(f"{label}, span", syncs)
    part("span")

    label_dsl = "capi (b) dsl.build_engine"
    eng = dsl.build_engine(DSL_PROGRAM, device=dev)
    check(eng.device.type == "cuda", f"{label_dsl}: built on {eng.device}")
    twin_dsl = copy.deepcopy(eng)
    got, wall_dsl, dsl_counts = timed_render(lambda: eng.render(N_DSL_BLOCKS * B))
    _, per_dsl = gooey_line(label_dsl, card, wall_dsl, N_DSL_BLOCKS, dsl_counts, got)
    part("dsl")
    with plain_versions():
        want = twin_dsl.render(N_DSL_BLOCKS * B)
    gooey_compare(f"{label_dsl}, {N_DSL_BLOCKS} blocks", got, want)
    part("dsl, plain versions")
    launches = {"per call": per, "span": per_span, "dsl": per_dsl}
    print(f"capi launches per block by render: {json.dumps(launches)}")
    gooey_profile(f"{label}, per call", card, prof_file, ms,
                  lambda: capi_calls(lambda n: capi.engine_render(h, n), 4))
    gooey_profile(f"{label}, span", card, prof_file, ms_span,
                  lambda: capi.engine_render(h, 4 * B))
    capi.engine_free(h)
    torch.cuda.synchronize()
    part("profiles")
    print(f"capi seconds by part: {json.dumps(parts)}")
    return counts


# --- phase 15: os_mode 1 and 2, and the examples ------------------------------

#: the families with an ``os_mode``: at 2 their drive leaves the 4x kernels
#: (``fbws_bank``, ``ws4_bank``) for ``ops/oversample.process``, whose
#: half-band sections run on ``affine1_bank``; at 1 there is no stage
OS_FAMILIES = ("kick", "snare", "bass")
N_OS_BLOCKS = 16          # (a): the timed render at os_mode 2
N_OS_COMPARE = 2          # (a): first blocks against the plain versions
#: (a): affine1_bank launches a block beyond bus7's 26: at 2 the kick's 8
#: half-band sections and its DC blocker's 2 scans, the snare's and the
#: bass's 8 sections each; at 1 the kick's 2 DC scans
OS_EXTRA_AFFINE = {2: 26, 1: 2}
#: (c): affine1_bank's row counts on the oversampler's paths
OS_AFFINE_ROWS = {2048: "the kick's or the snare's 1,024 voices x 2 branches",
                  1024: "the bass's 512 voices x 2 branches",
                  4: "a stereo bus effect, [2 branches, 2 channels]"}
#: (d): the examples, by how main takes a short render
EXAMPLES_QUICK = ("kick", "snare", "hihat", "hihat2", "tom", "tom2", "bass", "delay", "reverb",
                  "reverb_lab", "tilt_filter", "lfo_test", "sequencer", "membrane",
                  "multi_channel_submix", "midi_drums")
EXAMPLES_SECONDS = ("drums", "bass_sequencer", "chords", "effects_lab", "granular",
                    "loops_and_clips", "sampler_rack", "performance_record", "dsl_demo")
EXAMPLES_OTHER = ("bounce", "antialias_validation", "aliasing_plots", "scope")
EXAMPLE_SECONDS = 0.5


def os_kit_inputs(dev, n_blocks, os_mode, struck=False, **kw):
    """full_kit_4096_bus7 (:func:`bus_inputs` with the whole bus) with the
    kick, the snare and the bass at ``os_mode``; ``struck``: every voice of
    those three also struck at the first sample (the comparison's blocks,
    which the lagged traffic leaves nearly silent)."""
    state, events, static = bus_inputs(dev, n_blocks, order=FX_ORDER_FULL, **kw)
    if struck:
        for kind in OS_FAMILIES:
            events[kind + "_off"][0] = 0
            events[kind + "_vel"][0] = 0.9
    fam = {k: dict(v) for k, v in static["family_static"]}
    for kind in OS_FAMILIES:
        fam.setdefault(kind, {})["os_mode"] = os_mode
    static["family_static"] = tuple((k, tuple(sorted(v.items()))) for k, v in fam.items())
    return state, events, static


def phase_os_kit(dev, card):
    """Phase 15 (a): full_kit_4096_bus7 with the kick, the snare and the
    bass at ``os_mode`` 2 (16 blocks timed), then at 1 (one block); each
    render's first blocks against the plain versions, its launches a block
    and the rows of each ``affine1_bank`` launch.  Returns the os-2 render's
    counts and rows."""
    import torch

    from libgooey_tpu_torch.engine import engine
    from libgooey_tpu_torch.ops import bank_kernels as bk
    from libgooey_tpu_torch.ops import kernels

    path = tuple(n for n in bk.KERNELS if n not in ("fbws_bank", "ws4_bank")) + (
        "bus_chain", "plate_block")
    result = None
    for os_mode, n_blocks in ((2, N_OS_BLOCKS), (1, 1)):
        label = f"full_kit_4096_bus7, os_mode {os_mode} (kick, snare, bass)"
        n_cmp = min(N_OS_COMPARE, n_blocks)
        state, events, static = os_kit_inputs(dev, n_blocks, os_mode)
        head_state, head = os_kit_inputs(dev, n_cmp, os_mode, struck=True,
                                         delay_time=COMPARE_DELAY_S, over=COMPARE_FULL)[:2]
        _, out_k = engine.render_many(head_state, head, **static)   # also the warm-up
        torch.cuda.synchronize()
        peak_k = float(out_k.abs().max())
        check(bool(torch.isfinite(out_k).all()) and peak_k > 1e-3,
              f"{label}: the comparison's blocks give peak {peak_k}")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        _, out = engine.render_many(state, events, **static)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = float(out.abs().max())
        check(bool(torch.isfinite(out).all()) and tuple(out.shape) == (n_blocks, 2, B),
              f"{label}: output {tuple(out.shape)}")
        missing = [n for n in path if not counts[n]]
        check(not missing, f"{label}: never launched: {missing}")
        check(counts["fbws_bank"] == 0 and counts["ws4_bank"] == 0,
              f"{label}: a family at os_mode {os_mode} took a 4x kernel: {counts}")
        per_affine = counts["affine1_bank"] / n_blocks
        check(per_affine == 26 + OS_EXTRA_AFFINE[os_mode],
              f"{label}: {per_affine} affine1_bank launches a block, not "
              f"{26 + OS_EXTRA_AFFINE[os_mode]}")
        rows = launch_rows(lambda: engine.render_many(
            state, {k: v[:1] for k, v in events.items()}, **static))
        n_voices = sum(KIT.values())
        print(f"{label}: {n_voices} voices x {n_blocks} blocks {wall:.4f} s "
              f"({wall / n_blocks * 1e3:.3f} ms/block), peak {peak:.4f}; aggregate RTF "
              f"{n_voices * n_blocks * B / SR / wall:.1f} on {card}; affine1_bank "
              f"{per_affine:g} launches a block, rows of each launch in one block "
              f"{json.dumps(rows['affine1_bank'])}")
        print(f"{label} launches per block: "
              f"{json.dumps({n: c / n_blocks for n, c in counts.items()})}")
        with plain_versions():
            _, out_p = engine.render_many(head_state, head, **static)
        torch.cuda.synchronize()
        err = max_err(out_k, out_p)
        print(f"{label}: {n_cmp} blocks (every kick, snare and bass voice struck at the "
              f"first sample), kernels vs plain versions: max err {err:.3e} (tol "
              f"{RENDER_TOL:g}), peak {peak_k:.4f}")
        check(err <= RENDER_TOL, f"{label}: kernel render differs from the plain render by "
              f"{err}")
        if result is None:
            result = counts, rows
    return result


def os_effect_cases(dev):
    """Phase 15 (b)'s cases: ``(label, run)``, ``run()`` giving ``(state,
    out)`` of one block from fresh state at ``os_mode`` 1 and 2."""
    import torch

    from libgooey_tpu_torch.effects import compressor, saturation, waveshaper
    from libgooey_tpu_torch.effects import feedback_waveshaper as fbws
    from libgooey_tpu_torch.ops.oversample import OversamplerState

    rs = np.random.RandomState(SEED)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    x = t(rs.uniform(-1.0, 1.0, (2, B)) * 1.2)
    sc = t(rs.uniform(-1.0, 1.0, (2, B)) * (rs.rand(2, B) > 0.5) * 1.5)
    drive = t(rs.uniform(2.0, 12.0, (2, B)))
    bank_x = t(rs.uniform(-0.8, 0.8, (512, B)))
    bank_drive = t(rs.uniform(1.0, 10.0, (512, B)))
    comp = (-30.0, 6.0, 2.0, 60.0, 1.0)
    cases = []
    for m in (1, 2):
        cases += [
            (f"saturation [2, {B}] os {m}", lambda m=m: saturation.process_block(
                saturation.init_state(SR, 0.6, 0.5, 1.0, device=dev), x, [0.6, 0.5, 1.0],
                sample_rate=SR, os_mode=m)),
            (f"compressor [2, {B}] os {m}", lambda m=m: compressor.process_block(
                compressor.init_state(SR, *comp, device=dev), x, list(comp), sample_rate=SR,
                os_mode=m)),
            (f"compressor keyed [2, {B}] os {m}", lambda m=m: compressor.process_block(
                compressor.init_state(SR, *comp, device=dev), x, list(comp), sample_rate=SR,
                sidechain=sc, os_mode=m)),
            (f"feedback_waveshaper [2, {B}] os {m}", lambda m=m: fbws.process_block(
                fbws.FBShaperState.init((2,), dev), x, drive, 0.0, 0.3, 1.0, SR,
                feedback_path=False, os_mode=m)),
            (f"waveshaper.process_bank [512, {B}] os {m}", lambda m=m: waveshaper.process_bank(
                OversamplerState.init(512, dev), bank_x, bank_drive, m)),
        ]
    return cases


def phase_os_effects(dev, card):
    """Phase 15 (b): the effects at ``os_mode`` 1 and 2, each one block with
    its kernels (its launches counted) and again on the plain versions.
    Returns the os-2 saturation's ``affine1_bank`` rows."""
    import torch

    from libgooey_tpu_torch.ops import kernels

    bus_rows = None
    for label, run in os_effect_cases(dev):
        run()   # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        st, out = run()
        torch.cuda.synchronize()
        counts = {n: c for n, c in kernels.launch_counts().items() if c}
        with plain_versions():
            st_p, out_p = run()
        err = max(max_err(out, out_p), max_err(torch.utils._pytree.tree_leaves(st),
                                                 torch.utils._pytree.tree_leaves(st_p)))
        peak = float(out.abs().max())
        print(f"os effect {label}: launches {json.dumps(counts)}, peak {peak:.4f}, kernels vs "
              f"plain versions (output and state) max err {err:.3e} (tol {RENDER_TOL:g})")
        check(bool(torch.isfinite(out).all()) and peak > 1e-3, f"{label}: peak {peak}")
        check(err <= RENDER_TOL, f"{label}: differs from the plain versions by {err}")
        need = ["affine1_bank"] if " os 2" in label or "process_bank" not in label else []
        need += {"compressor": ["env_follower_block"],
                 "feedback_waveshaper": ["env_follow_bank"]}.get(label.split()[0], [])
        check(all(counts.get(n, 0) > 0 for n in need), f"{label}: {need} not all launched")
        if bus_rows is None and label.startswith("saturation") and label.endswith("os 2"):
            bus_rows = launch_rows(run)["affine1_bank"]
    return bus_rows


def phase_os_affine(dev, card, kit_rows, bus_rows):
    """Phase 15 (c): ``affine1_bank`` at the oversampler's row counts, an
    allpass section's arguments (no floor, a constant -a, inputs from the
    seed), bit-equal to its plain version, with its device time, its plain
    version's, its bound and its launches a block on (a)'s and (b)'s paths."""
    import torch

    from libgooey_tpu_torch.ops import bank_kernels as bk
    from libgooey_tpu_torch.ops.oversample import STAGE1

    rs = np.random.RandomState(SEED)
    for rows, what in OS_AFFINE_ROWS.items():
        b = torch.full((rows, B), -float(np.float32(STAGE1[0])), device=dev)
        c = torch.as_tensor(rs.uniform(-1.0, 1.0, (rows, B)).astype(np.float32), device=dev)
        y0 = torch.as_tensor(rs.uniform(-0.5, 0.5, rows).astype(np.float32), device=dev)
        args = (None, b, c, y0)
        got = bk.affine1_bank(*args)
        want = bk.affine1_bank_plain(*args)
        same = same_bits(got, want)
        for _ in range(3):
            bk.affine1_bank(*args)
        ms = device_ms(lambda: bk.affine1_bank(*args), 20)
        if ms is None:
            ms = event_ms(lambda: bk.affine1_bank(*args), 20)
        plain_ms = cuda_ms(lambda: bk.affine1_bank_plain(*args), 1)
        bms, bound_by = bound_ms("affine1_bank", args, {}, got)
        per_block = (bus_rows if rows == 4 else kit_rows).get(str(rows), 0)
        print(f"os affine1_bank [{rows}, {B}] ({what}): bit-equal {same}; device "
              f"{ms * 1e3:.2f} us/call, plain {plain_ms * 1e3:.1f} us/call, bound "
              f"{bms * 1e3:.4f} us ({bound_by}); {per_block} launches a block on its path "
              f"on {card}")
        check(same, f"affine1_bank at {rows} rows: not bit-equal to its plain version")


def phase_examples(dev, card):
    """Phase 15 (d): every port example on the card at its JAX ``quick``
    length (the themed tours at 0.5 s), writing into a temporary directory;
    each WAV finite and audible but ``loops_and_clips``' (its clip waits for
    the next bar, past 0.5 s, as in the JAX example), the scope's frame
    drawn; each one's wall seconds, and the
    oversampler validation's alias reduction beside its throughput."""
    import importlib
    import io
    import shutil
    import tempfile

    import torch

    from libgooey_tpu_torch.io_wav import read_wav

    tmp = tempfile.mkdtemp(prefix="gooey_examples_")
    walls = {}
    try:
        for name in EXAMPLES_QUICK + EXAMPLES_SECONDS + EXAMPLES_OTHER:
            mod = importlib.import_module(f"libgooey_tpu_torch.examples.{name}")
            wav = f"{tmp}/{name}.wav"
            if name in EXAMPLES_QUICK:
                call = lambda: mod.main(out_path=wav, quick=True)
            elif name in EXAMPLES_SECONDS:
                call = lambda: mod.main(seconds=EXAMPLE_SECONDS, out_path=wav)
            elif name in ("bounce", "antialias_validation"):
                call = lambda: mod.main(quick=True, out_dir=tmp)
            elif name == "aliasing_plots":
                call = lambda: mod.main(csv_path=f"{tmp}/alias.csv", quick=True, wav_path=wav)
            else:
                call = lambda: mod.main(out_path=f"{tmp}/scope.txt", quick=True)
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                res = call()
            torch.cuda.synchronize()
            walls[name] = round(time.perf_counter() - t0, 3)
            if name == "scope":
                text = open(res).read()
                check("┌" in text and "master" in text and "dB" in text,
                      "scope example: no frame")
                continue
            if name == "antialias_validation":
                a, ns = res["alias_db"], res["ns_per_sample"]
                print(f"example antialias_validation: alias reduction 2x {a[2]:.2f} dB, 4x "
                      f"{a[4]:.2f} dB; {ns[1]:.3f} / {ns[2]:.3f} / {ns[4]:.3f} ns/sample at "
                      f"1x / 2x / 4x on {card}")
                check(a[2] >= 20.0 and a[4] >= 20.0, f"antialias_validation: {a}")
            paths = res if name == "bounce" else [
                f"{tmp}/gooey_oversampled-4x-sweep.wav" if name == "antialias_validation"
                else wav]
            for path in paths:
                audio, sr = read_wav(path)
                peak = float(np.abs(audio).max())
                check(np.all(np.isfinite(audio)) and audio.shape[-1] >= 2048,
                      f"{name} example: {path} {audio.shape}")
                check(name == "loops_and_clips" or peak > 1e-5,
                      f"{name} example: silent ({path})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"examples on the card, wall seconds: {json.dumps(walls)}; {sum(walls.values()):.1f} s "
          f"in all on {card}")


def phase_os_modes(dev, card):
    """Phase 15: (a) the kit at os_mode 2 and 1, (b) the effects at 1 and 2,
    (c) ``affine1_bank`` at the oversampler's row counts, (d) the examples.
    Returns (a)'s os-2 counts."""
    parts, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        parts[name] = round(now - t_part, 1)
        t_part = now

    counts, rows = phase_os_kit(dev, card)
    part("(a) kit")
    bus_rows = phase_os_effects(dev, card)
    part("(b) effects")
    phase_os_affine(dev, card, rows["affine1_bank"], bus_rows)
    part("(c) affine1_bank")
    phase_examples(dev, card)
    part("(d) examples")
    print(f"os_modes seconds by part: {json.dumps(parts)}")
    return counts


# --- phase 16: the sharded render over torch.distributed ----------------------------

MESH_RANKS = 2            # gloo ranks sharing cuda:0
N_MESH_BLOCKS = 16        # (a), (c): blocks of full_kit_4096_bus7
N_MESH_SCOPE = 4          # (b): blocks of the full product scope, and of the sources
N_MESH_PROFILE = 4        # (a), (d), (e): blocks of rank 0 under the profiler
MESH_SOURCES = 4          # (b): the sources' buses
N_MESH_WHOLE = 8          # (d): blocks of the eight-family kit
N_MESH_RACKS = 16         # (e): blocks of the granulator and the sampler
#: (d): the poly's synths (85 in phase 11(b) does not halve), and rank 1's
#: synth that takes the LFO route, half of the chord and the release
MESH_POLY = 86
MESH_POLY_SLOT = 60
MESH_CHORD = {0: (48, 52, 55, 59), MESH_POLY_SLOT: (57, 60, 64)}
MESH_RELEASE_BLOCK = 2
#: (d): the poly's affine1_bank launches at its lanes a block (its
#: oscillators' phases; phase 11(b)'s "poly's 4")
MESH_POLY_AFFINE = 4
MESH_TOL = OUT_TOL
#: the least peak of a phase-16 render: the kit's gains are 1/V, so bus7's
#: 64 blocks peak near 1.3e-3 (phase 7) and its first 16 lower
MESH_PEAK = 1e-4
#: the sizes a rank takes from the parent, so that a rehearsal on the CPU
#: which shrinks them in the parent shrinks the ranks' too
MESH_SIZES = ("B", "KIT", "N_MESH_BLOCKS", "N_MESH_SCOPE", "N_MESH_PROFILE", "WHOLE_KIT",
              "MESH_POLY", "MESH_POLY_SLOT", "MESH_CHORD", "N_MESH_WHOLE", "G_LANES",
              "S_VOICES", "GRAIN_SOURCE", "ARENA_FRAMES", "N_MESH_RACKS")
#: phase 16's renders: (a)'s, (b)'s two, (d)'s and (e)'s; the ones timed
MESH_PARTS = ("bus7", "scope", "sources", "whole", "racks")
MESH_TIMED = ("bus7", "whole", "racks")


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def mesh_whole_inputs(dev):
    """(d): phase 11(b)'s eight-family kit with poly at ``MESH_POLY``
    synths, ``WHOLE_ROUTES`` and LFO 3 on synth ``MESH_POLY_SLOT``'s
    filter cutoff, a chord struck on synths 0 and ``MESH_POLY_SLOT`` at the
    first sample and the second released at block ``MESH_RELEASE_BLOCK``,
    every bank off the kit path (the JAX package's GSPMD render)."""
    from libgooey_tpu_torch import music

    kit = dict(WHOLE_KIT, poly=MESH_POLY)
    state, events, static = whole_kit_inputs(dev, N_MESH_WHOLE, kit)
    for slot, notes in MESH_CHORD.items():
        for j, note in enumerate(notes):
            lane = slot * 6 + j
            # struck once, at the first sample: no sequenced step on the lane
            events["poly_off"][:, lane], events["poly_vel"][:, lane] = B, 0.0
            events["poly_off"][0, lane], events["poly_vel"][0, lane] = 0, 0.9
            events["poly_freq"][0, lane] = music.midi_to_freq(note)
            if slot == MESH_POLY_SLOT:
                events["poly_rel"][MESH_RELEASE_BLOCK, lane] = 0
    route = (3, "poly", MESH_POLY_SLOT, "filter_cutoff", 1.0)
    return state, events, dict(static, lfo_routes=static["lfo_routes"] + (route,),
                               fused_banks=False)


def mesh_rack_inputs(dev):
    """(e): phase 10's states as its comparison takes them (``grain_inputs(dev,
    compare=True)``: the drive engaged, the arena filled) and per block a
    steal of a main lane of rank 0 into a release-pool lane of rank 1, a
    spawn reusing the stolen lane, a spawn on rank 1 and a sampler start on
    a voice of each rank.  Returns ``((grain, sampler), [(spawns, starts,
    block start)])``."""
    from libgooey_tpu_torch.instruments import granulator as gran
    from libgooey_tpu_torch.instruments import sampler as samp

    half, per = G_LANES // 2, gran.TOTAL
    rs = np.random.RandomState(4)
    blocks = []
    for i in range(N_MESH_RACKS):
        g = gran.SpawnEvents.empty()._asdict()
        inst = i % (half // per)
        victim = inst * per + 5
        for k, (slot, copy_from, off) in enumerate(
                ((half + gran.MAX_GRAINS + i % gran.RELEASE_POOL, victim, 30), (victim, -1, 30),
                 (half + inst * per + 10, -1, 200))):
            g["slot"][k], g["copy_from"][k], g["offset"][k] = slot, copy_from, off
            if copy_from >= 0:
                g["rel_total"][k] = 176.0
            else:
                g["duration"][k], g["src_pos"][k] = 20000.0, rs.uniform(0, 1 << 14)
                g["step"][k], g["shape"][k], g["vel"][k] = 1.3, 2.0, 0.8
        s = samp.StartEvents.empty()._asdict()
        for k, voice in enumerate((i % (S_VOICES // 2), S_VOICES // 2 + i % (S_VOICES // 2))):
            s["voice"][k], s["offset"][k] = voice, 100 + 50 * k
            s["base"][k] = rs.randint(0, ARENA_FRAMES - 30000)
            s["frames"][k], s["increment"][k], s["velocity"][k] = 30000.0, 1.25, 0.7
        blocks.append((gran.SpawnEvents(**g), samp.StartEvents(**s), i * B))
    return grain_inputs(dev, compare=True), blocks


def mesh_inputs(dev, part):
    """State, per-block events and statics of phase 16's renders, the same
    in the parent and in every rank: (a)/(c) full_kit_4096_bus7 as phase 7
    renders it, (b) with an LFO route on kick 768 and the compressor keyed
    from kick 640 (both rows of rank 1: the kick's 1,024 voices split 512 /
    512) and over the kit's level, (b, sources) the kit with
    ``collect_sources`` into four buses (each voice to one, from the seed);
    in (b) every voice is also struck at the first sample; (d)
    :func:`mesh_whole_inputs`, (e) :func:`mesh_rack_inputs` (no statics)."""
    if part == "racks":
        return mesh_rack_inputs(dev) + ({},)
    if part == "sources":
        state, events, static = kit_inputs(dev, N_MESH_SCOPE)
        nv = sum(KIT.values())
        pick = np.random.RandomState(SEED).randint(0, MESH_SOURCES, nv)
        events["source_matrix"] = np.tile(
            np.eye(MESH_SOURCES, dtype=np.float32)[pick].T, (N_MESH_SCOPE, 1, 1))
        static = dict(static, collect_sources=True)
    elif part == "scope":
        state, events, static = bus_inputs(dev, N_MESH_SCOPE, order=FX_ORDER_FULL,
                                           over={"compressor": COMPARE_FULL["compressor"]})
        events.update(lfo_phase=np.tile(np.linspace(0.0, 0.7, 8, dtype=np.float32),
                                         (N_MESH_SCOPE, 1)),
                      lfo_inc=np.full((N_MESH_SCOPE, 8), 2.0 / SR, np.float32),
                      lfo_amount=np.full((N_MESH_SCOPE, 8), 0.9, np.float32),
                      lfo_offset=np.zeros((N_MESH_SCOPE, 8), np.float32))
        nk = KIT["kick"]
        static = dict(static, lfo_routes=((0, "kick", nk * 3 // 4, "frequency", 0.8),),
                      sidechain_voice=nk // 2 + nk // 8)
    elif part == "whole":
        state, events, static = mesh_whole_inputs(dev)
    else:
        state, events, static = bus_inputs(dev, N_MESH_BLOCKS, order=FX_ORDER_FULL)
    if part in ("scope", "sources"):   # every voice also struck at the first sample
        for kind in KIT:
            events[kind + "_off"][0], events[kind + "_vel"][0] = 0, 0.8
    n = len(events["block_start"])
    return state, [{k: v[i] for k, v in events.items()} for i in range(n)], static


def rack_step(mesh=None):
    """One block of (e): the granulator, then the sampler, each on
    ``mesh`` (None: the single process); returns ``((grain, sampler), out
    [B], out [2, B])``."""
    from libgooey_tpu_torch.core.smoother import smoothing_coeff
    from libgooey_tpu_torch.instruments import granulator as gran
    from libgooey_tpu_torch.instruments import sampler as samp

    coeff = smoothing_coeff(SR)

    def step(states, ev):
        (gs, ss), (gev, sev, start) = states, ev
        gs, g = gran.render_block(gs, gev, start, sample_rate=SR, block_size=B,
                                  smooth_coeff=coeff, mesh=mesh)
        ss, s = samp.render_block(ss, sev, start, sample_rate=SR, block_size=B, mesh=mesh)
        return (gs, ss), g, s

    return step


def single_step(part, static):
    """One block of a phase-16 render in this process."""
    from libgooey_tpu_torch.engine import engine

    if part == "racks":
        return rack_step()
    return lambda st, ev: engine._render_all(st, engine._events_to(ev, st["pan"].current.device),
                                             **static)


def render_single(state, blocks, step):
    """The single-process render of phase 16's blocks: ``(state, outputs
    stacked over blocks)``."""
    import torch

    outs = []
    for ev in blocks:
        state, *rest = step(state, ev)
        outs.append(rest)
    sync(rest[0].device)
    return state, [torch.stack([o[i] for o in outs]) for i in range(len(outs[0]))]


def to_cpu(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_cpu(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


def state_err(a, b) -> float:
    """Worst :func:`case_rel_err` over two engine states' entries, or two
    tuples of rack states."""
    if isinstance(a, tuple):
        return max(case_rel_err(x, y) for x, y in zip(a, b))
    check(a.keys() == b.keys(), f"state keys differ: {sorted(a)} vs {sorted(b)}")
    return max(case_rel_err(a[k] if isinstance(a[k], tuple) else (a[k],),
                            b[k] if isinstance(b[k], tuple) else (b[k],)) for k in a)


def mesh_part(mesh, part, state, blocks, static):
    """One rank's placement, step and gather of a phase-16 render: ``(local
    state, local events, step, gather)``."""
    from libgooey_tpu_torch.engine import engine
    from libgooey_tpu_torch.parallel import mesh as pmesh

    if part == "racks":
        return (tuple(pmesh.shard_rack_state(x, mesh) for x in state), blocks, rack_step(mesh),
                lambda local: tuple(pmesh.gather_rack_state(x, mesh) for x in local))
    kinds = static["kinds"]
    local = pmesh.shard_engine_state(state, blocks[0], kinds, mesh)
    events = [pmesh.shard_events(ev, kinds, mesh) for ev in blocks]
    if part == "whole":        # poly: the JAX package's GSPMD path
        def step(st, ev):
            return engine._render_all(st, ev, mesh=mesh, **static)
    else:
        def step(st, ev):
            return pmesh.render_all_sharded(st, ev, mesh=mesh, **static)
    return local, events, step, lambda st: pmesh.gather_engine_state(st, kinds, mesh)


def mesh_render(mesh, part, local, events, step, timed=False):
    """One rank's render of a part's blocks: warm up on the first 2 blocks
    (``timed``), then with the launch counts at 0 render every block, each
    rank starting together; returns the outputs stacked, the wall seconds,
    the counts, ``affine1_bank``'s and ``svf_bank``'s calls by rows
    (``last_calls``) and the final local state."""
    import torch
    import torch.distributed as dist

    from libgooey_tpu_torch.ops import kernels

    if timed:
        st = local
        for ev in events[:2]:
            st = step(st, ev)[0]
    sync(mesh.device)
    dist.barrier(group=mesh.group)
    kernels.reset_launch_counts()
    outs = []
    with last_calls(("affine1_bank", "svf_bank")) as calls:
        t0 = time.perf_counter()
        for ev in events:
            local, *rest = step(local, ev)
            outs.append(rest)
        sync(mesh.device)
        wall = time.perf_counter() - t0
    rows = {f"{name}[{n}]": c for (name, n), (_, _, c) in calls.items()}
    return {"outs": [torch.stack([o[i] for o in outs]).cpu() for i in range(len(outs[0]))],
            "wall": wall, "counts": kernels.launch_counts(), "rows": rows, "local": local}


def mesh_profile(mesh, local, events, step):
    """``N_MESH_PROFILE`` more blocks from ``local``, rank 0 under
    torch.profiler (every rank renders them: the sums need all): the wall,
    the all-reduces' host ms (``Mesh.all_reduce`` traced as one span) and
    the device kernels' names and counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from libgooey_tpu_torch.ops import kernels
    from libgooey_tpu_torch.parallel import mesh as pmesh

    real = pmesh.Mesh.all_reduce

    def traced(self, t):
        with record_function("mesh_all_reduce"):
            return real(self, t)

    pmesh.Mesh.all_reduce = traced
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if mesh.device.type == "cuda"
                                     else [])
    ctx = profile(activities=acts) if mesh.rank == 0 else contextlib.nullcontext()
    try:
        with ctx as prof:
            t0 = time.perf_counter()
            for ev in events[:N_MESH_PROFILE]:
                local = step(local, ev)[0]
            sync(mesh.device)
            wall = time.perf_counter() - t0
    finally:
        pmesh.Mesh.all_reduce = real
    if prof is None:
        return None
    table = prof.key_averages()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans = [e for e in table if e.key == "mesh_all_reduce" and e.device_type == cpu]
    reduce_ms = sum(e.cpu_time_total for e in spans) / 1e3
    n_reduce = sum(e.count for e in spans)
    # the device's ops, less the spans that annotate its timeline (this one's
    # and gloo's own)
    device = [e for e in table if e.device_type == cuda
              and not e.key.startswith(("mesh_all_reduce", "gloo:"))]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    hand = collections.Counter()
    for e in device:
        name = kernel_symbol(e.key)
        if name.startswith(kernels.KERNELS):
            hand[name] += e.count
    return {"wall_ms": wall * 1e3, "reduce_ms": reduce_ms, "n_reduce": n_reduce,
            "busy_ms": busy_ms, "device_ops": sum(e.count for e in device), "kernels": dict(hand)}


def kernel_symbol(key: str) -> str:
    """A device kernel's bare name from its traced signature."""
    key = key.replace("(anonymous namespace)::", "")
    key = key[len("void "):] if key.startswith("void ") else key
    return key.split("(")[0].split("<")[0].split("::")[-1]


def mesh_rank(rank, size, tmp, device, sizes):
    """One rank of phase 16 (a), (b), (d) and (e): gloo on ``device`` (the
    parent's card), the parent's ``sizes``, phase 16's renders, its results
    saved to ``tmp``."""
    import torch
    import torch.distributed as dist

    from libgooey_tpu_torch.ops import _build
    from libgooey_tpu_torch.parallel import mesh as pmesh

    globals().update(sizes)
    dev = torch.device(device)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init", rank=rank,
                            world_size=size)
    try:
        if dev.type == "cuda":
            _build.build()          # the parent's build, found by its sources' hash
            _build.load_library()
        mesh = pmesh.make_mesh(size, [dev] * size)
        out = {}
        for part in MESH_PARTS:
            state, blocks, static = mesh_inputs(dev, part)
            local, events, step, gather = mesh_part(mesh, part, state, blocks, static)
            res = mesh_render(mesh, part, local, events, step, timed=part in MESH_TIMED)
            res["state"] = to_cpu(gather(res["local"]))
            if static.get("collect_sources"):
                voices = [pmesh.gather_voices(v, p, res["local"], static["kinds"], mesh)
                          for v, p in zip(res["outs"][1], res["outs"][2])]
                res["voices"] = torch.stack([v[0] for v in voices]).cpu()
                res["peaks"] = torch.stack([v[1] for v in voices]).cpu()
            if part in MESH_TIMED:
                res["profile"] = mesh_profile(mesh, res["local"], events, step)
            del res["local"]
            out[part] = res
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def mesh_compare(label, got, want, want_state, ranks, part, shared=slice(None)):
    """Rank 0's outputs and gathered state against the single-process
    render, the ranks' outputs bit for bit; returns ``(errs, state err,
    peak)``."""
    import torch

    check(all(same_bits(r[part]["outs"][shared], got["outs"][shared]) for r in ranks[1:]),
          f"{label}: the ranks' outputs differ")
    errs = [max_err(g, w) for g, w in zip(got["outs"][shared], want[shared])]
    s_err = state_err(got["state"], to_cpu(want_state))
    check(all(bool(torch.isfinite(g).all()) for g in got["outs"]),
          f"{label}: output is not finite")
    peak = float(want[0].abs().max())
    check(peak > MESH_PEAK, f"{label}: the render is silent (peak {peak})")
    check(max(errs) <= MESH_TOL and s_err <= STATE_TOL,
          f"{label}: off the single-process render (outputs {errs}, state {s_err})")
    return errs, s_err, peak


def mesh_walls(label, numbers, key, ranks, part, n, single_wall, card, spawn_s=None):
    """Print a timed part's walls a block and rank 0's traced block."""
    prof = ranks[0][part]["profile"]
    numbers.update({f"wall_{key}": ranks[0][part]["wall"] / n * 1e3,
                    f"wall_single_{key}": single_wall / n * 1e3,
                    f"reduce_share_{key}": prof["reduce_ms"] / prof["wall_ms"]})
    spawned = "" if spawn_s is None else f"; spawn and both ranks' work {spawn_s:.1f} s"
    print(f"{label}: {MESH_RANKS} gloo ranks on one card, {n} blocks: rank 0 "
          f"{numbers[f'wall_{key}']:.3f} ms/block (rank 1 "
          f"{ranks[1][part]['wall'] / n * 1e3:.3f}), the single-process render "
          f"{numbers[f'wall_single_{key}']:.3f} ms/block{spawned}; on {card}")
    print(f"{label} rank 0 traced over {N_MESH_PROFILE} blocks: wall "
          f"{prof['wall_ms'] / N_MESH_PROFILE:.3f} ms/block, all-reduces a block: "
          f"{prof['n_reduce'] / N_MESH_PROFILE:.2f}, taking "
          f"{prof['reduce_ms'] / N_MESH_PROFILE:.3f} ms/block of host time, a share of "
          f"{numbers[f'reduce_share_{key}']:.3f} of the wall; device busy "
          f"{prof['busy_ms'] / N_MESH_PROFILE:.3f} ms/block in "
          f"{prof['device_ops'] / N_MESH_PROFILE:.0f} device ops; on {card}")
    print(f"{label} rank 0's hand-written kernels in the trace, per block: " + json.dumps(
        {k: c / N_MESH_PROFILE for k, c in sorted(prof["kernels"].items())}))


def phase_mesh(dev, card):
    """Phase 16: (a) full_kit_4096_bus7 on two gloo ranks sharing the card,
    (b) the full product scope and the sources on them, (c) a one-rank NCCL
    group, (d) the eight-family kit with poly (the JAX package's GSPMD
    render), (e) the granulator and the sampler at phase 10's widths; each
    against the single-process render of the same inputs.  Returns the
    printed numbers."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from libgooey_tpu_torch.ops import bank_kernels as bk
    from libgooey_tpu_torch.parallel import mesh as pmesh

    # both ranks run on this host: gloo talks over the loopback device
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    single, single_wall = {}, {}
    for part in MESH_PARTS:
        state, blocks, static = mesh_inputs(dev, part)
        step = single_step(part, static)
        if part in MESH_TIMED:
            render_single(state, blocks[:2], step)    # warm-up
            t0 = time.perf_counter()
        single[part] = render_single(state, blocks, step)
        if part in MESH_TIMED:
            single_wall[part] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(mesh_rank, args=(MESH_RANKS, tmp, str(dev),
                                  {k: globals()[k] for k in MESH_SIZES}),
                 nprocs=MESH_RANKS, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                 for r in range(MESH_RANKS)]
    nv = sum(KIT.values())
    path = bk.KERNELS + ("bus_chain", "plate_block")
    numbers = {}
    for part in ("bus7", "scope", "sources"):
        want_state, want = single[part]
        want = [w.cpu() for w in want]
        got = ranks[0][part]
        n = got["outs"][0].shape[0]
        # the sources' local voices and peaks differ by rank: their sums do not
        shared = slice(0, 1) if part == "sources" else slice(None)
        label = f"phase 16 ({'a' if part == 'bus7' else 'b'}) {part}, {MESH_RANKS} gloo ranks"
        errs, s_err, peak = mesh_compare(label, got, want, want_state, ranks, part, shared)
        extra = ""
        if part == "sources":
            _, (_, voices, peaks) = single[part]
            v_err = max(max_err(got["voices"], voices.cpu()), max_err(got["peaks"], peaks.cpu()))
            check(v_err <= MESH_TOL, f"{label}: gathered voices or peaks off by {v_err}")
            extra = f", gathered voices and peaks {v_err:.3e}"
        if part == "scope":
            gain = float(got["state"]["fx_compressor"].gain.min())
            check(gain < 0.99, f"{label}: the sidechained compressor never engaged ({gain})")
            extra = f", the keyed compressor's gain down to {gain:.4f}"
        print(f"{label}: {nv} voices x {n} blocks, rank 0 vs the "
              f"single-process render: outputs {' / '.join(f'{e:.3e}' for e in errs)} (tol "
              f"{MESH_TOL:g}, peak {peak:.4f}), gathered state {s_err:.3e} (tol {STATE_TOL:g})"
              f"{extra}; "
              f"the {MESH_RANKS} ranks' outputs equal bit for bit")
        counts = got["counts"]
        if part == "bus7":
            check(all(counts[k] > 0 for k in path) and counts["mix_bank"] == n
                  and counts["bus_chain"] == n and counts["plate_block"] == n,
                  f"{label}: a kernel of the path never launched on rank 0: {counts}")
        print(f"{label} rank 0 launches: {json.dumps(counts)}")
    mesh_walls("phase 16 (a)", numbers, "a", ranks, "bus7", N_MESH_BLOCKS, single_wall["bus7"],
               card, spawn_s)

    # (d) the eight families with poly, off the kit path (the GSPMD render)
    label = f"phase 16 (d) whole kit, {MESH_RANKS} gloo ranks"
    want_state, want = single["whole"]
    got = ranks[0]["whole"]
    errs, s_err, peak = mesh_compare(label, got, [w.cpu() for w in want], want_state, ranks,
                                     "whole")
    kit = dict(WHOLE_KIT, poly=MESH_POLY)
    local_lanes = MESH_POLY * 6 // MESH_RANKS
    counts, rows = got["counts"], got["rows"]
    n = N_MESH_WHOLE
    check(all(counts[k] == n for k in ("mix_bank", "bus_chain", "plate_block"))
          and rows.get(f"affine1_bank[{local_lanes}]", 0) == MESH_POLY_AFFINE * n
          and rows.get(f"svf_bank[{local_lanes}]", 0) == n
          and rows.get(f"affine1_bank[{MESH_POLY // MESH_RANKS}]", 0) == n,
          f"{label}: the poly's lanes' and route's kernels or the mix and bus not as expected "
          f"on rank 0: "
          f"{counts}, {rows}")
    poly = got["state"]["poly"]
    slot = MESH_POLY_SLOT * 6
    check(bool((poly.release_sample[slot:slot + len(MESH_CHORD[MESH_POLY_SLOT])]
                == MESH_RELEASE_BLOCK * B).all()),
          f"{label}: synth {MESH_POLY_SLOT}'s release did not land on rank 1's lanes")
    print(f"{label}: {json.dumps(kit)} (poly at {MESH_POLY} synths, "
          f"{MESH_POLY * 6} lanes: phase 11(b)'s 85 do not halve), {sum(kit.values())} voices "
          f"in the mix, LFO routes {[r[1:3] for r in WHOLE_ROUTES]} and poly synth "
          f"{MESH_POLY_SLOT}'s filter cutoff (rank 1's), a chord on synths 0 and "
          f"{MESH_POLY_SLOT}, synth {MESH_POLY_SLOT} released at block {MESH_RELEASE_BLOCK}; "
          f"{n} blocks, rank 0 vs the single-process render: outputs "
          f"{' / '.join(f'{e:.3e}' for e in errs)} (tol {MESH_TOL:g}, peak {peak:.4f}), "
          f"gathered state {s_err:.3e} (tol {STATE_TOL:g}); the ranks' outputs equal bit for bit")
    print(f"{label} rank 0 launches: {json.dumps(counts)}; by rows: {json.dumps(rows)}")
    mesh_walls("phase 16 (d)", numbers, "d", ranks, "whole", n, single_wall["whole"], card)

    # (e) the racks: lanes and voices split, the lane sums all-reduced
    label = f"phase 16 (e) racks, {MESH_RANKS} gloo ranks"
    want_state, want = single["racks"]
    got = ranks[0]["racks"]
    errs, s_err, peak = mesh_compare(label, got, [w.cpu() for w in want], want_state, ranks,
                                     "racks")
    counts, n = got["counts"], N_MESH_RACKS
    rack = ("grain_read_cubic", "sampler_read_linear", "ws4_bank", "affine1_bank")
    check(all(counts[k] == n for k in rack),
          f"{label}: the racks' kernels not once a block on rank 0: {counts}")
    print(f"{label}: {G_LANES} grain lanes and {S_VOICES} sampler voices "
          f"({G_LANES // MESH_RANKS} and {S_VOICES // MESH_RANKS} a rank), a steal across "
          f"ranks, two spawns and two starts a block; {n} blocks, rank 0 vs the single-process "
          f"render: granulator {errs[0]:.3e}, sampler {errs[1]:.3e} (tol {MESH_TOL:g}, peak "
          f"{peak:.4f}), gathered state {s_err:.3e} (tol {STATE_TOL:g}); the ranks' outputs "
          f"equal bit for bit")
    print(f"{label} rank 0 launches: {json.dumps({k: counts[k] for k in counts if counts[k]})}")
    mesh_walls("phase 16 (e)", numbers, "e", ranks, "racks", n, single_wall["racks"], card)

    # (c) a one-rank NCCL group (gloo in a rehearsal on the CPU): its
    # all-reduce is the identity
    state, blocks, static = mesh_inputs(dev, "bus7")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{tmp}/init", rank=0, world_size=1)
        try:
            mesh = pmesh.make_mesh(1, [dev])
            local, events, step, _ = mesh_part(mesh, "bus7", state, blocks, static)
            c = mesh_render(mesh, "bus7", local, events, step, timed=True)
        finally:
            dist.destroy_process_group()
    _, want = single["bus7"]
    check(same_bits(c["outs"], [w.cpu() for w in want]),
          "phase 16 (c): the one-rank NCCL render differs from the single-process render")
    check(all(c["counts"][k] > 0 for k in path) and c["counts"]["mix_bank"] == N_MESH_BLOCKS,
          f"phase 16 (c): a kernel of the path never launched: {c['counts']}")
    numbers["wall_c"] = c["wall"] / N_MESH_BLOCKS * 1e3
    print(f"phase 16 (c): a one-rank NCCL group, {N_MESH_BLOCKS} blocks, "
          f"{numbers['wall_c']:.3f} ms/block, equal to the single-process render bit for bit; "
          f"launches {json.dumps(c['counts'])}; on {card}")
    return numbers


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", help="write a torch.profiler table here")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from libgooey_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"build: {lib.name} ready in {time.perf_counter() - t0:.2f} s")

    def clocked(phase, *a):
        t = time.perf_counter()
        out = phase(*a)
        print(f"{phase.__name__}: {time.perf_counter() - t:.1f} s")
        return out

    try:
        kernels = clocked(phase_kernels, dev)
        phase_rng(dev)
        with (open(args.profile, "w") if args.profile else contextlib.nullcontext()) as prof:
            clocked(phase_slice, dev, card, prof)
            clocked(phase_kit, dev, card, prof)
            clocked(phase_bus, dev, card, prof)
            counts = clocked(phase_full_bus, dev, card, prof)
            counts.update(clocked(phase_product, dev, card, prof))
            clocked(phase_engine, dev, card, prof)
            grain = clocked(phase_grain, dev, card, prof)
            clocked(phase_whole_engine, dev, card)
            clocked(phase_whole_kit, dev, card, prof)
            loops = clocked(phase_loops, dev, card, prof)
            clocked(phase_graph, dev, card, loops, prof)
            gooey = clocked(phase_gooey, dev, card, prof)
            capi_counts = clocked(phase_capi, dev, card, prof)
            os_counts = clocked(phase_os_modes, dev, card)
            clocked(phase_mesh, dev, card)
        if args.profile:
            print(f"profile written to {args.profile}")
        counts.update((n, grain[n]) for n in ("grain_read_cubic", "sampler_read_linear"))
        counts.update((n, c) for n, c in gooey.items() if c > counts.get(n, 0))
        counts.update((n, c) for n, c in capi_counts.items() if c > counts.get(n, 0))
        counts.update((n, c) for n, c in os_counts.items() if c > counts.get(n, 0))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    for name, n in counts.items():
        kernels[name]["launches"] = n
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
