#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--profile PATH]

Phases (any failure exits non-zero):

1. device: require a CUDA card; print its name and power limit (nvidia-smi);
2. build: compile the kernels (libgooey_tpu_torch/csrc, one nvcc per source
   in parallel);
3. kernels: each of the seventeen kernels against its plain PyTorch
   version on the card, at the main path's shapes (B = 512; V = 4,096 for
   the kick's five, V = 1,024 for ws4 and the triangle, R = 2,560 membrane
   rows for linrec2, the stereo bus [2, B] for the seven bus kernels, the
   mono plate input [B] with its [4, 566] and [2, 2719] histories, and
   ``bus_chain`` running the kit's seven bus phases, and the first four, in
   one launch, which must also equal the kernels in turn bit for bit),
   inputs from a numpy seed; with each kernel's time, its plain version's
   and its bound (the larger of bytes over 3.35 TB/s and operations over
   67 TFLOP/s); also the counter hash, bit for bit against the CPU;
4. the kick slice through ``render_many``: 4,096 kick voices, tight preset,
   ``max_harmonics=0, feedback_path=False``, the default bus (mix, master,
   soft limiter), 64 blocks of 512 at 44.1 kHz with sequenced staggered
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
   single bus kernels once a block, ``bus_chain`` never;
8. the ``Engine`` API with its default statics (kick and snare additive
   triangles at 128 and 192 harmonics): 16 named kicks and one sequenced
   instrument of each other family, through saturation, lowpass, tilt
   [0.3, 0.4], delay [0.015, 0.5, 0.4, 6000], compressor, spring and plate
   added with ``add_global_effect``, 1 s; then 1 s more with the
   compressor keyed from the first kick (``set_sidechain_source``), which
   splits the bus: the first four in one launch, the compressor's and the
   spring's own kernels, the plate's.

The last line is ``{"ok": true, "device": {...}}``; the line before holds
the card's name and power limit, and the one before that the per-kernel
JSON summary (launches from the first full_kit_4096_bus7 render, and the
eight single bus kernels' from its ``fuse_bus=False`` render).
``--profile PATH`` also writes torch.profiler tables of 4 steady-state
blocks of the kick slice, the kit and each kit-with-bus render to PATH.
"""

from __future__ import annotations

import argparse
import contextlib
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
    # 32 odd harmonics x ~11 (frequency, taper, gain, accumulate, recurrence)
    "triangle_additive_bank": 364,
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
}
#: the 2-block render with kernels vs with plain versions, on the card
RENDER_TOL = 1e-4


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


def max_err(a, b) -> float:
    import torch

    if isinstance(a, (tuple, list)):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


# --- phase 3: kernels against their plain versions ---------------------------


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def kernel_cases(dev):
    """(name, shape label, args, kwargs, n_outputs) at the main path's
    shapes; a kernel may have more than one case."""
    import torch

    from libgooey_tpu_torch.core.smoother import smoothing_coeff
    from libgooey_tpu_torch.effects import compressor, delay
    from libgooey_tpu_torch.effects import feedback_waveshaper as fbws
    from libgooey_tpu_torch.effects import reverb_plate, reverb_spring, saturation
    from libgooey_tpu_torch.ops import bank_kernels as bk
    from libgooey_tpu_torch.ops import bus_kernels as bus
    from libgooey_tpu_torch.ops import filters, noise, ringbuf

    rs = np.random.RandomState(SEED)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    def mask(p, rows=V):
        return t(rs.rand(rows, B) < p, torch.bool)

    kick_shape = f"V={V}, B={B}"
    cases = []
    # 1. affine1 as linrec1 uses it: no floor, one-pole coefficients with resets
    cases.append(("affine1_bank", kick_shape, (
        t(np.full((V, B), -3.0e38, np.float32)),
        t(np.where(rs.rand(V, B) < 0.002, 0.0, 0.9 + 0.0999 * rs.rand(V, B))),
        t(0.01 * rs.randn(V, B)), t(0.1 * rs.randn(V))), {}, 1))
    # 2. pink over hashed white noise with trigger resets
    poles, gains = noise.coefficients(SR)
    kw = dict(poles=tuple(map(float, poles)), gains=tuple(map(float, gains)),
              direct=float(noise.DIRECT_GAIN), outg=float(noise.OUTPUT_GAIN))
    cases.append(("pink_bank", kick_shape, (
        t(rs.uniform(-1, 1, (V, B))), mask(0.002), t(0.1 * rs.randn(V, 3))), kw, 1))
    # 3. TPT SVF with per-sample cutoff sweeps
    x = t(0.3 * rs.randn(V, B))
    g, h = filters.svf_coeffs(t(20.0 + 9000.0 * rs.rand(V, B)), 0.9, SR)
    cases.append(("svf_bank", kick_shape, (
        x, g.contiguous(), h.contiguous(), mask(0.002), t(0.1 * rs.randn(V)),
        t(0.1 * rs.randn(V))), {}, 2))
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
    # 6. the snare/bass overdrive: drive 1-10 per voice, some rows bypassed
    Vs = KIT["snare"]
    cases.append(("ws4_bank", f"V={Vs}, B={B}", (
        t(0.5 * rs.randn(Vs, B)),
        t(np.where(rs.rand(Vs, 1) < 0.1, 1.0, 1.0 + 9.0 * rs.rand(Vs, 1)) * np.ones(B)),
        t(0.05 * rs.randn(bk.FBWS_S_IN, Vs))), {}, 1))
    # 7. the membrane: tom2's 512 voices x 5 high-Q band-pass rows, resets
    R = 5 * KIT["tom2"]
    wr = 2 * np.pi * rs.uniform(160.0, 330.0, (R, 1)) / SR
    alpha = np.sin(wr) / (2 * rs.uniform(1.0, 7.5, (R, 1)))
    keep = np.where(rs.rand(R, B) < 0.002, 0.0, 1.0)
    cases.append(("linrec2_bank", f"R={R}, B={B}", (
        t(2 * np.cos(wr) / (1 + alpha) * keep), t(-(1 - alpha) / (1 + alpha) * keep),
        t(keep), t(np.zeros((R, B))), t(0.002 * rs.randn(R, B)), t(np.zeros((R, B))),
        t(0.01 * rs.randn(R)), t(0.01 * rs.randn(R))), {}, 2))
    # 8. the snare's tonal triangle: up to 2 s after the trigger, 40-2,000 Hz
    cases.append(("triangle_additive_bank", f"V={Vs}, B={B}, 64 harmonics", (
        t(rs.randint(0, 2 * int(SR), (Vs, 1)) + np.arange(B)[None, :]),
        t(rs.uniform(40.0, 2000.0, (Vs, B)))), dict(sample_rate=SR, max_harmonics=64), 1))

    # the bus: one stereo block [2, B]
    bus_shape = f"[2, {B}]"
    coeff = smoothing_coeff(SR, 30.0)
    xb = t(rs.uniform(-0.9, 0.9, (2, B)))
    # 9. saturation: drive and warmth moving; the left mix falls under the
    #    bypass gate mid-block, the right one fades from 0.6
    sat = saturation.init_state(SR, device=dev)
    cases.append(("saturation_block", bus_shape, (
        xb, t([[0.6, 0.5, 1.2e-4], [0.6, 0.5, 0.6]]), t([[0.2, 0.9, 0.0]] * 2),
        bus.pack_saturation(sat.ovs, sat.dc)), dict(coeff=coeff), 1))
    # 10. lowpass: cutoff sweeping 2-12 kHz at resonance 0.8 (the effect's maps)
    cut = np.minimum(np.linspace(2000.0, 12000.0, B), 0.4 * SR)[None, :].repeat(2, 0)
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
    tap = ringbuf.read_frac(ring, t(np.full((2, B), 0.015 * SR)))
    dl = (xb, tap, t([[0.6, 0.8, 4000.0]] * 2), t([[0.5, 0.4, 6000.0]] * 2),
          t(0.1 * rs.randn(2, 2)))
    for pingpong in (False, True):
        cases.append(("delay_block", f"{bus_shape}, pingpong={pingpong}", dl,
                      dict(coeff=coeff, sample_rate=SR, pingpong=pingpong), 2))
    first_four = [bus.Phase(name, args[1:], kw) for name, _, args, kw, _ in cases[-5:-1]]
    # 13. the compressor's detector on loud bursts: a 1 ms attack, a 100 ms
    #     release, a bypass span that holds the envelope
    bursts = t((rs.uniform(-1.0, 1.0, (2, B)) * (np.sin(np.arange(B) * 2 * np.pi / 97.0) > 0.3)
                * 1.5))
    byp = np.zeros((2, B))
    byp[:, 200:260] = 1.0
    env_args = (bursts, t(np.full((2, B), np.exp(-1.0 / (1.0 * 0.001 * SR)))),
                t(np.full((2, B), np.exp(-1.0 / (100.0 * 0.001 * SR)))), t(byp), t([0.3, 0.0]))
    cases.append(("env_follower_block", bus_shape, env_args, {}, 1))
    # 14. its gain stage on that envelope: threshold -30 dB, ratio 8, the
    #     smoothed gain falling from 1 through 0.99 (the tube colour engages)
    env = bus.env_follower_block_plain(*env_args)[0]
    comp = compressor.init_state(SR, device=dev)
    comp_args = (bursts, env, t(np.full((2, B), -30.0)), t(np.full((2, B), 8.0)),
                 t(np.ones((2, B))), bus.pack_compressor(comp.ovs, comp.dc, comp.gain))
    cases.append(("compressor_block", bus_shape, comp_args, {}, 1))
    # 15. the spring on a filled history, decay 0.3 -> 0.9 and damping
    #     0.6 -> 0.2 across the block
    dl, dr = reverb_spring.delay_lengths(SR)
    D = max(dl + dr)
    damping = np.linspace(0.6, 0.2, B)[None].repeat(2, 0)
    fb_gain = 0.95 * np.linspace(0.3, 0.9, B)[None].repeat(2, 0) ** 0.4
    fbgp = np.concatenate([np.zeros((2, 1)), fb_gain[:, :-1]], axis=-1)
    A = damping + (1.0 - damping) * np.prod(reverb_spring.GAINS) * fbgp
    A[:, 0] = damping[:, 0]
    spring_args = (xb, t(A), t(1.0 - damping), t(fbgp), t(0.3 * rs.randn(2 * bus.SPRING_APS, D)),
                   t([0.05, -0.02]), t(np.full((2, B), 0.3)), t([0.01, -0.03]))
    spring_kw = dict(delays=dl + dr, gains=reverb_spring.GAINS)
    cases.append(("spring_block", f"{bus_shape}, hist [12, {D}]", spring_args, spring_kw, 1))
    # 16. the plate's sub-block path on filled histories, the size knob
    #     moving 1.0 -> 0.0 in the block (the modulated lags sweep)
    srs = SR / reverb_plate.DATTORRO_SR
    DIN, DMOD = reverb_plate.in_hist_len(SR), reverb_plate.mod_hist_len(SR)
    q = np.float32(1.0 - smoothing_coeff(SR))
    size = reverb_plate.size_to_scale(torch.as_tensor(
        q ** np.arange(1, B + 1, dtype=np.float32))).numpy()
    lfo = np.sin(2 * np.pi * (np.arange(1, B + 1) * np.array([[0.5], [0.71]]) / SR
                              + [[0.2], [0.7]]))
    mod_off = np.clip(np.array([[672.0], [908.0]]) * srs * size + lfo * 16.0 * srs,
                      1.0, DMOD - 2.0)
    rows = [rs.uniform(-0.5, 0.5, B) for _ in range(6)]
    rows[3] = 0.95 * np.linspace(0.1, 0.6, B)
    cases.append(("plate_block", f"[{B}], in_hist [4, {DIN}], mod_hist [2, {DMOD}]",
                  (*map(t, rows), t(mod_off), t(0.2 * rs.randn(4, DIN)),
                   t(0.2 * rs.randn(2, DMOD)), t([0.1, -0.05, 0.02])),
                  dict(sample_rate=SR), 4))
    # 17. the kit's seven bus phases as one run, each on the signal the one
    #     before it left (the delay without ping-pong, as the engine runs
    #     it; the gain stage on the detector's envelope), then the first
    #     four alone (full_kit_4096_bus4)
    seven = first_four + [
        bus.Phase("env_follower_block", env_args[1:], {}),
        bus.Phase("compressor_block", (None,) + comp_args[2:], {}),
        bus.Phase("spring_block", spring_args[1:], spring_kw)]
    cases.append(("bus_chain", f"{bus_shape}, {' -> '.join(FX_ORDER_FULL[:-1])} (7 phases)",
                  (xb, seven), {}, 1))
    cases.append(("bus_chain", f"{bus_shape}, {' -> '.join(FX_ORDER)}", (xb, first_four), {}, 1))
    return cases


def nbytes(obj) -> int:
    """Bytes of every tensor in ``obj``, through tuples and lists (a
    ``bus_chain`` phase is a tuple of its name, arguments and keywords)."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(nbytes(a) for a in obj)
    return 0


def bound_ms(name, args, outs):
    """The least time the card could take: each input read once and each
    output written once at 3.35 TB/s, or the body's operations at 67
    TFLOP/s, whichever is larger (``bus_chain``: the sum of its phases'
    operations).  Returns ``(ms, "bytes"|"operations")``."""
    shape = args[0].shape
    rows, b = (1, shape[0]) if len(shape) == 1 else shape
    ops = (sum(OPS_PER_ROW_SAMPLE[ph.name] for ph in args[1]) if name == "bus_chain"
           else OPS_PER_ROW_SAMPLE[name])
    t_bytes = (nbytes(args) + nbytes(outs)) / PEAK_BYTES_S
    t_ops = ops * rows * b / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(a, b) -> float:
    """Worst ``|a-b| / max(1, |b|)``."""
    import torch

    if isinstance(a, (tuple, list)):
        return max((rel_err(x, y) for x, y in zip(a, b)), default=0.0)
    a, b = a.to(torch.float64), b.to(torch.float64)
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


def phase_kernels(dev):
    import torch

    from libgooey_tpu_torch.ops import kernels

    results = {}
    for name, shape, args, kw, n_out in kernel_cases(dev):
        mod = kernels.module_of(name)
        kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
        got = as_tuple(kern(*args, **kw))
        torch.cuda.synchronize()
        want = as_tuple(plain(*args, **kw))
        torch.cuda.synchronize()
        out_err = max_err(got[:n_out], want[:n_out])
        state_err = rel_err(got[n_out:], want[n_out:])
        for _ in range(3):
            kern(*args, **kw)
        ms = cuda_ms(lambda: kern(*args, **kw), 20)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), 1)
        bms, bound_by = bound_ms(name, args, got)
        print(f"kernel {name}: out err {out_err:.3e} (tol {OUT_TOL:g}), state err "
              f"{state_err:.3e} (tol {STATE_TOL:g}); {ms * 1e3:.1f} us/call vs plain "
              f"{plain_ms * 1e3:.1f} us/call, bound {bms * 1e3:.4f} us ({bound_by}) at {shape}")
        check(np.isfinite(out_err) and out_err <= OUT_TOL, f"{name}: output error {out_err}")
        check(np.isfinite(state_err) and state_err <= STATE_TOL,
              f"{name}: state error {state_err}")
        if name == "bus_chain":   # one launch gives what the kernels give in turn
            same = max_err(mod.run_phases(*args), got) == 0.0
            print(f"kernel bus_chain ({len(args[1])} phases): equal to its phases' own "
                  f"kernels in turn: {same}")
            check(same, "bus_chain differs from its phases' own kernels")
        err = max(out_err, state_err)
        if name in results:   # a second case of one kernel: keep the first's times
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
            continue
        # no single PyTorch call computes any of these recurrences
        results[name] = dict(name=name, route="cuda", source=mod.SOURCES[name],
                             replaces=mod.REPLACES[name], launches=0, max_abs_err=err,
                             ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bound_by,
                             library_ms=None)
    return results


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
    first; check the output, that each of ``path_kernels`` launched, and the
    first blocks against the all-plain render (``compare``: the state and
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
    check(all(counts[n] > 0 for n in path_kernels),
          f"{label}: a kernel never launched: {counts}")
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
        from torch.profiler import ProfilerActivity, profile

        prof_events = {k: v[:4] for k, v in events.items()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.render_many(state, prof_events, **static)
            torch.cuda.synchronize()
        table = prof.key_averages()
        device = [e for e in table if e.device_type == torch.autograd.DeviceType.CUDA]
        launches = sum(e.count for e in device) / 4
        busy_ms = sum(e.self_device_time_total for e in device) / 4e3
        h2d = sum(e.count for e in device if "HtoD" in e.key) / 4
        summary = (f"{label} (traced): {launches:.0f} device ops per block (kernels and "
                   f"copies; {h2d:.0f} host-to-device), device busy {busy_ms:.3f} ms/block")
        print(summary)
        prof_file.write(f"# 4 blocks of the {label} ({n_voices} voices) on {card}\n"
                        f"# {summary}\n")
        prof_file.write(table.table(sort_by="cuda_time_total", row_limit=90))
        prof_file.write("\n\n")
    return counts


def phase_slice(dev, card, prof_file=None):
    state, events, static = slice_inputs(dev, N_BLOCKS)
    return drive_path("kick slice", card, state, events, static, V,
                      ("affine1_bank", "pink_bank", "svf_bank", "env_follow_bank",
                       "fbws_bank"), N_REPEATS_EARLIER, prof_file)


def phase_kit(dev, card, prof_file=None):
    from libgooey_tpu_torch.ops import bank_kernels as bk

    state, events, static = kit_inputs(dev, N_BLOCKS)
    return drive_path("kit", card, state, events, static, sum(KIT.values()),
                      bk.KERNELS, N_REPEATS_EARLIER, prof_file)


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
    counts.update((n, c[n]) for n in BUS_SINGLES[:-1])
    return counts


# --- phase 7: the Engine API -------------------------------------------------


def phase_engine(dev):
    """The Engine with its default statics: 16 sequenced kicks (additive
    triangle at 128 harmonics) and one sequenced instrument of each other
    family, the bass with a note on one step, through the seven global
    effects; then a second second with the compressor keyed from the first
    kick."""
    from libgooey_tpu_torch.engine.engine import FAMILIES, Engine
    from libgooey_tpu_torch.instruments import kick
    from libgooey_tpu_torch.ops import kernels

    eng = Engine(SR, B, device=dev)
    presets = ("tight", "punch", "loose", "dirt")
    names = []
    for i in range(16):
        names.append(f"kick{i}")
        eng.add_kick(names[-1], kick.PRESETS[presets[i % 4]]())
    for kind in ("snare", "hihat2", "tom2", "bass"):
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
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = eng.render(n_samples)
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = float(np.abs(out).max())
        check(out.shape == (2, n_samples), f"{label}: output shape {out.shape}")
        check(bool(np.isfinite(out).all()), f"{label}: output is not finite")
        check(peak > 1e-3, f"{label}: output is silent (peak {peak})")
        check(all(n > 0 for k, n in counts.items() if k not in BUS_SINGLES + ("bus_chain",))
              and all(counts[k] == (n_blocks if k in launched else 0)
                      for k in BUS_SINGLES + ("bus_chain",)),
              f"{label}: a kernel never launched, or a bus kernel not once a block: {counts}")
        print(f"{label}: {len(names)} sequenced instruments of 5 families through "
              f"{'/'.join(eng.fx_order)}, {ENGINE_SECONDS:g} s rendered in {wall:.3f} s, "
              f"peak {peak:.4f}; "
              f"launches {json.dumps(counts)}")


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

    try:
        kernels = phase_kernels(dev)
        phase_rng(dev)
        with (open(args.profile, "w") if args.profile else contextlib.nullcontext()) as prof:
            phase_slice(dev, card, prof)
            phase_kit(dev, card, prof)
            phase_bus(dev, card, prof)
            counts = phase_full_bus(dev, card, prof)
        if args.profile:
            print(f"profile written to {args.profile}")
        phase_engine(dev)
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
