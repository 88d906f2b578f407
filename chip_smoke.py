#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--profile PATH]

Phases (any failure exits non-zero):

1. device: require a CUDA card; print its name and power limit (nvidia-smi);
2. build: compile the kernels (libgooey_tpu_torch/csrc, one nvcc per source
   in parallel);
3. kernels: each of the eight kernels against its plain PyTorch version on
   the card, at the main path's shapes (B = 512; V = 4,096 for the kick's
   five, V = 1,024 for ws4 and the triangle, R = 2,560 membrane rows for
   linrec2), inputs from a numpy seed; also the counter hash, bit for bit
   against the CPU;
4. the kick slice through ``render_many``: 4,096 kick voices, tight preset,
   ``max_harmonics=0, feedback_path=False``, the default bus (mix, master,
   soft limiter), 64 blocks of 512 at 44.1 kHz with sequenced staggered
   triggers; checks the output, the launch counts, and the first 2 blocks
   against the same render with every kernel swapped for its plain version;
   reports the aggregate real-time factor (voices x audio seconds / wall s)
   from the median of 5 timed renders;
5. the five-family kit through ``render_many`` (the voice half of
   ``bench_configs.build_full_kit``, with the default bus): kick, snare and
   hihat2 at 1,024 voices, tom2 and bass at 512, default presets, kick
   ``max_harmonics=0, feedback_path=False``, snare ``max_harmonics=64``,
   the kit's sequenced traffic, 64 blocks; the same checks with all eight
   kernels, ms/block, aggregate RTF and launches per kernel per block;
6. the ``Engine`` API with its default statics (kick and snare additive
   triangles at 128 and 192 harmonics): 16 named kicks and one sequenced
   instrument of each other family, 1 s.

The last line is ``{"ok": true, "device": {...}}``; the line before holds
the card's name and power limit, and the one before that the per-kernel
JSON summary (launches from the kit's run).  ``--profile PATH`` also writes
torch.profiler tables of 4 steady-state blocks of the kick slice and of the
kit to PATH.
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
#: timed repeats of the 64-block render (the host clock is shared and noisy)
N_REPEATS = 5
SEED = 0

#: kernel vs plain version: tanhf and the order of a few roundings differ
OUT_TOL = 1e-5
STATE_TOL = 1e-4
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


def kernel_cases(dev):
    """(name, shape label, kernel call, plain call, n_outputs) at the main
    path's shapes."""
    import torch

    from libgooey_tpu_torch.effects import feedback_waveshaper as fbws
    from libgooey_tpu_torch.ops import bank_kernels as bk
    from libgooey_tpu_torch.ops import filters, noise

    rs = np.random.RandomState(SEED)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    def mask(p, rows=V):
        return t(rs.rand(rows, B) < p, torch.bool)

    kick_shape = f"V={V}, B={B}"
    cases = []
    # 1. affine1 as linrec1 uses it: no floor, one-pole coefficients with resets
    a = t(np.full((V, B), -3.0e38, np.float32))
    bcoef = t(np.where(rs.rand(V, B) < 0.002, 0.0, 0.9 + 0.0999 * rs.rand(V, B)))
    c = t(0.01 * rs.randn(V, B))
    y0 = t(0.1 * rs.randn(V))
    cases.append(("affine1_bank", kick_shape, lambda: bk.affine1_bank(a, bcoef, c, y0),
                  lambda: bk.affine1_bank_plain(a, bcoef, c, y0), 1))
    # 2. pink over hashed white noise with trigger resets
    poles, gains = noise.coefficients(SR)
    kw = dict(poles=tuple(map(float, poles)), gains=tuple(map(float, gains)),
              direct=float(noise.DIRECT_GAIN), outg=float(noise.OUTPUT_GAIN))
    w = t(rs.uniform(-1, 1, (V, B)))
    rst = mask(0.002)
    fst = t(0.1 * rs.randn(V, 3))
    cases.append(("pink_bank", kick_shape, lambda: bk.pink_bank(w, rst, fst, **kw),
                  lambda: bk.pink_bank_plain(w, rst, fst, **kw), 1))
    # 3. TPT SVF with per-sample cutoff sweeps
    x = t(0.3 * rs.randn(V, B))
    g, h = filters.svf_coeffs(t(20.0 + 9000.0 * rs.rand(V, B)), 0.9, SR)
    g, h = g.contiguous(), h.contiguous()
    rst2 = mask(0.002)
    ic1, ic2 = t(0.1 * rs.randn(V)), t(0.1 * rs.randn(V))
    cases.append(("svf_bank", kick_shape, lambda: bk.svf_bank(x, g, h, rst2, ic1, ic2),
                  lambda: bk.svf_bank_plain(x, g, h, rst2, ic1, ic2), 2))
    # 4. envelope follower with bypass freezes
    att, rel = fbws.env_coeffs(SR)
    rect = t(np.abs(0.5 * rs.randn(V, B)))
    frz = mask(0.1)
    env0 = t(np.abs(0.1 * rs.randn(V)))
    cases.append(("env_follow_bank", kick_shape,
                  lambda: bk.env_follow_bank(rect, frz, env0, att=att, rel=rel),
                  lambda: bk.env_follow_bank_plain(rect, frz, env0, att=att, rel=rel), 1))
    # 5. the 4x waveshaper chain: kick-range drive, makeup gain, some bypass
    u = t((1.0 + 40.0 * rs.rand(V, 1) ** 3) * 0.3 * rs.randn(V, B))
    cs = t(np.where(rs.rand(V, B) < 0.05, -1.0, 0.2 + 2.8 * rs.rand(V, B)))
    packed = t(0.1 * rs.randn(bk.FBWS_S_IN, V))
    cases.append(("fbws_bank", kick_shape, lambda: bk.fbws_bank(u, cs, packed),
                  lambda: bk.fbws_bank_plain(u, cs, packed), 1))
    # 6. the snare/bass overdrive: drive 1-10 per voice, some rows bypassed
    Vs = KIT["snare"]
    xw = t(0.5 * rs.randn(Vs, B))
    drive = t(np.where(rs.rand(Vs, 1) < 0.1, 1.0, 1.0 + 9.0 * rs.rand(Vs, 1)) * np.ones(B))
    packed_w = t(0.05 * rs.randn(bk.FBWS_S_IN, Vs))
    cases.append(("ws4_bank", f"V={Vs}, B={B}", lambda: bk.ws4_bank(xw, drive, packed_w),
                  lambda: bk.ws4_bank_plain(xw, drive, packed_w), 1))
    # 7. the membrane: tom2's 512 voices x 5 high-Q band-pass rows, resets
    R = 5 * KIT["tom2"]
    wr = 2 * np.pi * rs.uniform(160.0, 330.0, (R, 1)) / SR
    alpha = np.sin(wr) / (2 * rs.uniform(1.0, 7.5, (R, 1)))
    keep = np.where(rs.rand(R, B) < 0.002, 0.0, 1.0)
    l2 = [t(2 * np.cos(wr) / (1 + alpha) * keep), t(-(1 - alpha) / (1 + alpha) * keep),
          t(keep), t(np.zeros((R, B))), t(0.002 * rs.randn(R, B)), t(np.zeros((R, B))),
          t(0.01 * rs.randn(R)), t(0.01 * rs.randn(R))]
    cases.append(("linrec2_bank", f"R={R}, B={B}", lambda: bk.linrec2_bank(*l2),
                  lambda: bk.linrec2_bank_plain(*l2), 2))
    # 8. the snare's tonal triangle: up to 2 s after the trigger, 40-2,000 Hz
    idx = t(rs.randint(0, 2 * int(SR), (Vs, 1)) + np.arange(B)[None, :])
    freq = t(rs.uniform(40.0, 2000.0, (Vs, B)))
    cases.append(("triangle_additive_bank", f"V={Vs}, B={B}, 64 harmonics",
                  lambda: (bk.triangle_additive_bank(idx, freq, SR, 64),),
                  lambda: (bk.triangle_additive_bank_plain(idx, freq, SR, 64),), 1))
    return cases


def phase_kernels(dev):
    import torch

    from libgooey_tpu_torch.ops import bank_kernels as bk

    results = {}
    for name, shape, kern, plain, n_out in kernel_cases(dev):
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        out_err = max_err(got[:n_out], want[:n_out])
        state_err = max_err(got[n_out:], want[n_out:]) if len(got) > n_out else 0.0
        for _ in range(3):
            kern()
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 1)
        print(f"kernel {name}: out err {out_err:.3e} (tol {OUT_TOL:g}), state err "
              f"{state_err:.3e} (tol {STATE_TOL:g}); {ms * 1e3:.1f} us/call vs plain "
              f"{plain_ms * 1e3:.1f} us/call at {shape}")
        check(np.isfinite(out_err) and out_err <= OUT_TOL, f"{name}: output error {out_err}")
        check(np.isfinite(state_err) and state_err <= STATE_TOL,
              f"{name}: state error {state_err}")
        results[name] = dict(name=name, route="cuda", source=bk.SOURCES[name],
                             replaces=bk.REPLACES[name],
                             max_abs_err=max(out_err, state_err), ms=ms, plain_ms=plain_ms)
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


@contextlib.contextmanager
def plain_versions():
    """Swap every bank kernel for its plain version (comparison runs only)."""
    from libgooey_tpu_torch.ops import bank_kernels as bk

    saved = {n: getattr(bk, n) for n in bk.KERNELS}
    for n in bk.KERNELS:
        setattr(bk, n, getattr(bk, n + "_plain"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(bk, n, fn)


def drive_path(label, dev, card, state, events, static, n_voices, kernels, prof_file=None):
    """Render one path: warm up, then with every launch count at 0 time
    ``N_REPEATS`` renders of ``N_BLOCKS`` and read the counts after the
    first; check the output, that each of ``kernels`` launched, and the
    first blocks against the all-plain render.  Returns the counts."""
    import torch

    from libgooey_tpu_torch.engine import engine
    from libgooey_tpu_torch.ops import bank_kernels as bk

    head = {k: v[:N_COMPARE] for k, v in events.items()}

    # warm-up (first launches, allocator) on the first blocks
    _, out_k = engine.render_many(state, head, **static)
    torch.cuda.synchronize()

    bk.reset_launch_counts()
    t0 = time.perf_counter()
    _, out = engine.render_many(state, events, **static)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    counts = bk.launch_counts()
    for _ in range(N_REPEATS - 1):
        t0 = time.perf_counter()
        engine.render_many(state, events, **static)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))

    peak = float(out.abs().max())
    check(bool(torch.isfinite(out).all()), f"{label} output is not finite")
    check(tuple(out.shape) == (N_BLOCKS, 2, B), f"{label} output shape {tuple(out.shape)}")
    check(peak > 1e-3, f"{label} output is silent (peak {peak})")
    check(all(counts[n] > 0 for n in kernels), f"{label}: a kernel never launched: {counts}")
    audio_s = N_BLOCKS * B / SR
    rtf = n_voices * audio_s / wall
    print(f"{label}: {n_voices} voices x {N_BLOCKS} blocks, median of {N_REPEATS} renders "
          f"{wall:.4f} s ({wall / N_BLOCKS * 1e3:.3f} ms/block; min "
          f"{min(walls) / N_BLOCKS * 1e3:.3f}, max {max(walls) / N_BLOCKS * 1e3:.3f}), "
          f"peak {peak:.4f}; aggregate RTF {rtf:.1f} on {card}")
    print(f"{label} launches: {json.dumps(counts)}")
    print(f"{label} launches per block: "
          f"{json.dumps({n: c / N_BLOCKS for n, c in counts.items()})}")

    with plain_versions():
        _, out_p = engine.render_many(state, head, **static)
    torch.cuda.synchronize()
    err = max_err(out_k, out_p)
    print(f"{label}: first {N_COMPARE} blocks, kernels vs plain versions: max err "
          f"{err:.3e} (tol {RENDER_TOL:g})")
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
        prof_file.write(table.table(sort_by="cuda_time_total", row_limit=60))
        prof_file.write("\n\n")
    return counts


def phase_slice(dev, card, prof_file=None):
    state, events, static = slice_inputs(dev, N_BLOCKS)
    return drive_path("kick slice", dev, card, state, events, static, V,
                      ("affine1_bank", "pink_bank", "svf_bank", "env_follow_bank",
                       "fbws_bank"), prof_file)


def phase_kit(dev, card, prof_file=None):
    from libgooey_tpu_torch.ops import bank_kernels as bk

    state, events, static = kit_inputs(dev, N_BLOCKS)
    return drive_path("kit", dev, card, state, events, static, sum(KIT.values()),
                      bk.KERNELS, prof_file)


# --- phase 6: the Engine API -------------------------------------------------


def phase_engine(dev):
    """The Engine with its default statics: 16 sequenced kicks (additive
    triangle at 128 harmonics) and one sequenced instrument of each other
    family, the bass with a note on one step."""
    from libgooey_tpu_torch.engine.engine import FAMILIES, Engine
    from libgooey_tpu_torch.instruments import kick
    from libgooey_tpu_torch.ops import bank_kernels as bk

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
    bk.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.render(int(SR))
    wall = time.perf_counter() - t0
    counts = bk.launch_counts()
    peak = float(np.abs(out).max())
    check(out.shape == (2, int(SR)), f"engine output shape {out.shape}")
    check(bool(np.isfinite(out).all()), "engine output is not finite")
    check(peak > 1e-3, f"engine output is silent (peak {peak})")
    check(all(n > 0 for n in counts.values()), f"engine: a kernel never launched: {counts}")
    print(f"engine: {len(names)} sequenced instruments of 5 families, 1 s rendered in "
          f"{wall:.3f} s, peak {peak:.4f}; launches {json.dumps(counts)}")


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
            counts = phase_kit(dev, card, prof)
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
