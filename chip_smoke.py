#!/usr/bin/env python3
"""Drive the PyTorch port's kick-bank slice once on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py [--profile PATH]

Phases (any failure exits non-zero):

1. device: require a CUDA card; print its name and power limit (nvidia-smi);
2. build: compile the bank kernels (libgooey_tpu_torch/csrc) with nvcc;
3. kernels: each bank kernel against its plain PyTorch version on the card,
   at the main path's shapes (V = 4,096 voices, B = 512), inputs from a
   numpy seed; also the counter hash, bit for bit against the CPU;
4. the slice through ``render_many``: 4,096 kick voices, tight preset,
   ``max_harmonics=0, feedback_path=False``, the default bus (mix, master,
   soft limiter), 64 blocks of 512 at 44.1 kHz with sequenced staggered
   triggers; checks the output, the launch counts, and the first 2 blocks
   against the same render with every kernel swapped for its plain version;
   reports the aggregate real-time factor (voices x audio seconds / wall s)
   from the median of 5 timed renders;
5. the slice through the ``Engine`` API: 16 named kicks, sequenced, 1 s.

The last line is ``{"ok": true, "device": {...}}``; the line before holds
the card's name and power limit, and the one before that the per-kernel
JSON summary.  ``--profile PATH`` also writes a torch.profiler table of 4
steady-state blocks to PATH.
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
    """(name, kernel call, plain call, n_outputs) at V=4096, B=512."""
    import torch

    from libgooey_tpu_torch.effects import feedback_waveshaper as fbws
    from libgooey_tpu_torch.ops import bank_kernels as bk
    from libgooey_tpu_torch.ops import filters, noise

    rs = np.random.RandomState(SEED)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    def mask(p):
        return t(rs.rand(V, B) < p, torch.bool)

    cases = []
    # 1. affine1 as linrec1 uses it: no floor, one-pole coefficients with resets
    a = t(np.full((V, B), -3.0e38, np.float32))
    bcoef = t(np.where(rs.rand(V, B) < 0.002, 0.0, 0.9 + 0.0999 * rs.rand(V, B)))
    c = t(0.01 * rs.randn(V, B))
    y0 = t(0.1 * rs.randn(V))
    cases.append(("affine1_bank", lambda: bk.affine1_bank(a, bcoef, c, y0),
                  lambda: bk.affine1_bank_plain(a, bcoef, c, y0), 1))
    # 2. pink over hashed white noise with trigger resets
    poles, gains = noise.coefficients(SR)
    kw = dict(poles=tuple(map(float, poles)), gains=tuple(map(float, gains)),
              direct=float(noise.DIRECT_GAIN), outg=float(noise.OUTPUT_GAIN))
    w = t(rs.uniform(-1, 1, (V, B)))
    rst = mask(0.002)
    fst = t(0.1 * rs.randn(V, 3))
    cases.append(("pink_bank", lambda: bk.pink_bank(w, rst, fst, **kw),
                  lambda: bk.pink_bank_plain(w, rst, fst, **kw), 1))
    # 3. TPT SVF with per-sample cutoff sweeps
    x = t(0.3 * rs.randn(V, B))
    g, h = filters.svf_coeffs(t(20.0 + 9000.0 * rs.rand(V, B)), 0.9, SR)
    g, h = g.contiguous(), h.contiguous()
    rst2 = mask(0.002)
    ic1, ic2 = t(0.1 * rs.randn(V)), t(0.1 * rs.randn(V))
    cases.append(("svf_bank", lambda: bk.svf_bank(x, g, h, rst2, ic1, ic2),
                  lambda: bk.svf_bank_plain(x, g, h, rst2, ic1, ic2), 2))
    # 4. envelope follower with bypass freezes
    att, rel = fbws.env_coeffs(SR)
    rect = t(np.abs(0.5 * rs.randn(V, B)))
    frz = mask(0.1)
    env0 = t(np.abs(0.1 * rs.randn(V)))
    cases.append(("env_follow_bank",
                  lambda: bk.env_follow_bank(rect, frz, env0, att=att, rel=rel),
                  lambda: bk.env_follow_bank_plain(rect, frz, env0, att=att, rel=rel), 1))
    # 5. the 4x waveshaper chain: kick-range drive, makeup gain, some bypass
    u = t((1.0 + 40.0 * rs.rand(V, 1) ** 3) * 0.3 * rs.randn(V, B))
    cs = t(np.where(rs.rand(V, B) < 0.05, -1.0, 0.2 + 2.8 * rs.rand(V, B)))
    packed = t(0.1 * rs.randn(bk.FBWS_S_IN, V))
    cases.append(("fbws_bank", lambda: bk.fbws_bank(u, cs, packed),
                  lambda: bk.fbws_bank_plain(u, cs, packed), 1))
    return cases


def phase_kernels(dev):
    import torch

    from libgooey_tpu_torch.ops import bank_kernels as bk

    results = {}
    for name, kern, plain, n_out in kernel_cases(dev):
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        out_err = max_err(got[:n_out], want[:n_out])
        state_err = max_err(got[n_out:], want[n_out:])
        for _ in range(3):
            kern()
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 1)
        print(f"kernel {name}: out err {out_err:.3e} (tol {OUT_TOL:g}), state err "
              f"{state_err:.3e} (tol {STATE_TOL:g}); {ms * 1e3:.1f} us/call vs plain "
              f"{plain_ms * 1e3:.1f} us/call at V={V}, B={B}")
        check(np.isfinite(out_err) and out_err <= OUT_TOL, f"{name}: output error {out_err}")
        check(np.isfinite(state_err) and state_err <= STATE_TOL,
              f"{name}: state error {state_err}")
        results[name] = dict(name=name, route="cuda", source=bk.SOURCE,
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


# --- phase 4: the slice through render_many ----------------------------------


def slice_inputs(dev, n_blocks):
    """State, stacked events and statics of the 4,096-voice kick slice, with
    the kick part of bench_configs.build_full_kit's traffic."""
    from libgooey_tpu_torch.core.smoother import SmootherBank, smoothing_coeff
    from libgooey_tpu_torch.engine.sequencer import Sequencer
    from libgooey_tpu_torch.instruments import kick

    state = {
        "kick": kick.init_state(V, kick.KickConfig.tight(), device=dev),
        "pan": SmootherBank.init(np.linspace(0.2, 0.8, V), dev),
        "gain": SmootherBank.init(np.full(V, 1.0 / V), dev),
        "master": SmootherBank.init(np.float32(0.25), dev),
    }
    seq = Sequencer(120.0, SR, 16)
    seq.set_pattern([True] * 16)
    seq.start()
    hits = []
    for b in range(n_blocks):
        hits += [b * B + trig.offset for trig in seq.tick_block(B)]
    lags = np.random.RandomState(0).randint(0, int(SR * 0.5), size=V)
    offs = np.full((n_blocks, V), B, np.int32)
    vels = np.zeros((n_blocks, V), np.float32)
    vel_of = (0.5 + 0.5 * ((np.arange(V) % 7) / 6.0)).astype(np.float32)
    for h in hits:
        s = h + lags
        ok = s < n_blocks * B
        offs[s[ok] // B, np.nonzero(ok)[0]] = s[ok] % B
        vels[s[ok] // B, np.nonzero(ok)[0]] = vel_of[ok]
    events = {"kick_off": offs, "kick_vel": vels,
              "block_start": (np.arange(n_blocks) * B).astype(np.int32)}
    static = dict(kinds=("kick",), sample_rate=SR, block_size=B,
                  smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
                  family_static=(("kick", (("feedback_path", False),
                                           ("max_harmonics", 0))),))
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


def phase_slice(dev, card, profile_path=None):
    import torch

    from libgooey_tpu_torch.engine import engine
    from libgooey_tpu_torch.ops import bank_kernels as bk

    state, events, static = slice_inputs(dev, N_BLOCKS)
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
    check(bool(torch.isfinite(out).all()), "slice output is not finite")
    check(tuple(out.shape) == (N_BLOCKS, 2, B), f"slice output shape {tuple(out.shape)}")
    check(peak > 1e-3, f"slice output is silent (peak {peak})")
    check(all(n > 0 for n in counts.values()), f"a kernel never launched: {counts}")
    audio_s = N_BLOCKS * B / SR
    rtf = V * audio_s / wall
    print(f"slice: {V} voices x {N_BLOCKS} blocks, median of {N_REPEATS} renders "
          f"{wall:.4f} s ({wall / N_BLOCKS * 1e3:.3f} ms/block; min "
          f"{min(walls) / N_BLOCKS * 1e3:.3f}, max {max(walls) / N_BLOCKS * 1e3:.3f}), "
          f"peak {peak:.4f}; aggregate RTF {rtf:.1f} on {card}")
    print(f"slice launches: {json.dumps(counts)}")

    with plain_versions():
        _, out_p = engine.render_many(state, head, **static)
    torch.cuda.synchronize()
    err = max_err(out_k, out_p)
    print(f"slice: first {N_COMPARE} blocks, kernels vs plain versions: max err "
          f"{err:.3e} (tol {RENDER_TOL:g})")
    check(err <= RENDER_TOL, f"kernel render differs from the plain render by {err}")

    if profile_path:
        from torch.profiler import ProfilerActivity, profile

        prof_events = {k: v[:4] for k, v in events.items()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.render_many(state, prof_events, **static)
            torch.cuda.synchronize()
        with open(profile_path, "w") as f:
            f.write(f"# 4 blocks of the {V}-voice kick slice on {card}\n")
            f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=60))
        print(f"profile written to {profile_path}")
    return counts, rtf


# --- phase 5: the Engine API -------------------------------------------------


def phase_engine(dev):
    from libgooey_tpu_torch.engine.engine import Engine
    from libgooey_tpu_torch.instruments import kick

    eng = Engine(SR, B, family_static={"kick": {"max_harmonics": 0, "feedback_path": False}},
                 device=dev)
    presets = ("tight", "punch", "loose", "dirt")
    for i in range(16):
        name = f"kick{i}"
        eng.add_kick(name, kick.PRESETS[presets[i % 4]]())
        eng.set_pan(name, i / 15.0)
        seq = eng.new_sequencer(name, 120.0)
        seq.set_pattern([(s + i) % 4 == 0 for s in range(16)])
        seq.start()
    eng.set_master_gain(0.5)
    t0 = time.perf_counter()
    out = eng.render(int(SR))
    wall = time.perf_counter() - t0
    peak = float(np.abs(out).max())
    check(out.shape == (2, int(SR)), f"engine output shape {out.shape}")
    check(bool(np.isfinite(out).all()), "engine output is not finite")
    check(peak > 1e-3, f"engine output is silent (peak {peak})")
    print(f"engine: 16 sequenced kicks, 1 s rendered in {wall:.3f} s, peak {peak:.4f}")


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
        counts, _rtf = phase_slice(dev, card, args.profile)
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
