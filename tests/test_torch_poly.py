"""The port's poly synth bank, its host allocator and its music layer
against the JAX package, and the bank against the per-sample numpy oracle,
on the CPU.

The bank: 2 synths (12 lanes) start from the same state, take the same
numpy events for 4 blocks of 128 samples (a chord whose notes all land in
one block: ``[V]`` slots; a lane struck twice in a block: ``[V, K]``
slots; releases, one of them cut by a retrigger) and, with ``routed``, a
seeded ``filter_cutoff`` trajectory per synth repeated over its lanes, as
the engine passes an LFO route.  The two oscillators' phases run in
``affine1_bank``'s plain version, the filter in ``svf_bank``'s.

Bounds: audio <= 1e-4; every state leaf <= 4e-4, relative to its magnitude
where that exceeds 1 (the latched frequencies and times).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from libgooey_tpu import music as jmusic
from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.engine.engine import Engine as JEngine
from libgooey_tpu.instruments import poly as jpoly

from libgooey_tpu_torch import interop
from libgooey_tpu_torch import music as tmusic
from libgooey_tpu_torch.engine.engine import Engine as TEngine
from libgooey_tpu_torch.instruments import poly as tpoly

from poly_oracle import PolyVoiceOracle
from test_torch_bus import max_state_err

SR = 44100.0
B = 128
S = 2
V = S * tpoly.NUM_VOICES
OUT_TOL = 1e-4
STATE_TOL = 4e-4
COEFF = smoothing_coeff(SR)


def events():
    """``(off, vel, freq, rel)`` of 4 blocks.  Block 0: a chord on synth 0
    at offset 0 and two notes on synth 1 ([V] slots); block 1: lane 0
    struck twice, lane 7 once ([V, K] slots) and lane 1 released; block 2:
    lanes 2 and 6 released, lane 6 struck again after its release; block 3:
    nothing."""
    blocks = []
    for blk in range(4):
        blocks.append([np.full(V, B, np.int32), np.zeros(V, np.float32),
                       np.zeros(V, np.float32), np.full(V, B, np.int32)])
    off, vel, freq, _rel = blocks[0]
    off[[0, 1, 2, 6, 7]] = [0, 0, 0, 33, 90]
    vel[[0, 1, 2, 6, 7]] = [0.9, 0.8, 0.7, 1.0, 0.5]
    freq[[0, 1, 2, 6, 7]] = [261.6256, 329.6276, 391.9954, 110.0, 164.8138]
    K = 2
    off = np.full((V, K), B, np.int32)
    vel = np.zeros((V, K), np.float32)
    freq = np.zeros((V, K), np.float32)
    off[0], vel[0], freq[0] = [10, 75], [0.6, 1.0], [440.0, 523.2511]
    off[7, 0], vel[7, 0], freq[7, 0] = 50, 0.7, 196.0
    blocks[1][:3] = off, vel, freq
    blocks[1][3][1] = 64
    blocks[2][3][[2, 6]] = [0, 20]
    blocks[2][0][6], blocks[2][1][6], blocks[2][2][6] = 100, 0.9, 220.0
    return blocks


def routed_traj(rs, start):
    """``[S, B]`` seeded trajectories around ``start`` ``[S]``, in [0, 1]."""
    n = np.arange(B, dtype=np.float32)
    phase = rs.uniform(0, 2 * np.pi, size=(S, 1)).astype(np.float32)
    return np.clip(start[:, None] + 0.3 * np.sin(phase + n * 0.03), 0.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("routed", [False, True])
def test_render_block_matches_jax(routed):
    targets = np.stack([jpoly.PolySynthConfig.pluck().as_array(),
                        jpoly.PolySynthConfig.keys().as_array()])
    static = dict(sample_rate=SR, block_size=B, smooth_coeff=COEFF)
    jrender = jax.jit(functools.partial(jpoly.render_block, **static))
    jst = jpoly.init_state(S, targets=targets)
    tst = interop.family_state_from_numpy("poly", jst, "cpu")
    rs = np.random.RandomState(3)
    peak = 0.0
    for blk, (off, vel, freq, rel) in enumerate(events()):
        start = np.int32(blk * B)
        over = None
        if routed:
            traj = routed_traj(rs, targets[:, tpoly.PARAM_INDEX["filter_cutoff"]])
            over = {"filter_cutoff": np.repeat(traj, tpoly.NUM_VOICES, axis=0)}
        jst, jout = jrender(jst, jnp.asarray(off), jnp.asarray(vel), start,
                            trig_freq=jnp.asarray(freq), release_offset=jnp.asarray(rel),
                            overrides=over and {k: jnp.asarray(v) for k, v in over.items()})
        tst, tout = tpoly.render_block(
            tst, off, vel, start, trig_freq=freq, release_offset=rel,
            overrides=over and {k: torch.as_tensor(v) for k, v in over.items()}, **static)
        jout = np.asarray(jout)
        peak = max(peak, float(np.abs(jout).max()))
        assert np.abs(tout.numpy() - jout).max() <= OUT_TOL, f"block {blk}"
        worst, where = max_state_err(jst, tst)
        assert worst <= STATE_TOL, f"block {blk}: state divergence {worst} at {where}"
    assert peak > 1e-2
    assert bool(np.asarray(jst.ever).any())


# --- the per-sample oracle (tests/test_poly.py's cases, through the port) --------

OB = 512


def render_lane(cfg, n_samples, evs):
    """``evs`` {sample: ("on", freq, vel) | ("off",)} on lane 0 of one synth."""
    state = tpoly.init_state(1, cfg, device="cpu")
    nv = tpoly.NUM_VOICES
    out = []
    for start in range(0, n_samples, OB):
        off, vel = np.full(nv, OB, np.int32), np.zeros(nv, np.float32)
        freq, rel = np.zeros(nv, np.float32), np.full(nv, OB, np.int32)
        for s, ev in evs.items():
            if start <= s < start + OB:
                if ev[0] == "on":
                    off[0], freq[0], vel[0] = s - start, ev[1], ev[2]
                else:
                    rel[0] = s - start
        state, y = tpoly.render_block(state, off, vel, np.int32(start), trig_freq=freq,
                                      release_offset=rel, sample_rate=SR, block_size=OB,
                                      smooth_coeff=COEFF)
        out.append(y[0].numpy())
    return np.concatenate(out)[:n_samples]


@pytest.mark.parametrize("preset, evs", [
    ("default", {100: ("on", 261.6256, 0.9)}),
    ("pluck", {10: ("on", 329.6276, 1.0), 1200: ("off",)}),
    ("pad", {5: ("on", 220.0, 0.8), 1500: ("off",), 1900: ("on", 246.9417, 0.6)}),
])
def test_lane_matches_oracle(preset, evs):
    cfg = tpoly.PRESETS[preset]()
    n = 3072
    got = render_lane(cfg, n, evs)
    oracle = PolyVoiceOracle({k: getattr(cfg, k) for k in tpoly.PARAM_NAMES}, SR)
    want = np.zeros(n, np.float32)
    for i in range(n):
        ev = evs.get(i)
        if ev is not None:
            if ev[0] == "on":
                oracle.trigger(ev[1], ev[2])
            else:
                oracle.release()
        want[i] = oracle.tick()
    assert np.abs(got - want).max() < OUT_TOL
    assert np.abs(got).max() > 1e-3


# --- the host: lane allocation, stealing, note-off, chords --------------------------


def _host_ops(eng):
    """Notes and chords on two synths, with sample_count moving as a render
    would move it; returns the allocator's trace."""
    eng.add_instrument("pad", "poly", (jpoly if isinstance(eng, JEngine) else tpoly)
                       .PolySynthConfig.pad())
    eng.add_instrument("pluck", "poly", (jpoly if isinstance(eng, JEngine) else tpoly)
                       .PolySynthConfig.pluck())
    trace = []
    eng.poly_chord_on("pad", "C", "major7", "drop2", 4, 0.8)
    eng.poly_note_on("pad", 72, 0.5)
    eng.poly_note_on("pad", 74, 0.5)      # the seventh note: steals the oldest lane
    eng.poly_chord_on("pluck", "A", "minor", "open", 3)
    trace.append(([list(map(dict, v)) for _k, v in sorted(eng._poly_lanes.items())],
                  list(eng._poly_queue)))
    eng._poly_queue.clear()
    eng.sample_count += 4096
    eng.poly_chord_off("pad", "C", "major7", "drop2", 4)
    eng.poly_note_on("pluck", 50)          # the pluck's lanes have ended: reuse
    eng.sample_count += 44100
    eng.poly_release_all("pad")
    eng.poly_note_on("pad", 60)
    trace.append(([list(map(dict, v)) for _k, v in sorted(eng._poly_lanes.items())],
                  list(eng._poly_queue)))
    return trace


def test_host_allocator_matches_jax():
    want = _host_ops(JEngine(SR, B))
    got = _host_ops(TEngine(SR, B, device="cpu"))
    assert got == want


def test_music_matches_jax():
    assert tmusic.NOTE_NAMES == jmusic.NOTE_NAMES
    for note in range(0, 128):
        assert tmusic.midi_to_freq(note) == jmusic.midi_to_freq(note)
    for name in tmusic.NOTE_NAMES:
        for octave in (-1, 2, 4, 8):
            assert tmusic.note_to_midi(name, octave) == jmusic.note_to_midi(name, octave)
        for quality in tmusic.CHORD_QUALITIES:
            for voicing in tmusic.VOICINGS:
                for octave in (2, 4, 9):
                    assert (tmusic.apply_voicing(tmusic.Chord(name, quality), voicing, octave)
                            == jmusic.apply_voicing(jmusic.Chord(name, quality), voicing,
                                                    octave))
        for scale in tmusic.SCALES:
            tk, jk = tmusic.Key(name, scale), jmusic.Key(name, scale)
            assert [(c.root, c.quality) for c in tk.diatonic_triads()] == \
                [(c.root, c.quality) for c in jk.diatonic_triads()]
            assert [(c.root, c.quality) for c in tk.diatonic_sevenths()] == \
                [(c.root, c.quality) for c in jk.diatonic_sevenths()]


def test_interop_round_trip():
    st = tpoly.init_state(3, tpoly.PolySynthConfig.strings(), device="cpu")
    st = st._replace(ever=torch.tensor([True, False] * 9), freq=torch.linspace(50, 900, 18))
    back = interop.family_state_from_numpy("poly", interop.to_numpy(st), "cpu")
    for a, b in zip(torch.utils._pytree.tree_leaves(st), torch.utils._pytree.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert back.ever.dtype == torch.bool
