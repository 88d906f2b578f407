"""The port's whole ``Engine`` against the JAX ``Engine``, on the CPU: all
eight families in one engine with LFO routes, poly chords and notes (a
synth struck seven times in a block: ``[V, K]`` slots), per-step preset
blends and ``set_config``; the host API (``get_param``, the MIDI-out queue
with its 64-event cap, ``add_global_effect``'s stored options); the bounce
methods and ``bounce_to_wav``'s file; and ``_render_all``'s
``collect_sources`` scatter.

Bounds: audio and sources <= 1e-4.  The kick's and snare's additive
triangles run at 0 and 16 harmonics and the tom's at 16, to keep the JAX
compile of the eight-family block short (tests/test_torch_hihat_tom.py
holds the tom at 128).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from libgooey_tpu import io_wav as jio_wav
from libgooey_tpu.core.blendable import PresetBlender as JPresetBlender
from libgooey_tpu.core.smoother import SmootherBank as JSmootherBank
from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.engine import engine as jengine
from libgooey_tpu.engine.engine import FAMILIES as JFAMILIES
from libgooey_tpu.engine.engine import Engine as JEngine

from libgooey_tpu_torch import interop
from libgooey_tpu_torch import io_wav as tio_wav
from libgooey_tpu_torch.core.blendable import PresetBlender as TPresetBlender
from libgooey_tpu_torch.engine import engine as tengine
from libgooey_tpu_torch.engine.engine import FAMILIES as TFAMILIES
from libgooey_tpu_torch.engine.engine import Engine as TEngine

SR = 44100.0
B = 128
OUT_TOL = 1e-4
STATIC = {"kick": {"max_harmonics": 0, "feedback_path": False},
          "snare": {"max_harmonics": 16}, "tom": {"max_harmonics": 16}}
ALL = (("kick", "tight"), ("snare", "default"), ("hh", "hihat", "open_default"),
       ("hihat", "closed_tight"), ("hihat2", "loose"), ("tom", "low"), ("tom2", "default"),
       ("bass", "default"), ("pad", "poly", "pad"), ("pluck", "poly", "pluck"))


def _eight(jax_side: bool):
    """An engine with every family (two hihats and two polys), each on a
    sequencer, with four LFO routes (bass cutoff at 1/8, the kick's pitch,
    the open hat's decay, the pad's cutoff) and preset blends on the
    snare's steps."""
    eng = JEngine(SR, B, family_static=STATIC) if jax_side else TEngine(
        SR, B, family_static=STATIC, device="cpu")
    fams = JFAMILIES if jax_side else TFAMILIES
    for i, entry in enumerate(ALL):
        name, kind, preset = (entry[0], entry[0], entry[1]) if len(entry) == 2 else entry
        eng.add_instrument(name, kind, fams[kind].PRESETS[preset]())
        eng.set_pan(name, i / (len(ALL) - 1))
        seq = eng.new_sequencer(name, 480.0 + 40.0 * i)
        seq.set_pattern([(s + i) % 3 == 0 for s in range(16)])
        if kind in ("bass", "poly"):
            seq.set_step_note(i % 3, 40 + i)
        seq.start()
    snare = fams["snare"].PRESETS
    blender = (JPresetBlender if jax_side else TPresetBlender)(
        snare["default"](), snare[sorted(snare)[1]](), snare[sorted(snare)[2]]())
    eng.blenders["snare"] = blender
    snare_seq = eng.sequencers[1]
    snare_seq.set_step_with_settings(1, True, 1.0, blend=(1.0, 0.0))
    snare_seq.set_step_blend(4, 0.3, 0.8)
    eng.set_lfo(0, division=5, bpm=140.0, amount=0.5)
    eng.add_lfo_route(0, "bass", "filter_cutoff", depth=0.8)
    eng.set_lfo(1, frequency_hz=0.8, amount=0.2)
    eng.add_lfo_route(1, "kick", "frequency", depth=0.5)
    eng.set_lfo(2, frequency_hz=5.0)
    eng.add_lfo_route(2, "hh", "decay", depth=0.6)
    eng.set_lfo(3, frequency_hz=2.0, offset=0.2)
    eng.add_lfo_route(3, "pad", "filter_cutoff")
    eng.add_global_effect("lowpass", [9000.0, 0.3], pingpong=False, note="kept")
    return eng


def _drive(eng, n_blocks):
    outs = []
    for blk in range(n_blocks):
        if blk == 0:
            eng.poly_chord_on("pad", "C", "dominant13", "root", 4, 0.9)   # six lanes
            eng.trigger("pad", 0.7, offset=50)       # a seventh note steals lane 0
        if blk == 2:
            eng.poly_chord_on("pluck", "A", "minor", "open", 3)
            cfg = (JFAMILIES if isinstance(eng, JEngine) else TFAMILIES)["tom"].PRESETS["high"]()
            eng.set_config("tom", cfg)
        if blk == 4:
            eng.poly_chord_off("pad", "C", "dominant13")
            eng.set_param("bass", "filter_resonance", 0.9)
        if blk == 5:
            eng.poly_release_all("pluck")
        out, mono = eng.render_block()
        outs.append((np.asarray(out), np.asarray(mono)))
    return np.stack([o for o, _ in outs]), np.stack([m for _, m in outs])


def test_eight_families_with_routes_chords_and_blends_match_jax(tmp_path):
    jeng, teng = _eight(True), _eight(False)
    want, want_mono = _drive(jeng, 7)
    got, got_mono = _drive(teng, 7)
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= OUT_TOL
    assert np.abs(got_mono - want_mono).max() <= OUT_TOL
    # the host mirrors: blended and set targets, the poly lanes, MIDI out
    for name, param in (("snare", "decay"), ("snare", "tonal"), ("tom", "frequency"),
                        ("bass", "filter_resonance"), ("pad", "amp_release")):
        assert teng.get_param(name, param) == jeng.get_param(name, param)
    assert teng._poly_lanes == jeng._poly_lanes
    assert teng._snap_queue == jeng._snap_queue
    assert teng.drain_midi_out() == jeng.drain_midi_out() and teng.midi_out == []
    assert teng.fx_extra == jeng.fx_extra == {"lowpass": {"pingpong": False, "note": "kept"}}

    # bounce: transport reset, master snapped, mono render; then the WAV
    jbuf = jeng.bounce_to_buffer(3 * B + 5)
    tbuf = teng.bounce_to_buffer(3 * B + 5)
    assert tbuf.shape == (3 * B + 5,) and np.abs(jbuf).max() > 1e-3
    assert np.abs(tbuf - jbuf).max() <= OUT_TOL
    assert teng.bounce_samples_for(120.0, bars=2) == jeng.bounce_samples_for(120.0, bars=2)
    assert teng.bounce_samples_for(90.0, beats=3.5) == jeng.bounce_samples_for(90.0, beats=3.5)
    assert teng.bounce_samples_for(90.0, samples=77) == 77
    for bits in (16, 24, 32):
        jp, tp = tmp_path / f"j{bits}.wav", tmp_path / f"t{bits}.wav"
        jbuf = jeng.bounce_to_wav(jp, 2 * B, bits=bits)
        tbuf = teng.bounce_to_wav(tp, 2 * B, bits=bits)
        jb, tb = jp.read_bytes(), tp.read_bytes()
        assert tb[:44] == jb[:44] and len(tb) == len(jb)
        # the port's copy of io_wav writes what the JAX package's writes
        jio_wav.write_wav(tmp_path / "x.wav", tbuf, int(SR), bits=bits)
        assert (tmp_path / "x.wav").read_bytes() == tb
        tx, rate = tio_wav.read_wav(tp)
        jx, _ = jio_wav.read_wav(jp)
        assert rate == int(SR) and np.abs(tx - jx).max() <= OUT_TOL + 2.0 / 32768


@pytest.mark.parametrize("blend", [(1.0, 0.0), (0.3, 0.7)])
def test_blend_snap_on_step_matches_jax(blend):
    """tests/test_engine.py's blend snap: a kick sequencer whose first step
    carries an X/Y blend over four presets; the step restages the kick's
    targets and snaps its smoothers to them, before the block renders."""
    outs, params = [], []
    for eng in (JEngine(SR, B, family_static=STATIC),
                TEngine(SR, B, family_static=STATIC, device="cpu")):
        presets = (JFAMILIES if isinstance(eng, JEngine) else TFAMILIES)["kick"].PRESETS
        eng.add_instrument("kick", "kick", presets["tight"]())
        blender = (JPresetBlender if isinstance(eng, JEngine) else TPresetBlender)
        eng.blenders["kick"] = blender(presets["tight"](), presets["dirt"](),
                                       presets["loose"](), presets["punch"]())
        seq = eng.new_sequencer("kick", 240.0)
        seq.set_step_with_settings(0, True, 1.0, blend=blend)
        seq.start()
        outs.append(eng.render_mono(4 * B))
        params.append([eng.get_param("kick", p) for p in TFAMILIES["kick"].PARAM_NAMES])
    assert np.abs(outs[0]).max() > 1e-4
    assert np.abs(outs[1] - outs[0]).max() <= OUT_TOL
    assert params[1] == params[0]
    if blend == (1.0, 0.0):     # the full "dirt" corner, as tests/test_engine.py
        assert abs(params[1][TFAMILIES["kick"].PARAM_INDEX["frequency"]] - 0.62) < 1e-6


def test_midi_out_cap_and_config_api_match_jax():
    """The MIDI-out queue keeps the last 64 events (silent drop), with
    sample offsets; ``set_config``/``get_param`` round-trip; host only."""
    engs = (JEngine(SR, B), TEngine(SR, B, device="cpu"))
    for eng in engs:
        fams = JFAMILIES if isinstance(eng, JEngine) else TFAMILIES
        eng.add_instrument("k", "kick")
        eng.add_instrument("h", "hihat")
        for name in ("k", "h"):
            seq = eng.new_sequencer(name, 2000.0)
            seq.set_pattern([True] * 16)
            seq.start()
        eng.set_config("h", fams["hihat"].PRESETS["open_long"]())
        eng.set_param("k", "sub", 0.123)
        for _ in range(120):      # ~92 sequenced events
            eng._stage()
            eng._collect_events()
            eng.sample_count += B
    jeng, teng = engs
    assert len(teng.midi_out) == 64
    assert teng.drain_midi_out() == jeng.drain_midi_out()
    assert teng.drain_midi_out() == []
    for param in TFAMILIES["hihat"].PARAM_NAMES:
        assert teng.get_param("h", param) == jeng.get_param("h", param)
    assert teng.get_param("k", "sub") == jeng.get_param("k", "sub") == np.float32(0.123)
    assert teng._configs["hihat"][0] == TFAMILIES["hihat"].PRESETS["open_long"]()


@pytest.mark.parametrize("pan_moving", [False, True])
def test_collect_sources_matches_jax(pan_moving):
    """``_render_all(collect_sources=True)``: the panned, gained voices
    scattered through a ``[S, V]`` matrix, the raw voices and their peaks,
    and the pan and gain smoothers advanced."""
    from libgooey_tpu.instruments import hihat as jhihat
    from libgooey_tpu.instruments import kick as jkick

    rs = np.random.RandomState(11)
    nk, nh = 4, 2
    pan = rs.rand(nk + nh).astype(np.float32)
    jstate = {"kick": jkick.init_state(nk), "hihat": jhihat.init_state(nh),
              "pan": JSmootherBank(jnp.asarray(pan),
                                   jnp.asarray(pan[::-1].copy() if pan_moving else pan)),
              "gain": JSmootherBank.init(rs.rand(nk + nh).astype(np.float32)),
              "master": JSmootherBank.init(np.float32(0.25))}
    tstate = interop.engine_state_from_numpy(jstate, "cpu")
    static = dict(kinds=("kick", "hihat"), sample_rate=SR, block_size=B,
                  smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
                  family_static=(("kick", (("feedback_path", False),
                                           ("max_harmonics", 0))),),
                  collect_sources=True)
    matrix = (rs.rand(3, nk + nh) < 0.6).astype(np.float32)
    for blk in range(2):
        events = {"kick_off": np.array([0, 30, B, 100], np.int32) if blk == 0
                  else np.full(nk, B, np.int32),
                  "kick_vel": np.full(nk, 0.9, np.float32),
                  "hihat_off": np.array([5, B] if blk == 0 else [B, 64], np.int32),
                  "hihat_vel": np.full(nh, 0.8, np.float32),
                  "block_start": np.int32(blk * B), "source_matrix": matrix}
        jstate, jsrc, jvoices, jpeaks = jengine._render_all_jit(
            jstate, {k: jnp.asarray(v) for k, v in events.items()}, **static)
        tstate, tsrc, tvoices, tpeaks = tengine._render_all(tstate, events, **static)
        assert tsrc.shape == (3, 2, B)
        assert np.abs(tsrc.numpy() - np.asarray(jsrc)).max() <= OUT_TOL
        assert np.abs(tvoices.numpy() - np.asarray(jvoices)).max() <= OUT_TOL
        assert np.abs(tpeaks.numpy() - np.asarray(jpeaks)).max() <= OUT_TOL
        for key in ("pan", "gain"):
            assert np.abs(tstate[key].current.numpy()
                          - np.asarray(jstate[key].current)).max() <= 1e-6
    assert np.abs(np.asarray(jsrc)).max() > 1e-3
