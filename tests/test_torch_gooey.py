"""The port's ``GooeyEngine`` per-block path against the JAX ``GooeyEngine``,
on the CPU, with ``span_rendering=False`` on both: one session with every
strip sequenced at 2,400 BPM (a step every ~2 blocks of 128) with swing,
mute, pan and a hot-swap, per-step blends and notes (two strips with notes
in one block), manual triggers, the granulator on seeded noise, one rack, a
perf chord, first with every global effect off, then with saturation and
delay (one two-effect run) and two strips soloed; the strip peaks, the
MIDI-out queue and the graph's peaks compared too.  Then the device state
carried from the JAX engine to the port's (``interop.gooey_state_from_numpy``)
mid-session, and the non-slow cases of ``tests/test_gooey.py`` on the
port alone.

Bounds: audio <= 1e-4, peaks <= 1e-4; the MIDI-out queue equal.  One JAX
engine configuration (its kit compile, ~35 s cold), B = 128.
"""

import numpy as np
import pytest
import torch

from libgooey_tpu.core.blendable import PresetBlender as JPresetBlender
from libgooey_tpu.gooey import GooeyEngine as JGooey
from libgooey_tpu.instruments import snare as jsnare

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.core.blendable import PresetBlender as TPresetBlender
from libgooey_tpu_torch.gooey import INSTRUMENT_KICK, INSTRUMENT_TOM
from libgooey_tpu_torch.gooey import GooeyEngine as TGooey
from libgooey_tpu_torch.instruments import snare as tsnare
from libgooey_tpu_torch.instruments.kick import KickConfig
from libgooey_tpu_torch.mixer import chain as chain_mod
from libgooey_tpu_torch.performance import (
    MODE_PUNCH_OUT,
    TICKS_PER_STEP,
    PerformanceRecorder,
)

SR = 44100.0
B = 128
TOL = 1e-4
PEAK_TOL = 1e-4
N_HALF = 4


def _make(jax_side: bool):
    g = JGooey(SR, B) if jax_side else TGooey(SR, B, device="cpu")
    g.span_rendering = False
    g.set_bpm(2400.0)
    assert g.set_channel_instrument(2, INSTRUMENT_TOM)       # hot-swap: ch2 -> tom2
    for ch, pattern in enumerate(("x.x.x.x.x.x.x.x.", "xxxxxxxxxxxxxxxx", "x...x...x...x...",
                                  "x.x.x.x.x.x.x.x.", "x...x...x...x...")):
        seq = g.sequencers[ch]
        seq.set_pattern_string(pattern)
        seq.set_swing(0.6)
        seq.start()
    # notes on the kick's and the tom's step 0 (two strips in one block), the bass's
    g.sequencers[0].set_step_note(0, 40)
    g.sequencers[0].set_step_note(2, 47)
    g.sequencers[2].set_step_note(0, 52)
    g.sequencers[4].set_step_note(0, 36)
    # per-step blends on the snare strip
    snare = (jsnare if jax_side else tsnare).PRESETS
    blender = (JPresetBlender if jax_side else TPresetBlender)(
        snare["tight"](), snare["loose"](), snare["hiss"](), snare["smack"]())
    g.set_blender(1, blender)
    g.sequencers[1].set_step_blend(1, 0.9, 0.1)
    g.sequencers[1].set_step_blend(3, 0.2, 0.8)
    g.strip_pan[:] = [0.2, 0.4, 0.6, 0.8, 0.3]
    g.strip_gain[4] = 0.8
    g.strip_mute[3] = True
    g.trigger_channel(1, 0.9)
    # the granulator on seeded noise, triggered
    rng = np.random.default_rng(5)
    g.granulator_load(rng.standard_normal(4096).astype(np.float32) * 0.3, SR)
    g.granulator_set_param("density", 0.9)
    g.granulator_set_param("grain_length", 0.05)
    g.granulator_trigger(1.0)
    # one rack, a pad struck
    g.register_sampler_rack(0, arena_frames=1 << 13)
    buf = (np.sin(np.arange(2000) * 0.05) * 0.5).astype(np.float32)
    g.racks[0].set_buffer(3, np.stack([buf, buf * 0.5], axis=1), SR)
    g.sampler_trigger(0, 3, 0.9)
    # a perf chord on the poly
    g.perf_chord_on(0, 0, 0, 0, 1, 4, 0.8)
    g.set_master_gain(0.7)
    return g


def _second_half(g):
    for eid in (chain_mod.EFFECT_SATURATION, chain_mod.EFFECT_DELAY):
        g.set_effect_enabled(eid, True)
    g.set_effect_param(chain_mod.EFFECT_DELAY, 2, 0.6)
    g.strip_solo[0] = g.strip_solo[4] = True
    g.trigger_channel(4, 0.7)
    g.perf_chord_off()


def _peaks(g):
    return ([g.take_strip_peak(s) for s in range(5)],
            [g.graph.take_peak(t) for t in range(len(g.graph.tracks))])


@pytest.fixture(scope="module")
def jax_session():
    """The JAX engine's whole session: each half's audio, peaks and
    MIDI-out queue, and its device state after the first half."""
    g = _make(True)
    first = g.render(N_HALF * B)
    midi1 = g.drain_midi_out()
    state = interop.gooey_state_from_numpy(g, "cpu")
    peaks1 = _peaks(g)
    _second_half(g)
    second = g.render(N_HALF * B)
    assert g.error is None, g.error
    return dict(first=first, midi1=midi1, peaks1=peaks1, state=state, second=second,
                midi2=g.drain_midi_out(), peaks2=_peaks(g))


def _check_half(got, want, midi_got, midi_want, peaks_got, peaks_want):
    err = float(np.abs(got - want).max())
    assert err <= TOL, err
    assert float(np.abs(want).max()) > 1e-3
    assert [(s, n) for s, n, _ in midi_got] == [(s, n) for s, n, _ in midi_want]
    np.testing.assert_allclose([v for _, _, v in midi_got], [v for _, _, v in midi_want],
                               rtol=0, atol=0)
    for a, b in zip(peaks_got, peaks_want):
        np.testing.assert_allclose(a, b, rtol=0, atol=PEAK_TOL)


def test_per_block_session_vs_jax(jax_session):
    """Every strip, blends and notes, the granulator, a rack and a chord,
    effects off; then saturation + delay and two strips soloed."""
    t = _make(False)
    first = t.render(N_HALF * B)
    assert t.error is None, t.error
    midi1 = t.drain_midi_out()
    _check_half(first, jax_session["first"], midi1, jax_session["midi1"], _peaks(t),
                jax_session["peaks1"])
    assert len(midi1) >= 6
    assert max(jax_session["peaks1"][0]) > 1e-3
    _second_half(t)
    second = t.render(N_HALF * B)
    assert t.error is None, t.error
    _check_half(second, jax_session["second"], t.drain_midi_out(), jax_session["midi2"],
                _peaks(t), jax_session["peaks2"])
    # the note overrides are restored
    assert t.get_param(0, "frequency") == pytest.approx(KickConfig().frequency)


def test_state_carried_from_jax(jax_session):
    """The JAX engine's device state after the first half, loaded into a
    port engine driven alike (its host objects advanced by its own first
    half): the second halves agree."""
    t = _make(False)
    t.render(N_HALF * B)
    t.drain_midi_out()
    _peaks(t)
    interop.load_gooey_state(t, jax_session["state"])
    want = jax_session["state"]
    assert torch.equal(t.gran_state.src_pos, want.gran.src_pos)
    assert torch.equal(t.engine._state["snare"].params.current,
                       want.engine["snare"].params.current)
    _second_half(t)
    second = t.render(N_HALF * B)
    assert t.error is None, t.error
    err = float(np.abs(second - jax_session["second"]).max())
    assert err <= TOL, err


# --- tests/test_gooey.py's non-slow cases, on the port (B = 128) ---------------------------------


def _small():
    return TGooey(SR, B, device="cpu")


def test_render_stereo_contract_and_error_latch():
    g = _small()
    g.trigger_channel(0, 1.0)
    out = g.render(4 * B)
    assert out.shape == (8 * B,) and out.dtype == np.float32
    l, r = out[0::2], out[1::2]
    np.testing.assert_allclose(l, r, atol=1e-6)  # a center-panned kick
    assert np.abs(l).max() > 1e-4
    msgs = []
    g.error_callback = msgs.append
    g.graph = None  # sabotage
    out = g.render(B)
    assert np.all(out == 0.0) and g.error is not None and msgs
    out = g.render(2 * B)
    assert out.shape == (4 * B,) and np.all(out == 0.0)  # terminal


def test_channel_instrument_hot_swap():
    g = _small()
    g.trigger_channel(1, 1.0)  # the snare by default
    a = g.render(4 * B)
    g2 = _small()
    assert g2.set_channel_instrument(1, 0)  # swap to the kick
    assert g2.get_channel_instrument(1) == 0
    assert not g2.set_channel_instrument(4, 0) and not g2.set_channel_instrument(0, 5)
    g2.trigger_channel(1, 1.0)
    b = g2.render(4 * B)
    assert np.abs(a - b).max() > 1e-3


def test_hot_swap_moves_the_strip_peak():
    """After a hot-swap mid-session the strip's peak meters its new
    instrument (the strips' voice indices are rebuilt with the scatter)."""
    g = _small()
    g.render(2 * B)
    g.take_strip_peak(1)
    g.set_channel_instrument(1, INSTRUMENT_KICK)
    g.trigger_channel(1, 1.0)
    g.render(2 * B)
    assert g.take_strip_peak(1) > 1e-3


def test_strip_mute_solo_and_peaks():
    g = _small()
    g.trigger_channel(0, 1.0)
    g.strip_mute[0] = True
    out = g.render(4 * B)
    assert np.abs(out).max() < 1e-4  # a muted strip gates its trigger
    assert g.take_strip_peak(0) == 0.0
    g = _small()
    g.strip_solo[1] = True  # solo the snare strip: the kick is inaudible
    g.trigger_channel(0, 1.0)
    out = g.render(4 * B)
    assert np.abs(out).max() < 1e-4
    g = _small()
    g.trigger_channel(0, 1.0)
    g.render(4 * B)
    assert g.take_strip_peak(0) > 1e-3
    assert g.take_strip_peak(0) == 0.0   # read and reset


def test_blend_pad_snaps_config():
    g = _small()
    assert not g.blend_to(0, 1.0, 0.0)
    g.set_blender(0, TPresetBlender(KickConfig.tight(), KickConfig.dirt(), KickConfig.loose(),
                                    KickConfig.punch_preset()))
    assert g.blend_to(0, 1.0, 0.0)
    assert abs(g.get_param(0, "frequency") - 0.62) < 1e-6  # the dirt corner


def test_param_round_trip():
    g = _small()
    g.set_param(0, "frequency", 0.42)
    assert abs(g.get_param(0, "frequency") - 0.42) < 1e-7
    g.set_effect_param(1, 1, 0.66)  # the delay's feedback
    assert abs(g.get_effect_param(1, 1) - 0.66) < 1e-6
    g.granulator_set_param("pitch", 1.5)
    assert g._gran_targets[3] == 1.0 and g.gran_host.cfg["pitch"] == 1.0
    assert not g.set_effect_order([0, 1, 2])
    assert g.set_effect_order([9, 6, 8, 7, 3, 1, 4, 0, 2])
    assert g.fx.order() == (9, 6, 8, 7, 3, 1, 4, 0, 2)


def test_midi_out_cap_and_bounce(tmp_path):
    g = _small()
    g.set_bpm(9600.0)
    for ch in range(5):
        g.sequencers[ch].set_pattern_string("x" * 16)
        g.sequencers[ch].start()
    inter = g.bounce_to_wav(tmp_path / "b.wav", 8 * B)
    assert inter.shape == (8 * B * 2,) and inter.dtype == np.float32
    assert (tmp_path / "b.wav").stat().st_size > 8 * B * 2 * 2
    assert len(g.drain_midi_out()) == 64 and g.drain_midi_out() == []


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TGooey()


def test_performance_recorder_loop_and_replay():
    p = PerformanceRecorder()
    p.update_clock(0.0, True)
    p.set_armed(True)
    p.update_clock(0.0, True)
    assert p.is_recording()
    p.last_beat = 0.25  # step 1
    p.record_chord_on(0, 0, 0, 0, 0, 4, 0.9)
    p.last_beat = 0.75
    p.record_chord_off()
    assert len(p.events) == 1
    ev = p.events[0]
    assert ev.start_tick == TICKS_PER_STEP and ev.duration_ticks == 2 * TICKS_PER_STEP
    p.set_armed(False)
    fired = []
    for beat in np.arange(4.0, 8.0, 0.01):  # the loop's second pass
        a = p.update_clock(float(beat), True)
        if a is not None:
            fired.append((round(beat, 2), a[0]))
    kinds = [k for _, k in fired]
    assert "trigger" in kinds and "release" in kinds
    trig_beat = fired[kinds.index("trigger")][0]
    assert abs((trig_beat % 4.0) - 0.25) < 0.02


def test_performance_punch_out_disarms():
    p = PerformanceRecorder()
    p.mode = MODE_PUNCH_OUT
    p.update_clock(0.0, True)
    p.set_armed(True)
    p.update_clock(0.0, True)
    assert p.is_recording()
    for beat in np.arange(0.0, 4.2, 0.05):
        p.update_clock(float(beat), True)
    assert not p.armed and not p.is_recording()
