"""The port's capi held to the JAX capi, on the CPU.

One script of C-API calls goes through ``libgooey_tpu.capi`` and
``libgooey_tpu_torch.capi`` alike: setters across the families (typed and
integer-id params, the snare's static ``filter_type``, strip gain, pan and
mute, a hot-swap, the master gain), sequencer steps with velocities, notes
and a blend, an LFO route, two global effects, the granulator on seeded
noise, a poly chord and a manual trigger.  Every getter of the session
agrees (exact: host state, ids and counts; the strip and track peaks within
1e-4), before and after ``engine_render(h, 1024)`` (two blocks of 512
through the span), whose audio agrees within 1e-4.  Then
the two modules' surfaces: the same function names, argument names and id
tables.

One JAX ``GooeyEngine`` span is compiled (two blocks with a two-effect run;
~55 s cold, ~10 s warm).
"""

import inspect

import numpy as np
import pytest

from libgooey_tpu import capi as jcapi
from libgooey_tpu_torch import capi as tcapi

SR = 44100.0
TOL = 1e-4
N_RENDERS = 1
FRAMES = 1024


def _script(capi, h):
    capi.engine_set_bpm(h, 2400.0)            # a 16th every ~276 samples
    capi.engine_set_master_gain(h, 0.8)
    assert capi.engine_set_channel_instrument(h, 2, 3) == 1     # ch2 -> tom2
    assert capi.engine_set_kick_param(h, 0, 1, 0.8) == 1        # punch
    assert capi.engine_set_channel_param(h, 0, 4, 0.6) == 1     # oscillator_decay
    assert capi.engine_set_channel_param(h, 1, 12, 2) == 1      # snare filter_type
    assert capi.engine_set_snare_param(h, 1, 10, 0.35) == 1     # filter_cutoff
    assert capi.engine_set_tom_param(h, 2, 0, 60.0) == 1        # tune
    assert capi.engine_set_hihat_param(h, 3, 1, 0.4) == 0       # ch3 is a tom2
    assert capi.engine_set_bass_param(h, 6, 0.45) == 1          # filter_cutoff
    assert capi.engine_set_channel_tuning(h, 0, 0.55) == 1
    assert capi.engine_set_instrument_gain(h, 4, 0.8) == 1
    assert capi.engine_set_instrument_pan(h, 1, 0.3) == 1
    assert capi.engine_set_instrument_mute(h, 3, 1) == 1
    for ch, bits in enumerate((0b0101010101010101, 0b1111111111111111, 0b0001000100010001,
                               0b0101010101010101, 0b0001000100010001)):
        capi.engine_sequencer_set_instrument_pattern(h, ch, bits)
        capi.engine_sequencer_set_swing(h, ch, 0.6)
    capi.engine_sequencer_set_instrument_step_with_settings(h, 1, 1, 1, 0.7)
    capi.engine_sequencer_set_instrument_step_velocity(h, 0, 2, 0.9)
    capi.engine_sequencer_set_instrument_step_note(h, 0, 0, 40)
    capi.engine_sequencer_set_instrument_step_note(h, 4, 0, 36)
    assert capi.engine_blend_enable(h, 1) == 1
    assert capi.engine_blend_set_corner_preset(h, 1, 2, 3) == 1
    capi.engine_sequencer_set_instrument_step_blend(h, 1, 2, 0.9, 0.1)
    assert capi.engine_set_lfo_timing(h, 0, 6) == 1
    capi.engine_set_lfo_amount(h, 0, 0.3)
    capi.engine_set_lfo_offset(h, 0, 0.1)
    assert capi.engine_add_lfo_route(h, 0, 1, 10, 0.5) == 1     # snare filter_cutoff
    assert capi.engine_add_lfo_route(h, 1, 2, 0) == 0           # tom2: not modulatable
    capi.engine_set_effect_enabled(h, 2, 1)                     # saturation
    capi.engine_set_effect_enabled(h, 1, 1)                     # delay
    assert capi.engine_set_effect_param(h, 1, 1, 0.55) == 1
    rng = np.random.default_rng(7)
    noise = (rng.standard_normal(4096) * 0.3).astype(np.float32)
    assert capi.engine_granulator_set_buffer(h, noise, SR) == 1
    capi.engine_granulator_set_seed(h, 99)
    assert capi.engine_granulator_set_param(h, 4, 0.9) == 1     # density
    assert capi.engine_granulator_set_param(h, 1, 0.05) == 1    # grain_length
    capi.engine_granulator_trigger(h, 1.0)
    assert capi.engine_poly_set_preset(h, 1) == 1               # pad
    assert capi.engine_poly_trigger_chord(h, 2, 0, 1, 0, 1, 4, 0.8) == 1
    for ch in range(5):
        capi.engine_sequencer_start(h, ch)
    capi.engine_trigger_instrument_with_velocity(h, 4, 0.7)


def _getters(capi, h):
    """Every getter of the session: ``(name, args, value)``."""
    calls = [("engine_get_bpm", ()), ("engine_get_master_gain", ()),
             ("engine_has_error", ()), ("engine_is_link_enabled", ()),
             ("engine_instrument_count", ()), ("engine_transport_beat", ()),
             ("engine_transport_get_beat_position", ()),
             ("engine_global_effect_count", ()), ("engine_get_effect_order", ()),
             ("engine_get_compressor_sidechain", ()), ("engine_mixer_get_track_count", ()),
             ("engine_granulator_buffer_len", ()), ("engine_granulator_buffer_sample_rate", ()),
             ("engine_granulator_active_grain_count", ()), ("engine_perf_is_record_armed", ()),
             ("engine_perf_get_event_count", ()), ("engine_perf_get_length_steps", ()),
             ("engine_get_lfo_route_count", ())]
    for ch in range(5):
        calls += [("engine_get_instrument_gain", (ch,)), ("engine_get_instrument_pan", (ch,)),
                  ("engine_get_instrument_mute", (ch,)), ("engine_get_instrument_solo", (ch,)),
                  ("engine_get_channel_tuning", (ch,)), ("engine_get_swing", (ch,)),
                  ("engine_sequencer_step_count", (ch,)),
                  ("engine_sequencer_get_current_step", (ch,)),
                  ("engine_sequencer_get_step_with_lookahead", (ch, 300)),
                  ("engine_sequencer_get_beat_position", (ch,)),
                  ("engine_get_sequencer_triggers_enabled", (ch,)),
                  ("engine_blend_is_enabled", (ch,)), ("engine_blend_get_position_x", (ch,)),
                  ("engine_blend_get_position_y", (ch,))]
        for step in range(16):
            calls += [(f"engine_sequencer_get_instrument_step_{what}", (ch, step))
                      for what in ("enabled", "velocity", "note", "blend_x", "blend_y",
                                   "blend_enabled")]
    for ch in range(4):
        calls.append(("engine_get_channel_instrument", (ch,)))
        n = {0: 8, 1: 20, 2: 6, 3: 9, 4: 16}[capi.engine_get_channel_instrument(h, ch)]
        calls += [("engine_get_channel_param", (ch, p)) for p in range(n)]
    calls += [("engine_get_kick_param", (0, p)) for p in range(8)]
    calls += [("engine_get_snare_param", (1, p)) for p in range(20)]
    calls += [("engine_get_tom_param", (2, p)) for p in range(9)]
    calls += [("engine_get_bass_param", (p,)) for p in range(16)]
    calls += [("engine_blend_get_corner_preset", (1, c)) for c in range(4)]
    for lfo in range(8):
        calls += [(f"engine_get_lfo_{what}", (lfo,))
                  for what in ("timing", "amount", "offset", "enabled", "phase", "route_count")]
    for eid in range(10):
        calls.append(("engine_get_global_effect_enabled", (eid,)))
    for eid, n in ((0, 2), (1, 4), (2, 3), (3, 5), (4, 2)):
        calls += [("engine_get_effect_param", (eid, p)) for p in range(n)]
    calls += [("engine_poly_get_param", (p,)) for p in range(14)]
    calls += [("engine_granulator_get_param", (p,)) for p in range(12)]
    for t in range(4):
        calls += [(f"engine_mixer_get_track_{what}", (t,))
                  for what in ("name", "gain", "pan", "mute", "solo")]
        calls.append(("engine_track_effect_count", (t,)))
    calls += [("engine_mixer_get_source_route", (s,)) for s in range(9)]
    return [(name, args, getattr(capi, name)(h, *args)) for name, args in calls]


def _peaks(capi, h):
    return (capi.engine_get_channel_peaks(h),
            [capi.engine_mixer_get_track_peak(h, t) for t in range(4)])


def _midi(capi, h):
    return capi.engine_drain_midi_events_flat(h)


def _session(capi, monkeypatch):
    if capi is tcapi:
        monkeypatch.setenv(tcapi.DEVICE_ENV, "cpu")
    h = capi.engine_new(SR)
    _script(capi, h)
    rec = dict(getters=[_getters(capi, h)], audio=[], peaks=[], midi=[])
    for _ in range(N_RENDERS):
        rec["audio"].append(capi.engine_render(h, FRAMES))
        rec["getters"].append(_getters(capi, h))
        rec["peaks"].append(_peaks(capi, h))
        rec["midi"].append(_midi(capi, h))
    rec["error"] = capi.engine_last_error(h)
    capi.engine_free(h)
    return rec


@pytest.fixture(scope="module")
def jax_session():
    with pytest.MonkeyPatch.context() as mp:
        return _session(jcapi, mp)


def test_scripted_session_matches_jax(jax_session, monkeypatch):
    got = _session(tcapi, monkeypatch)
    want = jax_session
    assert got["error"] == "" and want["error"] == "", (got["error"], want["error"])
    for i, (g_list, w_list) in enumerate(zip(got["getters"], want["getters"])):
        assert len(g_list) == len(w_list) > 800
        for (name, args, g), (_, _, w) in zip(g_list, w_list):
            assert type(g) is type(w) or (isinstance(w, float) and type(g) is float), \
                (i, name, args, type(g), type(w))
            assert g == w, (i, name, args, g, w)
    for g, w in zip(got["audio"], want["audio"]):
        assert g.dtype == np.float32 and g.shape == w.shape == (2 * FRAMES,)
        err = float(np.abs(g - w).max())
        assert err <= TOL, err
    assert float(np.abs(want["audio"][-1]).max()) > 1e-3
    for (gs, gt), (ws, wt) in zip(got["peaks"], want["peaks"]):
        np.testing.assert_allclose(gs, ws, rtol=0, atol=TOL)
        np.testing.assert_allclose(gt, wt, rtol=0, atol=TOL)
    assert max(want["peaks"][0][0]) > 1e-3
    for g, w in zip(got["midi"], want["midi"]):
        assert [(s, k) for s, k, _ in g] == [(s, k) for s, k, _ in w]
        np.testing.assert_array_equal([v for _, _, v in g], [v for _, _, v in w])
    assert sum(len(m) for m in want["midi"]) >= 6


def _functions(mod):
    return {n: f for n, f in vars(mod).items()
            if inspect.isfunction(f) and f.__module__ == mod.__name__}


def test_same_functions_and_arguments():
    """Every module-level function of the JAX capi, under the same name, with
    the same argument names and defaults."""
    jf, tf = _functions(jcapi), _functions(tcapi)
    assert set(jf) <= set(tf), sorted(set(jf) - set(tf))
    assert {n for n in tf if not n.startswith("_")} == {n for n in jf if not n.startswith("_")}
    assert len([n for n in jf if not n.startswith("_")]) > 250
    for name, f in jf.items():
        want = [(p.name, p.default) for p in inspect.signature(f).parameters.values()]
        got = [(p.name, p.default) for p in inspect.signature(tf[name]).parameters.values()]
        assert got == want, name


def test_same_id_tables():
    for name in ("KICK_PARAMS", "HIHAT_PARAMS", "SNARE_PARAMS", "TOM_PARAMS", "BASS_PARAMS",
                 "GRANULATOR_PARAMS", "KICK_PRESETS_BY_ID", "TOM_PRESETS_BY_ID",
                 "SNARE_PRESETS_BY_ID", "HIHAT_PRESETS_BY_ID", "BASS_PRESETS_BY_ID",
                 "POLY_PRESETS_BY_ID", "NUM_LFOS", "LFO_TIMING_COUNT",
                 "REORDERABLE_EFFECT_COUNT", "_FAMILY_TABLES", "_PRESETS_BY_KIND"):
        assert getattr(tcapi, name) == getattr(jcapi, name), name
