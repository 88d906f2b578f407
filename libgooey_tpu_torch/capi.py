"""C-ABI adapter: integer-id parameter dispatch for the native shim (port of
libgooey_tpu/capi.py).

Maps the FFI's integer constants (ffi.rs:1548-1970, the ABI the iOS host
compiles against) onto the port's ``GooeyEngine``.  The port's native shim
(``libgooey_tpu_torch/native/gooey_shim.cpp``) calls these flat functions
through the embedded interpreter; everything here must stay exception-safe
per the C contract (the shim converts Python exceptions into the engine
error latch).

Each engine lives on a CUDA card unless the caller asks for another device
through ``LIBGOOEY_TPU_TORCH_DEVICE`` (``cpu`` for the tests); with no card
and no such request ``engine_new`` raises, and the shim returns handle 0
with the error latched.  Every getter reads host state; the strip and track
peaks are the one read of the card (``take_strip_peak``,
``graph.take_peak``).  Audio and float arrays come back as contiguous
float32 numpy arrays (the shim copies them through the buffer protocol),
ids and counts as Python ints.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np

from libgooey_tpu_torch import music as _music
from libgooey_tpu_torch.core.blendable import PresetBlender
from libgooey_tpu_torch.engine.engine import FAMILIES
from libgooey_tpu_torch.engine.lfo import DIVISION_BEATS
from libgooey_tpu_torch.gooey import (
    INSTRUMENT_KINDS,
    NUM_KIT_CHANNELS,
    SAMPLER_RACK_MAX,
    GooeyEngine,
)
from libgooey_tpu_torch.instruments import bass as _bass
from libgooey_tpu_torch.instruments import poly as _poly
from libgooey_tpu_torch.mixer import chain as _chain
from libgooey_tpu_torch.mixer import graph as _graph
from libgooey_tpu_torch.mixer.clip_grid import CLIP_COLUMNS, CLIP_ROWS
from libgooey_tpu_torch.mixer.stereo_buffer import StereoSampleBuffer
from libgooey_tpu_torch.performance import TICKS_PER_STEP

#: the environment variable that names the engines' torch device ("cuda"
#: when unset; "cpu" only where the caller asks for it)
DEVICE_ENV = "LIBGOOEY_TPU_TORCH_DEVICE"

# Per-instrument-family param-id → smoothed-param name (§2.9 constants).
KICK_PARAMS = (
    "frequency", "punch", "sub", "click", "oscillator_decay",
    "pitch_envelope_amount", "volume", "tuning",
)
HIHAT_PARAMS = ("pitch", "decay", "attack", "tone", "volume", "tuning")  # HiHat2
SNARE_PARAMS = (
    "frequency", "decay", "brightness", "volume", "tonal", "noise",
    "pitch_drop", "tonal_decay", "noise_decay", "noise_tail_decay",
    "filter_cutoff", "filter_resonance", "filter_type", "xfade",
    "phase_mod_amount", "overdrive", "amp_decay", "amp_decay_curve",
    "tonal_decay_curve", "tuning",
)
TOM_PARAMS = (  # Tom2 (0-100 Max ranges except tuning)
    "tune", "bend", "tone", "color", "decay", "membrane", "membrane_q",
    "volume", "tuning",
)
BASS_PARAMS = (
    "frequency", "sub_level", "osc_level", "detune_level", "detune_amount",
    "osc_shape", "filter_cutoff", "filter_resonance", "filter_env_amount",
    "filter_env_decay", "filter_env_curve", "amp_decay", "amp_decay_curve",
    "overdrive", "volume", "tuning",
)
GRANULATOR_PARAMS = (
    "scan_position", "grain_length", "spray", "pitch", "density", "texture",
    "direction", "cloud_duration", "volume", "random_timing", "random_amp",
    "drive",
)

_FAMILY_TABLES = {
    "kick": KICK_PARAMS,
    "snare": SNARE_PARAMS,
    "hihat2": HIHAT_PARAMS,
    "tom2": TOM_PARAMS,
    "bass": BASS_PARAMS,
}

_engines = {}
_next_handle = 1


def engine_new(sample_rate: float) -> int:
    """A new engine on ``$LIBGOOEY_TPU_TORCH_DEVICE`` (default ``cuda``);
    raises with no card unless the variable asks for the CPU."""
    return _engine_new_on(sample_rate, os.environ.get(DEVICE_ENV) or "cuda")


def _engine_new_on(sample_rate: float, device) -> int:
    """:func:`engine_new` on a named ``device`` (the examples name theirs;
    the C API's signature stays the JAX package's)."""
    global _next_handle
    engine = GooeyEngine(sample_rate, device=device)
    h = _next_handle
    _next_handle += 1
    _engines[h] = engine
    return h


def engine_free(handle: int):
    _engines.pop(handle, None)


def _e(handle: int) -> GooeyEngine:
    return _engines[handle]


def engine_render(handle: int, frames: int) -> np.ndarray:
    """Interleaved stereo float32 of length frames*2 (a contiguous numpy
    array, which the shim reads through the buffer protocol)."""
    return _e(handle).render(int(frames))


def engine_last_error(handle: int) -> str:
    return _e(handle).error or ""


def engine_set_bpm(handle: int, bpm: float):
    _e(handle).set_bpm(bpm)


def engine_set_master_gain(handle: int, gain: float):
    _e(handle).set_master_gain(gain)


def engine_trigger_channel_with_velocity(handle: int, channel: int, velocity: float):
    _e(handle).trigger_channel(int(channel), float(velocity))


def engine_set_channel_instrument(handle: int, channel: int, instrument: int) -> int:
    return int(_e(handle).set_channel_instrument(int(channel), int(instrument)))


def engine_get_channel_instrument(handle: int, channel: int) -> int:
    return _e(handle).get_channel_instrument(int(channel))


def _param_name(engine: GooeyEngine, strip: int, param_id: int) -> str:
    kind = engine.channel_kind[strip] if strip < 4 else "bass"
    table = _FAMILY_TABLES[kind]
    return table[int(param_id)]


def engine_set_channel_param(handle: int, channel: int, param_id: int, value: float) -> int:
    e = _e(handle)
    try:
        name = _param_name(e, int(channel), int(param_id))
        if name == "filter_type":  # snare: static u8, not a smoothed param
            kind, slot = e.engine._names[e._strip_name(int(channel))]
            cfgs = e.engine._configs[kind]
            cfgs[slot] = dataclasses.replace(cfgs[slot], filter_type=int(value))
            st = e.engine._state
            if st is not None:
                # a fill on the card, never an element assigned a Python
                # number (a blocking copy); on a copy, as the JAX update is
                ft = st[kind].filter_type.clone()
                ft[slot].fill_(int(value))
                st[kind] = st[kind]._replace(filter_type=ft)
            return 1
        e.set_param(int(channel), name, float(value))
        return 1
    except (KeyError, IndexError):
        return 0


def engine_get_channel_param(handle: int, channel: int, param_id: int) -> float:
    e = _e(handle)
    name = _param_name(e, int(channel), int(param_id))
    if name == "filter_type":
        kind, slot = e.engine._names[e._strip_name(int(channel))]
        return float(e.engine._configs[kind][slot].filter_type)
    return e.get_param(int(channel), name)


def engine_sequencer_set_step(handle: int, channel: int, step: int, enabled: int,
                              velocity: float):
    _e(handle).sequencers[int(channel)].set_step_with_settings(
        int(step), bool(enabled), float(velocity)
    )


def engine_sequencer_set_step_note(handle: int, channel: int, step: int, note: int):
    _e(handle).sequencers[int(channel)].set_step_note(int(step), int(note))


def engine_sequencer_set_swing(handle: int, channel: int, swing: float):
    _e(handle).sequencers[int(channel)].set_swing(float(swing))


def engine_sequencer_start(handle: int, channel: int):
    _e(handle).sequencers[int(channel)].start()


def engine_sequencer_stop(handle: int, channel: int):
    _e(handle).sequencers[int(channel)].stop()


def engine_sequencer_arm_at_samples(handle: int, channel: int, samples: int,
                                    beat: float):
    _e(handle).sequencers[int(channel)].arm_at_samples(int(samples), float(beat))


def engine_set_effect_enabled(handle: int, effect_id: int, enabled: int):
    _e(handle).set_effect_enabled(int(effect_id), bool(enabled))


def engine_set_effect_param(handle: int, effect_id: int, param: int, value: float) -> int:
    return int(_e(handle).set_effect_param(int(effect_id), int(param), float(value)))


def engine_get_effect_param(handle: int, effect_id: int, param: int) -> float:
    return _e(handle).get_effect_param(int(effect_id), int(param))


def engine_granulator_set_param(handle: int, param_id: int, value: float) -> int:
    try:
        _e(handle).granulator_set_param(GRANULATOR_PARAMS[int(param_id)], float(value))
        return 1
    except (KeyError, IndexError):
        return 0


def engine_granulator_trigger(handle: int, velocity: float):
    _e(handle).granulator_trigger(float(velocity))


def engine_granulator_load(handle: int, samples: np.ndarray, sample_rate: float):
    _e(handle).granulator_load(samples, float(sample_rate))


def engine_take_channel_peak(handle: int, channel: int) -> float:
    return _e(handle).take_strip_peak(int(channel))


def engine_transport_beat(handle: int) -> float:
    return _e(handle).transport_beat()


# =====================================================================
# Full FFI surface (ffi.rs's 239 extern "C" functions, grouped by family)
# =====================================================================

# preset-id tables (ffi.rs:1882-1998, 5495-5499)
KICK_PRESETS_BY_ID = ("tight", "punch", "loose", "dirt")
TOM_PRESETS_BY_ID = ("derp", "ring", "brush", "void")
SNARE_PRESETS_BY_ID = ("tight", "loose", "hiss", "smack")
HIHAT_PRESETS_BY_ID = ("short", "loose", "dark", "soft")
BASS_PRESETS_BY_ID = ("acid", "sub", "reese", "stab")
POLY_PRESETS_BY_ID = ("default", "pad", "pluck", "keys", "strings")
_PRESETS_BY_KIND = {
    "kick": KICK_PRESETS_BY_ID, "snare": SNARE_PRESETS_BY_ID,
    "hihat2": HIHAT_PRESETS_BY_ID, "tom2": TOM_PRESETS_BY_ID,
    "bass": BASS_PRESETS_BY_ID,
}

NUM_LFOS, LFO_TIMING_COUNT = 8, len(DIVISION_BEATS)
REORDERABLE_EFFECT_COUNT = 9


# --- global / transport --------------------------------------------------------

def engine_get_bpm(handle):
    return float(_e(handle).bpm)


def engine_get_master_gain(handle):
    return float(_e(handle)._master_target)


def engine_has_error(handle):
    return int(_e(handle).error is not None)


def engine_set_link_enabled(handle, enabled):
    _e(handle).link_enabled = bool(enabled)


def engine_is_link_enabled(handle):
    return int(_e(handle).link_enabled)


def engine_set_render_host_time(handle, seconds):
    _e(handle).render_host_time = float(seconds)


def engine_transport_start(handle):
    _e(handle).transport_start()


def engine_transport_stop(handle):
    _e(handle).transport_stop()


def engine_instrument_count(handle=0):
    return len(INSTRUMENT_KINDS)


def engine_get_channel_peaks(handle):
    """Read-and-reset peaks for all strips → float32 array."""
    e = _e(handle)
    return np.array([e.take_strip_peak(i) for i in range(NUM_KIT_CHANNELS + 1)],
                    np.float32)


def engine_drain_midi_events(handle):
    """→ list of (sample, name, velocity) tuples (capacity 64, ffi.rs:69-71)."""
    return _e(handle).drain_midi_out()


def engine_bounce_to_buffer(handle, frames):
    return _e(handle).bounce_to_buffer(int(frames))


def engine_bounce_to_wav(handle, path, frames, bits=16):
    _e(handle).bounce_to_wav(path, int(frames), int(bits))
    return 1


# --- typed instrument params (legacy set_kick_param-style surface) ---------------

def _typed_param(handle, channel, kind, table, param_id, value=None):
    e = _e(handle)
    ch = int(channel)
    strip_kind = e.channel_kind[ch] if ch < NUM_KIT_CHANNELS else "bass"
    if strip_kind != kind:
        return None
    try:
        name = table[int(param_id)]
    except IndexError:
        return None
    if name == "filter_type":
        if value is None:
            return engine_get_channel_param(handle, ch, int(param_id))
        return engine_set_channel_param(handle, ch, int(param_id), value)
    if value is None:
        return e.get_param(ch, name)
    e.set_param(ch, name, float(value))
    return 1


def engine_set_kick_param(handle, channel, param_id, value):
    return int(_typed_param(handle, channel, "kick", KICK_PARAMS, param_id, value) or 0)


def engine_get_kick_param(handle, channel, param_id):
    return float(_typed_param(handle, channel, "kick", KICK_PARAMS, param_id) or 0.0)


def engine_set_snare_param(handle, channel, param_id, value):
    return int(_typed_param(handle, channel, "snare", SNARE_PARAMS, param_id, value) or 0)


def engine_get_snare_param(handle, channel, param_id):
    return float(_typed_param(handle, channel, "snare", SNARE_PARAMS, param_id) or 0.0)


def engine_set_hihat_param(handle, channel, param_id, value):
    return int(_typed_param(handle, channel, "hihat2", HIHAT_PARAMS, param_id, value) or 0)


def engine_get_hihat_param(handle, channel, param_id):
    return float(_typed_param(handle, channel, "hihat2", HIHAT_PARAMS, param_id) or 0.0)


def engine_set_tom_param(handle, channel, param_id, value):
    return int(_typed_param(handle, channel, "tom2", TOM_PARAMS, param_id, value) or 0)


def engine_get_tom_param(handle, channel, param_id):
    return float(_typed_param(handle, channel, "tom2", TOM_PARAMS, param_id) or 0.0)


def engine_set_bass_param(handle, param_id, value):
    return int(_typed_param(handle, NUM_KIT_CHANNELS, "bass", BASS_PARAMS, param_id, value) or 0)


def engine_get_bass_param(handle, param_id):
    return float(_typed_param(handle, NUM_KIT_CHANNELS, "bass", BASS_PARAMS, param_id) or 0.0)


def engine_kick_param_count(handle=0):
    return len(KICK_PARAMS)


def engine_snare_param_count(handle=0):
    return len(SNARE_PARAMS)


def engine_hihat_param_count(handle=0):
    return len(HIHAT_PARAMS)


def engine_tom_param_count(handle=0):
    return len(TOM_PARAMS)


def engine_load_bass_preset(handle, preset_id):
    e = _e(handle)
    try:
        name = BASS_PRESETS_BY_ID[int(preset_id)]
    except IndexError:
        return 0
    e.engine.set_config("bass", _bass.PRESETS[name]())
    return 1


def engine_set_channel_tuning(handle, channel, value):
    try:
        _e(handle).set_param(int(channel), "tuning", float(value))
        return 1
    except KeyError:
        return 0


def engine_get_channel_tuning(handle, channel):
    return _e(handle).get_param(int(channel), "tuning")


# --- per-strip mixer controls (instrument gain/pan/mute/solo) --------------------

def _strip_ok(e, strip):
    return 0 <= int(strip) <= NUM_KIT_CHANNELS


def engine_set_instrument_gain(handle, strip, gain):
    e = _e(handle)
    if not _strip_ok(e, strip):
        return 0
    e.strip_gain[int(strip)] = float(gain)
    return 1


def engine_get_instrument_gain(handle, strip):
    return float(_e(handle).strip_gain[int(strip)])


def engine_set_instrument_pan(handle, strip, pan):
    e = _e(handle)
    if not _strip_ok(e, strip):
        return 0
    e.strip_pan[int(strip)] = float(np.clip(pan, 0.0, 1.0))
    return 1


def engine_get_instrument_pan(handle, strip):
    return float(_e(handle).strip_pan[int(strip)])


def engine_set_instrument_mute(handle, strip, muted):
    e = _e(handle)
    if not _strip_ok(e, strip):
        return 0
    e.strip_mute[int(strip)] = bool(muted)
    return 1


def engine_get_instrument_mute(handle, strip):
    return int(_e(handle).strip_mute[int(strip)])


def engine_set_instrument_solo(handle, strip, soloed):
    e = _e(handle)
    if not _strip_ok(e, strip):
        return 0
    e.strip_solo[int(strip)] = bool(soloed)
    return 1


def engine_get_instrument_solo(handle, strip):
    return int(_e(handle).strip_solo[int(strip)])


def engine_trigger_instrument_with_velocity(handle, strip, velocity):
    _e(handle).trigger_channel(int(strip), float(velocity))


def engine_trigger_instrument(handle, strip):
    engine_trigger_instrument_with_velocity(handle, strip, 0.5)


def engine_trigger_kick(handle, velocity=1.0):
    """Legacy: trigger the first kick-assigned channel (channel 0 default)."""
    e = _e(handle)
    for ch in range(NUM_KIT_CHANNELS):
        if e.channel_kind[ch] == "kick":
            e.trigger_channel(ch, float(velocity))
            return 1
    return 0


# --- sequencer (per-strip, ffi.rs sequencer_* family) -----------------------------

def _seq(handle, channel):
    return _e(handle).sequencers[int(channel)]


def engine_sequencer_reset(handle, channel):
    _seq(handle, channel).reset()


def engine_sequencer_step_count(handle, channel):
    return len(_seq(handle, channel).pattern)


def engine_sequencer_get_current_step(handle, channel):
    return int(_seq(handle, channel).playhead_step)


def engine_sequencer_get_step_with_lookahead(handle, channel, lookahead):
    return int(_seq(handle, channel).step_at_lookahead(int(lookahead)))


def engine_sequencer_get_beat_position(handle, channel):
    return float(_seq(handle, channel).beat_position())


def engine_sequencer_set_beat_position(handle, channel, beat):
    _seq(handle, channel).set_beat_position(float(beat))


def engine_sequencer_start_at_host_time(handle, channel, host_time, beat=0.0):
    """Armed start anchored to the host clock (ffi.rs set_render_host_time +
    sequencer_start_at_host_time): countdown = (host_time - anchor) * sr."""
    e = _e(handle)
    samples = max(0, int(round((float(host_time) - e.render_host_time) * e.sr)))
    e.sequencers[int(channel)].arm_at_samples(samples, float(beat))


def engine_get_swing(handle, channel):
    return float(_seq(handle, channel).swing.target)


def engine_set_sequencer_triggers_enabled(handle, channel, enabled):
    _seq(handle, channel).triggers_enabled = bool(enabled)


def engine_get_sequencer_triggers_enabled(handle, channel):
    return int(_seq(handle, channel).triggers_enabled)


def engine_sequencer_set_instrument_step_with_settings(handle, channel, step,
                                                       enabled, velocity):
    _seq(handle, channel).set_step_with_settings(int(step), bool(enabled),
                                                 float(velocity))


def engine_sequencer_set_instrument_step_velocity(handle, channel, step, velocity):
    _seq(handle, channel).set_step_velocity(int(step), float(velocity))


def engine_sequencer_set_instrument_step_note(handle, channel, step, note):
    _seq(handle, channel).set_step_note(int(step), int(note))


def engine_sequencer_clear_instrument_step_note(handle, channel, step):
    _seq(handle, channel).set_step_note(int(step), None)


def engine_sequencer_set_instrument_step_blend(handle, channel, step, x, y):
    _seq(handle, channel).set_step_blend(int(step), float(x), float(y))


def engine_sequencer_clear_instrument_step_blend(handle, channel, step):
    _seq(handle, channel).clear_step_blend(int(step))


def engine_sequencer_set_instrument_pattern(handle, channel, bits):
    """16-step pattern as a bitmask (bit i = step i enabled)."""
    seq = _seq(handle, channel)
    seq.set_pattern([bool((int(bits) >> i) & 1) for i in range(len(seq.pattern))])


def engine_sequencer_get_instrument_step_enabled(handle, channel, step):
    return int(_seq(handle, channel).pattern[int(step)].enabled)


def engine_sequencer_get_instrument_step_velocity(handle, channel, step):
    return float(_seq(handle, channel).pattern[int(step)].velocity)


def engine_sequencer_get_instrument_step_note(handle, channel, step):
    note = _seq(handle, channel).pattern[int(step)].note
    return int(note) if note is not None else 255  # 255 = no note (ffi.rs)


def engine_sequencer_get_instrument_step_blend_x(handle, channel, step):
    b = _seq(handle, channel).pattern[int(step)].blend
    return float(b[0]) if b else -1.0


def engine_sequencer_get_instrument_step_blend_y(handle, channel, step):
    b = _seq(handle, channel).pattern[int(step)].blend
    return float(b[1]) if b else -1.0


def engine_sequencer_get_instrument_step_blend_enabled(handle, channel, step):
    return int(_seq(handle, channel).pattern[int(step)].blend is not None)


# --- LFO pool (8 LFOs x 16 routes, ffi.rs:33-67) -----------------------------------

def engine_lfo_count(handle=0):
    return NUM_LFOS


def engine_lfo_timing_count(handle=0):
    return LFO_TIMING_COUNT


def engine_set_lfo_timing(handle, lfo, timing):
    e = _e(handle)
    if not (0 <= int(lfo) < NUM_LFOS and 0 <= int(timing) < LFO_TIMING_COUNT):
        return 0
    e.engine.set_lfo(int(lfo), division=int(timing), bpm=e.bpm)
    return 1


def engine_get_lfo_timing(handle, lfo):
    return int(_e(handle).engine.lfos[int(lfo)].division)


def engine_set_lfo_amount(handle, lfo, amount):
    _e(handle).engine.lfos[int(lfo)].amount = float(amount)


def engine_get_lfo_amount(handle, lfo):
    return float(_e(handle).engine.lfos[int(lfo)].amount)


def engine_set_lfo_offset(handle, lfo, offset):
    _e(handle).engine.lfos[int(lfo)].offset = float(offset)


def engine_get_lfo_offset(handle, lfo):
    return float(_e(handle).engine.lfos[int(lfo)].offset)


def engine_set_lfo_enabled(handle, lfo, enabled):
    _e(handle).engine.lfos[int(lfo)].enabled = bool(enabled)


def engine_get_lfo_enabled(handle, lfo):
    return int(_e(handle).engine.lfos[int(lfo)].enabled)


def engine_get_lfo_phase(handle, lfo):
    return float(_e(handle).engine.lfos[int(lfo)].phase)


def engine_reset_lfo_phase(handle, lfo):
    _e(handle).engine.lfos[int(lfo)].phase = 0.0


def engine_add_lfo_route(handle, lfo, channel, param_id, depth=1.0):
    e = _e(handle)
    try:
        name = _param_name(e, int(channel), int(param_id))
    except (KeyError, IndexError):
        return 0
    if name == "filter_type":
        return 0
    try:
        e.engine.add_lfo_route(int(lfo), e._strip_name(int(channel)), name,
                               float(depth))
    except ValueError:
        return 0  # non-modulatable family (tom2) or route table full
    return 1


def engine_remove_lfo_route(handle, lfo, channel, param_id):
    e = _e(handle)
    try:
        name = _param_name(e, int(channel), int(param_id))
    except (KeyError, IndexError):
        return 0
    target = (int(lfo), e._strip_name(int(channel)), name)
    before = len(e.engine.lfo_routes)
    e.engine.lfo_routes = [
        r for r in e.engine.lfo_routes
        if (r.lfo, r.instrument, r.parameter) != target
    ]
    return int(len(e.engine.lfo_routes) != before)


def engine_clear_lfo_routes(handle, lfo=-1):
    e = _e(handle)
    e.engine.clear_lfo_routes(None if int(lfo) < 0 else int(lfo))


def engine_get_lfo_route_count(handle, lfo=-1):
    routes = _e(handle).engine.lfo_routes
    if int(lfo) < 0:
        return len(routes)
    return sum(1 for r in routes if r.lfo == int(lfo))


# --- global FX extras --------------------------------------------------------------

def engine_global_effect_count(handle):
    return len(_e(handle).fx.entries) + 1  # + pinned limiter


def engine_reorderable_effect_count(handle=0):
    return REORDERABLE_EFFECT_COUNT


def engine_get_global_effect_enabled(handle, effect_id):
    e = _e(handle)
    if int(effect_id) == _chain.EFFECT_LIMITER:
        return int(e.limiter_enabled)
    return int(e.fx_enabled.get(int(effect_id), False))


def engine_get_effect_order(handle):
    return [int(x) for x in _e(handle).fx.order()]


def engine_set_compressor_sidechain(handle, strip):
    e = _e(handle)
    e.sidechain_strip = None if int(strip) < 0 else int(strip)
    return 1


def engine_get_compressor_sidechain(handle):
    s = _e(handle).sidechain_strip
    return -1 if s is None else int(s)


# --- poly synth ----------------------------------------------------------------------

def engine_poly_set_param(handle, param_id, value):
    try:
        name = _poly.PARAM_NAMES[int(param_id)]
    except IndexError:
        return 0
    _e(handle).engine.set_param("poly", name, float(value))
    return 1


def engine_poly_get_param(handle, param_id):
    return float(_e(handle).engine.get_param("poly", _poly.PARAM_NAMES[int(param_id)]))


def engine_poly_set_preset(handle, preset_id):
    try:
        cfg = _poly.PRESETS[POLY_PRESETS_BY_ID[int(preset_id)]]()
    except IndexError:
        return 0
    _e(handle).engine.set_config("poly", cfg)
    return 1


def engine_poly_trigger_chord(handle, root, scale_type, degree, voicing, preset,
                              octave, velocity):
    """Trigger + stamp into the performance clip when recording
    (ffi.rs:5571-5621; the recorder ignores playback-driven calls)."""
    e = _e(handle)
    e._apply_chord(int(root), int(scale_type), int(degree), int(voicing),
                   int(preset), int(octave), float(velocity))
    e.performance.record_chord_on(int(root), int(scale_type), int(degree),
                                  int(voicing), int(preset), int(octave),
                                  float(velocity))
    return 1


def engine_poly_release(handle):
    e = _e(handle)
    e._release_chord()
    e.engine.poly_release_all("poly")
    e.performance.record_chord_off()


def engine_poly_available_voicing_count(handle=0):
    return len(_music.VOICINGS)


# --- blend pads (ffi.rs ChannelBlender, :409-440, 2001-2007) -------------------------

def _default_blender_for(e, strip):
    kind = e.channel_kind[strip] if strip < NUM_KIT_CHANNELS else "bass"
    mod = FAMILIES[kind]
    names = _PRESETS_BY_KIND[kind]
    return PresetBlender(*[mod.PRESETS[n]() for n in names])


def engine_blend_enable(handle, strip):
    e = _e(handle)
    if not _strip_ok(e, strip):
        return 0
    strip = int(strip)
    if e.blenders[strip] is None:
        e.blenders[strip] = _default_blender_for(e, strip)
        e.blend_corner_ids[strip] = [0, 1, 2, 3]
    e.blend_enabled[strip] = True
    return 1


def engine_blend_disable(handle, strip):
    _e(handle).blend_enabled[int(strip)] = False
    return 1


def engine_blend_is_enabled(handle, strip):
    return int(_e(handle).blend_enabled[int(strip)])


def engine_blend_set_position(handle, strip, x, y):
    e = _e(handle)
    if not e.blend_enabled[int(strip)]:
        return 0
    return int(e.blend_to(int(strip), float(x), float(y)))


def engine_blend_get_position_x(handle, strip):
    return float(_e(handle).blend_pos[int(strip)][0])


def engine_blend_get_position_y(handle, strip):
    return float(_e(handle).blend_pos[int(strip)][1])


def engine_blend_set_corner_preset(handle, strip, corner, preset_id):
    e = _e(handle)
    strip, corner = int(strip), int(corner)
    if not (_strip_ok(e, strip) and 0 <= corner < 4):
        return 0
    kind = e.channel_kind[strip] if strip < NUM_KIT_CHANNELS else "bass"
    names = _PRESETS_BY_KIND[kind]
    if not (0 <= int(preset_id) < len(names)):
        return 0
    if e.blenders[strip] is None:
        e.blenders[strip] = _default_blender_for(e, strip)
        e.blend_corner_ids[strip] = [0, 1, 2, 3]
    e.blenders[strip].set_corner(corner, FAMILIES[kind].PRESETS[names[int(preset_id)]]())
    e.blend_corner_ids[strip][corner] = int(preset_id)
    return 1


def engine_blend_get_corner_preset(handle, strip, corner):
    return int(_e(handle).blend_corner_ids[int(strip)][int(corner)])


def engine_blend_reset_corners(handle, strip):
    e = _e(handle)
    strip = int(strip)
    e.blenders[strip] = _default_blender_for(e, strip)
    e.blend_corner_ids[strip] = [0, 1, 2, 3]
    return 1


# --- granulator extras --------------------------------------------------------------

def engine_granulator_get_param(handle, param_id):
    e = _e(handle)
    return float(e.gran_host.cfg[GRANULATOR_PARAMS[int(param_id)]])


def engine_granulator_set_seed(handle, seed):
    _e(handle).gran_host.rng.state = int(seed) & 0xFFFFFFFF or 1


def engine_granulator_snap_params(handle):
    """Current to target on the card; the targets, and so the host mirror
    ``_gran_targets``, are unchanged."""
    e = _e(handle)
    p = e.gran_state.params
    e.gran_state = e.gran_state._replace(params=p._replace(current=p.target))


def engine_granulator_active_grain_count(handle):
    e = _e(handle)
    return int(e.gran_host.active_grain_count(e.sample_count))


def engine_granulator_buffer_len(handle):
    # 1 == "no host buffer loaded yet" (tests/ffi_granulator.rs:26-37); the
    # device-side placeholder table is an implementation detail.
    return int(_e(handle).gran_buffer_len)


def engine_granulator_buffer_sample_rate(handle):
    return float(_e(handle).gran_buffer_sr)


def engine_granulator_set_buffer(handle, samples, sample_rate):
    """Returns 1 on success, 0 on rejected input — a null/empty buffer, a
    non-positive/non-finite sample rate, or non-finite sample values leave
    the placeholder untouched (tests/ffi_granulator.rs:60-88;
    SampleBuffer::from_mono validation)."""
    if samples is None:
        return 0
    sr = float(sample_rate)
    if not math.isfinite(sr) or sr <= 0.0:
        return 0
    buf = np.asarray(samples, np.float32)
    if buf.size == 0 or not np.all(np.isfinite(buf)):
        return 0
    engine_granulator_load(handle, buf, sample_rate)
    return 1


# --- mixer graph (graph.rs / mixer_* + track_effect_*) ---------------------------------

def engine_mixer_add_track(handle, name):
    return int(_e(handle).graph.add_track(str(name)))


def engine_mixer_get_track_count(handle):
    return len(_e(handle).graph.tracks)


def engine_mixer_find_track(handle, name):
    for i, t in enumerate(_e(handle).graph.tracks):
        if t.name == str(name):
            return i
    return -1


def engine_mixer_get_track_name(handle, track):
    return _e(handle).graph.tracks[int(track)].name


def engine_mixer_set_track_name(handle, track, name):
    _e(handle).graph.tracks[int(track)].name = str(name)
    return 1


def engine_mixer_set_track_gain(handle, track, gain):
    _e(handle).graph.set_track_gain(int(track), float(gain))
    return 1


def engine_mixer_get_track_gain(handle, track):
    return float(_e(handle).graph.tracks[int(track)].gain)


def engine_mixer_set_track_pan(handle, track, pan):
    _e(handle).graph.set_track_pan(int(track), float(pan))
    return 1


def engine_mixer_get_track_pan(handle, track):
    return float(_e(handle).graph.tracks[int(track)].pan)


def engine_mixer_set_track_mute(handle, track, muted):
    _e(handle).graph.set_track_mute(int(track), bool(muted))
    return 1


def engine_mixer_get_track_mute(handle, track):
    return int(_e(handle).graph.tracks[int(track)].muted)


def engine_mixer_set_track_solo(handle, track, soloed):
    _e(handle).graph.set_track_solo(int(track), bool(soloed))
    return 1


def engine_mixer_get_track_solo(handle, track):
    return int(_e(handle).graph.tracks[int(track)].soloed)


def engine_mixer_get_track_peak(handle, track):
    return float(_e(handle).graph.take_peak(int(track)))


def engine_mixer_route_source(handle, source, track):
    return int(_e(handle).graph.route(int(source), int(track)))


def engine_mixer_unroute_source(handle, source):
    return int(_e(handle).graph.route(int(source), None))


def engine_mixer_get_source_route(handle, source):
    r = _e(handle).graph.routes[int(source)]
    return -1 if r is None else int(r)


def engine_mixer_clear_layout(handle):
    e = _e(handle)
    e.graph = _graph.MixerGraph(e.sr, e.bpm, device=e.device)
    return 1


def engine_mixer_reset_default_layout(handle):
    e = _e(handle)
    e.graph = _graph.MixerGraph.with_default_layout(e.sr, e.bpm, device=e.device)
    return 1


def _track_rack(handle, track):
    return _e(handle).graph.tracks[int(track)].rack


def engine_track_effect_add(handle, track, effect_id):
    return int(_track_rack(handle, track).add(int(effect_id)))


def engine_track_effect_remove(handle, track, index):
    return int(_track_rack(handle, track).remove(int(index)))


def engine_track_effect_move(handle, track, src, dst):
    return int(_track_rack(handle, track).move(int(src), int(dst)))


def engine_track_effect_clear(handle, track):
    _track_rack(handle, track).clear()
    return 1


def engine_track_effect_count(handle, track):
    return len(_track_rack(handle, track).entries)


def engine_track_effect_type_at(handle, track, index):
    return int(_track_rack(handle, track).entries[int(index)].effect_id)


def engine_track_effect_set_param(handle, track, index, param, value):
    return int(_track_rack(handle, track).set_param(int(index), int(param),
                                                    float(value)))


# --- loop channels (loop_channel.rs / loop_* family) -----------------------------------

def _loop(handle, channel):
    return _e(handle).mixer.channels[int(channel)]


def engine_loop_load(handle, channel, samples, num_channels, sample_rate,
                     source_bpm=0.0):
    """samples: interleaved float32 (frames * num_channels)."""
    pcm = np.asarray(samples, np.float32).reshape(-1, max(int(num_channels), 1))
    buf = StereoSampleBuffer.from_interleaved(
        pcm.reshape(-1), int(num_channels), float(sample_rate),
        float(source_bpm) if source_bpm and source_bpm > 0 else None,
    )
    _loop(handle, channel).set_buffer(buf)
    return 1


def engine_loop_set_playing(handle, channel, playing):
    _loop(handle, channel).set_playing(bool(playing))


def engine_loop_set_gain(handle, channel, gain):
    # loop_channel.rs:407-409 clamps to [0, MAX_GAIN=2.0]
    _loop(handle, channel).gain_target = min(max(float(gain), 0.0), 2.0)


def engine_loop_set_mute(handle, channel, muted):
    _loop(handle, channel).muted = bool(muted)


def engine_loop_set_solo(handle, channel, soloed):
    _loop(handle, channel).soloed = bool(soloed)


def engine_loop_set_speed(handle, channel, speed):
    # loop_channel.rs:419-421 clamps to [-MAX_SPEED, MAX_SPEED] = +/-4.0
    _loop(handle, channel).speed = min(max(float(speed), -4.0), 4.0)


def engine_loop_set_start(handle, channel, start):
    ch = _loop(handle, channel)
    ch.set_loop_window(float(start), ch.loop_end)


def engine_loop_set_end(handle, channel, end):
    ch = _loop(handle, channel)
    ch.set_loop_window(ch.loop_start, float(end))


def engine_loop_set_position(handle, channel, normalized):
    _loop(handle, channel).set_position(float(normalized))


def engine_loop_get_position(handle, channel):
    ch = _loop(handle, channel)
    if ch.buffer is None or len(ch.buffer) < 2:
        return 0.0
    return float(ch.cursor / (len(ch.buffer) - 1))


def engine_loop_set_pitch_mode(handle, channel, mode):
    if int(mode) not in (0, 1, 2):
        return 0
    _loop(handle, channel).pitch_mode = int(mode)
    return 1


def engine_loop_get_pitch_mode(handle, channel):
    return int(_loop(handle, channel).pitch_mode)


def engine_loop_set_source_bpm(handle, channel, bpm):
    ch = _loop(handle, channel)
    if ch.buffer is None:
        return 0
    ch.buffer = StereoSampleBuffer(ch.buffer.left, ch.buffer.right,
                                   ch.buffer.sample_rate, float(bpm))
    return 1


def engine_loop_get_source_bpm(handle, channel):
    ch = _loop(handle, channel)
    bpm = ch.buffer.source_bpm if ch.buffer is not None else None
    return float(bpm) if bpm else 0.0


def engine_loop_restart(handle, channel):
    _loop(handle, channel).restart()


def engine_loop_queue_swap(handle, channel, samples, num_channels, sample_rate,
                           divisions=1, source_bpm=0.0):
    pcm = np.asarray(samples, np.float32)
    buf = StereoSampleBuffer.from_interleaved(
        pcm, int(num_channels), float(sample_rate),
        float(source_bpm) if source_bpm and source_bpm > 0 else None,
    )
    _loop(handle, channel).queue_swap(buf, int(divisions))
    return 1


def engine_loop_cancel_queued_swap(handle, channel):
    _loop(handle, channel).cancel_queued_swap()


def engine_loop_swaps_completed(handle, channel):
    return int(_loop(handle, channel).swaps_completed)


def engine_loop_effect_add(handle, channel, effect_id):
    return int(_loop(handle, channel).chain.add(int(effect_id)))


def engine_loop_effect_remove(handle, channel, index):
    return int(_loop(handle, channel).chain.remove(int(index)))


def engine_loop_effect_move(handle, channel, src, dst):
    return int(_loop(handle, channel).chain.move(int(src), int(dst)))


def engine_loop_effect_clear(handle, channel):
    _loop(handle, channel).chain.clear()


def engine_loop_effect_count(handle, channel):
    return len(_loop(handle, channel).chain.entries)


def engine_loop_effect_type_at(handle, channel, index):
    return int(_loop(handle, channel).chain.entries[int(index)].effect_id)


def engine_loop_effect_set_param(handle, channel, index, param, value):
    return int(_loop(handle, channel).chain.set_param(int(index), int(param),
                                                      float(value)))


def engine_loop_render_to_wav(handle, channel, frames, path, bits=32):
    _e(handle).mixer.render_channel_to_wav(int(channel), int(frames), path,
                                           int(bits))
    return 1


# --- clip grid (clip_grid.rs / clip_* family) --------------------------------------------

def _grid(handle):
    return _e(handle).mixer.clip_grid


def engine_clip_load(handle, column, row, samples, num_channels, sample_rate,
                     source_bpm):
    pcm = np.asarray(samples, np.float32)
    buf = StereoSampleBuffer.from_interleaved(
        pcm, int(num_channels), float(sample_rate), float(source_bpm)
    )
    return int(_grid(handle).load(int(column), int(row), buf, float(source_bpm)))


def engine_clip_unload(handle, column, row):
    return int(_grid(handle).unload(int(column), int(row)))


def engine_clip_clear(handle):
    g = _grid(handle)
    for col in range(CLIP_COLUMNS):
        for row in range(CLIP_ROWS):
            g.slots[col][row] = None
    g.cancel_all()
    return 1


def engine_clip_launch(handle, column, row, quantization=-1):
    q = None if int(quantization) < 0 else int(quantization)
    return int(_grid(handle).launch_quantized(int(column), int(row), q))


def engine_clip_launch_at_beat(handle, column, row, beat):
    return int(_grid(handle).launch_at(int(column), int(row), float(beat)))


def engine_clip_launch_scene(handle, row, quantization=-1):
    q = None if int(quantization) < 0 else int(quantization)
    return int(_grid(handle).launch_scene_quantized(int(row), q))


def engine_clip_launch_scene_at_beat(handle, row, beat):
    g = _grid(handle)
    ok = False
    for col in range(CLIP_COLUMNS):
        if g.slots[col][int(row)] is not None:
            ok |= g.launch_at(col, int(row), float(beat))
    return int(ok)


def engine_clip_stop(handle, column, quantization=-1):
    q = None if int(quantization) < 0 else int(quantization)
    return int(_grid(handle).stop_quantized(int(column), q))


def engine_clip_stop_at_beat(handle, column, beat):
    return int(_grid(handle).stop_at(int(column), float(beat)))


def engine_clip_cancel(handle, column):
    _grid(handle).cancel(int(column))


def engine_clip_cancel_all(handle):
    _grid(handle).cancel_all()


def engine_clip_get_state(handle, column, row):
    return int(_grid(handle).slot_state(int(column), int(row)))


def engine_clip_get_active_row(handle, column):
    r = _grid(handle).active_row[int(column)]
    return -1 if r is None else int(r)


def engine_clip_get_queued_row(handle, column):
    r = _grid(handle).queued_row(int(column))
    return -1 if r is None else int(r)


def engine_clip_is_stop_queued(handle, column):
    p = _grid(handle).pending[int(column)]
    return int(p is not None and p.kind in ("stop", "stop_unload"))


def engine_clip_get_scheduled_beat(handle, column):
    b = _grid(handle).scheduled_beat(int(column))
    return -1.0 if b is None else float(b)


def engine_clip_get_active_playhead(handle, column):
    p = _grid(handle).active_playhead(int(column))
    return -1.0 if p is None else float(p)


def engine_clip_set_trim(handle, column, row, start, end, timing=0):
    e = _e(handle)
    return int(_grid(handle).set_trim(int(column), int(row), float(start),
                                      float(end), int(timing),
                                      e.mixer.channels))


def engine_clip_get_trim_start(handle, column, row):
    c = _grid(handle).slots[int(column)][int(row)]
    return float(c.trim_start) if c else 0.0


def engine_clip_get_trim_end(handle, column, row):
    c = _grid(handle).slots[int(column)][int(row)]
    return float(c.trim_end) if c else 1.0


def engine_clip_set_default_quantization(handle, quantization):
    if int(quantization) not in (0, 1, 2, 3):
        return 0
    _grid(handle).default_quantization = int(quantization)
    return 1


def engine_clip_get_default_quantization(handle):
    return int(_grid(handle).default_quantization)


def engine_transport_get_beat_position(handle):
    return float(_grid(handle).transport_beat)


# --- sampler racks (sampler.rs / sampler_* family) -----------------------------------------

def _rack(handle, rack):
    r = _e(handle).racks[int(rack)]
    if r is None:
        raise KeyError(f"sampler rack {rack} not registered")
    return r


def engine_sampler_register(handle):
    """Allocate the first free rack; returns its index or -1 (ffi.rs:6007).
    The host must route SOURCE_SAMPLER_BASE+index to a track to hear it."""
    e = _e(handle)
    for i in range(SAMPLER_RACK_MAX):
        if e.racks[i] is None:
            return i if e.register_sampler_rack(i) else -1
    return -1


def engine_sampler_set_slot_buffer(handle, rack, slot, samples, num_channels,
                                   sample_rate):
    pcm = np.asarray(samples, np.float32)
    if int(num_channels) == 2:
        pcm = pcm.reshape(-1, 2)
    try:
        return int(_rack(handle, rack).set_buffer(int(slot), pcm, float(sample_rate)))
    except (KeyError, RuntimeError):
        return 0


def engine_sampler_clear_slot(handle, rack, slot):
    return int(_rack(handle, rack).clear_slot(int(slot)))


def engine_sampler_trigger(handle, rack, slot, velocity):
    return int(_e(handle).sampler_trigger(int(rack), int(slot), float(velocity)))


def engine_sampler_set_step(handle, rack, step, enabled, slot, velocity):
    return int(_rack(handle, rack).set_step(int(step), bool(enabled), int(slot),
                                            float(velocity)))


def engine_sampler_get_step(handle, rack, step):
    """→ (enabled, slot, velocity)."""
    s = _rack(handle, rack).sequencer.pattern[int(step)]
    return (int(s.enabled), int(s.note if s.note is not None else 0),
            float(s.velocity))


def engine_sampler_start_pattern(handle, rack, beat):
    return int(_rack(handle, rack).schedule_start(float(beat)))


def engine_sampler_stop_pattern(handle, rack):
    _rack(handle, rack).stop_pattern()


def engine_sampler_is_pattern_running(handle, rack):
    return int(_rack(handle, rack).pattern_running)


def engine_sampler_cancel_pattern_start(handle, rack):
    _rack(handle, rack).pending_start_beat = None


def engine_sampler_get_pending_start_beat(handle, rack):
    b = _rack(handle, rack).pending_start_beat
    return -1.0 if b is None else float(b)


def engine_sampler_slot_is_loaded(handle, rack, slot):
    return int(_rack(handle, rack).slot_meta[int(slot)] is not None)


def engine_sampler_slot_frames(handle, rack, slot):
    m = _rack(handle, rack).slot_meta[int(slot)]
    return int(m[1]) if m else 0


def engine_sampler_slot_channels(handle, rack, slot):
    return 2 if _rack(handle, rack).slot_meta[int(slot)] else 0


def engine_sampler_slot_sample_rate(handle, rack, slot):
    m = _rack(handle, rack).slot_meta[int(slot)]
    return float(m[2]) if m else 0.0


def engine_sampler_get_source_id(handle, rack):
    return int(_graph.SOURCE_SAMPLER_BASE + int(rack))


# --- performance recorder (performance/mod.rs / perf_* family) -----------------------------

def _perf(handle):
    return _e(handle).performance


def engine_perf_set_record_armed(handle, armed):
    _perf(handle).set_armed(bool(armed))


def engine_perf_is_record_armed(handle):
    return int(_perf(handle).armed)


def engine_perf_is_recording(handle):
    return int(_perf(handle).is_recording())


def engine_perf_set_record_mode(handle, mode):
    if int(mode) not in (0, 1):
        return 0
    _perf(handle).mode = int(mode)
    return 1


def engine_perf_get_record_mode(handle):
    return int(_perf(handle).mode)


def engine_perf_clear_clip(handle):
    _perf(handle).clear_clip()


def engine_perf_get_event_count(handle):
    return len(_perf(handle).events)


def engine_perf_get_event(handle, index):
    """→ (start_tick, duration_ticks, root, scale, degree, voicing, preset,
    octave, velocity)."""
    ev = _perf(handle).events[int(index)]
    return (int(ev.start_tick), int(ev.duration_ticks), int(ev.root),
            int(ev.scale_type), int(ev.degree), int(ev.voicing), int(ev.preset),
            int(ev.octave), float(ev.velocity))


def engine_perf_get_sampler_event_count(handle):
    return len(_perf(handle).sampler_events)


def engine_perf_get_sampler_event(handle, index):
    ev = _perf(handle).sampler_events[int(index)]
    return (int(ev.start_tick), int(ev.rack), int(ev.slot), float(ev.velocity))


def engine_perf_get_length_ticks(handle):
    return int(_perf(handle).length_ticks)


def engine_perf_get_length_steps(handle):
    return int(_perf(handle).length_ticks // TICKS_PER_STEP)


# --- reference-ABI aliases + remaining surface (name parity with ffi.rs) ------

def engine_trigger_channel(handle, channel):
    _e(handle).trigger_channel(int(channel), 0.5)


def engine_set_channel_instrument_type(handle, channel, instrument):
    return engine_set_channel_instrument(handle, channel, instrument)


def engine_get_channel_instrument_type(handle, channel):
    return engine_get_channel_instrument(handle, channel)


def engine_set_global_effect_enabled(handle, effect_id, enabled):
    engine_set_effect_enabled(handle, effect_id, enabled)


def engine_set_global_effect_param(handle, effect_id, param, value):
    return engine_set_effect_param(handle, effect_id, param, value)


def engine_get_global_effect_param(handle, effect_id, param):
    return engine_get_effect_param(handle, effect_id, param)


def engine_set_swing(handle, channel, swing):
    engine_sequencer_set_swing(handle, channel, swing)


def engine_get_error_message(handle):
    return engine_last_error(handle)


def engine_move_effect(handle, src, dst):
    """Reorder the global chain by entry position (effect_chain.rs move)."""
    return int(_e(handle).fx.move(int(src), int(dst)))


def engine_set_effect_order_list(handle, order):
    return int(_e(handle).set_effect_order([int(x) for x in order]))


def engine_sequencer_set_instrument_step(handle, channel, step, enabled):
    seq = _seq(handle, channel)
    seq.set_step(int(step), bool(enabled))


def engine_sequencer_set_instrument_step_with_velocity(handle, channel, step,
                                                       enabled, velocity):
    _seq(handle, channel).set_step_with_settings(int(step), bool(enabled),
                                                 float(velocity))


def engine_sequencer_set_instrument_step_settings(handle, channel, step,
                                                  enabled, velocity):
    _seq(handle, channel).set_step_with_settings(int(step), bool(enabled),
                                                 float(velocity))


def engine_sequencer_get_instrument_step(handle, channel, step):
    return engine_sequencer_get_instrument_step_enabled(handle, channel, step)


def engine_sequencer_get_instrument_step_with_lookahead(handle, channel,
                                                        lookahead):
    return engine_sequencer_get_step_with_lookahead(handle, channel, lookahead)


def engine_sequencer_set_instrument_step_blend_override(handle, channel, step,
                                                        x, y):
    engine_sequencer_set_instrument_step_blend(handle, channel, step, x, y)


def engine_sequencer_clear_instrument_step_blend_override(handle, channel, step):
    engine_sequencer_clear_instrument_step_blend(handle, channel, step)


def engine_sequencer_get_instrument_step_blend_override_x(handle, channel, step):
    return engine_sequencer_get_instrument_step_blend_x(handle, channel, step)


def engine_sequencer_get_instrument_step_blend_override_y(handle, channel, step):
    return engine_sequencer_get_instrument_step_blend_y(handle, channel, step)


def engine_sequencer_set_instrument_note_pattern(handle, channel, notes):
    """Set all step notes at once; 255 clears a step's note (ffi.rs)."""
    seq = _seq(handle, channel)
    for i, note in enumerate(notes[: len(seq.pattern)]):
        seq.set_step_note(i, None if int(note) == 255 else int(note))


def engine_drain_midi_events_flat(handle):
    """→ list of (sample, strip_index, velocity); strip parsed from the
    engine voice name (ch<N>_* / bass / everything else = -1)."""
    out = []
    for sample, name, velocity in _e(handle).drain_midi_out():
        if name.startswith("ch") and "_" in name:
            strip = int(name[2:name.index("_")])
        elif name == "bass":
            strip = NUM_KIT_CHANNELS
        else:
            strip = -1
        out.append((int(sample), strip, float(velocity)))
    return out
