"""The port's C-API surface on the CPU, part 2: the mixer graph, loop, clip,
sampler and bounce/MIDI families of ``tests/test_capi_full.py`` (ffi.rs parity), each
assertion as the JAX test makes it, on ``libgooey_tpu_torch.capi`` with
``LIBGOOEY_TPU_TORCH_DEVICE=cpu``.  The port's CPU engine renders a
512-sample block in ~2 s, so the loop family's first render is 1,024 frames
(JAX: 4,096) and its swap loop stops once the swap lands (at most 8 renders,
as in JAX), and the clip family runs its transport at 480 BPM (JAX: the
default 120), so the quarter-note launch lands after ~11 blocks, not ~43."""

import numpy as np
import pytest

from libgooey_tpu_torch import capi


@pytest.fixture
def h(monkeypatch):
    monkeypatch.setenv(capi.DEVICE_ENV, "cpu")
    handle = capi.engine_new(44100.0)
    yield handle
    capi.engine_free(handle)


def test_mixer_graph_and_track_effects(h):
    assert capi.engine_mixer_get_track_count(h) == 4
    t = capi.engine_mixer_add_track(h, "Aux")
    assert capi.engine_mixer_find_track(h, "Aux") == t
    assert capi.engine_mixer_get_track_name(h, t) == "Aux"
    capi.engine_mixer_set_track_gain(h, t, 1.5)
    assert abs(capi.engine_mixer_get_track_gain(h, t) - 1.5) < 1e-7
    capi.engine_mixer_set_track_pan(h, t, 0.2)
    capi.engine_mixer_set_track_mute(h, t, 1)
    capi.engine_mixer_set_track_solo(h, t, 1)
    assert capi.engine_mixer_get_track_mute(h, t) == 1
    assert capi.engine_mixer_get_track_solo(h, t) == 1
    capi.engine_mixer_set_track_mute(h, t, 0)
    capi.engine_mixer_set_track_solo(h, t, 0)
    assert capi.engine_mixer_route_source(h, 0, t) == 1
    assert capi.engine_mixer_get_source_route(h, 0) == t
    assert capi.engine_mixer_unroute_source(h, 0) == 1
    assert capi.engine_mixer_get_source_route(h, 0) == -1
    assert capi.engine_track_effect_add(h, t, 0) == 1  # lowpass
    assert capi.engine_track_effect_count(h, t) == 1
    assert capi.engine_track_effect_type_at(h, t, 0) == 0
    assert capi.engine_track_effect_set_param(h, t, 0, 0, 2000.0) == 1
    capi.engine_track_effect_clear(h, t)
    assert capi.engine_track_effect_count(h, t) == 0
    capi.engine_mixer_reset_default_layout(h)
    assert capi.engine_mixer_get_track_count(h) == 4


def test_loop_family(h):
    ramp = (np.arange(2000, dtype=np.float32) % 500) / 500.0
    inter = np.repeat(ramp, 2)  # stereo interleaved
    assert capi.engine_loop_load(h, 0, inter, 2, 44100.0, 120.0) == 1
    capi.engine_loop_set_gain(h, 0, 0.8)
    capi.engine_loop_set_speed(h, 0, 1.0)
    assert capi.engine_loop_set_pitch_mode(h, 0, 1) == 1  # Resample
    assert capi.engine_loop_get_pitch_mode(h, 0) == 1
    assert capi.engine_loop_get_source_bpm(h, 0) == 120.0
    capi.engine_loop_set_start(h, 0, 0.0)
    capi.engine_loop_set_end(h, 0, 0.5)
    capi.engine_loop_set_playing(h, 0, 1)
    capi.engine_transport_start(h)
    out = capi.engine_render(h, 1024)
    assert np.abs(out).max() > 1e-4
    assert 0.0 <= capi.engine_loop_get_position(h, 0) <= 1.0
    assert capi.engine_loop_effect_add(h, 0, 2) == 1  # saturation
    assert capi.engine_loop_effect_count(h, 0) == 1
    assert capi.engine_loop_effect_type_at(h, 0, 0) == 2
    assert capi.engine_loop_effect_set_param(h, 0, 0, 0, 0.8) == 1
    capi.engine_loop_effect_clear(h, 0)
    # quantized swap: queue a different buffer, render until it lands
    other = np.zeros(1000 * 2, np.float32)
    assert capi.engine_loop_queue_swap(h, 0, other, 2, 44100.0, 1) == 1
    for _ in range(8):
        capi.engine_render(h, 512)
        if capi.engine_loop_swaps_completed(h, 0):
            break
    assert capi.engine_loop_swaps_completed(h, 0) == 1
    capi.engine_loop_restart(h, 0)
    capi.engine_loop_set_playing(h, 0, 0)


def test_clip_family(h):
    capi.engine_set_bpm(h, 480.0)
    ones = np.ones(44100 * 2, np.float32)
    assert capi.engine_clip_load(h, 1, 2, ones, 2, 44100.0, 120.0) == 1
    assert capi.engine_clip_get_state(h, 1, 2) & 1  # LOADED
    assert capi.engine_clip_set_default_quantization(h, 1) == 1  # quarter
    assert capi.engine_clip_get_default_quantization(h) == 1
    capi.engine_transport_start(h)
    assert capi.engine_clip_launch(h, 1, 2) == 1
    assert capi.engine_clip_get_queued_row(h, 1) == 2
    assert capi.engine_clip_get_scheduled_beat(h, 1) >= 0.0
    for _ in range(200):  # one quarter at 480 BPM = 5512.5 samples
        capi.engine_render(h, 512)
        if capi.engine_clip_get_active_row(h, 1) == 2:
            break
    assert capi.engine_clip_get_active_row(h, 1) == 2
    assert capi.engine_clip_get_active_playhead(h, 1) >= 0.0
    assert capi.engine_clip_set_trim(h, 1, 2, 0.1, 0.9, 0) == 1
    assert abs(capi.engine_clip_get_trim_start(h, 1, 2) - 0.1) < 1e-7
    assert capi.engine_clip_stop_at_beat(
        h, 1, capi.engine_transport_get_beat_position(h)) == 1
    assert capi.engine_clip_is_stop_queued(h, 1) == 1
    capi.engine_render(h, 512)
    assert capi.engine_clip_get_active_row(h, 1) == -1
    assert capi.engine_clip_unload(h, 1, 2) == 1
    capi.engine_clip_clear(h)


def test_sampler_family(h):
    assert capi.engine_sampler_register(h) == 0
    src = capi.engine_sampler_get_source_id(h, 0)
    assert src >= 4
    # unrouted sources are silent (graph.rs:343-350): route to a track
    assert capi.engine_mixer_route_source(h, src, 3) == 1
    # (a lone impulse would vanish in the 32-frame edge fade — use a tone)
    tone = np.sin(2 * np.pi * 440 * np.arange(256) / 44100).astype(np.float32)
    assert capi.engine_sampler_set_slot_buffer(h, 0, 3, tone, 1, 44100.0) == 1
    assert capi.engine_sampler_slot_is_loaded(h, 0, 3) == 1
    assert capi.engine_sampler_slot_frames(h, 0, 3) == 256
    assert capi.engine_sampler_slot_sample_rate(h, 0, 3) == 44100.0
    assert capi.engine_sampler_trigger(h, 0, 3, 1.0) == 1
    out = capi.engine_render(h, 1024)
    assert np.abs(out).max() > 1e-4
    assert capi.engine_sampler_set_step(h, 0, 0, 1, 3, 1.0) == 1
    assert capi.engine_sampler_get_step(h, 0, 0) == (1, 3, 1.0)
    assert capi.engine_sampler_start_pattern(h, 0, 0.0) == 1
    assert capi.engine_sampler_get_pending_start_beat(h, 0) == 0.0
    capi.engine_transport_start(h)
    capi.engine_render(h, 512)
    assert capi.engine_sampler_is_pattern_running(h, 0) == 1
    capi.engine_sampler_stop_pattern(h, 0)
    assert capi.engine_sampler_is_pattern_running(h, 0) == 0
    assert capi.engine_sampler_clear_slot(h, 0, 3) == 1
    assert capi.engine_sampler_slot_is_loaded(h, 0, 3) == 0


def test_bounce_and_midi(h):
    capi.engine_trigger_channel_with_velocity(h, 0, 1.0)
    buf = capi.engine_bounce_to_buffer(h, 1024)
    assert buf.shape == (2048,) and np.abs(buf).max() > 1e-4
    capi.engine_sequencer_set_step(h, 0, 0, 1, 1.0)
    capi.engine_sequencer_start(h, 0)
    capi.engine_render(h, 512)
    events = capi.engine_drain_midi_events(h)
    assert len(events) >= 1
    assert capi.engine_drain_midi_events(h) == []
