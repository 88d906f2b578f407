"""The port's C-API surface on the CPU, part 1: ten of
``tests/test_capi_full.py``'s fifteen FFI families (ffi.rs parity; the
mixer graph, loop, clip, sampler and bounce/MIDI families are in
``test_torch_capi_media.py``), each assertion as the JAX test makes it, on
``libgooey_tpu_torch.capi`` with ``LIBGOOEY_TPU_TORCH_DEVICE=cpu``.  The
port's CPU engine renders a 512-sample block in ~2 s (its kernels' plain
versions walk their recurrences sample by sample), so the sequencer, poly
and granulator families render 2,048 frames where the JAX test renders
8,192; what they assert holds within the first 2,048.  Then the port's own
contract: no card and no CPU request raises, the master gain's getter reads
the host, and the shim's return types."""

import numpy as np
import pytest
import torch

from libgooey_tpu_torch import capi


@pytest.fixture
def h(monkeypatch):
    monkeypatch.setenv(capi.DEVICE_ENV, "cpu")
    handle = capi.engine_new(44100.0)
    yield handle
    capi.engine_free(handle)


def test_global_and_transport(h):
    capi.engine_set_bpm(h, 140.0)
    assert capi.engine_get_bpm(h) == 140.0
    capi.engine_set_master_gain(h, 0.5)
    assert abs(capi.engine_get_master_gain(h) - 0.5) < 1e-7
    assert capi.engine_has_error(h) == 0
    capi.engine_set_link_enabled(h, 1)
    assert capi.engine_is_link_enabled(h) == 1
    capi.engine_transport_start(h)
    assert capi.engine_transport_get_beat_position(h) == 0.0
    capi.engine_render(h, 512)
    assert capi.engine_transport_get_beat_position(h) > 0.0
    capi.engine_transport_stop(h)
    assert capi.engine_instrument_count() == 5


def test_typed_instrument_params_and_presets(h):
    # channel 0 is a kick by default; snare-typed setter must refuse it
    assert capi.engine_set_kick_param(h, 0, 1, 0.8) == 1     # PUNCH
    assert abs(capi.engine_get_kick_param(h, 0, 1) - 0.8) < 1e-7
    assert capi.engine_set_snare_param(h, 0, 1, 0.5) == 0
    assert capi.engine_set_snare_param(h, 1, 0, 0.3) == 1    # FREQUENCY
    assert capi.engine_set_hihat_param(h, 2, 1, 0.6) == 1    # DECAY
    assert capi.engine_set_tom_param(h, 3, 0, 55.0) == 1     # TUNE (0-100)
    assert abs(capi.engine_get_tom_param(h, 3, 0) - 55.0) < 1e-5
    assert capi.engine_set_bass_param(h, 6, 0.4) == 1        # FILTER_CUTOFF
    assert abs(capi.engine_get_bass_param(h, 6) - 0.4) < 1e-7
    assert capi.engine_load_bass_preset(h, 2) == 1           # REESE
    assert capi.engine_kick_param_count() == 8
    assert capi.engine_snare_param_count() == 20
    assert capi.engine_hihat_param_count() == 6
    assert capi.engine_tom_param_count() == 9
    capi.engine_set_channel_tuning(h, 0, 0.75)
    assert abs(capi.engine_get_channel_tuning(h, 0) - 0.75) < 1e-7


def test_strip_mixer_controls(h):
    assert capi.engine_set_instrument_gain(h, 0, 0.7) == 1
    assert abs(capi.engine_get_instrument_gain(h, 0) - 0.7) < 1e-6
    capi.engine_set_instrument_pan(h, 1, 0.25)
    assert abs(capi.engine_get_instrument_pan(h, 1) - 0.25) < 1e-6
    capi.engine_set_instrument_mute(h, 2, 1)
    assert capi.engine_get_instrument_mute(h, 2) == 1
    capi.engine_set_instrument_solo(h, 3, 1)
    assert capi.engine_get_instrument_solo(h, 3) == 1
    capi.engine_set_instrument_solo(h, 3, 0)
    capi.engine_set_instrument_mute(h, 2, 0)
    assert capi.engine_trigger_kick(h, 1.0) == 1
    out = capi.engine_render(h, 2048)
    assert np.abs(out).max() > 1e-4
    peaks = capi.engine_get_channel_peaks(h)
    assert peaks.shape == (5,) and peaks[0] > 0.0
    assert capi.engine_get_channel_peaks(h)[0] == 0.0  # read-and-reset


def test_sequencer_step_round_trip(h):
    capi.engine_sequencer_set_instrument_step_with_settings(h, 0, 3, 1, 0.9)
    capi.engine_sequencer_set_instrument_step_note(h, 0, 3, 48)
    capi.engine_sequencer_set_instrument_step_blend(h, 0, 3, 0.2, 0.8)
    assert capi.engine_sequencer_get_instrument_step_enabled(h, 0, 3) == 1
    assert abs(capi.engine_sequencer_get_instrument_step_velocity(h, 0, 3) - 0.9) < 1e-7
    assert capi.engine_sequencer_get_instrument_step_note(h, 0, 3) == 48
    assert capi.engine_sequencer_get_instrument_step_blend_enabled(h, 0, 3) == 1
    assert abs(capi.engine_sequencer_get_instrument_step_blend_x(h, 0, 3) - 0.2) < 1e-7
    capi.engine_sequencer_clear_instrument_step_note(h, 0, 3)
    assert capi.engine_sequencer_get_instrument_step_note(h, 0, 3) == 255
    capi.engine_sequencer_clear_instrument_step_blend(h, 0, 3)
    assert capi.engine_sequencer_get_instrument_step_blend_enabled(h, 0, 3) == 0
    capi.engine_sequencer_set_instrument_pattern(h, 0, 0b1000100010001)
    assert capi.engine_sequencer_get_instrument_step_enabled(h, 0, 0) == 1
    assert capi.engine_sequencer_get_instrument_step_enabled(h, 0, 1) == 0
    assert capi.engine_sequencer_step_count(h, 0) == 16
    # triggers_enabled keeps phase but silences output
    capi.engine_set_sequencer_triggers_enabled(h, 0, 0)
    assert capi.engine_get_sequencer_triggers_enabled(h, 0) == 0
    capi.engine_sequencer_start(h, 0)
    out = capi.engine_render(h, 2048)   # step 0 falls in the first block
    assert np.abs(out).max() < 1e-5
    assert capi.engine_sequencer_get_beat_position(h, 0) > 0.0


def test_lfo_pool_and_routes(h):
    assert capi.engine_lfo_count() == 8 and capi.engine_lfo_timing_count() == 8
    assert capi.engine_set_lfo_timing(h, 0, 2) == 1
    assert capi.engine_get_lfo_timing(h, 0) == 2
    capi.engine_set_lfo_amount(h, 0, 0.4)
    assert abs(capi.engine_get_lfo_amount(h, 0) - 0.4) < 1e-7
    capi.engine_set_lfo_offset(h, 0, 0.1)
    capi.engine_set_lfo_enabled(h, 0, 1)
    assert capi.engine_add_lfo_route(h, 0, 0, 0) == 1  # kick frequency
    assert capi.engine_get_lfo_route_count(h, 0) == 1
    assert capi.engine_remove_lfo_route(h, 0, 0, 0) == 1
    assert capi.engine_get_lfo_route_count(h) == 0
    capi.engine_add_lfo_route(h, 1, 1, 1)
    capi.engine_clear_lfo_routes(h)
    assert capi.engine_get_lfo_route_count(h) == 0
    capi.engine_reset_lfo_phase(h, 0)
    assert capi.engine_get_lfo_phase(h, 0) == 0.0


def test_global_fx_and_sidechain(h):
    assert capi.engine_reorderable_effect_count() == 9
    assert capi.engine_global_effect_count(h) == 10
    capi.engine_set_effect_enabled(h, 2, 1)
    assert capi.engine_get_global_effect_enabled(h, 2) == 1
    order = capi.engine_get_effect_order(h)
    assert sorted(order) == [0, 1, 2, 3, 4, 6, 7, 8, 9]
    assert capi.engine_set_compressor_sidechain(h, 0) == 1
    assert capi.engine_get_compressor_sidechain(h) == 0
    # render with the sidechained compressor enabled must not error
    capi.engine_set_effect_enabled(h, 3, 1)
    capi.engine_trigger_channel_with_velocity(h, 0, 1.0)
    out = capi.engine_render(h, 1024)
    assert np.all(np.isfinite(out)) and capi.engine_last_error(h) == ""
    capi.engine_set_compressor_sidechain(h, -1)
    assert capi.engine_get_compressor_sidechain(h) == -1


def test_poly_family(h):
    assert capi.engine_poly_available_voicing_count() == 10
    assert capi.engine_poly_set_preset(h, 4) == 1  # strings
    assert capi.engine_poly_set_param(h, 13, 0.9) == 1  # volume
    assert abs(capi.engine_poly_get_param(h, 13) - 0.9) < 1e-7
    assert capi.engine_poly_trigger_chord(h, 0, 0, 0, 0, 0, 4, 0.9) == 1
    out = capi.engine_render(h, 2048)
    assert np.abs(out).max() > 1e-4
    capi.engine_poly_release(h)


def test_blend_pads(h):
    assert capi.engine_blend_enable(h, 0) == 1
    assert capi.engine_blend_is_enabled(h, 0) == 1
    assert capi.engine_blend_set_corner_preset(h, 0, 1, 3) == 1  # BR = dirt
    assert capi.engine_blend_get_corner_preset(h, 0, 1) == 3
    assert capi.engine_blend_set_position(h, 0, 1.0, 0.0) == 1
    assert capi.engine_blend_get_position_x(h, 0) == 1.0
    assert abs(capi.engine_get_channel_param(h, 0, 0) - 0.62) < 1e-6  # dirt freq
    capi.engine_blend_reset_corners(h, 0)
    assert capi.engine_blend_get_corner_preset(h, 0, 1) == 1
    capi.engine_blend_disable(h, 0)
    assert capi.engine_blend_set_position(h, 0, 0.5, 0.5) == 0


def test_granulator_extras(h):
    t = np.sin(2 * np.pi * 220 * np.arange(44100) / 44100).astype(np.float32)
    assert capi.engine_granulator_set_buffer(h, t, 44100.0) == 1
    assert capi.engine_granulator_buffer_len(h) == 44100
    assert capi.engine_granulator_buffer_sample_rate(h) == 44100.0
    capi.engine_granulator_set_seed(h, 1234)
    capi.engine_granulator_set_param(h, 4, 0.9)  # density
    assert abs(capi.engine_granulator_get_param(h, 4) - 0.9) < 1e-6
    capi.engine_granulator_snap_params(h)
    capi.engine_granulator_trigger(h, 1.0)
    out = capi.engine_render(h, 2048)
    assert np.abs(out).max() > 1e-5
    assert capi.engine_granulator_active_grain_count(h) >= 0


def test_perf_family(h):
    p = capi._perf(h)
    capi.engine_perf_set_record_mode(h, 1)
    assert capi.engine_perf_get_record_mode(h) == 1
    capi.engine_perf_set_record_mode(h, 0)
    p.update_clock(0.0, True)
    capi.engine_perf_set_record_armed(h, 1)
    assert capi.engine_perf_is_record_armed(h) == 1
    p.update_clock(0.0, True)
    assert capi.engine_perf_is_recording(h) == 1
    p.last_beat = 0.25
    p.record_chord_on(2, 0, 1, 0, 0, 4, 0.8)
    p.last_beat = 0.5
    p.record_chord_off()
    assert capi.engine_perf_get_event_count(h) == 1
    ev = capi.engine_perf_get_event(h, 0)
    assert ev[2] == 2 and ev[4] == 1 and abs(ev[8] - 0.8) < 1e-7
    assert capi.engine_perf_get_length_ticks(h) == \
        capi.engine_perf_get_length_steps(h) * 24
    capi.engine_perf_clear_clip(h)
    assert capi.engine_perf_get_event_count(h) == 0


# --- the port's own contract ---------------------------------------------------------


def test_engine_new_needs_a_card_or_a_cpu_request(monkeypatch):
    """With no card and no CPU request ``engine_new`` raises (the shim then
    returns handle 0 with the error latched); it never falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delenv(capi.DEVICE_ENV, raising=False)
    before = dict(capi._engines)
    with pytest.raises(RuntimeError, match="CUDA"):
        capi.engine_new(44100.0)
    assert capi._engines == before
    monkeypatch.setenv(capi.DEVICE_ENV, "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        capi.engine_new(44100.0)


def test_master_gain_getter_reads_the_host(h):
    """The getter reads the host mirror of the master target, never the
    device smoother (a copy of a CUDA tensor, or a blocking ``.item()``)."""
    capi.engine_set_master_gain(h, 0.7)
    e = capi._e(h)

    class _NoRead:
        def __getattr__(self, name):
            raise AssertionError(f"the getter read master.{name}")

    dev_master = e.master
    e.master = _NoRead()
    try:
        assert capi.engine_get_master_gain(h) == float(np.float32(0.7))
    finally:
        e.master = dev_master
    assert float(dev_master.target) == capi.engine_get_master_gain(h)
    capi.engine_render(h, 512)   # the mirror outlives a render
    assert capi.engine_get_master_gain(h) == float(np.float32(0.7))


def test_snap_params_keeps_the_target_mirror(h):
    capi.engine_granulator_set_param(h, 2, 0.3)   # spray
    e = capi._e(h)
    mirror = e._gran_targets.copy()
    capi.engine_granulator_snap_params(h)
    np.testing.assert_array_equal(e._gran_targets, mirror)
    p = e.gran_state.params
    np.testing.assert_array_equal(p.current.numpy(), mirror)
    np.testing.assert_array_equal(p.target.numpy(), mirror)


def test_return_types_for_the_shim(h):
    """Audio and float arrays are contiguous float32 numpy arrays (the shim
    reads them through the buffer protocol, which a tensor lacks); ids and
    counts are Python ints."""
    capi.engine_trigger_channel_with_velocity(h, 0, 1.0)
    for arr, n in ((capi.engine_render(h, 300), 600),
                   (capi.engine_bounce_to_buffer(h, 200), 400),
                   (capi.engine_get_channel_peaks(h), 5)):
        assert type(arr) is np.ndarray and arr.dtype == np.float32
        assert arr.flags["C_CONTIGUOUS"] and arr.shape == (n,)
        memoryview(arr).cast("B")    # the buffer protocol
    for v in (capi.engine_get_channel_instrument(h, 0), capi.engine_instrument_count(),
              capi.engine_mixer_get_track_count(h), capi.engine_sequencer_step_count(h, 0),
              capi.engine_get_lfo_route_count(h), capi.engine_global_effect_count(h),
              capi.engine_set_channel_param(h, 0, 0, 0.5), capi.engine_has_error(h),
              capi.engine_mixer_add_track(h, "Aux"), capi.engine_sampler_register(h),
              capi.engine_granulator_buffer_len(h), capi.engine_perf_get_length_steps(h)):
        assert type(v) is int, (v, type(v))
    for v in (capi.engine_get_bpm(h), capi.engine_get_master_gain(h),
              capi.engine_get_channel_param(h, 0, 0), capi.engine_take_channel_peak(h, 0),
              capi.engine_transport_beat(h), capi.engine_get_lfo_phase(h, 0)):
        assert type(v) is float, (v, type(v))
