"""The port's ``GooeyEngine`` span path against its own per-block path, on
the CPU, as tests/test_gooey_span.py pins the JAX package's two paths.

``render(frames)`` of two blocks or more plans the host half of K blocks,
uploads the plans once and runs the device half of each block in a Python
loop (``gooey._span_render``); ``span_rendering=False`` runs
``_render_one_block`` K times.  Each case drives two engines alike and holds
the renders to 1e-4: sequencer triggers with swing, strip gating and
effects; per-step blends and notes; LFO routes and a compressor keyed from a
strip; the granulator, a rack and performance replay; loops under the clip
grid; peaks and the MIDI-out queue; a multi-trigger block (``[V, K]``
slots); host automation between calls.  Then the span's block loop is
checked for host reads: no ``.cpu()``, ``.item()``, ``.numpy()``,
``.tolist()``, ``__array__`` or ``torch.cuda.synchronize`` inside it, and no
upload from the host outside the kernels' plain versions (which the card
does not run).  No JAX compile; B = 128.
"""

import collections
import sys

import numpy as np
import pytest
import torch

from libgooey_tpu_torch import gooey
from libgooey_tpu_torch.core.blendable import PresetBlender
from libgooey_tpu_torch.gooey import GooeyEngine
from libgooey_tpu_torch.instruments import kick as kick_mod
from libgooey_tpu_torch.instruments import snare as snare_mod
from libgooey_tpu_torch.mixer import chain as chain_mod
from libgooey_tpu_torch.mixer.stereo_buffer import StereoSampleBuffer

SR = 44100.0
B = 128
BPM = 2400.0     # a sixteenth every ~276 samples: a step every ~2 blocks
TOL = 1e-4


def _pair(setup):
    ga, gb = GooeyEngine(SR, B, device="cpu"), GooeyEngine(SR, B, device="cpu")
    gb.span_rendering = False
    for g in (ga, gb):
        g.set_bpm(BPM)
        setup(g)
    return ga, gb


def _compare(ga, gb, frames, tol=TOL):
    a, b = ga.render(frames), gb.render(frames)
    assert ga.error is None, ga.error
    assert gb.error is None, gb.error
    err = float(np.abs(a - b).max())
    assert err < tol, err
    assert float(np.abs(a).max()) > 1e-3
    return a


def _strips(g, patterns=("x.x.x.x.x.x.x.x.",) * 4):
    for ch, p in enumerate(patterns):
        if p:
            g.sequencers[ch].set_pattern_string(p)
            g.sequencers[ch].start()


def test_span_sequencers_swing_gating_fx():
    def setup(g):
        _strips(g)
        for ch in range(4):
            g.sequencers[ch].set_swing(0.6)
        g.strip_pan[:] = [0.2, 0.4, 0.6, 0.8, 0.5]
        g.strip_mute[3] = True
        g.strip_solo[1] = g.strip_solo[0] = True
        for eid in (chain_mod.EFFECT_SATURATION, chain_mod.EFFECT_DELAY,
                    chain_mod.EFFECT_REVERB):
            g.set_effect_enabled(eid, True)
        g.trigger_channel(1, 0.9)

    ga, gb = _pair(setup)
    _compare(ga, gb, 4 * B)
    # the state carries across spans and into the per-block path
    _compare(ga, gb, 2 * B)
    ga.span_rendering = False
    _compare(ga, gb, B + 17)


def test_span_blend_and_note_steps():
    """Per-step blend snaps and per-step note overrides (param 0 saved and
    restored) arrive mid-span as staged targets and snap masks."""
    def setup(g):
        blender = PresetBlender(kick_mod.KickConfig.tight(), kick_mod.KickConfig.punch_preset(),
                                kick_mod.KickConfig.loose(), kick_mod.KickConfig.dirt())
        g.set_blender(0, blender)
        seq = g.sequencers[0]
        seq.set_pattern_string("x.x.x.x.x.x.x.x.")
        seq.set_step_blend(2, 0.9, 0.1)
        seq.set_step_blend(4, 0.1, 0.9)
        seq.start()
        for ch, notes in ((1, (50, 62)), (2, (55, 70))):
            seq = g.sequencers[ch]
            seq.set_pattern_string("x.x.x.x.x.x.x.x.")
            seq.set_step_note(0, notes[0])
            seq.set_step_note(2, notes[1])
            seq.start()

    ga, gb = _pair(setup)
    _compare(ga, gb, 8 * B)
    # the note overrides were restored on both paths
    for kind in ("snare", "hihat2"):
        np.testing.assert_array_equal(np.stack(ga.engine._targets[kind]),
                                      np.stack(gb.engine._targets[kind]))
    assert ga.get_param(1, "frequency") == pytest.approx(snare_mod.PRESETS["default"]().frequency)
    _compare(ga, gb, 2 * B)


def test_span_lfo_routes_and_sidechain():
    def setup(g):
        g.engine.set_lfo(0, frequency_hz=3.0, amount=0.8)
        g.engine.lfos[0].enabled = True
        g.engine.add_lfo_route(0, "ch0_kick", "frequency", 0.7)
        g.engine.add_lfo_route(0, "bass", "filter_cutoff", 0.5)
        _strips(g, ("x.x.x.x.x.x.x.x.", "", "", "", "x...x...x...x..."))
        g.set_effect_enabled(chain_mod.EFFECT_SATURATION, True)
        g.set_effect_enabled(chain_mod.EFFECT_COMPRESSOR, True)
        g.set_effect_enabled(chain_mod.EFFECT_DELAY, True)
        g.sidechain_strip = 0

    ga, gb = _pair(setup)
    _compare(ga, gb, 4 * B)


def test_span_granulator_racks_and_perf():
    def setup(g):
        rng = np.random.default_rng(5)
        g.granulator_load(rng.standard_normal(4096).astype(np.float32) * 0.3, SR)
        g.granulator_set_param("density", 0.9)
        g.granulator_trigger(1.0)
        g.register_sampler_rack(0, arena_frames=1 << 13)
        buf = (np.sin(np.arange(2000) * 0.05) * 0.5).astype(np.float32)
        g.racks[0].set_buffer(3, np.stack([buf, buf], axis=1), SR)
        g.sampler_trigger(0, 3, 0.9)
        g.perf_chord_on(0, 0, 0, 0, 1, 4, 0.8)

    ga, gb = _pair(setup)
    _compare(ga, gb, 4 * B)
    for g in (ga, gb):
        g.perf_chord_off()
        g.sampler_trigger(0, 3, 0.5)
    _compare(ga, gb, 2 * B)


def test_span_performance_replay():
    """A chord recorded into the clip replays mid-span at its tick
    (the transport running, so the clock moves with the loop mixer)."""
    def setup(g):
        g.transport_start()
        g.performance.set_length_steps(1)
        g.performance.update_clock(0.0, True)
        g.performance.set_armed(True)
        g.perf_chord_on(2, 0, 1, 0, 2, 3, 0.9)
        g.performance.last_beat = 0.2
        g.perf_chord_off()
        g.performance.set_armed(False)

    ga, gb = _pair(setup)
    assert len(ga.performance.events) == 1
    _compare(ga, gb, 6 * B)


def test_span_loops_and_clip_grid():
    def setup(g):
        n = int(SR * 60 / BPM) * 4  # four beats of ramp
        ramp = np.linspace(0, 1, n, dtype=np.float32)
        buf = StereoSampleBuffer.from_channels(ramp, ramp[::-1].copy(), SR, source_bpm=BPM)
        g.mixer.channels[0].set_buffer(buf)
        g.mixer.channels[0].playing = True
        g.mixer.clip_grid.transport_start(g.mixer.channels)

    ga, gb = _pair(setup)
    _compare(ga, gb, 4 * B)
    _compare(ga, gb, 3 * B)


def test_span_peaks_and_midi_match():
    def setup(g):
        _strips(g, ("x.x.x.x.x.x.x.x.", "x...x...x...x...", "", "", "xx..xx..xx..xx.."))

    ga, gb = _pair(setup)
    _compare(ga, gb, 4 * B)
    midi = ga.drain_midi_out()
    assert midi == gb.drain_midi_out() and len(midi) >= 4
    pa = [ga.take_strip_peak(s) for s in range(5)]
    pb = [gb.take_strip_peak(s) for s in range(5)]
    np.testing.assert_allclose(pa, pb, atol=1e-6)
    assert pa[0] > 1e-3 and pa[2] == 0.0
    ta = [ga.graph.take_peak(t) for t in range(4)]
    tb = [gb.graph.take_peak(t) for t in range(4)]
    np.testing.assert_allclose(ta, tb, atol=1e-6)


def test_span_multi_trigger_block():
    """Two triggers of one voice in one block widen that kind's trigger
    events to ``[V, K]`` slots in every block of the span."""
    def setup(g):
        g.set_bpm(6000.0)           # a sixteenth every ~110 samples
        _strips(g, ("xxxxxxxxxxxxxxxx", "", "", "", "x.x.x.x.x.x.x.x."))
        g.sequencers[4].set_step_note(2, 45)

    ga, gb = _pair(setup)
    _compare(ga, gb, 5 * B)


def test_span_respects_host_automation_between_calls():
    def setup(g):
        _strips(g, ("x.x.x.x.x.x.x.x.",))

    ga, gb = _pair(setup)
    _compare(ga, gb, 3 * B)
    for g in (ga, gb):
        g.set_param(0, "frequency", 0.9)
        g.set_master_gain(0.5)
        g.set_bpm(3000.0)
        g.strip_pan[0] = 0.1
        g.set_effect_enabled(chain_mod.EFFECT_LOWPASS_FILTER, True)
        g.set_effect_enabled(chain_mod.EFFECT_PLATE_REVERB, True)
        g.set_effect_param(chain_mod.EFFECT_LOWPASS_FILTER, 0, 3000.0)
    _compare(ga, gb, 4 * B)


_READS = ("cpu", "item", "numpy", "tolist", "__array__")


def _caller(depth=2):
    return sys._getframe(depth).f_code.co_name


def test_span_loop_reads_nothing_back(monkeypatch):
    """Inside ``_span_render`` (the span's block loop): no host read of a
    tensor, no synchronisation, and no copy from the host (an upload, or an
    element assigned a Python number) but in the kernels' plain versions,
    which the card does not run.  Counted on the second render, past the
    one-time tables' first uploads."""
    seen = collections.Counter()
    real = gooey._span_render

    def counting(*args, **kw):
        saved = {n: getattr(torch.Tensor, n) for n in _READS}
        saved_setitem = torch.Tensor.__setitem__
        as_tensor, tensor, sync = torch.as_tensor, torch.tensor, torch.cuda.synchronize

        def reader(name, fn):
            def f(self, *a, **k):
                seen[name] += 1
                return fn(self, *a, **k)
            return f

        def upload(fn):
            def f(data, *a, **k):
                if (not isinstance(data, torch.Tensor) and k.get("device") is not None
                        and not _caller().endswith("_plain")):
                    seen[f"upload in {_caller()}"] += 1
                return fn(data, *a, **k)
            return f

        def setitem(self, index, value):
            if not isinstance(value, torch.Tensor) and not _caller().endswith("_plain"):
                seen[f"element set from the host in {_caller()}"] += 1
            return saved_setitem(self, index, value)

        def synchronize(*a, **k):
            seen["synchronize"] += 1
            return sync(*a, **k)

        for n, fn in saved.items():
            setattr(torch.Tensor, n, reader(n, fn))
        torch.Tensor.__setitem__ = setitem
        torch.as_tensor, torch.tensor = upload(as_tensor), upload(tensor)
        torch.cuda.synchronize = synchronize
        try:
            seen["calls"] += 1
            return real(*args, **kw)
        finally:
            for n, fn in saved.items():
                setattr(torch.Tensor, n, fn)
            torch.Tensor.__setitem__ = saved_setitem
            torch.as_tensor, torch.tensor, torch.cuda.synchronize = as_tensor, tensor, sync

    monkeypatch.setattr(gooey, "_span_render", counting)
    g = GooeyEngine(SR, B, device="cpu")
    g.set_bpm(BPM)
    _strips(g, ("x.x.x.x.x.x.x.x.",) * 4 + ("x...x...x...x...",))
    g.engine.set_lfo(0, frequency_hz=3.0, amount=0.8)
    g.engine.lfos[0].enabled = True
    g.engine.add_lfo_route(0, "ch0_kick", "frequency", 0.7)
    for eid in (chain_mod.EFFECT_SATURATION, chain_mod.EFFECT_LOWPASS_FILTER,
                chain_mod.EFFECT_DELAY, chain_mod.EFFECT_COMPRESSOR,
                chain_mod.EFFECT_PLATE_REVERB):
        g.set_effect_enabled(eid, True)
    g.sidechain_strip = 0
    rng = np.random.default_rng(5)
    g.granulator_load(rng.standard_normal(4096).astype(np.float32) * 0.3, SR)
    g.granulator_trigger(1.0)
    g.register_sampler_rack(0, arena_frames=1 << 13)
    buf = (np.sin(np.arange(2000) * 0.05) * 0.5).astype(np.float32)
    g.racks[0].set_buffer(3, np.stack([buf, buf], axis=1), SR)
    g.sampler_trigger(0, 3, 0.9)
    g.perf_chord_on(0, 0, 0, 0, 1, 4, 0.8)
    g.render(2 * B)
    seen.clear()
    out = g.render(16 * B)
    assert g.error is None, g.error
    assert float(np.abs(out).max()) > 1e-3
    assert seen == {"calls": 1}, dict(seen)
