"""The port's Engine API, kick voice and host logic against the JAX package
and the per-sample kick oracle (all on the CPU).  Engine comparisons hold
the stereo and mono output to 1e-4 (and, with the global bus, every state
leaf to 4e-4 relative to its magnitude where that exceeds 1, as
tests/test_torch_kit_bus.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from libgooey_tpu.engine.engine import FAMILIES as JFAMILIES
from libgooey_tpu.engine.engine import Engine as JEngine
from libgooey_tpu.engine.sequencer import Sequencer as JSequencer
from libgooey_tpu.instruments import kick as jkick

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.core.smoother import smoothing_coeff
from libgooey_tpu_torch.engine.engine import FAMILIES as TFAMILIES
from libgooey_tpu_torch.engine.engine import Engine as TEngine
from libgooey_tpu_torch.engine.sequencer import Sequencer as TSequencer
from libgooey_tpu_torch.instruments import kick as tkick
from libgooey_tpu_torch.ops import osc

from kick_oracle import KickOracle
from test_torch_bus import max_state_err

SR = 44100.0
B = 128
KICK_STATIC = {"kick": {"max_harmonics": 0, "feedback_path": False}}


def _drive(eng, n_blocks):
    """Three sequenced kicks with mixer moves, a manual trigger and a
    parameter change mid-render; returns (stereo, mono) numpy blocks."""
    names = ("a", "b", "c")
    presets = ("tight", "punch", "dirt")
    for i, (name, p) in enumerate(zip(names, presets)):
        mod = jkick if isinstance(eng, JEngine) else tkick
        eng.add_kick(name, mod.PRESETS[p]())
        seq = eng.new_sequencer(name, 140.0 + 20.0 * i)
        seq.set_pattern([(s + i) % 3 == 0 for s in range(16)])
        seq.start()
    eng.set_pan("a", 0.1)
    eng.set_gain("c", 0.5)
    eng.set_master_gain(0.6)
    outs, monos = [], []
    for blk in range(n_blocks):
        if blk == 1:
            eng.trigger("b", 0.9, offset=77)
        if blk == 2:
            eng.set_param("a", "frequency", 0.6)
        out, mono = eng.render_block()
        outs.append(np.asarray(out))
        monos.append(np.asarray(mono))
    return np.stack(outs), np.stack(monos)


def test_engine_api_matches_jax_engine():
    want, want_mono = _drive(JEngine(SR, B, family_static=KICK_STATIC), 4)
    got, got_mono = _drive(TEngine(SR, B, family_static=KICK_STATIC, device="cpu"), 4)
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= 1e-4
    assert np.abs(got_mono - want_mono).max() <= 1e-4


def _drive_kit(eng, n_blocks):
    """One sequenced instrument of each family with the Engine's default
    statics (kick and snare additive triangles at 128 and 192 harmonics),
    the bass sequencer carrying a note on one step and a mixer move; returns
    (stereo, mono) numpy blocks."""
    jax_side = isinstance(eng, JEngine)
    for i, kind in enumerate(("kick", "snare", "hihat2", "tom2", "bass")):
        mod = (JFAMILIES if jax_side else TFAMILIES)[kind]
        preset = sorted(k for k in mod.PRESETS if k != "default")[1]
        eng.add_instrument(kind, kind, mod.PRESETS[preset]())
        seq = eng.new_sequencer(kind, 480.0 + 60.0 * i)
        seq.set_pattern([True] * 16)
        if kind == "bass":
            seq.set_step_note(0, 45)
            seq.set_step_note(2, 52)
        seq.start()
    eng.set_pan("snare", 0.9)
    eng.set_gain("tom2", 0.5)
    outs, monos = [], []
    for blk in range(n_blocks):
        if blk == 1:
            eng.trigger("hihat2", 0.8, offset=50)
            eng.trigger("snare", 1.0, offset=100)
        out, mono = eng.render_block()
        outs.append(np.asarray(out))
        monos.append(np.asarray(mono))
    return np.stack(outs), np.stack(monos)


def test_engine_five_families_match_jax_engine():
    want, want_mono = _drive_kit(JEngine(SR, B), 4)
    got, got_mono = _drive_kit(TEngine(SR, B, device="cpu"), 4)
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= 1e-4
    assert np.abs(got_mono - want_mono).max() <= 1e-4


def _drive_fx(eng, n_blocks):
    """Two sequenced kicks through the four ported global effects, added
    through ``add_global_effect`` with the tilt at [0.3, 0.4] and the delay
    at [0.015, 0.5, 0.4, 6000]; effect targets change mid-render.  Returns
    (stereo, mono) numpy blocks."""
    mod = jkick if isinstance(eng, JEngine) else tkick
    for i, (name, p) in enumerate((("a", "punch"), ("b", "dirt"))):
        eng.add_kick(name, mod.PRESETS[p]())
        seq = eng.new_sequencer(name, 300.0 + 40.0 * i)
        seq.set_pattern([(s + i) % 2 == 0 for s in range(16)])
        seq.start()
    eng.set_pan("a", 0.2)
    eng.add_global_effect("saturation")
    eng.add_global_effect("lowpass", [5000.0, 0.5])
    eng.add_global_effect("tilt", [0.3, 0.4])
    eng.add_global_effect("delay", [0.015, 0.5, 0.4, 6000.0])
    outs, monos = [], []
    for blk in range(n_blocks):
        if blk == 3:
            eng.set_effect_param("saturation", 2, 0.5)
            eng.set_effect_param("tilt", 0, 0.7)
        out, mono = eng.render_block()
        outs.append(np.asarray(out))
        monos.append(np.asarray(mono))
    return np.stack(outs), np.stack(monos)


def test_engine_global_effects_match_jax_engine():
    jeng = JEngine(SR, B, family_static=KICK_STATIC)
    teng = TEngine(SR, B, family_static=KICK_STATIC, device="cpu")
    want, want_mono = _drive_fx(jeng, 6)
    got, got_mono = _drive_fx(teng, 6)
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= 1e-4
    assert np.abs(got_mono - want_mono).max() <= 1e-4
    assert teng.get_effect_param("tilt", 0) == jeng.get_effect_param("tilt", 0) == np.float32(0.7)
    worst, where = max_state_err(jeng._state, teng._state)
    assert worst <= 4e-4, f"state divergence {worst} at {where}"


def test_engine_effect_chain_host_api():
    eng = TEngine(SR, B, family_static=KICK_STATIC, device="cpu")
    eng.add_kick("k")
    eng.add_global_effect("tilt")
    eng.add_global_effect("delay")
    assert eng.fx_order == ["tilt", "delay"]
    eng.set_effect_order(["delay", "saturation", "tilt"])   # never added: dropped
    assert eng.fx_order == ["delay", "tilt"]
    eng.trigger("k", 1.0)
    eng.render_block()
    assert set(eng._state) >= {"fx_delay", "fx_tilt"}
    # added after the first render: its state is built then
    eng.add_global_effect("saturation", [0.5, 0.2, 1.0])
    assert "fx_saturation" in eng._state and eng.fx_order[-1] == "saturation"
    eng.remove_global_effect("tilt")
    assert eng.fx_order == ["delay", "saturation"]
    out, _ = eng.render_block()
    assert out.shape == (2, B) and bool(torch.isfinite(out).all())
    with pytest.raises(KeyError):
        eng.add_global_effect("chorus")


def test_sequencer_note_reaches_the_bass_frequency():
    eng = TEngine(SR, B, device="cpu")
    eng.add_instrument("b", "bass")
    seq = eng.new_sequencer("b", 120.0)
    seq.set_pattern([True] + [False] * 15)
    seq.set_step_note(0, 57)
    seq.start()
    eng.render_block()
    freq = float(eng._state["bass"].trig_freq[0])
    assert abs(freq - 220.0) < 1e-3


def test_engine_render_concatenates_blocks():
    def run(method):
        eng = TEngine(SR, B, family_static=KICK_STATIC, device="cpu")
        eng.add_kick("k")
        eng.trigger("k", 1.0)
        return getattr(eng, method)(300)

    out, mono = run("render"), run("render_mono")
    assert out.shape == (2, 300) and np.isfinite(out).all() and np.abs(out).max() > 1e-3
    # a centred voice: each channel is the mono sum times cos(pi/4)
    assert mono.shape == (300,)
    np.testing.assert_allclose(out[0], np.tanh(np.arctanh(mono) * np.cos(np.pi / 4)),
                               atol=1e-6)


@pytest.mark.parametrize("preset", ["tight", "punch"])
def test_kick_voice_matches_oracle(preset):
    """One voice against tests/kick_oracle.py (per-sample float32 reference),
    the -80 dBFS bar of tests/test_kick.py; the punch preset runs the
    additive triangle's plain version."""
    cfg = tkick.PRESETS[preset]()
    n, trig, vel = 2000, 37, 0.8
    st = tkick.init_state(1, cfg, device="cpu")
    got = []
    for start in range(0, n, B):
        off = np.full(1, B, np.int32)
        v = np.zeros(1, np.float32)
        if start <= trig < start + B:
            off[0], v[0] = trig - start, vel
        st, y = tkick.render_block(st, off, v, np.int32(start), sample_rate=SR, block_size=B,
                                   smooth_coeff=smoothing_coeff(SR), max_harmonics=128,
                                   feedback_path=False)
        got.append(y[0].numpy())
    got = np.concatenate(got)[:n]
    oracle = KickOracle({k: getattr(cfg, k) for k in tkick.PARAM_NAMES}, SR)
    want = np.zeros(n, np.float32)
    for i in range(n):
        if i == trig:
            oracle.trigger(i, vel)
        want[i] = oracle.tick(i)
    assert np.abs(got - want).max() < 1e-4


def test_sequencer_copy_matches_jax_sequencer():
    rs = np.random.RandomState(2)
    for bpm, swing in ((120.0, 0.5), (97.3, 0.66), (174.0, 0.2)):
        a, b = JSequencer(bpm, SR, 16), TSequencer(bpm, SR, 16)
        pattern = list(rs.rand(16) < 0.6)
        for s in (a, b):
            s.set_pattern(pattern)
            s.set_swing(swing)
            s.start()
        for _ in range(40):
            ta, tb = a.tick_block(B), b.tick_block(B)
            assert [dataclasses.astuple(t) for t in ta] == [dataclasses.astuple(t) for t in tb]


def test_interop_round_trip():
    st = tkick.init_state(5, tkick.KickConfig.dirt(), device="cpu")
    st = st._replace(velocity=torch.linspace(0.1, 0.9, 5))
    back = interop.kick_state_from_numpy(interop.to_numpy(st), "cpu")
    for a, b in zip(torch.utils._pytree.tree_leaves(st), torch.utils._pytree.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_unported_parts_raise_with_a_pointer():
    """What the port lacks raises: a state entry it has no module for (with
    a pointer to the ROADMAP), an oversampling mode other than 1x, 2x and
    4x (as the JAX package's ``oversample.process`` refuses it), an unknown
    family or effect, and a kernel on a tensor on neither CUDA nor the CPU.
    Every family of the JAX Engine is ported
    (tests/test_torch_engine_host.py), and the kick renders at ``os_mode``
    2 (tests/test_torch_os_modes.py holds it to the JAX package)."""
    eng = TEngine(SR, B, device="cpu")
    for kind in TFAMILIES:
        eng.add_instrument(kind, kind)
    assert tuple(TFAMILIES) == tuple(JFAMILIES)
    with pytest.raises(KeyError):
        eng.add_instrument("x", "theremin")
    with pytest.raises(KeyError):
        eng.add_global_effect("chorus")
    # the additive triangle now has a kernel: a tensor on neither CUDA nor
    # the CPU raises instead of falling back
    idx = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        osc.triangle_additive(idx, idx, SR, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        interop.engine_state_from_numpy({"mesh": None}, "cpu")
    st = tkick.init_state(2, device="cpu")
    kw = dict(sample_rate=SR, block_size=B, smooth_coeff=smoothing_coeff(SR), max_harmonics=0,
              feedback_path=False)
    args = (st, np.zeros(2, np.int32), np.ones(2, np.float32), 0)
    with pytest.raises(ValueError, match="unsupported oversampling mode"):
        tkick.render_block(*args, os_mode=3, **kw)
    _, out = tkick.render_block(*args, os_mode=2, **kw)
    assert torch.isfinite(out).all() and float(out.abs().max()) > 0.0
