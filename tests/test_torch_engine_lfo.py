"""LFO routes in the port against the JAX package, on the CPU: the
``VoiceBlock`` overrides a route feeds, the LFO pool's host phase and
device trajectories, and the ``Engine`` with routes (examples/lfo_test.py's
two, and a route on a family of the kit path, which takes it off the kit).

Bounds: audio <= 1e-4; trajectories and state <= 4e-4, relative to their
magnitude where that exceeds 1.  A routed kick ``frequency`` moves the
oscillator's phase, where the JAX associative scan and the port's
sequential one-pole differ by ulps that grow with time, so the engine runs
a few blocks.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from libgooey_tpu.core.smoother import SmootherBank as JSmootherBank
from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.engine import lfo as jlfo
from libgooey_tpu.engine.engine import FAMILIES as JFAMILIES
from libgooey_tpu.engine.engine import Engine as JEngine
from libgooey_tpu.instruments.common import VoiceBlock as JVoiceBlock

from libgooey_tpu_torch.core.smoother import SmootherBank as TSmootherBank
from libgooey_tpu_torch.engine import engine as tengine
from libgooey_tpu_torch.engine import lfo as tlfo
from libgooey_tpu_torch.engine.engine import FAMILIES as TFAMILIES
from libgooey_tpu_torch.engine.engine import Engine as TEngine
from libgooey_tpu_torch.instruments.common import VoiceBlock as TVoiceBlock
from libgooey_tpu_torch.ops import voice

SR = 44100.0
B = 128
OUT_TOL = 1e-4
TOL = 4e-4
COEFF = smoothing_coeff(SR)


def _close(a, b, tol=TOL):
    a = np.asarray(a, np.float64)
    b = b.numpy().astype(np.float64) if isinstance(b, torch.Tensor) else np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(a)), initial=0.0)) <= tol


@pytest.mark.parametrize("multi", [False, True])
def test_voice_block_overrides_match_jax(multi):
    """ptraj, value_at_trigger (a trigger at offset 0 reads the bank's
    current value, a later one the trajectory a sample before), eff_vec,
    latch_vec and advance_bank with two routed parameters of four."""
    rs = np.random.RandomState(5)
    V, P = 6, 4
    index = {"a": 0, "b": 1, "c": 2, "d": 3}
    cur = rs.rand(V, P).astype(np.float32)
    tgt = rs.rand(V, P).astype(np.float32)
    over = {"b": rs.rand(V, B).astype(np.float32), "d": rs.rand(V, B).astype(np.float32)}
    if multi:
        off = np.array([[0, 40], [5, B], [B, B], [127, B], [1, 2], [64, 100]], np.int32)
    else:
        off = np.array([0, 5, B, 127, 1, 64], np.int32)
    jvb = JVoiceBlock(JSmootherBank(jnp.asarray(cur), jnp.asarray(tgt)), jnp.asarray(off),
                      np.int32(3 * B), B, COEFF, index,
                      overrides={k: jnp.asarray(v) for k, v in over.items()})
    tvb = TVoiceBlock(TSmootherBank(torch.as_tensor(cur), torch.as_tensor(tgt)), off,
                      np.int32(3 * B), B, COEFF, index,
                      overrides={k: torch.as_tensor(v) for k, v in over.items()})
    for name in index:
        assert _close(jvb.ptraj(name), tvb.ptraj(name), 1e-6), name
        assert _close(jvb.value_at_trigger(name), tvb.value_at_trigger(name), 1e-6), name
    assert np.array_equal(np.asarray(jvb.has_trig), tvb.has_trig.numpy())
    K = off.shape[1] if multi else 1
    new = rs.rand(V, K, 3).astype(np.float32)
    old = rs.rand(V, 3).astype(np.float32)
    assert _close(jvb.eff_vec(jnp.asarray(new), jnp.asarray(old)),
                  tvb.eff_vec(torch.as_tensor(new), torch.as_tensor(old)), 0.0)
    assert _close(jvb.latch_vec(jnp.asarray(new), jnp.asarray(old)),
                  tvb.latch_vec(torch.as_tensor(new), torch.as_tensor(old)), 0.0)
    jb, tb = jvb.advance_bank(), tvb.advance_bank()
    assert _close(jb.current, tb.current, 1e-6) and _close(jb.target, tb.target, 0.0)
    assert np.array_equal(tb.current.numpy()[:, 1], over["b"][:, -1])


def test_lfo_pool_matches_jax():
    """The host phase in float64 (reduced mod 1 before the float32 cast),
    the frequency of the synced and free LFOs, the ``[8, B]`` trajectories
    and the bipolar targets."""
    cfgs = []
    for mod in (jlfo, tlfo):
        c = [mod.LfoConfig() for _ in range(8)]
        c[0].division, c[0].bpm = 5, 140.0
        c[1].frequency_hz, c[1].amount = 0.8, 0.2
        c[2].frequency_hz, c[2].offset = 13.7, 0.25
        c[3].division, c[3].bpm, c[3].amount = 7, 97.0, 0.6
        c[4].enabled = False
        cfgs.append(c)
    rs = np.random.RandomState(1)
    for _blk in range(200):
        rows = []
        for c in cfgs:
            rows.append(np.array([[x.advance(B, SR), x.freq() / SR,
                                   x.amount if x.enabled else 0.0, x.offset] for x in c],
                                 np.float32))
        assert np.array_equal(rows[0], rows[1])
    ph, inc, amt, offs = rows[1].T
    jt = jlfo.lfo_value_traj(jnp.asarray(ph)[:, None], jnp.asarray(inc)[:, None],
                             jnp.asarray(amt)[:, None], jnp.asarray(offs)[:, None], B)
    tt = tlfo.lfo_value_traj(*(torch.as_tensor(a) for a in (ph, inc, amt, offs)), B)
    assert _close(jt, tt, 1e-6)
    depth = rs.uniform(-2, 2, size=(8, 1)).astype(np.float32)
    assert _close(jlfo.bipolar_to_target(jt * depth),
                  tlfo.bipolar_to_target(tt * torch.as_tensor(depth)), 1e-6)


def _drive_example(eng, n_blocks, kit_route=False):
    """examples/lfo_test.py's engine (bass and kick on 140 BPM sequencers,
    LFO 0 at 1/8 on the bass cutoff, LFO 1 at 0.8 Hz on the kick pitch);
    with ``kit_route`` a snare and a hihat2 join, the hihat2 with a route
    on its decay.  Returns (stereo, mono) numpy blocks."""
    fams = JFAMILIES if isinstance(eng, JEngine) else TFAMILIES
    eng.add_instrument("bass", "bass")
    eng.add_instrument("kick", "kick")
    eng.set_lfo(0, division=5, bpm=140.0, amount=0.5)
    eng.add_lfo_route(0, "bass", "filter_cutoff", depth=0.8)
    eng.set_lfo(1, frequency_hz=0.8, amount=0.2)
    eng.add_lfo_route(1, "kick", "frequency", depth=0.5)
    seqs = {"bass": "x.x.x.x.x.x.x.x.", "kick": "x...x...x...x..."}
    if kit_route:
        eng.add_instrument("snare", "snare", fams["snare"].PRESETS["default"]())
        eng.add_instrument("hh", "hihat2", fams["hihat2"].PRESETS["loose"]())
        eng.set_lfo(2, frequency_hz=3.0, amount=1.0)
        eng.add_lfo_route(2, "hh", "decay", depth=0.7)
        seqs.update(snare="..x...x...x...x.", hh="xxxxxxxxxxxxxxxx")
    for name, pattern in seqs.items():
        seq = eng.new_sequencer(name, 480.0)
        seq.set_pattern_string(pattern)
        seq.start()
    outs, monos = [], []
    for _ in range(n_blocks):
        out, mono = eng.render_block()
        outs.append(np.asarray(out))
        monos.append(np.asarray(mono))
    return np.stack(outs), np.stack(monos)


def test_engine_lfo_example_matches_jax():
    want, want_mono = _drive_example(JEngine(SR, B), 6)
    got, got_mono = _drive_example(TEngine(SR, B, device="cpu"), 6)
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= OUT_TOL
    assert np.abs(got_mono - want_mono).max() <= OUT_TOL


def test_routed_family_leaves_the_kit_path(monkeypatch):
    """With the kit path on (its plain versions on the CPU), the routed
    kick, bass and hihat2 render on their stage paths, which leaves the
    snare alone on the kit kernels; without the routes all four take the
    kit together.  The routed render matches the JAX Engine."""
    monkeypatch.setattr(voice, "IMPL", "pallas")
    seen = []
    real = voice.kit_render_fused

    def recording(*a, kinds, **kw):
        seen.append(kinds)
        return real(*a, kinds=kinds, **kw)

    monkeypatch.setattr(voice, "kit_render_fused", recording)
    routed = []
    real_over = tengine._lfo_overrides

    def over(kind, *a):
        routed.append(kind)
        return real_over(kind, *a)

    monkeypatch.setattr(tengine, "_lfo_overrides", over)
    got, _ = _drive_example(TEngine(SR, B, device="cpu"), 4, kit_route=True)
    assert seen == [("snare",)] * 4 and routed == ["kick", "hihat2", "bass"] * 4
    want, _ = _drive_example(JEngine(SR, B), 4, kit_route=True)
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= OUT_TOL

    eng = TEngine(SR, B, device="cpu")
    _drive_example(eng, 1, kit_route=True)
    eng.clear_lfo_routes()
    seen.clear()
    eng.render_block()
    assert seen == [("kick", "snare", "hihat2", "bass")]


def test_route_api_matches_jax():
    """The 16-route cap, tom2's refusal, an unknown parameter, and clearing
    one LFO's routes or all of them."""
    engs = (JEngine(SR, B), TEngine(SR, B, device="cpu"))
    for eng in engs:
        eng.add_instrument("t", "tom2")
        eng.add_instrument("k", "kick")
        eng.add_instrument("p", "poly")
        for i in range(16):
            eng.add_lfo_route(0, "k", "frequency", depth=i / 16)
        with pytest.raises(RuntimeError, match="16"):
            eng.add_lfo_route(0, "k", "frequency")
        with pytest.raises(ValueError, match="tom2"):
            eng.add_lfo_route(1, "t", "frequency")
        with pytest.raises(KeyError):
            eng.add_lfo_route(1, "k", "no_such_param")
        eng.add_lfo_route(1, "p", "filter_cutoff", 0.3)
        eng.add_lfo_route(2, "k", "amp_decay", 0.5)
        eng.clear_lfo_routes(0)
    assert engs[0]._routes_static() == engs[1]._routes_static()
    assert engs[1]._routes_static() == ((1, "poly", 0, "filter_cutoff", 0.3),
                                        (2, "kick", 0, "amp_decay", 0.5))
    for eng in engs:
        eng.clear_lfo_routes()
    assert engs[0].lfo_routes == engs[1].lfo_routes == []
