"""The port's submix graph (``mixer/graph.py``) against the JAX package's,
both on the CPU: ``graph_block`` and ``MixerGraph.render`` with the default
layout and custom routes, track gain, pan and scoped solo, a two-effect
rack, the peaks through ``record_peaks``/``take_peak``; audio within 1e-6,
state within 1e-5.  The port starts from the JAX graph's device state
(``interop.graph_state_from_numpy``) after a few blocks."""

import numpy as np
import pytest
import torch

from libgooey_tpu.core.smoother import SmootherBank as JBank
from libgooey_tpu.mixer import chain as jchain
from libgooey_tpu.mixer import graph as jgraph

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.core.smoother import SmootherBank as TBank
from libgooey_tpu_torch.mixer import chain as tchain
from libgooey_tpu_torch.mixer import graph as tgraph

SR = 8000.0
B = 128
AUDIO_TOL = 1e-6
STATE_TOL = 1e-5


def _frames(rs):
    return (rs.randn(tgraph.SOURCE_CAPACITY, 2, B) * 0.3).astype(np.float32)


def _leaves(tree):
    return [np.asarray(x) for x in torch.utils._pytree.tree_leaves(tree)]


def _state_close(jg, tg):
    st = interop.graph_state_from_numpy(jg, "cpu")
    np.testing.assert_allclose(tg._smooth.current.numpy(), st.smooth.current.numpy(),
                               atol=STATE_TOL)
    for jr, tr in zip(st.racks, (t.rack.states for t in tg.tracks)):
        for a, b in zip(_leaves(jr), _leaves(tr)):
            np.testing.assert_allclose(b, a, atol=STATE_TOL, rtol=STATE_TOL)


def test_graph_block_matches_jax():
    """The bare block function: routing, strips moving toward new targets,
    a lowpass + delay rack on one track, per-track peaks."""
    import jax.numpy as jnp

    rs = np.random.RandomState(0)
    T = 3
    routing = np.zeros((T, tgraph.SOURCE_CAPACITY), np.float32)
    routing[0, [0, 5]] = 1.0
    routing[1, 1] = 1.0
    routing[2, [3, 4, 8]] = 1.0
    start = np.array([[1.0, 0.5, 1.0], [0.5, 0.2, 1.0], [1.5, 0.9, 0.0]], np.float32)
    targets = np.array([[0.3, 0.8, 1.0], [1.8, 0.5, 0.0], [1.0, 0.1, 1.0]], np.float32)
    racks = {"j": [], "t": []}
    for mod, key, dev in ((jchain, "j", {}), (tchain, "t", {"device": "cpu"})):
        for t in range(T):
            c = mod.EffectChain(SR, 120.0, **dev)
            if t == 1:
                c.add(mod.EFFECT_LOWPASS_FILTER)
                c.add(mod.EFFECT_DELAY)
                c.set_param(0, 0, 900.0)
                c.set_param(1, 2, 0.5)
            racks[key].append(c)
    keys = tuple(c.static_key() for c in racks["t"])
    jbank = JBank(jnp.asarray(start), jnp.asarray(start))
    tbank = TBank(torch.as_tensor(start), torch.as_tensor(start))
    jst = tuple(tuple(c.states) for c in racks["j"])
    tst = tuple(tuple(c.states) for c in racks["t"])
    for blk in range(4):
        x = _frames(rs)
        jbank, jst, jm, jp = jgraph.graph_block(
            jbank, jnp.asarray(targets), jnp.asarray(x), jnp.asarray(routing), jst,
            tuple(tuple(c.targets_list()) for c in racks["j"]), coeff=tgraph.smoothing_coeff(
                SR, 10.0), block_size=B, sample_rate=SR, rack_keys=keys)
        tbank, tst, tm, tp = tgraph.graph_block(
            tbank, torch.as_tensor(targets), torch.as_tensor(x), torch.as_tensor(routing), tst,
            tuple(tuple(c.targets_list()) for c in racks["t"]), coeff=tgraph.smoothing_coeff(
                SR, 10.0), block_size=B, sample_rate=SR, rack_keys=keys)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=AUDIO_TOL, rtol=0)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=AUDIO_TOL, rtol=0)
    np.testing.assert_allclose(tbank.current.numpy(), np.asarray(jbank.current), atol=STATE_TOL)
    for a, b in zip(_leaves(jst), _leaves(tst)):
        np.testing.assert_allclose(b, a, atol=STATE_TOL, rtol=STATE_TOL)


def _configure(g, mod, custom):
    if custom:
        g.add_track("FX")
        g.route(jgraph.SOURCE_LOOPMIXER, 4)
        g.route(jgraph.SOURCE_SAMPLER_BASE + 2, 0)
        g.route(jgraph.SOURCE_BASS, None)
        assert not g.route(jgraph.SOURCE_CAPACITY, 0) and not g.route(0, 9)
    g.set_track_gain(0, 1.7)
    g.set_track_pan(1, 0.2)
    g.set_track_pan(3, 0.95)
    rack = g.tracks[3].rack
    rack.add(mod.EFFECT_SATURATION)
    rack.add(mod.EFFECT_LOWPASS_FILTER)
    rack.set_param(1, 0, 2500.0)


def _render(g, frames, to_array):
    peaks = None
    out = []
    for x in frames:
        master, peaks = g.render(to_array(x), B)
        g.record_peaks(peaks)
        out.append(np.asarray(master))
    return np.stack(out)


@pytest.mark.parametrize("custom", [False, True], ids=["default_layout", "custom_routes"])
def test_mixer_graph_render_matches_jax(custom):
    """Three blocks on the JAX graph, the port started from its state, then
    both through a solo (scoped: the soloed track only), a mute and a gain
    change, with peaks taken at the end."""
    import jax.numpy as jnp

    rs = np.random.RandomState(1 + custom)
    jg = jgraph.MixerGraph.with_default_layout(SR, 120.0)
    tg = tgraph.MixerGraph.with_default_layout(SR, 120.0, device="cpu")
    _configure(jg, jchain, custom)
    _configure(tg, tchain, custom)
    np.testing.assert_array_equal(tg.routing_matrix(), jg.routing_matrix())

    _render(jg, [_frames(rs) for _ in range(3)], jnp.asarray)
    interop.load_graph_state(tg, interop.graph_state_from_numpy(jg, "cpu"))
    for t, j in zip(tg.tracks, jg.tracks):
        t.peak = j.peak
    outs = {"j": [], "t": []}
    for step in range(3):
        frames = [_frames(rs) for _ in range(2)]
        outs["j"].append(_render(jg, frames, jnp.asarray))
        outs["t"].append(_render(tg, frames, torch.as_tensor))
        for g in (jg, tg):
            if step == 0:
                g.set_track_solo(3, True)
            if step == 1:
                g.set_track_solo(3, False)
                g.set_track_mute(0, True)
                g.set_track_gain(2, 0.25)
    got, want = np.concatenate(outs["t"]), np.concatenate(outs["j"])
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=AUDIO_TOL, rtol=0)
    _state_close(jg, tg)
    for t in range(len(jg.tracks)):
        assert tg.take_peak(t) == pytest.approx(jg.take_peak(t), abs=AUDIO_TOL)
        assert tg.take_peak(t) == 0.0 == jg.take_peak(t)
