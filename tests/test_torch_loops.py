"""The port's loop mixer (``mixer/{stereo_buffer,loop_channel,clip_grid,
mixer}.py``) against the JAX package's, both on the CPU, at 8 kHz with
small buffers: ``read_cubic`` at its wrap and clamp edges, the OFF and
RESAMPLE modes, a wrapping sub-window, a quantized swap landing mid-block,
mute/solo fades, a channel chain, ``render_block`` and ``render_blocks``
within 1e-5, the stem render with its preroll, and the clip grid's host
state (cursors, grid actions, transport beat) equal bit for bit."""

import types

import numpy as np
import pytest
import torch

from libgooey_tpu.mixer import chain as jchain
from libgooey_tpu.mixer import loop_channel as jloop
from libgooey_tpu.mixer import mixer as jmixer
from libgooey_tpu.mixer import stereo_buffer as jsb

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.mixer import chain as tchain
from libgooey_tpu_torch.mixer import loop_channel as tloop
from libgooey_tpu_torch.mixer import mixer as tmixer
from libgooey_tpu_torch.mixer import stereo_buffer as tsb

SR = 8000.0
B = 256
CAP = 1 << 14
TOL = 1e-5

JAX = types.SimpleNamespace(sb=jsb, loop=jloop, chain=jchain,
                            mixer=lambda: jmixer.Mixer(SR, block_size=B, buffer_capacity=CAP))
PORT = types.SimpleNamespace(sb=tsb, loop=tloop, chain=tchain,
                             mixer=lambda: tmixer.Mixer(SR, block_size=B, buffer_capacity=CAP,
                                                        device="cpu"))


def _noise(n, seed):
    return (np.random.RandomState(seed).randn(n) * 0.3).astype(np.float32)


def _buf(P, n, seed, bpm=120.0, sr=SR):
    return P.sb.StereoSampleBuffer.from_channels(_noise(n, seed), _noise(n, seed + 100), sr, bpm)


def _both(configure):
    return configure(JAX, JAX.mixer()), configure(PORT, PORT.mixer())


def _render(m, calls):
    """``calls``: ints (render_blocks(k)) or None (render_block())."""
    out = []
    for c in calls:
        out.append(np.asarray(m.render_block() if c is None else m.render_blocks(c)))
    return np.concatenate(out, axis=-1)


def _host_state(m):
    return [(ch.cursor, ch.active_region, ch.swaps_completed, ch.playing, ch.buffer is None,
             ch.audible) for ch in m.channels]


def _compare(configure, calls, tol=TOL):
    jm, tm = _both(configure)
    want, got = _render(jm, calls), _render(tm, calls)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert _host_state(tm) == _host_state(jm)
    return jm, tm


@pytest.mark.parametrize("wrap", [False, True])
def test_read_cubic_edges_match_jax(wrap):
    import jax.numpy as jnp

    rs = np.random.RandomState(3)
    buf = rs.randn(2, 64).astype(np.float32)
    L = 50                                   # a capacity-padded region
    pos = np.concatenate([rs.uniform(-3, 53, 200), [0.0, 49.0, 49.999, -1e-9, 50.0, -0.5]])
    pos = pos.astype(np.float32)
    length = np.full(pos.shape, L, np.float32)
    base = np.full(pos.shape, 7, np.int32)
    want = np.asarray(jsb.read_cubic(jnp.asarray(buf), jnp.asarray(pos), wrap,
                                     jnp.asarray(length), jnp.asarray(base)))
    got = tsb.read_cubic(torch.as_tensor(buf), torch.as_tensor(pos), wrap,
                         torch.as_tensor(length), torch.as_tensor(base)).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jsb.read_cubic(jnp.asarray(buf), jnp.asarray(pos), wrap))
    got = tsb.read_cubic(torch.as_tensor(buf), torch.as_tensor(pos), wrap).numpy()
    np.testing.assert_array_equal(got, want)


def _off_resample(P, m):
    m.set_bpm(150.0)                     # warp 1.25 for the resample channel
    a, b = m.channels[0], m.channels[1]
    a.set_buffer(_buf(P, 3000, 0))
    a.speed = 1.3
    a.set_playing(True)
    b.set_buffer(_buf(P, 2500, 1, sr=11025.0))
    b.pitch_mode = P.loop.PITCH_RESAMPLE
    b.set_playing(True)
    b.gain_target = 0.7
    return m


@pytest.mark.parametrize("calls", [[None] * 6, [3, 3], [None, 4, None]],
                         ids=["block", "blocks", "mixed"])
def test_off_and_resample_match_jax(calls):
    _compare(_off_resample, calls)


def _sub_window(P, m):
    ch = m.channels[2]
    ch.set_buffer(_buf(P, 3000, 2))
    ch.set_loop_window(0.8, 0.3)         # wraps: [2400, 3000) U [0, 900)
    ch.speed = 1.7
    ch.set_playing(True)
    return m


def test_wrapping_sub_window_matches_jax():
    _compare(_sub_window, [None, None, 5])


def _swap(P, m):
    ch = m.channels[0]
    ch.set_buffer(_buf(P, 1000, 3))
    ch.set_playing(True)
    ch.queue_swap(_buf(P, 1200, 4), divisions=4)   # lands at 250, mid-block
    return m


@pytest.mark.parametrize("calls", [[None] * 5, [5]], ids=["block", "blocks"])
def test_quantized_swap_mid_block_matches_jax(calls):
    jm, tm = _compare(_swap, calls)
    assert tm.channels[0].swaps_completed == 1


def _mute_solo(P, m):
    for i in (0, 1, 3):
        m.channels[i].set_buffer(_buf(P, 2048, 10 + i))
        m.channels[i].set_playing(True)
    m.channels[1].soloed = True
    m.channels[3].muted = True
    return m


def test_mute_solo_fades_match_jax():
    jm, tm = _both(_mute_solo)
    want, got = [], []
    for step in range(3):
        want.append(_render(jm, [None, 2]))
        got.append(_render(tm, [None, 2]))
        for m in (jm, tm):                # unsolo, unmute, mute another
            m.channels[1].soloed = step == 1
            m.channels[3].muted = False
            m.channels[0].muted = step == 0
    np.testing.assert_allclose(np.concatenate(got, -1), np.concatenate(want, -1),
                               atol=TOL, rtol=0)
    assert _host_state(tm) == _host_state(jm)


def _with_chain(P, m):
    ch = m.channels[1]
    ch.set_buffer(_buf(P, 2048, 5))
    ch.set_playing(True)
    ch.chain.add(P.chain.EFFECT_LOWPASS_FILTER)
    ch.chain.add(P.chain.EFFECT_DELAY)
    ch.chain.set_param(0, 0, 1500.0)
    ch.chain.set_param(1, 1, 0.6)
    ch.chain.set_param(1, 2, 0.5)
    return m


def test_channel_chain_and_state_match_jax():
    """Two blocks on each package, then the port started from the JAX
    mixer's device state (``interop.mixer_state_from_numpy``, the host
    fields equal by construction), three more blocks: audio and state."""
    jm, tm = _both(_with_chain)
    _render(jm, [None, None])
    _render(tm, [None, None])
    interop.load_mixer_state(tm, interop.mixer_state_from_numpy(jm, "cpu"))
    want, got = _render(jm, [3]), _render(tm, [3])
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert np.abs(want).max() > 1e-3 and _host_state(tm) == _host_state(jm)
    st = interop.mixer_state_from_numpy(jm, "cpu")
    for a, b in zip(st.buffers, tm._dev_buffers):
        assert torch.equal(a, b)
    for a, b in zip(st.gains, tm._gain_banks):
        np.testing.assert_allclose(b.current.numpy(), a.current.numpy(), atol=TOL)
    for ja, ta in zip(st.chains, (ch.chain.states for ch in tm.channels)):
        for x, y in zip(torch.utils._pytree.tree_leaves(ja), torch.utils._pytree.tree_leaves(ta)):
            np.testing.assert_allclose(y.numpy(), x.numpy(), atol=TOL,
                                       rtol=TOL if x.dtype.is_floating_point else 0)


def test_stem_render_with_preroll_matches_jax():
    jm, tm = _both(_with_chain)
    want = jm.render_channel_to_buffer(1, 700, preroll_blocks=3)
    got = tm.render_channel_to_buffer(1, 700, preroll_blocks=3)
    assert got.shape == (2, 700)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(tm.render_channel_to_buffer(1, 700, preroll_blocks=3), got)
    assert _host_state(tm) == _host_state(jm)


def _grid(P, m):
    from libgooey_tpu.mixer import clip_grid as jgrid

    g = m.clip_grid
    m.set_bpm(180.0)
    for col in range(3):
        g.load(col, col, _buf(P, 2000 + 300 * col, 20 + col), 120.0)
    g.set_trim(1, 1, 0.1, 0.9, jgrid.RETRIM_IMMEDIATE, m.channels)
    g.transport_start(m.channels)
    g.launch_at(0, 0, 0.0)
    g.launch_quantized(1, 1, jgrid.QUANTIZE_QUARTER)
    g.launch_at(2, 2, 1.37)              # lands mid-block
    return m


def _grid_state(m):
    g = m.clip_grid
    return (g.transport_beat, g.transport_running, list(g.active_row), list(g.launch_beat),
            [None if p is None else (p.kind, p.row, p.beat) for p in g.pending],
            [g.slot_state(c, r) for c in range(4) for r in range(8)], _host_state(m))


def test_clip_grid_host_state_and_render_match_jax():
    """The grid's actions land at the same samples (cursor, regions, states
    and transport bit for bit); the audio within the WSOLA host path's
    float32 positions (1e-5)."""
    jm, tm = _both(_grid)
    for step in range(4):
        calls = [None, None] if step % 2 else [3]
        want, got = _render(jm, calls), _render(tm, calls)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        assert _grid_state(tm) == _grid_state(jm)
        if step == 1:
            for m in (jm, tm):
                m.clip_grid.stop_at(2, m.clip_grid.transport_beat + 0.5)
    assert np.abs(want).max() > 1e-3
