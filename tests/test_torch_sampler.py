"""The port's sampler rack against the JAX package's (its gather path, the
semantics the port's ``sampler_read_linear`` follows), all on the CPU:
rendered blocks, carried state, and the host's events bit for bit."""

import jax.numpy as jnp
import numpy as np
import torch

from libgooey_tpu.instruments import sampler as jsamp

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.instruments import sampler as tsamp

SR = 44100.0
B = 512


def _jax_events(ev):
    return jsamp.StartEvents(*(jnp.asarray(a) for a in ev))


def test_render_block_matches_jax():
    """test_sampler_pallas_read_matches_gather's inputs (16 voices started
    at mixed offsets, bases across the arena, increments 0.4-3), then an
    empty block: 1e-6, the state exactly."""
    rng = np.random.RandomState(3)
    jst = jsamp.init_state(1 << 14)
    arena = rng.standard_normal((1 << 14, 2)).astype(np.float32) * 0.4
    jst = jst._replace(arena=jnp.asarray(arena))
    tst = interop.sampler_state_from_numpy(jst, "cpu")
    K = jsamp.MAX_STARTS_PER_BLOCK
    ev = tsamp.StartEvents(
        voice=np.arange(K, dtype=np.int32),
        offset=rng.randint(0, 512, K).astype(np.int32),
        base=(rng.randint(0, 12, K) * 1000).astype(np.int32),
        frames=rng.uniform(400, 3000, K).astype(np.float32),
        increment=rng.uniform(0.4, 3.0, K).astype(np.float32),
        velocity=rng.uniform(0.3, 1.0, K).astype(np.float32),
    )
    for i, e in enumerate([ev, tsamp.StartEvents.empty()]):
        jst, jy = jsamp.render_block(jst, _jax_events(e), np.int32(i * B), sample_rate=SR,
                                     block_size=B, voice_read="gather")
        tst, ty = tsamp.render_block(tst, e, i * B, sample_rate=SR, block_size=B)
        assert ty.shape == (2, B)
        assert np.abs(ty.numpy() - np.asarray(jy)).max() <= 1e-6
        for a, b in zip(jst, interop.to_numpy(tst)):
            np.testing.assert_array_equal(np.asarray(a), b)
    assert np.abs(np.asarray(jy)).max() > 0.1


def _drive_host(mod, host, n_blocks):
    """Slots loaded with set_buffer (mono and stereo, 44.1, 96 and 22.05
    kHz), a pattern scheduled to start at beat 0.5, manual triggers past
    the voice count (oldest-age stealing), a cleared slot; returns each
    block's events as numpy arrays."""
    rs = np.random.RandomState(11)
    host.set_buffer(0, rs.uniform(-0.5, 0.5, 3000).astype(np.float32), SR)
    host.set_buffer(3, rs.uniform(-0.5, 0.5, (1500, 2)).astype(np.float32), 96000.0)
    host.set_buffer(7, rs.uniform(-0.5, 0.5, 800).astype(np.float32), 22050.0)
    for step in range(16):
        host.set_step(step, step % 3 != 1, (0, 3, 7)[step % 3], 0.5 + 0.03 * step)
    host.schedule_start(0.5)
    out = []
    beat = 0.0
    for blk in range(n_blocks):
        host.activate_start_if_due(beat)
        beat += B / SR * 480.0 / 60.0
        if 2 <= blk < 5:   # 14 starts a block for 3 blocks: more than the voices
            for i in range(14):
                host.trigger((0, 3)[i % 2], 0.9, offset=(7 * i + blk) % B)
        if blk == 6:
            host.clear_slot(7)
        ev = host.collect_events(blk * B, B, **({"device": False} if mod is jsamp else {}))
        out.append([np.asarray(a) for a in ev])
    return out


def test_host_events_match_jax_bit_for_bit():
    jh = jsamp.SamplerRackHost(SR, 480.0, arena_frames=1 << 14)
    th = tsamp.SamplerRackHost(SR, 480.0, arena_frames=1 << 14)
    want = _drive_host(jsamp, jh, 12)
    got = _drive_host(tsamp, th, 12)
    started = 0
    for w_blk, g_blk in zip(want, got):
        for a, b in zip(w_blk, g_blk):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        started += int((g_blk[0] >= 0).sum())
    assert started > tsamp.VOICES   # voices were stolen
    np.testing.assert_array_equal(jh.arena, th.arena)
    np.testing.assert_array_equal(jh.voice_age, th.voice_age)


def test_host_driven_rack_matches_jax():
    """The host's events through both render paths, 12 blocks: 1e-6."""
    jh = jsamp.SamplerRackHost(SR, 480.0, arena_frames=1 << 14)
    th = tsamp.SamplerRackHost(SR, 480.0, arena_frames=1 << 14)
    events = _drive_host(jsamp, jh, 12)
    _drive_host(tsamp, th, 12)
    jst = jsamp.init_state(1 << 14)._replace(arena=jnp.asarray(jh.arena))
    tst = tsamp.init_state(1 << 14, device="cpu")._replace(arena=torch.from_numpy(th.arena))
    peak = 0.0
    for i, ev in enumerate(events):
        jst, jy = jsamp.render_block(jst, jsamp.StartEvents(*map(jnp.asarray, ev)),
                                     np.int32(i * B), sample_rate=SR, block_size=B)
        tst, ty = tsamp.render_block(tst, tsamp.StartEvents(*ev), i * B, sample_rate=SR,
                                     block_size=B)
        assert np.abs(ty.numpy() - np.asarray(jy)).max() <= 1e-6, i
        peak = max(peak, float(ty.abs().max()))
    assert peak > 0.1


def test_state_round_trips_through_numpy():
    st = tsamp.init_state(1 << 10, device="cpu")
    st = st._replace(frames=torch.linspace(10.0, 500.0, tsamp.VOICES),
                     start_sample=torch.arange(tsamp.VOICES, dtype=torch.int32))
    back = interop.sampler_state_from_numpy(interop.to_numpy(st), "cpu")
    for a, b in zip(st, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
