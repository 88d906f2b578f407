"""The port's granulator against the JAX package's (its gather path, the
semantics the port's ``grain_read_cubic`` follows), all on the CPU: the
rendered block, the carried state leaf by leaf, and the host scheduler's
events bit for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libgooey_tpu.instruments import granulator as jgran

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.core.smoother import smoothing_coeff
from libgooey_tpu_torch.instruments import granulator as tgran

SR = 44100.0
B = 512
COEFF = smoothing_coeff(SR)

_jax_render = (functools.partial(jgran.render_block, sample_rate=SR, block_size=B,
                                        smooth_coeff=COEFF, grain_read="gather"))

#: tests/test_granulator_oracle.py's grains: two grains, one soft-stolen
#: into the release pool with a 180-sample fade
ORACLE_GRAINS = [
    dict(slot=0, offset=40, duration=700.0, src_pos=100.0, step=1.0, shape=2.0, vel=0.9),
    dict(slot=1, offset=300, duration=900.0, src_pos=2000.0, step=-0.5, shape=3.5, vel=0.7),
    dict(slot=tgran.MAX_GRAINS, offset=200, rel_total=180.0, copy_from=0),
]
#: test_pallas_grain_read_matches_gather's grains (one runs off the buffer's
#: end, one reverse off its start), then a steal of the first, and a steal
#: of the second in the same block that copies the lane as the first
#: steal's spawn left it
EDGE_GRAINS = [
    dict(slot=0, offset=10, duration=800.0, src_pos=50.0, step=1.3, shape=2.0, vel=0.9),
    dict(slot=1, offset=200, duration=600.0, src_pos=3900.0, step=2.0, shape=1.0, vel=0.8),
    dict(slot=2, offset=0, duration=900.0, src_pos=300.0, step=-0.7, shape=4.0, vel=0.6),
    dict(slot=tgran.MAX_GRAINS + 3, offset=350, rel_total=120.0, copy_from=0),
    dict(slot=0, offset=350, duration=500.0, src_pos=1000.0, step=-8.0, shape=0.5, vel=1.0),
    dict(slot=tgran.MAX_GRAINS + 4, offset=400, rel_total=60.0, copy_from=0),
]


def _events(entries):
    ev = tgran.SpawnEvents.empty()._asdict()
    for k, e in enumerate(entries):
        for name, v in e.items():
            ev[name][k] = v
    return tgran.SpawnEvents(**ev)


def _jax_events(ev):
    return jgran.SpawnEvents(*(jnp.asarray(a) for a in ev))


def _leaf_errors(jst, tst):
    """Per leaf: exact equality for integer leaves, else the worst error
    relative to the magnitude where it exceeds 1."""
    out = []
    jl = jax.tree_util.tree_leaves(jst)
    tl = jax.tree_util.tree_leaves(interop.to_numpy(tst))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
        if np.issubdtype(a.dtype, np.integer):
            out.append(0.0 if np.array_equal(a, b) else np.inf)
        else:
            d = np.abs(a.astype(np.float64) - b) / np.maximum(1.0, np.abs(a))
            out.append(float(d.max()) if d.size else 0.0)
    return out


@pytest.mark.parametrize("grains", ["oracle", "edge"])
@pytest.mark.parametrize("drive", [0.0, 0.6])
def test_render_block_matches_jax(grains, drive):
    """3 blocks: output within 1e-5 with the drive off and 1e-4 with it on
    (the JAX package's 4x chain runs associative scans, the port's steps;
    the makeup gain tanh(.5)/tanh(2) may differ by an ulp); the state leaf
    by leaf, integers exact, floats within 4e-4 (relative above 1)."""
    rs = np.random.RandomState(7)
    buf = (rs.standard_normal(4096) * 0.4).astype(np.float32)
    cfg = jgran.GranulatorConfig(drive=drive, volume=0.8)
    jst = jgran.init_state(buf, SR, cfg)
    tst = interop.granulator_state_from_numpy(jst, "cpu")
    # the drive and volume smoothers moving
    tgt = np.asarray(jst.params.target).copy()
    tgt[jgran.PARAM_INDEX["volume"]] = 0.5
    jst = jst._replace(params=jst.params._replace(target=jnp.asarray(tgt)))
    tst = tst._replace(params=tst.params._replace(target=torch.from_numpy(tgt)))
    blocks = [_events(ORACLE_GRAINS if grains == "oracle" else EDGE_GRAINS),
              tgran.SpawnEvents.empty(), _events([dict(slot=5, offset=100, duration=300.0,
                                                       src_pos=3000.0, step=1.5, shape=2.5,
                                                       vel=0.5)])]
    tol = 1e-5 if drive == 0.0 else 1e-4
    for i, ev in enumerate(blocks):
        jst, jy = _jax_render(jst, _jax_events(ev), np.int32(i * B))
        tst, ty = tgran.render_block(tst, ev, i * B, sample_rate=SR, block_size=B,
                                     smooth_coeff=COEFF)
        jy = np.asarray(jy)
        assert ty.shape == (B,)
        assert np.abs(ty.numpy() - jy).max() <= tol, i
        assert max(_leaf_errors(jst, tst)) <= 4e-4, i
    assert np.abs(jy).max() > 1e-3


def test_the_drive_state_advances_at_drive_zero():
    """The 4x chain runs every block (granulator.py:308): at drive 0 its
    state still moves, as in the JAX package."""
    rs = np.random.RandomState(8)
    buf = (rs.standard_normal(2048) * 0.4).astype(np.float32)
    st = tgran.init_state(buf, SR, tgran.GranulatorConfig(drive=0.0), device="cpu")
    st2, y = tgran.render_block(st, _events(ORACLE_GRAINS[:1]), 0, sample_rate=SR,
                                block_size=B, smooth_coeff=COEFF)
    assert float(y.abs().max()) > 1e-3
    assert float(st2.ovs.down1.ap0.abs().max()) > 0.0
    # the input state is left as it was
    assert int(st.spawn_sample[0]) == -(2**30)


@pytest.mark.parametrize("seed", [7, 0x12345678])
def test_host_events_match_jax_bit_for_bit(seed):
    """40 blocks of 1,024 samples of a dense seeded cloud (80 grains/s of
    3 s each, so the 64 main lanes fill and grains are stolen into the
    release pool) with timing jitter, spray, random amplitude and a
    mid-cloud pitch and direction change: the same events, bit for bit."""
    rs = np.random.RandomState(9)
    buf = rs.uniform(-0.5, 0.5, 4 * 44100).astype(np.float32)
    kw = dict(density=1.0, random_timing=0.7, random_amp=0.5, spray=0.4, grain_length=1.0,
              cloud_duration=0.9)
    bh = 2 * B
    jh = jgran.GranulatorHost(SR, buf, 48000.0, jgran.GranulatorConfig(**kw), seed=seed)
    th = tgran.GranulatorHost(SR, buf, 48000.0, tgran.GranulatorConfig(**kw), seed=seed)
    steals = 0
    for h in (jh, th):
        h.trigger(0.01, 0.9)
    for blk in range(40):
        if blk == 20:
            for h in (jh, th):
                h.set_param("pitch", 1.0)
                h.set_param("direction", 0.8)
        want = jh.collect_events(blk * bh, bh, device=False)
        got = th.collect_events(blk * bh, bh)
        for f in tgran.SpawnEvents._fields:
            a, b = np.asarray(getattr(want, f)), getattr(got, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (blk, f)
        steals += int((np.asarray(got.copy_from) >= 0).sum())
        assert th.active_grain_count(blk * bh) == jh.active_grain_count(blk * bh)
    assert steals > 0
    assert th.rng.state == int(jh.rng.state)


def test_xorshift32_draws_match_jax():
    from libgooey_tpu.core.rng import XorShift32 as JX

    from libgooey_tpu_torch.core.rng import XorShift32 as TX

    for seed in (0, 1, 0x12345678, 0xFFFFFFFF):
        a, b = JX(seed), TX(seed)
        assert [a.next_u32() for _ in range(500)] == [b.next_u32() for _ in range(500)]
        assert [a.next_f32() for _ in range(500)] == [b.next_f32() for _ in range(500)]


def test_state_round_trips_through_numpy():
    rs = np.random.RandomState(10)
    st = tgran.init_state(rs.uniform(-1, 1, 256).astype(np.float32), 48000.0, device="cpu")
    st = st._replace(src_pos=torch.linspace(0.0, 200.0, tgran.TOTAL))
    back = interop.granulator_state_from_numpy(interop.to_numpy(st), "cpu")
    for a, b in zip(torch.utils._pytree.tree_leaves(st), torch.utils._pytree.tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
