"""The bus kernels' plain versions against the JAX package's Pallas wrappers.

The nine wrappers of ``libgooey_tpu_torch/ops/bus_kernels.py`` and
``plate_block`` (``ops/plate_kernels.py``) run their plain PyTorch versions
on the CPU; each is compared with its Pallas wrapper in
``libgooey_tpu/ops/pallas_fx.py`` run in interpret mode (as tests/
test_pallas_fx.py runs it on the CPU), on the same numpy inputs at the bus's
shape ``[2, B]``.  The Pallas bodies solve the linear recurrences with
log-depth scans and the plain versions step them sample by sample, so the two
agree at float-noise level.

Bounds: output <= 2e-5, every state leaf <= 1e-4.  Measured with these
inputs on the CPU: saturation 4.8e-7 output / 6.4e-7 state, lowpass 1.5e-7 /
6e-8, tilt 2.4e-7 / 1.6e-7, delay 6e-8 (output and write) / 4.5e-8, both
ping-pong settings (the lowpass and the delay at B = 256, 100 and 33, two
blocks each); env follower 2.4e-7 / 2.4e-7, compressor 3.1e-7 / 3.2e-8,
spring 6e-8 / 1.2e-7 (history), plate 8.9e-8 (branch outputs and damping
filters) / 1.2e-7 (histories); waveshaper 5.1e-7 / 7.2e-7, feedback
waveshaper 7.2e-7 / 2.3e-5 (B = 256, 100 and 33).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libgooey_tpu.ops import oversample as jovs
from libgooey_tpu.ops import pallas_fx

from libgooey_tpu.effects import reverb_plate as jplate
from libgooey_tpu.effects import reverb_spring as jspring

from libgooey_tpu_torch.core.smoother import smoothing_coeff
from libgooey_tpu_torch.ops import bank_kernels as bk
from libgooey_tpu_torch.ops import bus_kernels as bus
from libgooey_tpu_torch.ops import plate_kernels
from libgooey_tpu_torch.ops.filters import DCBlockState
from libgooey_tpu_torch.ops.oversample import OversamplerState

from test_torch_slice import _max_state_err

SR = 44100.0
B = 256   # the other kernels' block; the saturation, the detector, the compressor and
#           the spring also at 100
OUT_TOL = 2e-5
STATE_TOL = 1e-4
COEFF = smoothing_coeff(SR, 30.0)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _gate_mix(fall_at, rise_at):
    """Mix smoother values whose trajectory ``tgt + snap((cur - tgt) *
    q^(n+1))`` falls under the bypass gate (1e-4) at sample ``fall_at``
    (from the first value to 0) and rises out of it at ``rise_at`` (from 0
    to the second)."""
    logq = np.log(1.0 - COEFF)
    return (1e-4 * np.exp(-logq * (fall_at + 0.5)),
            1e-4 / (1.0 - np.exp(logq * (rise_at + 0.5))))


def _inside_chunks(flags):
    """The samples where a [2, B] bool row flips, per channel; each must lie
    inside a 32-sample chunk of the kernels (not at its first sample)."""
    flips = [np.flatnonzero(np.diff(np.asarray(f, np.int8))) + 1 for f in flags]
    assert all(len(f) and (f % 32 != 0).all() for f in flips), flips
    return flips


@pytest.mark.parametrize("B", [256, 100])
def test_saturation_block_matches_pallas(B):
    """Two blocks from a zero state, each side carrying its own state, drive
    and warmth moving: in the first the left mix falls under the bypass
    gate and the right one rises out of it, in the second the other way
    round, each inside a 32-sample chunk, so the DC blocker's gating and
    held state are exercised; the unpacked state is compared leaf by
    leaf."""
    rs = np.random.RandomState(3)
    x = rs.uniform(-0.9, 0.9, (2, 2 * B)).astype(np.float32)
    fall0, rise0 = _gate_mix(77, 39)
    fall1, rise1 = _gate_mix(71, 45)
    blocks = [([[0.6, 0.5, fall0], [0.3, 0.2, 0.0]], [[0.2, 0.9, 0.0], [0.7, 0.6, rise0]]),
              ([[0.2, 0.9, 0.0], [0.7, 0.6, fall1]], [[0.6, 0.5, rise1], [0.1, 0.3, 0.0]])]
    j_ovs = jovs.OversamplerState.init((2,))
    j_dc = (jnp.zeros(2, jnp.float32), jnp.zeros(2, jnp.float32))
    t_ovs = OversamplerState.init(2, "cpu")
    t_dc = DCBlockState.init((2,), "cpu")
    for i, (cur, tgt) in enumerate(blocks):
        cur2 = np.asarray(cur, np.float32)
        tgt2 = np.asarray(tgt, np.float32)
        mix = bus._trajectories(_t(cur2), _t(tgt2), COEFF, B)[2]
        want = [[77], [39]] if i == 0 else [[45], [71]]
        assert [list(f) for f in _inside_chunks(mix < 1e-4)] == want
        xb = x[:, i * B:(i + 1) * B]
        jout, jnst = pallas_fx.saturation_block(
            jnp.asarray(xb), cur2, tgt2, pallas_fx.pack_ovs4_dc(j_ovs, *j_dc), coeff=COEFF)
        j_ovs, jdx, jdy, jsm = pallas_fx.unpack_ovs4_dc(jnst, j_ovs)
        j_dc = (jdx, jdy)
        tout, tnst = bus.saturation_block_plain(_t(xb), _t(cur2), _t(tgt2),
                                                bus.pack_saturation(t_ovs, t_dc), coeff=COEFF)
        t_ovs, tdx, tdy, tsm = bus.unpack_saturation(tnst, t_ovs)
        t_dc = DCBlockState(x1=tdx, y1=tdy)
        assert np.abs(np.asarray(jout)).max() > 0.1
        assert _err(jout, tout) <= OUT_TOL
        worst, where = _max_state_err(
            {"ovs": j_ovs, "dc": j_dc, "sm": jsm},
            {"ovs": t_ovs, "dc": (t_dc.x1, t_dc.y1), "sm": tsm})
        assert worst <= STATE_TOL, f"block {i}: {worst} at {where}"


@pytest.mark.parametrize("B", [256, 100, 33])
def test_lowpass_block_matches_pallas(B):
    """Two blocks from a carried state, over a loud input that falls silent
    after a burst in the second: feedback up to 3.3 (resonance above 1, the
    min(fb, 1) clip engaged) on the left, g up to the effect's 0.9 clip; the
    right channel at feedback 0 and g 0.9 in the silence, so that both
    stages flush under 1e-15."""
    rs = np.random.RandomState(15)
    st_j = np.asarray([[0.1, -0.2], [0.05, 0.3]], np.float32)
    st_t = _t(st_j)
    quiet = B // 3
    for i in range(2):
        x = rs.uniform(-0.9, 0.9, (2, B)).astype(np.float32)
        g = rs.uniform(0.2, 0.9, (2, B)).astype(np.float32)
        fb = rs.uniform(0.0, 3.3, (2, B)).astype(np.float32)
        if i == 1:
            x[:, quiet:] = 0.0
            g[1, quiet:], fb[1, quiet:] = 0.9, 0.0
        jout, st_j = pallas_fx.lowpass_block(jnp.asarray(x), g, fb, st_j)
        tout, st_t = bus.lowpass_block_plain(_t(x), _t(g), _t(fb), st_t)
        assert np.abs(np.asarray(jout)).max() > 0.5
        assert _err(jout, tout) <= OUT_TOL, i
        assert _err(st_j, st_t) <= STATE_TOL, i
    assert (tout[1, -3:] == 0.0).all() and (st_t[1] == 0.0).all()


def _through_center(tgt, n):
    """A knob current whose trajectory towards ``tgt`` crosses the center
    (0.5) between samples ``n - 1`` and ``n``."""
    return float(tgt + (0.5 - tgt) * np.exp(-np.log(1.0 - COEFF) * (n + 0.5)))


@pytest.mark.parametrize("cur,tgt,n,at", [
    pytest.param((0.25, 0.3), (0.75, 0.6), B, None, id="cur0-tgt0"),
    pytest.param((0.7, 0.9), (0.3, 0.5), B, None, id="cur1-tgt1"),
    pytest.param((0.5, 0.0), (0.5, 0.0), B, None, id="cur2-tgt2"),
    pytest.param((0.25, 0.3), (0.75, 0.6), 100, None, id="B100"),
    pytest.param((0.7, 0.9), (0.3, 0.5), 33, None, id="B33"),
    pytest.param((_through_center(0.9, B // 2 + 7), 1.0), (0.9, 1.0), B, B // 2 + 7,
                 id="through-center-res1"),
])
def test_tilt_block_matches_pallas(cur, tgt, n, at):
    """Sweeps across the center in both directions at resonance up to Q 7.7,
    and the passthrough knob, at B = 256, 100 and 33; the knob rising
    through the center mid-block (the low-pass handing over to the
    high-pass inside a short passthrough span) at resonance 1 (Q 8.5)."""
    rs = np.random.RandomState(11)
    x = rs.uniform(-0.8, 0.8, (2, n)).astype(np.float32)
    cur2, tgt2 = np.asarray([cur, cur], np.float32), np.asarray([tgt, tgt], np.float32)
    ic = np.asarray([[0.02, -0.05], [-0.01, 0.04]], np.float32)
    st = np.concatenate([ic, np.zeros((2, 2), np.float32)], axis=-1)
    jout, jnst = pallas_fx.tilt_block(jnp.asarray(x), cur2, tgt2, st, coeff=COEFF, sample_rate=SR)
    tout, tnst = bus.tilt_block_plain(_t(x), _t(cur2), _t(tgt2), _t(ic), coeff=COEFF,
                                      sample_rate=SR)
    assert _err(jout, tout) <= OUT_TOL
    assert _err(jnst, tnst) <= STATE_TOL
    if at is not None:   # the knob crosses the center at sample ``at``
        knob = bus._trajectories(_t(cur2), _t(tgt2), COEFF, n)[0][0].numpy()
        assert knob[at - 1] < 0.5 <= knob[at]


def _settling(tgt, cur, at):
    """Smoother currents (float32) off their targets ``tgt`` by the
    distance whose trajectory ``tgt + snap((cur - tgt) * q^(n+1))`` snaps
    to the target (1e-4) at sample ``at``, on the side of ``cur``, or
    ``cur`` where ``at`` is None (still moving at the block's end)."""
    tgt = np.asarray(tgt, np.float32)
    d = 1e-4 * np.exp(-np.log(1.0 - COEFF) * (np.asarray(at, np.float64) + 0.5))
    out = tgt + np.where(np.asarray(cur) > tgt, d, -d)
    return np.where(np.isnan(np.asarray(at, np.float64)), cur, out).astype(np.float32)


@pytest.mark.parametrize("B", [256, 100, 33])
@pytest.mark.parametrize("pingpong", [False, True])
def test_delay_block_matches_pallas(pingpong, B):
    """A pre-gathered tap, two blocks with carried filter and smoother
    state: in the first, feedback and mix settle (the 1e-4 snap) inside the
    block, each channel at its own sample, while the cutoff sweeps; in the
    second the cutoff turns and sweeps down."""
    rs = np.random.RandomState(13)
    tgt = np.asarray([[0.3, 0.5, 12000.0], [0.3, 0.5, 12000.0]], np.float32)
    nan = float("nan")
    at = [[B // 2 + 3, B // 3, nan], [B // 4 + 1, 2 * B // 3, nan]]
    cur_j = _settling(tgt, [[0.6, 0.8, 4000.0], [0.1, 0.2, 3000.0]], at)
    fb_t, mix_t, _ = bus._trajectories(_t(cur_j), _t(tgt), COEFF, B)
    for row, (fa, ma) in zip(range(2), ((at[0][0], at[0][1]), (at[1][0], at[1][1]))):
        assert int(np.argmax(fb_t[row].numpy() == tgt[row, 0])) == fa
        assert int(np.argmax(mix_t[row].numpy() == tgt[row, 1])) == ma
    z = np.asarray([[0.1, 0.05], [-0.2, -0.1]], np.float32)
    st_j = np.concatenate([z, np.zeros((2, 3), np.float32)], axis=-1)
    cur_t, z_t = _t(cur_j), _t(z)
    for i in range(2):
        x = rs.uniform(-0.8, 0.8, (2, B)).astype(np.float32)
        delayed = rs.uniform(-0.5, 0.5, (2, B)).astype(np.float32)
        jout, jwrite, jnst = pallas_fx.delay_block(
            jnp.asarray(x), delayed, cur_j, tgt, st_j, coeff=COEFF, sample_rate=SR,
            pingpong=pingpong)
        tout, twrite, tnst = bus.delay_block_plain(
            _t(x), _t(delayed), cur_t, _t(tgt), z_t, coeff=COEFF, sample_rate=SR,
            pingpong=pingpong)
        assert _err(jout, tout) <= OUT_TOL, i
        assert _err(jwrite, twrite) <= OUT_TOL, i
        assert _err(jnst, tnst) <= STATE_TOL, i
        st_j, cur_j = np.asarray(jnst), np.asarray(jnst)[:, 2:]
        z_t, cur_t = tnst[:, :2].contiguous(), tnst[:, 2:].contiguous()
        tgt = tgt.copy()
        tgt[:, 2] = 2000.0


def _bursts(rs, n, level=1.5):
    """Loud bursts on silence: the detector's attack and release both run."""
    return (rs.uniform(-1.0, 1.0, (2, n)) *
            (np.sin(np.arange(n) * 2 * np.pi / 97.0) > 0.3) * level).astype(np.float32)


def _coef(ms):
    return np.float32(np.exp(-1.0 / (ms * 0.001 * SR)))


@pytest.mark.parametrize("B,span", [(256, (100, 160)), (100, (37, 77))])
def test_env_follower_block_matches_pallas(B, span):
    """Bursts with a 1 ms attack and an 80 ms release from a carried
    envelope, and a bypass span that must hold it; the span starts and ends
    inside the lone kernel's 64-sample chunks (across a chunk's end)."""
    lo, hi = span
    assert lo % 64 and hi % 64 and lo // 64 < hi // 64
    rs = np.random.RandomState(21)
    x = _bursts(rs, B)
    att, rel = np.full((2, B), _coef(1.0)), np.full((2, B), _coef(80.0))
    byp = np.zeros((2, B), np.float32)
    byp[:, lo:hi] = 1.0
    env0 = np.asarray([0.3, 0.0], np.float32)
    jenv, jlast = pallas_fx.env_follower_block(np.abs(x), att, rel, byp, env0)
    tenv, tlast = bus.env_follower_block_plain(_t(x), _t(att), _t(rel), _t(byp), _t(env0))
    assert np.abs(np.asarray(jenv)).max() > 0.5
    assert np.array_equal(tenv[:, lo:hi].numpy(), tenv[:, lo - 1:lo].expand(2, hi - lo).numpy())
    assert _err(jenv, tenv) <= OUT_TOL
    assert _err(jlast, tlast) <= STATE_TOL


def _gain_below(env, thr, ratio, mix, g0):
    """Where the compressor's smoothed gain first falls under 0.99, per
    channel (its knee and smoother in float64)."""
    over = 20.0 / np.log(10.0) * np.log(env.astype(np.float64) + 1e-20) - thr
    slope = 1.0 - 1.0 / ratio
    gr = np.where(over <= -3.0, 0.0,
                  np.where(over >= 3.0, over * slope, (over + 3.0) ** 2 / 12.0 * slope))
    target = np.exp(-0.05 * np.log(10.0) * gr)
    g, first = np.asarray(g0, np.float64), [None, None]
    for n in range(env.shape[1]):
        g = np.where(mix[:, n] < 1e-4, g, 0.95 * g + 0.05 * target[:, n])
        first = [f if f is not None or g[c] >= 0.99 else n for c, f in enumerate(first)]
    return first


@pytest.mark.parametrize("B", [256, 100])
def test_compressor_block_matches_pallas(B):
    """Two blocks from a zero state on a loud envelope: the knee engaged and
    the smoothed gain crossing 0.99 inside a 32-sample chunk (the tube
    colour switching in), then a block whose left mix falls under the
    bypass gate and whose right one leaves it again, each inside a chunk;
    the packed state (pack_ovs4_dc there, pack_compressor here) compared
    leaf by leaf."""
    rs = np.random.RandomState(5)
    x = _bursts(rs, 2 * B)
    env, _ = bus.env_follower_block_plain(
        _t(x), _t(np.full((2, 2 * B), _coef(1.0))), _t(np.full((2, 2 * B), _coef(30.0))),
        _t(np.zeros((2, 2 * B))), _t(np.zeros(2)))
    env = env.numpy()
    thr = np.full((2, 2 * B), -30.0, np.float32)
    ratio = np.full((2, 2 * B), 8.0, np.float32)
    mix = np.ones((2, 2 * B), np.float32)
    mix[0, B + 71:] = 0.0
    mix[1, B + 7:B + 45] = 0.0
    assert [list(f) for f in _inside_chunks(mix[:, B:] < 1e-4)] == [[71], [7, 45]]
    first = _gain_below(env[:, :B], thr[:, :B], ratio[:, :B], mix[:, :B], np.ones(2))
    assert all(f is not None and f % 32 != 0 for f in first), first
    j_ovs, j_dc, j_gain = jovs.OversamplerState.init((2,)), (np.zeros(2, np.float32),) * 2, \
        np.ones(2, np.float32)
    t_ovs, t_dc, t_gain = OversamplerState.init(2, "cpu"), DCBlockState.init((2,), "cpu"), \
        torch.ones(2)
    for i in range(2):
        sl = slice(i * B, (i + 1) * B)
        jout, jnst = pallas_fx.compressor_block(
            jnp.asarray(x[:, sl]), env[:, sl], thr[:, sl], ratio[:, sl], mix[:, sl],
            pallas_fx.pack_ovs4_dc(j_ovs, *j_dc), j_gain)
        j_ovs, jdx, jdy, _ = pallas_fx.unpack_ovs4_dc(jnst, j_ovs)
        j_dc, j_gain = (jdx, jdy), np.asarray(jnst)[0:2, pallas_fx._OUT_IDX["gain"]]
        tout, tnst = bus.compressor_block_plain(
            _t(x[:, sl]), _t(env[:, sl]), _t(thr[:, sl]), _t(ratio[:, sl]), _t(mix[:, sl]),
            bus.pack_compressor(t_ovs, t_dc, t_gain))
        t_ovs, tdx, tdy, t_gain = bus.unpack_compressor(tnst, t_ovs)
        t_dc = DCBlockState(x1=tdx, y1=tdy)
        assert _err(jout, tout) <= OUT_TOL, i
        worst, where = _max_state_err({"ovs": j_ovs, "dc": j_dc, "gain": j_gain},
                                      {"ovs": t_ovs, "dc": (t_dc.x1, t_dc.y1), "gain": t_gain})
        assert worst <= STATE_TOL, f"block {i}: {worst} at {where}"
    assert bool((t_gain < 0.99).all())


@pytest.mark.parametrize("B", [256, 100, 33])
def test_waveshaper_block_matches_pallas(B):
    """Two blocks from a zero state, each side carrying its own state, drive
    and mix block scalars per channel: the left channel engaged, then
    bypassed by its mix at 0; the right one bypassed by its drive at 0.8
    (<= 1), then engaged at drive 6.  Both sides step the chain through a
    bypassed block (the caller holds the state); the state is compared
    leaf by leaf."""
    rs = np.random.RandomState(9)
    x = rs.uniform(-1.2, 1.2, (2, 2 * B)).astype(np.float32)
    blocks = [((4.0, 0.8), (0.5, 0.7)), ((4.0, 6.0), (0.0, 0.8))]
    j_ovs, t_ovs = jovs.OversamplerState.init((2,)), OversamplerState.init(2, "cpu")
    zeros = jnp.zeros(2, jnp.float32)
    for i, (drive, mix) in enumerate(blocks):
        xb = x[:, i * B:(i + 1) * B]
        drive, mix = np.asarray(drive, np.float32), np.asarray(mix, np.float32)
        jout, jnst = pallas_fx.waveshaper_block(
            jnp.asarray(xb), drive, mix, pallas_fx.pack_ovs4_dc(j_ovs, zeros, zeros))
        j_ovs = pallas_fx.unpack_ovs4_dc(jnst, j_ovs)[0]
        tout, tnst = bus.waveshaper_block_plain(_t(xb), _t(np.stack([drive, mix], -1)),
                                                bk.pack_ws4_bank(t_ovs))
        t_ovs = bk.unpack_ws4_bank(tnst, t_ovs)
        jout = np.asarray(jout)
        bypassed = (mix <= 1e-4) | (drive <= 1.0)
        assert np.array_equal(jout[bypassed], xb[bypassed])
        assert np.abs(jout[~bypassed] - xb[~bypassed]).max() > 0.1
        assert _err(jout, tout) <= OUT_TOL, i
        worst, where = _max_state_err({"ovs": j_ovs}, {"ovs": t_ovs})
        assert worst <= STATE_TOL, f"block {i}: {worst} at {where}"


@pytest.mark.parametrize("B", [256, 100, 33])
def test_fbws_fast_block_matches_pallas(B):
    """Two blocks of loud bursts from a carried feedback filter on an
    envelope that dips under the makeup gain's 0.05 floor inside 32-sample
    chunks: the left channel bypassed by its drive at 1.0 with a filter of
    1e-16 (flushed to 0), then engaged at drive 150 (the drive_norm clip);
    the right one engaged at drive 8 with feedback 0.5 (the makeup's high
    end), then bypassed by its mix at 0 (its DC blocker and filter held).
    The DC blocker, the filter and the 4x state compared leaf by leaf."""
    rs = np.random.RandomState(7)
    x = _bursts(rs, 2 * B)
    n = np.arange(2 * B)
    env = np.stack([0.3 + 0.3 * np.sin(2.0 * np.pi * n / 37.0),
                    0.3 + 0.3 * np.sin(2.0 * np.pi * n / 29.0 + 1.0)]).astype(np.float32)
    assert all((np.flatnonzero(e[:B] < 0.05) % 32 != 0).any() for e in env)
    fbc = [np.float32(1.0 - np.exp(-2.0 * np.pi * f / SR)) for f in (2000.0, 500.0)]
    blocks = [[[1.0, 0.0, fbc[0], 1.0], [8.0, 0.5, fbc[1], 0.7]],
              [[150.0, 0.0, fbc[0], 0.6], [8.0, 0.5, fbc[1], 0.0]]]
    filt0 = np.asarray([1e-16, 0.01], np.float32)
    j_ovs, j_dc, j_filt = jovs.OversamplerState.init((2,)), (np.zeros(2, np.float32),) * 2, filt0
    t_ovs, t_dc, t_filt = OversamplerState.init(2, "cpu"), (torch.zeros(2),) * 2, _t(filt0)
    for i, prm in enumerate(blocks):
        sl = slice(i * B, (i + 1) * B)
        prm = np.asarray(prm, np.float32)
        jout, jnst = pallas_fx.fbws_fast_block(
            jnp.asarray(x[:, sl]), env[:, sl], *prm.T, pallas_fx.pack_ovs4_dc(j_ovs, *j_dc),
            j_filt)
        j_ovs, jdx, jdy, _ = pallas_fx.unpack_ovs4_dc(jnst, j_ovs)
        j_dc, j_filt = (jdx, jdy), np.asarray(jnst)[0:2, pallas_fx._OUT_IDX["gain"]]
        state = SimpleNamespace(ovs=t_ovs, dc_x1=t_dc[0], dc_y1=t_dc[1], filter_state=t_filt)
        tout, tnst = bus.fbws_fast_block_plain(_t(x[:, sl]), _t(env[:, sl]), _t(prm),
                                               bus.pack_fbws_fast(state))
        t_ovs, tdx, tdy, t_filt = bus.unpack_fbws_fast(tnst, t_ovs)
        t_dc = (tdx, tdy)
        assert np.abs(np.asarray(jout)).max() > 0.1
        assert _err(jout, tout) <= OUT_TOL, i
        worst, where = _max_state_err({"ovs": j_ovs, "dc": j_dc, "filt": j_filt},
                                      {"ovs": t_ovs, "dc": t_dc, "filt": t_filt})
        assert worst <= STATE_TOL, f"block {i}: {worst} at {where}"
        if i == 0:   # the bypassed left channel's 1e-16 flushed on both sides
            assert j_filt[0] == 0.0 and float(t_filt[0]) == 0.0
            assert abs(float(t_filt[1])) > 1e-3


def _spring_rows(rs, n, decay=(0.3, 0.9), damping=(0.6, 0.2)):
    """The damping loop's rows for decay and damping moving across the
    block (reverb_spring.py:128-147, in numpy float32)."""
    decay_t = np.linspace(*decay, n, dtype=np.float32)[None].repeat(2, 0)
    damping_t = np.linspace(*damping, n, dtype=np.float32)[None].repeat(2, 0)
    fb_gain = (np.power(decay_t, np.float32(0.4)) * np.float32(0.95)).astype(np.float32)
    alpha = np.float32(np.prod(jspring.GAINS))
    p2 = (np.float32(1.0) - damping_t).astype(np.float32)
    fbgp = np.concatenate([np.zeros((2, 1), np.float32), fb_gain[:, :-1]], axis=-1)
    A = (damping_t + p2 * alpha * fbgp).astype(np.float32)
    A[:, 0] = damping_t[:, 0]
    return A, p2, fbgp


@pytest.mark.parametrize("B,sr", [(256, SR), (100, SR), (256, 96000.0)])
def test_spring_block_matches_pallas(B, sr):
    """A filled history and a carried damping state, decay and damping
    moving; the port's kernel with mix 1 and no feedback carry gives the TPU
    kernel's wet signal.  At 100 samples the lone kernel's last part is
    shorter than the shortest lag (127); at 96,000 Hz the lags more than
    double (the shortest 276, past the kernel's 128-sample parts; the
    history 1,734)."""
    rs = np.random.RandomState(7)
    dl, dr = jspring.delay_lengths(sr)
    D = max(dl + dr)
    assert B % min(dl + dr) or sr != SR
    hist = (0.3 * rs.randn(12, D)).astype(np.float32)
    damp = np.asarray([0.05, -0.02], np.float32)
    x = rs.uniform(-0.8, 0.8, (2, B)).astype(np.float32)
    A, p2, fbgp = _spring_rows(rs, B)
    jwet, jhist, jlast = pallas_fx.spring_block(
        jnp.asarray(x), A, p2, fbgp, hist, damp, delays=dl + dr, gains=jspring.GAINS,
        chunk=jspring.chunk_size(sr, B))
    twet, thist, tlast = bus.spring_block_plain(
        _t(x), _t(A), _t(p2), _t(fbgp), _t(hist), _t(damp), _t(np.ones((2, B))), _t(np.zeros(2)),
        delays=dl + dr, gains=jspring.GAINS)
    assert np.abs(np.asarray(jwet)).max() > 0.1
    assert _err(jwet, twet) <= OUT_TOL
    assert _err(jhist, thist) <= STATE_TOL
    assert _err(jlast, tlast) <= STATE_TOL


def _plate_inputs(rs, n, sr=SR):
    """The plate kernel's inputs at ``sr`` with the size knob moving 1.0 ->
    0.0 in the block (the modulated lags sweep ~1,200 samples at 44.1 kHz),
    filled histories and seeds."""
    srs = sr / jplate.DATTORRO_SR
    DIN, DMOD = jplate.in_hist_len(sr), jplate.mod_hist_len(sr)
    q = np.float32(1.0 - smoothing_coeff(sr))
    size = (np.float32(0.0) + np.float32(1.0) * q ** np.arange(1, n + 1, dtype=np.float32))
    scale = np.asarray(jplate.size_to_scale(jnp.asarray(size.astype(np.float32))))
    ph = np.arange(1, n + 1) * np.array([[0.5], [0.71]]) / sr + np.array([[0.2], [0.7]])
    mod_off = np.clip(np.array([[672.0], [908.0]]) * srs * scale[None]
                      + np.sin(2 * np.pi * ph) * 16.0 * srs, 1.0, DMOD - 2.0).astype(np.float32)
    rows = [rs.uniform(-0.5, 0.5, n).astype(np.float32) for _ in range(6)]
    rows[3] = np.linspace(0.1, 0.6, n, dtype=np.float32) * np.float32(0.95)   # damping
    return (rows, mod_off, (0.2 * rs.randn(4, DIN)).astype(np.float32),
            (0.2 * rs.randn(2, DMOD)).astype(np.float32),
            np.asarray([0.1, -0.05, 0.02], np.float32))


def test_plate_block_matches_pallas():
    """The sub-block recurrences, the TPU kernel given its one-hot window
    bases (reverb_plate.py:344-350), the port's without them: the bases only
    place the TPU gather's window, so the results agree."""
    rs = np.random.RandomState(19)
    rows, mod_off, in_hist, mod_hist, seeds = _plate_inputs(rs, B)
    C = min(jplate.chunk_size(SR, B), jplate.KERNEL_CHUNK)
    DMOD = mod_hist.shape[1]
    col_b = DMOD + np.arange(B)[None, :] - np.floor(mod_off).astype(np.int32) - 1
    wbase = col_b.reshape(2, B // C, C).min(axis=-1).astype(np.int32)
    want = pallas_fx.plate_block(*rows, mod_off, wbase, in_hist, mod_hist, seeds, chunk=C,
                                 sample_rate=SR)
    got = plate_kernels.plate_block_plain(*map(_t, rows), _t(mod_off), _t(in_hist),
                                          _t(mod_hist), _t(seeds), sample_rate=SR)
    assert np.abs(np.asarray(want[0])).max() > 0.05
    for i, (w, g) in enumerate(zip(want, got)):
        assert _err(w, g) <= (OUT_TOL if i < 4 else STATE_TOL), i


@pytest.mark.parametrize("sr,n,C", [(SR, 100, 100), (22050.0, 256, 64)],
                         ids=["B100", "22050Hz"])
def test_plate_block_tails_match_pallas(sr, n, C):
    """The plain version against the Pallas body at a block that is not a
    power of two (one TPU chunk of 100, within the shortest diffusion lag of
    158) and at 22,050 Hz (chunks of 64, within its shortest lag of 79)."""
    rs = np.random.RandomState(23)
    rows, mod_off, in_hist, mod_hist, seeds = _plate_inputs(rs, n, sr)
    DMOD = mod_hist.shape[1]
    col_b = DMOD + np.arange(n)[None, :] - np.floor(mod_off).astype(np.int32) - 1
    wbase = col_b.reshape(2, n // C, C).min(axis=-1).astype(np.int32)
    want = pallas_fx.plate_block(*rows, mod_off, wbase, in_hist, mod_hist, seeds, chunk=C,
                                 sample_rate=sr)
    got = plate_kernels.plate_block_plain(*map(_t, rows), _t(mod_off), _t(in_hist),
                                          _t(mod_hist), _t(seeds), sample_rate=sr)
    assert np.abs(np.asarray(want[0])).max() > 0.05
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.shape == w.shape
        assert _err(w, g) <= (OUT_TOL if i < 4 else STATE_TOL), i


@pytest.mark.parametrize("sr,C", [(44100.0, 158), (22050.0, 79)])
def test_plate_chunk_is_within_the_shortest_diffusion_lag(monkeypatch, sr, C):
    """The kernel's chunk is the smallest whole diffusion lag (capped at 256),
    so no sample of a chunk reads a diffusion column the chunk writes; the
    wrapper passes it after DIN, DMOD and B."""
    from libgooey_tpu_torch.effects import reverb_plate

    lags = plate_kernels.plate_constants(sr)[1]
    assert plate_kernels.plate_chunk(sr) == C == min(lags) <= plate_kernels.MAX_CHUNK
    assert plate_kernels.plate_chunk(192000.0) == plate_kernels.MAX_CHUNK < min(
        plate_kernels.plate_constants(192000.0)[1])
    calls = []
    monkeypatch.setattr(plate_kernels, "_on_cuda", lambda name, t: True)
    monkeypatch.setattr(plate_kernels, "_launch", lambda *a: calls.append(a))
    DIN, DMOD = reverb_plate.in_hist_len(sr), reverb_plate.mod_hist_len(sr)
    x = torch.zeros(256)
    launches = plate_kernels.plate_block.launches
    plate_kernels.plate_block(x, x, x, x, x, x, torch.ones(2, 256), torch.zeros(4, DIN),
                              torch.zeros(2, DMOD), torch.zeros(3), sample_rate=sr)
    plate_kernels.plate_block.launches = launches
    (call,) = calls
    assert call[2] == "plate_block_launch" and call[-4:] == (DIN, DMOD, 256, C)


def test_plate_block_refuses_a_shape_past_shared_memory(monkeypatch):
    """A block whose work rows exceed Hopper's 227 KB of shared memory raises
    in the wrapper (192 kHz at the engine's longest block there); 96 kHz at
    512 samples takes ~90 KB."""
    from libgooey_tpu_torch.effects import reverb_plate

    assert plate_kernels.smem_bytes(reverb_plate.in_hist_len(96000.0),
                                    reverb_plate.mod_hist_len(96000.0), 512) < 96_000
    monkeypatch.setattr(plate_kernels, "_on_cuda", lambda name, t: True)
    monkeypatch.setattr(plate_kernels, "_launch", lambda *a: pytest.fail("launched"))
    sr = 192000.0
    B = reverb_plate.min_tank_lag(sr)
    DIN, DMOD = reverb_plate.in_hist_len(sr), reverb_plate.mod_hist_len(sr)
    x = torch.zeros(B)
    with pytest.raises(ValueError, match="shared memory"):
        plate_kernels.plate_block(x, x, x, x, x, x, torch.ones(2, B), torch.zeros(4, DIN),
                                  torch.zeros(2, DMOD), torch.zeros(3), sample_rate=sr)
