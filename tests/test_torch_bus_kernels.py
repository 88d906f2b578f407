"""The bus kernels' plain versions against the JAX package's Pallas wrappers.

The four wrappers of ``libgooey_tpu_torch/ops/bus_kernels.py`` run their plain
PyTorch versions on the CPU; each is compared with its Pallas wrapper in
``libgooey_tpu/ops/pallas_fx.py`` run in interpret mode (as tests/
test_pallas_fx.py runs it on the CPU), on the same numpy inputs at the bus's
shape ``[2, B]``.  The Pallas bodies solve the linear recurrences with
log-depth scans and the plain versions step them sample by sample, so the two
agree at float-noise level.

Bounds: output <= 2e-5, every state leaf <= 1e-4.  Measured with these
inputs on the CPU: saturation 4.8e-7 output / 6.4e-7 state, lowpass 2.4e-7 /
3e-8, tilt 2.4e-7 / 1.6e-7, delay 6e-8 (output and write) / 3e-8, both
ping-pong settings.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libgooey_tpu.ops import oversample as jovs
from libgooey_tpu.ops import pallas_fx

from libgooey_tpu_torch.core.smoother import smoothing_coeff
from libgooey_tpu_torch.ops import bus_kernels as bus
from libgooey_tpu_torch.ops.filters import DCBlockState
from libgooey_tpu_torch.ops.oversample import OversamplerState

from test_torch_slice import _max_state_err

SR = 44100.0
B = 256
OUT_TOL = 2e-5
STATE_TOL = 1e-4
COEFF = smoothing_coeff(SR, 30.0)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def test_saturation_block_matches_pallas():
    """Two blocks from a zero state, each side carrying its own state: the
    first block crosses the bypass gate (mix 0.6 -> 0), the second comes back
    with new drive and warmth, so the DC blocker's gating and held state are
    exercised; the unpacked state is compared leaf by leaf."""
    rs = np.random.RandomState(3)
    x = rs.uniform(-0.9, 0.9, (2, 2 * B)).astype(np.float32)
    blocks = [((0.6, 0.5, 0.6), (0.6, 0.5, 0.0)), ((0.6, 0.5, 0.00005), (0.2, 0.9, 0.8))]
    j_ovs = jovs.OversamplerState.init((2,))
    j_dc = (jnp.zeros(2, jnp.float32), jnp.zeros(2, jnp.float32))
    t_ovs = OversamplerState.init(2, "cpu")
    t_dc = DCBlockState.init((2,), "cpu")
    for i, (cur, tgt) in enumerate(blocks):
        cur2 = np.asarray([cur, cur], np.float32)
        tgt2 = np.asarray([tgt, tgt], np.float32)
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


def test_lowpass_block_matches_pallas():
    """Resonant settings (fb up to 3.3) over a loud input, two blocks."""
    rs = np.random.RandomState(15)
    st_j = np.asarray([[0.1, -0.2], [0.05, 0.3]], np.float32)
    st_t = _t(st_j)
    for i in range(2):
        x = rs.uniform(-0.9, 0.9, (2, B)).astype(np.float32)
        g = rs.uniform(0.2, 0.9, (2, B)).astype(np.float32)
        fb = rs.uniform(0.0, 3.3, (2, B)).astype(np.float32)
        jout, st_j = pallas_fx.lowpass_block(jnp.asarray(x), g, fb, st_j)
        tout, st_t = bus.lowpass_block_plain(_t(x), _t(g), _t(fb), st_t)
        assert _err(jout, tout) <= OUT_TOL, i
        assert _err(st_j, st_t) <= STATE_TOL, i


@pytest.mark.parametrize("cur,tgt", [((0.25, 0.3), (0.75, 0.6)),
                                     ((0.7, 0.9), (0.3, 0.5)),
                                     ((0.5, 0.0), (0.5, 0.0))])
def test_tilt_block_matches_pallas(cur, tgt):
    """Sweeps across the center in both directions at resonance up to Q 7.7,
    and the passthrough knob."""
    rs = np.random.RandomState(11)
    x = rs.uniform(-0.8, 0.8, (2, B)).astype(np.float32)
    cur2, tgt2 = np.asarray([cur, cur], np.float32), np.asarray([tgt, tgt], np.float32)
    ic = np.asarray([[0.02, -0.05], [-0.01, 0.04]], np.float32)
    st = np.concatenate([ic, np.zeros((2, 2), np.float32)], axis=-1)
    jout, jnst = pallas_fx.tilt_block(jnp.asarray(x), cur2, tgt2, st, coeff=COEFF, sample_rate=SR)
    tout, tnst = bus.tilt_block_plain(_t(x), _t(cur2), _t(tgt2), _t(ic), coeff=COEFF,
                                      sample_rate=SR)
    assert _err(jout, tout) <= OUT_TOL
    assert _err(jnst, tnst) <= STATE_TOL


@pytest.mark.parametrize("pingpong", [False, True])
def test_delay_block_matches_pallas(pingpong):
    """A pre-gathered tap, feedback/mix/cutoff moving, both channels."""
    rs = np.random.RandomState(13)
    x = rs.uniform(-0.8, 0.8, (2, B)).astype(np.float32)
    delayed = rs.uniform(-0.5, 0.5, (2, B)).astype(np.float32)
    cur = np.asarray([[0.6, 0.8, 4000.0], [0.5, 0.7, 3000.0]], np.float32)
    tgt = np.asarray([[0.3, 0.5, 12000.0], [0.3, 0.5, 12000.0]], np.float32)
    z = np.asarray([[0.1, 0.05], [-0.2, -0.1]], np.float32)
    st = np.concatenate([z, np.zeros((2, 3), np.float32)], axis=-1)
    jout, jwrite, jnst = pallas_fx.delay_block(
        jnp.asarray(x), delayed, cur, tgt, st, coeff=COEFF, sample_rate=SR, pingpong=pingpong)
    tout, twrite, tnst = bus.delay_block_plain(
        _t(x), _t(delayed), _t(cur), _t(tgt), _t(z), coeff=COEFF, sample_rate=SR,
        pingpong=pingpong)
    assert _err(jout, tout) <= OUT_TOL
    assert _err(jwrite, twrite) <= OUT_TOL
    assert _err(jnst, tnst) <= STATE_TOL
