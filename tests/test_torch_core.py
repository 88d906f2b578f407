"""The port's elementwise building blocks against the JAX package on the CPU:
smoother closed forms (bit for bit where the op order is the same),
envelopes, pan/tuning math, the soft limiter and the one-pole."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libgooey_tpu.core import dsp as jdsp
from libgooey_tpu.core import envelope as jenv
from libgooey_tpu.core import smoother as jsm
from libgooey_tpu.effects import limiter as jlim
from libgooey_tpu.ops import scan as jscan

from libgooey_tpu_torch.core import dsp as tdsp
from libgooey_tpu_torch.core import envelope as tenv
from libgooey_tpu_torch.core import smoother as tsm
from libgooey_tpu_torch.effects import limiter as tlim
from libgooey_tpu_torch.ops import scan as tscan

SR = 44100.0
B = 128


def T(a):
    return torch.from_numpy(np.array(a))


def err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _bank(rs, shape):
    cur = rs.randn(*shape).astype(np.float32)
    tgt = rs.randn(*shape).astype(np.float32)
    tgt.flat[::5] = cur.flat[::5] + 4e-5  # lanes that snap at once
    return cur, tgt


def test_smoothing_coeff_matches_jax():
    for sr in (22050.0, 44100.0, 96000.0):
        for ms in (0.0, 1.0, 15.0, 120.0):
            assert tsm.smoothing_coeff(sr, ms) == jsm.smoothing_coeff(sr, ms)


@pytest.mark.parametrize("shape", [(6, 19), (40,), ()])
def test_smoother_closed_forms_match_jax(shape):
    """smooth_block, smooth_block_lazy (by slices) and smooth_advance: the
    trajectories within float32 rounding of pow, the settle snap exact."""
    rs = np.random.RandomState(len(shape))
    cur, tgt = _bank(rs, shape) if shape else (np.float32(0.25), np.float32(0.5))
    coeff = tsm.smoothing_coeff(SR)
    jb = jsm.SmootherBank(jnp.asarray(cur), jnp.asarray(tgt))
    tb = tsm.SmootherBank(T(cur), T(tgt))
    jn, jtraj = jsm.smooth_block(jb, coeff, B)
    tn, ttraj = tsm.smooth_block(tb, coeff, B)
    assert err(jtraj, ttraj) <= 1e-6 and err(jn.current, tn.current) <= 1e-6
    tl, tslice = tsm.smooth_block_lazy(tb, coeff, B)
    assert torch.equal(tl.current, tn.current)
    if shape:
        n = shape[0]
        lazy = torch.cat([tslice(0, n // 2), tslice(n // 2, n)])
        assert torch.equal(lazy, ttraj)
    ta = tsm.smooth_advance(tb, coeff, B)
    ja = jsm.smooth_advance(jb, coeff, B)
    assert err(ja.current, ta.current) <= 1e-6
    # the snap lands on the target exactly in both packages
    assert np.array_equal(np.asarray(jn.current) == np.asarray(tgt),
                          tn.current.numpy() == np.asarray(tgt))


def test_envelope_amplitude_matches_jax():
    rs = np.random.RandomState(9)
    elapsed = np.concatenate([np.linspace(-0.01, 0.6, 4000),
                              [0.0, 0.001, 2.0e4]]).astype(np.float32)[None, :]
    decay = rs.uniform(0.01, 0.5, (5, 1)).astype(np.float32)
    curve = rs.uniform(0.05, 12.0, (5, 1)).astype(np.float32)
    for sustain in (0.0, 0.5):
        je = jenv.ADSR(0.001, jnp.asarray(decay), sustain, jnp.asarray(decay * 0.2), 1.0,
                       jnp.asarray(curve))
        te = tenv.ADSR(0.001, T(decay), sustain, T(decay * 0.2), 1.0, T(curve))
        assert err(jenv.amplitude(je, jnp.asarray(elapsed)),
                   tenv.amplitude(te, T(elapsed))) <= 1e-6


def test_dsp_and_limiter_match_jax():
    x = np.linspace(-0.2, 1.2, 1001).astype(np.float32)
    for a, b in zip(jdsp.pan_gains(x), tdsp.pan_gains(T(x))):
        assert err(a, b) <= 1e-7
    assert err(jdsp.tuning_to_multiplier(x), tdsp.tuning_to_multiplier(T(x))) <= 1e-6
    assert err(jdsp.denormalize(x, 30.0, 120.0), tdsp.denormalize(T(x), 30.0, 120.0)) <= 1e-5
    sig = (3.0 * np.sin(np.linspace(0, 20, 2048))).astype(np.float32)
    for thr in (1.0, 0.5, 0.0001, 2.0):
        assert err(jlim.soft_limit(sig, thr), tlim.soft_limit(T(sig), thr)) <= 1e-6


def test_onepole_matches_jax():
    rs = np.random.RandomState(8)
    coeff = rs.uniform(0.001, 0.2, (4, B)).astype(np.float32)
    x = rs.randn(4, B).astype(np.float32)
    y0 = rs.randn(4).astype(np.float32)
    assert err(jscan.onepole(coeff, x, y0), tscan.onepole(T(coeff), T(x), T(y0))) <= 1e-6
