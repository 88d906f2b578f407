"""The port's 1x/2x/4x oversampler against the JAX package's scan form, on the CPU.

``libgooey_tpu_torch/ops/oversample.py`` runs each allpass section of both
polyphase branches as one ``scan.linrec1`` (``affine1_bank``; its plain
version here).  The JAX package takes the same scan form below
``_MX_MIN_BATCH`` lanes, which every case here stays under.  Held here:
``upsample2``/``downsample2`` per stage and ``process``/``stateful`` at
modes 1, 2 and 4 over 3 blocks with carried state (every state leaf, the
``*y2``/``*x2`` captures included, within 1e-5); ``repeat_to_rate``,
``filters.dc_block`` (also 1e-5: the JAX scan's associative order moves
its output by ~1e-6), ``osc.ring_mod`` and the naive saw/square/triangle
against their JAX twins; and the alias reduction at 2x and 4x against 1x,
at least the 20 dB that tests/test_oversample.py asks of the JAX package.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libgooey_tpu.ops import filters as jfilters
from libgooey_tpu.ops import osc as josc
from libgooey_tpu.ops import oversample as jov

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.ops import filters as tfilters
from libgooey_tpu_torch.ops import osc as tosc
from libgooey_tpu_torch.ops import oversample as tov

from test_torch_slice import _max_state_err

B = 64
N_BLOCKS = 3
TOL = 1e-5
SR = 48000.0


def _x(seed, shape=(3,)):
    rs = np.random.RandomState(seed)
    return rs.uniform(-1.0, 1.0, shape + (N_BLOCKS * B,)).astype(np.float32)


def _fn_jax(v):
    return jnp.tanh(v * 3.0)


def _fn_port(v):
    return torch.tanh(v * 3.0)


@pytest.mark.parametrize("stage", ["up1", "up2", "down2", "down1"])
def test_halfband_stage_matches_jax(stage):
    """One half-band stage alone, its design's coefficients (STAGE1 for the
    outer stages, STAGE2 for the inner), 3 blocks with carried state."""
    coefs = jov.STAGE1 if stage.endswith("1") else jov.STAGE2
    up = stage.startswith("up")
    x = _x(1)
    jst = jov.HalfbandState.init(coefs, (3,))
    tst = interop.from_numpy(tov.HalfbandState.init(tov.STAGE1 if stage.endswith("1")
                                                    else tov.STAGE2, 3, "cpu"), jst, "cpu")
    jfun = jov.upsample2 if up else jov.downsample2
    tfun = tov.upsample2 if up else tov.downsample2
    n = B if up else 2 * B
    xs = x if up else np.concatenate([x, _x(2)], axis=-1)
    for i in range(N_BLOCKS):
        xb = xs[..., i * n:(i + 1) * n]
        jst, jy = jfun(jst, jnp.asarray(xb), coefs)
        tst, ty = tfun(tst, torch.from_numpy(xb.copy()), tov.STAGE1 if stage.endswith("1")
                       else tov.STAGE2)
        assert ty.shape == jy.shape
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=TOL)
        worst, where = _max_state_err(jst, tst)
        assert worst <= TOL, f"block {i}: {where} {worst}"


@pytest.mark.parametrize("mode", [1, 2, 4])
def test_process_and_stateful_match_jax(mode):
    """``process`` over [3, 64] blocks, and the ``stateful`` hook over a
    1-D block (the effects' [...] shapes), both carried over 3 blocks."""
    x = _x(3)
    jst = jov.OversamplerState.init((3,))
    tst = interop.from_numpy(tov.OversamplerState.init(3, "cpu"), jst, "cpu")
    jst1 = jov.OversamplerState.init(())
    tst1 = interop.from_numpy(tov.OversamplerState.init((), "cpu"), jst1, "cpu")
    peak = 0.0
    for i in range(N_BLOCKS):
        xb = x[..., i * B:(i + 1) * B]
        jst, jy = jov.process(jst, _fn_jax, jnp.asarray(xb), mode)
        tst, ty = tov.process(tst, _fn_port, torch.from_numpy(xb.copy()), mode)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=TOL)
        peak = max(peak, float(np.abs(np.asarray(jy)).max()))
        worst, where = _max_state_err(jst, tst)
        assert worst <= TOL, f"block {i}: {where} {worst}"

        jwrap, jbox = jov.stateful(jst1, mode)
        twrap, tbox = tov.stateful(tst1, mode)
        jy1 = jwrap(_fn_jax, jnp.asarray(xb[0]))
        ty1 = twrap(_fn_port, torch.from_numpy(xb[0].copy()))
        jst1, tst1 = jbox["state"], tbox["state"]
        np.testing.assert_allclose(ty1.numpy(), np.asarray(jy1), rtol=0, atol=TOL)
        worst, where = _max_state_err(jst1, tst1)
        assert worst <= TOL, f"stateful block {i}: {where} {worst}"
    assert peak > 0.5
    if mode == 1:   # no stage runs at 1x: the state comes back untouched
        assert all(float(np.abs(leaf).max()) == 0.0
                   for leaf in _leaf_arrays(interop.to_numpy(tst)))


def _leaf_arrays(tree):
    if hasattr(tree, "_fields"):
        for v in tree:
            yield from _leaf_arrays(v)
    else:
        yield np.asarray(tree)


def test_repeat_to_rate_matches_jax():
    traj = np.random.RandomState(4).rand(2, B).astype(np.float32)
    for factor in (1, 2, 4):
        v = np.zeros((2, factor * B), np.float32)
        j = jov.repeat_to_rate(jnp.asarray(traj), jnp.asarray(v), B)
        t = tov.repeat_to_rate(torch.from_numpy(traj), torch.from_numpy(v), B)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # a block-scalar or a mismatched trajectory is passed as it is
    assert tov.repeat_to_rate(0.5, torch.zeros(2, 2 * B), B) == 0.5
    other = torch.ones(2, B // 2)
    assert tov.repeat_to_rate(other, torch.zeros(2, 2 * B), B) is other


def test_dc_block_matches_jax():
    x = _x(5, (2,)) + 0.3   # an offset for the blocker to remove
    jst = jfilters.DCBlockState.init((2,))
    tst = tfilters.DCBlockState.init((2,), "cpu")
    for i in range(N_BLOCKS):
        xb = x[:, i * B:(i + 1) * B]
        jst, jy = jfilters.dc_block(jst, jnp.asarray(xb))
        tst, ty = tfilters.dc_block(tst, torch.from_numpy(xb.copy()))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=TOL)
        np.testing.assert_allclose(tst.y1.numpy(), np.asarray(jst.y1), rtol=0, atol=TOL)
        np.testing.assert_array_equal(tst.x1.numpy(), np.asarray(jst.x1))


@pytest.mark.parametrize("name", ["saw_naive", "square_naive", "triangle_naive", "ring_mod"])
def test_naive_oscillators_match_jax(name):
    idx = np.arange(4096, dtype=np.float32)[None, :].repeat(3, 0)
    freq = np.array([[440.0], [1760.0], [7040.0]], np.float32)
    args = (freq * 1.5,) if name == "ring_mod" else ()
    j = getattr(josc, name)(jnp.asarray(idx), jnp.asarray(freq), *map(jnp.asarray, args),
                            44100.0)
    t = getattr(tosc, name)(torch.from_numpy(idx), torch.from_numpy(freq),
                            *map(torch.from_numpy, args), 44100.0)
    tol = 2e-5 if name == "ring_mod" else 0.0
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=tol)
    assert float(np.abs(t.numpy()).max()) > 0.5


def _coherent(sig, freq):
    t = np.arange(2000, len(sig))
    ph = 2 * np.pi * freq * t / SR
    s = sig[2000:]
    return np.hypot(np.dot(s, np.cos(ph)), np.dot(s, np.sin(ph)))


def test_alias_reduction_at_2x_and_4x():
    """tanh drive 10 on a 10 kHz sine at 48 kHz: the 3rd harmonic folds to
    18 kHz at 1x; 2x and 4x each cut it by at least 20 dB and move the
    fundamental by under 1 dB (tests/test_oversample.py's bounds at 4x)."""
    n = 8192
    x = torch.from_numpy((np.sin(2 * np.pi * 10000 * np.arange(n) / SR) * 0.8)
                         .astype(np.float32))

    def run(mode):
        st = tov.OversamplerState.init((), "cpu")
        outs = []
        for i in range(0, n, 2048):
            st, y = tov.process(st, lambda v: torch.tanh(v * 10.0), x[i:i + 2048], mode)
            outs.append(y.numpy())
        return np.concatenate(outs)

    base = run(1)
    for mode in (2, 4):
        y = run(mode)
        alias_red = 20 * np.log10(_coherent(base, 18000.0) / max(_coherent(y, 18000.0), 1e-12))
        fund = 20 * np.log10(_coherent(y, 10000.0) / _coherent(base, 10000.0))
        assert alias_red >= 20.0, (mode, alias_red)
        assert abs(fund) < 1.0, (mode, fund)
