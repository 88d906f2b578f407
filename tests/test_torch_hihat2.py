"""The port's hihat2 bank against the JAX package's stage path, on the CPU.

Both packages start from the same state (carried across with ``interop``),
take the same numpy triggers and render 4 blocks of 128 samples; every
carried state leaf is compared by name, the uint32 ``voice_salt`` included.
The voices mix the four presets, both noise colours (white: the salted
counter hash; pink: ``pink_bank``) and both slopes (one or two biquads in
``linrec2_bank``); the phase accumulators and the asymmetric envelope
smoother run in ``affine1_bank``, the tone filter in ``svf_bank``.

Bounds: audio <= 1e-4, every state leaf <= 4e-4 (as tests/test_torch_snare.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.instruments import hihat2 as jhh

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.core import rng
from libgooey_tpu_torch.instruments import hihat2 as thh

from test_torch_slice import _max_state_err
from test_torch_snare import _events

SR = 44100.0
B = 128
V = 8
OUT_TOL = 1e-4
STATE_TOL = 4e-4


def _jax_state(salt_base=0):
    presets = [jhh.HiHat2Config.short, jhh.HiHat2Config.loose,
               jhh.HiHat2Config.dark, jhh.HiHat2Config.soft]
    targets = np.stack([presets[v % 4]().as_array() for v in range(V)])
    st = jhh.init_state(V, targets=targets)
    return st._replace(
        noise_color=jnp.asarray(np.arange(V) % 2, jnp.int32),
        filter_slope=jnp.asarray((np.arange(V) // 2) % 2, jnp.int32),
        voice_salt=jnp.arange(salt_base, salt_base + V, dtype=jnp.uint32))


@pytest.mark.parametrize("salt_base", [0, 4000])
def test_render_block_matches_jax(salt_base):
    """``salt_base`` = 4000 puts ``salt * 0x9E3779B9`` far past 2^32, where
    the counter's uint32 wrap decides every noise bit."""
    static = dict(sample_rate=SR, block_size=B, smooth_coeff=smoothing_coeff(SR))
    jrender = jax.jit(functools.partial(jhh.render_block, fused=False, **static))
    jst = _jax_state(salt_base)
    tst = interop.family_state_from_numpy("hihat2", jst, "cpu")
    offs, vels = _events()
    peak = 0.0
    for blk, (off, vel) in enumerate(zip(offs, vels)):
        start = np.int32(blk * B)
        jst, jout = jrender(jst, jnp.asarray(off), jnp.asarray(vel), start)
        tst, tout = thh.render_block(tst, off, vel, start, **static)
        jout = np.asarray(jout)
        peak = max(peak, float(np.abs(jout).max()))
        assert np.abs(tout.numpy() - jout).max() <= OUT_TOL, f"block {blk}"
        worst, where = _max_state_err(jst, tst)
        assert worst <= STATE_TOL, f"block {blk}: state divergence {worst} at {where}"
    assert peak > 1e-2


def test_salted_noise_counter_is_bit_exact():
    """``n + salt * 0x9E3779B9`` with uint32 wrap, through the int64
    emulation, against numpy's uint32 arithmetic and the JAX hash."""
    from libgooey_tpu.core import rng as jrng

    n = np.arange(2**31 - 64, 2**31 + 64, dtype=np.int64).astype(np.uint32)
    salt = np.array([0, 1, 7, 4095, 2**31 + 5], np.uint32)
    want = n[None, :] + salt[:, None] * np.uint32(0x9E3779B9)
    got = rng.add_mul32(torch.from_numpy(n.astype(np.int64))[None, :],
                        torch.from_numpy(salt.astype(np.int64))[:, None], thh.SALT_MULT)
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert np.array_equal(rng.white(got).numpy().view(np.int32),
                          np.asarray(jrng.white(jnp.asarray(want))).view(np.int32))


def test_voice_salt_round_trips_as_uint32():
    st = thh.init_state(5, device="cpu")
    st = st._replace(voice_salt=torch.tensor([0, 1, 2**31, 2**32 - 1, 9]))
    arr = interop.to_numpy(st)
    assert arr.voice_salt.dtype == np.uint32
    back = interop.family_state_from_numpy("hihat2", arr, "cpu")
    assert torch.equal(back.voice_salt, st.voice_salt)
