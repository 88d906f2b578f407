"""The three kernels the kit adds to the port (plain versions, on the CPU)
against the JAX package's Pallas wrappers in interpret mode, and the 4x
waveshaper also against the JAX package's XLA oversampler path.

The same numpy inputs feed both packages.  V = 130 crosses a 128-lane group
of the TPU layout.  Tolerances:

* ``linrec2_bank`` <= 1e-6: the plain version keeps the Pallas body's
  per-sample op order (XLA:CPU may contract a multiply-add into an FMA
  where PyTorch rounds twice).
* ``ws4_bank`` <= 1e-5 against the Pallas wrapper (32 allpass sections and 4
  tanh per sample, as ``fbws_bank``) and <= 3e-5 against ``ws.process``
  through the stateful XLA oversampler (reassociated half-band matmuls), on
  the output and every unpacked state field, over two blocks.
* ``triangle_additive_bank`` <= 2e-5: the Chebyshev recurrence runs up to
  128 steps from libm's ``sin``/``cos`` of a phase of thousands of radians
  (see the test for the wrapper's own constant).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libgooey_tpu.effects import waveshaper as jws
from libgooey_tpu.ops import osc as josc
from libgooey_tpu.ops import oversample as jovs
from libgooey_tpu.ops import pallas_fx, pallas_voice

from libgooey_tpu_torch.ops import bank_kernels as bk
from libgooey_tpu_torch.ops import oversample as tovs

SR = 44100.0
V, B = 130, 128


def T(a):
    return torch.from_numpy(np.array(a))


def err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _membrane_like_coeffs(rs, R):
    """Band-pass DF-I feedback matrices at high Q (the membrane's bands)
    with trigger resets, and an input drive."""
    f = rs.uniform(150.0, 350.0, (R, 1))
    q = rs.uniform(1.0, 8.0, (R, 1))
    w = 2 * np.pi * f / SR
    alpha = np.sin(w) / (2 * q)
    a0 = 1 + alpha
    a1 = np.broadcast_to(-2 * np.cos(w) / a0, (R, B))
    a2 = np.broadcast_to((1 - alpha) / a0, (R, B))
    keep = np.where(rs.rand(R, B) < 0.01, 0.0, 1.0)
    coefs = [-a1 * keep, -a2 * keep, keep, np.zeros((R, B)),
             0.01 * rs.randn(R, B), np.zeros((R, B))]
    return [c.astype(np.float32) for c in coefs]


def test_linrec2_bank_matches_jax():
    rs = np.random.RandomState(31)
    coefs = _membrane_like_coeffs(rs, V)
    s1_0 = (0.1 * rs.randn(V)).astype(np.float32)
    s2_0 = (0.1 * rs.randn(V)).astype(np.float32)
    want = pallas_fx.linrec2_bank(*coefs, s1_0, s2_0, interpret=True)
    got = bk.linrec2_bank(*map(T, coefs), T(s1_0), T(s2_0))
    assert np.abs(np.asarray(want[0])).max() > 1e-3
    for name, a, b in zip(("s1", "s2", "s1_last", "s2_last"), want, got):
        assert err(a, b) <= 1e-6, name


def _ovs_err(jovs_state, tovs_state) -> float:
    worst = 0.0
    for hb in ("up1", "up2", "down2", "down1"):
        for f in jovs_state.up1._fields:
            worst = max(worst, err(getattr(getattr(jovs_state, hb), f),
                                   getattr(getattr(tovs_state, hb), f)))
    return worst


def test_ws4_bank_matches_jax_over_blocks():
    """Two blocks threaded through each package's pack/unpack: against the
    interpret-mode Pallas wrapper and against ``ws.process`` at 4x."""
    rs = np.random.RandomState(9)
    j_bank = j_xla = jovs.OversamplerState.init((V,))
    t_st = tovs.OversamplerState.init((V,), "cpu")
    for _ in range(2):
        x = (0.6 * rs.randn(V, B)).astype(np.float32)
        drive = (1.0 + 9.0 * rs.rand(V, 1) * np.ones((1, B))).astype(np.float32)
        drive[:8] = 1.0                                         # bypassed rows
        sat_j, nst_j = pallas_fx.ws4_bank(x, drive, pallas_fx.pack_ws4_bank(j_bank),
                                          interpret=True)
        j_bank = pallas_fx.unpack_ws4_bank(nst_j, j_bank)
        os_wrap, os_box = jovs.stateful(j_xla, 4)
        out_x = jws.process(jnp.asarray(x), jnp.asarray(drive), mix=1.0, oversample=os_wrap)
        j_xla = os_box["state"]
        sat_t, nst_t = bk.ws4_bank(T(x), T(drive), bk.pack_ws4_bank(t_st))
        assert tuple(nst_t.shape) == (bk.FBWS_S_OUT, V) == tuple(nst_j.shape)
        t_st = bk.unpack_ws4_bank(nst_t, t_st)
        assert err(sat_j, sat_t) <= 1e-5
        assert _ovs_err(j_bank, t_st) <= 1e-5
        shaped = torch.where(T(drive) <= 1.0, T(x), sat_t)
        assert err(out_x, shaped) <= 3e-5
        assert _ovs_err(j_xla, t_st) <= 3e-5
    assert float(sat_t.abs().max()) > 0.1


@pytest.mark.parametrize("R,n", [(1, 512), (130, 100)])
def test_ws4_bank_tails_match_jax_over_blocks(R, n):
    """The granulator's one row at its drive of 4, and 100-sample blocks
    (a tail of the kernel's 32-sample chunks) with the drive moving within
    each row, two blocks threaded through each package's pack/unpack."""
    rs = np.random.RandomState(R + n)
    j_st = jovs.OversamplerState.init((R,))
    t_st = tovs.OversamplerState.init((R,), "cpu")
    for _ in range(2):
        x = (0.6 * rs.randn(R, n)).astype(np.float32)
        if R == 1:
            drive = np.full((R, n), 4.0, np.float32)
        else:
            drive = (1.0 + 9.0 * rs.rand(R, 1) * np.linspace(0.5, 1.0, n)).astype(np.float32)
            drive[::9] = 1.0
        sat_j, nst_j = pallas_fx.ws4_bank(x, drive, pallas_fx.pack_ws4_bank(j_st),
                                          interpret=True)
        j_st = pallas_fx.unpack_ws4_bank(nst_j, j_st)
        sat_t, nst_t = bk.ws4_bank(T(x), T(drive), bk.pack_ws4_bank(t_st))
        t_st = bk.unpack_ws4_bank(nst_t, t_st)
        assert tuple(sat_t.shape) == (R, n) and tuple(nst_t.shape) == (bk.FBWS_S_OUT, R)
        assert err(sat_j, sat_t) <= 1e-5
        assert err(nst_j, nst_t) <= 1e-5
        assert _ovs_err(j_st, t_st) <= 1e-5
    assert float(sat_t.abs().max()) > 0.1


@pytest.mark.parametrize("max_harmonics", [64, 256])
def test_triangle_additive_bank_matches_jax(max_harmonics):
    """40-2,000 Hz per sample (above Nyquist/64 the taper and the Nyquist cap
    bite), against the Pallas wrapper within a block of the trigger and
    against the XLA formulation up to 2 s after it.

    The port follows ``osc.py:130``, which rounds the float64 ``2pi/sr`` to
    float32 once; the Pallas body (``pallas_voice.py:172``) divides in
    float32 and lands one ulp away, so 2 s after a trigger (theta ~ 2e4 rad)
    the wrapper and the XLA path differ by ~7e-3 between themselves.  The
    family paths the port is held to run the XLA formulation."""
    rs = np.random.RandomState(max_harmonics)
    freq = rs.uniform(40.0, 2000.0, (V, B)).astype(np.float32)
    near = (rs.randint(-B, B, (V, 1)) + np.arange(B)[None, :]).astype(np.float32)
    want = pallas_voice.triangle_additive_bank(near, freq, SR, max_harmonics, interpret=True)
    got = bk.triangle_additive_bank(T(near), T(freq), SR, max_harmonics)
    assert np.abs(np.asarray(want)).max() > 0.5
    assert err(want, got) <= 2e-5
    late = (rs.randint(0, 2 * int(SR), (V, 1)) + np.arange(B)[None, :]).astype(np.float32)
    want = josc.triangle_additive(jnp.asarray(late), jnp.asarray(freq), SR, max_harmonics)
    got = bk.triangle_additive_bank(T(late), T(freq), SR, max_harmonics)
    assert err(want, got) <= 2e-5
