"""The port's snare bank against the JAX package's stage path, on the CPU.

Both packages start from the same state (carried across with ``interop``),
take the same numpy triggers and render 4 blocks of 128 samples; every
carried state leaf is compared by name.  The voices mix the four presets,
so the overdrive (``ws4_bank``), the phase modulator and the Chamberlin
(``linrec2_bank``) all run, with the tonal triangle at the kit's 64
harmonics and the Engine's 192 (``triangle_additive_bank``).

Bounds: audio <= 1e-4 (the -80 dBFS bar of tests/test_snare.py), every
state leaf <= 4e-4 (the bound tests/test_pallas_voice.py holds the TPU's
fused kernels to against the same twin).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.instruments import snare as jsnare

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.instruments import snare as tsnare

from test_torch_slice import _max_state_err

SR = 44100.0
B = 128
V = 8
OUT_TOL = 1e-4
STATE_TOL = 4e-4


def _jax_state():
    presets = [jsnare.SnareConfig.tight, jsnare.SnareConfig.loose,
               jsnare.SnareConfig.hiss, jsnare.SnareConfig.smack]
    cfgs = [presets[v % 4]() for v in range(V)]
    st = jsnare.init_state(V, targets=np.stack([c.as_array() for c in cfgs]))
    # every filter mode of the Chamberlin (LP, BP, HP, notch)
    return st._replace(filter_type=jnp.asarray(np.arange(V) % 4, jnp.int32))


def _events():
    """4 blocks: staggered single triggers (first and last sample of a
    block included), a ``[V, K]`` block with two triggers on one voice, a
    retrigger of a sounding voice and a block without triggers."""
    offs = [np.full(V, B, np.int32) for _ in range(4)]
    vels = [np.zeros(V, np.float32) for _ in range(4)]
    offs[0][:5] = [0, 17, 64, 100, 127]
    vels[0][:5] = [1.0, 0.5, 0.8, 0.3, 0.9]
    offs[1] = np.full((V, 2), B, np.int32)
    vels[1] = np.zeros((V, 2), np.float32)
    offs[1][0], vels[1][0] = [5, 70], [0.9, 0.4]
    offs[1][5], vels[1][5] = [12, 13], [0.3, 0.8]
    offs[1][7], vels[1][7] = [40, B], [1.0, 0.0]
    offs[2][[1, 6]] = [60, 3]
    vels[2][[1, 6]] = [0.7, 0.6]
    return offs, vels


@pytest.mark.parametrize("max_harmonics", [64, 192])
def test_render_block_matches_jax(max_harmonics):
    static = dict(sample_rate=SR, block_size=B, smooth_coeff=smoothing_coeff(SR),
                  max_harmonics=max_harmonics)
    jrender = jax.jit(functools.partial(jsnare.render_block, fused=False, **static))
    jst = _jax_state()
    tst = interop.family_state_from_numpy("snare", jst, "cpu")
    offs, vels = _events()
    peak = 0.0
    for blk, (off, vel) in enumerate(zip(offs, vels)):
        start = np.int32(blk * B)
        jst, jout = jrender(jst, jnp.asarray(off), jnp.asarray(vel), start)
        tst, tout = tsnare.render_block(tst, off, vel, start, **static)
        jout = np.asarray(jout)
        peak = max(peak, float(np.abs(jout).max()))
        assert tout.shape == (V, B)
        assert np.abs(tout.numpy() - jout).max() <= OUT_TOL, f"block {blk}"
        worst, where = _max_state_err(jst, tst)
        assert worst <= STATE_TOL, f"block {blk}: state divergence {worst} at {where}"
    assert peak > 1e-2


def test_interop_round_trip():
    st = tsnare.init_state(3, tsnare.SnareConfig.hiss(), device="cpu")
    back = interop.family_state_from_numpy("snare", interop.to_numpy(st), "cpu")
    worst, _ = _max_state_err(interop.to_numpy(st), back)
    assert worst == 0.0
    assert back.filter_type.dtype == st.filter_type.dtype
