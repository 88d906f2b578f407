"""The port's bass bank against the JAX package's stage path, on the CPU.

Both packages start from the same state (carried across with ``interop``),
take the same numpy triggers and render 4 blocks of 128 samples; every
carried state leaf is compared by name.  The voices mix the four presets,
so the pre-filter overdrive (``ws4_bank``) is on in some voices and frozen
in others (``sub`` has none); the phase accumulators run in
``affine1_bank``, the swept filter in ``svf_bank``.  Sequencer notes reach
the bank as ``note_freq``, ``[V]`` and ``[V, K]``.

Bounds: audio <= 1e-4, every state leaf <= 4e-4 (as tests/test_torch_snare.py).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.instruments import bass as jbass

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.instruments import bass as tbass

from test_torch_slice import _max_state_err
from test_torch_snare import _events

SR = 44100.0
B = 128
V = 8
OUT_TOL = 1e-4
STATE_TOL = 4e-4


def _note_freqs(offs):
    """A note on some triggers (0 = keep the param's frequency), shaped
    like each block's offsets."""
    rs = np.random.RandomState(3)
    out = []
    for off in offs:
        f = np.where(rs.rand(*off.shape) < 0.5, 0.0, rs.uniform(40.0, 180.0, off.shape))
        out.append(np.where(off < B, f, 0.0).astype(np.float32))
    return out


@pytest.mark.parametrize("with_notes", [False, True])
def test_render_block_matches_jax(with_notes):
    presets = [jbass.BassConfig.acid, jbass.BassConfig.sub, jbass.BassConfig.reese,
               jbass.BassConfig.stab]
    targets = np.stack([presets[v % 4]().as_array() for v in range(V)])
    static = dict(sample_rate=SR, block_size=B, smooth_coeff=smoothing_coeff(SR))
    jrender = jax.jit(functools.partial(jbass.render_block, fused=False, **static))
    jst = jbass.init_state(V, targets=targets)
    tst = interop.family_state_from_numpy("bass", jst, "cpu")
    offs, vels = _events()
    notes = _note_freqs(offs) if with_notes else [None] * len(offs)
    peak = 0.0
    for blk, (off, vel, nf) in enumerate(zip(offs, vels, notes)):
        start = np.int32(blk * B)
        jnf = None if nf is None else jnp.asarray(nf)
        jst, jout = jrender(jst, jnp.asarray(off), jnp.asarray(vel), start, note_freq=jnf)
        tst, tout = tbass.render_block(tst, off, vel, start, note_freq=nf, **static)
        jout = np.asarray(jout)
        peak = max(peak, float(np.abs(jout).max()))
        assert np.abs(tout.numpy() - jout).max() <= OUT_TOL, f"block {blk}"
        worst, where = _max_state_err(jst, tst)
        assert worst <= STATE_TOL, f"block {blk}: state divergence {worst} at {where}"
    assert peak > 1e-2
    if with_notes:
        assert np.isin(np.asarray(jst.trig_freq), np.concatenate(
            [n.ravel() for n in notes])).any()
