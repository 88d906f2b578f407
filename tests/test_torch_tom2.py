"""The port's tom2 bank against the JAX package's stage path, on the CPU.

Both packages start from the same state (carried across with ``interop``),
take the same numpy triggers and render 4 blocks of 128 samples; every
carried state leaf is compared by name.  The voices mix the four presets:
``ring`` and ``void`` drive the membrane (five high-Q bands as 5V rows of
``linrec2_bank``), ``brush`` the rand~ noise at a high colour; the
pitch-tracking band-pass is ``linrec2_bank`` too, the phase accumulators
and the ring follower ``affine1_bank``.

Bounds: audio <= 1e-4, every state leaf <= 4e-4 (as tests/test_torch_snare.py):
the recurrences are sample-sequential on both sides, in the same op order.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libgooey_tpu.instruments import tom2 as jtom

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.instruments import tom2 as ttom

from test_torch_slice import _max_state_err
from test_torch_snare import _events

SR = 44100.0
B = 128
V = 8
OUT_TOL = 1e-4
STATE_TOL = 4e-4


@pytest.mark.parametrize("triangle_enabled", [True, False])
def test_render_block_matches_jax(triangle_enabled):
    presets = [jtom.Tom2Config.derp, jtom.Tom2Config.ring, jtom.Tom2Config.brush,
               jtom.Tom2Config.void_preset]
    targets = np.stack([presets[v % 4]().as_array() for v in range(V)])
    static = dict(sample_rate=SR, block_size=B, triangle_enabled=triangle_enabled)
    jrender = jax.jit(functools.partial(jtom.render_block, fused=False, **static))
    jst = jtom.init_state(V, targets=targets)
    tst = interop.family_state_from_numpy("tom2", jst, "cpu")
    offs, vels = _events()
    peak = 0.0
    for blk, (off, vel) in enumerate(zip(offs, vels)):
        start = np.int32(blk * B)
        jst, jout = jrender(jst, jnp.asarray(off), jnp.asarray(vel), start)
        tst, tout = ttom.render_block(tst, off, vel, start, **static)
        jout = np.asarray(jout)
        peak = max(peak, float(np.abs(jout).max()))
        assert np.abs(tout.numpy() - jout).max() <= OUT_TOL, f"block {blk}"
        worst, where = _max_state_err(jst, tst)
        assert worst <= STATE_TOL, f"block {blk}: state divergence {worst} at {where}"
    assert peak > 1e-2
    assert float(np.abs(np.asarray(jst.membrane.ring_level)).max()) > 1e-4
