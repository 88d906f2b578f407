"""The port's Engine with the whole global bus against the JAX Engine on the
CPU.

One sequenced instrument of each of the five families (the Engine's
default statics), all seven global effects added with
``add_global_effect`` in the JAX package's default order, the compressor
set over the kit's level; after three blocks the compressor is keyed from
the kick with ``set_sidechain_source``, and after five from its input
again.  Both engines render the same calls block by block.  (In a file of
its own, so that its two JAX compiles run beside tests/test_torch_engine.py.)

Bounds: stereo and mono output 1e-4, every state leaf 4e-4 relative to its
magnitude where that exceeds 1, as tests/test_torch_engine.py.  Measured:
stereo 6.6e-7 (peak 0.148), mono 5.0e-6, worst state leaf 2.7e-5 (a voice
leaf, ``hihat2.hpf1.x2``); the smoothed gain reached 0.217.
"""

import numpy as np

from libgooey_tpu.engine.engine import FAMILIES as JFAMILIES
from libgooey_tpu.engine.engine import Engine as JEngine

from libgooey_tpu_torch.engine.engine import FAMILIES as TFAMILIES
from libgooey_tpu_torch.engine.engine import Engine as TEngine

from test_torch_bus import max_state_err

SR = 44100.0
B = 128
N = 7
FX = ("saturation", "lowpass", "tilt", "delay", "compressor", "spring", "plate")
TARGETS = {"tilt": [0.3, 0.4], "delay": [0.015, 0.5, 0.4, 6000.0],
           "compressor": [-40.0, 6.0, 2.0, 60.0, 1.0], "plate": [0.6, 0.4, 0.4, 0.0, 1.0, 0.2]}


def _drive(eng):
    """Returns (stereo, mono) numpy blocks."""
    jax_side = isinstance(eng, JEngine)
    for i, kind in enumerate(("kick", "snare", "hihat2", "tom2", "bass")):
        mod = (JFAMILIES if jax_side else TFAMILIES)[kind]
        eng.add_instrument(kind, kind, mod.PRESETS["default"]())
        seq = eng.new_sequencer(kind, 480.0 + 60.0 * i)
        seq.set_pattern([(s + i) % 3 == 0 for s in range(16)])
        seq.start()
    eng.set_master_gain(0.6)
    for name in FX:
        eng.add_global_effect(name, TARGETS.get(name))
    outs, monos = [], []
    for blk in range(N):
        if blk == 3:
            eng.set_sidechain_source("kick")
        if blk == 5:
            eng.set_sidechain_source(None)
        out, mono = eng.render_block()
        outs.append(np.asarray(out))
        monos.append(np.asarray(mono))
    return np.stack(outs), np.stack(monos)


def test_engine_kit_with_the_whole_bus_and_a_sidechain_matches_jax_engine():
    jeng, teng = JEngine(SR, B), TEngine(SR, B, device="cpu")
    want, want_mono = _drive(jeng)
    got, got_mono = _drive(teng)
    assert np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= 1e-4
    assert np.abs(got_mono - want_mono).max() <= 1e-4
    # the compressor reduced the gain while keyed from the kick
    assert float(teng._state["fx_compressor"].gain.min()) < 0.99
    worst, where = max_state_err(jeng._state, teng._state)
    assert worst <= 4e-4, f"state divergence {worst} at {where}"
