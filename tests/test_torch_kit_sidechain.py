"""The five-family kit with the seven-effect bus and its compressor keyed
from a kick voice, port against the JAX package on the CPU.

tests/test_torch_kit_bus.py's configuration and traffic at blocks of 128
(in a file of its own, so that its JAX compile runs beside that file's),
with ``sidechain_voice`` set: the compressor's detector follows the raw
output of global voice 1 (the second kick) while its gain acts on the bus.
The compressor then leaves the run, which splits into the four effects
before it (one ``bus_chain`` a block), the compressor's own two kernels, the
spring's and the plate's.  The moving targets put the bus over the
compressor's threshold.

Bounds: those of tests/test_torch_kit_bus.py, output 1e-4 and every state
leaf 4e-4.  Measured: output 9.1e-8, worst state leaf 2.3e-5 (a voice
leaf, ``hihat2.hpf2.y1``).
"""

from test_torch_kit_bus import OUT_TOL, STATE_TOL, render_both

#: the voice whose raw output keys the compressor (family order: the kicks
#: come first)
SIDECHAIN_VOICE = 1


def test_kit_with_sidechained_bus_matches_jax():
    out_err, (worst, where) = render_both("moving", b=128, sidechain_voice=SIDECHAIN_VOICE)
    assert out_err <= OUT_TOL
    assert worst <= STATE_TOL, f"state divergence {worst} at {where}"
