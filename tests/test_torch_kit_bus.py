"""The five-family kit with the whole global bus, port against the JAX
package on the CPU.

The configuration of ``bench_configs.build_full_kit`` at a small width (the
kit's statics, mixer and traffic shape of tests/test_torch_kit.py) with its
seven-effect bus in its order, ``fx_order = ("saturation", "lowpass",
"tilt", "delay", "compressor", "spring", "plate")``, rendered through
``render_many``.  The delay time is 0.015 s (661.5 samples), so within the
4 blocks of 256 the ring's taps read what earlier blocks wrote; the plate is
at its smallest size (0.0: its modulated allpasses read 225-340 samples
back; its tank's feedback, 1,172-1,650 back, is held against the JAX package
in tests/test_torch_bus.py).  The JAX side runs its CPU path (each effect's
``impl="xla"`` branch); both start from the same state and take the same
numpy events.  tests/test_torch_kit_sidechain.py renders it with the
compressor keyed from a kick voice.

Bounds: stereo output <= 1e-4; every carried state leaf, the delay ring and
the plate's tank included, <= 4e-4, relative to the leaf's magnitude where
that exceeds 1 (see tests/test_torch_bus.py).  Measured: output 4.2e-7
(defaults) / 1.8e-7 (moving), worst state leaf 3.8e-5 (a voice leaf,
``tom2.morph.rand_frac``), both target sets.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from libgooey_tpu.engine import engine as jengine

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.engine import engine as tengine
from libgooey_tpu_torch.ops import kernels

from test_torch_bus import max_state_err
from test_torch_kit import PER_FAMILY, _jax_state
from test_torch_kit import STATIC as KIT_STATIC

SR = 44100.0
B = 256
N = 4
OUT_TOL = 1e-4
STATE_TOL = 4e-4
FX_ORDER = ("saturation", "lowpass", "tilt", "delay", "compressor", "spring", "plate")
STATIC = dict(KIT_STATIC, block_size=B, fx_order=FX_ORDER)
DELAY_INIT = (0.015, 0.5, 0.4, 6000.0)
PLATE_INIT = (0.5, 0.3, 0.5, 0.0, 1.0, 0.0)
#: per-effect targets: the Engine's defaults (the tilt in passthrough) with
#: the short delay and the smallest plate, and a set that moves every
#: smoother, runs the SVF and puts the bus over the compressor's threshold
TARGETS = {
    "defaults": dict(jengine.FX_DEFAULT_TARGETS, delay=list(DELAY_INIT), plate=list(PLATE_INIT)),
    "moving": {"saturation": [0.5, 0.6, 0.8], "lowpass": [3000.0, 0.6],
               "tilt": [0.3, 0.4], "delay": [0.015, 0.6, 0.5, 5000.0],
               "compressor": [-60.0, 8.0, 1.0, 50.0, 1.0], "spring": [0.7, 0.4, 0.3],
               "plate": [0.7, 0.4, 0.3, 0.05, 0.8, 0.0]},
}


def _state():
    state = _jax_state()
    init = {"delay": DELAY_INIT, "plate": PLATE_INIT}
    for name in FX_ORDER:
        state["fx_" + name] = jengine.FX_MODULES[name].init_state(SR, *init.get(name, ()))
    return state


def _events(targets, b=B):
    """Staggered triggers in every family, a retrigger while sounding, and
    per-block effect targets, for blocks of ``b``."""
    rs = np.random.RandomState(6)
    ev = {"block_start": (np.arange(N) * b).astype(np.int32)}
    for kind, vk in PER_FAMILY.items():
        offs = np.full((N, vk), b, np.int32)
        vels = np.zeros((N, vk), np.float32)
        for v in range(vk):
            offs[v % 2, v] = rs.randint(0, b)
            vels[v % 2, v] = 0.5 + 0.5 * ((v % 7) / 6.0)
        offs[2, 0], vels[2, 0] = 77, 0.9
        ev[kind + "_off"], ev[kind + "_vel"] = offs, vels
    for name in FX_ORDER:
        ev["fx_" + name] = np.tile(np.asarray(targets[name], np.float32), (N, 1))
    return ev


def render_both(targets, b=B, **static):
    """Render the kit with the bus through both packages from the same
    state; returns ``(output error, (worst state error, its leaf))``."""
    events = _events(TARGETS[targets], b)
    jstate = _state()
    tstate = interop.engine_state_from_numpy(jstate, "cpu")
    static = dict(STATIC, block_size=b, **static)
    jst, jout = jengine.render_many(
        jstate, {k: jnp.asarray(v) for k, v in events.items()}, **static)
    tst, tout = tengine.render_many(tstate, events, **static)
    jout = np.asarray(jout)
    assert tout.shape == (N, 2, b)
    assert np.abs(jout).max() > 1e-3
    # the delay's ring and the plate's tank hold what the bus wrote
    assert np.abs(np.asarray(jst["fx_delay"].ring.buf)).max() > 1e-3
    assert np.abs(np.asarray(jst["fx_plate"].tank)).max() > 1e-4
    return float(np.abs(tout.numpy() - jout).max()), max_state_err(jst, tst)


@pytest.mark.parametrize("targets", sorted(TARGETS))
def test_kit_with_bus_matches_jax(targets):
    out_err, (worst, where) = render_both(targets)
    assert out_err <= OUT_TOL
    assert worst <= STATE_TOL, f"state divergence {worst} at {where}"


def _count_wrapper_calls(monkeypatch, **static):
    """Calls of each kernel wrapper over one block of the kit with the bus
    (on the CPU they run their plain versions; on CUDA the same calls launch
    the kernels)."""
    calls = {n: 0 for n in kernels.KERNELS}
    for n in kernels.KERNELS:
        mod = kernels.module_of(n)

        def counted(*a, _fn=getattr(mod, n), _n=n, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, n, counted)
    state = interop.engine_state_from_numpy(_state(), "cpu")
    events = {k: v[:1] for k, v in _events(TARGETS["moving"]).items()}
    tengine.render_many(state, events, **STATIC, **static)
    return calls


VOICE_CALLS = {"affine1_bank": 26, "pink_bank": 2, "svf_bank": 3, "env_follow_bank": 1,
               "fbws_bank": 1, "ws4_bank": 2, "linrec2_bank": 5, "triangle_additive_bank": 1,
               "mix_bank": 1,
               # the kit path's and the chain's waveshapers, the granulator's
               # and the sampler's reads: not on this path
               "kit_sources": 0, "kit_drive": 0, "waveshaper_block": 0, "fbws_fast_block": 0,
               "grain_read_cubic": 0, "sampler_read_linear": 0}


BUS_SINGLES = ("saturation_block", "lowpass_block", "tilt_block", "delay_block",
               "env_follower_block", "compressor_block", "spring_block")


def test_kit_with_bus_goes_through_every_kernel_wrapper(monkeypatch):
    """The eight voice wrappers, and the bus as the JAX engine runs it on
    the TPU: the six effects before the plate as one run, one ``bus_chain``
    a block, then the plate's own kernel."""
    assert _count_wrapper_calls(monkeypatch) == dict(
        VOICE_CALLS, **dict.fromkeys(BUS_SINGLES, 0), bus_chain=1, plate_block=1)


def test_unmerged_bus_goes_through_each_effect_wrapper(monkeypatch):
    """With ``fuse_bus=False`` each effect launches its own kernels once a
    block (the JAX engine's per-effect path, as for a lone effect): all
    seventeen wrappers but ``bus_chain``."""
    assert _count_wrapper_calls(monkeypatch, fuse_bus=False) == dict(
        VOICE_CALLS, **dict.fromkeys(BUS_SINGLES, 1), bus_chain=0, plate_block=1)
