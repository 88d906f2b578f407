"""The five-family kit with the first half of the global bus, port against
the JAX package on the CPU.

The configuration of ``bench_configs.build_full_kit`` at a small width (the
kit's statics, mixer and traffic shape of tests/test_torch_kit.py) with the
bus cut to its first four effects in its order, ``fx_order = ("saturation",
"lowpass", "tilt", "delay")``, rendered through ``render_many``.  The delay
time is 0.015 s (661.5 samples), so within the 4 blocks of 256 the ring's
taps read what earlier blocks wrote.  The JAX side runs its CPU path (each
effect's ``impl="xla"`` branch); both start from the same state and take the
same numpy events.

Bounds: stereo output <= 1e-4; every carried state leaf, the delay ring
included, <= 4e-4, relative to the leaf's magnitude where that exceeds 1
(see tests/test_torch_bus.py).  Measured: output 8.8e-7 (peak 0.115), worst
state leaf 3.8e-5 (a voice leaf, ``tom2.morph.rand_frac``), both target sets.
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
FX_ORDER = ("saturation", "lowpass", "tilt", "delay")
STATIC = dict(KIT_STATIC, block_size=B, fx_order=FX_ORDER)
DELAY_INIT = (0.015, 0.5, 0.4, 6000.0)

#: per-effect targets: the Engine's defaults (the tilt in passthrough) with
#: the short delay, and a set that moves every smoother and runs the SVF
TARGETS = {
    "defaults": dict(jengine.FX_DEFAULT_TARGETS, delay=list(DELAY_INIT)),
    "moving": {"saturation": [0.5, 0.6, 0.8], "lowpass": [3000.0, 0.6],
               "tilt": [0.3, 0.4], "delay": [0.015, 0.6, 0.5, 5000.0]},
}


def _state():
    state = _jax_state()
    for name in FX_ORDER:
        init = DELAY_INIT if name == "delay" else ()
        state["fx_" + name] = jengine.FX_MODULES[name].init_state(SR, *init)
    return state


def _events(targets):
    """Staggered triggers in every family, a retrigger while sounding, and
    per-block effect targets."""
    rs = np.random.RandomState(6)
    ev = {"block_start": (np.arange(N) * B).astype(np.int32)}
    for kind, vk in PER_FAMILY.items():
        offs = np.full((N, vk), B, np.int32)
        vels = np.zeros((N, vk), np.float32)
        for v in range(vk):
            offs[v % 2, v] = rs.randint(0, B)
            vels[v % 2, v] = 0.5 + 0.5 * ((v % 7) / 6.0)
        offs[2, 0], vels[2, 0] = 77, 0.9
        ev[kind + "_off"], ev[kind + "_vel"] = offs, vels
    for name in FX_ORDER:
        ev["fx_" + name] = np.tile(np.asarray(targets[name], np.float32), (N, 1))
    return ev


@pytest.mark.parametrize("targets", sorted(TARGETS))
def test_kit_with_bus_matches_jax(targets):
    events = _events(TARGETS[targets])
    jstate = _state()
    tstate = interop.engine_state_from_numpy(jstate, "cpu")
    jst, jout = jengine.render_many(
        jstate, {k: jnp.asarray(v) for k, v in events.items()}, **STATIC)
    tst, tout = tengine.render_many(tstate, events, **STATIC)
    jout = np.asarray(jout)
    assert tout.shape == (N, 2, B)
    assert np.abs(jout).max() > 1e-3
    # the delay's ring holds what the bus wrote, echoes included
    assert np.abs(np.asarray(jst["fx_delay"].ring.buf)).max() > 1e-3
    assert np.abs(tout.numpy() - jout).max() <= OUT_TOL
    worst, where = max_state_err(jst, tst)
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
               "fbws_bank": 1, "ws4_bank": 2, "linrec2_bank": 5, "triangle_additive_bank": 1}


def test_kit_with_bus_goes_through_every_kernel_wrapper(monkeypatch):
    """The eight voice wrappers, and the four-effect bus as one run: one
    ``bus_chain`` a block, as the JAX engine merges the run on the TPU."""
    assert _count_wrapper_calls(monkeypatch) == dict(
        VOICE_CALLS, saturation_block=0, lowpass_block=0, tilt_block=0, delay_block=0,
        bus_chain=1)


def test_unmerged_bus_goes_through_each_effect_wrapper(monkeypatch):
    """With ``fuse_bus=False`` each effect launches its own kernel once a
    block (the JAX engine's per-effect path, as for a lone effect)."""
    assert _count_wrapper_calls(monkeypatch, fuse_bus=False) == dict(
        VOICE_CALLS, saturation_block=1, lowpass_block=1, tilt_block=1, delay_block=1,
        bus_chain=0)
