"""The port's five-family kit against the JAX package on the CPU.

The kit is the voice half of the engine's main path
(``bench_configs.build_full_kit``) at a small width: kick, snare, hihat2,
tom2 and bass banks with the kit's statics (kick ``max_harmonics=0,
feedback_path=False``, snare ``max_harmonics=64``), the per-family pan/gain
mix, the master gain and the pinned soft limiter (``fx_order=()``),
rendered block by block through ``render_many``.  The JAX side runs its
stage paths on the JAX CPU backend; both start from the same state
(``interop``) and take the same numpy events.

Bounds: stereo output <= 1e-4, every carried state leaf <= 4e-4 (as
tests/test_torch_slice.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from libgooey_tpu.core.smoother import SmootherBank as JSmootherBank
from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.engine import engine as jengine

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.engine import engine as tengine
from libgooey_tpu_torch.ops import bank_kernels

from test_torch_slice import _max_state_err

SR = 44100.0
B = 128
N = 4
PER_FAMILY = {"kick": 3, "snare": 3, "hihat2": 3, "tom2": 2, "bass": 2}
V = sum(PER_FAMILY.values())
OUT_TOL = 1e-4
STATE_TOL = 4e-4

STATIC = dict(kinds=tuple(PER_FAMILY), sample_rate=SR, block_size=B,
              smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
              family_static=(("kick", (("feedback_path", False), ("max_harmonics", 0))),
                             ("snare", (("max_harmonics", 64),))))


def _jax_state():
    """Each family's presets in turn, the bench kit's mixer setup, with a
    pan move still settling (the mix's per-sample branch)."""
    state = {}
    for kind, vk in PER_FAMILY.items():
        mod = jengine.FAMILIES[kind]
        presets = sorted(k for k in mod.PRESETS if k != "default")
        targets = np.stack([mod.PRESETS[presets[v % len(presets)]]().as_array()
                            for v in range(vk)])
        state[kind] = mod.init_state(vk, targets=targets)
    pan = np.linspace(0.2, 0.8, V).astype(np.float32)
    state["pan"] = JSmootherBank(current=jnp.asarray(pan), target=jnp.asarray(pan[::-1].copy()))
    state["gain"] = JSmootherBank.init(np.full(V, 4.0 / V, np.float32))
    state["master"] = JSmootherBank.init(np.float32(0.25))
    return state


def _events(bass_notes=False):
    """Staggered triggers in every family, a retrigger, and (optionally)
    sequencer notes for the bass."""
    rs = np.random.RandomState(5)
    ev = {"block_start": (np.arange(N) * B).astype(np.int32)}
    for kind, vk in PER_FAMILY.items():
        offs = np.full((N, vk), B, np.int32)
        vels = np.zeros((N, vk), np.float32)
        for v in range(vk):
            blk = v % 2
            offs[blk, v] = rs.randint(0, B)
            vels[blk, v] = 0.5 + 0.5 * ((v % 7) / 6.0)
        offs[2, 0], vels[2, 0] = 33, 0.9           # retrigger while sounding
        ev[kind + "_off"], ev[kind + "_vel"] = offs, vels
    if bass_notes:
        ev["bass_freq"] = np.where(ev["bass_off"] < B, 55.0, 0.0).astype(np.float32)
    return ev


@pytest.mark.parametrize("bass_notes", [False, True])
def test_render_many_matches_jax(bass_notes):
    events = _events(bass_notes)
    jstate = _jax_state()
    tstate = interop.engine_state_from_numpy(jstate, "cpu")
    jst, jout = jengine.render_many(
        jstate, {k: jnp.asarray(v) for k, v in events.items()}, **STATIC)
    tst, tout = tengine.render_many(tstate, events, **STATIC)
    jout = np.asarray(jout)
    assert tout.shape == (N, 2, B)
    assert np.abs(jout).max() > 1e-3
    assert np.abs(tout.numpy() - jout).max() <= OUT_TOL
    worst, where = _max_state_err(jst, tst)
    assert worst <= STATE_TOL, f"state divergence {worst} at {where}"


def test_kit_goes_through_every_kernel_wrapper(monkeypatch):
    """All eight voice-bank wrappers and the mix are on the kit's path (on
    the CPU they run their plain versions; on CUDA the same calls launch the
    kernels)."""
    calls = {n: 0 for n in bank_kernels.KERNELS}
    for n in bank_kernels.KERNELS:
        fn = getattr(bank_kernels, n)

        def counted(*a, _fn=fn, _n=n, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(bank_kernels, n, counted)
    state = interop.engine_state_from_numpy(_jax_state(), "cpu")
    events = {k: v[:1] for k, v in _events().items()}
    tengine.render_many(state, events, **STATIC)
    # per block: kick 2 + hihat2 5 + tom2 13 + bass 6 affine1 (one-poles,
    # phase accumulators, cumsums, the envelope smoother, the ring follower);
    # the Chamberlin, hihat2's two biquads, tom2's band-pass and membrane
    assert calls == {"affine1_bank": 26, "pink_bank": 2, "svf_bank": 3,
                     "env_follow_bank": 1, "fbws_bank": 1, "ws4_bank": 2,
                     "linrec2_bank": 5, "triangle_additive_bank": 1, "mix_bank": 1}
