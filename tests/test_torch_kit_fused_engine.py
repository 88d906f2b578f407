"""The engine's kit gate: ``_render_all`` with every family of a small kit
through the two kit launches, against the JAX package's merged kit path,
on the CPU.

As tests/test_pallas_voice.py's ``test_kit_mega_path_matches_per_family``:
kick, snare and hihat2 at 4 voices, tom2 and bass at 3, the bench kit's
mixer, 2 chained blocks; the port with ``voice.IMPL = "pallas"`` (the kit
kernels' plain versions) against the JAX package with ``pallas_voice.IMPL =
"pallas"`` (its Pallas bodies in interpret mode, jitted), from the same
state (``interop``).  ``fused_banks=False`` keeps both off the kit path.

Bounds: stereo output <= 3e-5, every state leaf <= 4e-4 by name.
"""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libgooey_tpu.core.smoother import SmootherBank as JSmootherBank
from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.engine import engine as jengine
from libgooey_tpu.ops import pallas_voice as pv

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.engine import engine as tengine
from libgooey_tpu_torch.ops import voice, voice_kernels

from test_torch_slice import _max_state_err

SR = 44100.0
B = 128
PER_FAMILY = {"kick": 4, "snare": 4, "hihat2": 4, "tom2": 3, "bass": 3}
TOTAL = sum(PER_FAMILY.values())
OUT_TOL = 3e-5
STATE_TOL = 4e-4
STATIC = dict(kinds=tuple(PER_FAMILY), sample_rate=SR, block_size=B,
              smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
              family_static=(("kick", (("feedback_path", False), ("max_harmonics", 16))),
                             ("snare", (("max_harmonics", 16),))))


def _jax_state():
    state = {k: jengine.FAMILIES[k].init_state(v) for k, v in PER_FAMILY.items()}
    state["pan"] = JSmootherBank.init(np.linspace(0.2, 0.8, TOTAL).astype(np.float32))
    state["gain"] = JSmootherBank.init(np.full(TOTAL, 1.0 / TOTAL, np.float32))
    state["master"] = JSmootherBank.init(np.float32(0.25))
    return state


def _events():
    rng = np.random.default_rng(7)
    events = {"block_start": np.int32(0)}
    for k, v in PER_FAMILY.items():
        off = np.full(v, B, np.int32)
        off[: max(1, v // 2)] = rng.integers(0, B, max(1, v // 2))
        events[k + "_off"] = off
        events[k + "_vel"] = np.full(v, 0.9, np.float32)
    events["bass_freq"] = np.where(events["bass_off"] < B, 55.0, 0.0).astype(np.float32)
    return events


@contextlib.contextmanager
def _impl(value):
    prev_j, prev_t = pv.IMPL, voice.IMPL
    pv.IMPL = voice.IMPL = value
    try:
        yield
    finally:
        pv.IMPL, voice.IMPL = prev_j, prev_t


@pytest.mark.parametrize("fused_banks", [True, False])
def test_render_all_matches_jax(fused_banks, monkeypatch):
    seen = []
    real = voice_kernels.kit_sources
    monkeypatch.setattr(voice_kernels, "kit_sources",
                        lambda phases: seen.append([p.name for p in phases]) or real(phases))
    events = _events()
    jstate = _jax_state()
    tstate = interop.engine_state_from_numpy(jstate, "cpu")
    static = dict(STATIC, fused_banks=fused_banks)
    with _impl("pallas"):
        step = jax.jit(lambda s, ev: jengine._render_all(s, ev, **static))
        for blk in range(2):
            ev = dict(events, block_start=np.int32(blk * B))
            jstate, jout, _ = step(jstate, {k: jnp.asarray(v) for k, v in ev.items()})
            tstate, tout, _ = tengine._render_all(tstate, ev, **static)
            jout = np.asarray(jout)
            assert np.abs(tout.numpy() - jout).max() <= OUT_TOL, blk
            for k in PER_FAMILY:
                worst, where = _max_state_err(jstate[k], tstate[k])
                assert worst <= STATE_TOL, f"{k} block {blk}: {worst} at {where}"
    assert np.abs(jout).max() > 1e-3
    # one kit launch a block with all five families, or none
    assert seen == ([["kick_a", "snare_a", "hihat2", "tom2", "bass"]] * 2 if fused_banks
                    else [])
