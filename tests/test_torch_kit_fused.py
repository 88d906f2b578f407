"""The port's kit path (ops/voice.py) against the JAX package's fused
voice-bank path, family by family, on the CPU.

Each family's fused wrapper of the port (``voice.IMPL = "pallas"``: on the
CPU the kit kernels' plain versions) renders 3 blocks of 128 samples at V =
5 with the offsets of tests/test_pallas_voice.py, from the same state
(``interop``) as the JAX wrapper, which runs its Pallas bodies in interpret
mode.  tom2 is compared through ``render_block(fused=True)`` on both sides,
the JAX one jitted (its double mtof amplifies an ulp of XLA's eager exp2).

Bounds (tests/test_pallas_voice.py's): output <= 3e-5, every carried state
leaf <= 4e-4 by name.  The Pallas bodies solve the linear recurrences with
lane scans, the port sample by sample.
"""

import contextlib
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libgooey_tpu.core.smoother import SmootherBank as JSmootherBank
from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.instruments import bass as jbass
from libgooey_tpu.instruments import hihat2 as jhihat2
from libgooey_tpu.instruments import kick as jkick
from libgooey_tpu.instruments import snare as jsnare
from libgooey_tpu.instruments import tom2 as jtom2
from libgooey_tpu.ops import pallas_voice as pv

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.instruments import bass, hihat2, kick, snare, tom2
from libgooey_tpu_torch.ops import voice, voice_kernels

from test_torch_slice import _max_state_err

SR = 44100.0
B = 128
V = 5
COEFF = smoothing_coeff(SR)
OUT_TOL = 3e-5
STATE_TOL = 4e-4
OFFS = [np.array([0, 40, B, 3, 100], np.int32),
        np.array([B, B, 17, B, B], np.int32),
        np.array([5, B, B, B, 0], np.int32)]
VELS = np.array([1.0, 0.8, 0.5, 0.3, 0.9], np.float32)

#: (JAX module, port module, fused wrapper name, kwargs, param clamps,
#: seed); the clamps keep the snare's Chamberlin off its unstable corner
FAMILIES = {
    "kick": (jkick, kick, "kick_render_fused", dict(max_harmonics=32), {}, 1),
    "snare": (jsnare, snare, "snare_render_fused", dict(max_harmonics=32),
              {"filter_cutoff": (0.0, 0.7), "filter_resonance": (0.0, 0.6)}, 2),
    "hihat2": (jhihat2, hihat2, "hihat2_render_fused", {}, {}, 3),
    "bass": (jbass, bass, "bass_render_fused", {}, {}, 4),
}


@contextlib.contextmanager
def impl(value):
    prev = voice.IMPL
    voice.IMPL = value
    try:
        yield
    finally:
        voice.IMPL = prev


def _mk_state(mod, rng, clamps, overdrive=None):
    targets = rng.uniform(0, 1, (V, mod.NUM_PARAMS)).astype(np.float32)
    cur = np.clip(targets + rng.normal(0, 0.2, targets.shape), 0, 1).astype(np.float32)
    for name, (lo, hi) in clamps.items():
        i = mod.PARAM_INDEX[name]
        targets[:, i] = np.clip(targets[:, i], lo, hi)
        cur[:, i] = np.clip(cur[:, i], lo, hi)
    if overdrive is not None:   # one voice's drive held off: its bypass freeze
        i = mod.PARAM_INDEX["overdrive"]
        targets[overdrive, i] = cur[overdrive, i] = 0.0
    st = mod.init_state(V, targets=targets)
    return st._replace(params=JSmootherBank(current=jnp.asarray(cur), target=jnp.asarray(targets)))


def _with_statics(kind, st):
    if kind == "snare":
        return st._replace(filter_type=jnp.asarray([0, 1, 2, 3, 1], jnp.int32))
    if kind == "hihat2":
        return st._replace(noise_color=jnp.asarray([0, 1, 0, 1, 0], jnp.int32),
                           filter_slope=jnp.asarray([1, 0, 1, 0, 1], jnp.int32))
    return st


@pytest.mark.parametrize("kind", sorted(FAMILIES))
def test_fused_wrapper_matches_jax(kind):
    jmod, tmod, name, kw, clamps, seed = FAMILIES[kind]
    rng = np.random.default_rng(seed)
    jst = _with_statics(kind, _mk_state(jmod, rng, clamps, overdrive=2 if kind != "hihat2"
                                        else None))
    tst = interop.family_state_from_numpy(kind, jst, "cpu")
    jfused, tfused = getattr(pv, name), getattr(voice, name)
    peak = 0.0
    with impl("pallas"):
        for blk, off in enumerate(OFFS):
            start = np.int32(blk * B)
            jst, jout = jfused(jst, off, VELS, start, sample_rate=SR, block_size=B,
                               smooth_coeff=COEFF, interpret=True, **kw)
            tst, tout = tfused(tst, off, VELS, start, sample_rate=SR, block_size=B,
                               smooth_coeff=COEFF, **kw)
            jout = np.asarray(jout)
            peak = max(peak, float(np.abs(jout).max()))
            assert np.abs(tout.numpy() - jout).max() <= OUT_TOL, (kind, blk)
            worst, where = _max_state_err(jst, tst)
            assert worst <= STATE_TOL, f"{kind} block {blk}: {worst} at {where}"
    assert peak > 1e-3


def test_bass_note_freq_matches_jax():
    """Per-step notes reach the kit path's trigger snapshot."""
    rng = np.random.default_rng(11)
    jst = _mk_state(jbass, rng, {})
    tst = interop.family_state_from_numpy("bass", jst, "cpu")
    off = np.array([0, 7, B, 60, B], np.int32)
    nfq = np.array([55.0, 110.0, 0.0, 0.0, 220.0], np.float32)
    kw = dict(sample_rate=SR, block_size=B, smooth_coeff=COEFF, note_freq=nfq)
    jst, jout = pv.bass_render_fused(jst, off, VELS, np.int32(0), interpret=True, **kw)
    with impl("pallas"):
        tst, tout = voice.bass_render_fused(tst, off, VELS, np.int32(0), **kw)
    assert np.abs(tout.numpy() - np.asarray(jout)).max() <= OUT_TOL
    assert np.array_equal(tst.trig_freq.numpy(), np.asarray(jst.trig_freq))


def test_tom2_fused_matches_jax():
    targets = (np.random.default_rng(42).uniform(0, 1, (V, jtom2.NUM_PARAMS)) * 100.0
               ).astype(np.float32)
    targets[:, jtom2.PARAM_INDEX["tuning"]] /= 100.0
    targets[0] = jtom2.Tom2Config.ring().as_array()     # membrane-heavy
    targets[1] = jtom2.Tom2Config.brush().as_array()    # high colour: fast rand~
    jst = jtom2.init_state(V, targets=targets)
    tst = interop.family_state_from_numpy("tom2", jst, "cpu")
    static = dict(sample_rate=SR, block_size=B, smooth_coeff=COEFF, fused=True)
    prev = pv.IMPL
    pv.IMPL = "pallas"
    try:
        jrender = jax.jit(functools.partial(jtom2.render_block, **static))
        with impl("pallas"):
            for blk, off in enumerate(OFFS):
                start = np.int32(blk * B)
                jst, jout = jrender(jst, jnp.asarray(off), jnp.asarray(VELS), start)
                tst, tout = tom2.render_block(tst, off, VELS, start, **static)
                assert np.abs(tout.numpy() - np.asarray(jout)).max() <= OUT_TOL, blk
                worst, where = _max_state_err(jst, tst)
                assert worst <= STATE_TOL, f"block {blk}: {worst} at {where}"
    finally:
        pv.IMPL = prev


def _calls(monkeypatch):
    seen = []
    real = voice_kernels.kit_sources
    monkeypatch.setattr(voice_kernels, "kit_sources",
                        lambda phases: seen.append(len(phases)) or real(phases))
    return seen


@pytest.mark.parametrize("case", ["multi_trigger", "too_wide", "feedback_path", "auto_cpu",
                                  "eligible"])
def test_dispatch_gate(case, monkeypatch):
    """``[V, K]`` offsets, V > MAX_FUSED_VOICES and the kick's feedback path
    take the stage path, as does ``IMPL="auto"`` on a CPU tensor; a ``[V]``
    bank under ``IMPL="pallas"`` takes the kit path."""
    nv = voice.MAX_FUSED_VOICES + 1 if case == "too_wide" else 3
    st = kick.init_state(nv, device="cpu")
    off = np.zeros((nv, 2) if case == "multi_trigger" else nv, np.int32)
    vel = np.ones(off.shape, np.float32)
    seen = _calls(monkeypatch)
    kw = dict(sample_rate=SR, block_size=B, smooth_coeff=COEFF, max_harmonics=0,
              feedback_path=False)
    if case == "feedback_path":
        kw["feedback_path"] = True
    with impl("auto" if case == "auto_cpu" else "pallas"):
        kick.render_block(st, off, vel, np.int32(0), **kw)
    assert seen == ([1] if case == "eligible" else [])
