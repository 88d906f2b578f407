"""The engine's mix (one ``mix_bank`` over the voice matrix) against the
JAX package's ``_render_all`` with each of its two mixes: its
``MIX_IMPL = "pallas"`` (set here, not in the JAX package; its
``pallas_fx.mix_bank`` runs in interpret mode), and its default per-family
mix, which it also keeps below 8 voices.  One kick bank, pan and gain
smoothers moving, 2 blocks, on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libgooey_tpu.core.smoother import SmootherBank as JSmootherBank
from libgooey_tpu.engine import engine as jengine

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.core.smoother import smoothing_coeff
from libgooey_tpu_torch.engine import engine as tengine
from libgooey_tpu_torch.ops import bank_kernels

SR = 44100.0
B = 128
N = 2


def _static(V):
    return dict(kinds=("kick",), sample_rate=SR, block_size=B, smooth_coeff=smoothing_coeff(SR),
                limiter_threshold=1.0,
                family_static=(("kick", (("feedback_path", False), ("max_harmonics", 0))),))


def _jax_state(V, pan_step=None):
    """Kick presets in turn; pans sweeping to their mirror image and gains
    moving (both smoothers unsettled), as tests/test_torch_kit.py holds
    them; one voice within the settle snap.  ``pan_step``: every pan
    ``pan_step`` from its target instead."""
    mod = jengine.FAMILIES["kick"]
    presets = sorted(k for k in mod.PRESETS if k != "default")
    targets = np.stack([mod.PRESETS[presets[v % len(presets)]]().as_array() for v in range(V)])
    pan = np.linspace(0.1, 0.9, V).astype(np.float32)
    pan_tgt = pan[::-1].copy()
    pan_tgt[0] = pan[0] + 5e-5
    if pan_step is not None:
        pan_tgt = pan + np.float32(pan_step)
    gain = np.full(V, 2.0 / V, np.float32)
    return {"kick": mod.init_state(V, targets=targets),
            "pan": JSmootherBank(current=jnp.asarray(pan), target=jnp.asarray(pan_tgt)),
            "gain": JSmootherBank(current=jnp.asarray(gain), target=jnp.asarray(0.5 * gain)),
            "master": JSmootherBank.init(np.float32(0.5))}


def _events(V):
    rs = np.random.RandomState(12)
    return [{"block_start": np.int32(i * B),
             "kick_off": np.where(rs.rand(V) < 0.7, rs.randint(0, B, V), B).astype(np.int32),
             "kick_vel": rs.uniform(0.4, 1.0, V).astype(np.float32)} for i in range(N)]


def _port(state, events, V):
    outs, monos = [], []
    for ev in events:
        state, out, mono = tengine._render_all(state, ev, **_static(V))
        outs.append(out.numpy())
        monos.append(mono.numpy())
    return state, np.stack(outs), np.stack(monos)


def _jax(V, pan_step=None):
    jstate = _jax_state(V, pan_step)
    step = jax.jit(functools.partial(jengine._render_all, **_static(V)))
    outs, monos = [], []
    for ev in _events(V):
        jstate, out, mono = step(jstate, {k: jnp.asarray(v) for k, v in ev.items()})
        outs.append(np.asarray(out))
        monos.append(np.asarray(mono))
    return jstate, np.stack(outs), np.stack(monos)


@pytest.mark.parametrize("V,jax_mix,pan_step", [
    (12, "pallas", None), (12, "xla", None), (5, "pallas", None),
    # every pan just inside and just outside the settle snap (|step·q| vs
    # SMOOTHER_SETTLE_EPS = 1e-4): the JAX per-family mix takes its
    # settled-pan branch on the first, its per-sample branch on the second
    (12, "xla", 0.99e-4), (12, "xla", 1.01e-4 / 0.998)])
def test_mix_matches_jax(monkeypatch, V, jax_mix, pan_step):
    """The JAX fused mix at 12 voices, its per-family mix at 12, at 5
    voices (``total_v < 8``, engine.py:357: the JAX package keeps its
    per-family mix there) and at the settle snap's edge: one ``mix_bank`` a
    block, stereo and mono within 1e-5, the advanced pan and gain smoothers
    within 1e-6."""
    monkeypatch.setattr(jengine, "MIX_IMPL", jax_mix)
    jstate, jout, jmono = _jax(V, pan_step)
    tstate = interop.engine_state_from_numpy(_jax_state(V, pan_step), "cpu")
    calls = []
    real = bank_kernels.mix_bank
    monkeypatch.setattr(bank_kernels, "mix_bank",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tstate, tout, tmono = _port(tstate, _events(V), V)
    assert len(calls) == N
    assert np.abs(jout).max() > 1e-3
    assert np.abs(tout - jout).max() <= 1e-5
    assert np.abs(tmono - jmono).max() <= 1e-5
    for name in ("pan", "gain"):
        for a, b in zip(jstate[name], tstate[name]):
            assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-6, name
