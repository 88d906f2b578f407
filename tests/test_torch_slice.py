"""The port's kick-bank slice against the JAX package on the CPU.

The slice is the engine's main path for one family: the kick bank's stage
path (``render_block``), the per-family pan/gain mix, the master gain and the
pinned soft limiter (``fx_order=()``), rendered block by block through
``render_many``.  The JAX side runs its own stage path on the JAX CPU
backend; both start from the same state (carried across with ``interop``)
and take the same numpy events.

Bounds: stereo output <= 1e-4 (the -80 dBFS bar of tests/test_kick.py);
every carried state leaf <= 4e-4 (the bound tests/test_pallas_voice.py
holds the TPU's fused kernels to against the same twin).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from libgooey_tpu.core.smoother import SmootherBank as JSmootherBank
from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.engine import engine as jengine
from libgooey_tpu.instruments import kick as jkick

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.engine import engine as tengine
from libgooey_tpu_torch.ops import bank_kernels

SR = 44100.0
B = 128
V = 8
OUT_TOL = 1e-4
STATE_TOL = 4e-4

STATIC = dict(kinds=("kick",), sample_rate=SR, block_size=B,
              smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
              family_static=(("kick", (("feedback_path", False),
                                       ("max_harmonics", 0))),))


def _jax_state(pan_moving=True):
    """Per-voice presets on the bench kit's mixer setup; ``pan_moving``
    leaves a pan move settling (the mix's per-sample branch), else the pans
    are settled (the per-lane branch)."""
    presets = [jkick.KickConfig.tight, jkick.KickConfig.punch_preset,
               jkick.KickConfig.loose, jkick.KickConfig.dirt]
    targets = np.stack([presets[v % 4]().as_array() for v in range(V)])
    pan = np.linspace(0.2, 0.8, V).astype(np.float32)
    return {
        "kick": jkick.init_state(V, targets=targets),
        "pan": JSmootherBank(current=jnp.asarray(pan),
                             target=jnp.asarray(pan[::-1].copy() if pan_moving else pan)),
        "gain": JSmootherBank.init(np.full(V, 1.0 / V, np.float32)),
        "master": JSmootherBank.init(np.float32(0.25)),
    }


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{f}")
    else:
        yield path, np.asarray(tree)


def _max_state_err(jax_state, port_state):
    """Worst |a-b| over all state leaves, matched by name; names the leaf."""
    ja = dict(_leaves(jax_state))
    tb = dict(_leaves(interop.to_numpy(port_state)))
    assert ja.keys() == tb.keys()
    worst, where = 0.0, None
    for k in ja:
        e = float(np.max(np.abs(ja[k].astype(np.float64) - tb[k].astype(np.float64))))
        assert np.isfinite(e), k
        if e > worst:
            worst, where = e, k
    return worst, where


def _run_both(events, pan_moving=True):
    jstate = _jax_state(pan_moving)
    tstate = interop.engine_state_from_numpy(jstate, "cpu")
    jst, jout = jengine.render_many(
        jstate, {k: jnp.asarray(v) for k, v in events.items()}, **STATIC)
    tst, tout = tengine.render_many(tstate, events, **STATIC)
    return jst, np.asarray(jout), tst, tout.numpy()


@pytest.mark.parametrize("pan_moving", [True, False])
def test_render_many_matches_jax(pan_moving):
    """4 blocks with staggered triggers, including a mid-block retrigger of
    a sounding voice and triggers on the block's first and last samples."""
    N = 4
    offs = np.full((N, V), B, np.int32)
    vels = np.zeros((N, V), np.float32)
    offs[0, :5] = [0, 17, 64, 100, 127]
    vels[0, :5] = [1.0, 0.5, 0.8, 0.3, 0.9]
    offs[1, 5:7] = [3, 90]
    vels[1, 5:7] = [0.6, 1.0]
    offs[2, 1] = 60            # retrigger while voice 1 still sounds
    vels[2, 1] = 0.7
    offs[3, [0, 7]] = [40, 0]
    vels[3, [0, 7]] = [0.4, 0.2]
    events = {"kick_off": offs, "kick_vel": vels,
              "block_start": (np.arange(N) * B).astype(np.int32)}
    jst, jout, tst, tout = _run_both(events, pan_moving)
    assert tout.shape == (N, 2, B)
    assert np.abs(jout).max() > 1e-3
    assert np.abs(tout - jout).max() <= OUT_TOL
    worst, where = _max_state_err(jst, tst)
    assert worst <= STATE_TOL, f"state divergence {worst} at {where}"


def test_multi_trigger_blocks_match_jax():
    """``[V, K]`` trigger slots: two triggers of one voice inside one block
    (the later one re-snapshots envelopes mid-block)."""
    N, K = 2, 2
    offs = np.full((N, V, K), B, np.int32)
    vels = np.zeros((N, V, K), np.float32)
    offs[0, 0] = [5, 70]
    vels[0, 0] = [0.9, 0.4]
    offs[0, 3] = [30, B]
    vels[0, 3] = [1.0, 0.0]
    offs[1, 0] = [0, 64]
    vels[1, 0] = [0.5, 1.0]
    offs[1, 6] = [12, 13]
    vels[1, 6] = [0.3, 0.8]
    events = {"kick_off": offs, "kick_vel": vels,
              "block_start": (np.arange(N) * B).astype(np.int32)}
    jst, jout, tst, tout = _run_both(events)
    assert np.abs(tout - jout).max() <= OUT_TOL
    worst, where = _max_state_err(jst, tst)
    assert worst <= STATE_TOL, f"state divergence {worst} at {where}"


def test_slice_goes_through_every_bank_wrapper(monkeypatch):
    """Each of the kick's five bank wrappers is on the slice's path (on the
    CPU they run their plain versions; on CUDA the same calls launch the
    kernels), and the mix; the kit's other three are not, at
    ``max_harmonics=0``."""
    calls = {n: 0 for n in bank_kernels.KERNELS}
    for n in bank_kernels.KERNELS:
        fn = getattr(bank_kernels, n)

        def counted(*a, _fn=fn, _n=n, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(bank_kernels, n, counted)
    state = interop.engine_state_from_numpy(_jax_state(), "cpu")
    events = {"kick_off": np.zeros((1, V), np.int32),
              "kick_vel": np.ones((1, V), np.float32),
              "block_start": np.zeros(1, np.int32)}
    tengine.render_many(state, events, **STATIC)
    assert calls == {"affine1_bank": 2, "pink_bank": 1, "svf_bank": 1,
                     "env_follow_bank": 1, "fbws_bank": 1, "ws4_bank": 0,
                     "linrec2_bank": 0, "triangle_additive_bank": 0, "mix_bank": 1}


@pytest.mark.parametrize("kw", [dict(kinds=("kick", "hihat")),
                                dict(lfo_routes=((0, "kick", 0, "frequency", 1.0),))])
def test_unported_bus_features_raise(kw):
    """The two engine features this test once expected to raise, now
    ported, against the JAX ``_render_all`` for 3 blocks: a hihat bank of 4
    beside the kicks (``kinds``), and an LFO at 0.8 Hz routed to kick 0's
    frequency (``lfo_routes``: one one-pole scan toward the LFO's targets,
    in place of the closed-form smoother).  State within 4e-4, relative to
    its magnitude where that exceeds 1."""
    from libgooey_tpu.instruments import hihat as jhihat

    jstate = _jax_state()
    if "hihat" in kw.get("kinds", ()):
        nh = 4
        jstate["hihat"] = jhihat.init_state(nh, jhihat.HiHatConfig.open_default())
        jstate["pan"] = JSmootherBank.init(np.linspace(0.1, 0.9, V + nh).astype(np.float32))
        jstate["gain"] = JSmootherBank.init(np.full(V + nh, 1.0 / V, np.float32))
    tstate = interop.engine_state_from_numpy(jstate, "cpu")
    static = {**STATIC, **kw}
    peak = 0.0
    for blk in range(3):
        events = {"kick_off": np.full(V, B, np.int32), "kick_vel": np.full(V, 0.9, np.float32),
                  "block_start": np.int32(blk * B)}
        if blk == 0:
            events["kick_off"][:4] = [0, 20, 77, 127]
        if "hihat" in static["kinds"]:
            events["hihat_off"] = np.array([3, B, 60, B] if blk != 1 else [B, 9, B, B],
                                           np.int32)
            events["hihat_vel"] = np.full(4, 0.7, np.float32)
        if static.get("lfo_routes"):
            events.update(lfo_phase=np.full(8, 0.1 + 0.01 * blk, np.float32),
                          lfo_inc=np.full(8, 0.8 / SR, np.float32),
                          lfo_amount=np.ones(8, np.float32), lfo_offset=np.zeros(8, np.float32))
        jstate, jout, _ = jengine._render_all_jit(
            jstate, {k: jnp.asarray(v) for k, v in events.items()}, **static)
        tstate, tout, _ = tengine._render_all(tstate, events, **static)
        jout = np.asarray(jout)
        peak = max(peak, float(np.abs(jout).max()))
        assert np.abs(tout.numpy() - jout).max() <= OUT_TOL, f"block {blk}"
        for path, a in _leaves(jstate):
            b = dict(_leaves(interop.to_numpy(tstate)))[path]
            err = np.max(np.abs(a.astype(np.float64) - b) / np.maximum(1.0, np.abs(a)),
                         initial=0.0)
            assert err <= STATE_TOL, f"block {blk}: {path} off by {err}"
    assert peak > 1e-3
