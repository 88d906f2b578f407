"""The port's hihat (v1) and tom (v1) banks against the JAX package and
against the per-sample numpy oracles, on the CPU.

Against JAX: both packages start from the same state (carried across with
``interop``), take the same numpy triggers (single-trigger blocks, a
``[V, K]`` block with two triggers on a voice, a retrigger, a block without
triggers) and render 4 blocks of 128 samples; with ``overrides`` a routed
parameter follows a seeded ``[V, B]`` trajectory, as an LFO route gives
it.  Every carried state leaf is compared by name.  The hihat's output
one-pole is ``affine1_bank``'s plain version here, the tom's punch
``triangle_additive_bank``'s.

Against the oracles (tests/hihat_oracle.py, tests/tom_oracle.py): the
cases of tests/test_hihat_tom_oracle.py, rendered through the port.

Bounds: audio <= 1e-4; every state leaf <= 4e-4, relative to its magnitude
where that exceeds 1 (the JAX one-pole is an associative scan on the CPU,
the port's a sequential walk).
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.instruments import hihat as jhihat
from libgooey_tpu.instruments import tom as jtom

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.instruments import hihat as thihat
from libgooey_tpu_torch.instruments import tom as ttom

from hihat_oracle import HiHatOracle
from test_hihat_tom_oracle import cfg_dict, run_oracle
from test_torch_bus import max_state_err
from tom_oracle import TomOracle

SR = 44100.0
B = 128
V = 8
OUT_TOL = 1e-4
STATE_TOL = 4e-4
COEFF = smoothing_coeff(SR)

#: family -> (JAX module, port module, presets, routed parameter, statics)
FAMILIES = {
    "hihat": (jhihat, thihat, ("closed_default", "open_default", "closed_tight",
                               "open_bright"), "decay", {}),
    "tom": (jtom, ttom, ("high", "mid", "low", "floor"), "frequency",
            {"max_harmonics": 128}),
}


def events():
    """4 blocks: staggered single triggers (a block's first and last sample
    included), a ``[V, K]`` block with two triggers on two voices, a
    retrigger of a sounding voice and a block without triggers."""
    offs = [np.full(V, B, np.int32) for _ in range(4)]
    vels = [np.zeros(V, np.float32) for _ in range(4)]
    offs[0][:5] = [0, 17, 64, 100, 127]
    vels[0][:5] = [1.0, 0.5, 0.8, 0.3, 0.9]
    offs[1] = np.full((V, 2), B, np.int32)
    vels[1] = np.zeros((V, 2), np.float32)
    offs[1][0], vels[1][0] = [5, 70], [0.9, 0.4]
    offs[1][5], vels[1][5] = [12, 13], [0.3, 0.8]
    offs[1][7], vels[1][7] = [40, B], [1.0, 0.0]
    offs[2][[1, 6]] = [60, 3]
    vels[2][[1, 6]] = [0.7, 0.6]
    return offs, vels


def routed_traj(rs, start):
    """A seeded ``[V, B]`` trajectory of a routed parameter: a slow sine per
    voice around ``start``, in [0, 1]."""
    n = np.arange(B, dtype=np.float32)
    phase = rs.uniform(0, 2 * np.pi, size=(V, 1)).astype(np.float32)
    return np.clip(start[:, None] + 0.3 * np.sin(phase + n * 0.02), 0.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_render_block_matches_jax(family, routed):
    jmod, tmod, presets, param, extra = FAMILIES[family]
    targets = np.stack([jmod.PRESETS[presets[v % 4]]().as_array() for v in range(V)])
    static = dict(sample_rate=SR, block_size=B, smooth_coeff=COEFF, **extra)
    jrender = jax.jit(functools.partial(jmod.render_block, **static))
    jst = jmod.init_state(V, targets=targets)
    if family == "hihat":
        jst = jst._replace(is_open=jnp.asarray([v % 2 for v in range(V)], jnp.float32))
    tst = interop.family_state_from_numpy(family, jst, "cpu")
    rs = np.random.RandomState(7)
    peak = 0.0
    for blk, (off, vel) in enumerate(zip(*events())):
        start = np.int32(blk * B)
        over = None
        if routed:
            over = {param: routed_traj(rs, targets[:, jmod.PARAM_INDEX[param]])}
        jst, jout = jrender(jst, jnp.asarray(off), jnp.asarray(vel), start,
                            overrides=over and {k: jnp.asarray(v) for k, v in over.items()})
        tst, tout = tmod.render_block(
            tst, off, vel, start, overrides=over and {k: torch.as_tensor(v) for k, v in over.items()},
            **static)
        jout = np.asarray(jout)
        peak = max(peak, float(np.abs(jout).max()))
        assert np.abs(tout.numpy() - jout).max() <= OUT_TOL, f"block {blk}"
        worst, where = max_state_err(jst, tst)
        assert worst <= STATE_TOL, f"block {blk}: state divergence {worst} at {where}"
    assert peak > 1e-2


# --- the per-sample oracles ------------------------------------------------------

OB = 512


def render_port(mod, config, n_samples, triggers, param_changes=None, **kw):
    """tests/test_hihat_tom_oracle.render_bank through the port: one voice,
    ``triggers`` {sample: velocity}, ``param_changes`` {sample: {param:
    target}} staged at the containing block's start."""
    state = mod.init_state(1, config, device="cpu")
    targets = np.broadcast_to(config.as_array(), (1, mod.NUM_PARAMS)).copy()
    out = []
    for start in range(0, n_samples, OB):
        for s, changes in (param_changes or {}).items():
            if start <= s < start + OB:
                for k, v in changes.items():
                    targets[:, mod.PARAM_INDEX[k]] = v
                state = state._replace(params=state.params.with_targets(targets))
        offs = sorted((t - start, v) for t, v in triggers.items() if start <= t < start + OB)
        off = np.full((1, max(len(offs), 1)), OB, np.int32)
        vel = np.zeros((1, max(len(offs), 1)), np.float32)
        for k, (o, v) in enumerate(offs):
            off[0, k], vel[0, k] = o, v
        if len(offs) <= 1:
            off, vel = off[:, 0], vel[:, 0]
        state, y = mod.render_block(state, off, vel, np.int32(start), sample_rate=SR,
                                    block_size=OB, smooth_coeff=COEFF, **kw)
        out.append(y[0].numpy())
    return np.concatenate(out)[:n_samples]


HIHAT_CASES = {
    "closed_retrigger": ("closed_default", {7: 0.8, 900: 1.0, 1400: 0.35}, None, 2048),
    "open": ("open_default", {11: 0.9}, None, 2048),
    "smoothing": ("closed_tight", {3: 1.0, 1100: 0.7},
                  {OB: {"filter": 0.9, "frequency": 0.8}, 3 * OB: {"volume": 0.3}}, 2560),
    # two triggers inside one block: the [V, K] path
    "two_in_a_block": ("closed_default", {40: 0.9, 300: 0.6}, None, 1024),
}


@pytest.mark.parametrize("case", sorted(HIHAT_CASES))
def test_hihat_matches_oracle(case):
    preset, trig, changes, n = HIHAT_CASES[case]
    cfg = thihat.PRESETS[preset]()
    got = render_port(thihat, cfg, n, trig, changes)
    oracle = HiHatOracle(cfg_dict(cfg, thihat.PARAM_NAMES), SR, coeff=COEFF,
                         is_open=cfg.is_open)
    want = run_oracle(oracle, n, trig, changes)
    assert np.abs(got - want).max() < OUT_TOL
    assert np.abs(got).max() > 0.01


TOM_CASES = {
    "retrigger": (dataclasses.replace(ttom.TomConfig.mid_tom(), punch=0.6, pitch_drop=0.7),
                  {90: 0.8, 1200: 1.0}, None, 2048),
    "smoothing": (ttom.TomConfig.low_tom(), {5: 1.0},
                  {OB: {"frequency": 0.6, "pitch_drop": 0.1}, 2 * OB: {"volume": 0.4}}, 1536),
    "two_in_a_block": (ttom.TomConfig.high_tom(), {20: 1.0, 400: 0.5}, None, 1024),
}


@pytest.mark.parametrize("case", sorted(TOM_CASES))
def test_tom_matches_oracle(case):
    cfg, trig, changes, n = TOM_CASES[case]
    got = render_port(ttom, cfg, n, trig, changes, max_harmonics=128)
    oracle = TomOracle(cfg_dict(cfg, ttom.PARAM_NAMES), SR, coeff=COEFF, max_harmonics=128)
    want = run_oracle(oracle, n, trig, changes)
    assert np.abs(got - want).max() < OUT_TOL
    assert np.abs(got).max() > 0.01


def test_interop_round_trips():
    """The hihat's and the tom's states go to numpy and back unchanged."""
    for mod, cfg in ((thihat, thihat.HiHatConfig.open_bright()),
                     (ttom, ttom.TomConfig.floor_tom())):
        st = mod.init_state(5, cfg, device="cpu")
        st = st._replace(velocity=torch.linspace(0.1, 0.9, 5))
        back = interop.family_state_from_numpy(mod.__name__.rsplit(".", 1)[1],
                                               interop.to_numpy(st), "cpu")
        for a, b in zip(torch.utils._pytree.tree_leaves(st),
                        torch.utils._pytree.tree_leaves(back)):
            assert a.dtype == b.dtype and torch.equal(a, b)
