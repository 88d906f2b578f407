"""A run of bus effects in one launch, port against the JAX package's merged
chain on the CPU.

The port's ``effects/chain.process_run`` (one ``bus_chain`` launch on the
card, its plain version here) against ``pallas_chain.process_run``, the path
the JAX engine takes for a run of effects on the TPU, run in interpret mode
as tests/test_pallas_chain.py runs it.  Three blocks carry state from the
same start and take the same numpy inputs; targets change mid-stream (the
saturation crosses its bypass gate, the tilt crosses the center, the
compressor's threshold drops).  The longest run is the kit's bus up to the
plate: seven phases, the compressor's detector and gain stage among them.
Also the run against the port's own per-effect path, bit for bit, and the
engine's bus split into runs around the plate and a sidechained compressor,
merged or not.

Bounds: output 2e-5, the bound tests/test_pallas_chain.py holds the JAX
package's merged run to against its per-effect path; every state leaf, the
delay's ring included, 1e-4, relative to the leaf's magnitude where that
exceeds 1 (tests/test_torch_bus.py).  Measured with these inputs: the kit's
order 1.9e-6 output / 1.2e-6 state, the ping-pong run 1.2e-7 / 1.2e-7, the
seven-phase run 2.1e-7 / 8.9e-7 (the delay's ring).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libgooey_tpu.effects import compressor as jcompressor
from libgooey_tpu.effects import delay as jdelay
from libgooey_tpu.effects import lowpass as jlowpass
from libgooey_tpu.effects import reverb_spring as jspring
from libgooey_tpu.effects import saturation as jsaturation
from libgooey_tpu.effects import tilt as jtilt
from libgooey_tpu.ops import pallas_chain

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.core.smoother import SmootherBank, smoothing_coeff
from libgooey_tpu_torch.effects import chain
from libgooey_tpu_torch.engine import engine as tengine
from libgooey_tpu_torch.instruments import kick
from libgooey_tpu_torch.ops import bank_kernels, kernels

from test_torch_bus import max_state_err

SR = 44100.0
B = 256
N = 3
OUT_TOL = 2e-5
STATE_TOL = 1e-4

#: name -> (JAX module, port module, the JAX chain's effect id)
EFFECTS = {"saturation": (jsaturation, 2), "lowpass": (jlowpass, 0), "tilt": (jtilt, 4),
           "delay": (jdelay, 1), "compressor": (jcompressor, 3), "spring": (jspring, 6)}

#: (effects in order, init args, per-block targets, ping-pong, input seed)
CASES = {
    # the kit's order with every smoother moving
    "kit": (("saturation", "lowpass", "tilt", "delay"),
            {"saturation": (0.6, 0.5, 1.0), "lowpass": (2000.0, 0.8), "tilt": (0.25, 0.3),
             "delay": (0.015, 0.5, 0.4, 6000.0)},
            [{"saturation": (0.6, 0.5, 1.0), "lowpass": (2000.0, 0.8), "tilt": (0.25, 0.3),
              "delay": (0.015, 0.5, 0.4, 6000.0)},
             {"saturation": (0.2, 0.9, 0.0), "lowpass": (9000.0, 0.4), "tilt": (0.75, 0.6),
              "delay": (0.02, 0.6, 0.7, 3000.0)}], False, 5),
    # the delay first with ping-pong, then the tilt across the center and a
    # saturation that leaves its bypass gate
    "pingpong": (("delay", "tilt", "saturation"),
                 {"delay": (0.01, 0.7, 0.6, 6000.0), "tilt": (0.7, 0.2),
                  "saturation": (0.6, 0.5, 0.0)},
                 [{"delay": (0.01, 0.7, 0.6, 6000.0), "tilt": (0.3, 0.5),
                   "saturation": (0.6, 0.5, 0.0)},
                  {"delay": (0.01, 0.7, 0.6, 6000.0), "tilt": (0.3, 0.5),
                   "saturation": (0.4, 0.3, 0.9)}], True, 6),
    # the kit's bus up to the plate: seven phases in one launch
    "full": (("saturation", "lowpass", "tilt", "delay", "compressor", "spring"),
             {"saturation": (0.6, 0.5, 1.0), "lowpass": (6000.0, 0.5), "tilt": (0.3, 0.4),
              "delay": (0.005, 0.5, 0.4, 6000.0), "compressor": (-20.0, 4.0, 5.0, 80.0, 1.0),
              "spring": (0.5, 0.6, 0.4)},
             [{"saturation": (0.6, 0.5, 1.0), "lowpass": (6000.0, 0.5), "tilt": (0.3, 0.4),
               "delay": (0.005, 0.5, 0.4, 6000.0), "compressor": (-20.0, 4.0, 5.0, 80.0, 1.0),
               "spring": (0.5, 0.6, 0.4)},
              {"saturation": (0.6, 0.5, 1.0), "lowpass": (6000.0, 0.5), "tilt": (0.3, 0.4),
               "delay": (0.005, 0.5, 0.4, 6000.0), "compressor": (-30.0, 8.0, 1.0, 30.0, 0.8),
               "spring": (0.8, 0.5, 0.2)}], False, 7),
}


def _targets(seq, i, name):
    return np.asarray(seq[min(i, len(seq) - 1)][name], np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_matches_jax_merged_chain(case):
    names, init, seq, pingpong, seed = CASES[case]
    rs = np.random.RandomState(seed)
    x = rs.uniform(-0.8, 0.8, (2, N * B)).astype(np.float32)
    jst = [EFFECTS[n][0].init_state(SR, *init[n]) for n in names]
    tst = [interop.fx_state_from_numpy(n, s, "cpu") for n, s in zip(names, jst)]
    entries = [(EFFECTS[n][1], pingpong and n == "delay") for n in names]
    options = [{"pingpong": pingpong} if n == "delay" else {} for n in names]
    modules = [tengine.FX_MODULES[n] for n in names]
    worst_out = 0.0
    for i in range(N):
        xb = x[:, i * B:(i + 1) * B]
        tg = [_targets(seq, i, n) for n in names]
        jst, jy = pallas_chain.process_run(entries, jst, jnp.asarray(xb), tg, sample_rate=SR,
                                           interpret=True)
        tst, ty = chain.process_run(modules, tst, torch.from_numpy(xb.copy()), tg,
                                    sample_rate=SR, options=options)
        jy = np.asarray(jy)
        assert np.abs(jy).max() > 0.05
        worst_out = max(worst_out, float(np.abs(jy - ty.numpy()).max()))
    assert worst_out <= OUT_TOL, f"{case}: output error {worst_out}"
    worst, where = max_state_err(dict(zip(names, jst)), dict(zip(names, tst)))
    assert worst <= STATE_TOL, f"{case}: state error {worst} at {where}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_equals_the_per_effect_path(case):
    """One launch gives what each effect's own ``process_block`` gives, one
    after the other, bit for bit (here the plain versions; on the card the
    same row functions in one kernel or in one each)."""
    names, init, seq, pingpong, seed = CASES[case]
    rs = np.random.RandomState(seed)
    modules = [tengine.FX_MODULES[n] for n in names]
    st = [m.init_state(SR, *init[n], device="cpu") for m, n in zip(modules, names)]
    run_st, run_y = list(st), None
    options = [{"pingpong": pingpong} if n == "delay" else {} for n in names]
    for i in range(N):
        xb = torch.from_numpy(rs.uniform(-0.8, 0.8, (2, B)).astype(np.float32))
        tg = [_targets(seq, i, n) for n in names]
        run_st, run_y = chain.process_run(modules, run_st, xb, tg, sample_rate=SR,
                                          options=options)
        y, new = xb, []
        for m, s, t, kw in zip(modules, st, tg, options):
            s, y = m.process_block(s, y, t, sample_rate=SR, **kw)
            new.append(s)
        st = new
        assert torch.equal(run_y, y), i
    for a, b in zip(torch.utils._pytree.tree_leaves(run_st), torch.utils._pytree.tree_leaves(st)):
        assert torch.equal(a, b)


def test_engine_bus_merged_or_not_renders_the_same():
    """``render_many`` with the four-effect bus as one run and with
    ``fuse_bus=False`` (each effect its own kernel): the same audio and
    state, bit for bit."""
    V = 4
    rs = np.random.RandomState(8)
    fx = ("saturation", "lowpass", "tilt", "delay")
    targets = dict(tengine.FX_DEFAULT_TARGETS, tilt=[0.3, 0.4], delay=[0.005, 0.5, 0.4, 6000.0])
    state = {"kick": kick.init_state(V, device="cpu"),
             "pan": SmootherBank.init(np.linspace(0.2, 0.8, V), "cpu"),
             "gain": SmootherBank.init(np.full(V, 0.5), "cpu"),
             "master": SmootherBank.init(np.float32(0.5), "cpu")}
    for name in fx:
        state["fx_" + name] = tengine.FX_MODULES[name].init_state(SR, device="cpu")
    events = {"block_start": (np.arange(N) * 128).astype(np.int32),
              "kick_off": rs.randint(0, 256, (N, V)).astype(np.int32),
              "kick_vel": rs.uniform(0.5, 1.0, (N, V)).astype(np.float32)}
    for name in fx:
        events["fx_" + name] = np.tile(np.float32(targets[name]), (N, 1))
    static = dict(kinds=("kick",), sample_rate=SR, block_size=128,
                  smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
                  family_static=(("kick", (("feedback_path", False), ("max_harmonics", 0))),),
                  fx_order=fx)
    st_run, y_run = tengine.render_many(state, events, **static)
    st_one, y_one = tengine.render_many(state, events, fuse_bus=False, **static)
    assert float(y_run.abs().max()) > 1e-3
    assert torch.equal(y_run, y_one)
    for name in fx:
        for a, b in zip(torch.utils._pytree.tree_leaves(st_run["fx_" + name]),
                        torch.utils._pytree.tree_leaves(st_one["fx_" + name])):
            assert torch.equal(a, b)


#: fx orders and the kernel wrappers one block launches, with the compressor
#: keyed from its input (-1) or from voice 1
SPLITS = {
    # the plate splits the bus: three lone effects
    "plate_between": (("saturation", "plate", "lowpass"), -1,
                      dict(saturation_block=1, plate_block=1, lowpass_block=1)),
    # two runs around the plate
    "two_runs": (("saturation", "lowpass", "plate", "tilt", "compressor", "spring"), -1,
                 dict(bus_chain=2, plate_block=1)),
    # a sidechained compressor leaves its run: the tilt and the spring alone
    "sidechained": (("saturation", "lowpass", "plate", "tilt", "compressor", "spring"), 1,
                    dict(bus_chain=1, plate_block=1, tilt_block=1, env_follower_block=1,
                         compressor_block=1, spring_block=1)),
}


def _split_render(monkeypatch, order, sidechain, **kw):
    """Two blocks of four kicks through ``order``; returns (state, out,
    wrapper calls)."""
    V, Bs = 4, 128
    rs = np.random.RandomState(8)
    targets = dict(tengine.FX_DEFAULT_TARGETS, tilt=[0.3, 0.4], plate=[0.6, 0.5, 0.4, 0.0, 1.0, 0.0],
                   compressor=[-40.0, 6.0, 2.0, 60.0, 1.0])
    state = {"kick": kick.init_state(V, device="cpu"),
             "pan": SmootherBank.init(np.linspace(0.2, 0.8, V), "cpu"),
             "gain": SmootherBank.init(np.full(V, 0.5), "cpu"),
             "master": SmootherBank.init(np.float32(0.5), "cpu")}
    for name in order:
        state["fx_" + name] = tengine.FX_MODULES[name].init_state(SR, device="cpu")
    events = {"block_start": (np.arange(2) * Bs).astype(np.int32),
              "kick_off": rs.randint(0, 2 * Bs, (2, V)).astype(np.int32),
              "kick_vel": rs.uniform(0.5, 1.0, (2, V)).astype(np.float32)}
    for name in order:
        events["fx_" + name] = np.tile(np.float32(targets[name]), (2, 1))
    static = dict(kinds=("kick",), sample_rate=SR, block_size=Bs,
                  smooth_coeff=smoothing_coeff(SR), limiter_threshold=1.0,
                  family_static=(("kick", (("feedback_path", False), ("max_harmonics", 0))),),
                  fx_order=order, sidechain_voice=sidechain)
    calls = {n: 0 for n in kernels.KERNELS}
    for n in kernels.KERNELS:
        mod = kernels.module_of(n)

        def counted(*a, _fn=getattr(mod, n), _n=n, **k):
            calls[_n] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, n, counted)
    st, out = tengine.render_many(state, events, **static, **kw)
    monkeypatch.undo()
    return st, out, calls


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_bus_splits_into_runs_and_equals_the_per_effect_path(monkeypatch, split):
    """The engine's run loop: which kernels a block launches, and the same
    audio and state, bit for bit, with ``fuse_bus=False`` (every effect its
    own kernels)."""
    order, sidechain, per_block = SPLITS[split]
    st_run, y_run, calls = _split_render(monkeypatch, order, sidechain)
    bus = {n: c for n, c in calls.items() if c and n not in bank_kernels.KERNELS}
    assert bus == {n: 2 * c for n, c in per_block.items()}
    st_one, y_one, _ = _split_render(monkeypatch, order, sidechain, fuse_bus=False)
    assert float(y_run.abs().max()) > 1e-3
    assert torch.equal(y_run, y_one)
    for name in order:
        for a, b in zip(torch.utils._pytree.tree_leaves(st_run["fx_" + name]),
                        torch.utils._pytree.tree_leaves(st_one["fx_" + name])):
            assert torch.equal(a, b), name
