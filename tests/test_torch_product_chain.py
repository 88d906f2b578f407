"""The product block's effect chain (mixer/chain.py), port against the JAX
package on the CPU.

* the host API of ``EffectChain`` on the same calls;
* the waveshaper's and the feedback waveshaper's blocks (``waveshaper_block``,
  ``env_follower_block`` + ``fbws_fast_block``, here their plain versions)
  against the JAX package's Pallas wrappers in interpret mode and its XLA
  paths, bypassed, engaged, and across a bypassed block (the state hold);
* ``process_chain`` of ``bench_configs.bench_onchip_product_block``'s nine
  entries (lowpass, delay, saturation, compressor, tilt, spring,
  waveshaper, feedback waveshaper, plate) against the JAX package's, 3
  blocks, at the default targets (the two waveshapers bypassed) and engaged;
* the merged run of the first eight entries, ten ``bus_chain`` phases,
  bit for bit against the per-entry path;
* the run splitting around the plate and a feedback waveshaper with its
  feedback on (the general per-sample loop).

Bounds: output 2e-5 and state 1e-4 relative to the leaf's magnitude where
it exceeds 1 (tests/test_torch_bus_chain.py's) for the two waveshapers;
the whole chain 1e-4 / 1e-4 (the plate's, tests/test_torch_bus.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libgooey_tpu.effects import feedback_waveshaper as jfbws
from libgooey_tpu.effects import freeze as jfreeze
from libgooey_tpu.mixer import chain as jchain
from libgooey_tpu.ops import pallas_fx

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.mixer import chain as tchain
from libgooey_tpu_torch.ops import bus_kernels

from test_torch_bus import max_state_err

SR = 44100.0
B = 128
N = 3
OUT_TOL = 2e-5
STATE_TOL = 1e-4
CHAIN_TOL = 1e-4

#: bench_onchip_product_block's chain order (bench_configs.py:540-579)
PRODUCT = (jchain.EFFECT_LOWPASS_FILTER, jchain.EFFECT_DELAY, jchain.EFFECT_SATURATION,
           jchain.EFFECT_COMPRESSOR, jchain.EFFECT_TILT_FILTER, jchain.EFFECT_REVERB,
           jchain.EFFECT_WAVESHAPER, jchain.EFFECT_FEEDBACK_WAVESHAPER,
           jchain.EFFECT_PLATE_REVERB)
#: the two waveshapers engaged
ENGAGED = {jchain.EFFECT_WAVESHAPER: [4.0, 0.5],
           jchain.EFFECT_FEEDBACK_WAVESHAPER: [4.0, 0.0, 2000.0, 1.0]}


def _input(seed, n=N * B, scale=0.8):
    return np.random.RandomState(seed).uniform(-scale, scale, (2, n)).astype(np.float32)


def _leaves_err(ja, tb):
    return max_state_err({"s": ja}, {"s": tb})


def test_effect_chain_host_api_matches_jax():
    j, t = jchain.EffectChain(SR, 120.0), tchain.EffectChain(SR, 120.0, device="cpu")
    calls = ([("add", eid) for eid in range(10)]
             + [("set_param", 1, 0, 3), ("set_param", 1, 4, 1.0), ("set_param", 7, 0, 4.0),
                ("set_param", 9, 1, 0.3), ("move", 0, 5), ("move", 8, 2), ("move", 3, 12),
                ("remove", 4), ("remove", 20), ("set_bpm", 90.0), ("set_param", 40, 0, 1.0)])
    for name, *args in calls:
        assert getattr(t, name)(*args) == getattr(j, name)(*args), (name, args)
        assert t.order() == j.order()
        assert t.static_key() == j.static_key()
        for a, b in zip(j.targets_list(), t.targets_list()):
            assert np.array_equal(np.asarray(a), b)
    for i in range(len(j.entries)):
        for p in range(len(j.entries[i].targets) + 1):
            if p < len(j.entries[i].targets) or j.entries[i].effect_id == jchain.EFFECT_DELAY:
                assert t.get_param(i, p) == j.get_param(i, p)
    j.clear()
    t.clear()
    assert t.order() == j.order() == ()


def _ws_pallas(state, x, tg):
    """The JAX waveshaper entry's TPU branch (mixer/chain.py), interpreted."""
    zeros = jnp.zeros(2, jnp.float32)
    y, nst = pallas_fx.waveshaper_block(x, tg[0], tg[1],
                                        pallas_fx.pack_ovs4_dc(state, zeros, zeros),
                                        interpret=True)
    new, _, _, _ = pallas_fx.unpack_ovs4_dc(nst, state)
    return jfreeze.hold_where((tg[1] <= 1e-4) | (tg[0] <= 1.0), state, new), y


#: per-block targets: bypassed, engaged, engaged across a bypassed block
SEQS = {
    jchain.EFFECT_WAVESHAPER: {"bypassed": [[1.0, 0.0]], "engaged": [[4.0, 0.5], [3.0, 0.8]],
                               "hold": [[4.0, 0.5], [1.0, 0.5], [6.0, 0.3]]},
    jchain.EFFECT_FEEDBACK_WAVESHAPER: {
        "bypassed": [[1.0, 0.0, 2000.0, 0.0]],
        "engaged": [[4.0, 0.0, 2000.0, 1.0], [8.0, 0.0, 500.0, 0.7]],
        "hold": [[4.0, 0.0, 2000.0, 1.0], [4.0, 0.0, 2000.0, 0.0], [2.0, 0.0, 3000.0, 1.0]]},
}


@pytest.mark.parametrize("path", ["pallas", "xla"])
@pytest.mark.parametrize("seq", ["bypassed", "engaged", "hold"])
@pytest.mark.parametrize("eid", [jchain.EFFECT_WAVESHAPER, jchain.EFFECT_FEEDBACK_WAVESHAPER])
def test_waveshaper_entries_match_jax(eid, seq, path):
    targets = SEQS[eid][seq]
    x = _input(3 + eid, scale=1.2)
    jst = jchain._init_device_state(eid, SR)
    if eid == jchain.EFFECT_WAVESHAPER:   # a warm history, so a hold shows
        jst = jst._replace(up1=jst.up1._replace(ap0=jnp.full((2, 4), 0.1)))
    tst = interop.chain_state_from_numpy(eid, jst, "cpu")
    prev = jfbws.IMPL
    jfbws.IMPL = path
    try:
        for i in range(N):
            tg = np.asarray(targets[min(i, len(targets) - 1)], np.float32)
            xb = x[:, i * B:(i + 1) * B]
            if eid == jchain.EFFECT_WAVESHAPER and path == "pallas":
                jst, jy = _ws_pallas(jst, jnp.asarray(xb), jnp.asarray(tg))
            else:
                jst, jy = jchain.process_entry(eid, jst, jnp.asarray(xb), jnp.asarray(tg),
                                               sample_rate=SR, pingpong=True)
            tst, ty = tchain.process_entry(eid, tst, torch.from_numpy(xb.copy()), tg,
                                           sample_rate=SR, pingpong=True)
            jy = np.asarray(jy)
            assert np.abs(jy - ty.numpy()).max() <= OUT_TOL, (i, np.abs(jy - ty.numpy()).max())
            worst, where = _leaves_err(jst, tst)
            assert worst <= STATE_TOL, f"block {i}: {worst} at {where}"
            if seq == "bypassed":
                assert np.array_equal(ty.numpy(), xb)
    finally:
        jfbws.IMPL = prev


def _chains(engaged, keys=PRODUCT, feedback=None):
    j = jchain.EffectChain(SR, 120.0)
    t = tchain.EffectChain(SR, 120.0, device="cpu")
    for eid in keys:
        j.add(eid)
        t.add(eid)
    for i, eid in enumerate(keys):
        vals = ENGAGED.get(eid) if engaged else None
        if eid == jchain.EFFECT_FEEDBACK_WAVESHAPER and feedback is not None:
            vals = [4.0, feedback, 2000.0, 1.0]
        for p, v in enumerate(vals or ()):
            j.set_param(i, p, v)
            t.set_param(i, p, v)
    assert t.static_key() == j.static_key()
    return j, t


def _run_chain(j, t, seed, fuse_runs=True):
    x = _input(seed)
    jst, tst = list(j.states), [interop.chain_state_from_numpy(e, s, "cpu")
                                for e, s in zip(j.order(), j.states)]
    worst_out = peak = 0.0
    for i in range(N):
        xb = x[:, i * B:(i + 1) * B]
        jst, jy = jchain.process_chain(jst, jnp.asarray(xb), j.targets_list(), j.static_key(),
                                       sample_rate=SR)
        tst, ty = tchain.process_chain(tst, torch.from_numpy(xb.copy()), t.targets_list(),
                                       t.static_key(), sample_rate=SR, fuse_runs=fuse_runs)
        jy = np.asarray(jy)
        peak = max(peak, float(np.abs(jy).max()))
        worst_out = max(worst_out, float(np.abs(jy - ty.numpy()).max()))
    return worst_out, peak, jst, tst


@pytest.mark.parametrize("engaged", [False, True])
def test_product_chain_matches_jax(engaged):
    j, t = _chains(engaged)
    worst_out, peak, jst, tst = _run_chain(j, t, 11)
    assert peak > 0.05
    assert worst_out <= CHAIN_TOL, worst_out
    for eid, a, b in zip(j.order(), jst, tst):
        worst, where = _leaves_err(a, b)
        assert worst <= CHAIN_TOL, f"entry {eid}: {worst} at {where}"


def _record_chains(monkeypatch):
    runs = []
    real = bus_kernels.bus_chain
    monkeypatch.setattr(bus_kernels, "bus_chain",
                        lambda x, phases: runs.append([p.name for p in phases]) or real(x, phases))
    return runs


@pytest.mark.parametrize("engaged", [False, True])
def test_ten_phase_run_equals_per_entry_path(engaged, monkeypatch):
    """The first eight entries in one bus_chain of ten phases give what the
    entries' own paths give, bit for bit; the plate runs alone."""
    _, t = _chains(engaged)
    runs = _record_chains(monkeypatch)
    x = _input(12)
    merged = [tchain._init_device_state(e, SR, "cpu") for e in t.order()]
    single = list(merged)
    for i in range(N):
        xb = torch.from_numpy(x[:, i * B:(i + 1) * B].copy())
        merged, ym = tchain.process_chain(merged, xb, t.targets_list(), t.static_key(),
                                          sample_rate=SR)
        single, ys = tchain.process_chain(single, xb, t.targets_list(), t.static_key(),
                                          sample_rate=SR, fuse_runs=False)
        assert torch.equal(ym, ys), i
    assert runs == [["lowpass_block", "delay_block", "saturation_block", "env_follower_block",
                     "compressor_block", "tilt_block", "spring_block", "waveshaper_block",
                     "env_follower_block", "fbws_fast_block"]] * N
    for a, b in zip(merged, single):
        for u, v in zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)):
            assert torch.equal(u, v)


def test_runs_split_around_plate_and_general_feedback(monkeypatch):
    """lowpass | plate | delay | fbws with feedback on | saturation, tilt:
    one run of two; the rest alone, the feedback waveshaper on its general
    per-sample loop; the output against the JAX package's chain."""
    keys = (jchain.EFFECT_LOWPASS_FILTER, jchain.EFFECT_PLATE_REVERB, jchain.EFFECT_DELAY,
            jchain.EFFECT_FEEDBACK_WAVESHAPER, jchain.EFFECT_SATURATION,
            jchain.EFFECT_TILT_FILTER)
    j, t = _chains(False, keys, feedback=0.3)
    assert not t.static_key()[3][1]
    runs = _record_chains(monkeypatch)
    worst_out, peak, jst, tst = _run_chain(j, t, 13)
    assert runs == [["saturation_block", "tilt_block"]] * N
    assert peak > 0.05
    assert worst_out <= CHAIN_TOL, worst_out
    for eid, a, b in zip(j.order(), jst, tst):
        worst, where = _leaves_err(a, b)
        assert worst <= CHAIN_TOL, f"entry {eid}: {worst} at {where}"
