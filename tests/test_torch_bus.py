"""The port's bus effects against the JAX package's modules on the CPU.

Each port effect (``libgooey_tpu_torch/effects/{saturation,lowpass,tilt,
delay,compressor,reverb_spring,reverb_plate}.py``) runs its
``process_block`` block by block from the same state
(carried across with ``interop``) and the same numpy inputs as the JAX
module, once against ``impl="xla"`` (the path the JAX engine takes on the
CPU) and once against ``impl="pallas"`` (the TPU kernel's body, in interpret
mode).  Targets move mid-stream as in tests/test_pallas_fx.py: the
saturation crosses its bypass gate, the tilt crosses the center, the delay's
time, feedback and cutoff change; the compressor (on loud bursts, also keyed
from a sidechain), the spring and the plate take tests/test_pallas_fx.py's
target sequences, the plate's size also jumping 1.0 -> 0.0.  Also the ring
buffer, the freeze helper and the knee against their JAX twins, and the
plate against tests/test_plate.py's per-sample numpy oracle.

Bounds, output: the tolerances tests/test_pallas_fx.py holds the JAX
package's two paths to (saturation 2e-5, delay 2e-5, tilt, lowpass,
compressor, spring and plate 1e-5); every state leaf, the delay's ring and
the plate's tank and predelay ring included: 1e-4, relative to the
leaf's magnitude where that exceeds 1 (the cutoff smoothers hold Hz: the JAX
package's two paths raise ``1 - coeff`` to the n-th power in two ways,
``exp(n log q)`` and ``q**n``, which differ by ~1e-5 of the value).
Measured with these inputs, output against xla / pallas: saturation 1.9e-5
/ 1.9e-6 (the JAX package's own two paths: 1.9e-5), lowpass 1.1e-7 /
1.1e-7, tilt 6.0e-7 / 5.7e-7, delay 6.3e-6 / 1.2e-7, compressor 9.5e-7 /
9.5e-7 (keyed from a sidechain 3.4e-7 / 2.5e-7), spring 4.5e-8 / 6.0e-8, plate
1.4e-7 / 1.4e-7 (the size jump 1.0e-6 / 1.0e-6, from its float64-rounded
size powers; with PyTorch's float32 ``pow`` it was 1.1e-5); worst state leaf
1.1e-5 (xla, the delay's smoothers) / 1.2e-6 (pallas), the new effects' 9.6e-7
(the compressor's envelope).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libgooey_tpu.effects import compressor as jcompressor
from libgooey_tpu.effects import delay as jdelay
from libgooey_tpu.effects import freeze as jfreeze
from libgooey_tpu.effects import lowpass as jlowpass
from libgooey_tpu.effects import reverb_plate as jplate
from libgooey_tpu.effects import reverb_spring as jspring
from libgooey_tpu.effects import saturation as jsaturation
from libgooey_tpu.effects import tilt as jtilt
from libgooey_tpu.ops import ringbuf as jringbuf

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.effects import compressor as tcompressor
from libgooey_tpu_torch.effects import delay as tdelay
from libgooey_tpu_torch.effects import freeze as tfreeze
from libgooey_tpu_torch.effects import lowpass as tlowpass
from libgooey_tpu_torch.effects import reverb_plate as tplate
from libgooey_tpu_torch.effects import reverb_spring as tspring
from libgooey_tpu_torch.effects import saturation as tsaturation
from libgooey_tpu_torch.effects import tilt as ttilt
from libgooey_tpu_torch.ops import ringbuf as tringbuf

from test_plate import plate_oracle
from test_torch_slice import _leaves

SR = 44100.0
B = 512
STATE_TOL = 1e-4

MODULES = {"saturation": (jsaturation, tsaturation), "lowpass": (jlowpass, tlowpass),
           "tilt": (jtilt, ttilt), "delay": (jdelay, tdelay),
           "compressor": (jcompressor, tcompressor), "spring": (jspring, tspring),
           "plate": (jplate, tplate)}
OUT_TOL = {"saturation": 2e-5, "lowpass": 1e-5, "tilt": 1e-5, "delay": 2e-5,
           "compressor": 1e-5, "spring": 1e-5, "plate": 1e-5}

#: (effect, init args, per-block targets, extra kwargs, input seed)
CASES = {
    # mix falls under the bypass gate mid-stream
    "saturation": ("saturation", (0.6, 0.5, 1.0),
                   [(0.6, 0.5, 1.0), (0.6, 0.5, 1.0), (0.2, 0.9, 0.7), (0.2, 0.9, 0.0)], {}, 3),
    # bypassed from the start (the oversampler history is held), then re-engaged
    "saturation_held": ("saturation", (0.6, 0.5, 0.0),
                        [(0.6, 0.5, 0.0), (0.6, 0.5, 0.0), (0.6, 0.5, 1.0)], {}, 4),
    "lowpass": ("lowpass", (2000.0, 0.8), [(2000.0, 0.8), (2000.0, 0.8), (12000.0, 0.3)],
                {}, 15),
    # LP region -> HP region across the center, then back to the center
    "tilt": ("tilt", (0.25, 0.3), [(0.25, 0.3), (0.25, 0.3), (0.75, 0.6), (0.5, 0.0)], {}, 11),
    # passthrough all along: the SVF state is held
    "tilt_held": ("tilt", (0.5, 0.0), [(0.5, 0.0)] * 3, {}, 12),
    "delay": ("delay", (0.02, 0.6, 0.8, 4000.0),
              [(0.02, 0.6, 0.8, 4000.0), (0.02, 0.6, 0.8, 4000.0), (0.05, 0.3, 0.5, 12000.0)],
              {}, 13),
    "delay_pingpong": ("delay", (0.015, 0.7, 1.0, 6000.0), [(0.015, 0.7, 1.0, 6000.0)] * 4,
                       {"pingpong": True}, 14),
    # over the threshold, then a harder setting, then the mix under the gate
    "compressor": ("compressor", (-20.0, 4.0, 5.0, 80.0, 1.0),
                   [(-20.0, 4.0, 5.0, 80.0, 1.0), (-20.0, 4.0, 5.0, 80.0, 1.0),
                    (-35.0, 10.0, 1.0, 30.0, 0.6), (-35.0, 10.0, 1.0, 30.0, 0.0)], {}, 5),
    # the detector keyed from another signal (bursts) while the gain acts on x
    "compressor_sidechain": ("compressor", (-30.0, 6.0, 2.0, 60.0, 1.0),
                             [(-30.0, 6.0, 2.0, 60.0, 1.0)] * 4, {"sidechain": True}, 9),
    "spring": ("spring", (0.5, 1.0, 0.4), [(0.5, 1.0, 0.4), (0.5, 1.0, 0.4), (0.9, 0.6, 0.1)],
               {}, 7),
    # decay/mix/damping/predelay/width/size; the size sweeps mid-stream
    "plate": ("plate", (0.6, 1.0, 0.4, 0.1, 1.0, 0.5),
              [(0.6, 1.0, 0.4, 0.1, 1.0, 0.5), (0.6, 1.0, 0.4, 0.1, 1.0, 0.5),
               (0.6, 1.0, 0.4, 0.1, 0.5, 0.9), (0.3, 0.8, 0.2, 0.0, 0.8, 0.2)], {}, 19),
    # the worst-case size jump, fully large to minimum
    "plate_size_jump": ("plate", (0.6, 1.0, 0.3, 0.0, 1.0, 1.0),
                        [(0.6, 1.0, 0.3, 0.0, 1.0, 1.0)] * 2 + [(0.6, 1.0, 0.3, 0.0, 1.0, 0.0)],
                        {}, 23),
}


def _input(case, rs, n):
    """Each case's input: a burst into silence for the reverbs (their tails
    then run on their own), loud gated bursts for the compressor, noise for
    the rest."""
    name = CASES[case][0]
    if name in ("spring", "plate"):
        x = np.zeros((2, n), np.float32)
        burst = 200 if name == "spring" else 400
        x[:, :burst] = rs.uniform(-1, 1, (2, burst))
        return x
    if name == "compressor":
        return (rs.uniform(-1.0, 1.0, (2, n)) * (rs.rand(2, n) > 0.5) * 1.5).astype(np.float32)
    return rs.uniform(-0.8, 0.8, (2, n)).astype(np.float32)


def max_state_err(jax_state, port_state):
    """Worst ``|a-b| / max(1, |a|)`` over all state leaves, matched by name;
    names the leaf."""
    ja = dict(_leaves(jax_state))
    tb = dict(_leaves(interop.to_numpy(port_state)))
    assert ja.keys() == tb.keys()
    worst, where = 0.0, None
    for k in ja:
        a, b = ja[k].astype(np.float64), tb[k].astype(np.float64)
        e = float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(a)), initial=0.0))
        assert np.isfinite(e), k
        if e > worst:
            worst, where = e, k
    return worst, where


def _run_both(case, impl):
    name, init, seq, kw, seed = CASES[case]
    jmod, tmod = MODULES[name]
    rs = np.random.RandomState(seed)
    n_blocks = 4
    x = _input(case, rs, n_blocks * B)
    sc = kw.get("sidechain") and _input("compressor", rs, n_blocks * B)
    jst = jmod.init_state(SR, *init)
    tst = interop.fx_state_from_numpy(name, jst, "cpu")
    worst_out = 0.0
    for i in range(n_blocks):
        tg = np.asarray(seq[min(i, len(seq) - 1)], np.float32)
        xb = x[:, i * B:(i + 1) * B]
        if sc is not None and sc is not False:
            kw = {"sidechain": sc[:, i * B:(i + 1) * B]}
        jkw = {k: jnp.asarray(v) for k, v in kw.items()} if "sidechain" in kw else kw
        tkw = {k: torch.from_numpy(v) for k, v in kw.items()} if "sidechain" in kw else kw
        jst, jy = jmod.process_block(jst, jnp.asarray(xb), tg, sample_rate=SR, impl=impl, **jkw)
        tst, ty = tmod.process_block(tst, torch.from_numpy(xb.copy()), tg, sample_rate=SR, **tkw)
        assert i < 2 or np.abs(np.asarray(jy)).max() > 1e-3
        worst_out = max(worst_out, float(np.abs(np.asarray(jy) - ty.numpy()).max()))
    return name, worst_out, max_state_err({"s": jst}, {"s": tst})


#: every case against both JAX paths, but for the saturation's re-engaging
#: block: there the JAX package's own two paths differ by 2.4e-5, beyond the
#: 2e-5 bound, so the port (which follows the Pallas body) is held to that one
PAIRS = [(case, impl) for case in sorted(CASES) for impl in ("xla", "pallas")
         if (case, impl) != ("saturation_held", "xla")]


@pytest.mark.parametrize("case,impl", PAIRS)
def test_effect_matches_jax(case, impl):
    name, worst_out, (worst_state, where) = _run_both(case, impl)
    assert worst_out <= OUT_TOL[name], f"{case}/{impl}: output error {worst_out}"
    assert worst_state <= STATE_TOL, f"{case}/{impl}: state error {worst_state} at {where}"


def test_jax_paths_differ_on_the_reengaging_saturation():
    """Why ``saturation_held`` is held to the Pallas path only: there the JAX
    package's own two paths differ by more than the 2e-5 bound."""
    rs = np.random.RandomState(CASES["saturation_held"][4])
    x = rs.uniform(-0.8, 0.8, (2, 4 * B)).astype(np.float32)
    seq = CASES["saturation_held"][2]
    outs = {}
    for impl in ("xla", "pallas"):
        st, ys = jsaturation.init_state(SR, *seq[0]), []
        for i in range(4):
            st, y = jsaturation.process_block(st, jnp.asarray(x[:, i * B:(i + 1) * B]),
                                              np.float32(seq[min(i, 2)]), sample_rate=SR,
                                              impl=impl)
            ys.append(np.asarray(y))
        outs[impl] = np.concatenate(ys, -1)
    assert np.abs(outs["xla"] - outs["pallas"]).max() > OUT_TOL["saturation"]   # 2.4e-5


@pytest.mark.parametrize("ms", [30.0, 50.0])
def test_pow_table_matches_xla_power(ms):
    """The smoothers' powers: float64 powers rounded once, which is what
    XLA's float32 ``power`` gives (at most one ulp off at one n of 512);
    one ulp of the delay time moves its ring tap by ~1e-4 samples."""
    from libgooey_tpu_torch.core.smoother import pow_table, smoothing_coeff

    c = smoothing_coeff(SR, ms)
    want = np.asarray(jnp.power(1.0 - c, jnp.arange(1, B + 1, dtype=jnp.float32)))
    got = pow_table(float(np.float32(1.0 - c)), B, "cpu").numpy()
    assert int((got != want).sum()) <= 1
    assert np.abs(got - want).max() <= 6e-8


def test_held_blocks_keep_the_incoming_state():
    """All-bypassed saturation blocks and all-passthrough tilt blocks hand
    back the oversampler / SVF state they were given."""
    x = torch.from_numpy(np.random.RandomState(0).uniform(-0.5, 0.5, (2, B)).astype(np.float32))
    st = tsaturation.init_state(SR, 0.6, 0.5, 0.0, device="cpu")
    st = st._replace(ovs=st.ovs._replace(up1=st.ovs.up1._replace(ap0=torch.full((2, 4), 0.1))))
    new, out = tsaturation.process_block(st, x, (0.6, 0.5, 0.0), sample_rate=SR)
    assert torch.equal(out, x)
    for a, b in zip(torch.utils._pytree.tree_leaves(new.ovs), torch.utils._pytree.tree_leaves(st.ovs)):
        assert torch.equal(a, b)
    tt = ttilt.init_state(SR, device="cpu")._replace(svf=ttilt.filters.SVFState(torch.full((2,), 0.2),
                                                                  torch.full((2,), -0.1)))
    new_t, out_t = ttilt.process_block(tt, x, (0.5, 0.0), sample_rate=SR)
    assert torch.equal(out_t, x)
    assert torch.equal(new_t.svf.ic1, tt.svf.ic1) and torch.equal(new_t.svf.ic2, tt.svf.ic2)


def test_ring_matches_jax():
    """Block writes that wrap the ring, then fractional reads across the
    wrap point, against libgooey_tpu/ops/ringbuf.py."""
    rs = np.random.RandomState(21)
    L, C = 1000, 96
    jr = jringbuf.Ring.init(L, batch=(2,))
    tr = tringbuf.Ring(buf=torch.zeros(2, L), pos=torch.zeros((), dtype=torch.int64))
    for _ in range(13):   # 1,248 samples: pos wraps past L once
        w = rs.randn(2, C).astype(np.float32)
        jr = jringbuf.write_block(jr, jnp.asarray(w))
        tr = tringbuf.write_block(tr, torch.from_numpy(w))
    assert int(tr.pos) == int(jr.pos) == (13 * C) % L
    assert np.array_equal(np.asarray(jr.buf), tr.buf.numpy())
    offs = rs.uniform(0.0, L + 10.0, (2, C)).astype(np.float32)   # clamped both ends
    got = tringbuf.read_frac(tr, torch.from_numpy(offs), min_offset=1.0)
    want = jringbuf.read_frac(jr, jnp.asarray(offs), min_offset=1.0)
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("cur,tgt", [(0.5, 0.0), (0.00005, 0.0), (0.0, 0.00009), (0.0, 1e-3)])
def test_traj_all_below_matches_jax(cur, tgt):
    q = float(np.float32(1.0 - 0.0007556))
    want = jfreeze.traj_all_below(jnp.float32(cur), jnp.float32(tgt), jnp.float32(q), B, 1e-4)
    got = tfreeze.traj_all_below(torch.tensor(cur), torch.tensor(tgt), q, B, 1e-4)
    assert bool(want) == bool(got)


def test_tap_frac_matches_jax():
    """The post-write fractional tap (the plate's predelay) after writes
    that wrap the ring, offsets clamped at both ends."""
    rs = np.random.RandomState(22)
    L, C = 700, 128
    jr, tr = jringbuf.Ring.init(L), tringbuf.Ring.init(L, device="cpu")
    for _ in range(7):
        w = rs.randn(C).astype(np.float32)
        jr = jringbuf.write_block(jr, jnp.asarray(w))
        tr = tringbuf.write_block(tr, torch.from_numpy(w))
    offs = rs.uniform(-5.0, L + 5.0, C).astype(np.float32)
    want = jringbuf.tap_frac(jr, jnp.asarray(offs), C)
    got = tringbuf.tap_frac(tr, torch.from_numpy(offs), C)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_gain_reduction_matches_jax():
    over = np.linspace(-10.0, 10.0, 201, dtype=np.float32)
    ratio = np.float32(4.0)
    want = np.asarray(jcompressor.gain_reduction_db(jnp.asarray(over), ratio))
    got = tcompressor.gain_reduction_db(torch.from_numpy(over), torch.tensor(ratio)).numpy()
    assert np.abs(want - got).max() <= 1e-6


def test_plate_matches_the_oracle():
    """An impulse through the plate at a small size, full wet, against the
    per-sample numpy oracle of tests/test_plate.py (its 1e-4 bar)."""
    n = 8 * B
    x = np.zeros((2, n), np.float32)
    x[:, 0] = 1.0
    args = (0.7, 1.0, 0.2, 0.0, 1.0, 0.1)
    st, outs = tplate.init_state(SR, *args, device="cpu"), []
    for i in range(0, n, B):
        st, y = tplate.process_block(st, torch.from_numpy(x[:, i:i + B]),
                                     np.asarray(args, np.float32), sample_rate=SR)
        outs.append(y.numpy())
    got = np.concatenate(outs, axis=-1)
    wl, wr = plate_oracle(x[0], *args[:3], predelay=args[3], width=args[4], size=args[5])
    assert np.abs(wl).max() > 1e-3
    assert max(np.abs(got[0] - wl).max(), np.abs(got[1] - wr).max()) < 1e-4


@pytest.mark.parametrize("name", ["saturation", "lowpass", "tilt", "delay", "compressor",
                                  "spring", "plate", "ring"])
def test_states_are_made_where_asked(name):
    """An effect's ``init_state`` and ``Ring.init`` take the device as a
    required keyword, as the instruments do: called without it they raise,
    never handing back CPU tensors a card's engine did not ask for."""
    from libgooey_tpu_torch.engine import engine as tengine

    make = ((lambda **kw: tringbuf.Ring.init(64, batch=(2,), **kw)) if name == "ring"
            else (lambda **kw: tengine.FX_MODULES[name].init_state(SR, **kw)))
    with pytest.raises(TypeError, match="device"):
        make()
    leaves = torch.utils._pytree.tree_leaves(make(device="cpu"))
    assert leaves and all(t.device.type == "cpu" for t in leaves)
