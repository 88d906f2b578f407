"""What the JAX package shards only through GSPMD, on the port's
``torch.distributed`` mesh (libgooey_tpu_torch/parallel/mesh.py), on the CPU.

(a) A poly-bearing render: ``kinds=("kick", "poly")``, 4 kicks and 4 poly
synths (24 lanes), B = 128, 2 blocks, a chord on synths 1 and 3, synth 3
released in the second block, an LFO route on synth 3's ``filter_cutoff``
(rank 1's), no bus.  The port's ``engine._render_all(..., mesh=...)`` on
2 gloo ranks against the JAX package's GSPMD render (``_render_all_jit``
over ``shard_voice_tree`` on ``make_mesh(2)``, ``fused_banks=False``, as
tests/test_parallel.py:88-133 runs it): 1e-4 audio, 4e-4 state (relative
where a leaf exceeds 1), the engine pins' bars; and against the port's
single-process render: 2e-6, the JAX package's own bar
(tests/test_parallel.py:133).  (b) The granulator's 80 lanes of
tests/test_parallel.py:212-228 over 2 blocks, then a block with a spawn on
each rank and steals from lane 5 (rank 0) into lanes 70 and 71 (rank 1),
the second copying the spawn that reused lane 5: against the JAX render
jitted over the lane-sharded placement (``grain_read="gather"``) 1e-4
audio and 4e-4 state, against the port's single render 1e-6
(tests/test_parallel.py:251).  (c) The sampler's 32 voices of
tests/test_parallel.py:255-266 with starts on each rank in a third block:
1e-4 against the JAX render (``voice_read="gather"``), 1e-6 against the
port's single render (tests/test_parallel.py:289).  In all three the ranks
are bit-equal and gathering the placed state gives it back bit for bit.
(d) The placement of poly and of the racks against the JAX addressable
shards at D = 2 and 4, with no process.  (e) The errors.

Every rank scenario runs in one group of 2 ranks (``torch_mesh_ranks.run``).
Measured: (a) against JAX 4.0e-7 audio (peak 0.25), mono 4.2e-7, state
6.2e-6 (``poly.svf.ic1``); against the single render 3.0e-8 audio, mono
6.0e-8, state 0.0; (b) against JAX 2.8e-5 audio (peak 0.38: the jitted
JAX read contracts ``src_pos + step·age`` into an FMA), state 3.6e-5;
against the single render 8.9e-8 audio, state 1.2e-7; (c) against JAX
4.8e-7 (peak 3.9), against the single render 0.0.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from libgooey_tpu.core.smoother import SmootherBank as JSmootherBank
from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.engine import engine as jeng
from libgooey_tpu.instruments import granulator as jgran
from libgooey_tpu.instruments import sampler as jsamp
from libgooey_tpu.parallel import mesh as jmesh

from libgooey_tpu_torch import interop, music
from libgooey_tpu_torch.engine import engine as teng
from libgooey_tpu_torch.instruments import granulator as tgran
from libgooey_tpu_torch.instruments import sampler as tsamp
from libgooey_tpu_torch.parallel import mesh as tmesh

import torch_mesh_ranks
from test_torch_bus import max_state_err
from test_torch_granulator import _leaf_errors

SR, B = 44100.0, 128
COEFF = smoothing_coeff(SR)
N_BLOCKS = 2
POLY_KIT = {"kick": 4, "poly": 4}
LANES = POLY_KIT["poly"] * teng.poly.NUM_VOICES
#: the chord's synths and notes; synth 3 (rank 1's) is released in block 1
#: and carries the route
CHORD = {1: (60, 64, 67), 3: (57, 60, 64)}
RELEASED, RELEASE_AT = 3, 40
POLY_ROUTES = ((0, "poly", 3, "filter_cutoff", 0.9),)
#: the racks' event block (after two without events): a spawn on each rank,
#: a steal from lane 5 (rank 0) into lane 70 (rank 1), a spawn reusing lane
#: 5, and a steal of that spawn into lane 71
GRAIN_EVENTS = [dict(slot=70, offset=30, rel_total=120.0, copy_from=5),
                dict(slot=5, offset=30, duration=900.0, src_pos=1000.0, step=1.2, shape=2.0,
                     vel=0.8),
                dict(slot=71, offset=90, rel_total=60.0, copy_from=5),
                dict(slot=45, offset=60, duration=700.0, src_pos=2500.0, step=-0.8, shape=3.0,
                     vel=0.7)]
SAMPLER_STARTS = [dict(voice=3, offset=20, base=100, frames=2000.0, increment=1.5,
                       velocity=0.9),
                  dict(voice=20, offset=70, base=900, frames=1500.0, increment=0.75,
                       velocity=0.6)]


# --- (a) poly: the GSPMD render -----------------------------------------------------


def _poly_state():
    V = sum(POLY_KIT.values())          # the mix: one row a synth
    state = {k: jeng.FAMILIES[k].init_state(v) for k, v in POLY_KIT.items()}
    state["pan"] = JSmootherBank.init(np.linspace(0.2, 0.8, V).astype(np.float32))
    state["gain"] = JSmootherBank.init(np.full(V, 0.5, np.float32))
    state["master"] = JSmootherBank.init(np.float32(0.5))
    return state


def _poly_events():
    rng = np.random.RandomState(31)
    out = []
    for i in range(N_BLOCKS):
        ev = {"block_start": np.int32(i * B)}
        nk = POLY_KIT["kick"]
        ev["kick_off"] = (rng.randint(0, B, nk) if i == 0 else np.full(nk, B)).astype(np.int32)
        ev["kick_vel"] = (rng.uniform(0.3, 1.0, nk) if i == 0 else np.zeros(nk)).astype(
            np.float32)
        off, vel = np.full(LANES, B, np.int32), np.zeros(LANES, np.float32)
        freq, rel = np.zeros(LANES, np.float32), np.full(LANES, B, np.int32)
        for slot, notes in CHORD.items():
            for j, note in enumerate(notes):
                lane = slot * teng.poly.NUM_VOICES + j
                if i == 0:
                    off[lane], vel[lane] = 10 * (j + 1), 0.9
                    freq[lane] = music.midi_to_freq(note)
                elif slot == RELEASED:
                    rel[lane] = RELEASE_AT
        ev.update(poly_off=off, poly_vel=vel, poly_freq=freq, poly_rel=rel,
                  lfo_phase=np.full(8, 0.1 * i, np.float32),
                  lfo_inc=np.full(8, 40.0 / SR, np.float32),
                  lfo_amount=np.full(8, 0.9, np.float32), lfo_offset=np.zeros(8, np.float32))
        out.append(ev)
    return out


POLY_STATIC = dict(kinds=tuple(POLY_KIT), sample_rate=SR, block_size=B, smooth_coeff=COEFF,
                   limiter_threshold=0.9,
                   family_static=(("kick", (("feedback_path", False), ("max_harmonics", 16))),),
                   lfo_routes=POLY_ROUTES, fused_banks=False)


# --- (b), (c) the racks ----------------------------------------------------------------


def _rack_states():
    """tests/test_parallel.py:212-228 and 255-266's states, one draw order."""
    rng = np.random.RandomState(3)
    buf = rng.randn(4096).astype(np.float32) * 0.3
    G = jgran.TOTAL
    gstate = jgran.init_state(buf, SR)._replace(
        spawn_sample=jnp.zeros(G, jnp.int32),
        duration=jnp.asarray(rng.uniform(2000, 6000, G).astype(np.float32)),
        src_pos=jnp.asarray(rng.uniform(0, 2048, G).astype(np.float32)),
        step=jnp.asarray(rng.uniform(0.5, 2.0, G).astype(np.float32)),
        shape=jnp.asarray(rng.uniform(0.5, 4.0, G).astype(np.float32)),
        vel=jnp.asarray(rng.uniform(0.3, 1.0, G).astype(np.float32)))
    SVO = jsamp.VOICES
    sstate = jsamp.init_state(4096)._replace(
        arena=jnp.asarray(rng.randn(4096, 2).astype(np.float32) * 0.3),
        start_sample=jnp.zeros(SVO, jnp.int32), base=jnp.zeros(SVO, jnp.int32),
        frames=jnp.full(SVO, 3000.0, jnp.float32),
        increment=jnp.asarray(rng.uniform(0.5, 2.0, SVO).astype(np.float32)),
        velocity=jnp.asarray(rng.uniform(0.3, 1.0, SVO).astype(np.float32)))
    return gstate, sstate


def _fill(empty, entries, key):
    ev = empty._asdict()
    for k, e in enumerate(entries):
        for name, v in e.items():
            ev[name][k] = v
    assert all(int(ev[key][k]) >= 0 for k in range(len(entries)))
    return type(empty)(**ev)


def _grain_events():
    return [tgran.SpawnEvents.empty()] * 2 + [_fill(tgran.SpawnEvents.empty(), GRAIN_EVENTS,
                                                    "slot")]


def _sampler_events():
    return [tsamp.StartEvents.empty()] * 2 + [_fill(tsamp.StartEvents.empty(), SAMPLER_STARTS,
                                                    "voice")]


def _single_rack(mod, state, events, **kw):
    outs = []
    for i, ev in enumerate(events):
        state, out = mod.render_block(state, ev, i * B, block_size=B, **kw)
        outs.append(out)
    return state, torch.stack(outs)


def _jax_rack(render, state, lanes, events, ev_type):
    """The JAX render jitted over the lane-sharded placement
    (tests/test_parallel.py:242-248, 280-286) on ``make_mesh(2)``."""
    mesh = jmesh.make_mesh(2)
    vspec, rep = NamedSharding(mesh, P(jmesh.VOICE_AXIS)), NamedSharding(mesh, P())

    def place(x):
        x = jnp.asarray(x)
        return jax.device_put(x, vspec if x.ndim >= 1 and x.shape[0] == lanes else rep)

    state = jax.tree_util.tree_map(place, state)
    step = jax.jit(render)
    outs = []
    for i, ev in enumerate(events):
        state, out = step(state, ev_type(*(jnp.asarray(a) for a in ev)), jnp.int32(i * B))
        outs.append(np.asarray(out))
    return state, np.stack(outs)


# --- the ranks, once ------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``(scenarios, rank 0's results)``: poly, the granulator, the sampler."""
    gstate, sstate = _rack_states()
    scenarios = [
        {"path": "engine", "events": _poly_events(), "static": POLY_STATIC,
         "state": interop.engine_state_from_numpy(
             jax.tree_util.tree_map(np.asarray, _poly_state()), "cpu")},
        {"path": "granulator", "events": _grain_events(),
         "state": interop.granulator_state_from_numpy(gstate, "cpu"),
         "static": dict(sample_rate=SR, block_size=B, smooth_coeff=COEFF)},
        {"path": "sampler", "events": _sampler_events(),
         "state": interop.sampler_state_from_numpy(sstate, "cpu"),
         "static": dict(sample_rate=SR, block_size=B)},
    ]
    return scenarios, torch_mesh_ranks.run(2, scenarios, tmp_path_factory.mktemp("scope"))


def test_poly_matches_jax_gspmd_and_single_render(ranks):
    scenarios, results = ranks
    got = results[0]
    mesh = jmesh.make_mesh(2)
    vspec = NamedSharding(mesh, P(jmesh.VOICE_AXIS))
    state = jmesh.shard_voice_tree(_poly_state(), mesh)
    outs, monos = [], []
    for ev in _poly_events():
        ev = {k: jnp.asarray(v) for k, v in ev.items()}
        for k, v in ev.items():
            if v.ndim == 1 and v.shape[0] % 2 == 0:
                ev[k] = jax.device_put(v, vspec)
        state, out, mono = jeng._render_all_jit(state, ev, **POLY_STATIC)
        outs.append(np.asarray(out))
        monos.append(np.asarray(mono))
    want, want_mono = np.stack(outs), np.stack(monos)
    assert np.abs(want[1]).max() > 1e-3
    assert np.abs(got["out"].numpy() - want).max() <= 1e-4
    assert np.abs(got["mono"].numpy() - want_mono).max() <= 1e-4
    worst, where = max_state_err(state, got["state"])
    assert worst <= 4e-4, f"state divergence {worst} at {where}"

    sc = scenarios[0]
    single = sc["state"]
    blocks = []
    for ev in sc["events"]:
        single, out, mono = teng._render_all(single, ev, **sc["static"])
        blocks.append((out, mono))
    assert float((got["out"] - torch.stack([b[0] for b in blocks])).abs().max()) <= 2e-6
    assert float((got["mono"] - torch.stack([b[1] for b in blocks])).abs().max()) <= 2e-6
    worst, where = max_state_err(interop.to_numpy(single), got["state"])
    assert worst <= 2e-6, f"state {worst} at {where}"
    # the chord sounded, and the release and the route reached synth 3's
    # lanes on rank 1
    assert float(got["state"]["poly"].phase_a.abs().max()) > 0.0
    lanes3 = slice(RELEASED * 6, RELEASED * 6 + len(CHORD[RELEASED]))
    assert bool((got["state"]["poly"].release_sample[lanes3] == B + RELEASE_AT).all())
    cut = teng.poly.PARAM_INDEX["filter_cutoff"]
    assert float(got["state"]["poly"].params.current[RELEASED, cut]) != float(
        got["state"]["poly"].params.current[1, cut])


def test_granulator_matches_jax_and_single_render(ranks):
    scenarios, results = ranks
    got, sc = results[1], scenarios[1]
    gstate, _ = _rack_states()
    render = functools.partial(jgran.render_block, sample_rate=SR, block_size=B,
                               smooth_coeff=COEFF, grain_read="gather")
    jstate, want = _jax_rack(render, gstate, jgran.TOTAL, sc["events"], jgran.SpawnEvents)
    assert np.abs(want).max() > 1e-4
    assert np.abs(got["out"].numpy() - want).max() <= 1e-4
    assert max(_leaf_errors(jstate, got["state"])) <= 4e-4
    single, outs = _single_rack(tgran, sc["state"], sc["events"], sample_rate=SR,
                                smooth_coeff=COEFF)
    assert float((got["out"] - outs).abs().max()) <= 1e-6
    assert max(_leaf_errors(interop.to_numpy(single), got["state"])) <= 1e-6
    # the steals copied rank 0's lane 5 as each found it
    st = got["state"]
    assert float(st.src_pos[70]) == float(sc["state"].src_pos[5])
    assert float(st.src_pos[71]) == 1000.0 and int(st.rel_start[71]) == 2 * B + 90


def test_sampler_matches_jax_and_single_render(ranks):
    scenarios, results = ranks
    got, sc = results[2], scenarios[2]
    _, sstate = _rack_states()
    render = functools.partial(jsamp.render_block, sample_rate=SR, block_size=B,
                               voice_read="gather")
    jstate, want = _jax_rack(render, sstate, jsamp.VOICES, sc["events"], jsamp.StartEvents)
    assert np.abs(want).max() > 1e-5
    assert np.abs(got["out"].numpy() - want).max() <= 1e-4
    for a, b in zip(jstate, interop.to_numpy(got["state"])):
        np.testing.assert_array_equal(np.asarray(a), b)
    single, outs = _single_rack(tsamp, sc["state"], sc["events"], sample_rate=SR)
    assert float((got["out"] - outs).abs().max()) <= 1e-6
    assert int(got["state"].start_sample[20]) == 2 * B + 70


@pytest.mark.parametrize("index", [0, 1, 2], ids=["poly", "granulator", "sampler"])
def test_ranks_agree_and_gather_inverts_shard(ranks, index):
    _, results = ranks
    assert results[index]["ranks_equal"], "the ranks' outputs differ"
    assert results[index]["roundtrip"], "gather(shard(state)) != state"


# --- (d) placement against the JAX addressable shards, no process -------------------


def _randomized(tree, seed):
    """``tree`` with every leaf drawn afresh (its shape and dtype), so that
    a row taken from the wrong place shows."""
    rng = np.random.RandomState(seed)

    def draw(x):
        x = np.asarray(x)
        if x.dtype == np.bool_:
            return rng.rand(*x.shape) < 0.5
        return (rng.uniform(-100, 100, x.shape) if x.dtype.kind == "f"
                else rng.randint(-1000, 1000, x.shape)).astype(x.dtype)

    return jax.tree_util.tree_map(draw, tree)


def _shard_of(x, mesh, r):
    """Rank ``r``'s addressable shard of a placed JAX array."""
    return next(np.asarray(s.data) for s in x.addressable_shards if s.device == mesh.devices[r])


def _assert_leaves_equal(jax_leaves, port_tree):
    port_leaves = jax.tree_util.tree_leaves(interop.to_numpy(port_tree))
    assert len(jax_leaves) == len(port_leaves)
    for a, b in zip(jax_leaves, port_leaves):
        assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("D", [2, 4])
def test_poly_placement_matches_jax_shards(D):
    mesh = jmesh.make_mesh(D, jax.devices()[:D])
    jpoly = _randomized(jeng.FAMILIES["poly"].init_state(4), D)
    placed = jmesh.shard_voice_tree(jpoly, mesh)
    port = interop.family_state_from_numpy("poly", jpoly, "cpu")
    events = _poly_events()[0]
    vspec = NamedSharding(mesh, P(jmesh.VOICE_AXIS))
    kit = POLY_KIT
    V = sum(kit.values())
    mix = {"pan": teng.SmootherBank.init(np.arange(V, dtype=np.float32), "cpu"),
           "gain": teng.SmootherBank.init(-np.arange(V, dtype=np.float32), "cpu")}
    offsets = np.cumsum([0] + list(kit.values())[:-1])
    for r in range(D):
        tm = tmesh.Mesh(None, r, D, "cpu")
        local = tmesh.shard_engine_state(dict(mix, poly=port), events, tuple(kit), tm)
        _assert_leaves_equal([_shard_of(x, mesh, r) for x in jax.tree_util.tree_leaves(placed)],
                             local["poly"])
        ev = tmesh.shard_events(events, tuple(kit), tm)
        for key in ("poly_off", "poly_vel", "poly_freq", "poly_rel"):
            want = _shard_of(jax.device_put(jnp.asarray(events[key]), vspec), mesh, r)
            assert np.array_equal(ev[key].numpy(), want)
        # the mix rows: each family's slice, a synth one row (the JAX perm block)
        perm = np.concatenate([np.arange(o + r * (v // D), o + (r + 1) * (v // D))
                               for o, v in zip(offsets, kit.values())])
        assert np.array_equal(local["pan"].current.numpy(), perm.astype(np.float32))
        back = [tmesh.shard_engine_state(dict(mix, poly=port), events, tuple(kit),
                                         tmesh.Mesh(None, q, D, "cpu")) for q in range(D)]
        assert torch.equal(torch.cat([b["poly"].params.target for b in back]),
                           port.params.target)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("rack", ["granulator", "sampler"])
def test_rack_placement_matches_jax_shards(rack, D):
    gstate, sstate = _rack_states()
    jst, lanes, to_port = ((gstate, jgran.TOTAL, interop.granulator_state_from_numpy)
                           if rack == "granulator" else
                           (sstate, jsamp.VOICES, interop.sampler_state_from_numpy))
    jst = _randomized(jst, D)
    mesh = jmesh.make_mesh(D, jax.devices()[:D])
    vspec, rep = NamedSharding(mesh, P(jmesh.VOICE_AXIS)), NamedSharding(mesh, P())
    port = to_port(jst, "cpu")
    placed = [jax.device_put(x, vspec if x.ndim >= 1 and x.shape[0] == lanes else rep)
              for x in jax.tree_util.tree_leaves(jst)]
    for r in range(D):
        local = tmesh.shard_rack_state(port, tmesh.Mesh(None, r, D, "cpu"))
        _assert_leaves_equal([_shard_of(x, mesh, r) for x in placed], local)
    # the source stays whole by name, even where its length is the lane count
    if rack == "granulator":
        short = port._replace(buffer=torch.arange(lanes, dtype=torch.float32))
        local = tmesh.shard_rack_state(short, tmesh.Mesh(None, D - 1, D, "cpu"))
        assert torch.equal(local.buffer, short.buffer)
        assert local.src_pos.shape == (lanes // D,)


# --- (e) errors -------------------------------------------------------------------------


def test_errors():
    mesh = tmesh.Mesh(None, 1, 2, "cpu")
    # 3 poly synths (18 lanes) do not halve, though their lanes do
    events = {"kick_off": np.zeros(2, np.int32), "poly_off": np.zeros(18, np.int32),
              "block_start": np.int32(0)}
    with pytest.raises(ValueError, match="must divide"):
        tmesh.shard_events(events, ("kick", "poly"), mesh)
    with pytest.raises(ValueError, match="must divide"):
        tmesh.shard_engine_state({}, events, ("kick", "poly"), mesh)
    # rack lanes that do not divide the group
    gst = tgran.init_state(np.zeros(64, np.float32), SR, device="cpu")
    with pytest.raises(ValueError, match="rack lanes .* must divide"):
        tmesh.shard_rack_state(gst, tmesh.Mesh(None, 0, 3, "cpu"))
    sst = tsamp.init_state(64, device="cpu")
    with pytest.raises(ValueError, match="rack lanes .* must divide"):
        tmesh.shard_rack_state(sst, tmesh.Mesh(None, 0, 3, "cpu"))
    # global ids past the group's lanes
    local = tmesh.shard_rack_state(gst, mesh)
    ev = _fill(tgran.SpawnEvents.empty(), [dict(slot=2 * 40, offset=0, duration=10.0)], "slot")
    with pytest.raises(ValueError, match="lane 80 of 80"):
        tgran.render_block(local, ev, 0, sample_rate=SR, block_size=B, smooth_coeff=COEFF,
                           mesh=mesh)
    ev = _fill(tsamp.StartEvents.empty(), [dict(voice=32)], "voice")
    with pytest.raises(ValueError, match="voice 32 of 32"):
        tsamp.render_block(tmesh.shard_rack_state(sst, mesh), ev, 0, sample_rate=SR,
                           block_size=B, mesh=mesh)
    # a steal across ranks needs the group's all-reduce
    ev = _fill(tgran.SpawnEvents.empty(), [dict(slot=70, copy_from=5, rel_total=10.0)], "slot")
    with pytest.raises(RuntimeError, match="no process group"):
        tgran.render_block(local, ev, 0, sample_rate=SR, block_size=B, smooth_coeff=COEFF,
                           mesh=mesh)
