"""The port's voice sharding (libgooey_tpu_torch/parallel/mesh.py) on the CPU.

(a) The port's ``render_all_sharded`` on 2 gloo ranks against the JAX
package's on ``pmesh.make_mesh(2)`` (conftest's virtual CPU devices, the
default ``IMPL``, so no interpret mode), both from one JAX init: the five
headline families at 4 voices each, routes on shard 1's voices, the
compressor keyed from a shard-1 kick, ``fx_order=("saturation",
"compressor")`` (a short bus: the seven-effect JAX compile costs ~80 s),
two blocks.  Bounds: the engine pins' 1e-4 audio and 4e-4 state (relative
where a leaf exceeds 1).  (b) The port sharded against its single-process
render at 2 and 4 ranks: all five families at 8 voices, the seven effects
and the limiter with a route and the sidechain tap on rank 1 or later,
then ``collect_sources``; atol 2e-6, the JAX package's own bar
(tests/test_parallel.py:63,134), every rank's blocks equal bit for bit,
and the gathered state against the single render's.  (c) The slicing
against the JAX package's ``perm`` and specs, without processes.  (d) The
errors.

Each group of ranks is spawned once per size (``torch_mesh_ranks.run``) and
renders every scenario, so the ranks' torch imports are paid once.
Measured: (a) stereo 2.8e-8 (peak 0.024), mono 1.9e-7, state 7.4e-6
(``hihat2.hpf1.x1``); (b) stereo 2.1e-9 / 1.2e-9 at 2 / 4 ranks, state
2.8e-8, sources 7.5e-9, the gathered voices and peaks bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from libgooey_tpu.core.smoother import SmootherBank as JSmootherBank
from libgooey_tpu.core.smoother import smoothing_coeff
from libgooey_tpu.engine import engine as jeng
from libgooey_tpu.parallel import mesh as jmesh

from libgooey_tpu_torch import interop
from libgooey_tpu_torch.engine import engine as teng
from libgooey_tpu_torch.parallel import mesh as tmesh

import torch_mesh_ranks
from test_torch_bus import max_state_err

SR, B = 44100.0, 128
KIT4 = {"kick": 4, "snare": 4, "hihat2": 4, "tom2": 4, "bass": 4}
KIT8 = {k: 8 for k in KIT4}
FX7 = ("saturation", "lowpass", "tilt", "delay", "compressor", "spring", "plate")
FX_JAX = ("saturation", "compressor")
#: routes on kick 3 and snare 5: ranks 1 (of 2) and 1 or 2 (of 4) at 4 or 8 voices
ROUTES = ((0, "kick", 3, "frequency", 0.8), (1, "snare", 5, "filter_cutoff", 0.6))
#: targets that engage the compressor at the kit's level, and a plate small
#: enough that its tank reads what the first block wrote
TARGETS = {"compressor": [-40.0, 6.0, 2.0, 60.0, 1.0], "delay": [0.015, 0.5, 0.4, 6000.0],
           "plate": [0.6, 0.4, 0.4, 0.0, 1.0, 0.0]}
N_BLOCKS = 2
N_SOURCES = 3


def _jax_state(kit, fx):
    V = sum(kit.values())
    state = {k: jeng.FAMILIES[k].init_state(v) for k, v in kit.items()}
    state["pan"] = JSmootherBank.init(np.linspace(0.2, 0.8, V).astype(np.float32))
    state["gain"] = JSmootherBank.init(np.full(V, 1.0 / V, np.float32))
    state["master"] = JSmootherBank.init(np.float32(0.5))
    for name in fx:
        state["fx_" + name] = jeng.FX_MODULES[name].init_state(SR, *TARGETS.get(name, ()))
    return state


def _events(kit, fx, seed, sources=False):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(N_BLOCKS):
        ev = {"block_start": np.int32(i * B)}
        for name in fx:
            ev["fx_" + name] = np.asarray(TARGETS.get(name, jeng.FX_DEFAULT_TARGETS[name]),
                                          np.float32)
        for kind, v in kit.items():
            first = i == 0
            ev[kind + "_off"] = (rng.randint(0, B, v) if first else np.full(v, B)).astype(np.int32)
            ev[kind + "_vel"] = (rng.uniform(0.3, 1.0, v) if first else np.zeros(v)).astype(
                np.float32)
        ev["lfo_phase"] = np.full(8, 0.1 * i, np.float32)
        ev["lfo_inc"] = np.full(8, 2.0 / SR, np.float32)
        ev["lfo_amount"] = np.full(8, 0.9, np.float32)
        ev["lfo_offset"] = np.zeros(8, np.float32)
        if sources:
            V = sum(kit.values())
            ev["source_matrix"] = np.eye(N_SOURCES, dtype=np.float32)[
                np.random.RandomState(seed + 1).randint(0, N_SOURCES, V)].T.copy()
        out.append(ev)
    return out


def _static(kit, fx, sidechain_voice, **kw):
    return dict(kinds=tuple(kit), sample_rate=SR, block_size=B,
                smooth_coeff=smoothing_coeff(SR), limiter_threshold=0.9,
                family_static=(("kick", (("feedback_path", False), ("max_harmonics", 16))),
                               ("snare", (("max_harmonics", 16),))),
                lfo_routes=ROUTES, sidechain_voice=sidechain_voice, fx_order=fx, **kw)


def _scenarios(size):
    """(a)'s port side at 2 ranks, then (b)'s bus and sources renders."""
    out = []
    if size == 2:
        out.append({"state": interop.engine_state_from_numpy(
                        jax.tree_util.tree_map(np.asarray, _jax_state(KIT4, FX_JAX)), "cpu"),
                    "events": _events(KIT4, FX_JAX, 23),
                    "static": _static(KIT4, FX_JAX, KIT4["kick"] // 2)})
    sc_voice = KIT8["kick"] // size          # kick row 0 of rank 1
    state8 = interop.engine_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, _jax_state(KIT8, FX7)), "cpu")
    out.append({"state": state8, "events": _events(KIT8, FX7, 7),
                "static": _static(KIT8, FX7, sc_voice)})
    out.append({"state": state8, "events": _events(KIT8, (), 11, sources=True),
                "static": _static(KIT8, (), -1, collect_sources=True)})
    return out


@pytest.fixture(scope="module", params=[2, 4])
def sharded(request, tmp_path_factory):
    """``(size, scenarios, rank 0's results)`` of one group of ranks."""
    size = request.param
    scenarios = _scenarios(size)
    results = torch_mesh_ranks.run(size, scenarios, tmp_path_factory.mktemp(f"ranks{size}"))
    if size == 2:
        scenarios, results = scenarios[1:], results[1:] + [results[0]]
    return size, scenarios, results


def _single(sc):
    """The single-process render of a scenario."""
    state, blocks = sc["state"], []
    for ev in sc["events"]:
        state, *rest = teng._render_all(state, ev, **sc["static"])
        blocks.append(rest)
    return state, [torch.stack([b[i] for b in blocks]) for i in range(len(blocks[0]))]


# --- (a) against the JAX package's render_all_sharded ----------------------------


@pytest.mark.parametrize("sharded", [2], indirect=True)
def test_sharded_render_matches_jax_sharded(sharded):
    _, _, results = sharded
    got = results[-1]
    state = _jax_state(KIT4, FX_JAX)
    events = _events(KIT4, FX_JAX, 23)
    static = _static(KIT4, FX_JAX, KIT4["kick"] // 2)
    mesh = jmesh.make_mesh(2)
    # key-aware placement, so that the carried state keeps its shardings
    # and the second block reuses the first one's compile
    specs = jmesh._state_specs(state, static["kinds"], events[0], mesh)
    state = jax.tree_util.tree_map(
        lambda x, p: jax.device_put(jnp.asarray(x), NamedSharding(mesh, p)), state, specs)
    step = jax.jit(functools.partial(jmesh.render_all_sharded, mesh=mesh, **static))
    outs, monos = [], []
    for ev in events:
        state, out, mono = step(state, {k: jnp.asarray(v) for k, v in ev.items()})
        outs.append(np.asarray(out))
        monos.append(np.asarray(mono))
    want, want_mono = np.stack(outs), np.stack(monos)
    assert np.abs(want).max() > 1e-3
    assert np.abs(got["out"].numpy() - want).max() <= 1e-4
    assert np.abs(got["mono"].numpy() - want_mono).max() <= 1e-4
    assert got["ranks_equal"]
    worst, where = max_state_err(state, got["state"])
    assert worst <= 4e-4, f"state divergence {worst} at {where}"
    # the sidechain engaged the compressor on both sides
    assert float(got["state"]["fx_compressor"].gain.min()) < 0.99


# --- (b) against the port's single-process render ---------------------------------


def test_sharded_bus_matches_single_render(sharded):
    size, scenarios, results = sharded
    want_state, (want, want_mono) = _single(scenarios[0])
    got = results[0]
    assert float(want.abs().max()) > 1e-3
    assert float((got["out"] - want).abs().max()) <= 2e-6
    assert float((got["mono"] - want_mono).abs().max()) <= 2e-6
    worst, where = max_state_err(interop.to_numpy(want_state), got["state"])
    assert worst <= 2e-6, f"{size} ranks: state {worst} at {where}"
    assert float(got["state"]["fx_compressor"].gain.min()) < 0.99


def test_sharded_sources_match_single_render(sharded):
    size, scenarios, results = sharded
    want_state, (sources, voices, peaks) = _single(scenarios[1])
    got = results[1]
    assert got["sources"].shape == (N_BLOCKS, N_SOURCES, 2, B)
    assert float(sources.abs().max()) > 1e-3
    assert float((got["sources"] - sources).abs().max()) <= 2e-6
    assert torch.equal(got["voices"], voices)
    assert torch.equal(got["peaks"], peaks)
    worst, where = max_state_err(interop.to_numpy(want_state), got["state"])
    assert worst <= 2e-6, f"{size} ranks: state {worst} at {where}"


def test_ranks_agree_and_gather_inverts_shard(sharded):
    size, _, results = sharded
    for res in results:
        assert res["ranks_equal"], f"{size} ranks: the ranks' outputs differ"
        assert res["roundtrip"], f"{size} ranks: gather(shard(state)) != state"


def test_one_rank_group_is_the_single_render(tmp_path, monkeypatch):
    """A one-rank group's all-reduce is the identity: bit for bit."""
    sc = _scenarios(4)[0]
    _, (want, want_mono) = _single(sc)
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init", rank=0,
                            world_size=1)
    try:
        mesh = tmesh.make_mesh(1, ["cpu"])
        state = tmesh.shard_engine_state(sc["state"], sc["events"][0], sc["static"]["kinds"],
                                         mesh)
        outs, monos = [], []
        for ev in sc["events"]:
            state, out, mono = tmesh.render_all_sharded(state, ev, mesh=mesh, **sc["static"])
            outs.append(out)
            monos.append(mono)
    finally:
        dist.destroy_process_group()
    assert torch.equal(torch.stack(outs), want)
    assert torch.equal(torch.stack(monos), want_mono)


# --- (c) slicing, with no process group ------------------------------------------


def _jax_perm(sizes, D):
    """The JAX package's ``perm`` (libgooey_tpu/parallel/mesh.py:179-184)."""
    offsets = np.cumsum([0] + sizes[:-1])
    return np.concatenate([np.arange(o + s * (v // D), o + (s + 1) * (v // D))
                           for s in range(D) for o, v in zip(offsets, sizes)])


@pytest.mark.parametrize("D", [2, 4, 8])
def test_mix_rows_and_source_columns_match_jax_perm(D):
    kit = {"kick": 8, "snare": 16, "hihat2": 8, "tom2": 24, "bass": 8}
    V = sum(kit.values())
    state = {"pan": teng.SmootherBank.init(np.arange(V, dtype=np.float32), "cpu"),
             "gain": teng.SmootherBank.init(-np.arange(V, dtype=np.float32), "cpu")}
    events = {k + "_off": np.zeros(v, np.int32) for k, v in kit.items()}
    events["source_matrix"] = np.tile(np.arange(V, dtype=np.float32), (3, 1))
    pans, gains, cols = [], [], []
    for r in range(D):
        mesh = tmesh.Mesh(None, r, D, "cpu")
        st = tmesh.shard_engine_state(state, events, tuple(kit), mesh)
        pans.append(st["pan"].current)
        gains.append(st["gain"].target)
        cols.append(tmesh.shard_events(events, tuple(kit), mesh)["source_matrix"][0])
    perm = _jax_perm(list(kit.values()), D)
    assert np.array_equal(torch.cat(pans).numpy(), perm.astype(np.float32))
    assert np.array_equal(torch.cat(gains).numpy(), -perm.astype(np.float32))
    assert np.array_equal(torch.cat(cols).numpy(), perm.astype(np.float32))


def _specs_match(port_full, port_local, jax_specs, D):
    """Each port leaf is sliced exactly where the JAX spec shards it."""
    leaves_full = jax.tree_util.tree_leaves(interop.to_numpy(port_full))
    leaves_local = jax.tree_util.tree_leaves(interop.to_numpy(port_local))
    specs = jax.tree_util.tree_leaves(jax_specs, is_leaf=lambda p: isinstance(p, P))
    assert len(leaves_full) == len(leaves_local) == len(specs)
    for full, local, spec in zip(leaves_full, leaves_local, specs):
        sliced = spec != P()
        assert local.shape[0:1] == ((full.shape[0] // D,) if sliced else full.shape[0:1])
        assert local.shape[1:] == full.shape[1:]


@pytest.mark.parametrize("D", [2, 8])
def test_state_and_event_slicing_match_jax_specs(D):
    """Family leaves by the family's voice count, a packed ``[2, K]`` leaf
    kept whole, the mix banks sliced, the rest whole; events by key, so an
    ``[8]`` ``lfo_phase`` stays whole on 8 ranks."""
    kit = {"kick": 2 * D, "hihat2": D, "bass": 8}
    jstate = _jax_state(kit, ("saturation",))
    # a packed [2, K] leaf in a family state: not voice-led at 2 ranks
    jstate["bass"] = jstate["bass"]._replace(params=jstate["bass"].params._replace(
        current=np.zeros((2, 3), np.float32)))
    events = _events(kit, ("saturation",), 3)[0]
    state = interop.to_numpy(interop.engine_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, {k: v for k, v in jstate.items() if k != "bass"}),
        "cpu"))
    state["bass"] = jax.tree_util.tree_map(np.asarray, jstate["bass"])
    jm = jmesh.make_mesh(D, jax.devices()[:D])
    local = tmesh.shard_engine_state(state, events, tuple(kit), tmesh.Mesh(None, D - 1, D, "cpu"))
    for key in state:
        _specs_match(state[key], local[key], jmesh._state_specs(
            jstate, tuple(kit), events, jm)[key], D)
    ev_local = tmesh.shard_events(events, tuple(kit), tmesh.Mesh(None, D - 1, D, "cpu"))
    jspecs = jmesh._event_specs(events, tuple(kit), jm)
    for key, val in events.items():
        _specs_match({key: val}, {key: ev_local[key]}, {key: jspecs[key]}, D)
    assert ev_local["lfo_phase"].shape == (8,)
    assert torch.equal(ev_local["kick_off"], torch.as_tensor(events["kick_off"][-2:]))
    assert local["bass"].params.current.shape == (2, 3)
    assert ev_local["fx_saturation"].dtype == torch.float32


# --- (d) errors ---------------------------------------------------------------------


def test_errors(monkeypatch):
    mesh = tmesh.Mesh(None, 0, 2, "cpu")
    kit = {"kick": 2, "poly": 2}
    static = dict(_static(kit, (), -1), lfo_routes=())
    with pytest.raises(ValueError) as port_err:
        tmesh.render_all_sharded({}, {}, mesh=mesh, **static)
    with pytest.raises(ValueError) as jax_err:
        jmesh.render_all_sharded({}, {}, mesh=jmesh.make_mesh(2), **static)
    assert str(port_err.value) == str(jax_err.value)
    # voice counts that do not divide the group
    events = {"kick_off": np.zeros(3, np.int32), "block_start": np.int32(0)}
    with pytest.raises(ValueError, match="must divide"):
        tmesh.shard_events(events, ("kick",), mesh)
    with pytest.raises(ValueError, match="must divide"):
        tmesh.shard_engine_state({}, events, ("kick",), mesh)
    # no process group: no mesh, and no collective on a group-less one
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="not initialised"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.all_reduce(torch.zeros(3))
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.all_gather(torch.zeros(3))
    # the card unless the caller asks for the CPU: no quiet fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.Mesh(None, 0, 1, "cuda")
    with pytest.raises(ValueError, match="outside"):
        tmesh.Mesh(None, 2, 2, "cpu")
