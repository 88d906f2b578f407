"""The ranks of the port's sharded render for tests/test_torch_mesh.py.

``run(size, scenarios, tmp)`` starts ``size`` gloo ranks on the CPU (one
process each, ``file://`` init in ``tmp``) that render every scenario and
returns rank 0's results.  A scenario is ``{"state": full port state,
"events": [block events], "static": keywords}`` and, optionally, its
``"path"``:

* ``"sharded"`` (the default): ``parallel.mesh.render_all_sharded`` with
  ``_render_all``'s keywords;
* ``"engine"``: ``engine._render_all(..., mesh=mesh)`` itself, the path of
  a poly-bearing render (the JAX package's GSPMD path);
* ``"granulator"`` / ``"sampler"``: the rack's ``render_block(...,
  mesh=mesh)`` on ``parallel.mesh.shard_rack_state``'s lanes, block ``i``
  starting at ``i · block_size``, events (``SpawnEvents`` /
  ``StartEvents``) with global lane ids; ``static`` holds the keywords.

An engine result holds the blocks' ``out`` and ``mono`` (or ``sources``,
``voices`` and ``peaks`` with ``collect_sources``), a rack's ``out``;
whether every rank's blocks equal rank 0's bit for bit, the final state
gathered (to family order), and whether gathering the first shard gives
the full state back bit for bit.

This module imports torch and the port only: each rank is a fresh
interpreter, and none of it needs JAX.
"""

import os
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from libgooey_tpu_torch.parallel import mesh as pmesh


def run(size: int, scenarios: list, tmp) -> list:
    tmp = Path(tmp)
    torch.save(scenarios, tmp / "scenarios.pt")
    mp.spawn(_rank, args=(size, str(tmp)), nprocs=size, join=True)
    return torch.load(tmp / "results.pt", weights_only=False)


def _same(a, b) -> bool:
    """Bit-equal trees (tensors by their bytes, so NaNs compare)."""
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _rack(sc: dict, mesh) -> dict:
    from libgooey_tpu_torch.instruments import granulator, sampler

    mod = granulator if sc["path"] == "granulator" else sampler
    full = sc["state"]
    state = pmesh.shard_rack_state(full, mesh)
    roundtrip = _same(pmesh.gather_rack_state(state, mesh), full)
    outs = []
    for i, ev in enumerate(sc["events"]):
        state, out = mod.render_block(state, ev, i * sc["static"]["block_size"], mesh=mesh,
                                      **sc["static"])
        outs.append(out)
    out = torch.stack(outs)
    return {"roundtrip": roundtrip, "state": pmesh.gather_rack_state(state, mesh), "out": out,
            "ranks_equal": all(_same(out, other) for other in mesh.all_gather(out))}


def _render(sc: dict, state, events, mesh):
    if sc.get("path", "sharded") == "sharded":
        return pmesh.render_all_sharded(state, events, mesh=mesh, **sc["static"])
    from libgooey_tpu_torch.engine import engine

    return engine._render_all(state, events, mesh=mesh, **sc["static"])


def _scenario(sc: dict, mesh) -> dict:
    if sc.get("path") in ("granulator", "sampler"):
        return _rack(sc, mesh)
    kinds = sc["static"]["kinds"]
    full = sc["state"]
    state = pmesh.shard_engine_state(full, sc["events"][0], kinds, mesh)
    roundtrip = _same(pmesh.gather_engine_state(state, kinds, mesh), full)
    blocks = []
    for ev in sc["events"]:
        got = _render(sc, state, pmesh.shard_events(ev, kinds, mesh), mesh)
        state = got[0]
        blocks.append(got[1:])
    res = {"roundtrip": roundtrip, "state": pmesh.gather_engine_state(state, kinds, mesh)}
    if sc["static"].get("collect_sources"):
        res["sources"] = torch.stack([b[0] for b in blocks])
        voices = [pmesh.gather_voices(b[1], b[2], state, kinds, mesh) for b in blocks]
        res["voices"] = torch.stack([v[0] for v in voices])
        res["peaks"] = torch.stack([v[1] for v in voices])
        mine = res["sources"]
    else:
        res["out"] = torch.stack([b[0] for b in blocks])
        res["mono"] = torch.stack([b[1] for b in blocks])
        mine = torch.cat([res["out"].flatten(), res["mono"].flatten()])
    res["ranks_equal"] = all(_same(mine, other) for other in mesh.all_gather(mine))
    return res


def _rank(rank: int, size: int, tmp: str):
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init", rank=rank,
                            world_size=size)
    try:
        mesh = pmesh.make_mesh(size, ["cpu"] * size)
        scenarios = torch.load(Path(tmp) / "scenarios.pt", weights_only=False)
        results = [_scenario(sc, mesh) for sc in scenarios]
        if rank == 0:
            torch.save(results, Path(tmp) / "results.pt")
    finally:
        dist.destroy_process_group()
