"""The ranks of the port's sharded render for tests/test_torch_mesh.py.

``run(size, scenarios, tmp)`` starts ``size`` gloo ranks on the CPU (one
process each, ``file://`` init in ``tmp``) that render every scenario
through ``parallel.mesh.render_all_sharded`` and returns rank 0's results.
A scenario is ``{"state": full port state, "events": [block event dicts],
"static": _render_all's keywords}``; its result holds the blocks' ``out``
and ``mono`` (or ``sources``, ``voices`` and ``peaks`` with
``collect_sources``), whether every rank's blocks equal rank 0's bit for
bit, the final state gathered to family order, and whether gathering the
first shard gives the full state back bit for bit.

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


def _scenario(sc: dict, mesh) -> dict:
    kinds = sc["static"]["kinds"]
    full = sc["state"]
    state = pmesh.shard_engine_state(full, sc["events"][0], kinds, mesh)
    roundtrip = _same(pmesh.gather_engine_state(state, kinds, mesh), full)
    blocks = []
    for ev in sc["events"]:
        got = pmesh.render_all_sharded(state, pmesh.shard_events(ev, kinds, mesh), mesh=mesh,
                                       **sc["static"])
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
