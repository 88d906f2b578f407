"""Voice sharding over ``torch.distributed`` (port of
libgooey_tpu/parallel/mesh.py).

The engine's only cross-voice communication is the final additive mix
(SURVEY.md §2.10), so it scales past one card by data parallelism over
voices:

* every per-voice array of the engine state is split on a 1-D ``voices``
  axis, rank r holding rows ``[r·n/D, (r+1)·n/D)`` of each family;
* each rank renders its local voices with the ordinary engine
  (``engine._render_all``, the fused bank kernels included);
* the ``[2, B]`` mix with the ``[B]`` mono sum (one ``[3, B]`` all-reduce),
  the ``[B]`` sidechain tap and, with ``collect_sources``, the
  ``[S, 2, B]`` sources are summed over the group;
* the master, the bus and the limiter run replicated on every rank from
  identical sums.

The JAX package drives every device from one controller; here each rank is
a process of its own, as ``torch.distributed`` programs are: the caller
runs ``init_process_group`` (NCCL for one rank a card, gloo for the CPU or
for ranks sharing a card), builds a :class:`Mesh` with :func:`make_mesh`,
places its slice with :func:`shard_engine_state` and :func:`shard_events`,
and renders every block on every rank.  :func:`gather_engine_state` and
:func:`gather_voices` put the full state and the per-voice outputs back
together in family order.  The JAX package's two sharded paths map so:

* **shard_map** (:func:`render_all_sharded`): the full product scope,
  fused banks by default; ``poly`` raises there, as in the JAX package.
* **GSPMD** (JAX: plain ``jit`` over sharded arrays, any feature incl.
  poly, ``fused_banks=False``): ``engine._render_all(local_state,
  local_events, mesh=mesh, fused_banks=False, ...)`` on each rank.  A poly
  synth's six lanes stay on the rank that holds the synth: its ``[S, P]``
  parameters and its ``[S·6]`` lanes take the rank's contiguous slots
  (lane = slot·6 + i), and it adds one row a synth to the mix.
* The granulator's lanes and the sampler's voices (JAX: GSPMD over the
  lane axis): :func:`shard_rack_state`, then ``render_block(...,
  mesh=mesh)`` with the events' global lane ids; a rank applies the events
  on its lanes, and the lane sums are all-reduced.
  :func:`gather_rack_state` inverts the placement.

The flat mixer banks (pan, gain) and the ``source_matrix`` columns index
voices in family order ``[f0 voices..., f1 voices..., ...]`` (a poly synth
is one voice there).  A rank concatenates its local family slices, so rank
r takes the rows ``[o_f + r·v_f/D, o_f + (r+1)·v_f/D)`` of each family f
(offset ``o_f``, ``v_f`` voices): the JAX package's ``perm`` block for
shard r.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from libgooey_tpu_torch.engine.engine import _lanes_per_slot

VOICE_AXIS = "voices"

#: per-voice event keys besides each family's ``<kind>_off`` / ``<kind>_vel``
_VOICE_EVENT_KEYS = ("poly_freq", "poly_rel", "bass_freq")


def _checked_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no CUDA raises
    (the card unless the caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mesh: no CUDA device available "
                           "(pass devices=['cpu', ...] to run on the CPU)")
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the voice axis as one rank sees it: the process
    group, this rank, the group's size and this rank's device.

    ``Mesh(None, rank, size, device)`` places slices with no group (the
    slicing helpers need no process); any collective on it raises."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    def __post_init__(self):
        if not 0 <= self.rank < self.size:
            raise ValueError(f"mesh: rank {self.rank} outside a group of {self.size}")
        object.__setattr__(self, "device", _checked_device(self.device))

    def _group(self):
        if self.group is None:
            raise RuntimeError("mesh: this Mesh has no process group (built from "
                               "rank, size and device); collectives need make_mesh")
        return self.group

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group, in place; returns ``t``."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self._group())
        return t

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` in rank order, on ``t``'s device.  gloo
        gathers host tensors only, so under gloo a device tensor goes
        through the CPU; bools travel as bytes."""
        group = self._group()
        src = t.contiguous()
        if src.device.type != "cpu" and dist.get_backend(group) == "gloo":
            src = src.cpu()
        if src.dtype == torch.bool:
            src = src.to(torch.uint8)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=group)
        return [p.to(device=t.device, dtype=t.dtype) for p in parts]


def make_mesh(n_devices: Optional[int] = None, devices=None, *, group=None) -> Mesh:
    """This rank's view of a 1-D mesh over ``group`` (the default group
    when None), which the caller has initialised with
    ``torch.distributed.init_process_group``.

    ``n_devices``, when given, must equal the group's size.  The device is
    ``devices[rank]`` when ``devices`` is given, else
    ``cuda:<LOCAL_RANK>``; a CUDA device with no CUDA raises."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(call init_process_group on every rank first)")
    group = dist.group.WORLD if group is None else group
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"make_mesh: n_devices={n_devices} but the group has {size} ranks")
    if devices is not None:
        if len(devices) != size:
            raise ValueError(f"make_mesh: {len(devices)} devices for {size} ranks")
        device = devices[rank]
    else:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return Mesh(group, rank, size, device)


def voice_sharding(mesh: Mesh):
    """Placement of a leaf whose leading axis is the voice axis: this
    rank's rows ``[r·n/D, (r+1)·n/D)`` on ``mesh.device``."""
    def place(x):
        x = _tensor(x, mesh.device)
        n = x.shape[0] // mesh.size
        return x[mesh.rank * n:(mesh.rank + 1) * n]
    return place


def replicated(mesh: Mesh):
    """Placement of a replicated leaf: the whole leaf on ``mesh.device``."""
    return lambda x: _tensor(x, mesh.device)


def _tensor(x, device) -> torch.Tensor:
    """A leaf as a tensor on ``device``; a float64 host array becomes
    float32, as the JAX package places it."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.asarray(x)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif not arr.flags.writeable:
        arr = arr.copy()
    return torch.as_tensor(arr, device=device)


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def _tree_map(fn, tree):
    """``fn`` over the array leaves of dicts, lists, tuples and the state
    NamedTuples; other leaves (None, Python numbers) pass through."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if _is_leaf(tree) else tree


def shard_voice_tree(tree, mesh: Mesh):
    """This rank's part of a tree: a leaf whose leading axis divides by
    the group's size and is longer than 1 gets its rows; every other leaf
    is replicated."""
    rows, whole = voice_sharding(mesh), replicated(mesh)

    def place(x):
        shape = np.shape(x)
        if len(shape) >= 1 and shape[0] % mesh.size == 0 and shape[0] > 1:
            return rows(x)
        return whole(x)

    return _tree_map(place, tree)


def _family_sizes(events: dict, kinds) -> tuple:
    """Each family's voice count in the mix, in ``kinds`` order: the
    leading dim of ``<kind>_off`` over the family's lanes a slot (a poly
    synth's six lanes are one voice of the mix)."""
    return tuple(int(np.shape(events[k + "_off"])[0]) // _lanes_per_slot(k) for k in kinds)


def _check_divides(sizes, mesh: Mesh, what="family voice counts"):
    if any(v % mesh.size for v in sizes):
        raise ValueError(f"{what} {list(sizes)} must divide the mesh size {mesh.size}")


def _family_leaf(n: int, kind: str):
    """Whether a leaf of family ``kind`` with ``n`` voices (slots) in the
    mix is per voice: its leading dim is ``n`` or, for poly, ``n`` · 6."""
    lanes = n * _lanes_per_slot(kind)
    return lambda x: np.ndim(x) >= 1 and np.shape(x)[0] in (n, lanes)


def _voice_rows(sizes, rank: int, size: int) -> np.ndarray:
    """The global voice ids (family order) that rank ``rank`` of ``size``
    holds, in its local order: each family's slice in turn (the JAX
    package's ``perm`` block for shard ``rank``)."""
    offsets = np.cumsum((0,) + tuple(sizes[:-1]))
    return np.concatenate([np.arange(o + rank * (v // size), o + (rank + 1) * (v // size))
                           for o, v in zip(offsets, sizes)]).astype(np.int64)


def shard_engine_state(state: dict, events: dict, kinds, mesh: Mesh) -> dict:
    """This rank's engine state from the full one (host arrays or tensors).

    A family leaf is sliced only when its leading dim is the family's
    voice count (from ``events``), so a packed ``[2, K]`` leaf stays whole;
    a poly leaf by its synths (``params``) or its lanes, six a synth, both
    the rank's contiguous synths; the check that the counts divide the
    group is on synths.  ``pan`` and ``gain`` take the rank's voices in its
    local order (each family's slice in turn); ``master`` and the effects
    are replicated."""
    sizes = _family_sizes(events, kinds)
    _check_divides(sizes, mesh)
    rows, whole = voice_sharding(mesh), replicated(mesh)
    mix_idx = _voice_rows(sizes, mesh.rank, mesh.size)
    out = {}
    for key, sub in state.items():
        if key in kinds:
            per_voice = _family_leaf(sizes[tuple(kinds).index(key)], key)
            out[key] = _tree_map(lambda x, p=per_voice: rows(x) if p(x) else whole(x), sub)
        elif key in ("pan", "gain"):
            out[key] = _tree_map(lambda x: _pick(whole(x), mix_idx, 0), sub)
        else:
            out[key] = _tree_map(whole, sub)
    return out


def _pick(x: torch.Tensor, idx: np.ndarray, dim: int) -> torch.Tensor:
    return x.index_select(dim, torch.as_tensor(idx, device=x.device))


def shard_events(events: dict, kinds, mesh: Mesh) -> dict:
    """This rank's events, key by key (not by shape): ``<kind>_off``,
    ``<kind>_vel``, ``poly_freq``, ``poly_rel`` and ``bass_freq`` take
    their leading-axis rows (poly's lanes: the rank's synths),
    ``source_matrix`` the columns of the rank's voices in its local order;
    ``block_start``, ``lfo_*`` and ``fx_*`` are replicated, so an ``[8]``
    ``lfo_phase`` stays whole on 8 ranks."""
    voice_keys = set(_VOICE_EVENT_KEYS)
    for k in kinds:
        voice_keys.update((k + "_off", k + "_vel"))
    sizes = _family_sizes(events, kinds)
    _check_divides(sizes, mesh)
    rows, whole = voice_sharding(mesh), replicated(mesh)
    out = {}
    for key, val in events.items():
        if key == "source_matrix":
            out[key] = _pick(whole(val), _voice_rows(sizes, mesh.rank, mesh.size), 1)
        elif key in voice_keys:
            _check_divides((np.shape(val)[0],), mesh)
            out[key] = rows(val)
        else:
            out[key] = _tree_map(whole, val)
    return out


def render_all_sharded(state: dict, events: dict, *, mesh: Mesh, **static):
    """One engine block on this rank of ``mesh``, from its local state and
    events (:func:`shard_engine_state`, :func:`shard_events`): the rank's
    voices through ``engine._render_all`` with the mesh as its
    ``psum_axis``, so every rank returns the same mix.  ``poly`` raises,
    as in the JAX package's ``shard_map`` path: a poly-bearing render
    calls ``engine._render_all(..., mesh=mesh)`` (the module docstring).

    Returns ``(new_local_state, out[2, B], mono[B])``, ``out`` and ``mono``
    equal on every rank; with ``collect_sources``, ``(new_local_state,
    sources[S, 2, B], all_voices_local, voice_peaks_local)``
    (:func:`gather_voices` puts the last two back in family order).  The
    static keywords are ``_render_all``'s; ``fused_banks`` defaults to True,
    and the kit gate then sees each rank's local voice counts."""
    from libgooey_tpu_torch.engine import engine as eng

    static = dict(static)
    static.setdefault("fused_banks", True)
    if "poly" in static["kinds"]:
        raise ValueError("poly is not supported under shard_map; "
                         "use the GSPMD (fused_banks=False) path")
    return eng._render_all(state, events, mesh=mesh, **static)


def _inverse_rows(local_sizes, mesh: Mesh) -> torch.Tensor:
    """For the ranks' local rows concatenated in rank order, the position of
    each global voice id (family order)."""
    sizes = tuple(v * mesh.size for v in local_sizes)
    order = np.concatenate([_voice_rows(sizes, r, mesh.size) for r in range(mesh.size)])
    return torch.as_tensor(np.argsort(order), device=mesh.device)


def _gather_rows(x: torch.Tensor, mesh: Mesh, inverse=None) -> torch.Tensor:
    full = torch.cat(mesh.all_gather(x), dim=0)
    return full if inverse is None else full.index_select(0, inverse.to(full.device))


def _local_sizes(local_state: dict, kinds) -> tuple:
    """Each family's local voice count in the mix: its ``trig_sample``
    rows (lanes) over its lanes a slot."""
    return tuple(local_state[k].trig_sample.shape[0] // _lanes_per_slot(k) for k in kinds)


def gather_engine_state(local_state: dict, kinds, mesh: Mesh) -> dict:
    """The full engine state from every rank's local state (the inverse of
    :func:`shard_engine_state`), on ``mesh.device``, on every rank.

    A family leaf is gathered when its leading dim is the family's local
    voice count in the mix or, for poly, its local lanes (every family leaf
    of the port is voice-led); ``pan`` and ``gain`` go back to family
    order; every other entry is this rank's (replicated) copy."""
    local_sizes = _local_sizes(local_state, kinds)
    inverse = _inverse_rows(local_sizes, mesh)
    out = {}
    for key, sub in local_state.items():
        if key in kinds:
            per_voice = _family_leaf(local_sizes[tuple(kinds).index(key)], key)
            out[key] = _tree_map(
                lambda x, p=per_voice: _gather_rows(x, mesh) if p(x) else x, sub)
        elif key in ("pan", "gain"):
            out[key] = _tree_map(lambda x: _gather_rows(x, mesh, inverse), sub)
        else:
            out[key] = sub
    return out


def gather_voices(all_voices: torch.Tensor, voice_peaks: torch.Tensor, local_state: dict,
                  kinds, mesh: Mesh):
    """The full ``[V, B]`` voices and ``[V]`` peaks in family order from
    every rank's ``collect_sources`` outputs, on every rank."""
    local_sizes = _local_sizes(local_state, kinds)
    inverse = _inverse_rows(local_sizes, mesh)
    return (_gather_rows(all_voices, mesh, inverse),
            _gather_rows(voice_peaks, mesh, inverse))


#: the rack fields every rank holds whole: the granulator's source buffer,
#: parameters, 1/sqrt(N) compensation, buffer rate and drive oversampler,
#: the sampler's arena; every other field is one row a lane (voice)
RACK_REPLICATED = ("buffer", "arena", "params", "gain_comp", "buffer_sr", "ovs")


def _rack_lanes(state) -> int:
    """A granulator's or sampler's lane (voice) count: the rows of its
    first per-lane field."""
    return getattr(state, next(f for f in state._fields if f not in RACK_REPLICATED)).shape[0]


def shard_rack_state(state, mesh: Mesh):
    """This rank's part of a granulator (``GrainState``) or sampler
    (``SamplerState``) state: every per-lane field its rows ``[r·n/D,
    (r+1)·n/D)``, the fields of :data:`RACK_REPLICATED` whole, whatever
    their shapes (a 4,096-sample buffer is not split).  The lane count must
    divide the group's size."""
    _check_divides((_rack_lanes(state),), mesh, "rack lanes")
    rows, whole = voice_sharding(mesh), replicated(mesh)
    return type(state)(*(_tree_map(whole if f in RACK_REPLICATED else rows, v)
                         for f, v in zip(state._fields, state)))


def gather_rack_state(local_state, mesh: Mesh):
    """The full rack state from every rank's part (the inverse of
    :func:`shard_rack_state`), on every rank: the per-lane fields gathered
    in rank order, the replicated ones this rank's copy."""
    return type(local_state)(*(v if f in RACK_REPLICATED else _gather_rows(v, mesh)
                               for f, v in zip(local_state._fields, local_state)))
