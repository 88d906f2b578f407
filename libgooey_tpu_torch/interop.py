"""Carrying state between the JAX package and the port, through numpy.

``*_from_numpy`` turns a JAX package state (or any tree whose leaves
``np.asarray`` accepts) into the port's state on ``device``, field by field:
the port's state tuples keep the JAX field names and nesting, so both
packages compute the same thing from the same state.  ``to_numpy`` goes the
other way; a leaf whose numpy dtype differs from its tensor's (hihat2's
``voice_salt``: uint32 in the JAX package, int64 here) is named in its
tuple's ``NUMPY_DTYPES`` (``Ring.pos`` and the plate's ``pos``: int32
there, int64 here).  Events
need no conversion: they are numpy dicts with the JAX keys (``kick_off``,
``kick_vel``, ``bass_freq``, ``block_start``, ``fx_<name>``) that both
packages take; the granulator's and the sampler's events are NamedTuples
of numpy arrays with the JAX fields.  The submix graph's and the loop
mixer's device state (``graph_state_from_numpy``, ``mixer_state_from_numpy``)
go into a port object with ``load_graph_state`` / ``load_mixer_state``, and a
``GooeyEngine``'s (``gooey_state_from_numpy``) with ``load_gooey_state``; their
host fields are numpy on both sides.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from libgooey_tpu_torch.core.smoother import SmootherBank
from libgooey_tpu_torch.effects import (
    compressor,
    delay,
    feedback_waveshaper,
    lowpass,
    reverb_plate,
    reverb_spring,
    saturation,
    tilt,
)
from libgooey_tpu_torch.instruments import (
    bass,
    granulator,
    hihat,
    hihat2,
    kick,
    poly,
    sampler,
    snare,
    tom,
    tom2,
)
from libgooey_tpu_torch.ops import ringbuf
from libgooey_tpu_torch.ops.oversample import OversamplerState

#: the engine families' modules (``init_state`` builds the template)
_FAMILIES = {"kick": kick, "snare": snare, "hihat": hihat, "hihat2": hihat2, "tom": tom,
             "tom2": tom2, "bass": bass, "poly": poly}
#: the ported global effects' modules, likewise
_FX = {"saturation": saturation, "lowpass": lowpass, "tilt": tilt, "delay": delay,
       "compressor": compressor, "spring": reverb_spring, "plate": reverb_plate}


def from_numpy(template, src, device):
    """Rebuild ``template``'s structure (a port state on the CPU) with the
    leaves of ``src``, on ``device``; fields are matched by name."""
    if isinstance(template, torch.Tensor):
        arr = np.asarray(src)
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"leaf shape {arr.shape} does not match {tuple(template.shape)}")
        return torch.as_tensor(arr.astype(template.numpy().dtype), device=device)
    return type(template)(*(from_numpy(t, getattr(src, f), device)
                            for f, t in zip(template._fields, template)))


def family_state_from_numpy(kind: str, src, device):
    """A JAX bank state of family ``kind`` (or a tree with the same fields)
    -> the port's state of that family (poly: its lanes, six a synth)."""
    V = np.asarray(src.trig_sample).shape[0]
    if kind == "poly":
        V //= poly.NUM_VOICES
    return from_numpy(_FAMILIES[kind].init_state(V, device="cpu"), src, device)


def kick_state_from_numpy(src, device) -> kick.KickState:
    """A JAX ``KickState`` (or a tree with the same fields) -> port ``KickState``."""
    return family_state_from_numpy("kick", src, device)


def _zeros_like(src) -> torch.Tensor:
    return torch.zeros(np.asarray(src).shape, dtype=torch.float32)


def fx_state_from_numpy(name: str, src, device):
    """A JAX global-effect state (one of ``engine.FX_MODULES``, or a tree
    with the same fields) -> the port's state of that effect.  Delay lines
    (the delay's ring, the spring's history, the plate's predelay ring,
    histories and tank) keep the lengths they have in ``src``."""
    template = _FX[name].init_state(44100.0, device="cpu")
    if name == "delay":
        L = np.asarray(src.ring.buf).shape[-1]
        template = template._replace(ring=ringbuf.Ring.init(L, batch=(2,), device="cpu"))
    elif name == "spring":
        template = template._replace(hist=_zeros_like(src.hist))
    elif name == "plate":
        template = template._replace(
            predelay=ringbuf.Ring.init(np.asarray(src.predelay.buf).shape[-1], device="cpu"),
            in_hist=_zeros_like(src.in_hist), mod_hist=_zeros_like(src.mod_hist),
            tank=_zeros_like(src.tank))
    return from_numpy(template, src, device)


#: effect-chain ids (mixer/chain.py EFFECT_*) of the global effects above
_CHAIN_FX = {0: "lowpass", 1: "delay", 2: "saturation", 3: "compressor", 4: "tilt",
             6: "spring", 9: "plate"}


def chain_state_from_numpy(effect_id: int, src, device):
    """A JAX effect-chain entry's state (mixer/chain.py, by ``EFFECT_*``
    id) -> the port's: the waveshaper's bare ``OversamplerState``, the
    feedback waveshaper's ``FBShaperState``, the other effects' states."""
    if effect_id == 7:
        return from_numpy(OversamplerState.init(2, "cpu"), src, device)
    if effect_id == 8:
        return from_numpy(feedback_waveshaper.FBShaperState.init((2,), "cpu"), src, device)
    return fx_state_from_numpy(_CHAIN_FX[effect_id], src, device)


def granulator_state_from_numpy(src, device) -> granulator.GrainState:
    """A JAX ``GrainState`` (any lane count, its ``SmootherBank`` params and
    its shape-() ``OversamplerState`` included) -> the port's."""
    G, L = np.asarray(src.spawn_sample).shape[0], np.asarray(src.buffer).shape[0]
    template = granulator.init_state(np.zeros(L, np.float32), 0.0, device="cpu")
    template = template._replace(**{
        f: torch.zeros(G, dtype=getattr(template, f).dtype)
        for f in granulator._GRAIN_FIELDS + ("rel_start", "rel_total")})
    return from_numpy(template, src, device)


def sampler_state_from_numpy(src, device) -> sampler.SamplerState:
    """A JAX ``SamplerState`` (any arena length and voice count) -> the
    port's."""
    F, V = np.asarray(src.arena).shape[0], np.asarray(src.start_sample).shape[0]
    template = sampler.init_state(F, device="cpu")
    template = template._replace(**{
        f: torch.zeros(V, dtype=getattr(template, f).dtype)
        for f in sampler.SamplerState._fields[1:]})
    return from_numpy(template, src, device)


def smoother_from_numpy(src, device) -> SmootherBank:
    return SmootherBank(
        current=torch.as_tensor(np.array(src.current, np.float32), device=device),
        target=torch.as_tensor(np.array(src.target, np.float32), device=device))


def engine_state_from_numpy(src: dict, device) -> dict:
    """A JAX engine state dict (family banks, ``pan``, ``gain``,
    ``master``, ``fx_<name>``) -> the port's engine state dict."""
    out = {}
    for key, val in src.items():
        if key in _FAMILIES:
            out[key] = family_state_from_numpy(key, val, device)
        elif key.startswith("fx_") and key[3:] in _FX:
            out[key] = fx_state_from_numpy(key[3:], val, device)
        elif key in ("pan", "gain", "master"):
            out[key] = smoother_from_numpy(val, device)
        else:
            from libgooey_tpu_torch import not_ported

            raise not_ported(f"engine state entry {key!r}")
    return out


class GraphState(NamedTuple):
    """A ``MixerGraph``'s device state: the ``[T, 3]`` strip smoothers (or
    None before the first render), each track's rack states and the peak
    accumulator (or None)."""

    smooth: Optional[SmootherBank]
    racks: list
    peak: Optional[torch.Tensor]


class MixerState(NamedTuple):
    """A loop ``Mixer``'s device state, per channel: the ``[2, 2 *
    capacity]`` buffer, the gain/gate smoothers and the chain states."""

    buffers: list
    gains: list
    chains: list


def _rack_from_numpy(chain, device) -> list:
    return [chain_state_from_numpy(e.effect_id, st, device)
            for e, st in zip(chain.entries, chain.states)]


def graph_state_from_numpy(src, device) -> GraphState:
    """A JAX ``MixerGraph`` (or an object with its ``_smooth``, ``tracks``
    with their ``rack``, and ``_peak_dev``) -> the port's graph state.
    ``load_graph_state`` puts it into a port ``MixerGraph``."""
    smooth = None if src._smooth is None else smoother_from_numpy(src._smooth, device)
    peak = (None if src._peak_dev is None
            else torch.as_tensor(np.array(src._peak_dev, np.float32), device=device))
    return GraphState(smooth, [_rack_from_numpy(t.rack, device) for t in src.tracks], peak)


def load_graph_state(graph, state: GraphState):
    graph._smooth, graph._peak_dev = state.smooth, state.peak
    for t, rack in zip(graph.tracks, state.racks):
        t.rack.states = list(rack)


def mixer_state_from_numpy(src, device) -> MixerState:
    """A JAX loop ``Mixer`` (or an object with its ``_dev_buffers``,
    ``_gain_banks`` and ``channels`` with their ``chain``) -> the port's
    mixer state.  ``load_mixer_state`` puts it into a port ``Mixer``."""
    return MixerState(
        [torch.as_tensor(np.array(b, np.float32), device=device) for b in src._dev_buffers],
        [smoother_from_numpy(g, device) for g in src._gain_banks],
        [_rack_from_numpy(ch.chain, device) for ch in src.channels])


def load_mixer_state(mixer, state: MixerState):
    mixer._dev_buffers = list(state.buffers)
    mixer._gain_banks = list(state.gains)
    for ch, rack in zip(mixer.channels, state.chains):
        ch.chain.states = list(rack)


class GooeyState(NamedTuple):
    """A ``GooeyEngine``'s device state: the engine's state dict (or None
    before the first render), the granulator, each rack slot's state (None
    where no rack is registered), each global effect's state in chain
    order, the master smoother, the submix graph and the strip-peak
    accumulator.  The loop mixer's goes through ``mixer_state_from_numpy``."""

    engine: Optional[dict]
    gran: granulator.GrainState
    racks: list
    fx: list
    master: SmootherBank
    graph: GraphState
    strip_peak: torch.Tensor


def gooey_state_from_numpy(src, device) -> GooeyState:
    """A JAX ``GooeyEngine`` (or an object with its ``engine._state``,
    ``gran_state``, ``rack_states``, ``fx`` entries and states, ``master``,
    ``graph`` and ``_strip_peak_dev``) -> the port's engine state.
    ``load_gooey_state`` puts it into a port ``GooeyEngine``; the host
    objects (sequencers, hosts, queues) are the caller's to drive alike."""
    e_state = src.engine._state
    return GooeyState(
        engine=None if e_state is None else engine_state_from_numpy(e_state, device),
        gran=granulator_state_from_numpy(src.gran_state, device),
        racks=[None if st is None else sampler_state_from_numpy(st, device)
               for st in src.rack_states],
        fx=_rack_from_numpy(src.fx, device),
        master=smoother_from_numpy(src.master, device),
        graph=graph_state_from_numpy(src.graph, device),
        strip_peak=torch.as_tensor(np.array(src._strip_peak_dev, np.float32), device=device))


def load_gooey_state(gooey, state: GooeyState):
    gooey.engine._state = None if state.engine is None else dict(state.engine)
    gooey.gran_state = state.gran
    gooey.rack_states = list(state.racks)
    gooey.fx.states = list(state.fx)
    gooey.master = state.master
    gooey._master_target = float(state.master.target.reshape(-1)[0])
    load_graph_state(gooey.graph, state.graph)
    gooey._strip_peak_dev = state.strip_peak


def to_numpy(tree):
    """Port state (tensors in NamedTuples, dicts, lists) -> the same structure
    with numpy leaves."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        dtypes = getattr(type(tree), "NUMPY_DTYPES", {})
        return type(tree)(*(to_numpy(v) if f not in dtypes else to_numpy(v).astype(dtypes[f])
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree
