"""The engine: named instruments, sequencers, LFOs, master bus
(port of libgooey_tpu/engine/engine.py).

Behavioral reference: src/engine/mod.rs.  Instruments of one family live in
one voice bank (``[V, ...]`` state); a named instrument is a voice slot.  The
host side runs sequencers and trigger queues in exact arithmetic, stages
parameter targets, and drives one block step

    _render_all(state, events) -> (state', stereo[2, B], mono[B])

All eight families (kick, snare, hihat, hihat2, tom, tom2, bass, poly),
with the kit gate (two or more eligible small banks render together
through the two kit launches, ops/voice.py), LFO routes (each routed
(family, parameter) pair one ``affine1_bank`` scan a block; a routed
family leaves the kit path), the pan/gain mix of every voice in one
``mix_bank`` launch (or, with ``collect_sources``, the per-voice source
scatter), the master gain, the global bus of all seven effects
(saturation, lowpass, tilt, delay, compressor with its optional sidechain,
spring, plate) in any order, split into runs as the JAX package splits it
(a run of two or more in one kernel launch), and the pinned soft limiter.
The host side adds the poly lane allocator with its note and chord API,
per-step preset blends, the MIDI-out queue and the bounce methods.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from libgooey_tpu_torch import io_wav, music
from libgooey_tpu_torch.core import dsp
from libgooey_tpu_torch.core.constants import DEFAULT_BLOCK_SIZE, DEFAULT_SAMPLE_RATE
from libgooey_tpu_torch.core.smoother import (
    SmootherBank,
    smooth_advance,
    smooth_block,
    smoothing_coeff,
)
from libgooey_tpu_torch.effects import chain as fx_chain
from libgooey_tpu_torch.effects import compressor as fx_compressor
from libgooey_tpu_torch.effects import delay as fx_delay
from libgooey_tpu_torch.effects import limiter
from libgooey_tpu_torch.effects import lowpass as fx_lowpass
from libgooey_tpu_torch.effects import reverb_plate as fx_plate
from libgooey_tpu_torch.effects import reverb_spring as fx_spring
from libgooey_tpu_torch.effects import saturation as fx_saturation
from libgooey_tpu_torch.effects import tilt as fx_tilt
from libgooey_tpu_torch.engine import lfo as lfo_mod
from libgooey_tpu_torch.engine.sequencer import Sequencer
from libgooey_tpu_torch.instruments import bass, hihat, hihat2, kick, poly, snare, tom, tom2
from libgooey_tpu_torch.ops import bank_kernels, voice
from libgooey_tpu_torch.ops import scan as gscan

#: Instrument family registry: kind -> module (``init_state``,
#: ``render_block``, PARAM_NAMES / PARAM_INDEX / PRESETS), in the JAX
#: package's order (engine.py:87-96): the global voice index that pan, gain
#: and the sidechain read is family order, then slot.
FAMILIES = {
    "kick": kick,
    "snare": snare,
    "hihat": hihat,
    "hihat2": hihat2,
    "tom": tom,
    "tom2": tom2,
    "bass": bass,
    "poly": poly,
}

#: Global-FX registry: name -> module (``init_state``, ``process_block``).
#: The JAX package's order is the default FFI effect order (saturation, LP,
#: tilt, delay, compressor, spring, plate; SoftLimiter pinned last).
FX_MODULES = {
    "saturation": fx_saturation,
    "lowpass": fx_lowpass,
    "tilt": fx_tilt,
    "delay": fx_delay,
    "compressor": fx_compressor,
    "spring": fx_spring,
    "plate": fx_plate,
}

#: Effects that can join a run of effects in one launch (each has
#: ``prepare``; ``pallas_chain._BUILDERS`` in the JAX package): all but the
#: plate, and the compressor only while it keys from its own input.
MERGEABLE_FX = ("saturation", "lowpass", "tilt", "delay", "compressor", "spring")

FX_DEFAULT_TARGETS = {
    "saturation": [0.3, 0.3, 1.0],
    "lowpass": [8000.0, 0.2],
    "tilt": [0.5, 0.0],
    "delay": [0.5, 0.3, 0.3, 8000.0],
    "compressor": [-20.0, 4.0, 10.0, 100.0, 1.0],
    "spring": [0.5, 0.3, 0.5],
    "plate": [0.5, 0.3, 0.5, 0.0, 1.0, 0.5],
}

#: Per-family extra static kwargs for render_block (the JAX defaults).
FAMILY_STATIC = {
    "kick": dict(max_harmonics=128, feedback_path=False),
    "snare": dict(max_harmonics=192),
    "hihat": dict(),
    "hihat2": dict(),
    "tom": dict(max_harmonics=128),
    "tom2": dict(),
    "bass": dict(),
}


def _lanes_per_slot(kind: str) -> int:
    """Event lanes per named instrument: poly allocates NUM_VOICES lanes per
    synth; every other family one lane per instrument."""
    return poly.NUM_VOICES if kind == "poly" else 1


def _pack_triggers(pend: dict, V: int, B: int):
    """Pack per-voice trigger lists into event arrays.

    ``pend`` maps voice index -> list of ``(offset, velocity, freq)``.
    Returns ``(offs, vels, freqs)`` shaped ``[V]`` when no voice has more
    than one trigger this block, else ``[V, K]`` slot arrays with offsets
    ascending per voice and empty slots filled with ``B`` (= no trigger)."""
    K = max((len(v) for v in pend.values()), default=1) or 1
    if K == 1:
        offs = np.full(V, B, np.int32)
        vels = np.zeros(V, np.float32)
        freqs = np.zeros(V, np.float32)
        for flat, lst in pend.items():
            offs[flat], vels[flat], freqs[flat] = lst[0]
        return offs, vels, freqs
    offs = np.full((V, K), B, np.int32)
    vels = np.zeros((V, K), np.float32)
    freqs = np.zeros((V, K), np.float32)
    for flat, lst in pend.items():
        # stable sort: same-offset triggers keep arrival order (last wins)
        for k, (off, vel, freq) in enumerate(sorted(lst, key=lambda t: t[0])):
            offs[flat, k], vels[flat, k], freqs[flat, k] = off, vel, freq
    return offs, vels, freqs


def _voice_row(voice_outs, i: int) -> torch.Tensor:
    """Row ``i`` of the global voice matrix (family order, then slot)
    without concatenating the banks (engine.py:331-337)."""
    for out in voice_outs:
        if i < out.shape[0]:
            return out[i]
        i -= out.shape[0]
    raise IndexError(i)


def _sidechain_tap(voice_outs, i: int, mesh) -> torch.Tensor:
    """Global voice ``i``'s row on a rank of ``mesh``: the owning rank's
    local row, zeros on every other, summed over the group (engine.py:476-496;
    every family holds ``size`` equal slices)."""
    for out in voice_outs:
        n_local = out.shape[0]
        if i < n_local * mesh.size:
            row = i - mesh.rank * n_local
            tap = (out[row].clone() if 0 <= row < n_local
                   else torch.zeros_like(out[0]))
            return mesh.all_reduce(tap)
        i -= n_local * mesh.size
    raise IndexError(i)


def _joins_run(name: str, sidechain_voice: int) -> bool:
    return name in MERGEABLE_FX and not (name == "compressor" and sidechain_voice >= 0)


def _render_kit(state, events, kinds, static, sample_rate, block_size, smooth_coeff,
                lfo_routes):
    """The kit gate (engine.py:218-257): when two or more families are
    eligible, their blocks go through the two kit launches together
    (``voice.kit_render_fused``); an ineligible family (an LFO route on it,
    ``[V, K]`` trigger slots, the kick's feedback path, os_mode != 4, a bank
    wider than MAX_FUSED_VOICES) renders on its own path.  Returns
    ``{kind: (state, out)}`` of the kit's families."""
    if not kinds or not voice.use_kit(state["pan"].current):
        return {}
    kit_kinds = []
    for kind in kinds:
        st = static.get(kind, {})
        if kind not in voice.KINDS or any(r[1] == kind for r in lfo_routes):
            continue
        if kind == "kick" and (st.get("feedback_path", False) or st.get("os_mode", 4) != 4):
            continue
        if kind in ("snare", "bass") and st.get("os_mode", 4) != 4:
            continue
        if not voice.eligible(events[kind + "_off"], state[kind].trig_sample.shape[0]):
            continue
        kit_kinds.append(kind)
    if len(kit_kinds) < 2:
        return {}
    return voice.kit_render_fused(
        {k: state[k] for k in kit_kinds},
        {k: events[k + "_off"] for k in kit_kinds},
        {k: events[k + "_vel"] for k in kit_kinds},
        events["block_start"], kinds=tuple(kit_kinds), sample_rate=sample_rate,
        block_size=block_size, smooth_coeff=smooth_coeff,
        kick_max_harmonics=static.get("kick", {}).get("max_harmonics", 256),
        snare_max_harmonics=static.get("snare", {}).get("max_harmonics", 256),
        tom2_triangle=static.get("tom2", {}).get("triangle_enabled", True),
        bass_note_freq=events.get("bass_freq") if "bass" in kit_kinds else None)


def _on(x, dev) -> torch.Tensor:
    """An event array (numpy or a tensor) as a tensor on ``dev``."""
    return torch.as_tensor(x, device=dev)


def _lfo_overrides(kind, bank: SmootherBank, kind_routes, lfo_trajs, smooth_coeff,
                   mesh=None):
    """``{param: [V, B]}`` trajectories of a family's routed parameters
    (engine.py:266-291): each parameter's targets with the routed slots'
    rows set to the LFO's bipolar target, then one one-pole scan from the
    bank's current value (one ``affine1_bank`` launch).  A route's slot is a
    global row: on a rank of ``mesh`` the local rows start at ``rank · V``
    (JAX ``_global_rows``, engine.py:188-198)."""
    mod = FAMILIES[kind]
    V, B = bank.target.shape[0], lfo_trajs.shape[-1]
    rows = torch.arange(V, device=bank.target.device)
    if mesh is not None:
        rows = rows + mesh.rank * V
    overrides = {}
    for pname in sorted({r[3] for r in kind_routes}):
        idx = mod.PARAM_INDEX[pname]
        tgt = bank.target[:, idx, None].expand(V, B)
        for (li, _k, slot, rp, depth) in kind_routes:
            if rp == pname:
                val = lfo_mod.bipolar_to_target(lfo_trajs[li] * depth)
                tgt = torch.where((rows == slot)[:, None], val[None, :], tgt)
        overrides[pname] = gscan.onepole(smooth_coeff, tgt, bank.current[:, idx])
    return overrides


def _render_all(
    state: dict,
    events: dict,
    *,
    kinds: Tuple[str, ...],
    sample_rate: float,
    block_size: int,
    smooth_coeff: float,
    limiter_threshold: float,
    family_static=(),
    lfo_routes: Tuple = (),
    fx_order: Tuple[str, ...] = (),
    sidechain_voice: int = -1,
    collect_sources: bool = False,
    fuse_bus: bool = True,
    fused_banks: bool = True,
    mesh=None,
):
    """One block over every instrument bank + mix + master + global bus +
    limiter.

    ``events`` holds ``<kind>_off`` / ``<kind>_vel`` trigger arrays, the
    scalar ``block_start`` (numpy or tensors), optionally ``bass_freq``
    (per-trigger note frequencies, 0 = the param's), ``poly_freq`` /
    ``poly_rel`` (the poly lanes' trigger frequencies and release offsets),
    the LFOs' ``lfo_phase`` / ``lfo_inc`` / ``lfo_amount`` / ``lfo_offset``
    ``[8]`` and ``fx_<name>`` staged targets for each effect of
    ``fx_order``.  ``lfo_routes``: tuple of ``(lfo_index, kind, slot,
    param, depth)``.  ``sidechain_voice``: global voice index whose raw
    output keys the compressor's detector (-1: the compressor keys from its
    input).  ``fuse_bus=False`` runs every effect through its own kernels,
    even in a run of two or more (the JAX package's
    ``LIBGOOEY_CHAIN_FUSE=off``, mixer/chain.py).  ``fused_banks=False``
    keeps every bank off the kit path (ops/voice.py).  ``mesh`` (a
    ``parallel.mesh.Mesh``; the JAX package's ``psum_axis``): ``state`` and
    ``events`` hold this rank's voices of a sharded render
    (``parallel.mesh.render_all_sharded``), route slots and
    ``sidechain_voice`` stay global ids, and the mix with the mono sum, the
    sidechain tap and ``sources`` are summed over the mesh's group, so the
    master, the bus and the limiter run replicated.

    Returns ``(new_state, stereo[2, B], mono[B])``; with ``collect_sources``
    (engine.py:339-354) ``(new_state, sources[S, 2, B], all_voices[V, B],
    voice_peaks[V])`` instead: each voice panned and gained, scattered
    through ``events["source_matrix"]`` ``[S, V]`` into source buses, with
    no master, bus or limiter (their state is not advanced)."""
    static = {k: dict(v) for k, v in family_static}
    new_state = dict(state)
    dev = state["pan"].current.device

    # LFO value trajectories [8, B] from the host-carried phases
    lfo_trajs = None
    if lfo_routes:
        lfo_trajs = lfo_mod.lfo_value_traj(
            _on(events["lfo_phase"], dev), _on(events["lfo_inc"], dev),
            _on(events["lfo_amount"], dev), _on(events["lfo_offset"], dev), block_size)

    kit_results = _render_kit(state, events, kinds, static, sample_rate, block_size,
                              smooth_coeff, lfo_routes) if fused_banks else {}
    voice_outs = []
    for kind in kinds:
        if kind in kit_results:
            new_state[kind], out = kit_results[kind]
            voice_outs.append(out)
            continue
        kind_routes = [r for r in lfo_routes if r[1] == kind]
        overrides = (_lfo_overrides(kind, state[kind].params, kind_routes, lfo_trajs,
                                    smooth_coeff, mesh) if kind_routes else None)
        extra = {}
        if kind == "poly":
            extra["trig_freq"] = events["poly_freq"]
            extra["release_offset"] = events["poly_rel"]
            if overrides is not None:
                overrides = {k: torch.repeat_interleave(v, poly.NUM_VOICES, dim=0)
                             for k, v in overrides.items()}
        if kind == "bass" and "bass_freq" in events:
            extra["note_freq"] = events["bass_freq"]
        if kind in voice.KINDS:   # the families with a kit path of their own
            extra["fused"] = fused_banks
        bank_state, out = FAMILIES[kind].render_block(
            state[kind],
            events[kind + "_off"],
            events[kind + "_vel"],
            events["block_start"],
            sample_rate=sample_rate,
            block_size=block_size,
            smooth_coeff=smooth_coeff,
            overrides=overrides,
            **extra,
            **static.get(kind, {}),
        )
        new_state[kind] = bank_state
        voice_outs.append(out)

    if collect_sources:
        all_voices = torch.cat(voice_outs, dim=0)
        pan_bank, pan_traj = smooth_block(state["pan"], smooth_coeff, block_size)
        gain_bank, gain_traj = smooth_block(state["gain"], smooth_coeff, block_size)
        gl, gr = dsp.pan_gains(pan_traj)
        shaped = all_voices * gain_traj
        panned = torch.stack([shaped * gl, shaped * gr], dim=1)          # [V, 2, B]
        matrix = _on(events["source_matrix"], dev).to(torch.float32)
        sources = torch.einsum("sv,vcb->scb", matrix, panned)
        if mesh is not None:
            sources = mesh.all_reduce(sources.contiguous())              # engine.py:349-350
        voice_peaks = torch.amax(shaped.abs(), dim=-1)                   # [V]
        new_state["pan"] = pan_bank
        new_state["gain"] = gain_bank
        return new_state, sources, all_voices, voice_peaks

    # the mix of every voice in one launch (engine.py:357-376, the JAX
    # package's MIX_IMPL = "pallas"; its per-family default mix computes the
    # same sums and stays its test reference)
    pan, gain = state["pan"], state["gain"]
    suml, sumr, mono_sum = bank_kernels.mix_bank(
        torch.cat(voice_outs, dim=0), pan.current, pan.target, gain.current, gain.target,
        coeff=smooth_coeff)
    if mesh is not None:
        # the only cross-voice sums of a sharded render (engine.py:425-430):
        # one [3, B] all-reduce a block, then everything below is replicated
        suml, sumr, mono_sum = mesh.all_reduce(torch.stack([suml, sumr, mono_sum]))
    pan_bank = smooth_advance(pan, smooth_coeff, block_size)
    gain_bank = smooth_advance(gain, smooth_coeff, block_size)
    mix = torch.stack([suml, sumr], dim=0)

    master_bank, master_traj = smooth_block(state["master"], smooth_coeff, block_size)
    bus = mix * master_traj[None, :]
    mono = mono_sum * master_traj

    # global FX chain, user-ordered, split into maximal runs as the JAX
    # package splits it on the TPU (engine.py:443-501): a run of two or more
    # mergeable effects is one bus_chain launch; the plate, a sidechained
    # compressor and a lone effect launch their own kernels.
    i = 0
    while i < len(fx_order):
        j = i
        while fuse_bus and j < len(fx_order) and _joins_run(fx_order[j], sidechain_voice):
            j += 1
        if j - i >= 2:
            run = fx_order[i:j]
            fx_states, bus = fx_chain.process_run(
                [FX_MODULES[n] for n in run], [state["fx_" + n] for n in run], bus,
                [events["fx_" + n] for n in run], sample_rate=sample_rate)
            new_state.update(("fx_" + n, st) for n, st in zip(run, fx_states))
            i = j
            continue
        fx_name = fx_order[i]
        kw = {}
        if fx_name == "compressor" and sidechain_voice >= 0:
            sc = (_voice_row(voice_outs, sidechain_voice) if mesh is None
                  else _sidechain_tap(voice_outs, sidechain_voice, mesh))
            kw["sidechain"] = torch.stack([sc, sc], dim=0)
        new_state["fx_" + fx_name], bus = FX_MODULES[fx_name].process_block(
            state["fx_" + fx_name], bus, events["fx_" + fx_name], sample_rate=sample_rate,
            **kw)
        i += 1

    out = limiter.soft_limit(bus, limiter_threshold)
    mono = limiter.soft_limit(mono, limiter_threshold)

    new_state["pan"] = pan_bank
    new_state["gain"] = gain_bank
    new_state["master"] = master_bank
    return new_state, out, mono


def _events_to(events: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                               device=device)
            for k, v in events.items()}


def render_many(state: dict, events_stacked: dict, **static):
    """Render N blocks, one ``_render_all`` per block (the counterpart of the
    JAX package's ``lax.scan`` over blocks).

    ``events_stacked`` carries a leading block axis on every event array; it
    is moved to the state's device once, up front.  Returns
    ``(final_state, stereo[N, 2, B])``."""
    dev = state["pan"].current.device
    ev = _events_to(events_stacked, dev)
    n_blocks = ev["block_start"].shape[0]
    outs = []
    for i in range(n_blocks):
        state, out, _mono = _render_all(state, {k: v[i] for k, v in ev.items()}, **static)
        outs.append(out)
    return state, torch.stack(outs, dim=0)


class Engine:
    """Host control plane over the device-resident render step.

    Mirrors the reference Engine API (src/engine/mod.rs:84-127): named
    instruments, ``add_sequencer``, ``trigger``, master gain, per-instrument
    pan/gain — each named instrument occupying one voice lane of its
    family's bank, on ``device``.
    """

    def __init__(
        self,
        sample_rate: float = DEFAULT_SAMPLE_RATE,
        block_size: int = DEFAULT_BLOCK_SIZE,
        family_static: Optional[dict] = None,
        *,
        device,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine: no CUDA device available "
                               "(pass device='cpu' to run on the CPU)")
        self.sample_rate = float(sample_rate)
        self.block_size = int(block_size)
        self.smooth_coeff = smoothing_coeff(self.sample_rate)
        self.limiter_threshold = 1.0
        self.family_static = {**FAMILY_STATIC, **(family_static or {})}

        # host mirrors
        self._names: Dict[str, Tuple[str, int]] = {}   # name -> (kind, slot)
        self._targets: Dict[str, List[np.ndarray]] = {k: [] for k in FAMILIES}
        self._configs: Dict[str, List[object]] = {k: [] for k in FAMILIES}
        self._dirty: Dict[str, bool] = {k: False for k in FAMILIES}
        self._pan: List[float] = []
        self._gain: List[float] = []
        self._mix_dirty = False
        self._master_target = 0.25   # engine/mod.rs default master gain
        self._master_dirty = False

        self.sequencers: List[Sequencer] = []
        self._trigger_queue: List = []
        self.sample_count = 0
        self._state: Optional[dict] = None  # built lazily at first render

        # LFO pool (8, ffi.rs:33) + routes
        self.lfos = [lfo_mod.LfoConfig() for _ in range(8)]
        self.lfo_routes: List[lfo_mod.LfoRoute] = []

        # global FX chain: ordered names + staged targets; limiter pinned last
        self.fx_order: List[str] = []
        self.fx_targets: Dict[str, np.ndarray] = {}
        self.fx_extra: Dict[str, dict] = {}   # e.g. delay pingpong, timing
        self.sidechain_source: Optional[str] = None

        # MIDI-out event queue with per-block sample offsets (ffi.rs:2146-2168)
        self.midi_out: List[Tuple[int, str, float]] = []

        # per-instrument X/Y preset blenders (ChannelBlender, ffi.rs:409-440)
        self.blenders: Dict[str, object] = {}
        self._snap_queue: List[Tuple[str, int]] = []

        # poly host voice allocator: per synth slot, per lane metadata
        self._poly_lanes: Dict[int, list] = {}
        self._poly_queue: List[Tuple[int, int, str, int, float]] = []
        self._poly_order = 0

    # --- instrument management ------------------------------------------------

    def add_instrument(self, name: str, kind: str, config=None) -> int:
        if self._state is not None:
            raise RuntimeError("add instruments before the first render")
        if kind not in FAMILIES:
            raise KeyError(f"unknown instrument family {kind!r}")
        mod = FAMILIES[kind]
        cfg = config if config is not None else mod.PRESETS["default"]()
        slot = len(self._targets[kind])
        self._targets[kind].append(cfg.as_array())
        self._configs[kind].append(cfg)
        self._names[name] = (kind, slot)
        # mixer strip slot (global voice order: family order, then slot)
        self._pan.append(0.5)
        self._gain.append(1.0)
        return slot

    def add_kick(self, name: str, config=None) -> int:
        return self.add_instrument(name, "kick", config)

    def instrument_kinds(self) -> Tuple[str, ...]:
        return tuple(k for k in FAMILIES if self._targets[k])

    def _global_voice_index(self, name: str) -> int:
        kind, slot = self._names[name]
        idx = 0
        for k in FAMILIES:
            if k == kind:
                return idx + slot
            idx += len(self._targets[k])
        raise KeyError(name)

    # --- parameters -------------------------------------------------------------

    def set_param(self, name: str, param: str, value: float):
        """Smoothed normalized param target (the *_PARAM_* setter family)."""
        kind, slot = self._names[name]
        self._targets[kind][slot][FAMILIES[kind].PARAM_INDEX[param]] = value
        self._dirty[kind] = True
        if self._state is not None:
            self._stage_kind(kind)

    def get_param(self, name: str, param: str) -> float:
        """Round-trip getter (host mirror: no device read)."""
        kind, slot = self._names[name]
        return float(self._targets[kind][slot][FAMILIES[kind].PARAM_INDEX[param]])

    def set_config(self, name: str, config):
        kind, slot = self._names[name]
        self._targets[kind][slot] = config.as_array()
        self._configs[kind][slot] = config
        self._dirty[kind] = True
        if self._state is not None:
            self._stage_kind(kind)

    def set_pan(self, name: str, pan: float):
        self._pan[self._global_voice_index(name)] = float(np.clip(pan, 0.0, 1.0))
        self._mix_dirty = True

    def set_gain(self, name: str, gain: float):
        self._gain[self._global_voice_index(name)] = max(float(gain), 0.0)
        self._mix_dirty = True

    def set_master_gain(self, gain: float):
        self._master_target = float(gain)
        self._master_dirty = True

    # --- control ------------------------------------------------------------------

    def add_sequencer(self, seq: Sequencer):
        if seq.name not in self._names:
            raise KeyError(f"sequencer targets unknown instrument {seq.name!r}")
        self.sequencers.append(seq)

    def new_sequencer(self, name: str, bpm: float, steps: int = 16) -> Sequencer:
        seq = Sequencer(bpm, self.sample_rate, steps, name)
        self.add_sequencer(seq)
        return seq

    def trigger(self, name: str, velocity: float = 0.5, offset: int = 0):
        """Queue a trigger for the next block at in-block ``offset``."""
        self._trigger_queue.append((self._names[name], float(velocity), int(offset)))

    # --- LFOs (engine/lfo.rs; 8-LFO pool ffi.rs:33-67) -----------------------------

    def set_lfo(self, index: int, *, frequency_hz=None, division=None, bpm=None,
                amount=None, offset=None):
        cfg = self.lfos[index]
        if frequency_hz is not None:
            cfg.frequency_hz = frequency_hz
        if division is not None:
            cfg.division = division
            cfg.frequency_hz = None
        if bpm is not None:
            cfg.bpm = bpm
        if amount is not None:
            cfg.amount = amount
        if offset is not None:
            cfg.offset = offset

    def add_lfo_route(self, lfo_index: int, name: str, parameter: str,
                      depth: float = 1.0):
        """Route LFO -> (instrument, param); max 16 routes/LFO (ffi.rs:34)."""
        if sum(1 for r in self.lfo_routes if r.lfo == lfo_index) >= 16:
            raise RuntimeError("route capacity exceeded (16 per LFO)")
        kind, _slot = self._names[name]
        if kind == "tom2":
            raise ValueError("tom2 is not modulatable (tom2.rs as_modulatable)")
        if parameter not in FAMILIES[kind].PARAM_INDEX:
            raise KeyError(parameter)
        self.lfo_routes.append(lfo_mod.LfoRoute(lfo_index, name, parameter, depth))

    def clear_lfo_routes(self, lfo_index: Optional[int] = None):
        """Drop the routes of ``lfo_index``, or every route with ``None``."""
        self.lfo_routes = [
            r for r in self.lfo_routes if lfo_index is not None and r.lfo != lfo_index
        ]

    def _routes_static(self) -> Tuple:
        out = []
        for r in self.lfo_routes:
            kind, slot = self._names[r.instrument]
            out.append((r.lfo, kind, slot, r.parameter, float(r.depth)))
        return tuple(out)

    # --- global FX chain ----------------------------------------------------------

    def add_global_effect(self, name: str, targets=None, **extra):
        """Append a global effect (reorderable; SoftLimiter stays pinned last).
        Extra keyword options are stored in ``fx_extra``, as the JAX Engine
        stores them; no effect reads them."""
        if name not in FX_MODULES:
            raise KeyError(name)
        if name not in self.fx_order:
            self.fx_order.append(name)
        self.fx_targets[name] = np.asarray(
            targets if targets is not None else FX_DEFAULT_TARGETS[name], np.float32)
        self.fx_extra[name] = extra
        if self._state is not None and "fx_" + name not in self._state:
            self._state["fx_" + name] = FX_MODULES[name].init_state(
                self.sample_rate, device=self.device)

    def remove_global_effect(self, name: str):
        if name in self.fx_order:
            self.fx_order.remove(name)

    def set_effect_order(self, order: List[str]):
        """Reorder the chain (ffi effect_order; limiter pinned last); names
        never added are dropped."""
        unknown = [n for n in order if n not in FX_MODULES]
        if unknown:
            raise KeyError(f"unknown global effects {unknown}")
        self.fx_order = [n for n in order if n in self.fx_targets]

    def set_effect_param(self, name: str, index: int, value: float):
        self.fx_targets[name][index] = value

    def get_effect_param(self, name: str, index: int) -> float:
        return float(self.fx_targets[name][index])

    def set_sidechain_source(self, name: Optional[str]):
        """Compressor detector keyed from an instrument (ffi sidechain);
        ``None`` keys it from its input again."""
        self.sidechain_source = name

    # --- poly note interface (poly_synth.rs trigger/release, FFI chord API) ------

    def _poly_allocate(self, slot: int, note: int) -> int:
        """Prefer an inactive lane, else steal the oldest (poly_synth.rs:421-434)."""
        lanes = self._poly_lanes.setdefault(
            slot, [dict(note=-1, order=-1, end=0) for _ in range(poly.NUM_VOICES)])
        now = self.sample_count
        idx = next((i for i, lane in enumerate(lanes) if lane["end"] <= now), None)
        if idx is None:
            idx = min(range(poly.NUM_VOICES), key=lambda i: lanes[i]["order"])
        self._poly_order += 1
        cfg = self._targets["poly"][slot]
        sustain = cfg[poly.PARAM_INDEX["amp_sustain"]]
        a = 0.001 * 5000.0 ** cfg[poly.PARAM_INDEX["amp_attack"]]
        d = 0.001 * 5000.0 ** cfg[poly.PARAM_INDEX["amp_decay"]]
        end = 2**62 if sustain > 0.0 else now + int((a + d) * self.sample_rate) + 1
        lanes[idx].update(note=note, order=self._poly_order, end=end)
        return idx

    def poly_note_on(self, name: str, note: int, velocity: float = 1.0):
        kind, slot = self._names[name]
        assert kind == "poly", name
        lane = self._poly_allocate(slot, note)
        self._poly_queue.append((slot, lane, "on", int(note), float(velocity)))

    def poly_note_off(self, name: str, note: int):
        _kind, slot = self._names[name]
        lanes = self._poly_lanes.get(slot, [])
        cfg = self._targets["poly"][slot]
        r = 0.001 * 5000.0 ** cfg[poly.PARAM_INDEX["amp_release"]]
        for lane, meta in enumerate(lanes):
            if meta["note"] == note and meta["end"] > self.sample_count:
                meta["end"] = self.sample_count + int(r * self.sample_rate) + 1
                self._poly_queue.append((slot, lane, "off", int(note), 0.0))

    def poly_release_all(self, name: str):
        _kind, slot = self._names[name]
        for meta in self._poly_lanes.get(slot, []):
            if meta["end"] > self.sample_count:
                self.poly_note_off(name, meta["note"])

    def poly_chord_on(self, name: str, root: str, quality: str = "major",
                      voicing: str = "root", octave: int = 4, velocity: float = 1.0):
        """Chord interface via the music layer (FFI chord API)."""
        for note in music.apply_voicing(music.Chord(root, quality), voicing, octave):
            self.poly_note_on(name, note, velocity)

    def poly_chord_off(self, name: str, root: str, quality: str = "major",
                       voicing: str = "root", octave: int = 4):
        for note in music.apply_voicing(music.Chord(root, quality), voicing, octave):
            self.poly_note_off(name, note)

    # --- device state ---------------------------------------------------------------

    def _build_state(self):
        state = {}
        for kind in self.instrument_kinds():
            targets = np.stack(self._targets[kind])
            state[kind] = FAMILIES[kind].init_state(
                len(self._targets[kind]), targets=targets, device=self.device)
            # non-smoothed static per-voice fields from the configs
            cfgs = self._configs[kind]
            if kind == "snare":
                state[kind] = state[kind]._replace(filter_type=self._ints(
                    [c.filter_type for c in cfgs]))
            if kind == "hihat":
                state[kind] = state[kind]._replace(is_open=torch.as_tensor(
                    np.asarray([1.0 if c.is_open else 0.0 for c in cfgs], np.float32),
                    device=self.device))
            if kind == "hihat2":
                state[kind] = state[kind]._replace(
                    noise_color=self._ints([c.noise_color for c in cfgs]),
                    filter_slope=self._ints([c.filter_slope for c in cfgs]))
        state["pan"] = SmootherBank.init(np.asarray(self._pan, np.float32), self.device)
        state["gain"] = SmootherBank.init(np.asarray(self._gain, np.float32), self.device)
        state["master"] = SmootherBank.init(np.float32(self._master_target), self.device)
        for name in self.fx_order:
            state["fx_" + name] = FX_MODULES[name].init_state(self.sample_rate,
                                                             device=self.device)
        self._state = state

    def _ints(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int32), device=self.device)

    def _stage_kind(self, kind: str):
        if not self._dirty[kind] or self._state is None:
            return
        st = self._state[kind]
        targets = np.stack(self._targets[kind])
        if isinstance(st.params, SmootherBank):
            params = st.params.with_targets(targets)
            # a step's blend snaps its slot to the new target (ffi.rs:1163-1205)
            snaps = [s for k, s in self._snap_queue if k == kind]
            if snaps:
                cur = params.current.clone()
                for slot in snaps:
                    cur[slot] = params.target[slot]
                params = SmootherBank(current=cur, target=params.target)
                self._snap_queue = [e for e in self._snap_queue if e[0] != kind]
        else:  # tom2: plain params
            params = torch.as_tensor(targets.astype(np.float32), device=self.device)
        self._state[kind] = st._replace(params=params)
        self._dirty[kind] = False

    def _stage(self):
        if self._state is None:
            self._build_state()
        for kind in self.instrument_kinds():
            self._stage_kind(kind)
        if self._mix_dirty:
            self._state["pan"] = self._state["pan"].with_targets(self._pan)
            self._state["gain"] = self._state["gain"].with_targets(self._gain)
            self._mix_dirty = False
        if self._master_dirty:
            self._state["master"] = self._state["master"].with_targets(
                np.float32(self._master_target))
            self._master_dirty = False

    def _collect_events(self) -> dict:
        """This block's trigger lists (poly notes, manual queue,
        sequencers), packed into numpy event arrays with exact in-block
        offsets; a sequenced step with a blend restages its slot; the
        LFOs' phases advance."""
        B = self.block_size
        kinds = self.instrument_kinds()
        pend = {k: {} for k in kinds}          # kind -> {lane: [(off, vel, freq)]}

        def add(kind, flat, off, vel, freq=0.0):
            pend[kind].setdefault(flat, []).append((int(off), float(vel), float(freq)))

        poly_rel = (np.full(len(self._targets["poly"]) * poly.NUM_VOICES, B, np.int32)
                    if "poly" in kinds else None)
        # poly note events (the host allocator already chose their lanes)
        for (slot, lane, kind_ev, note, velocity) in self._poly_queue:
            flat = slot * poly.NUM_VOICES + lane
            if kind_ev == "on":
                add("poly", flat, 0, velocity, music.midi_to_freq(note))
            else:
                poly_rel[flat] = 0
        self._poly_queue.clear()
        for (kind, slot), velocity, offset in self._trigger_queue:
            if kind == "poly":
                lane = self._poly_allocate(slot, 60)
                add(kind, slot * poly.NUM_VOICES + lane, offset, velocity,
                    music.midi_to_freq(60))
            else:
                add(kind, slot, offset, velocity)
        self._trigger_queue.clear()
        for seq in self.sequencers:
            kind, slot = self._names[seq.name]
            for trig in seq.tick_block(B):
                if kind == "poly":
                    note = trig.note if trig.note is not None else 60
                    lane = self._poly_allocate(slot, note)
                    add(kind, slot * poly.NUM_VOICES + lane, trig.offset, trig.velocity,
                        music.midi_to_freq(note))
                elif kind == "bass" and trig.note is not None:
                    # a step's note override sets the trigger frequency
                    add(kind, slot, trig.offset, trig.velocity, music.midi_to_freq(trig.note))
                else:
                    add(kind, slot, trig.offset, trig.velocity)
                # a step's blend snaps the voice to the blended config
                # (ffi.rs:1163-1205 snap_params on step blends)
                blender = self.blenders.get(seq.name)
                if trig.blend is not None and blender is not None:
                    self._targets[kind][slot] = blender.blend(*trig.blend).as_array()
                    self._dirty[kind] = True
                    self._snap_queue.append((kind, slot))
                self.midi_out.append((self.sample_count + trig.offset, seq.name,
                                      trig.velocity))
        if len(self.midi_out) > 64:   # MIDI_EVENT_CAPACITY, silent overflow drop
            self.midi_out = self.midi_out[-64:]
        events = {"block_start": np.int32(self.sample_count)}
        for k in kinds:
            V = len(self._targets[k]) * _lanes_per_slot(k)
            offs, vels, freqs = _pack_triggers(pend[k], V, B)
            events[k + "_off"] = offs
            events[k + "_vel"] = vels
            if k == "poly":
                events["poly_freq"] = freqs
                events["poly_rel"] = poly_rel
            elif k == "bass":
                events["bass_freq"] = freqs
        if self.lfo_routes:
            phases, incs, amounts, offsets = [], [], [], []
            for cfg in self.lfos:
                phases.append(cfg.advance(B, self.sample_rate))
                incs.append(cfg.freq() / self.sample_rate)
                amounts.append(cfg.amount if cfg.enabled else 0.0)
                offsets.append(cfg.offset)
            events["lfo_phase"] = np.array(phases, np.float32)
            events["lfo_inc"] = np.array(incs, np.float32)
            events["lfo_amount"] = np.array(amounts, np.float32)
            events["lfo_offset"] = np.array(offsets, np.float32)
        for name in self.fx_order:
            events["fx_" + name] = np.asarray(self.fx_targets[name])
        return events

    def drain_midi_out(self):
        """Host MIDI-out drain (ffi.rs:2146-2168): ``(sample, name, velocity)``."""
        out = self.midi_out
        self.midi_out = []
        return out

    def _static_key(self):
        return tuple(
            (k, tuple(sorted(self.family_static.get(k, {}).items())))
            for k in self.instrument_kinds()
        )

    # --- rendering ------------------------------------------------------------------

    def render_block(self):
        """Render one block -> ``(stereo[2, B], mono[B])`` tensors on the device."""
        self._stage()
        events = self._collect_events()
        self._stage()  # a step's blend may have restaged targets
        sc_voice = (self._global_voice_index(self.sidechain_source)
                    if self.sidechain_source is not None else -1)
        self._state, out, mono = _render_all(
            self._state,
            events,
            kinds=self.instrument_kinds(),
            sample_rate=self.sample_rate,
            block_size=self.block_size,
            smooth_coeff=self.smooth_coeff,
            limiter_threshold=self.limiter_threshold,
            family_static=self._static_key(),
            lfo_routes=self._routes_static(),
            fx_order=tuple(self.fx_order),
            sidechain_voice=sc_voice,
        )
        self.sample_count += self.block_size
        return out, mono

    def render(self, num_samples: int) -> np.ndarray:
        blocks = []
        rendered = 0
        while rendered < num_samples:
            out, _ = self.render_block()
            blocks.append(out)
            rendered += self.block_size
        return torch.cat(blocks, dim=1)[:, :num_samples].cpu().numpy()

    def render_mono(self, num_samples: int) -> np.ndarray:
        """Mono (unpanned sum) — the reference's bounce path (mod.rs:400-415)."""
        blocks = []
        rendered = 0
        while rendered < num_samples:
            _, mono = self.render_block()
            blocks.append(mono)
            rendered += self.block_size
        return torch.cat(blocks)[:num_samples].cpu().numpy()

    # --- bounce (src/bounce.rs) ------------------------------------------------------

    def prepare_for_bounce(self):
        """Reset sequencers/transport and snap master gain (mod.rs:464-477)."""
        for seq in self.sequencers:
            seq.reset()
        self._stage()
        self._state["master"] = self._state["master"].snapped()
        self.sample_count = 0

    def bounce_samples_for(self, bpm: float, bars: Optional[int] = None,
                           beats: Optional[float] = None,
                           samples: Optional[int] = None) -> int:
        """BounceLength::{Bars,Beats,Samples} -> samples (bounce.rs:9-33)."""
        if samples is not None:
            return int(samples)
        if beats is None:
            beats = (bars or 0) * 4.0
        return int(beats * (60.0 / bpm) * self.sample_rate)

    def bounce_to_buffer(self, num_samples: int) -> np.ndarray:
        self.prepare_for_bounce()
        for seq in self.sequencers:
            seq.start()
        out = self.render_mono(num_samples)
        for seq in self.sequencers:
            seq.stop()
        return out

    def bounce_to_wav(self, path, num_samples: int, bits: int = 16):
        buf = self.bounce_to_buffer(num_samples)
        io_wav.write_wav(path, buf, int(self.sample_rate), bits=bits)
        return buf
