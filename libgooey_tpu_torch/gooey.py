"""GooeyEngine: the product engine behind the ``gooey_engine_*`` C API
(port of libgooey_tpu/gooey.py).

Behavioral reference: src/ffi.rs.  A DrumKit of 4 hot-swappable voice strips
and a bass strip (each strip: its instrument, its own sequencer, an X/Y
blender, gain/mute/solo/pan, a peak meter and pending triggers), the
PolySynth, the Granulator, the loop Mixer with its ClipGrid, a MixerGraph,
up to 4 sampler racks, a PerformanceRecorder, 9 reorderable global effects
with a pinned SoftLimiter, the Engine's 8 LFOs and their routes, and a
terminal error latch (an exception: silence and the error callback, for
good).

One block runs the FFI pipeline (ffi.rs:1043-1380): sequencers, triggers
with blend and note overrides, performance replay, strip gating, the
instrument banks into source frames, the granulator, the loop mixer, the
racks, the mixer graph, the master gain, the enabled global effects in user
order (a run of two or more mergeable effects in one ``bus_chain`` launch,
``mixer/chain.process_chain``; a compressor keyed from a strip alone) and
the limiter.

Two renders agree: the per-block path (``_render_one_block``) and, for
``render`` of two blocks or more, the span path (``_render_span``): the
loop mixer's K blocks in one ``render_blocks`` call, the host half of the K
blocks planned up front (``_plan_host_block``) and uploaded once, then the
device half of each block in a Python loop over device tensors
(``_span_render``, the counterpart of the JAX package's ``lax.scan``) that
reads nothing back.  Peaks stay on the device until a host query
(``take_strip_peak``, ``graph.take_peak``).

Hot-swapping (INSTRUMENT_* 0-4): every kit channel has one voice in each of
the five families' banks; swapping changes which voice a strip triggers and
gates, with no state rebuilt.
"""

from __future__ import annotations

import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from libgooey_tpu_torch import io_wav, music
from libgooey_tpu_torch.core.blendable import PresetBlender
from libgooey_tpu_torch.core.smoother import SmootherBank, smooth_block, smoothing_coeff
from libgooey_tpu_torch.effects import limiter
from libgooey_tpu_torch.engine import engine as eng
from libgooey_tpu_torch.engine.engine import FAMILIES, Engine
from libgooey_tpu_torch.engine.sequencer import Sequencer
from libgooey_tpu_torch.instruments import granulator as gran_mod
from libgooey_tpu_torch.instruments import poly as poly_mod
from libgooey_tpu_torch.instruments import sampler as samp_mod
from libgooey_tpu_torch.mixer import chain as chain_mod
from libgooey_tpu_torch.mixer import graph as graph_mod
from libgooey_tpu_torch.mixer.mixer import Mixer
from libgooey_tpu_torch.performance import PerformanceRecorder

# INSTRUMENT_* ids (ffi.rs:1843-1851)
INSTRUMENT_KICK, INSTRUMENT_SNARE, INSTRUMENT_HIHAT, INSTRUMENT_TOM, INSTRUMENT_BASS = range(5)
INSTRUMENT_KINDS = ("kick", "snare", "hihat2", "tom2", "bass")
DEFAULT_CHANNEL_KINDS = ("kick", "snare", "hihat2", "tom2")

NUM_KIT_CHANNELS = 4
SAMPLER_RACK_MAX = 4

_SQRT_HALF = float(np.float32(np.sqrt(0.5)))


def _fx_chain_block(states, bus, targets, key, sidechain, limiter_threshold, *,
                    sample_rate, limiter_enabled):
    """The enabled global effects in order, then the soft limiter
    (ffi.rs:1313-1376).  Maximal runs go through ``process_chain`` (two or
    more mergeable entries: one ``bus_chain`` launch); a compressor keyed
    from a strip (``sidechain`` not None) runs alone through
    ``process_entry``, since a run has no sidechain operand."""
    new_states = []
    i, n = 0, len(key)
    while i < n:
        j = i
        while j < n and not (sidechain is not None and key[j][0] == chain_mod.EFFECT_COMPRESSOR):
            j += 1
        if j > i:
            sts, bus = chain_mod.process_chain(states[i:j], bus, targets[i:j], key[i:j],
                                               sample_rate=sample_rate)
            new_states.extend(sts)
        if j < n:
            st, bus = chain_mod.process_entry(key[j][0], states[j], bus, targets[j],
                                              sample_rate=sample_rate, pingpong=key[j][1],
                                              sidechain=sidechain)
            new_states.append(st)
            j += 1
        i = j
    if limiter_enabled:
        bus = limiter.soft_limit(bus, limiter_threshold)
    return new_states, bus


def _span_render(carry, consts, xs, *, kinds, sample_rate, block_size, smooth_coeff,
                 family_static, lfo_routes, fx_key, limiter_enabled, rack_slots,
                 graph_rack_keys, graph_coeff, sidechain_voice):
    """The device half of K planned blocks (gooey.py:115-212), one block
    after another over device tensors.  ``xs`` holds the K blocks' uploaded
    plans (``ev``, ``stage_tgt``, ``stage_snap``, ``pan_tgt``,
    ``gain_tgt``: a leading block axis), ``loop_out`` ``[K, 2, B]`` and the
    host-side granulator and rack events with their block starts.  Nothing
    is read back.  Returns ``(carry, bus [K, 2, B])``."""
    c = dict(carry)
    outs = []
    for k in range(len(xs["bs"])):
        e_state = dict(c["engine"])
        # param staging (Engine._stage_kind, per block)
        for kind in kinds:
            st = e_state[kind]
            tgt = xs["stage_tgt"][kind][k]
            if isinstance(st.params, SmootherBank):
                snap = xs["stage_snap"][kind][k][:, None]
                cur = torch.where(snap, tgt, st.params.current)
                e_state[kind] = st._replace(params=SmootherBank(current=cur, target=tgt))
            else:   # tom2: plain params
                e_state[kind] = st._replace(params=tgt)
        e_state["pan"] = SmootherBank(current=e_state["pan"].current, target=xs["pan_tgt"][k])
        e_state["gain"] = SmootherBank(current=e_state["gain"].current,
                                       target=xs["gain_tgt"][k])

        ev = {name: v[k] for name, v in xs["ev"].items()}
        ev["source_matrix"] = consts["source_matrix"]
        e_state, sources, all_voices, voice_peaks = eng._render_all(
            e_state, ev, kinds=kinds, sample_rate=sample_rate, block_size=block_size,
            smooth_coeff=smooth_coeff, limiter_threshold=1.0, family_static=family_static,
            lfo_routes=lfo_routes, fx_order=(), sidechain_voice=-1, collect_sources=True)
        bs = xs["bs"][k]

        gran_state, gout = gran_mod.render_block(
            c["gran"], xs["gran"][k], bs, sample_rate=sample_rate, block_size=block_size,
            smooth_coeff=smooth_coeff)
        # `sources` is this block's own tensor (the scatter's output)
        sources[graph_mod.SOURCE_GRANULATOR] = torch.stack(
            [gout * _SQRT_HALF, gout * _SQRT_HALF])
        sources[graph_mod.SOURCE_LOOPMIXER] = xs["loop_out"][k]

        rack_states = []
        for i, slot in enumerate(rack_slots):
            rs, rout = samp_mod.render_block(c["racks"][i], xs["racks"][k][i], bs,
                                             sample_rate=sample_rate, block_size=block_size)
            rack_states.append(rs)
            sources[graph_mod.SOURCE_SAMPLER_BASE + slot] = rout

        gbank, gracks, master_bus, gpeaks = graph_mod.graph_block(
            c["gbank"], consts["graph_targets"], sources, consts["graph_routing"],
            c["gracks"], consts["graph_rack_targets"], coeff=graph_coeff,
            block_size=block_size, sample_rate=sample_rate, rack_keys=graph_rack_keys)

        master, mtraj = smooth_block(c["master"], smooth_coeff, block_size)
        bus = master_bus * mtraj[None, :]
        sidechain = None
        if sidechain_voice >= 0:
            sc = all_voices[sidechain_voice]
            sidechain = torch.stack([sc, sc], dim=0)
        fx_states, bus = _fx_chain_block(
            c["fx"], bus, consts["fx_targets"], fx_key, sidechain, consts["limiter_threshold"],
            sample_rate=sample_rate, limiter_enabled=limiter_enabled)

        c = dict(engine=e_state, gran=gran_state, racks=tuple(rack_states),
                 fx=tuple(fx_states), master=master, gbank=gbank, gracks=gracks,
                 strip_peak=torch.maximum(c["strip_peak"], voice_peaks[consts["strip_idx"]]),
                 graph_peak=torch.maximum(c["graph_peak"], gpeaks))
        outs.append(bus)
    return c, torch.stack(outs, dim=0)


def _upload(tree, device):
    """Stack-then-upload: each numpy leaf of a dict tree, one copy each."""
    if isinstance(tree, dict):
        return {k: _upload(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree, device=device)


class GooeyEngine:
    """The product engine on ``device`` (a CUDA card unless the caller asks
    for ``device="cpu"``; with no card it raises)."""

    def __init__(self, sample_rate: float = 44100.0, block_size: int = 512, *,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GooeyEngine: no CUDA device available "
                               "(pass device='cpu' to run on the CPU)")
        dev = self.device
        self.sr = float(sample_rate)
        self.block = int(block_size)
        self.bpm = 120.0
        self.error: Optional[str] = None
        self.error_callback = None
        self.sample_count = 0

        # instrument layer: 4 kit channels x 5 kinds + the bass strip
        self.engine = Engine(sample_rate, block_size, device=dev)
        for ch in range(NUM_KIT_CHANNELS):
            for kind in INSTRUMENT_KINDS:
                self.engine.add_instrument(f"ch{ch}_{kind}", kind)
        self.engine.add_instrument("bass", "bass")
        self.channel_kind: List[str] = list(DEFAULT_CHANNEL_KINDS)

        # strip control: sequencer + blender + mixer strip per kit channel + bass
        self.sequencers: List[Sequencer] = [
            Sequencer(self.bpm, self.sr, 16, f"strip{c}") for c in range(NUM_KIT_CHANNELS + 1)]
        self.blenders: List[Optional[PresetBlender]] = [None] * (NUM_KIT_CHANNELS + 1)
        self.blend_enabled = [False] * (NUM_KIT_CHANNELS + 1)
        self.blend_pos = [(0.5, 0.5)] * (NUM_KIT_CHANNELS + 1)
        self.blend_corner_ids = [[0, 0, 0, 0] for _ in range(NUM_KIT_CHANNELS + 1)]
        self.link_enabled = False
        self.render_host_time = 0.0
        self.strip_gain = np.ones(NUM_KIT_CHANNELS + 1, np.float32)
        self.strip_pan = np.full(NUM_KIT_CHANNELS + 1, 0.5, np.float32)
        self.strip_mute = np.zeros(NUM_KIT_CHANNELS + 1, bool)
        self.strip_solo = np.zeros(NUM_KIT_CHANNELS + 1, bool)
        self.strip_peak = np.zeros(NUM_KIT_CHANNELS + 1, np.float32)
        #: the per-strip peak accumulator on the device: each block folds its
        #: voice peaks in; take_strip_peak() is the only read
        self._strip_peak_dev = torch.zeros(NUM_KIT_CHANNELS + 1, dtype=torch.float32,
                                           device=dev)
        self._strip_voice_idx: Optional[torch.Tensor] = None
        self._pending_triggers: List = []   # (strip, velocity)
        self._post_restore: List = []       # (name, pname, saved) note restores

        # poly / granulator / loops / racks / graph / performance
        self.engine.add_instrument("poly", "poly")
        gr_buf = np.zeros(1024, np.float32)
        self.gran_host = gran_mod.GranulatorHost(self.sr, gr_buf, self.sr)
        self.gran_state = gran_mod.init_state(gr_buf, self.sr, device=dev)
        #: host mirror of the granulator's parameter targets (never read back)
        self._gran_targets = gran_mod.GranulatorConfig().as_array()
        # FFI buffer contract (tests/ffi_granulator.rs:26-37): the reported
        # length is 1 until a buffer is loaded; the 1024-zero placeholder
        # renders silence
        self.gran_buffer_len = 1
        self.gran_buffer_sr = float(self.sr)
        self.mixer = Mixer(self.sr, self.bpm, self.block, device=dev)
        self.graph = graph_mod.MixerGraph.with_default_layout(self.sr, self.bpm, device=dev)
        self.racks: List[Optional[samp_mod.SamplerRackHost]] = [None] * SAMPLER_RACK_MAX
        self.rack_states: List[Optional[samp_mod.SamplerState]] = [None] * SAMPLER_RACK_MAX
        self.performance = PerformanceRecorder()
        self.perf_chord_target = "poly"
        self._perf_sounding = None

        # global FX: reorderable chain entries + enabled flags; limiter pinned
        self.fx = chain_mod.EffectChain(self.sr, self.bpm, device=dev)
        for eid in (
            chain_mod.EFFECT_SATURATION, chain_mod.EFFECT_LOWPASS_FILTER,
            chain_mod.EFFECT_TILT_FILTER, chain_mod.EFFECT_DELAY,
            chain_mod.EFFECT_COMPRESSOR, chain_mod.EFFECT_WAVESHAPER,
            chain_mod.EFFECT_FEEDBACK_WAVESHAPER, chain_mod.EFFECT_REVERB,
            chain_mod.EFFECT_PLATE_REVERB,
        ):
            self.fx.add(eid)
        self.fx_enabled: Dict[int, bool] = {e.effect_id: False for e in self.fx.entries}
        self.limiter_enabled = True
        self.limiter_threshold = 1.0
        self.sidechain_strip: Optional[int] = None
        self.master = SmootherBank.init(np.float32(1.0), dev)
        #: host mirror of the master gain's target (float32, never read back)
        self._master_target = 1.0
        self.midi_out: List = []

        self._smooth_coeff = smoothing_coeff(self.sr)
        self._source_matrix: Optional[torch.Tensor] = None
        #: multi-block render(frames) calls take the span path; clearing
        #: this forces the per-block path
        self.span_rendering = True

    # --- naming helpers ----------------------------------------------------------

    def _strip_name(self, strip: int) -> str:
        if strip < NUM_KIT_CHANNELS:
            return f"ch{strip}_{self.channel_kind[strip]}"
        return "bass"

    def set_channel_instrument(self, channel: int, instrument_id: int) -> bool:
        """Hot-swap a kit channel's instrument (ffi.rs:2290-2335)."""
        if not (0 <= channel < NUM_KIT_CHANNELS) or not (0 <= instrument_id < 5):
            return False
        self.channel_kind[channel] = INSTRUMENT_KINDS[instrument_id]
        self._source_matrix = None
        self._strip_voice_idx = None
        return True

    def get_channel_instrument(self, channel: int) -> int:
        return INSTRUMENT_KINDS.index(self.channel_kind[channel])

    # --- params / triggers ---------------------------------------------------------

    def set_param(self, strip: int, param: str, value: float):
        self.engine.set_param(self._strip_name(strip), param, value)

    def get_param(self, strip: int, param: str) -> float:
        return self.engine.get_param(self._strip_name(strip), param)

    def trigger_channel(self, strip: int, velocity: float = 0.5):
        """Queued like the FFI's atomics, drained at sample 0 (ffi.rs:1078)."""
        self._pending_triggers.append((strip, float(velocity)))

    def set_blender(self, strip: int, blender: PresetBlender):
        self.blenders[strip] = blender

    def blend_to(self, strip: int, x: float, y: float):
        """Apply the X/Y pad blend now (a snap, ffi ChannelBlender)."""
        b = self.blenders[strip]
        if b is None:
            return False
        name = self._strip_name(strip)
        self.engine._snap_queue.append(self.engine._names[name])  # before the setter
        self.engine.set_config(name, b.blend(x, y))
        self.blend_pos[strip] = (float(x), float(y))
        return True

    # --- transport / BPM ---------------------------------------------------------------

    def set_bpm(self, bpm: float):
        self.bpm = float(bpm)
        for seq in self.sequencers:
            seq.set_bpm(bpm)
        self.mixer.set_bpm(bpm)
        self.fx.set_bpm(bpm)
        for rack in self.racks:
            if rack:
                rack.sequencer.set_bpm(bpm)

    def transport_beat(self) -> float:
        return self.mixer.clip_grid.transport_beat

    def transport_start(self):
        self.mixer.clip_grid.transport_start(self.mixer.channels)

    def transport_stop(self):
        self.mixer.clip_grid.transport_stop(self.mixer.channels)

    # --- sampler racks ---------------------------------------------------------------------

    def register_sampler_rack(self, index: int, arena_frames: int = 1 << 20) -> bool:
        if not (0 <= index < SAMPLER_RACK_MAX):
            return False
        self.racks[index] = samp_mod.SamplerRackHost(self.sr, self.bpm, f"rack{index}",
                                                     arena_frames)
        self.rack_states[index] = samp_mod.init_state(arena_frames, device=self.device)
        return True

    def sampler_trigger(self, rack: int, slot: int, velocity: float,
                        from_playback: bool = False) -> bool:
        r = self.racks[rack]
        if r is None:
            return False
        ok = r.trigger(slot, velocity)
        if ok and not from_playback:
            self.performance.record_sampler_hit(rack, slot, velocity)
        return ok

    def _upload_arenas(self):
        for i, rack in enumerate(self.racks):
            if rack is not None and rack.arena_dirty:
                self.rack_states[i] = self.rack_states[i]._replace(
                    arena=torch.as_tensor(rack.arena, device=self.device))
                rack.arena_dirty = False

    # --- granulator --------------------------------------------------------------------------

    def granulator_load(self, samples: np.ndarray, sample_rate: float):
        buf = np.asarray(samples, np.float32)
        self.gran_buffer_len = int(buf.shape[-1])
        self.gran_buffer_sr = float(sample_rate)
        old_cfg = self.gran_host.cfg
        self.gran_host = gran_mod.GranulatorHost(self.sr, buf, sample_rate,
                                                 seed=self.gran_host.rng.state)
        self.gran_host.cfg = old_cfg  # loading a buffer keeps the knob state
        self.gran_state = gran_mod.init_state(buf, sample_rate, device=self.device)._replace(
            params=self.gran_state.params)

    def granulator_set_param(self, name: str, value: float):
        self.gran_host.set_param(name, value)
        tgt = self._gran_targets.copy()
        tgt[gran_mod.PARAM_INDEX[name]] = np.clip(value, 0.0, 1.0)
        self._gran_targets = tgt
        self.gran_state = self.gran_state._replace(
            params=self.gran_state.params.with_targets(tgt))

    def granulator_trigger(self, velocity: float = 1.0):
        self.gran_host.trigger(self.sample_count / self.sr, velocity)

    # --- performance recorder ------------------------------------------------------------------

    def perf_chord_on(self, root: int, scale_type: int, degree: int, voicing: int,
                      preset: int, octave: int, velocity: float):
        self._apply_chord(root, scale_type, degree, voicing, preset, octave, velocity)
        self.performance.record_chord_on(root, scale_type, degree, voicing, preset, octave,
                                         velocity)

    def perf_chord_off(self):
        self._release_chord()
        self.performance.record_chord_off()

    def _apply_chord(self, root, scale_type, degree, voicing, preset, octave, velocity):
        """Trigger a diatonic-seventh chord (ffi.rs:5571-5621): the poly
        preset as smoothed targets (no snap), the sounding notes released,
        then the voiced chord."""
        names = ("default", "pad", "pluck", "keys", "strings")
        name = names[preset] if 0 <= int(preset) < len(names) else "default"
        self.engine.set_config(self.perf_chord_target, poly_mod.PRESETS[name]())
        key = music.Key(music.NOTE_NAMES[root % 12],
                        "major" if scale_type == 0 else "natural_minor")
        chord = key.diatonic_sevenths()[degree % 7]
        octave = min(max(int(octave), 0), 8)
        notes = music.apply_voicing(chord, music.VOICINGS[voicing % len(music.VOICINGS)],
                                    octave)
        self._release_chord()
        self._perf_sounding = notes
        for n in notes:
            self.engine.poly_note_on(self.perf_chord_target, n, min(max(velocity, 0.0), 1.0))

    def _release_chord(self):
        if self._perf_sounding:
            for n in self._perf_sounding:
                self.engine.poly_note_off(self.perf_chord_target, n)
            self._perf_sounding = None

    # --- global FX -----------------------------------------------------------------------------

    def set_effect_enabled(self, effect_id: int, enabled: bool):
        if effect_id == chain_mod.EFFECT_LIMITER:
            self.limiter_enabled = enabled
        else:
            self.fx_enabled[effect_id] = bool(enabled)

    def set_effect_param(self, effect_id: int, param: int, value: float) -> bool:
        for i, e in enumerate(self.fx.entries):
            if e.effect_id == effect_id:
                return self.fx.set_param(i, param, value)
        return False

    def get_effect_param(self, effect_id: int, param: int) -> float:
        for i, e in enumerate(self.fx.entries):
            if e.effect_id == effect_id:
                return self.fx.get_param(i, param)
        raise KeyError(effect_id)

    def set_effect_order(self, order: List[int]) -> bool:
        """Reorder the 9 reorderable effects (limiter pinned last)."""
        if sorted(order) != sorted(e.effect_id for e in self.fx.entries):
            return False
        by_id = {e.effect_id: (e, s) for e, s in zip(self.fx.entries, self.fx.states)}
        self.fx.entries = [by_id[i][0] for i in order]
        self.fx.states = [by_id[i][1] for i in order]
        return True

    def _enabled_fx(self):
        return [(i, ent) for i, ent in enumerate(self.fx.entries)
                if self.fx_enabled.get(ent.effect_id, False)]

    def _sidechain_voice(self, enabled) -> int:
        """The global voice index that keys the compressor, or -1."""
        if self.sidechain_strip is None or not any(
                ent.effect_id == chain_mod.EFFECT_COMPRESSOR for _, ent in enabled):
            return -1
        return self.engine._global_voice_index(self._strip_name(self.sidechain_strip))

    # --- source routing ----------------------------------------------------------------------------

    def _build_source_matrix(self) -> np.ndarray:
        """``[SOURCE_CAPACITY, V]``: strips to the drum kit and the bass, the
        poly to the polysynth source; the granulator, loops and racks enter
        separately."""
        e = self.engine
        n_named = sum(len(e._targets[k]) for k in e.instrument_kinds())
        m = np.zeros((graph_mod.SOURCE_CAPACITY, n_named), np.float32)
        for ch in range(NUM_KIT_CHANNELS):
            m[graph_mod.SOURCE_DRUMKIT, e._global_voice_index(self._strip_name(ch))] = 1.0
        m[graph_mod.SOURCE_BASS, e._global_voice_index("bass")] = 1.0
        m[graph_mod.SOURCE_POLYSYNTH, e._global_voice_index("poly")] = 1.0
        return m

    def _routing(self):
        """The source matrix and the strips' voice indices on the device,
        rebuilt after a hot-swap."""
        if self._source_matrix is None:
            self._source_matrix = torch.as_tensor(self._build_source_matrix(),
                                                  device=self.device)
        if self._strip_voice_idx is None:
            self._strip_voice_idx = torch.as_tensor(
                np.asarray([self.engine._global_voice_index(self._strip_name(s))
                            for s in range(NUM_KIT_CHANNELS + 1)], np.int64),
                device=self.device)

    def _stage_strip_gating(self):
        """Stage the strip mixer settings into the engine's pan and gain
        (solo-aware); a kit channel's inactive instruments get gain 0.
        Idempotent: it runs at the top of every block, and before a span's
        first ``_stage`` so that block 0 starts from the gated values."""
        e = self.engine
        any_solo = bool(self.strip_solo.any())
        for strip in range(NUM_KIT_CHANNELS + 1):
            audible = (not self.strip_mute[strip]) and ((not any_solo) or self.strip_solo[strip])
            if strip < NUM_KIT_CHANNELS:
                for kind in INSTRUMENT_KINDS:
                    nm = f"ch{strip}_{kind}"
                    active = kind == self.channel_kind[strip]
                    e.set_gain(nm, self.strip_gain[strip] if (active and audible) else 0.0)
                    e.set_pan(nm, float(self.strip_pan[strip]))
            else:
                e.set_gain("bass", self.strip_gain[strip] if audible else 0.0)
                e.set_pan("bass", float(self.strip_pan[strip]))
        e.set_gain("poly", 1.0)
        e.set_pan("poly", 0.5)  # the poly is center-panned (ffi.rs:1291)

    # --- the render pipeline (ffi.rs:1043-1380) ------------------------------------------------------

    def render(self, frames: int) -> np.ndarray:
        """Interleaved stereo ``[frames*2]`` float32, like gooey_engine_render.

        On an internal error the engine latches a terminal error state and
        outputs silence forever (ffi.rs:2086-2122)."""
        if self.error is not None:
            return np.zeros(frames * 2, np.float32)
        try:
            out = self._render_blocks(frames)
            return out.T.reshape(-1)
        except Exception as exc:  # the catch_unwind panic fence
            self.error = f"{exc}\n{traceback.format_exc()}"
            if self.error_callback:
                try:
                    self.error_callback(str(exc))
                except Exception:
                    pass
            return np.zeros(frames * 2, np.float32)

    def _render_blocks(self, frames: int) -> np.ndarray:
        """``[2, frames]`` on the host: the span path for two blocks or
        more, else block by block, every block enqueued before the one copy
        back."""
        K = (frames + self.block - 1) // self.block
        if K >= 2 and self.span_rendering:
            out = self._render_span(K)
        else:
            outs = []
            rendered = 0
            while rendered < frames:
                outs.append(self._render_one_block())
                rendered += self.block
            out = torch.cat(outs, dim=-1)
        return out[:, :frames].cpu().numpy()

    def _tick_strips(self, e):
        """The strip sequencers into engine triggers, with blend snaps and
        per-step note overrides (their restores queued in ``_post_restore``),
        the MIDI-out queue, then the manual triggers."""
        B = self.block
        for strip, seq in enumerate(self.sequencers):
            name = self._strip_name(strip)
            kind, slot = e._names[name]
            for trig in seq.tick_block(B):
                if trig.blend is not None and self.blenders[strip] is not None:
                    cfg = self.blenders[strip].blend(*trig.blend)
                    # the snap is queued BEFORE the setter: set_config stages
                    # eagerly and consumes the kind's pending snaps
                    # (ffi.rs:1163-1205 snap_params)
                    e._snap_queue.append((kind, slot))
                    e.set_config(name, cfg)
                if trig.note is not None and kind != "bass":
                    # a step's MIDI note overrides param 0 for its trigger
                    mod = FAMILIES[kind]
                    pname = mod.PARAM_NAMES[0]
                    saved = e.get_param(name, pname)
                    freq = music.midi_to_freq(trig.note)
                    lo, hi = getattr(mod, "FREQ_RANGE", (30.0, 120.0))
                    e._snap_queue.append((kind, slot))
                    e.set_param(name, pname, float(np.clip((freq - lo) / (hi - lo), 0, 1)))
                    e._trigger_queue.append(((kind, slot), trig.velocity, trig.offset))
                    # two note steps of one strip in a block keep the FIRST
                    # saved value (the second would read the override)
                    if not any(n == name and p == pname for n, p, _ in self._post_restore):
                        self._post_restore.append((name, pname, saved))
                else:
                    e._trigger_queue.append(((kind, slot), trig.velocity, trig.offset))
                if len(self.midi_out) < 64:  # overflow drops new (ffi.rs:69-71)
                    self.midi_out.append((self.sample_count + trig.offset, name,
                                          trig.velocity))
        for strip, velocity in self._pending_triggers:
            # manual triggers land at the block start (ffi.rs:1078-1095)
            e._trigger_queue.append((e._names[self._strip_name(strip)], velocity, 0))
        self._pending_triggers.clear()

    def _replay(self, beat: float, running: bool):
        """Performance clip replay (ffi.rs:1212-1235)."""
        action = self.performance.update_clock(beat, running)
        self.performance.applying_playback = True
        if action is not None:
            if action[0] == "trigger":
                ev = action[1]
                self._apply_chord(ev.root, ev.scale_type, ev.degree, ev.voicing, ev.preset,
                                  ev.octave, ev.velocity)
            else:
                self._release_chord()
        for hit in self.performance.take_sampler_hits():
            self.sampler_trigger(hit.rack, hit.slot, hit.velocity, from_playback=True)
        self.performance.applying_playback = False

    # --- planned-span render ----------------------------------------------------------

    def _plan_host_block(self, beat: float, running: bool):
        """The host half of ``_render_one_block`` for one planned block, in
        the same order with the same queues; the engine's parameter writes
        land in the block's stage snapshot (the caller holds
        ``engine._state`` at None, so the eager ``_stage_kind`` is inert).
        Returns the block's events, stage snapshot and granulator and rack
        events (numpy)."""
        B = self.block
        e = self.engine
        for rack in self.racks:
            if rack:
                rack.activate_start_if_due(beat)
        self._tick_strips(e)
        self._replay(beat, running)
        self._stage_strip_gating()

        ev = e._collect_events()
        stage_tgt, stage_snap = {}, {}
        for kind in e.instrument_kinds():
            stage_tgt[kind] = np.stack(e._targets[kind]).astype(np.float32)
            mask = np.zeros(len(e._targets[kind]), bool)
            for k2, s2 in e._snap_queue:
                if k2 == kind:
                    mask[s2] = True
            stage_snap[kind] = mask
        e._snap_queue.clear()
        for kind in e.instrument_kinds():
            e._dirty[kind] = False
        pan_tgt = np.asarray(e._pan, np.float32).copy()
        gain_tgt = np.asarray(e._gain, np.float32).copy()
        e._mix_dirty = False

        gran_ev = self.gran_host.collect_events(self.sample_count, B)
        rack_evs = tuple(rack.collect_events(self.sample_count, B)
                         for rack in self.racks if rack is not None)

        # the span restores note overrides after the block's plan (the
        # per-block path after its dispatch); both queue the snap
        for name, pname, saved in self._post_restore:
            e.set_param(name, pname, saved)
            e._snap_queue.append(e._names[name])
        self._post_restore = []

        bs = self.sample_count
        e.sample_count += B
        self.sample_count += B
        return dict(ev=ev, stage_tgt=stage_tgt, stage_snap=stage_snap, pan_tgt=pan_tgt,
                    gain_tgt=gain_tgt, gran=gran_ev, racks=rack_evs, bs=bs)

    def _render_span(self, K: int) -> torch.Tensor:
        """Render K blocks through the planned span -> ``[2, K*B]`` on the device."""
        B = self.block
        e = self.engine
        dev = self.device
        self._upload_arenas()

        # 1. the loop mixer's K blocks in one call (the streamed WSOLA
        # path), which also gives each block's transport beat
        beats = []
        loop_out = self.mixer.render_blocks(K, collect_beats=beats)
        loop_seq = loop_out.reshape(2, K, B).permute(1, 0, 2)   # [K, 2, B]

        # 2. plan K host halves with the eager staging off; the strips are
        # gated before the first _stage (which may build the state), so
        # block 0 ramps from the gated pan and gain
        self._routing()
        self._stage_strip_gating()
        e._stage()
        carry_engine = dict(e._state)
        e._state = None
        try:
            plans = [self._plan_host_block(beat, running) for beat, running in beats]
        finally:
            e._state = carry_engine

        # 3. ragged trigger blocks: a kind with a multi-trigger block takes
        # [V, Kmax] slots in every block (offsets padded with B, velocities 0)
        kinds = e.instrument_kinds()
        for kind in kinds:
            offs = [p["ev"][kind + "_off"] for p in plans]
            km = max(o.shape[1] if o.ndim == 2 else 1 for o in offs)
            if km == 1 and all(o.ndim == 1 for o in offs):
                continue
            fkey = {"poly": "poly_freq", "bass": "bass_freq"}.get(kind)
            for p in plans:
                evd = p["ev"]
                fills = [(kind + "_off", B), (kind + "_vel", 0.0)]
                if fkey is not None:
                    fills.append((fkey, 0.0))
                for key, fill in fills:
                    a = evd[key]
                    a2 = a[:, None] if a.ndim == 1 else a
                    pad = np.full((a2.shape[0], km - a2.shape[1]), fill, a2.dtype)
                    evd[key] = np.concatenate([a2, pad], axis=1)

        # 4. stack the plans and upload them once for the span
        stacked = {
            "ev": {k: np.stack([p["ev"][k] for p in plans]) for k in plans[0]["ev"]},
            "stage_tgt": {k: np.stack([p["stage_tgt"][k] for p in plans]) for k in kinds},
            "stage_snap": {k: np.stack([p["stage_snap"][k] for p in plans]) for k in kinds},
            "pan_tgt": np.stack([p["pan_tgt"] for p in plans]),
            "gain_tgt": np.stack([p["gain_tgt"] for p in plans]),
        }
        xs = _upload(stacked, dev)
        xs.update(loop_out=loop_seq, gran=[p["gran"] for p in plans],
                  racks=[p["racks"] for p in plans], bs=[p["bs"] for p in plans])

        enabled = self._enabled_fx()
        fx_key = tuple((ent.effect_id, chain_mod.entry_flag(ent)) for _, ent in enabled)
        g = self.graph
        g._stage()
        rack_slots = tuple(i for i, r in enumerate(self.racks) if r is not None)

        carry = dict(
            engine=carry_engine, gran=self.gran_state,
            racks=tuple(self.rack_states[i] for i in rack_slots),
            fx=tuple(self.fx.states[i] for i, _ in enabled), master=self.master,
            gbank=g._smooth, gracks=tuple(tuple(t.rack.states) for t in g.tracks),
            strip_peak=self._strip_peak_dev,
            graph_peak=torch.zeros(len(g.tracks), dtype=torch.float32, device=dev))
        consts = dict(
            source_matrix=self._source_matrix, graph_targets=g._targets_dev,
            graph_routing=g._routing_dev,
            graph_rack_targets=tuple(tuple(torch.as_tensor(a, device=dev)
                                           for a in t.rack.targets_list())
                                     for t in g.tracks),
            fx_targets=tuple(torch.as_tensor(ent.targets, device=dev) for _, ent in enabled),
            limiter_threshold=self.limiter_threshold, strip_idx=self._strip_voice_idx)
        carry2, bus_seq = _span_render(
            carry, consts, xs, kinds=kinds, sample_rate=self.sr, block_size=B,
            smooth_coeff=self._smooth_coeff, family_static=e._static_key(),
            lfo_routes=e._routes_static(), fx_key=fx_key,
            limiter_enabled=bool(self.limiter_enabled), rack_slots=rack_slots,
            graph_rack_keys=tuple(t.rack.static_key() for t in g.tracks),
            graph_coeff=g._coeff, sidechain_voice=self._sidechain_voice(enabled))

        # 5. land the final carry back in the host objects
        e._state = dict(carry2["engine"])
        self.gran_state = carry2["gran"]
        for i, slot in enumerate(rack_slots):
            self.rack_states[slot] = carry2["racks"][i]
        for (i, _), st in zip(enabled, carry2["fx"]):
            self.fx.states[i] = st
        self.master = carry2["master"]
        g._smooth = carry2["gbank"]
        for t, st in zip(g.tracks, carry2["gracks"]):
            t.rack.states = list(st)
        self._strip_peak_dev = carry2["strip_peak"]
        g.record_peaks(carry2["graph_peak"])
        return bus_seq.permute(1, 0, 2).reshape(2, -1)

    # --- the per-block path -------------------------------------------------------------

    def _render_one_block(self) -> torch.Tensor:
        """One block -> ``[2, B]`` on the device."""
        B = self.block
        e = self.engine

        # 1. sampler rack transport-due activation (ffi.rs:1143-1150)
        beat = self.mixer.clip_grid.transport_beat
        for rack in self.racks:
            if rack:
                rack.activate_start_if_due(beat)
        # 2-3. strip sequencers, manual triggers
        self._tick_strips(e)
        # 4. performance clip replay
        self._replay(beat, self.mixer.clip_grid.transport_running)
        # 5. strip gating
        self._routing()
        self._stage_strip_gating()

        # 6. instrument banks -> panned source frames (LFO routes inside)
        e._stage()
        events = e._collect_events()
        e._stage()
        events["source_matrix"] = self._source_matrix
        new_state, sources, all_voices, voice_peaks = eng._render_all(
            e._state, events, kinds=e.instrument_kinds(), sample_rate=self.sr, block_size=B,
            smooth_coeff=e.smooth_coeff, limiter_threshold=1.0,
            family_static=e._static_key(), lfo_routes=e._routes_static(), fx_order=(),
            sidechain_voice=-1, collect_sources=True)
        e._state = new_state
        e.sample_count += B

        # note overrides restored after the triggers latched them (one entry
        # per note-bearing step; the snap queued before the setter)
        for name, pname, saved in self._post_restore:
            e._snap_queue.append(e._names[name])
            e.set_param(name, pname, saved)
        self._post_restore = []

        # 7. strip peaks folded on the device (ffi.rs:649-658)
        self._strip_peak_dev = torch.maximum(self._strip_peak_dev,
                                             voice_peaks[self._strip_voice_idx])

        # 8. granulator (a center-panned mono source)
        gev = self.gran_host.collect_events(self.sample_count, B)
        self.gran_state, gout = gran_mod.render_block(
            self.gran_state, gev, self.sample_count, sample_rate=self.sr, block_size=B,
            smooth_coeff=self._smooth_coeff)
        # `sources` is this block's own tensor (the scatter's output)
        sources[graph_mod.SOURCE_GRANULATOR] = torch.stack([gout * _SQRT_HALF,
                                                            gout * _SQRT_HALF])
        # 9. loop mixer
        sources[graph_mod.SOURCE_LOOPMIXER] = self.mixer.render_block()

        # 10. sampler racks (a changed arena uploaded first)
        self._upload_arenas()
        for i, rack in enumerate(self.racks):
            if rack is None:
                continue
            sev = rack.collect_events(self.sample_count, B)
            self.rack_states[i], rout = samp_mod.render_block(
                self.rack_states[i], sev, self.sample_count, sample_rate=self.sr,
                block_size=B)
            sources[graph_mod.SOURCE_SAMPLER_BASE + i] = rout

        # 11. mixer graph
        master_bus, track_peaks = self.graph.render(sources, B)
        self.graph.record_peaks(track_peaks)

        # 12-14. master gain -> global FX (enabled, user order) -> limiter
        self.master, mtraj = smooth_block(self.master, self._smooth_coeff, B)
        bus = master_bus * mtraj[None, :]
        enabled = self._enabled_fx()
        sc_voice = self._sidechain_voice(enabled)
        sidechain = None
        if sc_voice >= 0:
            # the detector tracks the chosen strip's dry voice (compressor.rs:230-247)
            sc = all_voices[sc_voice]
            sidechain = torch.stack([sc, sc], dim=0)
        new_states, bus = _fx_chain_block(
            [self.fx.states[i] for i, _ in enabled], bus,
            [np.asarray(ent.targets, np.float32) for _, ent in enabled],
            tuple((ent.effect_id, chain_mod.entry_flag(ent)) for _, ent in enabled), sidechain,
            self.limiter_threshold, sample_rate=self.sr,
            limiter_enabled=bool(self.limiter_enabled))
        for (i, _), st in zip(enabled, new_states):
            self.fx.states[i] = st

        self.sample_count += B
        return bus

    # --- misc API ------------------------------------------------------------------------------------

    def set_master_gain(self, gain: float):
        self._master_target = float(np.float32(gain))
        self.master = self.master.with_targets(np.float32(gain))

    def take_strip_peak(self, strip: int) -> float:
        """Drain the device accumulator into the host mirror (the only peak
        read, a host query off the render path)."""
        dev = self._strip_peak_dev.cpu().numpy()
        if dev.any():
            np.maximum(self.strip_peak, dev, out=self.strip_peak)
            self._strip_peak_dev = torch.zeros_like(self._strip_peak_dev)
        p = float(self.strip_peak[strip])
        self.strip_peak[strip] = 0.0
        return p

    def drain_midi_out(self):
        out = self.midi_out
        self.midi_out = []
        return out

    def bounce_to_buffer(self, frames: int) -> np.ndarray:
        """Offline render (interleaved), like gooey_engine_bounce_to_buffer."""
        return self.render(frames)

    def bounce_to_wav(self, path, frames: int, bits: int = 16):
        inter = self.render(frames)
        io_wav.write_wav(path, inter.reshape(-1, 2).T, int(self.sr), bits=bits)
        return inter
