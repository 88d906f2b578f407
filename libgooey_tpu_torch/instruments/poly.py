"""PolySynth: 6-voice dual-oscillator subtractive synth with full ADSR
(port of libgooey_tpu/instruments/poly.py).

Behavioral reference: src/instruments/poly_synth.rs.

* per voice: two detuned polyBLEP saw<->square oscillators (mix *0.5), TPT
  SVF with filter ADSR (cutoff swept up by env*amount), amp ADSR with
  sustain and manual release; exponential time map ``0.001 * 5000^x``
  (poly_synth.rs:19-22);
* voice stealing by oldest trigger order, handled by the host (the engine);
* fixed 1/4 headroom, not per-active-voice normalization
  (poly_synth.rs:517-523);
* envelope configs latched at trigger; params per *synth*, not per voice.

Bank layout: ``S`` synth instances x ``NUM_VOICES`` lanes, flattened to
``[S*6]``; parameter smoothers live per synth and broadcast to lanes.
Releases arrive as per-lane release-offset events.  Kernels: the two
oscillators' phases run in ``affine1_bank`` (``scan.phase_cumsum_reset``),
the filter in ``svf_bank`` (``filters.svf_tpt_outputs``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from libgooey_tpu_torch.core.envelope import ADSR, amplitude
from libgooey_tpu_torch.core.smoother import SmootherBank
from libgooey_tpu_torch.instruments.common import NEVER, VoiceBlock
from libgooey_tpu_torch.ops import filters, osc
from libgooey_tpu_torch.ops import scan as gscan

NUM_VOICES = 6  # poly_synth.rs:219

PARAM_NAMES = (
    "osc_shape", "detune_amount", "filter_cutoff", "filter_resonance",
    "filter_env_amount", "amp_attack", "amp_decay", "amp_sustain",
    "amp_release", "filter_attack", "filter_decay", "filter_sustain",
    "filter_release", "volume",
)
NUM_PARAMS = len(PARAM_NAMES)
PARAM_INDEX = {n: i for i, n in enumerate(PARAM_NAMES)}


def env_time(normalized):
    """0-1 -> 1 ms..5 s exponential (poly_synth.rs:19-22)."""
    return 0.001 * torch.pow(5000.0, normalized)


def cutoff_hz(normalized):
    return 20.0 * torch.pow(18000.0 / 20.0, normalized)


@dataclass(frozen=True)
class PolySynthConfig:
    osc_shape: float = 0.0
    detune_amount: float = 0.2
    filter_cutoff: float = 0.6
    filter_resonance: float = 0.15
    filter_env_amount: float = 0.3
    amp_attack: float = 0.55
    amp_decay: float = 0.7
    amp_sustain: float = 0.7
    amp_release: float = 0.8
    filter_attack: float = 0.5
    filter_decay: float = 0.65
    filter_sustain: float = 0.4
    filter_release: float = 0.75
    volume: float = 0.7

    def as_array(self) -> np.ndarray:
        return np.clip(
            np.array([getattr(self, n) for n in PARAM_NAMES], np.float32), 0.0, 1.0
        )

    @staticmethod
    def default():
        return PolySynthConfig()

    @staticmethod
    def pad():
        return PolySynthConfig(0.0, 0.4, 0.45, 0.2, 0.2, 0.8, 0.75, 0.8, 0.85,
                               0.75, 0.7, 0.5, 0.8, 0.6)

    @staticmethod
    def pluck():
        return PolySynthConfig(0.3, 0.15, 0.55, 0.25, 0.5, 0.0, 0.5, 0.0, 0.45,
                               0.0, 0.45, 0.0, 0.4, 0.75)

    @staticmethod
    def keys():
        return PolySynthConfig(0.5, 0.1, 0.65, 0.1, 0.35, 0.25, 0.6, 0.5, 0.6,
                               0.2, 0.55, 0.3, 0.55, 0.7)

    @staticmethod
    def strings():
        # poly_synth.rs:125-142
        return PolySynthConfig(0.0, 0.5, 0.5, 0.1, 0.15, 0.85, 0.7, 0.9, 0.85,
                               0.8, 0.7, 0.6, 0.8, 0.5)


PRESETS = {
    "default": PolySynthConfig.default,
    "pad": PolySynthConfig.pad,
    "pluck": PolySynthConfig.pluck,
    "keys": PolySynthConfig.keys,
    "strings": PolySynthConfig.strings,
}


class PolyState(NamedTuple):
    params: SmootherBank          # [S, NUM_PARAMS] (per synth)
    trig_sample: torch.Tensor     # [S*6] i32
    release_sample: torch.Tensor  # [S*6] i32 (NEVER = not released)
    ever: torch.Tensor            # [S*6] bool: the lane has been triggered
    velocity: torch.Tensor        # [S*6]
    freq: torch.Tensor            # [S*6] Hz latched at trigger
    amp_adsr: torch.Tensor        # [S*6, 4] latched seconds/level
    filt_adsr: torch.Tensor       # [S*6, 4]
    phase_a: torch.Tensor         # [S*6]
    phase_b: torch.Tensor         # [S*6]
    svf: filters.SVFState         # [S*6]


def init_state(num_synths: int, config: Optional[PolySynthConfig] = None, targets=None, *,
               device) -> PolyState:
    if targets is None:
        targets = np.broadcast_to((config or PolySynthConfig()).as_array(),
                                  (num_synths, NUM_PARAMS))
    V = num_synths * NUM_VOICES
    adsr0 = torch.tensor([[0.01, 0.3, 0.7, 0.5]], dtype=torch.float32, device=device)
    return PolyState(
        params=SmootherBank.init(targets, device),
        trig_sample=torch.full((V,), int(NEVER), dtype=torch.int32, device=device),
        release_sample=torch.full((V,), int(NEVER), dtype=torch.int32, device=device),
        ever=torch.zeros((V,), dtype=torch.bool, device=device),
        velocity=torch.ones((V,), dtype=torch.float32, device=device),
        freq=torch.full((V,), 440.0, dtype=torch.float32, device=device),
        amp_adsr=adsr0.repeat(V, 1),
        filt_adsr=adsr0.repeat(V, 1),
        phase_a=torch.zeros((V,), dtype=torch.float32, device=device),
        phase_b=torch.zeros((V,), dtype=torch.float32, device=device),
        svf=filters.SVFState.init((V,), device),
    )


def _adsr_snapshot(vat, prefix: str) -> torch.Tensor:
    """``[..., 4]`` (attack s, decay s, sustain, release s) read at trigger."""
    return torch.stack([
        torch.clamp(env_time(vat(prefix + "_attack")), min=0.001),
        torch.clamp(env_time(vat(prefix + "_decay")), min=0.001),
        torch.clamp(vat(prefix + "_sustain"), 0.0, 1.0),
        torch.clamp(env_time(vat(prefix + "_release")), min=0.001),
    ], dim=-1)


def render_block(
    state: PolyState,
    trig_offset,       # [S*6] i32 (B = none), or [S*6, K]
    trig_velocity,     # like trig_offset
    block_start,
    *,
    trig_freq=None,    # like trig_offset: Hz for this block's triggers
    release_offset=None,  # [S*6] i32 (B = none)
    sample_rate: float,
    block_size: int,
    smooth_coeff: float,
    overrides=None,
):
    """Render one block; returns ``(new_state, out[S, B])``: one mixed lane
    per synth (fixed 1/4 headroom applied)."""
    sr = sample_rate
    B = block_size
    dev = state.velocity.device
    V = state.trig_sample.shape[0]
    S = V // NUM_VOICES

    # per-lane expanded smoother bank for the trigger/latch machinery
    voice_bank = SmootherBank(
        current=torch.repeat_interleave(state.params.current, NUM_VOICES, dim=0),
        target=torch.repeat_interleave(state.params.target, NUM_VOICES, dim=0))
    vb = VoiceBlock(voice_bank, trig_offset, block_start, B, smooth_coeff,
                    PARAM_INDEX, overrides=overrides)
    ptraj, vat, eff = vb.ptraj, vb.value_at_trigger, vb.eff

    vel_new = torch.clamp(torch.as_tensor(trig_velocity, dtype=torch.float32, device=dev),
                          0.0, 1.0)
    freq_new = (torch.as_tensor(trig_freq, dtype=torch.float32, device=dev)
                if trig_freq is not None
                else torch.full((V,), 261.6256, dtype=torch.float32, device=dev))  # MIDI 60
    amp_new = _adsr_snapshot(vat, "amp")
    filt_new = _adsr_snapshot(vat, "filter")

    vel = eff(vel_new, state.velocity)
    freq0 = eff(freq_new, state.freq)
    if vb.legacy:
        amp_cfg = torch.where(vb.after[..., None], amp_new[:, None, :],
                              state.amp_adsr[:, None, :])
        filt_cfg = torch.where(vb.after[..., None], filt_new[:, None, :],
                               state.filt_adsr[:, None, :])
    else:
        amp_cfg = vb.eff_vec(amp_new, state.amp_adsr)
        filt_cfg = vb.eff_vec(filt_new, state.filt_adsr)
    ever = vb.after | state.ever[:, None]

    _t, _ei, _idx, elapsed = vb.elapsed(state.trig_sample, sr)
    reset = vb.at_trig

    # --- release handling: a new trigger cancels any release ------------------
    if release_offset is None:
        release_offset = torch.full((V,), B, dtype=torch.int32, device=dev)
    release_offset = torch.as_tensor(release_offset, device=dev).to(torch.int32)
    has_rel = release_offset < B
    rel_after = (vb.n_local[None, :] >= release_offset[:, None]) & has_rel[:, None]
    rel_eff = torch.where(rel_after, (vb.block_start + release_offset)[:, None],
                          state.release_sample[:, None])
    # a (re)trigger at or after the release clears it (trigger sets
    # release_time_start = None, poly_synth.rs trigger_note)
    trig_abs = vb.trig_eff(state.trig_sample)
    never = int(NEVER)
    rel_eff = torch.where(rel_eff <= trig_abs, never, rel_eff)
    n_global = vb.block_start + vb.n_local
    rel_elapsed = torch.where(
        rel_eff > never,
        torch.clamp((n_global[None, :] - rel_eff).to(torch.float32)
                    * float(np.float32(1.0 / sr)), min=0.0),
        0.0,  # 0 -> the held path in envelope.amplitude
    )

    # --- envelopes ---------------------------------------------------------------
    amp_env = amplitude(
        ADSR(amp_cfg[..., 0], amp_cfg[..., 1], amp_cfg[..., 2], amp_cfg[..., 3], 1.0, 0.5),
        elapsed, release_elapsed=rel_elapsed)
    filt_env = amplitude(
        ADSR(filt_cfg[..., 0], filt_cfg[..., 1], filt_cfg[..., 2], filt_cfg[..., 3], 1.0, 0.5),
        elapsed, release_elapsed=rel_elapsed)

    # --- oscillators -------------------------------------------------------------
    detune_ratio = 1.0 + ptraj("detune_amount") * 0.0175
    inc_a = freq0 / sr
    inc_b = freq0 * detune_ratio / sr
    # exact mod-1 accumulation (poly_synth.rs oscillators use f64 phase)
    ph_a = gscan.phase_cumsum_reset(inc_a, reset, state.phase_a)
    ph_b = gscan.phase_cumsum_reset(inc_b, reset, state.phase_b)
    shape = ptraj("osc_shape")

    def pair(phase, inc):
        saw = (2.0 * phase - 1.0) - osc.poly_blep(phase, inc)
        sq = (torch.where(phase < 0.5, 1.0, -1.0) + osc.poly_blep(phase, inc)
              - osc.poly_blep(torch.remainder(phase + 0.5, 1.0), inc))
        return saw * (1.0 - shape) + sq * shape

    osc_mix = (pair(ph_a, inc_a) + pair(ph_b, inc_b)) * 0.5

    # --- filter ------------------------------------------------------------------
    base_cut = cutoff_hz(ptraj("filter_cutoff"))
    mod_cut = torch.clamp(
        base_cut + ptraj("filter_env_amount") * filt_env * (18000.0 - base_cut),
        20.0, 18000.0)
    q = 0.5 + ptraj("filter_resonance") * 14.5
    svf_state, lp, _bp, _hp = filters.svf_tpt_outputs(state.svf, osc_mix, mod_cut, q, sr,
                                                      reset=reset)

    voice_out = lp * amp_env * torch.sqrt(vel) * ptraj("volume")
    voice_out = torch.where(ever, voice_out, 0.0)

    # mix NUM_VOICES lanes per synth with fixed 1/4 headroom
    out = voice_out.reshape(S, NUM_VOICES, B).sum(dim=1) * 0.25

    if vb.legacy:
        amp_adsr = torch.where(vb.has_trig[:, None], amp_new, state.amp_adsr)
        filt_adsr = torch.where(vb.has_trig[:, None], filt_new, state.filt_adsr)
    else:
        amp_adsr = vb.latch_vec(amp_new, state.amp_adsr)
        filt_adsr = vb.latch_vec(filt_new, state.filt_adsr)
    new_state = PolyState(
        params=SmootherBank(current=vb.advance_bank().current[::NUM_VOICES].contiguous(),
                            target=state.params.target),
        trig_sample=vb.latch(vb.block_start + vb.trig_offset, state.trig_sample),
        release_sample=rel_eff[:, -1].to(torch.int32),
        ever=ever[:, -1],
        velocity=vb.latch(vel_new, state.velocity),
        freq=vb.latch(freq_new, state.freq),
        amp_adsr=amp_adsr,
        filt_adsr=filt_adsr,
        phase_a=ph_a[:, -1],
        phase_b=ph_b[:, -1],
        svf=svf_state,
    )
    return new_state, out
