"""KickDrum: 3-oscillator analog-style kick, batched over ``[V, B]``
(port of libgooey_tpu/instruments/kick.py:39-408).

Behavioral reference: src/instruments/kick.rs.  Sub sine at f, punch
additive triangle at 2.5f, click noise through a cheap resonant high-pass,
an exponential pitch envelope, a phase-modulator transient, a pink-noise
layer through a resonant low-pass, the feedback waveshaper's overdrive and
a master amplitude envelope with velocity laws.

A bank of at most ``ops.voice.MAX_FUSED_VOICES`` voices with one trigger
slot a block takes the kit path (``fused=True``, the gate of kick.py:253-275):
its sources in the ``kit_sources`` kernel, the envelope follower between,
its 4x drive in ``kit_drive`` (ops/voice.py, ops/voice_kernels.py; the
TPU's ``pallas_voice.kick_render_fused``).  Every other bank renders the
stage path below, whose recurrences run in the bank kernels
(ops/bank_kernels.py); the rest is elementwise math.  At ``os_mode`` 1 and
2 the drive runs the feedback waveshaper's scan path (its tanh through
``ops/oversample.process``) in place of ``fbws_bank``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from libgooey_tpu_torch.core import dsp
from libgooey_tpu_torch.core.envelope import ADSR, amplitude
from libgooey_tpu_torch.core.smoother import SmootherBank
from libgooey_tpu_torch.effects import feedback_waveshaper as fbws
from libgooey_tpu_torch.instruments.common import NEVER, VoiceBlock, phase_mod_env
from libgooey_tpu_torch.ops import filters, noise, osc, voice

# --- parameter table (order = host ABI, kick.rs:80-99; all normalized 0-1) ---

PARAM_NAMES = (
    "frequency",            # 0: 30-120 Hz
    "punch",                # 1
    "sub",                  # 2
    "click",                # 3
    "oscillator_decay",     # 4: 0.01-4 s
    "pitch_envelope_amount",  # 5
    "pitch_envelope_curve",   # 6: 0.1-4
    "volume",               # 7
    "pitch_start_ratio",    # 8: 1-10x
    "phase_mod_amount",     # 9
    "noise_amount",         # 10
    "noise_cutoff",         # 11: 20-10000 Hz
    "noise_resonance",      # 12: 0-5
    "overdrive",            # 13
    "feedback",             # 14: ->0-0.98
    "feedback_cutoff",      # 15: 200-4000 Hz
    "amp_decay",            # 16: 0-4 s
    "amp_decay_curve",      # 17: 0.1-10
    "tuning",               # 18: ±12 semitones
)
NUM_PARAMS = len(PARAM_NAMES)
PARAM_INDEX = {n: i for i, n in enumerate(PARAM_NAMES)}

# normalization ranges (kick.rs:14-59)
FREQ_RANGE = (30.0, 120.0)
OSC_DECAY_RANGE = (0.01, 4.0)
PITCH_CURVE_RANGE = (0.1, 4.0)
PITCH_RATIO_RANGE = (1.0, 10.0)
NOISE_CUTOFF_RANGE = (20.0, 10_000.0)
NOISE_RES_RANGE = (0.0, 5.0)
AMP_DECAY_RANGE = (0.0, 4.0)
AMP_CURVE_RANGE = (0.1, 10.0)

VELOCITY_TO_DECAY = 0.5   # kick.rs:818
CLICK_FILTER_HZ = 8000.0  # kick.rs:799
CLICK_FILTER_RES = 4.0


def overdrive_to_drive(amount):
    """Cubic map 0-1 -> 1-41x drive (kick.rs:68-70)."""
    return 1.0 + amount * amount * amount * 40.0


@dataclass(frozen=True)
class KickConfig:
    """Normalized 0-1 preset (kick.rs:80-99)."""

    frequency: float = 0.22
    punch: float = 0.0
    sub: float = 1.0
    click: float = 0.0
    oscillator_decay: float = 0.12
    pitch_envelope_amount: float = 0.7
    pitch_envelope_curve: float = 0.01
    volume: float = 0.85
    pitch_start_ratio: float = 0.222
    phase_mod_amount: float = 0.0
    noise_amount: float = 0.0
    noise_cutoff: float = 0.198
    noise_resonance: float = 0.2
    overdrive: float = 0.0
    feedback: float = 0.0
    feedback_cutoff: float = 0.474
    amp_decay: float = 0.125
    amp_decay_curve: float = 0.091

    tuning: float = 0.5

    def as_array(self) -> np.ndarray:
        return np.clip(
            np.array([getattr(self, n) for n in PARAM_NAMES], np.float32), 0.0, 1.0
        )

    # factory presets (kick.rs:257-351)
    @staticmethod
    def tight() -> "KickConfig":
        return KickConfig(
            frequency=0.22, punch=0.0, sub=1.0, click=0.0, oscillator_decay=0.12,
            pitch_envelope_amount=0.7, pitch_envelope_curve=0.01, volume=0.85,
            pitch_start_ratio=0.64, phase_mod_amount=1.0, noise_amount=0.07,
            noise_cutoff=0.01, noise_resonance=0.02, overdrive=0.2, feedback=0.0,
            feedback_cutoff=0.47, amp_decay=0.12, amp_decay_curve=0.02,
        )

    @staticmethod
    def punch_preset() -> "KickConfig":
        return KickConfig(
            frequency=0.5, punch=0.2, sub=1.0, click=0.2, oscillator_decay=0.12,
            pitch_envelope_amount=0.6, pitch_envelope_curve=0.1, volume=0.85,
            pitch_start_ratio=0.24, phase_mod_amount=1.0, noise_amount=0.07,
            noise_cutoff=0.11, noise_resonance=0.42, overdrive=0.2, feedback=0.0,
            feedback_cutoff=0.47, amp_decay=0.12, amp_decay_curve=0.02,
        )

    @staticmethod
    def loose() -> "KickConfig":
        return KickConfig(
            frequency=0.32, punch=0.4, sub=1.0, click=0.0, oscillator_decay=0.62,
            pitch_envelope_amount=0.2, pitch_envelope_curve=0.12, volume=0.85,
            pitch_start_ratio=0.84, phase_mod_amount=1.0, noise_amount=0.07,
            noise_cutoff=0.01, noise_resonance=0.02, overdrive=0.25, feedback=0.0,
            feedback_cutoff=0.47, amp_decay=0.12, amp_decay_curve=0.12,
        )

    @staticmethod
    def dirt() -> "KickConfig":
        return KickConfig(
            frequency=0.62, punch=0.1, sub=1.0, click=0.1, oscillator_decay=0.1,
            pitch_envelope_amount=0.6, pitch_envelope_curve=0.1, volume=0.85,
            pitch_start_ratio=0.44, phase_mod_amount=1.0, noise_amount=0.2,
            noise_cutoff=0.1, noise_resonance=0.82, overdrive=0.2, feedback=0.0,
            feedback_cutoff=0.47, amp_decay=0.1, amp_decay_curve=0.1,
        )


PRESETS = {
    "default": KickConfig.tight,
    "tight": KickConfig.tight,
    "punch": KickConfig.punch_preset,
    "loose": KickConfig.loose,
    "dirt": KickConfig.dirt,
}


class KickState(NamedTuple):
    """State of a bank of V kick voices."""

    params: SmootherBank          # [V, NUM_PARAMS]
    trig_sample: torch.Tensor     # [V] i32 — global sample of last trigger
    velocity: torch.Tensor        # [V] latched at trigger
    pitch_mult: torch.Tensor      # [V] triggered_pitch_multiplier
    pitch_curve: torch.Tensor     # [V] latched actual 0.1-4 (1.0 == linear)
    amp_decay: torch.Tensor       # [V] latched actual seconds (velocity-scaled)
    amp_curve: torch.Tensor       # [V] latched actual 0.1-10
    pm_active: torch.Tensor       # [V] phase modulator armed at trigger
    click_hp: filters.OnePoleState
    noise_svf: filters.SVFState
    pink: noise.PinkState
    shaper: fbws.FBShaperState


def init_state(num_voices: int, config: Optional[KickConfig] = None, targets=None, *,
               device) -> KickState:
    """Create a V-voice bank on ``device``.  ``targets`` may be a ``[V, P]``
    array of per-voice normalized params (overrides ``config``)."""
    if targets is None:
        cfg = (config or KickConfig.tight()).as_array()
        targets = np.broadcast_to(cfg, (num_voices, NUM_PARAMS))
    targets = np.array(targets, np.float32)
    tgt = torch.as_tensor(targets, device=device)
    v = (num_voices,)
    ratio = 1.0 + (
        dsp.denormalize(tgt[:, PARAM_INDEX["pitch_start_ratio"]], *PITCH_RATIO_RANGE)
        - 1.0
    ) * tgt[:, PARAM_INDEX["pitch_envelope_amount"]]

    def full(value, dtype=torch.float32):
        return torch.full(v, value, dtype=dtype, device=device)

    return KickState(
        params=SmootherBank.init(targets, device),
        trig_sample=full(int(NEVER), torch.int32),
        velocity=full(1.0),
        pitch_mult=ratio.to(torch.float32),
        pitch_curve=full(1.0),
        amp_decay=full(0.5),
        amp_curve=full(1.0),
        pm_active=full(0.0),
        click_hp=filters.OnePoleState.init(v, device),
        noise_svf=filters.SVFState.init(v, device),
        pink=noise.PinkState.init(v, device),
        shaper=fbws.FBShaperState.init(v, device),
    )


def render_block(
    state: KickState,
    trig_offset,
    trig_velocity,
    block_start,
    *,
    sample_rate: float,
    block_size: int,
    smooth_coeff: float,
    max_harmonics: int = 256,
    feedback_path: bool = False,
    os_mode: int = 4,
    overrides=None,
    fused: bool = True,
):
    """Render one block for the whole voice bank.

    Args:
      trig_offset: ``[V]`` int — sample offset of this block's trigger per
        voice, >= block_size for none — or ``[V, K]`` slot arrays when some
        voice takes several triggers this block (offsets ascending).
      trig_velocity: float, same shape as ``trig_offset``.
      block_start: int — global sample index of the block's start.

    Returns ``(new_state, out[V, B])``.  ``fused``: allow the kit path.
    """
    B = block_size
    sr = sample_rate
    dev = state.velocity.device
    if (fused and voice.use_kit(state.velocity)
            and voice.eligible(trig_offset, state.velocity.shape[0])
            and overrides is None and not feedback_path and os_mode == 4):
        return voice.kick_render_fused(state, trig_offset, trig_velocity, block_start,
                                       sample_rate=sr, block_size=B, smooth_coeff=smooth_coeff,
                                       max_harmonics=max_harmonics)
    vb = VoiceBlock(state.params, trig_offset, block_start, B, smooth_coeff, PARAM_INDEX,
                    overrides=overrides)
    ptraj, value_at_trigger, eff = vb.ptraj, vb.value_at_trigger, vb.eff
    at_trig = vb.at_trig

    # --- trigger-time snapshots (kick.rs:971-1086) --------------------------
    vel_new = torch.clamp(torch.as_tensor(trig_velocity, dtype=torch.float32, device=dev),
                          0.0, 1.0)
    pea = value_at_trigger("pitch_envelope_amount")
    psr = dsp.denormalize(value_at_trigger("pitch_start_ratio"), *PITCH_RATIO_RANGE)
    pitch_mult_new = 1.0 + (psr - 1.0) * pea
    pc = dsp.denormalize(value_at_trigger("pitch_envelope_curve"), *PITCH_CURVE_RANGE)
    pitch_curve_new = torch.where((pc - 1.0).abs() < 0.01, 1.0, pc)
    decay_scale_new = 1.0 - VELOCITY_TO_DECAY * vel_new * vel_new
    ad = dsp.denormalize(value_at_trigger("amp_decay"), *AMP_DECAY_RANGE) * decay_scale_new
    ac = dsp.denormalize(value_at_trigger("amp_decay_curve"), *AMP_CURVE_RANGE)
    amp_curve_new = torch.where((ac - 1.0).abs() < 0.01, 1.0, ac)
    pm_active_new = (value_at_trigger("phase_mod_amount") > 0.001).to(torch.float32)

    vel = eff(vel_new, state.velocity)
    pitch_mult = eff(pitch_mult_new, state.pitch_mult)
    pitch_curve = eff(pitch_curve_new, state.pitch_curve)
    amp_decay_s = eff(ad, state.amp_decay)
    amp_curve = eff(amp_curve_new, state.amp_curve)
    pm_active = eff(pm_active_new, state.pm_active)

    _trig_eff, elapsed_i, idx_f, elapsed = vb.elapsed(state.trig_sample, sr)

    # --- live smoothed params (kick.rs:1097-1232) ---------------------------
    decay_scale = 1.0 - VELOCITY_TO_DECAY * vel * vel
    base_decay = (
        dsp.denormalize(ptraj("oscillator_decay"), *OSC_DECAY_RANGE) * decay_scale
    )
    base_freq = dsp.denormalize(ptraj("frequency"), *FREQ_RANGE) * dsp.tuning_to_multiplier(
        ptraj("tuning")
    )

    # pitch envelope (decay live, curve latched; sustain 0)
    pitch_env = amplitude(
        ADSR(0.001, base_decay, 0.0, base_decay * 0.2, 1.0, pitch_curve), elapsed
    )
    fmult = 1.0 + (pitch_mult - 1.0) * pitch_env

    # phase-modulator transient: up to 3x freq boost at full amount
    pm_amt = ptraj("phase_mod_amount")
    pm_env = phase_mod_env(elapsed, pm_active > 0.5)
    fmult = fmult * torch.where(pm_amt > 0.001, 1.0 + pm_env * pm_amt * 2.0, 1.0)

    # --- oscillators ---------------------------------------------------------
    osc_env = amplitude(ADSR(0.001, base_decay, 0.0, base_decay * 0.2, 1.0, 1.0), elapsed)
    sub_out = osc.sine(idx_f, base_freq * fmult, sr) * osc_env * ptraj("sub")

    if max_harmonics > 0:
        punch_out = (
            osc.triangle_additive(idx_f, base_freq * 2.5 * fmult, sr, max_harmonics)
            * osc_env
            * (ptraj("punch") * 0.7)
        )
    else:
        punch_out = 0.0

    click_env = amplitude(
        ADSR(0.001, base_decay * 0.2, 0.0, base_decay * 0.02, 1.0, 1.0), elapsed
    )
    click_vel_scale = 0.6 + 0.4 * vel
    click_raw = (
        osc.noise(idx_f)
        * click_env
        * (ptraj("click") * 0.15 * click_vel_scale)
    )
    click_hp, click_out = filters.resonant_highpass_block(
        state.click_hp, click_raw, CLICK_FILTER_HZ, CLICK_FILTER_RES, sr, reset=at_trig
    )

    # --- pink-noise layer (kick.rs:1174-1193) --------------------------------
    noise_amt = ptraj("noise_amount")
    pink_state, pink_sig = noise.pink_block(state.pink, elapsed_i, sr, reset=at_trig)
    noise_cut = dsp.denormalize(ptraj("noise_cutoff"), *NOISE_CUTOFF_RANGE)
    noise_res = dsp.denormalize(ptraj("noise_resonance"), *NOISE_RES_RANGE)
    noise_svf, noise_filtered = filters.resonant_lowpass_block(
        state.noise_svf, pink_sig, noise_cut, noise_res, sr, reset=at_trig
    )
    noise_env = amplitude(ADSR(0.001, base_decay, 0.0, base_decay * 0.2, 1.0, 1.0), elapsed)
    noise_out = torch.where(
        noise_amt > 0.001, noise_filtered * noise_env * noise_amt * 0.5, 0.0
    )

    total = sub_out + punch_out + click_out + noise_out

    # --- overdrive (kick.rs:1243-1262) ---------------------------------------
    drive = overdrive_to_drive(ptraj("overdrive"))
    fb = ptraj("feedback") * 0.98
    fbc = fbws.filter_coeff(200.0 + ptraj("feedback_cutoff") * 3800.0, sr)
    shaper_state, shaped = fbws.process_block(
        state.shaper, total, drive, fb, fbc, 1.0, sr,
        feedback_path=feedback_path, os_mode=os_mode,
    )

    # --- master amplitude (kick.rs:1264-1284) --------------------------------
    amp_decay_floor = torch.clamp(amp_decay_s, min=0.001)
    amp_env = amplitude(
        ADSR(0.001, amp_decay_floor, 0.0, amp_decay_floor * 0.2, 0.5, amp_curve),
        elapsed,
    )
    out = shaped * amp_env * torch.sqrt(vel) * ptraj("volume")

    # --- state advance --------------------------------------------------------
    new_state = KickState(
        params=vb.advance_bank(),
        trig_sample=vb.latch(vb.block_start + vb.trig_offset, state.trig_sample),
        velocity=vb.latch(vel_new, state.velocity),
        pitch_mult=vb.latch(pitch_mult_new, state.pitch_mult),
        pitch_curve=vb.latch(pitch_curve_new, state.pitch_curve),
        amp_decay=vb.latch(ad, state.amp_decay),
        amp_curve=vb.latch(amp_curve_new, state.amp_curve),
        pm_active=vb.latch(pm_active_new, state.pm_active),
        click_hp=click_hp,
        noise_svf=noise_svf,
        pink=pink_state,
        shaper=shaper_state,
    )
    return new_state, out
