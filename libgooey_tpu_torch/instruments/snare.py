"""SnareDrum: tonal + filtered-noise + crack, batched over ``[V, B]``
(port of libgooey_tpu/instruments/snare.py:39-360, the stage path).

Behavioral reference: src/instruments/snare.rs.  Architecture
(snare.rs:709-760, 1044-1200):

* tonal "triangle" (additive odd-harmonic) oscillator @ f with pitch
  envelope and a curved tonal envelope;
* noise through a Chamberlin SVF with selectable mode (LP/BP/HP/notch) and
  two envelopes, main body + longer tail, combined 0.7/0.3;
* crack noise with velocity boost (0.7 + 0.3v);
* tonal/noise crossfade, phase-modulator transient (up to 2x), the plain
  tanh waveshaper overdrive at 4x (drive = 1 + od*9) before the amp
  envelope; velocity -> decay 0.45, -> pitch 0.5, -> amp sqrt(v).

A bank of at most ``ops.voice.MAX_FUSED_VOICES`` voices with one trigger
slot a block takes the kit path (``fused=True``, the gate of
snare.py:200-220): its sources in the ``kit_sources`` kernel, the Chamberlin
between (``linrec2_bank``), its noise envelopes and 4x overdrive in
``kit_drive`` (ops/voice.py; the TPU's ``pallas_voice.snare_render_fused``).
Every other bank renders the stage path below; its kernels:
``triangle_additive_bank`` (tonal), ``linrec2_bank`` (Chamberlin),
``ws4_bank`` (overdrive; at ``os_mode`` 2 the half-band stages of
``ops/oversample.process`` on ``affine1_bank`` instead, at 1 none).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from libgooey_tpu_torch.core import dsp
from libgooey_tpu_torch.core.envelope import ADSR, amplitude
from libgooey_tpu_torch.core.smoother import SmootherBank
from libgooey_tpu_torch.effects import freeze as frz
from libgooey_tpu_torch.effects import waveshaper
from libgooey_tpu_torch.instruments.common import NEVER, VoiceBlock, phase_mod_env
from libgooey_tpu_torch.ops import filters, osc, voice
from libgooey_tpu_torch.ops.oversample import OversamplerState

PARAM_NAMES = (
    "frequency",          # 0: 100-600 Hz
    "tonal",              # 1
    "noise",              # 2
    "brightness",         # 3 (crack amount)
    "decay",              # 4: 0.05-3.5 s
    "pitch_drop",         # 5
    "volume",             # 6
    "tonal_decay",        # 7: 0-3.5 s
    "tonal_decay_curve",  # 8: 0.1-10
    "noise_decay",        # 9: 0-3.5 s
    "noise_tail_decay",   # 10: 0-3.5 s
    "filter_cutoff",      # 11: 100-10000 Hz
    "filter_resonance",   # 12: 0.5-10
    "xfade",              # 13
    "phase_mod_amount",   # 14
    "overdrive",          # 15
    "amp_decay",          # 16: 0-4 s
    "amp_decay_curve",    # 17: 0.1-10
    "tuning",             # 18
)
NUM_PARAMS = len(PARAM_NAMES)
PARAM_INDEX = {n: i for i, n in enumerate(PARAM_NAMES)}

FREQ_RANGE = (100.0, 600.0)
DECAY_RANGE = (0.05, 3.5)
TONAL_DECAY_RANGE = (0.0, 3.5)
CURVE_RANGE = (0.1, 10.0)
NOISE_DECAY_RANGE = (0.0, 3.5)
TAIL_DECAY_RANGE = (0.0, 3.5)
CUTOFF_RANGE = (100.0, 10_000.0)
RES_RANGE = (0.5, 10.0)
AMP_DECAY_RANGE = (0.0, 4.0)

VELOCITY_TO_DECAY = 0.45  # snare.rs:788
VELOCITY_TO_PITCH = 0.5   # snare.rs:790

# filter_type constants (state_variable.rs process_mode)
FILTER_LP, FILTER_BP, FILTER_HP, FILTER_NOTCH = 0, 1, 2, 3


@dataclass(frozen=True)
class SnareConfig:
    """Normalized 0-1 preset (snare.rs:71-96)."""

    frequency: float = 0.2
    tonal: float = 0.4
    noise: float = 0.7
    brightness: float = 0.5
    decay: float = 0.029
    pitch_drop: float = 0.3
    volume: float = 0.8
    tonal_decay: float = 0.029 * 0.8
    tonal_decay_curve: float = 0.091
    noise_decay: float = 0.029 * 0.6
    noise_tail_decay: float = 0.029
    filter_cutoff: float = 0.495
    filter_resonance: float = 0.053
    xfade: float = 0.5
    phase_mod_amount: float = 0.0
    overdrive: float = 0.0
    amp_decay: float = 0.125
    amp_decay_curve: float = 0.02
    tuning: float = 0.5
    filter_type: int = FILTER_BP  # static (not smoothed; u8 in the reference)

    def as_array(self) -> np.ndarray:
        return np.clip(
            np.array([getattr(self, n) for n in PARAM_NAMES], np.float32), 0.0, 1.0
        )

    @staticmethod
    def tight() -> "SnareConfig":
        return SnareConfig()

    @staticmethod
    def loose() -> "SnareConfig":
        return SnareConfig(
            frequency=0.16, tonal=0.8, noise=0.6, brightness=0.3, decay=0.79,
            pitch_drop=0.1, volume=0.9, tonal_decay=0.33, tonal_decay_curve=0.2,
            noise_decay=0.23, noise_tail_decay=0.34, filter_cutoff=0.55,
            filter_resonance=0.05, xfade=0.5, phase_mod_amount=0.0,
            overdrive=0.1, amp_decay=0.12, amp_decay_curve=0.02,
        )

    @staticmethod
    def hiss() -> "SnareConfig":
        return SnareConfig(
            frequency=0.16, tonal=0.0, noise=0.6, brightness=0.3, decay=0.04,
            pitch_drop=0.4, volume=0.9, tonal_decay=0.53, tonal_decay_curve=0.09,
            noise_decay=0.38, noise_tail_decay=0.29, filter_cutoff=0.29,
            filter_resonance=0.45, xfade=0.5, phase_mod_amount=1.0,
            overdrive=0.2, amp_decay=0.18, amp_decay_curve=0.02,
        )

    @staticmethod
    def smack() -> "SnareConfig":
        return SnareConfig(
            frequency=0.2, tonal=0.3, noise=0.8, brightness=0.0, decay=0.029,
            pitch_drop=0.3, volume=0.85, tonal_decay=0.014, tonal_decay_curve=0.091,
            noise_decay=0.034, noise_tail_decay=0.086, filter_cutoff=0.293,
            filter_resonance=0.158, xfade=0.4, phase_mod_amount=0.5,
            overdrive=0.0, amp_decay=0.125, amp_decay_curve=0.02,
        )


PRESETS = {
    "default": SnareConfig.tight,
    "tight": SnareConfig.tight,
    "loose": SnareConfig.loose,
    "hiss": SnareConfig.hiss,
    "smack": SnareConfig.smack,
}


class SnareState(NamedTuple):
    params: SmootherBank            # [V, NUM_PARAMS]
    ovs: OversamplerState           # [V, ...] overdrive 4x oversampler
    filter_type: torch.Tensor       # [V] i32 (u8 in the reference ABI)
    trig_sample: torch.Tensor       # [V] i32
    velocity: torch.Tensor          # [V]
    pitch_mult: torch.Tensor        # [V] (updated at trigger from pitch_drop)
    amp_curve: torch.Tensor         # [V] latched actual 0.1-10
    tonal_curve: torch.Tensor       # [V] latched actual 0.1-10
    amp_decay: torch.Tensor         # [V] latched seconds (velocity-scaled)
    pm_active: torch.Tensor         # [V]
    noise_svf: filters.ChamberlinState


def init_state(num_voices: int, config: Optional[SnareConfig] = None, targets=None, *,
               device) -> SnareState:
    """Create a V-voice bank on ``device``; ``targets`` may be a ``[V, P]``
    array of per-voice normalized params (overrides ``config``'s)."""
    cfg = config or SnareConfig.tight()
    if targets is None:
        targets = np.broadcast_to(cfg.as_array(), (num_voices, NUM_PARAMS))
    v = (num_voices,)

    def full(value, dtype=torch.float32):
        return torch.full(v, value, dtype=dtype, device=device)

    return SnareState(
        params=SmootherBank.init(targets, device),
        ovs=OversamplerState.init(v, device),
        filter_type=full(cfg.filter_type, torch.int32),
        trig_sample=full(int(NEVER), torch.int32),
        velocity=full(0.5),
        pitch_mult=full(float(np.float32(1.0 + cfg.pitch_drop * 1.5))),
        amp_curve=full(1.0),
        tonal_curve=full(1.0),
        amp_decay=full(0.5),
        pm_active=full(0.0),
        noise_svf=filters.ChamberlinState.init(v, device),
    )


def render_block(
    state: SnareState,
    trig_offset,
    trig_velocity,
    block_start,
    *,
    sample_rate: float,
    block_size: int,
    smooth_coeff: float,
    max_harmonics: int = 256,
    os_mode: int = 4,
    overrides=None,
    fused: bool = True,
):
    """Render one block for the snare bank -> ``(new_state, out[V, B])``.

    ``trig_offset``/``trig_velocity``: ``[V]`` (one trigger slot, ``B`` =
    none) or ``[V, K]`` slot arrays with offsets ascending per voice.
    ``fused``: allow the kit path."""
    sr = sample_rate
    dev = state.velocity.device
    if (fused and voice.use_kit(state.velocity)
            and voice.eligible(trig_offset, state.velocity.shape[0])
            and overrides is None and os_mode == 4):
        return voice.snare_render_fused(state, trig_offset, trig_velocity, block_start,
                                        sample_rate=sr, block_size=block_size,
                                        smooth_coeff=smooth_coeff, max_harmonics=max_harmonics)
    vb = VoiceBlock(state.params, trig_offset, block_start, block_size,
                    smooth_coeff, PARAM_INDEX, overrides=overrides)
    ptraj, vat, eff = vb.ptraj, vb.value_at_trigger, vb.eff

    # --- trigger snapshots (snare.rs:873-1027) -------------------------------
    vel_new = torch.clamp(torch.as_tensor(trig_velocity, dtype=torch.float32, device=dev),
                          0.0, 1.0)
    decay_scale_new = 1.0 - VELOCITY_TO_DECAY * vel_new * vel_new
    pitch_mult_new = 1.0 + vat("pitch_drop") * 1.5
    tc = dsp.denormalize(vat("tonal_decay_curve"), *CURVE_RANGE)
    ad = dsp.denormalize(vat("amp_decay"), *AMP_DECAY_RANGE) * decay_scale_new
    ac = dsp.denormalize(vat("amp_decay_curve"), *CURVE_RANGE)
    pm_active_new = (vat("phase_mod_amount") > 0.001).to(torch.float32)

    vel = eff(vel_new, state.velocity)
    pitch_mult = eff(pitch_mult_new, state.pitch_mult)
    tonal_curve = eff(tc, state.tonal_curve)
    amp_decay_s = eff(ad, state.amp_decay)
    amp_curve = eff(ac, state.amp_curve)
    pm_active = eff(pm_active_new, state.pm_active)

    _t, _elapsed_i, idx_f, elapsed = vb.elapsed(state.trig_sample, sr)

    # --- live decays (snare.rs:1058-1105: re-applied per sample) -------------
    vel2 = vel * vel
    decay_scale = 1.0 - VELOCITY_TO_DECAY * vel2
    pitch_decay_scale = 1.0 - VELOCITY_TO_PITCH * vel2
    scaled_decay = dsp.denormalize(ptraj("decay"), *DECAY_RANGE) * decay_scale
    pitch_decay = torch.minimum(scaled_decay * 0.3 * pitch_decay_scale, scaled_decay * 0.25)
    base_freq = dsp.denormalize(ptraj("frequency"), *FREQ_RANGE) * dsp.tuning_to_multiplier(
        ptraj("tuning"))

    pitch_env = amplitude(ADSR(0.001, pitch_decay, 0.0, pitch_decay * 0.1, 1.0, 1.0), elapsed)
    fmult = 1.0 + (pitch_mult - 1.0) * pitch_env
    pm_amt = ptraj("phase_mod_amount")
    pm = phase_mod_env(elapsed, pm_active > 0.5)
    fmult = fmult * torch.where(pm_amt > 0.001, 1.0 + pm * pm_amt * 1.0, 1.0)

    # oscillator built-in envelopes: 1 ms attack then hold (sustain 1)
    hold_env = amplitude(ADSR(0.001, 0.001, 1.0, 1.0, 1.0, 1.0), elapsed)

    # --- tonal component ------------------------------------------------------
    if max_harmonics > 0:
        tonal_raw = osc.triangle_additive(idx_f, base_freq * fmult, sr, max_harmonics)
    else:
        tonal_raw = osc.sine(idx_f, base_freq * fmult, sr)
    tonal_env = amplitude(
        ADSR(0.001, dsp.denormalize(ptraj("tonal_decay"), *TONAL_DECAY_RANGE) * decay_scale,
             0.0, 1.0, 1.0, tonal_curve),
        elapsed,
    )
    xfade = ptraj("xfade")
    tonal_out = tonal_raw * hold_env * ptraj("tonal") * tonal_env * (1.0 - xfade)

    # --- noise component ------------------------------------------------------
    noise_raw = osc.noise(idx_f) * hold_env * (ptraj("noise") * 0.8)
    cutoff = dsp.denormalize(ptraj("filter_cutoff"), *CUTOFF_RANGE)
    res = dsp.denormalize(ptraj("filter_resonance"), *RES_RANGE)
    svf_state, lo, bp, hp, notch = filters.chamberlin_block(
        state.noise_svf, noise_raw, cutoff, res, sr, reset=vb.at_trig)
    ft = state.filter_type[:, None]
    filtered = torch.where(
        ft == FILTER_LP, lo,
        torch.where(ft == FILTER_HP, hp, torch.where(ft == FILTER_NOTCH, notch, bp)))
    noise_env = amplitude(
        ADSR(0.001, dsp.denormalize(ptraj("noise_decay"), *NOISE_DECAY_RANGE) * decay_scale,
             0.0, 1.0, 1.0, 1.0),
        elapsed,
    )
    tail_env = amplitude(
        ADSR(0.001, dsp.denormalize(ptraj("noise_tail_decay"), *TAIL_DECAY_RANGE) * decay_scale,
             0.0, 1.0, 1.0, 1.0),
        elapsed,
    )
    noise_out = filtered * (noise_env * 0.7 + tail_env * 0.3) * xfade

    # --- crack component (velocity-boosted, short decay) ----------------------
    crack_env = amplitude(
        ADSR(0.001, scaled_decay * 0.2, 0.0, scaled_decay * 0.1, 1.0, 1.0), elapsed)
    # the same hash source as the main noise (oscillator.rs:187-196)
    crack_raw = osc.noise(idx_f) * crack_env
    crack_out = crack_raw * (ptraj("brightness") * 0.4 * (0.7 + 0.3 * vel))

    total = tonal_out + noise_out + crack_out

    # --- overdrive: plain tanh waveshaper at os_mode x, drive = 1 + od*9 (snare.rs:1166)
    drive = 1.0 + ptraj("overdrive") * 9.0
    ws_ovs_out, shaped = waveshaper.process_bank(state.ovs, total, drive, os_mode)

    amp_env = amplitude(
        ADSR(0.001, torch.clamp(amp_decay_s, min=0.001), 0.0, 1.0, 1.0, amp_curve), elapsed)
    out = shaped * amp_env * torch.sqrt(vel) * ptraj("volume")

    # exact bypass freeze at block granularity (waveshaper.rs:55-57 early
    # return at drive <= 1, i.e. od == 0; effects/freeze.py)
    new_state = SnareState(
        params=vb.advance_bank(),
        ovs=frz.hold_where(torch.all(drive <= 1.0, dim=-1), state.ovs, ws_ovs_out),
        filter_type=state.filter_type,
        trig_sample=vb.latch(vb.block_start + vb.trig_offset, state.trig_sample),
        velocity=vb.latch(vel_new, state.velocity),
        pitch_mult=vb.latch(pitch_mult_new, state.pitch_mult),
        amp_curve=vb.latch(ac, state.amp_curve),
        tonal_curve=vb.latch(tc, state.tonal_curve),
        amp_decay=vb.latch(ad, state.amp_decay),
        pm_active=vb.latch(pm_active_new, state.pm_active),
        noise_svf=svf_state,
    )
    return new_state, out
