"""BassSynth: sub sine + morphing polyBLEP saw/square pair through a swept
SVF, batched over ``[V, B]`` (port of libgooey_tpu/instruments/bass.py:32-329,
the stage path).

Behavioral reference: src/instruments/bass.rs.

* phase-accumulator oscillators (reset at trigger): sub sine @ f, main
  saw/square crossfade by `osc_shape`, detuned copy (0-30 cents, live);
* frequency frozen at trigger (bass.rs:757), tuning live; a sequencer
  step's note overrides it (``note_freq``);
* pre-filter tanh waveshaper at 4x (drive = 1 + od*9) when overdrive > 0.001;
* TPT SVF low-pass: exponential cutoff map ``20*(18000/20)^x``; the filter
  envelope (latched decay/curve) sweeps from base + amt*(max-base) down;
* amp envelope: 2 ms linear attack, curved decay (latched); sqrt velocity.

A bank of at most ``ops.voice.MAX_FUSED_VOICES`` voices with one trigger
slot a block takes the kit path (``fused=True``, bass.py:176-201): its
oscillators, 4x drive and envelopes in the ``kit_sources`` kernel, the swept
SVF after it in ``svf_bank`` (ops/voice.py).  Kernels on the stage path:
``affine1_bank`` (phase accumulators), ``ws4_bank`` (overdrive; at
``os_mode`` 2 the half-band stages of ``ops/oversample.process`` on
``affine1_bank`` instead, at 1 none), ``svf_bank`` (filter).
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
from libgooey_tpu_torch.instruments.common import NEVER, VoiceBlock
from libgooey_tpu_torch.ops import filters, osc, voice
from libgooey_tpu_torch.ops import scan as gscan
from libgooey_tpu_torch.ops.oversample import OversamplerState

TWO_PI = float(2.0 * np.pi)

PARAM_NAMES = (
    "frequency",          # 0: 30-200 Hz
    "sub_level",          # 1
    "osc_level",          # 2
    "detune_level",       # 3
    "detune_amount",      # 4: 0-30 cents
    "osc_shape",          # 5: saw(0)..square(1)
    "filter_cutoff",      # 6: 20-18000 Hz exp
    "filter_resonance",   # 7: 0.5-15 Q
    "filter_env_amount",  # 8
    "filter_env_decay",   # 9: 0.01-2 s
    "filter_env_curve",   # 10: 0.1-8
    "amp_decay",          # 11: 0.05-4 s
    "amp_decay_curve",    # 12: 0.1-10
    "overdrive",          # 13
    "volume",             # 14
    "tuning",             # 15
)
NUM_PARAMS = len(PARAM_NAMES)
PARAM_INDEX = {n: i for i, n in enumerate(PARAM_NAMES)}

FREQ_RANGE = (30.0, 200.0)
DETUNE_RANGE = (0.0, 30.0)
CUTOFF_RANGE = (20.0, 18_000.0)
RES_RANGE = (0.5, 15.0)
FENV_DECAY_RANGE = (0.01, 2.0)
FENV_CURVE_RANGE = (0.1, 8.0)
AMP_DECAY_RANGE = (0.05, 4.0)
AMP_CURVE_RANGE = (0.1, 10.0)


def exp_denormalize(normalized, lo, hi):
    """``lo * (hi/lo)^x``: exponential frequency map (bass.rs:52-54)."""
    return lo * torch.pow(hi / lo, torch.clamp(normalized, 0.0, 1.0))


@dataclass(frozen=True)
class BassConfig:
    frequency: float = 0.24
    sub_level: float = 0.4
    osc_level: float = 0.8
    detune_level: float = 0.0
    detune_amount: float = 0.0
    osc_shape: float = 0.1
    filter_cutoff: float = 0.15
    filter_resonance: float = 0.7
    filter_env_amount: float = 0.85
    filter_env_decay: float = 0.15
    filter_env_curve: float = 0.08
    amp_decay: float = 0.35
    amp_decay_curve: float = 0.1
    overdrive: float = 0.3
    volume: float = 0.8
    tuning: float = 0.5

    def as_array(self) -> np.ndarray:
        return np.clip(
            np.array([getattr(self, n) for n in PARAM_NAMES], np.float32), 0.0, 1.0
        )

    # presets (bass.rs:183-268)
    @staticmethod
    def acid():
        return BassConfig()

    @staticmethod
    def sub():
        return BassConfig(0.18, 1.0, 0.15, 0.0, 0.0, 0.0, 0.7, 0.05, 0.1, 0.3,
                          0.2, 0.6, 0.15, 0.0, 0.85)

    @staticmethod
    def reese():
        return BassConfig(0.18, 0.3, 0.8, 0.8, 0.5, 0.05, 0.35, 0.3, 0.5, 0.4,
                          0.15, 0.55, 0.12, 0.6, 0.8)

    @staticmethod
    def stab():
        return BassConfig(0.3, 0.2, 0.9, 0.0, 0.0, 0.9, 0.2, 0.4, 0.9, 0.08,
                          0.05, 0.2, 0.08, 0.2, 0.8)


PRESETS = {
    "default": BassConfig.acid,
    "acid": BassConfig.acid,
    "sub": BassConfig.sub,
    "reese": BassConfig.reese,
    "stab": BassConfig.stab,
}


class BassState(NamedTuple):
    ovs: OversamplerState        # pre-filter waveshaper 4x oversampler
    params: SmootherBank         # [V, NUM_PARAMS]
    trig_sample: torch.Tensor    # [V] i32
    velocity: torch.Tensor       # [V]
    trig_freq: torch.Tensor      # [V] frequency snapshot (Hz)
    amp_decay_s: torch.Tensor    # [V] latched
    amp_curve: torch.Tensor      # [V]
    fenv_decay_s: torch.Tensor   # [V]
    fenv_curve: torch.Tensor     # [V]
    sub_phase: torch.Tensor      # [V]
    osc_phase: torch.Tensor      # [V]
    det_phase: torch.Tensor      # [V]
    svf: filters.SVFState


def init_state(num_voices: int, config: Optional[BassConfig] = None, targets=None, *,
               device) -> BassState:
    cfg = config or BassConfig.acid()
    if targets is None:
        targets = np.broadcast_to(cfg.as_array(), (num_voices, NUM_PARAMS))
    v = (num_voices,)
    freq0 = np.float32(FREQ_RANGE[0]) + np.clip(np.float32(cfg.frequency), 0.0, 1.0) * (
        np.float32(FREQ_RANGE[1] - FREQ_RANGE[0]))

    def full(value, dtype=torch.float32):
        return torch.full(v, value, dtype=dtype, device=device)

    return BassState(
        ovs=OversamplerState.init(v, device),
        params=SmootherBank.init(targets, device),
        trig_sample=full(int(NEVER), torch.int32),
        velocity=full(1.0),
        trig_freq=full(float(freq0)),
        amp_decay_s=full(1.0),
        amp_curve=full(1.0),
        fenv_decay_s=full(0.3),
        fenv_curve=full(1.0),
        sub_phase=full(0.0),
        osc_phase=full(0.0),
        det_phase=full(0.0),
        svf=filters.SVFState.init(v, device),
    )


def render_block(
    state: BassState,
    trig_offset,
    trig_velocity,
    block_start,
    *,
    sample_rate: float,
    block_size: int,
    smooth_coeff: float,
    note_freq=None,
    os_mode: int = 4,
    overrides=None,
    fused: bool = True,
):
    """Render one block for the bass bank -> ``(new_state, out[V, B])``.

    ``note_freq``: optional Hz override for this block's triggers, ``[V]``
    or shaped like ``trig_offset``; 0 keeps the param frequency (sequencer
    per-step notes set the frequency before triggering).  ``fused``: allow
    the kit path (with ``[V]`` notes)."""
    sr = sample_rate
    dev = state.velocity.device
    if (fused and voice.use_kit(state.velocity)
            and voice.eligible(trig_offset, state.velocity.shape[0])
            and overrides is None and os_mode == 4
            and (note_freq is None or np.ndim(note_freq) == 1)):
        return voice.bass_render_fused(state, trig_offset, trig_velocity, block_start,
                                       sample_rate=sr, block_size=block_size,
                                       smooth_coeff=smooth_coeff, note_freq=note_freq)
    vb = VoiceBlock(state.params, trig_offset, block_start, block_size,
                    smooth_coeff, PARAM_INDEX, overrides=overrides)
    ptraj, vat, eff = vb.ptraj, vb.value_at_trigger, vb.eff

    # --- trigger snapshots (bass.rs:747-791) -----------------------------------
    vel_new = torch.clamp(torch.as_tensor(trig_velocity, dtype=torch.float32, device=dev),
                          0.0, 1.0)
    freq_new = dsp.denormalize(vat("frequency"), *FREQ_RANGE)
    if note_freq is not None:
        nf = torch.as_tensor(note_freq, device=dev).to(torch.float32)
        if nf.dim() < freq_new.dim():
            nf = nf[:, None]  # [V] note against [V, K] trigger slots
        freq_new = torch.where(nf > 0.0, nf, freq_new)
    ad_new = dsp.denormalize(vat("amp_decay"), *AMP_DECAY_RANGE)
    ac_new = dsp.denormalize(vat("amp_decay_curve"), *AMP_CURVE_RANGE)
    fd_new = dsp.denormalize(vat("filter_env_decay"), *FENV_DECAY_RANGE)
    fc_new = dsp.denormalize(vat("filter_env_curve"), *FENV_CURVE_RANGE)

    vel = eff(vel_new, state.velocity)
    freq0 = eff(freq_new, state.trig_freq)
    ad = eff(ad_new, state.amp_decay_s)
    ac = eff(ac_new, state.amp_curve)
    fd = eff(fd_new, state.fenv_decay_s)
    fc = eff(fc_new, state.fenv_curve)

    _t, _ei, _idx, elapsed = vb.elapsed(state.trig_sample, sr)
    reset = vb.at_trig

    # --- oscillators (phase accumulators, reset at trigger) --------------------
    freq = freq0 * dsp.tuning_to_multiplier(ptraj("tuning"))
    detune_cents = dsp.denormalize(ptraj("detune_amount"), *DETUNE_RANGE)
    det_freq = freq * torch.exp2(detune_cents / 1200.0)

    sub_inc = freq / sr
    osc_inc = freq / sr
    det_inc = det_freq / sr
    # exact mod-1 accumulation (the reference keeps f64 phase accumulators)
    sub_phase = gscan.phase_cumsum_reset(sub_inc, reset, state.sub_phase)
    osc_phase = gscan.phase_cumsum_reset(osc_inc, reset, state.osc_phase)
    det_phase = gscan.phase_cumsum_reset(det_inc, reset, state.det_phase)

    sub_out = torch.sin(sub_phase * TWO_PI)
    shape = ptraj("osc_shape")

    def blep_pair(phase, inc):
        saw = (2.0 * phase - 1.0) - osc.poly_blep(phase, inc)
        naive_sq = torch.where(phase < 0.5, 1.0, -1.0)
        sq = naive_sq + osc.poly_blep(phase, inc) - osc.poly_blep(
            torch.remainder(phase + 0.5, 1.0), inc)
        return saw, sq

    saw_m, sq_m = blep_pair(osc_phase, osc_inc)
    saw_d, sq_d = blep_pair(det_phase, det_inc)
    osc_out = saw_m * (1.0 - shape) + sq_m * shape
    det_out = saw_d * (1.0 - shape) + sq_d * shape

    mix = (sub_out * ptraj("sub_level") + osc_out * ptraj("osc_level")
           + det_out * ptraj("detune_level"))

    # --- pre-filter saturation ---------------------------------------------------
    od = ptraj("overdrive")
    drive = 1.0 + od * 9.0
    ws_ovs_out, shaped = waveshaper.process_bank(state.ovs, mix, drive, os_mode)
    saturated = torch.where(od > 0.001, shaped, mix)

    # --- swept SVF low-pass --------------------------------------------------------
    fenv = amplitude(ADSR(0.001, fd, 0.0, fd * 0.1, 1.0, fc), elapsed)
    base_cutoff = exp_denormalize(ptraj("filter_cutoff"), *CUTOFF_RANGE)
    env_offset = (CUTOFF_RANGE[1] - base_cutoff) * ptraj("filter_env_amount") * fenv
    cutoff = torch.clamp(base_cutoff + env_offset, *CUTOFF_RANGE)
    resonance = dsp.denormalize(ptraj("filter_resonance"), *RES_RANGE)
    svf_state, filtered, _bp, _hp = filters.svf_tpt_outputs(
        state.svf, saturated, cutoff, resonance, sr, reset=reset)

    # --- amplitude ------------------------------------------------------------------
    amp_env = amplitude(ADSR(0.002, ad, 0.0, ad * 0.1, 1.0, ac), elapsed)
    out = filtered * amp_env * torch.sqrt(vel) * ptraj("volume")

    # exact bypass freeze at block granularity (bass.rs:846 ticks the shaper
    # only when od > 0.001; effects/freeze.py)
    new_state = BassState(
        ovs=frz.hold_where(torch.all(od <= 0.001, dim=-1), state.ovs, ws_ovs_out),
        params=vb.advance_bank(),
        trig_sample=vb.latch(vb.block_start + vb.trig_offset, state.trig_sample),
        velocity=vb.latch(vel_new, state.velocity),
        trig_freq=vb.latch(freq_new, state.trig_freq),
        amp_decay_s=vb.latch(ad_new, state.amp_decay_s),
        amp_curve=vb.latch(ac_new, state.amp_curve),
        fenv_decay_s=vb.latch(fd_new, state.fenv_decay_s),
        fenv_curve=vb.latch(fc_new, state.fenv_curve),
        sub_phase=sub_phase[:, -1],
        osc_phase=osc_phase[:, -1],
        det_phase=det_phase[:, -1],
        svf=svf_state,
    )
    return new_state, out
