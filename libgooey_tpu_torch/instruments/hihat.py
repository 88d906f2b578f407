"""HiHat (v1): dual noise sources + envelope-swept one-pole output filter
(port of libgooey_tpu/instruments/hihat.py).

Behavioral reference: src/instruments/hihat.rs.  Signal path
(hihat.rs:575-672):

* main noise oscillator — open: ADSR(1ms, 0.2d, 0.4 sustain "wash", 0.8d);
  closed: ADSR(1ms, d, 0, 0.1d);
* brightness noise — shorter envelope (0.2d), level = filter*0.5 (live);
* sum * amplitude envelope * resonance factor (1 + filter*0.8);
* one-pole output low-pass with cutoff = base + filter*6kHz + transient
  boosts: a 15% filter-envelope sweep and a velocity boost (up to +30%),
  both decaying with the filter envelope (0.5d);
* volume * sqrt(velocity).

Envelope configs are latched at trigger.  Both noise oscillators hash the
same sample index, so they are the same sequence at different gains.  The
output one-pole runs in the ``affine1_bank`` kernel (``scan.linrec1``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from libgooey_tpu_torch.core import dsp
from libgooey_tpu_torch.core.envelope import ADSR, amplitude
from libgooey_tpu_torch.core.smoother import SmootherBank
from libgooey_tpu_torch.instruments.common import NEVER, VoiceBlock
from libgooey_tpu_torch.ops import filters, osc

PARAM_NAMES = (
    "frequency",       # 0: 4000-16000 Hz
    "filter",          # 1
    "decay",           # 2: 0.005-0.4 s
    "volume",          # 3
    "amp_decay",       # 4: 0-4 s
    "amp_decay_curve",  # 5: 0.1-10
)
NUM_PARAMS = len(PARAM_NAMES)
PARAM_INDEX = {n: i for i, n in enumerate(PARAM_NAMES)}

FREQ_RANGE = (4000.0, 16000.0)
DECAY_RANGE = (0.005, 0.4)
AMP_DECAY_RANGE = (0.0, 4.0)
CURVE_RANGE = (0.1, 10.0)

VELOCITY_TO_DECAY = 0.4   # hihat.rs:407
VELOCITY_TO_PITCH = 0.3   # hihat.rs:408
FILTER_ENV_AMOUNT = 0.15  # hihat.rs:401


@dataclass(frozen=True)
class HiHatConfig:
    frequency: float = 0.33
    filter: float = 0.6
    decay: float = 0.19
    volume: float = 0.8
    amp_decay: float = 0.1
    amp_decay_curve: float = 0.02
    is_open: bool = False

    def as_array(self) -> np.ndarray:
        return np.clip(
            np.array([getattr(self, n) for n in PARAM_NAMES], np.float32), 0.0, 1.0
        )

    # presets (hihat.rs:120-199)
    @staticmethod
    def closed_default():
        return HiHatConfig(0.33, 0.6, 0.19, 0.8, 0.1, 0.02, False)

    @staticmethod
    def open_default():
        return HiHatConfig(0.5, 0.6, 1.0, 0.7, 0.25, 0.02, True)

    @staticmethod
    def closed_tight():
        return HiHatConfig(0.17, 0.55, 0.025, 0.9, 0.05, 0.02, False)

    @staticmethod
    def open_bright():
        return HiHatConfig(0.83, 0.7, 1.0, 0.8, 0.25, 0.02, True)

    @staticmethod
    def closed_dark():
        return HiHatConfig(0.0, 0.4, 0.24, 0.7, 0.1, 0.02, False)

    @staticmethod
    def open_long():
        return HiHatConfig(0.33, 0.45, 1.0, 0.6, 0.35, 0.02, True)


PRESETS = {
    # a HiHat starts closed (hihat.rs HiHat::new); "default" is the engine's
    # generic add_instrument preset name
    "default": HiHatConfig.closed_default,
    "closed_default": HiHatConfig.closed_default,
    "open_default": HiHatConfig.open_default,
    "closed_tight": HiHatConfig.closed_tight,
    "open_bright": HiHatConfig.open_bright,
    "closed_dark": HiHatConfig.closed_dark,
    "open_long": HiHatConfig.open_long,
}


class HiHatState(NamedTuple):
    params: SmootherBank        # [V, NUM_PARAMS]
    is_open: torch.Tensor       # [V] f32 (0/1; switchable per voice)
    trig_sample: torch.Tensor   # [V] i32
    velocity: torch.Tensor      # [V]
    vel_boost: torch.Tensor     # [V] velocity_freq_boost latch
    decay_s: torch.Tensor       # [V] latched scaled decay (s)
    amp_decay_s: torch.Tensor   # [V] latched scaled amp decay (s)
    amp_curve: torch.Tensor     # [V] latched 0.1-10
    filt: filters.OnePoleState  # output one-pole LP


def init_state(num_voices: int, config: Optional[HiHatConfig] = None, targets=None, *,
               device) -> HiHatState:
    cfg = config or HiHatConfig.closed_default()
    if targets is None:
        targets = np.broadcast_to(cfg.as_array(), (num_voices, NUM_PARAMS))
    v = (num_voices,)

    def full(value, dtype=torch.float32):
        return torch.full(v, value, dtype=dtype, device=device)

    return HiHatState(
        params=SmootherBank.init(targets, device),
        is_open=full(1.0 if cfg.is_open else 0.0),
        trig_sample=full(int(NEVER), torch.int32),
        velocity=full(1.0),
        vel_boost=full(1.0),
        decay_s=full(0.08),
        amp_decay_s=full(0.4),
        amp_curve=full(1.0),
        filt=filters.OnePoleState.init(v, device),
    )


def render_block(
    state: HiHatState,
    trig_offset,
    trig_velocity,
    block_start,
    *,
    sample_rate: float,
    block_size: int,
    smooth_coeff: float,
    overrides=None,
):
    """Render one block for the hi-hat bank -> ``(new_state, out[V, B])``."""
    sr = sample_rate
    dev = state.velocity.device
    vb = VoiceBlock(state.params, trig_offset, block_start, block_size,
                    smooth_coeff, PARAM_INDEX, overrides=overrides)
    ptraj, vat, eff = vb.ptraj, vb.value_at_trigger, vb.eff

    # --- trigger snapshots (hihat.rs:498-573) --------------------------------
    vel_new = torch.clamp(torch.as_tensor(trig_velocity, dtype=torch.float32, device=dev),
                          0.0, 1.0)
    vel2_new = vel_new * vel_new
    decay_scale = 1.0 - VELOCITY_TO_DECAY * vel2_new
    d_new = dsp.denormalize(vat("decay"), *DECAY_RANGE) * decay_scale
    ad_new = dsp.denormalize(vat("amp_decay"), *AMP_DECAY_RANGE) * decay_scale
    ac = dsp.denormalize(vat("amp_decay_curve"), *CURVE_RANGE)
    ac_new = torch.where((ac - 1.0).abs() < 0.01, 1.0, ac)
    boost_new = 1.0 + VELOCITY_TO_PITCH * vel2_new

    vel = eff(vel_new, state.velocity)
    d = eff(d_new, state.decay_s)
    ad = eff(ad_new, state.amp_decay_s)
    a_curve = eff(ac_new, state.amp_curve)
    boost = eff(boost_new, state.vel_boost)
    is_open = state.is_open[:, None] > 0.5

    _t, _ei, idx_f, elapsed = vb.elapsed(state.trig_sample, sr)

    # --- envelopes (all latched shapes) ---------------------------------------
    noise_env = torch.where(
        is_open,
        amplitude(ADSR(0.001, d * 0.2, 0.4, d * 0.8, 1.0, 1.0), elapsed),
        amplitude(ADSR(0.001, d, 0.0, d * 0.1, 1.0, 1.0), elapsed),
    )
    bright_env = amplitude(ADSR(0.001, d * 0.2, 0.0, d * 0.05, 1.0, 1.0), elapsed)
    amp_env = torch.where(
        is_open,
        amplitude(ADSR(0.001, ad * 0.3, 0.3, ad * 0.7, 1.0, a_curve), elapsed),
        amplitude(ADSR(0.001, ad, 0.0, ad * 0.05, 1.0, a_curve), elapsed),
    )
    filt_env = amplitude(ADSR(0.001, d * 0.5, 0.0, d * 0.05, 1.0, 1.0), elapsed)

    # --- sources: both oscillators hash the same index ------------------------
    w = osc.noise(idx_f)
    filt_traj = ptraj("filter")
    combined = w * noise_env + w * bright_env * (filt_traj * 0.5)
    shaped = combined * amp_env * (1.0 + filt_traj * 0.8)

    # --- output one-pole LP with envelope-swept cutoff -------------------------
    base_cutoff = dsp.denormalize(ptraj("frequency"), *FREQ_RANGE)
    velocity_cutoff_boost = (boost - 1.0) * filt_env * base_cutoff
    envelope_boost = filt_env * FILTER_ENV_AMOUNT * base_cutoff
    cutoff = torch.clamp(
        base_cutoff + filt_traj * 6000.0 + envelope_boost + velocity_cutoff_boost,
        max=sr * 0.45,
    )
    g = torch.clamp(1.0 - torch.exp(float(-2.0 * np.pi) * cutoff / sr), 0.0, 1.0)
    filt_state, y = filters.onepole_lp_block(state.filt, shaped, g)
    y = torch.where(y.abs() < 1e-15, 0.0, y)

    out = y * ptraj("volume") * torch.sqrt(vel)

    new_state = HiHatState(
        params=vb.advance_bank(),
        is_open=state.is_open,
        trig_sample=vb.latch(vb.block_start + vb.trig_offset, state.trig_sample),
        velocity=vb.latch(vel_new, state.velocity),
        vel_boost=vb.latch(boost_new, state.vel_boost),
        decay_s=vb.latch(d_new, state.decay_s),
        amp_decay_s=vb.latch(ad_new, state.amp_decay_s),
        amp_curve=vb.latch(ac_new, state.amp_curve),
        filt=filt_state,
    )
    return new_state, out
