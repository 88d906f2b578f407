"""TomDrum (v1): sine body + triangle punch with pitch sweep
(port of libgooey_tpu/instruments/tom.py).

Behavioral reference: src/instruments/tom.rs.

* tonal sine @ f (decay 0.9d), punch triangle @ 3f (decay 0.3d, level
  punch*volume*0.6), both volumes live per sample;
* pitch envelope (0.4d) sweeping from ``1 + pitch_drop`` down to 1; the
  punch osc gets half the sweep;
* master amplitude envelope (attack curve 0.5, curved decay) latched at
  trigger; velocity decay scale ``0.5 + 0.5v``; amplitude ``sqrt(v)``.

The punch's additive triangle runs in the ``triangle_additive_bank`` kernel
(``osc.triangle_additive``).
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
from libgooey_tpu_torch.ops import osc

PARAM_NAMES = (
    "frequency",       # 0: 60-300 Hz
    "tonal",           # 1
    "punch",           # 2
    "decay",           # 3: 0.05-2 s
    "pitch_drop",      # 4
    "volume",          # 5
    "amp_decay",       # 6: 0-4 s
    "amp_decay_curve",  # 7: 0.1-10
)
NUM_PARAMS = len(PARAM_NAMES)
PARAM_INDEX = {n: i for i, n in enumerate(PARAM_NAMES)}

FREQ_RANGE = (60.0, 300.0)
DECAY_RANGE = (0.05, 2.0)
AMP_DECAY_RANGE = (0.0, 4.0)
CURVE_RANGE = (0.1, 10.0)


@dataclass(frozen=True)
class TomConfig:
    frequency: float = 0.25
    tonal: float = 0.8
    punch: float = 0.4
    decay: float = 0.18
    pitch_drop: float = 0.3
    volume: float = 0.8
    amp_decay: float = 0.2
    amp_decay_curve: float = 0.02

    def as_array(self) -> np.ndarray:
        return np.clip(
            np.array([getattr(self, n) for n in PARAM_NAMES], np.float32), 0.0, 1.0
        )

    # presets (tom.rs:131-190)
    @staticmethod
    def default():
        return TomConfig()

    @staticmethod
    def high_tom():
        return TomConfig(0.5, 0.9, 0.5, 0.13, 0.4, 0.85, 0.15, 0.02)

    @staticmethod
    def mid_tom():
        return TomConfig()

    @staticmethod
    def low_tom():
        return TomConfig(0.125, 0.7, 0.3, 0.28, 0.2, 0.85, 0.3, 0.02)

    @staticmethod
    def floor_tom():
        return TomConfig(0.04, 0.6, 0.2, 0.38, 0.15, 0.9, 0.4, 0.02)


PRESETS = {
    "default": TomConfig.default,
    "high": TomConfig.high_tom,
    "mid": TomConfig.mid_tom,
    "low": TomConfig.low_tom,
    "floor": TomConfig.floor_tom,
}


class TomState(NamedTuple):
    params: SmootherBank       # [V, NUM_PARAMS]
    trig_sample: torch.Tensor  # [V] i32
    velocity: torch.Tensor     # [V]
    decay_s: torch.Tensor      # [V] latched scaled decay
    amp_decay_s: torch.Tensor  # [V]
    amp_curve: torch.Tensor    # [V]


def init_state(num_voices: int, config: Optional[TomConfig] = None, targets=None, *,
               device) -> TomState:
    if targets is None:
        targets = np.broadcast_to((config or TomConfig()).as_array(), (num_voices, NUM_PARAMS))
    v = (num_voices,)

    def full(value, dtype=torch.float32):
        return torch.full(v, value, dtype=dtype, device=device)

    return TomState(
        params=SmootherBank.init(targets, device),
        trig_sample=full(int(NEVER), torch.int32),
        velocity=full(1.0),
        decay_s=full(0.4),
        amp_decay_s=full(0.8),
        amp_curve=full(1.0),
    )


def render_block(
    state: TomState,
    trig_offset,
    trig_velocity,
    block_start,
    *,
    sample_rate: float,
    block_size: int,
    smooth_coeff: float,
    max_harmonics: int = 128,
    overrides=None,
):
    """Render one block for the tom bank -> ``(new_state, out[V, B])``."""
    sr = sample_rate
    dev = state.velocity.device
    vb = VoiceBlock(state.params, trig_offset, block_start, block_size,
                    smooth_coeff, PARAM_INDEX, overrides=overrides)
    ptraj, vat, eff = vb.ptraj, vb.value_at_trigger, vb.eff

    # trigger snapshots: decay_scale = 0.5 + 0.5v (tom.rs trigger)
    vel_new = torch.clamp(torch.as_tensor(trig_velocity, dtype=torch.float32, device=dev),
                          0.0, 1.0)
    scale_new = 0.5 + 0.5 * vel_new
    d_new = dsp.denormalize(vat("decay"), *DECAY_RANGE) * scale_new
    ad_new = dsp.denormalize(vat("amp_decay"), *AMP_DECAY_RANGE) * scale_new
    ac = dsp.denormalize(vat("amp_decay_curve"), *CURVE_RANGE)
    ac_new = torch.where((ac - 1.0).abs() < 0.01, 1.0, ac)

    vel = eff(vel_new, state.velocity)
    d = eff(d_new, state.decay_s)
    ad = eff(ad_new, state.amp_decay_s)
    a_curve = eff(ac_new, state.amp_curve)

    _t, _ei, idx_f, elapsed = vb.elapsed(state.trig_sample, sr)

    # live params
    freq = dsp.denormalize(ptraj("frequency"), *FREQ_RANGE)
    volume = ptraj("volume")
    pitch_mult = 1.0 + ptraj("pitch_drop") * 1.0  # live (tom.rs tick)

    pitch_env = amplitude(ADSR(0.001, d * 0.4, 0.0, d * 0.2, 1.0, 1.0), elapsed)
    fmult = 1.0 + (pitch_mult - 1.0) * pitch_env

    tonal_env = amplitude(ADSR(0.001, d * 0.9, 0.0, d * 0.3, 1.0, 1.0), elapsed)
    tonal = osc.sine(idx_f, freq * fmult, sr) * tonal_env * (ptraj("tonal") * volume)

    punch_env = amplitude(ADSR(0.001, d * 0.3, 0.0, d * 0.1, 1.0, 1.0), elapsed)
    punch_freq = freq * 3.0 * (1.0 + (fmult - 1.0) * 0.5)
    if max_harmonics > 0:
        punch_raw = osc.triangle_additive(idx_f, punch_freq, sr, max_harmonics)
    else:
        punch_raw = torch.zeros_like(tonal)
    punch = punch_raw * punch_env * (ptraj("punch") * volume * 0.6)

    ad_floor = torch.clamp(ad, min=0.001)
    amp_env = amplitude(ADSR(0.001, ad_floor, 0.0, ad_floor * 0.2, 0.5, a_curve), elapsed)
    out = (tonal + punch) * amp_env * torch.sqrt(vel)

    new_state = TomState(
        params=vb.advance_bank(),
        trig_sample=vb.latch(vb.block_start + vb.trig_offset, state.trig_sample),
        velocity=vb.latch(vel_new, state.velocity),
        decay_s=vb.latch(d_new, state.decay_s),
        amp_decay_s=vb.latch(ad_new, state.amp_decay_s),
        amp_curve=vb.latch(ac_new, state.amp_curve),
    )
    return new_state, out
