"""HiHat2: the Max-derived hi-hat (phase-mod metallic noise), batched over
``[V, B]`` (port of libgooey_tpu/instruments/hihat2.py:35-260, the stage path).

Behavioral reference: src/instruments/hihat2.rs.  Signal path
(hihat2.rs:453-509):

* noise source (white or pink; never reset) * 0.25 phase-modulates a `mod`
  oscillator at 0.1*pitch; its output * 0.75 phase-modulates the `main`
  oscillator at pitch; both are phase-accumulator sines reset at trigger;
* 1 or 2 RBJ highpass biquad stages at pitch (12/24 dB; the second stage
  scales by 0.8);
* MaxCurve envelope [(1, attack, -0.3), (0, decay, -0.8)] through an
  asymmetric smoother (instant up, 100-sample down);
* * velocity * 0.35, TPT SVF highpass at `tone`, then volume.

A bank of at most ``ops.voice.MAX_FUSED_VOICES`` voices with one trigger
slot a block takes the kit path (``fused=True``, hihat2.py:150-168): the
whole block in the ``kit_sources`` kernel (ops/voice.py).  Kernels on the
stage path: ``affine1_bank`` (phase accumulators and the asymmetric
smoother), ``pink_bank``, ``linrec2_bank`` (the two biquads), ``svf_bank``
(tone).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from libgooey_tpu_torch.core import dsp, rng
from libgooey_tpu_torch.core.max_curve import max_curve
from libgooey_tpu_torch.core.smoother import SmootherBank
from libgooey_tpu_torch.instruments.common import NEVER, VoiceBlock
from libgooey_tpu_torch.ops import filters
from libgooey_tpu_torch.ops import noise as pink_mod
from libgooey_tpu_torch.ops import scan as gscan
from libgooey_tpu_torch.ops import voice

TWO_PI = float(2.0 * np.pi)

PARAM_NAMES = ("pitch", "decay", "attack", "tone", "volume", "tuning")
NUM_PARAMS = len(PARAM_NAMES)
PARAM_INDEX = {n: i for i, n in enumerate(PARAM_NAMES)}

PITCH_RANGE = (3500.0, 10_000.0)   # after pow2 curve
ATTACK_MS_RANGE = (0.5, 200.0)
DECAY_MS_RANGE = (0.5, 4000.0)
TONE_RANGE = (500.0, 10_000.0)

NOISE_WHITE, NOISE_PINK = 0, 1
SLOPE_12DB, SLOPE_24DB = 0, 1

#: golden-ratio multiplier that salts each voice's noise counter
SALT_MULT = 0x9E3779B9


@dataclass(frozen=True)
class HiHat2Config:
    pitch: float = 0.76
    decay: float = 0.05
    attack: float = 0.0
    tone: float = 1.0
    volume: float = 1.0
    tuning: float = 0.5
    noise_color: int = NOISE_WHITE
    filter_slope: int = SLOPE_24DB

    def as_array(self) -> np.ndarray:
        return np.clip(
            np.array([getattr(self, n) for n in PARAM_NAMES], np.float32), 0.0, 1.0
        )

    # presets (hihat2.rs:80-99)
    @staticmethod
    def short():
        return HiHat2Config(0.76, 0.05, 0.0, 1.0)

    @staticmethod
    def loose():
        return HiHat2Config(0.76, 0.30, 0.0, 1.0)

    @staticmethod
    def dark():
        return HiHat2Config(0.41, 0.05, 0.0, 0.15)

    @staticmethod
    def soft():
        return HiHat2Config(0.41, 0.05, 0.15, 0.60)


PRESETS = {
    "default": HiHat2Config.short,
    "short": HiHat2Config.short,
    "loose": HiHat2Config.loose,
    "dark": HiHat2Config.dark,
    "soft": HiHat2Config.soft,
}


def pitch_hz_from_norm(pitch_norm):
    """pow2 pitch curve: denorm(pitch^2, 3500, 10000) (hihat2.rs:100-104)."""
    return dsp.denormalize(pitch_norm * pitch_norm, *PITCH_RANGE)


class HiHat2State(NamedTuple):
    params: SmootherBank          # [V, NUM_PARAMS]
    noise_color: torch.Tensor     # [V] i32
    filter_slope: torch.Tensor    # [V] i32
    trig_sample: torch.Tensor     # [V] i32
    velocity: torch.Tensor        # [V]
    mod_phase: torch.Tensor       # [V] phase accumulators
    main_phase: torch.Tensor      # [V]
    env_smooth: torch.Tensor      # [V] asymmetric smoother state
    hpf1: filters.BiquadState
    hpf2: filters.BiquadState
    svf: filters.SVFState
    pink: pink_mod.PinkState
    #: global voice index salting the per-voice noise stream: int64 holding
    #: the JAX package's uint32 pattern (interop carries it as uint32)
    voice_salt: torch.Tensor      # [V]

    #: numpy dtype of a leaf when it differs from the tensor's (interop)
    NUMPY_DTYPES = {"voice_salt": np.uint32}


def init_state(num_voices: int, config: Optional[HiHat2Config] = None, targets=None, *,
               device) -> HiHat2State:
    cfg = config or HiHat2Config.short()
    if targets is None:
        targets = np.broadcast_to(cfg.as_array(), (num_voices, NUM_PARAMS))
    v = (num_voices,)

    def full(value, dtype=torch.float32):
        return torch.full(v, value, dtype=dtype, device=device)

    return HiHat2State(
        params=SmootherBank.init(targets, device),
        noise_color=full(cfg.noise_color, torch.int32),
        filter_slope=full(cfg.filter_slope, torch.int32),
        trig_sample=full(int(NEVER), torch.int32),
        velocity=full(1.0),
        mod_phase=full(0.0),
        main_phase=full(0.0),
        env_smooth=full(0.0),
        hpf1=filters.BiquadState.init(v, device),
        hpf2=filters.BiquadState.init(v, device),
        svf=filters.SVFState.init(v, device),
        pink=pink_mod.PinkState.init(v, device),
        voice_salt=torch.arange(num_voices, dtype=torch.int64, device=device),
    )


def render_block(
    state: HiHat2State,
    trig_offset,
    trig_velocity,
    block_start,
    *,
    sample_rate: float,
    block_size: int,
    smooth_coeff: float,
    overrides=None,
    fused: bool = True,
):
    """Render one block for the HiHat2 bank -> ``(new_state, out[V, B])``;
    ``fused``: allow the kit path."""
    sr = sample_rate
    dev = state.velocity.device
    if (fused and voice.use_kit(state.velocity)
            and voice.eligible(trig_offset, state.velocity.shape[0]) and overrides is None):
        return voice.hihat2_render_fused(state, trig_offset, trig_velocity, block_start,
                                         sample_rate=sr, block_size=block_size,
                                         smooth_coeff=smooth_coeff)
    vb = VoiceBlock(state.params, trig_offset, block_start, block_size,
                    smooth_coeff, PARAM_INDEX, overrides=overrides)
    ptraj, eff = vb.ptraj, vb.eff

    vel_new = torch.clamp(torch.as_tensor(trig_velocity, dtype=torch.float32, device=dev),
                          0.0, 1.0)
    vel = eff(vel_new, state.velocity)
    _t, _elapsed_i, _idx_f, elapsed = vb.elapsed(state.trig_sample, sr)

    # live-updated envelope segment durations (hihat2.rs:460-463)
    attack_s = dsp.denormalize(ptraj("attack"), *ATTACK_MS_RANGE) * 0.001
    decay_s = dsp.denormalize(ptraj("decay"), *DECAY_MS_RANGE) * 0.001

    pitch_hz = pitch_hz_from_norm(ptraj("pitch")) * dsp.tuning_to_multiplier(ptraj("tuning"))

    # --- noise source (NOT reset at trigger; counter = global sample) --------
    n_global = (vb.block_start + vb.n_local)[None, :]
    white = rng.white(rng.add_mul32(n_global, state.voice_salt[:, None], SALT_MULT))
    pink_state, pink = pink_mod.pink_block(state.pink, n_global.expand(white.shape), sr)
    noise_sig = torch.where((state.noise_color == NOISE_PINK)[:, None], pink, white)

    # --- phase-mod oscillator chain (hihat2.rs:256-285, 497-505) -------------
    mod_inc = pitch_hz * 0.1 / sr
    main_inc = pitch_hz / sr
    reset = vb.at_trig
    mod_phase = gscan.phase_cumsum_reset(mod_inc, reset, state.mod_phase)
    main_phase = gscan.phase_cumsum_reset(main_inc, reset, state.main_phase)
    mod_sig = noise_sig * 0.25
    mod_out = torch.sin(TWO_PI * torch.remainder(mod_phase + mod_sig, 1.0))
    main_out = torch.sin(TWO_PI * torch.remainder(main_phase + mod_out * 0.75, 1.0))

    # --- highpass stages at pitch ---------------------------------------------
    hpf_coeffs = filters.rbj_highpass_coeffs(pitch_hz, 1.0, sr)
    hpf1, y1 = filters.biquad_df1_block(state.hpf1, main_out, hpf_coeffs, reset=reset)
    hpf2, y2 = filters.biquad_df1_block(state.hpf2, y1, hpf_coeffs, reset=reset)
    filtered = torch.where((state.filter_slope == SLOPE_24DB)[:, None], y2 * 0.8, y1)

    # --- MaxCurve envelope through the asymmetric smoother ---------------------
    # segments: [(1, attack, -0.3), (0, decay, -0.8)] evaluated per sample
    in_attack = elapsed < attack_s
    attack_prog = torch.where(attack_s > 0, elapsed / torch.clamp(attack_s, min=1e-9), 1.0)
    decay_prog = torch.where(decay_s > 0,
                             (elapsed - attack_s) / torch.clamp(decay_s, min=1e-9), 1.0)
    env_raw = torch.where(
        in_attack,
        max_curve(attack_prog, -0.3),
        1.0 - max_curve(torch.clamp(decay_prog, 0.0, 1.0), -0.8),
    )
    env_raw = torch.where(elapsed < 0.0, 0.0, env_raw)
    down_coeff = float(1.0 - np.exp(-1.0 / 100.0))  # 100-sample down smoother
    env = gscan.asym_smooth(env_raw, down_coeff, state.env_smooth, reset=reset)

    output = filtered * env * vel * 0.35

    # --- tone SVF highpass + volume -------------------------------------------
    tone_hz = dsp.denormalize(ptraj("tone"), *TONE_RANGE)
    svf_state, _lp, _bp, hp = filters.svf_tpt_outputs(state.svf, output, tone_hz, 0.5, sr,
                                                      reset=reset)
    out = hp * ptraj("volume")

    new_state = HiHat2State(
        params=vb.advance_bank(),
        noise_color=state.noise_color,
        filter_slope=state.filter_slope,
        trig_sample=vb.latch(vb.block_start + vb.trig_offset, state.trig_sample),
        velocity=vb.latch(vel_new, state.velocity),
        mod_phase=mod_phase[:, -1],
        main_phase=main_phase[:, -1],
        env_smooth=env[:, -1],
        hpf1=hpf1,
        hpf2=hpf2,
        svf=svf_state,
        pink=pink_state,
        voice_salt=state.voice_salt,
    )
    return new_state, out
