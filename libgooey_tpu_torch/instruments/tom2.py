"""Tom2: the Max-derived tom (morph oscillator + membrane resonator),
batched over ``[V, B]`` (port of libgooey_tpu/instruments/tom2.py:35-302,
the stage path and ``_back_half``).

Behavioral reference: src/instruments/tom2.rs.  Signal path
(tom2.rs:427-594):

* MaxCurve envelope [(1, 1 ms, 0.8), (0, decay, -0.83)], decay latched at
  trigger from the 0-100 `decay` knob (0.5-4000 ms);
* pitch = ``tune_freq * (1 + (env * bend_scaled)^2)``;
* sources: ClickOsc impulse * 1.1 + triangle * 0.5 + MorphOsc;
* RBJ constant-gain bandpass tracking the pitch, then the VCA envelope;
* MembraneResonator wet path rings past the VCA, with a ring-level fade;
  sub-40 Hz fade-out guard; output gain 0.7 * volume/100.

Tom2 parameters are plain values (0-100, Max convention), not smoothed, and
its trigger ignores velocity.  Kernels on this path: ``affine1_bank`` (phase
accumulators, the rand~ ramp, the ring follower) and ``linrec2_bank`` (the
bandpass and the membrane's five bands, R = 5V rows).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from libgooey_tpu_torch.core import dsp
from libgooey_tpu_torch.core.max_curve import max_curve
from libgooey_tpu_torch.instruments.common import NEVER
from libgooey_tpu_torch.ops import filters, morph, voice
from libgooey_tpu_torch.ops import scan as gscan

PARAM_NAMES = (
    "tune", "bend", "tone", "color", "decay", "membrane", "membrane_q", "volume",
    "tuning",
)
NUM_PARAMS = len(PARAM_NAMES)
PARAM_INDEX = {n: i for i, n in enumerate(PARAM_NAMES)}

FREQ_MIN, FREQ_MAX = 40.0, 600.0
FADE_START_FREQ, MIN_AUDIBLE_FREQ = 40.0, 20.0
DECAY_MIN_MS, DECAY_MAX_MS = 0.5, 4000.0


@dataclass(frozen=True)
class Tom2Config:
    """0-100 ranged params (Max convention), tuning 0-1 (tom2.rs:105-178)."""

    tune: float = 60.0
    bend: float = 70.0
    tone: float = 50.0
    color: float = 0.0
    decay: float = 20.0
    membrane: float = 0.0
    membrane_q: float = 50.0
    volume: float = 100.0
    tuning: float = 0.5

    def as_array(self) -> np.ndarray:
        return np.array([getattr(self, n) for n in PARAM_NAMES], np.float32)

    @staticmethod
    def derp():
        return Tom2Config()

    @staticmethod
    def ring():
        return Tom2Config(80.0, 20.0, 10.0, 0.0, 100.0, 60.0, 70.0, 100.0)

    @staticmethod
    def brush():
        return Tom2Config(40.0, 20.0, 10.0, 90.0, 30.0, 0.0, 50.0, 100.0)

    @staticmethod
    def void_preset():
        return Tom2Config(60.0, 30.0, 100.0, 50.0, 90.0, 40.0, 80.0, 100.0)


PRESETS = {
    "default": Tom2Config.derp,
    "derp": Tom2Config.derp,
    "ring": Tom2Config.ring,
    "brush": Tom2Config.brush,
    "void": Tom2Config.void_preset,
}


def tune_to_freq(tune):
    """tune 0-100 -> 40-600 Hz with a pow-2 knee (tom2.rs:243-249)."""
    n = tune / 100.0
    return FREQ_MIN + n * n * (FREQ_MAX - FREQ_MIN)


class Tom2State(NamedTuple):
    params: torch.Tensor          # [V, NUM_PARAMS]: plain, unsmoothed
    trig_sample: torch.Tensor     # [V] i32
    decay_s: torch.Tensor         # [V] latched decay seconds
    tri_phase: torch.Tensor       # [V]
    morph: morph.MorphState       # [V] fields
    bandpass: filters.BiquadState
    membrane: filters.MembraneState


def init_state(num_voices: int, config: Optional[Tom2Config] = None, targets=None, *,
               device) -> Tom2State:
    if targets is None:
        targets = np.broadcast_to((config or Tom2Config()).as_array(),
                                  (num_voices, NUM_PARAMS))
    v = (num_voices,)
    return Tom2State(
        params=torch.as_tensor(np.array(targets, np.float32), device=device),
        trig_sample=torch.full(v, int(NEVER), dtype=torch.int32, device=device),
        decay_s=torch.full(v, 2.0, dtype=torch.float32, device=device),
        tri_phase=torch.zeros(v, dtype=torch.float32, device=device),
        morph=morph.MorphState.init(v, device),
        bandpass=filters.BiquadState.init(v, device),
        membrane=filters.MembraneState.init(v, device),
    )


def render_block(
    state: Tom2State,
    trig_offset,
    trig_velocity,
    block_start,
    *,
    sample_rate: float,
    block_size: int,
    smooth_coeff: float = 0.0,
    triangle_enabled: bool = True,
    overrides=None,
    fused: bool = True,
):
    """Render one block for the Tom2 bank -> ``(new_state, out[V, B])``.

    ``trig_velocity``, ``smooth_coeff`` and ``overrides`` are accepted for
    the uniform instrument signature and ignored (tom2.rs discards velocity
    and is not modulatable).  With ``fused`` and a ``[V]`` bank the kit
    path takes it (ops/voice.py): the source stage runs in ``kit_sources``,
    the bandpass and the membrane below are shared by both paths (tom2.py
    fused gate, 141-190)."""
    del trig_velocity, smooth_coeff, overrides
    sr = sample_rate
    B = block_size
    dev = state.trig_sample.device
    if (fused and voice.use_kit(state.trig_sample)
            and voice.eligible(trig_offset, state.trig_sample.shape[0])):
        front = voice.tom2_sources_fused(state, trig_offset, block_start, sample_rate=sr,
                                         block_size=B, triangle_enabled=triangle_enabled)
        return finish_fused(state, trig_offset, block_start, *front, sample_rate=sr,
                            block_size=B)

    n_local = torch.arange(B, dtype=torch.int32, device=dev)
    trig_offset = torch.as_tensor(trig_offset, device=dev).to(torch.int32)
    block_start = torch.as_tensor(block_start, device=dev).to(torch.int32)
    if trig_offset.dim() == 1:
        trig_offset = trig_offset[:, None]   # [V, K] trigger slots (ascending)
    valid_k = trig_offset < B                                          # [V, K]
    has_trig = torch.any(valid_k, dim=1)
    after_k = (n_local[None, None, :] >= trig_offset[:, :, None]) & valid_k[:, :, None]
    after = torch.any(after_k, dim=1)
    at_trig = torch.any(
        (n_local[None, None, :] == trig_offset[:, :, None]) & valid_k[:, :, None], dim=1)
    trig_global = block_start + trig_offset                            # [V, K]
    trig_eff = torch.broadcast_to(state.trig_sample[:, None], after.shape)
    for k in range(trig_offset.shape[1]):
        trig_eff = torch.where(after_k[:, k, :], trig_global[:, k, None], trig_eff)
    n_global = block_start + n_local
    elapsed_i = n_global[None, :] - trig_eff
    elapsed = elapsed_i.to(torch.float32) * float(np.float32(1.0 / sr))

    def p(name):
        return state.params[:, PARAM_INDEX[name]][:, None]  # [V, 1]

    decay_new = (DECAY_MIN_MS + (state.params[:, PARAM_INDEX["decay"]] / 100.0)
                 * (DECAY_MAX_MS - DECAY_MIN_MS)) * 0.001
    decay_s = torch.where(after, decay_new[:, None], state.decay_s[:, None])

    # --- envelope: [(1, 1ms, 0.8), (0, decay, -0.83)] -------------------------
    attack_s = 0.001
    in_attack = elapsed < attack_s
    env = torch.where(
        in_attack,
        max_curve(elapsed / attack_s, 0.8),
        1.0 - max_curve(torch.clamp((elapsed - attack_s) / decay_s, 0.0, 1.0), -0.83),
    )
    env = torch.where(elapsed < 0.0, 0.0, env)
    env_complete = elapsed >= (attack_s + decay_s)

    # --- pitch ----------------------------------------------------------------
    base_freq = tune_to_freq(p("tune")) * dsp.tuning_to_multiplier(p("tuning"))
    bend_scaled = (p("bend") / 100.0) * 2.0
    raw_freq = base_freq * (1.0 + torch.square(env * bend_scaled))

    past_attack = (elapsed >= attack_s) | (env > 0.9)
    main_done = env_complete | (past_attack & (raw_freq < MIN_AUDIBLE_FREQ))
    fade_factor = torch.where(
        past_attack & (raw_freq < FADE_START_FREQ),
        (raw_freq - MIN_AUDIBLE_FREQ) / (FADE_START_FREQ - MIN_AUDIBLE_FREQ),
        1.0,
    )
    modulated_freq = torch.clamp(raw_freq, min=FREQ_MIN)

    # --- sources ----------------------------------------------------------------
    click_out = morph.click_block(elapsed_i) * 1.1

    tri_inc = modulated_freq / sr
    tri_phase = gscan.phase_cumsum_reset(tri_inc, at_trig, state.tri_phase)
    if triangle_enabled:
        tri_out = morph.triangle_from_phase(torch.remainder(tri_phase - tri_inc, 1.0)) * 0.5
    else:
        tri_out = torch.zeros_like(click_out)

    zeros = torch.zeros_like(env)
    mix_control = (p("tone") / 100.0) * 2.0 - 1.0
    color_freq_1 = morph.mtof(30.0 + (p("color") / 100.0) * 20.0)
    morph_state, morph_out = morph.morph_block(
        state.morph, modulated_freq, mix_control + zeros, color_freq_1 + zeros,
        p("tone") + zeros, elapsed_i, at_trig, sr)

    mixed = click_out + tri_out + morph_out

    last_trig = state.trig_sample
    for k in range(trig_offset.shape[1]):
        last_trig = torch.where(valid_k[:, k], trig_global[:, k], last_trig)

    bp_state, mem_state, out = _back_half(state, at_trig, elapsed_i, mixed, env, main_done,
                                          fade_factor, modulated_freq, sr)
    new_state = Tom2State(
        params=state.params,
        trig_sample=last_trig,
        decay_s=torch.where(has_trig, decay_new, state.decay_s),
        tri_phase=torch.remainder(tri_phase[:, -1], 1.0),
        morph=morph_state,
        bandpass=bp_state,
        membrane=mem_state,
    )
    return new_state, out


def _back_half(state, at_trig, elapsed_i, mixed, env, main_done, fade_factor,
               modulated_freq, sr):
    """Bandpass + membrane recurrences and the output composition
    (tom2.py:267-302)."""

    def p(name):
        return state.params[:, PARAM_INDEX[name]][:, None]  # [V, 1]

    # --- pitch-tracking bandpass (q = 1 + (color/100)^2, gain 1.1) -------------
    filter_freq = torch.clamp(modulated_freq, min=20.0)
    color_n = p("color") / 100.0
    coeffs = filters.rbj_bandpass_coeffs(filter_freq, 1.0 + color_n * color_n, 1.1, sr)
    bp_state, filtered = filters.biquad_df1_block(state.bandpass, mixed, coeffs,
                                                  reset=at_trig)

    # --- membrane resonator -------------------------------------------------------
    q_scale = 0.005 + (state.params[:, PARAM_INDEX["membrane_q"]] / 100.0) * 0.015
    gain_scale = torch.full_like(q_scale, 0.003)  # tom input gain (tom2.rs:393-398)
    membrane_mix = p("membrane") / 100.0
    membrane_input = torch.where(main_done, 0.0, filtered * env)
    membrane_input = torch.where(membrane_mix > 0.0, membrane_input, 0.0)
    mem_state, mem_out, ring = filters.membrane_block(
        state.membrane, membrane_input, q_scale, gain_scale, sr, reset=at_trig)
    mem_out = torch.where(membrane_mix > 0.0, mem_out, 0.0)
    fade = filters.membrane_fade(ring)

    vol = p("volume") / 100.0
    dry = filtered * env
    mixed_out = dry * (1.0 - membrane_mix) + mem_out * membrane_mix
    ring_only = mem_out * membrane_mix * fade * 0.7 * vol
    normal = mixed_out * fade_factor * 0.7 * vol
    out = torch.where(main_done, ring_only, normal)
    # fully inactive: main done and membrane not ringing (tom2.rs:478-482)
    out = torch.where(main_done & (ring <= 0.0001), 0.0, out)
    out = torch.where(elapsed_i >= 0, out, 0.0)
    return bp_state, mem_state, out


def finish_fused(state, trig_offset, block_start, front, mixed, env, main_done, fade_factor,
                 modulated_freq, *, sample_rate, block_size):
    """Finish a kit-path render (tom2.py:305): the trigger geometry again,
    the shared back half, the new Tom2State."""
    B = block_size
    dev = state.trig_sample.device
    n_local = torch.arange(B, dtype=torch.int32, device=dev)
    off = torch.as_tensor(trig_offset, device=dev).to(torch.int32)[:, None]
    block_start = torch.as_tensor(block_start, device=dev).to(torch.int32)
    valid = off < B
    at_trig = (n_local[None, :] == off) & valid
    after = (n_local[None, :] >= off) & valid
    trig_eff = torch.where(after, block_start + off, state.trig_sample[:, None])
    elapsed_i = (block_start + n_local)[None, :] - trig_eff
    new_trig, new_decay, new_tri_phase, morph_state = front
    bp_state, mem_state, out = _back_half(state, at_trig, elapsed_i, mixed, env, main_done,
                                          fade_factor, modulated_freq, sample_rate)
    return Tom2State(params=state.params, trig_sample=new_trig, decay_s=new_decay,
                     tri_phase=new_tri_phase, morph=morph_state, bandpass=bp_state,
                     membrane=mem_state), out
