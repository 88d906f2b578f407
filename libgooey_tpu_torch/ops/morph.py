"""MorphOsc and ClickOsc: the Max-derived tom sources, blocked
(port of libgooey_tpu/ops/morph.py).

Behavioral reference: src/gen/morph_osc.rs and src/gen/click_osc.rs.

MorphOsc is a 3-channel crossfade (``mix3``) of:
  1. ring mod: sine(phase@f)*0.5 * sine(phase@190Hz)*0.5
  2. triangle(phase@f)*0.5 + combined noise
  3. combined noise + gated sine*0.2 (gate open when tone < 99)
combined noise = (white*0.2 + rand~)*0.4, where rand~ ramps linearly between
random values at ``mtof(color_freq)`` rate.  The phase accumulators are
per-block cumulative sums with carried state and trigger resets
(``ops/scan.py``); rand~ is a pure function of the accumulated rand phase
(segment index -> hashed target), as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from libgooey_tpu_torch.core import rng
from libgooey_tpu_torch.ops import scan as gscan

TWO_PI = float(2.0 * np.pi)
RAND_SEED = 0x12345678


def mtof(midi):
    """MIDI note -> frequency (morph_osc.rs:36-38)."""
    return 440.0 * torch.exp2((midi - 69.0) / 12.0)


def triangle_from_phase(phase):
    """Naive /\\ triangle from phase in [0,1) (morph_osc.rs:24-32)."""
    t = torch.remainder(phase, 1.0)
    return torch.where(t < 0.5, 4.0 * t - 1.0, 3.0 - 4.0 * t)


class MorphState(NamedTuple):
    """Carried phases, ``[V]`` each; the rand~ position is carried as
    (segment count, fractional phase) so f32 keeps its precision."""

    main_phase: torch.Tensor
    tri_phase: torch.Tensor
    fixed_phase: torch.Tensor
    gated_phase: torch.Tensor
    rand_seg: torch.Tensor    # i32 segments since trigger
    rand_frac: torch.Tensor   # f32 in [0, 1)

    @staticmethod
    def init(shape, device) -> "MorphState":
        def z(dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return MorphState(z(), z(), z(), z(), z(torch.int32), z())


def _accum(inc, reset_f, carry):
    """Unwrapped cumsum with trigger resets, split-increment form
    (morph.py:78-106): ``hi*(n+1)`` on a 2^-11 grid is exact, ``lo*(n+1)``
    and the residual cumsum carry one rounding each."""
    B = inc.shape[-1]
    n1 = torch.arange(1, B + 1, dtype=torch.float32, device=inc.device)
    inc0 = inc[..., 0:1]
    hi = torch.floor(inc0 * 2048.0) / 2048.0
    lo = inc0 - hi
    ramp = hi * n1 + lo * n1
    p = ramp + gscan.cumsum_bank(inc - inc0)
    p_prev = torch.cat([torch.zeros_like(p[..., 0:1]), p[..., :-1]], dim=-1)
    base = gscan.linrec1(1.0 - reset_f, reset_f * p_prev, -carry)
    return p - base


def morph_block(state: MorphState, frequency, mix_control, color_freq, tone, elapsed_i,
                reset, sample_rate: float):
    """One block of the morph oscillator -> ``(new_state, out[V, B])``.

    ``frequency``, ``mix_control`` (-1..1), ``color_freq`` (the first-mtof
    result), ``tone`` (0-100) are ``[V, B]``; ``elapsed_i`` int samples
    since trigger; ``reset`` the trigger mask."""
    sr = sample_rate
    inc = frequency / sr
    main_phase = gscan.phase_cumsum_reset(inc, reset, state.main_phase)
    tri_phase = gscan.phase_cumsum_reset(inc, reset, state.tri_phase)
    gated_phase = gscan.phase_cumsum_reset(inc, reset, state.gated_phase)
    fixed_inc = 190.0 / sr
    fixed_phase = gscan.phase_cumsum_reset(torch.full_like(inc, fixed_inc), reset,
                                           state.fixed_phase)

    # the reference uses the phase, then advances: shift by one increment
    def used(phase, inc):
        return torch.remainder(phase - inc, 1.0)

    main_sine = torch.sin(TWO_PI * used(main_phase, inc)) * 0.5
    tri = triangle_from_phase(used(tri_phase, inc)) * 0.5
    fixed_sine = torch.sin(TWO_PI * used(fixed_phase, fixed_inc)) * 0.5
    gated_sine = torch.where(tone < 99.0, torch.sin(TWO_PI * used(gated_phase, inc)) * 0.2, 0.0)

    # white noise: hash of samples-since-trigger (counter resets at trigger)
    white = rng.white(elapsed_i) * 0.2

    # rand~ sample-and-hold with linear ramps at mtof(color_freq) Hz, on top
    # of the carried fraction; the segment count rebases as an integer
    reset_f = reset.to(torch.float32)
    total = _accum(mtof(color_freq) / sr, reset_f, state.rand_frac)
    seg_local = torch.floor(total)
    frac = total - seg_local
    # the carried segment base resets to 0 from the trigger sample on
    after = torch.cumsum(reset.to(torch.int32), dim=-1) > 0
    seg = torch.where(after, 0, state.rand_seg[..., None]) + seg_local.to(torch.int32)
    # segment 0 ramps from 0 to 0 (the reference starts with current=target=0)
    tgt = torch.where(seg >= 1, rng.white(seg, RAND_SEED), 0.0)
    cur = torch.where(seg >= 2, rng.white(seg - 1, RAND_SEED), 0.0)
    rand_value = cur + (tgt - cur) * frac

    noise_combined = (white + rand_value) * 0.4
    ch1 = main_sine * fixed_sine
    ch2 = tri + noise_combined
    ch3 = noise_combined + gated_sine
    w1 = torch.clamp(-mix_control, 0.0, 1.0)
    w2 = torch.clamp(1.0 - mix_control.abs(), 0.0, 1.0)
    w3 = torch.clamp(mix_control, 0.0, 1.0)
    out = ch1 * w1 + ch2 * w2 + ch3 * w3

    new_state = MorphState(
        main_phase=main_phase[..., -1],
        tri_phase=tri_phase[..., -1],
        fixed_phase=fixed_phase[..., -1],
        gated_phase=gated_phase[..., -1],
        rand_seg=seg[..., -1],
        rand_frac=frac[..., -1],
    )
    return new_state, out


# --- ClickOsc ------------------------------------------------------------------

#: The 64-sample tom attack impulse (the reference's Max patch `setimpulse`
#: table, src/gen/click_osc.rs:7-14).
TOM_IMPULSE = np.array(
    [
        0.884058, 0.942029, 0.913043, 0.869565, 0.833333, 0.797101, 0.772947,
        0.748792, 0.724638, 0.695652, 0.666667, 0.637681, 0.619565, 0.601449,
        0.583333, 0.565217, 0.536232, 0.507246, 0.478261, 0.449275, 0.42029,
        0.391304, 0.371981, 0.352657, 0.333333, 0.304348, 0.275362, 0.23913,
        0.202899, 0.181159, 0.15942, 0.137681, 0.115942, 0.101449, 0.086957,
        0.072464, 0.057971, 0.043478, 0.028986, 0.014493, 0.009662, 0.004831,
        0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.014493,
        0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    ],
    np.float32,
)


@functools.lru_cache(maxsize=None)
def _impulse(device: torch.device) -> torch.Tensor:
    """The impulse table on ``device``, copied once (a per-block
    host-to-device copy would synchronize the stream)."""
    return torch.as_tensor(TOM_IMPULSE, device=device)


def click_block(elapsed_i):
    """One-shot 64-sample wavetable playback from the trigger sample: a pure
    function of samples-since-trigger (click_osc.rs:44-77)."""
    idx = elapsed_i.to(torch.int64)
    table = _impulse(idx.device)
    n = table.shape[0]
    in_range = (idx >= 0) & (idx < n)
    return torch.where(in_range, table[torch.clamp(idx, 0, n - 1)], 0.0)
