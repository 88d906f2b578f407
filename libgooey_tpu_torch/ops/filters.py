"""Recursive filters over ``[V, B]`` (port of libgooey_tpu/ops/filters.py:56-443).

Coefficient trajectories are computed elementwise from the smoothed
parameters; the state recursion runs in a bank kernel: ``svf_bank`` for the
TPT (Simper) state-variable filter, ``linrec2_bank`` (through
``scan.linrec2``) for the RBJ biquads, the membrane's five bands and the
2x-iterated Chamberlin SVF, ``affine1_bank`` (through ``scan.linrec1``) for
the one-pole structures and ``dc_block`` (the bus effects' 4x blockers run
inside their kernels).

Behavioral references: src/filters/resonant_lowpass.rs and
state_variable_tpt.rs (Simper SVF: g = tan(pi*fc/sr), r = 1/Q,
h = 1/(1 + r*g + g*g)), src/filters/resonant_highpass.rs (the cheap one-pole
HP of the kick click), biquad_highpass.rs / biquad_bandpass.rs (RBJ, Direct
Form I), membrane_resonator.rs and state_variable.rs (Chamberlin).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from libgooey_tpu_torch.ops import bank_kernels
from libgooey_tpu_torch.ops import scan as gscan

PI = float(np.pi)


def _shift1(x: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Delay by one along the trailing axis with carried first value."""
    return torch.cat([x0[..., None], x[..., :-1]], dim=-1)


# --- TPT (Simper) state-variable filter -------------------------------------


class SVFState(NamedTuple):
    """TPT SVF integrator state (ic1eq, ic2eq), ``[V]`` each."""

    ic1: torch.Tensor
    ic2: torch.Tensor

    @staticmethod
    def init(shape, device) -> "SVFState":
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return SVFState(ic1=z, ic2=z.clone())


def svf_coeffs(cutoff_hz, q, sample_rate: float, min_hz=20.0, max_hz=20_000.0):
    """Per-sample (g, h) for the TPT SVF.  resonant_lowpass.rs:95-103."""
    cutoff = torch.clamp(cutoff_hz, min_hz, min(max_hz, sample_rate * 0.45))
    g = torch.tan(PI * cutoff / sample_rate)
    r = 1.0 / torch.clamp(q if isinstance(q, torch.Tensor) else torch.full_like(g, q), 0.5, 10.0)
    h = 1.0 / (1.0 + r * g + g * g)
    return g, h


def svf_tpt_block(state: SVFState, x, g, h, reset=None):
    """Run the TPT SVF over a block with per-sample coefficients.

    Per-sample update (resonant_lowpass.rs:48-61):
        v1 = (g*(x - ic2) + ic1) * h ;  v2 = ic2 + g*v1
        ic1' = 2*v1 - ic1 ;  ic2' = 2*v2 - ic2
    ``reset`` zeroes the incoming state at masked samples.
    Returns ``(new_state, v1, v2)`` with the pre-update taps."""
    g, h, x = torch.broadcast_tensors(g, h, x)
    v1, v2, ic1, ic2 = bank_kernels.svf_bank(
        x.contiguous(), g.contiguous(), h.contiguous(),
        None if reset is None else reset.contiguous(),
        state.ic1.contiguous(), state.ic2.contiguous())
    return SVFState(ic1=ic1, ic2=ic2), v1, v2


def resonant_lowpass_block(state: SVFState, x, cutoff_hz, q, sample_rate, reset=None):
    """`ResonantLowpassFilter`: TPT SVF low-pass tap with denormal flush
    (resonant_lowpass.rs:48-61, output = v2 flushed at 1e-15)."""
    g, h = svf_coeffs(cutoff_hz, q, sample_rate)
    state, _v1, v2 = svf_tpt_block(state, x, g, h, reset=reset)
    out = torch.where(v2.abs() < 1e-15, 0.0, v2)
    return state, out


def svf_tpt_outputs(state: SVFState, x, cutoff_hz, q, sample_rate, reset=None):
    """`StateVariableTPTFilter`: ``(state, lowpass, bandpass, highpass)`` taps.

    state_variable_tpt.rs:42-68: lp = v2, bp = v1, hp = x - r*v1 - v2; ``q``
    is a Python number or a tensor, clamped below only."""
    cutoff = torch.clamp(cutoff_hz, 20.0, sample_rate * 0.45)
    g = torch.tan(PI * cutoff / sample_rate)
    if isinstance(q, torch.Tensor):
        r = 1.0 / torch.clamp(q, min=0.5)
    else:
        r = float(np.float32(1.0) / np.maximum(np.float32(q), np.float32(0.5)))
    h = 1.0 / (1.0 + r * g + g * g)
    state, v1, v2 = svf_tpt_block(state, x, g, h, reset=reset)
    return state, v2, v1, x - (r * v1 + v2)


# --- one-pole structures -----------------------------------------------------


class OnePoleState(NamedTuple):
    y: torch.Tensor

    @staticmethod
    def init(shape, device) -> "OnePoleState":
        return OnePoleState(y=torch.zeros(shape, dtype=torch.float32, device=device))


def onepole_lp_block(state: OnePoleState, x, coeff, reset=None):
    """``y += coeff * (x - y)`` over a block; ``coeff`` is a scalar or a
    per-sample tensor broadcasting against ``x``; returns ``(state, y traj)``."""
    if isinstance(coeff, torch.Tensor):
        a = torch.broadcast_to(1.0 - coeff, x.shape)
    else:
        coeff = float(np.float32(coeff))
        a = torch.full_like(x, float(np.float32(1.0) - np.float32(coeff)))
    if reset is not None:
        a = torch.where(reset, 0.0, a)
    y = gscan.linrec1(a, coeff * x, state.y)
    return OnePoleState(y=y[..., -1]), y


def resonant_highpass_block(state: OnePoleState, x, cutoff_hz, resonance,
                            sample_rate, reset=None):
    """`ResonantHighpassFilter` — the intentionally cheap one-pole HP of the
    kick click (resonant_highpass.rs:22-53):

        alpha = 1 - exp(-2pi*fc/sr); hp = x - state; state += alpha*hp
        out = hp * (1 + res*0.1)
    """
    alpha = np.float32(1.0 - np.exp(np.float32(-2.0 * PI * cutoff_hz / sample_rate)))
    state_new, y = onepole_lp_block(state, x, alpha, reset=reset)
    s_prev = _shift1(y, state.y)
    if reset is not None:
        s_prev = torch.where(reset, 0.0, s_prev)
    hp = x - s_prev
    return state_new, hp * (1.0 + resonance * 0.1)


# --- DC blocker ---------------------------------------------------------------


class DCBlockState(NamedTuple):
    """DC blocker memories ``y[n] = x[n] - x[n-1] + R*y[n-1]``
    (feedback_waveshaper.rs:262-271): previous input and output."""

    x1: torch.Tensor
    y1: torch.Tensor

    @staticmethod
    def init(shape, device) -> "DCBlockState":
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return DCBlockState(x1=z, y1=z.clone())


def dc_block(state: DCBlockState, x, coeff: float = 0.995):
    """``y[n] = x[n] - x[n-1] + R*y[n-1]`` (feedback_waveshaper.rs:262-271)
    through ``scan.linrec1``: one ``affine1_bank`` launch on the card."""
    x_prev = _shift1(x, state.x1)
    y = gscan.linrec1(torch.full_like(x, float(np.float32(coeff))), x - x_prev, state.y1)
    return DCBlockState(x1=x[..., -1], y1=y[..., -1]), y


# --- RBJ biquads (Direct Form I) ----------------------------------------------


class BiquadState(NamedTuple):
    """DF-I delay line: x1, x2, y1, y2 (slice-shaped)."""

    x1: torch.Tensor
    x2: torch.Tensor
    y1: torch.Tensor
    y2: torch.Tensor

    @staticmethod
    def init(shape, device) -> "BiquadState":
        def z():
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return BiquadState(z(), z(), z(), z())


def rbj_highpass_coeffs(freq, q, sample_rate: float):
    """RBJ highpass (biquad_highpass.rs:85-104).  Returns (b0, b1, b2, a1, a2)."""
    omega = 2.0 * PI * freq / sample_rate
    sin_o, cos_o = torch.sin(omega), torch.cos(omega)
    alpha = sin_o / (2.0 * q)
    a0 = 1.0 + alpha
    b0 = (1.0 + cos_o) / 2.0 / a0
    b1 = -(1.0 + cos_o) / a0
    b2 = (1.0 + cos_o) / 2.0 / a0
    a1 = -2.0 * cos_o / a0
    a2 = (1.0 - alpha) / a0
    return b0, b1, b2, a1, a2


def rbj_bandpass_coeffs(freq, q, gain, sample_rate: float):
    """RBJ constant-gain bandpass (biquad_bandpass.rs:90-120)."""
    nyquist = sample_rate * 0.5
    freq = torch.clamp(freq, 20.0, nyquist * 0.95)
    q = torch.clamp(q, 0.1, 100.0)
    omega = 2.0 * PI * freq / sample_rate
    sin_o, cos_o = torch.sin(omega), torch.cos(omega)
    alpha = sin_o / (2.0 * q)
    a0 = 1.0 + alpha
    b0 = q * alpha * gain / a0
    b1 = torch.zeros_like(b0)
    b2 = -q * alpha * gain / a0
    a1 = -2.0 * cos_o / a0
    a2 = (1.0 - alpha) / a0
    return b0, b1, b2, a1, a2


def biquad_df1_block(state: BiquadState, x, coeffs, reset=None):
    """Direct Form I biquad over a block with per-sample coefficients.

    ``y[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2] - a1 y[n-1] - a2 y[n-2]``
    (biquad_highpass.rs:110-125): the feed-forward side vectorizes with
    shifts, the feedback side runs in ``linrec2`` with
    ``A = [[-a1, -a2], [1, 0]]``.  A reset clears the delay line at masked
    samples.  The output flushes denormals; the state keeps the raw value.
    Returns ``(new_state, y)``."""
    b0, b1, b2, a1, a2, x = torch.broadcast_tensors(*coeffs, x)
    x_prev1 = _shift1(x, state.x1)
    x_prev2 = _shift1(x_prev1, state.x2)
    if reset is not None:
        # x1 is 0 at the reset sample, x2 at the reset sample and the next
        reset = torch.broadcast_to(reset, x.shape)
        keepm = torch.where(reset, 0.0, 1.0)
        reset_prev = _shift1(reset, torch.zeros(x.shape[:-1], dtype=torch.bool,
                                                device=x.device))
        x_prev1 = x_prev1 * keepm
        x_prev2 = x_prev2 * keepm * torch.where(reset_prev, 0.0, 1.0)
    w = b0 * x + b1 * x_prev1 + b2 * x_prev2
    A11 = -a1
    A12 = -a2
    ones = torch.ones_like(a1)
    zeros = torch.zeros_like(a1)
    if reset is not None:
        A11 = A11 * keepm
        A12 = A12 * keepm
        ones = ones * keepm
    y, y2 = gscan.linrec2(A11, A12, ones, zeros, w, zeros, (state.y1, state.y2))
    out = torch.where(y.abs() < 1e-15, 0.0, y)
    new_state = BiquadState(x1=x[..., -1], x2=x_prev1[..., -1], y1=y[..., -1], y2=y2[..., -1])
    return new_state, out


# --- Membrane resonator ---------------------------------------------------------

#: Max patch preset 1 (gain, freq_hz, q) rows (membrane_resonator.rs:13-19)
MEMBRANE_PARAMS = np.array(
    [
        [275.0, 165.0, 376.0],
        [220.0, 228.0, 205.0],
        [79.0, 294.0, 143.0],
        [65.0, 320.0, 129.0],
        [57.0, 326.0, 141.0],
    ],
    np.float32,
)


@functools.lru_cache(maxsize=None)
def _membrane_table(device: torch.device) -> torch.Tensor:
    """``MEMBRANE_PARAMS`` on ``device``, copied once: a host-to-device copy
    per block would synchronize the stream."""
    return torch.as_tensor(MEMBRANE_PARAMS, device=device)


class MembraneState(NamedTuple):
    """5 parallel bandpass filters + ring-level follower."""

    biquads: BiquadState      # fields shaped [..., 5]
    ring_level: torch.Tensor  # [...]

    @staticmethod
    def init(shape, device) -> "MembraneState":
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        return MembraneState(
            biquads=BiquadState.init(shape + (5,), device),
            ring_level=torch.zeros(shape, dtype=torch.float32, device=device),
        )


def membrane_block(state: MembraneState, x, q_scale, gain_scale, sample_rate, reset=None):
    """5-band parallel resonator bank with tanh soft clip and ring follower.

    membrane_resonator.rs:147-203: out = tanh(sum of 5 reson filters);
    ring_level = 0.999*ring + 0.001*|out|.  The band axis folds into the
    rows of one ``linrec2`` call (R = V*5).  ``q_scale``/``gain_scale`` are
    per-voice ``[V]``.  Returns ``(new_state, out, ring_level_traj)``."""
    table = _membrane_table(x.device)
    gains, freqs, qs = table[:, 0], table[:, 1], table[:, 2]
    scaled_q = torch.clamp(qs * q_scale[..., None], 0.1, 100.0)       # [..., 5]
    scaled_gain = gains * gain_scale[..., None]                       # [..., 5]
    coeffs = rbj_bandpass_coeffs(freqs[:, None], scaled_q[..., None],
                                 scaled_gain[..., None], sample_rate)  # [..., 5, 1]
    x5 = x[..., None, :]                                              # [..., 1, B]
    reset5 = None if reset is None else reset[..., None, :]
    new_bq, y = biquad_df1_block(state.biquads, x5, coeffs, reset=reset5)
    clipped = torch.tanh(torch.sum(y, dim=-2))
    a = torch.full_like(clipped, 0.999)
    if reset is not None:
        a = torch.where(reset, 0.0, a)
    ring = gscan.linrec1(a, 0.001 * clipped.abs(), state.ring_level)
    return MembraneState(biquads=new_bq, ring_level=ring[..., -1]), clipped, ring


def membrane_fade(ring_level):
    """Smooth fade multiplier from ring level (membrane_resonator.rs:162-180)."""
    fade_start, fade_end = 0.005, 0.0001
    return torch.clamp((ring_level - fade_end) / (fade_start - fade_end), 0.0, 1.0)


# --- Chamberlin SVF (snare tone shaping) --------------------------------------


class ChamberlinState(NamedTuple):
    low: torch.Tensor
    band: torch.Tensor

    @staticmethod
    def init(shape, device) -> "ChamberlinState":
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return ChamberlinState(low=z, band=z.clone())


def chamberlin_block(state: ChamberlinState, x, cutoff_hz, resonance, sample_rate,
                     reset=None):
    """Chamberlin SVF, 2x-iterated per sample (state_variable.rs:53-91).

    ``f = 2 sin(pi * min(fc/sr, 0.45))``, ``q = 1/max(resonance, 0.5)``; each
    audio sample runs the core update twice with the same input.  One
    iteration is the affine map ``s' = M s + k x`` on s = (low, band); the
    two compose into one map per sample, solved by ``linrec2``.  Returns
    ``(state, low, band, high, notch)``, the second iteration's taps."""
    ratio = torch.clamp(torch.clamp(cutoff_hz, 20.0, 20_000.0) / sample_rate, max=0.45)
    f = 2.0 * torch.sin(PI * ratio)
    qq = 1.0 / torch.clamp(resonance, min=0.5)
    f, qq, x = torch.broadcast_tensors(f, qq, x)

    # one iteration: low' = low + f*band; band' = f*x + (1 - f*q - f*f)*band - f*low
    m11 = torch.ones_like(f)
    m12 = f
    m21 = -f
    m22 = 1.0 - f * qq - f * f
    k1 = torch.zeros_like(f)
    k2 = f
    a11 = m11 * m11 + m12 * m21
    a12 = m11 * m12 + m12 * m22
    a21 = m21 * m11 + m22 * m21
    a22 = m21 * m12 + m22 * m22
    b1 = (m11 * k1 + m12 * k2 + k1) * x
    b2 = (m21 * k1 + m22 * k2 + k2) * x
    if reset is not None:
        keep = torch.where(reset, 0.0, 1.0)
        a11, a12, a21, a22 = a11 * keep, a12 * keep, a21 * keep, a22 * keep
    s1, s2 = gscan.linrec2(a11, a12, a21, a22, b1, b2, (state.low, state.band))
    low_prev = _shift1(s1, state.low)
    band_prev = _shift1(s2, state.band)
    if reset is not None:
        low_prev = torch.where(reset, 0.0, low_prev)
        band_prev = torch.where(reset, 0.0, band_prev)
    lo1 = low_prev + f * band_prev
    hi1 = x - lo1 - qq * band_prev
    ba1 = band_prev + f * hi1
    lo2 = lo1 + f * ba1
    hi2 = x - lo2 - qq * ba1
    ba2 = ba1 + f * hi2
    notch = hi2 + lo2
    return ChamberlinState(low=s1[..., -1], band=s2[..., -1]), lo2, ba2, hi2, notch
