"""Recursive filters over ``[V, B]`` (port of libgooey_tpu/ops/filters.py:56-184).

Coefficient trajectories are computed elementwise from the smoothed
parameters; the state recursion runs in a bank kernel: ``svf_bank`` for the
TPT (Simper) state-variable filter, ``affine1_bank`` (through
``scan.linrec1``) for the one-pole structures.  The Chamberlin SVF, the
biquads and the DC blocker wait for a later PR (ROADMAP.md Queue A, A3).

Behavioral references: src/filters/resonant_lowpass.rs (Simper SVF:
g = tan(pi*fc/sr), r = 1/Q, h = 1/(1 + r*g + g*g)) and
src/filters/resonant_highpass.rs (the cheap one-pole HP of the kick click).
"""

from __future__ import annotations

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


# --- one-pole structures -----------------------------------------------------


class OnePoleState(NamedTuple):
    y: torch.Tensor

    @staticmethod
    def init(shape, device) -> "OnePoleState":
        return OnePoleState(y=torch.zeros(shape, dtype=torch.float32, device=device))


def onepole_lp_block(state: OnePoleState, x, coeff, reset=None):
    """``y += coeff * (x - y)`` over a block with a scalar ``coeff``;
    returns ``(state, y traj)``."""
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
