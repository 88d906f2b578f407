"""Small stateless DSP math (port of libgooey_tpu/core/dsp.py).

Behavioral reference: src/frame.rs (equal-power pan, downmix) and
src/utils/mod.rs (tuning, cubic interpolation, the raised-sine window).
Stereo convention as in the JAX package: the channel axis leads, ``[2, B]``.
"""

from __future__ import annotations

import numpy as np
import torch

HALF_PI = float(np.pi / 2.0)


def pan_gains(pan: torch.Tensor):
    """Equal-power pan gains for ``pan`` in [0, 1] (0=L, 0.5=center, 1=R).

    Returns ``(gain_l, gain_r)``.  Reference: src/frame.rs:31-37."""
    angle = torch.clamp(pan, 0.0, 1.0) * HALF_PI
    return torch.cos(angle), torch.sin(angle)


def panned(x: torch.Tensor, pan) -> torch.Tensor:
    """Pan mono ``x[...]`` into stereo ``[2, ...]`` with the equal-power law."""
    gl, gr = pan_gains(torch.as_tensor(pan, dtype=torch.float32, device=x.device))
    return torch.stack([x * gl, x * gr], dim=0)


def mono(x: torch.Tensor) -> torch.Tensor:
    """A mono signal equally on both channels (src/frame.rs:23)."""
    return torch.stack([x, x], dim=0)


def downmix(stereo: torch.Tensor) -> torch.Tensor:
    """Average a ``[2, ...]`` stereo stream to mono (src/frame.rs:42-44)."""
    return 0.5 * (stereo[0] + stereo[1])


def tuning_to_multiplier(normalized: torch.Tensor) -> torch.Tensor:
    """Normalized tuning (0..1) -> frequency multiplier (0.5x .. 2.0x).

    Reference: src/utils/mod.rs:14-17."""
    semitones = (torch.clamp(normalized, 0.0, 1.0) - 0.5) * 24.0
    return torch.exp2(semitones * (1.0 / 12.0))


def denormalize(normalized, lo, hi):
    """Map a normalized 0-1 value into [lo, hi] (clamping the input).

    Reference: src/instruments/kick.rs:48-52."""
    return lo + torch.clamp(normalized, 0.0, 1.0) * (hi - lo)


def cubic_interpolate(p0, p1, p2, p3, t):
    """4-point Catmull-Rom interpolation between ``p1`` and ``p2``
    (src/utils/mod.rs:26-32)."""
    a0 = -0.5 * p0 + 1.5 * p1 - 1.5 * p2 + 0.5 * p3
    a1 = p0 - 2.5 * p1 + 2.0 * p2 - 0.5 * p3
    a2 = -0.5 * p0 + 0.5 * p2
    a3 = p1
    return ((a0 * t + a1) * t + a2) * t + a3


def raised_sine_window(phase: torch.Tensor, shape) -> torch.Tensor:
    """``sin(pi*phase).max(0)**shape`` for phase in [0, 1]; shape 2 is Hann
    (src/utils/mod.rs:39-44)."""
    s = torch.clamp(torch.sin(np.pi * torch.clamp(phase, 0.0, 1.0)), min=0.0)
    return torch.pow(s, shape)


def normalize(value, lo, hi):
    """Inverse of :func:`denormalize`, clamped (kick.rs:55-59)."""
    return torch.clamp((value - lo) / (hi - lo), 0.0, 1.0)


def flush_denormals(x: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    """Flush values under ``eps`` in magnitude to zero, the reference's
    denormal guards (src/filters/resonant_lowpass.rs:55-60)."""
    return torch.where(x.abs() < eps, 0.0, x)
