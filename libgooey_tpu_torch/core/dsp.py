"""Small stateless DSP math (port of the slice's part of libgooey_tpu/core/dsp.py).

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


def tuning_to_multiplier(normalized: torch.Tensor) -> torch.Tensor:
    """Normalized tuning (0..1) -> frequency multiplier (0.5x .. 2.0x).

    Reference: src/utils/mod.rs:14-17."""
    semitones = (torch.clamp(normalized, 0.0, 1.0) - 0.5) * 24.0
    return torch.exp2(semitones * (1.0 / 12.0))


def denormalize(normalized, lo, hi):
    """Map a normalized 0-1 value into [lo, hi] (clamping the input).

    Reference: src/instruments/kick.rs:48-52."""
    return lo + torch.clamp(normalized, 0.0, 1.0) * (hi - lo)
