"""The limiters (port of libgooey_tpu/effects/limiter.py): the hard clamp
(``BrickWallLimiter``, src/effects/limiter.rs:15-33) and the soft
``tanh(x/t)*t`` (``SoftLimiter``, limiter.rs:66-77), pinned last on the
bus.  Both are stateless and per channel.
"""

from __future__ import annotations

import numpy as np
import torch


def brick_wall(x: torch.Tensor, threshold: float = 1.0) -> torch.Tensor:
    """Hard clamp to ±threshold (limiter.rs:15-33)."""
    return torch.clamp(x, -threshold, threshold)


def soft_limit(x: torch.Tensor, threshold: float = 1.0) -> torch.Tensor:
    """``tanh(x/t) * t`` with the threshold clamped to [0.001, 1.0]
    (float32 host arithmetic for a scalar threshold, as in the JAX package)."""
    t = np.clip(np.float32(threshold), np.float32(0.001), np.float32(1.0))
    return torch.tanh(x * float(np.float32(1.0) / t)) * float(t)
