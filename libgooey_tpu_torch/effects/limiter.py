"""The master soft limiter (port of libgooey_tpu/effects/limiter.py:20-26).

``tanh(x/t)*t`` (src/effects/limiter.rs:66-77), pinned last on the bus.
"""

from __future__ import annotations

import numpy as np
import torch


def soft_limit(x: torch.Tensor, threshold: float = 1.0) -> torch.Tensor:
    """``tanh(x/t) * t`` with the threshold clamped to [0.001, 1.0]
    (float32 host arithmetic for a scalar threshold, as in the JAX package)."""
    t = np.clip(np.float32(threshold), np.float32(0.001), np.float32(1.0))
    return torch.tanh(x * float(np.float32(1.0) / t)) * float(t)
