"""Pink noise: counter-based white source + Paul Kellet economy filter
(port of libgooey_tpu/ops/noise.py:25-100).

Three parallel one-poles with sample-rate-rescaled poles (``p^(44100/sr)``)
and variance-preserving gains, plus a direct white term; output gain 0.11
(src/gen/pink_noise.rs).  The filter runs through the ``pink_bank`` kernel
on CUDA and its plain version on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libgooey_tpu_torch.core import rng
from libgooey_tpu_torch.ops import bank_kernels

REFERENCE_SAMPLE_RATE = 44_100.0
REFERENCE_POLES = np.array([0.99765, 0.96300, 0.57000], np.float32)
REFERENCE_GAINS = np.array([0.0990460, 0.2965164, 1.0526913], np.float32)
DIRECT_GAIN = 0.1848
OUTPUT_GAIN = 0.11


def coefficients(sample_rate: float):
    """Sample-rate-adjusted (poles, gains) as float32 numpy — pink_noise.rs:26-46."""
    rate_ratio = REFERENCE_SAMPLE_RATE / max(sample_rate, 1.0)
    poles = REFERENCE_POLES**rate_ratio
    gains = REFERENCE_GAINS * np.sqrt(
        (1.0 - poles * poles) / (1.0 - REFERENCE_POLES * REFERENCE_POLES)
    )
    return poles.astype(np.float32), gains.astype(np.float32)


class PinkState(NamedTuple):
    """Per-voice filter state, shape ``[V, 3]``."""

    fstate: torch.Tensor

    @staticmethod
    def init(shape, device) -> "PinkState":
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        return PinkState(fstate=torch.zeros(shape + (3,), dtype=torch.float32, device=device))


def pink_block(state: PinkState, counters, sample_rate: float,
               seed=rng.DEFAULT_SEED, reset=None):
    """Generate a block of pink noise.

    ``counters``: integer samples-since-trigger ``[V, B]`` (drives the white
    source); ``reset``: optional bool ``[V, B]`` mask zeroing the filter
    state at trigger offsets (kick.rs:1082-1085).
    Returns ``(new_state, pink[V, B])``."""
    poles, gains = coefficients(sample_rate)
    w = rng.white(counters.to(torch.int32), seed)
    if reset is not None:
        reset = reset.contiguous()
    pink, fstate = bank_kernels.pink_bank(
        w.contiguous(), reset, state.fstate.contiguous(),
        poles=tuple(float(p) for p in poles),
        gains=tuple(float(g) for g in gains),
        direct=float(DIRECT_GAIN), outg=float(OUTPUT_GAIN))
    return PinkState(fstate=fstate), pink
