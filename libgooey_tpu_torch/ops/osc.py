"""Time-based oscillators over ``[V, B]`` blocks (port of libgooey_tpu/ops/osc.py).

Each waveform is a pure function of ``(sample_index_since_trigger, freq[n])``
(src/gen/oscillator.rs:242-255): no phase integration.
"""

from __future__ import annotations

import numpy as np
import torch

from libgooey_tpu_torch.core import rng

TWO_PI = float(2.0 * np.pi)


def sine(sample_index, freq, sample_rate):
    """``sin(idx * f * 2pi / sr)`` — src/gen/oscillator.rs:41-45."""
    return torch.sin(sample_index * freq * (TWO_PI / sample_rate))


def noise(sample_index, seed=rng.DEFAULT_SEED):
    """Hash-of-sample-index noise (src/gen/oscillator.rs:187-196)."""
    return rng.white_from_sample_index(torch.floor(sample_index).to(torch.int32), seed)


def triangle_additive(sample_index, freq, sample_rate, max_harmonics: int):
    """The reference's band-limited "triangle": an additive odd-harmonic sum
    with a quadratic Gibbs taper over the top 25% of the band and harmonics
    capped at Nyquist (oscillator.rs:106-131), via the Chebyshev recurrence
    ``sin((i+2)t) = 2cos(2t) sin(it) - sin((i-2)t)``.

    This is the plain version and runs on the CPU only.  Its kernel,
    ``triangle_additive_bank``, is not ported yet, so a CUDA tensor raises
    (the kick slice runs ``max_harmonics=0`` and never calls this)."""
    if sample_index.device.type != "cpu":
        from libgooey_tpu_torch import not_ported

        raise not_ported("osc.triangle_additive on CUDA (kernel triangle_additive_bank)")
    theta = sample_index * freq * (TWO_PI / sample_rate)
    nyquist = sample_rate / 2.0
    sin1 = torch.sin(theta)
    cos2x2 = 2.0 * torch.cos(2.0 * theta)
    max_i = torch.floor(nyquist / torch.clamp(freq, min=1e-6))
    prev, curr, acc = -sin1, sin1, torch.zeros_like(sin1)
    for k in range((max_harmonics + 1) // 2):
        i = 2.0 * k + 1.0
        hfreq = freq * i
        ratio = hfreq / nyquist
        t = (ratio - 0.75) * 4.0
        taper = torch.where(ratio > 0.75, 1.0 - t * t, 1.0)
        gain = taper / (i * i)
        active = (i <= max_i) & (hfreq <= nyquist)
        acc = acc + torch.where(active, gain * curr, 0.0)
        prev, curr = curr, cos2x2 * curr - prev
    return acc
