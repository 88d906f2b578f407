"""Time-based oscillators over ``[V, B]`` blocks (port of libgooey_tpu/ops/osc.py).

Each waveform is a pure function of ``(sample_index_since_trigger, freq[n])``
(src/gen/oscillator.rs:242-255): no phase integration.  The additive
triangle runs in the ``triangle_additive_bank`` kernel.  The naive
saw/square/triangle are the aliasing A/B references of the examples.
"""

from __future__ import annotations

import numpy as np
import torch

from libgooey_tpu_torch.core import rng
from libgooey_tpu_torch.ops import bank_kernels

TWO_PI = float(2.0 * np.pi)


def sine(sample_index, freq, sample_rate):
    """``sin(idx * f * 2pi / sr)`` — src/gen/oscillator.rs:41-45."""
    return torch.sin(sample_index * freq * (TWO_PI / sample_rate))


def ring_mod(sample_index, freq, mod_freq, sample_rate):
    """Carrier sine x modulator sine (src/gen/oscillator.rs:181-185)."""
    return sine(sample_index, freq, sample_rate) * sine(sample_index, mod_freq, sample_rate)


def noise(sample_index, seed=rng.DEFAULT_SEED):
    """Hash-of-sample-index noise (src/gen/oscillator.rs:187-196)."""
    return rng.white_from_sample_index(torch.floor(sample_index).to(torch.int32), seed)


def poly_blep(t, dt):
    """2-sample polynomial step correction (src/gen/polyblep.rs:8-20)."""
    dt = torch.clamp(dt, min=1e-12)
    early = t / dt
    late = (t - 1.0) / dt
    return torch.where(
        t < dt,
        2.0 * early - early * early - 1.0,
        torch.where(t > 1.0 - dt, late * late + 2.0 * late + 1.0, 0.0),
    )


def _phase(sample_index, freq, sample_rate):
    """Phase in [0,1) and per-sample increment (oscillator.rs:153-157)."""
    inc = freq / sample_rate
    return torch.remainder(sample_index * inc, 1.0), inc


def saw_blep(sample_index, freq, sample_rate):
    """Band-limited saw: naive ramp minus one blep (polyblep.rs:25-29)."""
    phase, inc = _phase(sample_index, freq, sample_rate)
    return (2.0 * phase - 1.0) - poly_blep(phase, inc)


def square_blep(sample_index, freq, sample_rate):
    """Band-limited square: bleps at both edges (polyblep.rs:34-40)."""
    phase, inc = _phase(sample_index, freq, sample_rate)
    naive = torch.where(phase < 0.5, 1.0, -1.0)
    return naive + poly_blep(phase, inc) - poly_blep(torch.remainder(phase + 0.5, 1.0), inc)


def saw_naive(sample_index, freq, sample_rate):
    """Aliasing saw for A/B comparison (oscillator.rs:169-172)."""
    phase, _ = _phase(sample_index, freq, sample_rate)
    return 2.0 * phase - 1.0


def square_naive(sample_index, freq, sample_rate):
    """Aliasing square (oscillator.rs:164-167)."""
    phase, _ = _phase(sample_index, freq, sample_rate)
    return torch.where(phase < 0.5, 1.0, -1.0)


def triangle_naive(sample_index, freq, sample_rate):
    """Aliasing /\\ triangle (oscillator.rs:174-179)."""
    phase, _ = _phase(sample_index, freq, sample_rate)
    return torch.where(phase < 0.5, 4.0 * phase - 1.0, 3.0 - 4.0 * phase)


def triangle_additive(sample_index, freq, sample_rate, max_harmonics: int):
    """The reference's band-limited "triangle": an additive odd-harmonic sum
    with a quadratic Gibbs taper over the top 25% of the band and harmonics
    capped at Nyquist (oscillator.rs:106-131), via the Chebyshev recurrence
    ``sin((i+2)t) = 2cos(2t) sin(it) - sin((i-2)t)``.

    Runs in ``bank_kernels.triangle_additive_bank`` over the broadcast
    ``[..., B]`` block with leading axes flattened into rows: the CUDA
    kernel on a CUDA tensor, its plain version on a CPU tensor."""
    idx, f = torch.broadcast_tensors(sample_index, freq)
    B = idx.shape[-1]
    out = bank_kernels.triangle_additive_bank(
        idx.reshape(-1, B).contiguous(), f.reshape(-1, B).contiguous(),
        sample_rate, max_harmonics)
    return out.reshape(idx.shape)
