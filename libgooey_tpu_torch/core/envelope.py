"""Time-based ADSR envelopes (port of libgooey_tpu/core/envelope.py).

Amplitude is a closed-form function of seconds-since-trigger
(src/envelope.rs:154-210), evaluated over the whole ``[V, B]`` block.
"Linear" is the power curve with exponent 1.0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ADSR(NamedTuple):
    """ADSR configuration as broadcastable tensors (or Python floats)."""

    attack: torch.Tensor
    decay: torch.Tensor
    sustain: torch.Tensor
    release: torch.Tensor
    attack_curve: torch.Tensor  # power-curve exponent, 1.0 == linear
    decay_curve: torch.Tensor


def adsr(attack, decay, sustain, release, attack_curve=1.0, decay_curve=1.0, *,
         device=None) -> ADSR:
    """An :class:`ADSR` of float32 tensors with the reference's 1 ms minimums
    (src/envelope.rs:34-38) and the sustain clamped to [0, 1]; on
    ``device`` (None: a tensor's own device, else the CPU)."""
    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    return ADSR(attack=torch.clamp(f32(attack), min=0.001),
                decay=torch.clamp(f32(decay), min=0.001),
                sustain=torch.clamp(f32(sustain), 0.0, 1.0),
                release=torch.clamp(f32(release), min=0.001),
                attack_curve=f32(attack_curve), decay_curve=f32(decay_curve))


def apply_curve(progress: torch.Tensor, c) -> torch.Tensor:
    """EnvelopeCurve::apply — ``progress ** clamp(c, 0.1, 10)``."""
    if isinstance(c, torch.Tensor):
        c = torch.clamp(c, 0.1, 10.0)
    else:
        c = float(np.clip(np.float32(c), np.float32(0.1), np.float32(10.0)))
    return torch.pow(torch.clamp(progress, min=0.0), c)


def amplitude(env: ADSR, elapsed: torch.Tensor, release_elapsed=None) -> torch.Tensor:
    """Envelope amplitude for ``elapsed`` seconds since trigger.  Negative
    elapsed yields 0.

    ``release_elapsed``: seconds since a manual release, or None for the
    un-released path (the drum path: a sustain-0 envelope is 0 after attack
    + decay).  Where it is positive, the amplitude is the held value at
    ``elapsed - release_elapsed`` ramped linearly to 0 over ``release``
    seconds (src/envelope.rs:163-189)."""
    a, d, s = env.attack, env.decay, env.sustain
    attack_amp = apply_curve(elapsed / a, env.attack_curve)
    decay_prog = apply_curve((elapsed - a) / d, env.decay_curve)
    decay_amp = 1.0 - (1.0 - s) * decay_prog

    in_attack = elapsed < a
    in_decay = elapsed < a + d
    held = torch.where(in_attack, attack_amp, torch.where(in_decay, decay_amp, s))
    held = torch.where(elapsed >= 0.0, held, 0.0)
    if release_elapsed is None:
        return held
    pre = amplitude(env, elapsed - release_elapsed)
    released = pre * torch.clamp(1.0 - release_elapsed / env.release, min=0.0)
    return torch.where(release_elapsed > 0.0, released, held)


def drum_active(env: ADSR, elapsed: torch.Tensor) -> torch.Tensor:
    """Whether a sustain-0 envelope still has signal (attack+decay window)."""
    return (elapsed >= 0.0) & (elapsed < env.attack + env.decay)
