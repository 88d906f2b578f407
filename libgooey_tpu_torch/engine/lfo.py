"""LFO pool and modulation routes (port of libgooey_tpu/engine/lfo.py).

Behavioral reference: src/engine/lfo.rs and the FFI route table (8 LFOs x 16
routes, src/ffi.rs:33-67, applied per sample at ffi.rs:1237-1250).

An LFO is a sine of a free-running phase — use-then-advance — whose value
``offset + sin(2*pi*phase)*amount`` modulates smoothed parameter *targets*
through ``set_bipolar`` (value*depth clipped to +-1 -> a normalized 0-1
target).  The smoothers then chase those per-sample targets at their usual
15 ms.

The host tracks each LFO's phase in float64; the device gets
``phase0 + n*inc`` per block and evaluates the sine trajectory over the
block.  A routed parameter's closed-form smoother trajectory is replaced by
a one-pole scan toward the LFO-driven targets (``VoiceBlock`` overrides).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

#: LFO_TIMING_* constants (lfo.rs:46-60): beats per cycle.
DIVISION_BEATS = (16.0, 8.0, 4.0, 2.0, 1.0, 0.5, 0.25, 0.125)


@dataclass
class LfoConfig:
    """Host-side LFO settings (one of 8 in the FFI pool)."""

    frequency_hz: Optional[float] = None   # None -> BPM-synced
    division: int = 4                      # LFO_TIMING_QUARTER
    bpm: float = 120.0
    amount: float = 1.0
    offset: float = 0.0
    enabled: bool = True
    phase: float = 0.0                     # advanced by the host per block

    def freq(self) -> float:
        if self.frequency_hz is not None:
            return self.frequency_hz
        return (self.bpm / 60.0) / DIVISION_BEATS[self.division]

    def advance(self, samples: int, sample_rate: float) -> float:
        """Return the block-start phase and advance by ``samples`` (float64,
        reduced mod 1 before any float32 cast)."""
        p0 = self.phase
        self.phase = (self.phase + samples * self.freq() / sample_rate) % 1.0
        return p0


@dataclass(frozen=True)
class LfoRoute:
    """One modulation route: LFO i -> (instrument name, parameter, depth)."""

    lfo: int
    instrument: str
    parameter: str
    depth: float = 1.0


def lfo_value_traj(phase0, inc, amount, offset, block: int) -> torch.Tensor:
    """``[..., B]`` LFO output trajectories (use-then-advance: the value at n
    uses ``phase0 + n*inc``, lfo.rs:170-185); the arguments are float32
    tensors of one shape (one entry per LFO)."""
    n = torch.arange(block, dtype=torch.float32, device=phase0.device)
    return offset[..., None] + torch.sin(
        float(2.0 * np.pi) * (phase0[..., None] + n * inc[..., None])) * amount[..., None]


def bipolar_to_target(value, lo=0.0, hi=1.0):
    """SmoothedParam::set_bipolar: clip +-1 -> normalized target
    (smoother.rs:112-115)."""
    norm = (torch.clamp(value, -1.0, 1.0) + 1.0) * 0.5
    return lo + norm * (hi - lo)
