"""LowpassFilterEffect: Moog-style two-pole LP with tanh'd resonance feedback
(port of libgooey_tpu/effects/lowpass.py:22-112).

Behavioral reference: src/effects/lowpass_filter.rs.

    g = clamp(1 - e^(-2pi*fc/fs), 0, 0.9)        fc capped at 0.40*sr
    res_eff = res * (1 - min(fc/5000, 1)^2 * 0.7)
    fb = res_eff * 3.5
    in' = x - tanh(stage2*fb) * min(fb, 1)
    stage1 += g*(in' - stage1); stage2 += g*(stage1 - stage2)
    out = tanh(stage2)

The tanh inside the feedback loop makes this a nonlinear recurrence: the
coefficients are computed here, the loop runs in the ``lowpass_block``
kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libgooey_tpu_torch.core.smoother import (
    SmootherBank,
    broadcast_targets,
    pow_table,
    settle_snap,
    smoothing_coeff,
)
from libgooey_tpu_torch.ops import bus_kernels

P_CUTOFF, P_RES = range(2)
CUTOFF_RANGE = (20.0, 20000.0)


class LowpassState(NamedTuple):
    stages: torch.Tensor   # [2, 2] (stage1, stage2) per channel
    smooth: SmootherBank   # [2, 2]


def init_state(sample_rate: float, cutoff=8000.0, resonance=0.2, *,
               device) -> LowpassState:
    vals = np.array(
        [[np.clip(cutoff, *CUTOFF_RANGE), np.clip(resonance, 0.0, 0.95)]] * 2, np.float32)
    return LowpassState(stages=torch.zeros((2, 2), dtype=torch.float32, device=device),
                        smooth=SmootherBank.init(vals, device))


def prepare(state: LowpassState, targets, *, sample_rate: float, block_size: int, device):
    """The block's kernel phase and ``finish(outputs) -> new_state``
    (lowpass.py:62-112, as pallas_chain._lowpass_phases repeats it)."""
    coeff = smoothing_coeff(sample_rate, 30.0)
    cur = state.smooth.current
    tgt = broadcast_targets(targets, (2, 2), device)
    powers = pow_table(float(np.float32(1.0 - coeff)), block_size, device)

    def traj(idx):
        return tgt[:, idx, None] + settle_snap((cur[:, idx] - tgt[:, idx])[:, None] * powers)

    cut_traj = traj(P_CUTOFF)
    cutoff = torch.clamp(cut_traj, max=sample_rate * 0.40)
    res = traj(P_RES)
    g = torch.clamp(1.0 - torch.exp(-2.0 * np.pi * cutoff / sample_rate), 0.0, 0.90)
    freq_ratio = torch.clamp(cutoff / 5000.0, max=1.0)
    res_eff = res * (1.0 - freq_ratio * freq_ratio * 0.7)
    fb = res_eff * 3.5
    phase = bus_kernels.Phase("lowpass_block", (g, fb, state.stages.contiguous()), {})

    def finish(outputs):
        (stages,) = outputs
        return LowpassState(
            stages=stages,
            smooth=SmootherBank(current=torch.stack([cut_traj[:, -1], res[:, -1]], dim=-1),
                                target=tgt),
        )

    return phase, finish


def process_block(state: LowpassState, x, targets, *, sample_rate: float):
    """One block of the stereo resonant LP -> ``(new_state, out[2, B])``."""
    x = torch.where(torch.isfinite(x), x, 0.0)
    phase, finish = prepare(state, targets, sample_rate=sample_rate, block_size=x.shape[-1],
                            device=x.device)
    out, outputs = bus_kernels.run_phase(x.contiguous(), phase)
    return finish(outputs), out
