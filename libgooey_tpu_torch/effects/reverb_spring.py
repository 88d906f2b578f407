"""Spring reverb: series allpass chain with global damped feedback
(port of libgooey_tpu/effects/reverb_spring.py:1-205).

Behavioral reference: src/effects/reverb.rs.  Per channel:

    signal = input + fb_prev
    signal = AP_1..AP_6(signal)            (Schroeder, prime delays, gains
                                            0.70..0.58; L/R use different
                                            prime tables for decorrelation)
    damp' = signal*(1-damping) + damp*damping
    fb    = damp' * (decay^0.4 * 0.95)     (used next sample)
    out   = input*(1-mix) + signal*mix

The damping recurrence, written as in the JAX package,

    d[n] = (damping[n] + (1-damping[n])*alpha*fb_gain[n-1]) * d[n-1]
         + (1-damping[n]) * (alpha*xeff[n] + beta[n])

(alpha = prod(gains), beta the allpass chain's offset from its delayed
reads) takes its coefficient rows ``A``, ``p2`` and ``fbgp`` from the
smoothed parameters here; the ``spring_block`` kernel steps it with the
allpasses, the feedback carry and the mix.  ``prepare`` gives that kernel's
phase, also for a run of effects in one launch (``effects/chain.py``).

State layout (kept from the JAX package, whose interop compares it by name):
the 12 allpass delay lines are rows of one right-aligned history matrix
``hist[12, D]`` (D = the longest lag); row i's last d_i columns hold its most
recent d_i values.
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

NUM_ALLPASSES = bus_kernels.SPRING_APS
DELAYS_44100_L = (131, 251, 389, 521, 617, 787)
DELAYS_44100_R = (127, 263, 397, 541, 631, 797)
GAINS = (0.70, 0.68, 0.65, 0.62, 0.60, 0.58)
MAX_FEEDBACK = 0.95

PARAM_DECAY, PARAM_MIX, PARAM_DAMPING = range(3)


class SpringState(NamedTuple):
    hist: torch.Tensor     # [12, D] right-aligned delay-line histories (L then R)
    fb: torch.Tensor       # [2] feedback sample (includes its feedback gain)
    damp: torch.Tensor     # [2] damping filter state
    smooth: SmootherBank   # [2, 3]: decay, mix, damping


def delay_lengths(sample_rate: float):
    scale = sample_rate / 44100.0
    mk = lambda tbl: tuple(max(int(d * scale), 1) for d in tbl)
    return mk(DELAYS_44100_L), mk(DELAYS_44100_R)


def init_state(sample_rate: float, decay: float = 0.5, mix: float = 0.3,
               damping: float = 0.5, *, device) -> SpringState:
    dl, dr = delay_lengths(sample_rate)
    D = max(dl + dr)
    init = np.array([[np.clip(decay, 0, 1), np.clip(mix, 0, 1), np.clip(damping, 0, 1)]] * 2,
                    np.float32)
    return SpringState(
        hist=torch.zeros((2 * NUM_ALLPASSES, D), dtype=torch.float32, device=device),
        fb=torch.zeros(2, dtype=torch.float32, device=device),
        damp=torch.zeros(2, dtype=torch.float32, device=device),
        smooth=SmootherBank.init(init, device),
    )


def chunk_size(sample_rate: float, block_size: int) -> int:
    """Largest divisor of the block not exceeding the min allpass delay: the
    chunk of the JAX package's chunked formulation, within which every
    delayed read is history (the kernel steps sample by sample)."""
    min_delay = min(delay_lengths(sample_rate)[1])
    c = block_size
    while c > min_delay:
        c //= 2
    return max(c, 1)


def prepare(state: SpringState, targets, *, sample_rate: float, block_size: int, device):
    """The block's kernel phase and ``finish(outputs) -> new_state``: the
    damping loop's coefficient rows before the kernel (reverb_spring.py:
    113-148, as pallas_chain._spring_phases repeats it)."""
    B = block_size
    coeff = smoothing_coeff(sample_rate)
    cur = state.smooth.current
    tgt = broadcast_targets(targets, (2, 3), device)
    powers = pow_table(float(np.float32(1.0 - coeff)), B, device)
    # [3, 2, B]: decay, mix, damping trajectories
    traj = (tgt.t()[:, :, None] + settle_snap((cur - tgt).t()[:, :, None] * powers)).contiguous()
    decay_t, mix_t, damping_t = traj[PARAM_DECAY], traj[PARAM_MIX], traj[PARAM_DAMPING]
    fb_gain_t = torch.pow(torch.clamp(decay_t, min=0.0), 0.4) * MAX_FEEDBACK
    alpha = float(np.prod(GAINS))
    p2 = 1.0 - damping_t
    fbgp = torch.cat([torch.zeros_like(fb_gain_t[:, :1]), fb_gain_t[:, :-1]], dim=-1)
    A = damping_t + p2 * alpha * fbgp
    A[:, 0] = damping_t[:, 0]
    dl, dr = delay_lengths(sample_rate)
    phase = bus_kernels.Phase(
        "spring_block",
        (A, p2, fbgp, state.hist.contiguous(), state.damp.contiguous(), mix_t,
         state.fb.contiguous()),
        dict(delays=dl + dr, gains=GAINS))

    def finish(outputs):
        new_hist, d_last = outputs
        return SpringState(
            hist=new_hist,
            fb=fb_gain_t[:, -1] * d_last,
            damp=d_last,
            smooth=SmootherBank(current=traj[:, :, -1].t(), target=tgt),
        )

    return phase, finish


def process_block(state: SpringState, x, targets, *, sample_rate: float):
    """One block of the stereo spring reverb -> ``(new_state, out[2, B])``.
    ``targets``: [3] decay, mix, damping."""
    x = torch.where(torch.isfinite(x), x, 0.0)
    phase, finish = prepare(state, targets, sample_rate=sample_rate, block_size=x.shape[-1],
                            device=x.device)
    out, outputs = bus_kernels.run_phase(x.contiguous(), phase)
    return finish(outputs), out
