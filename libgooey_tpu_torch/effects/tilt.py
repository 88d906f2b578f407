"""TiltFilterEffect: one-knob LP<->HP sweep with center crossfade
(port of libgooey_tpu/effects/tilt.py).

Behavioral reference: src/effects/tilt_filter.rs.

* knob < 0.5: low-pass region: mix = 1-2k, freq sweeps 80 Hz -> 20 kHz log;
* knob > 0.5: high-pass region: mix = 2(k-0.5), freq sweeps 20 Hz -> 8 kHz log;
* resonance -> Q = 0.5 + res*8; TPT SVF core; out = dry*(1-mix) + tap*mix;
* passthrough when mix < 0.001 (filter state frozen).

The whole block (smoothers, frequency maps, SVF, crossfade) is the
``tilt_block`` kernel.  A block that sits in the center window from its first
sample to its last holds the SVF state (the reference's passthrough freeze,
block-granular).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libgooey_tpu_torch.core.smoother import SmootherBank, broadcast_targets, smoothing_coeff
from libgooey_tpu_torch.effects import freeze
from libgooey_tpu_torch.ops import bus_kernels, filters

LP_FREQ = (80.0, 20000.0)
HP_FREQ = (20.0, 8000.0)

P_CUTOFF, P_RES = range(2)


class TiltState(NamedTuple):
    svf: filters.SVFState  # [2]
    smooth: SmootherBank   # [2, 2]


def init_state(sample_rate: float, cutoff=0.5, resonance=0.0, *, device) -> TiltState:
    vals = np.array([[np.clip(cutoff, 0, 1), np.clip(resonance, 0, 1)]] * 2, np.float32)
    return TiltState(svf=filters.SVFState.init((2,), device),
                     smooth=SmootherBank.init(vals, device))


def prepare(state: TiltState, targets, *, sample_rate: float, block_size: int, device):
    """The block's kernel phase and ``finish(outputs) -> new_state``
    (tilt.py:59-91, as pallas_chain._tilt_phases repeats it)."""
    coeff = smoothing_coeff(sample_rate, 30.0)
    cur = state.smooth.current
    tgt = broadcast_targets(targets, (2, 2), device)
    # passthrough <=> mix = |2k-1| < 0.001; the knob trajectory is monotone,
    # so the whole block is inside the center window iff its ends are
    ends = freeze.traj_ends(cur[:, P_CUTOFF], tgt[:, P_CUTOFF],
                            float(np.float32(1.0 - coeff)), block_size)
    held = ((2.0 * ends[0] - 1.0).abs() < 0.001) & ((2.0 * ends[1] - 1.0).abs() < 0.001)
    ic = torch.stack([state.svf.ic1, state.svf.ic2], dim=-1)
    phase = bus_kernels.Phase("tilt_block", (cur.contiguous(), tgt, ic),
                              dict(coeff=coeff, sample_rate=sample_rate))

    def finish(outputs):
        (nst,) = outputs
        return TiltState(
            svf=freeze.hold_where(held, state.svf,
                                  filters.SVFState(ic1=nst[:, 0], ic2=nst[:, 1])),
            smooth=SmootherBank(current=nst[:, 2:4], target=tgt),
        )

    return phase, finish


def process_block(state: TiltState, x, targets, *, sample_rate: float):
    """One block of the stereo tilt filter -> ``(new_state, out[2, B])``."""
    phase, finish = prepare(state, targets, sample_rate=sample_rate, block_size=x.shape[-1],
                            device=x.device)
    out, outputs = bus_kernels.run_phase(x.contiguous(), phase)
    return finish(outputs), out
