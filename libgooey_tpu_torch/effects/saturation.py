"""TubeSaturation: asymmetric atan saturation with second-harmonic warmth
(port of libgooey_tpu/effects/saturation.py:36-144).

Behavioral reference: src/effects/saturation.rs.

    driven = x * (1 + drive*7)
    biased = driven + bias*|driven|          bias = warmth*0.4
    soft   = atan(biased) * 2/pi
    sat    = soft + soft^2*sign(soft)*0.15*bias
    out    = x*(1-mix) + dc_block(sat)*mix   (bypass when mix < 1e-4)

The curve runs at 4x through the half-band chains, and the whole block (the
smoothers, the chain, the shaper, the DC blocker and the mix) is one
``saturation_block`` kernel, as the JAX package's Pallas branch is
(``prepare`` gives that kernel's phase, also for a run of effects in one
launch: ``effects/chain.py``).  Its smoother currents are the
trajectories' last values.  When the mix stays
under the bypass gate all block, the oversampler history is held (the
reference's early return, block-granular).  Only ``os_mode=4`` is ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libgooey_tpu_torch import not_ported
from libgooey_tpu_torch.core.smoother import SmootherBank, broadcast_targets, smoothing_coeff
from libgooey_tpu_torch.effects import freeze
from libgooey_tpu_torch.ops import bus_kernels
from libgooey_tpu_torch.ops.filters import DCBlockState
from libgooey_tpu_torch.ops.oversample import OversamplerState

PARAMS = ("drive", "warmth", "mix")
P_DRIVE, P_WARMTH, P_MIX = range(3)


class SaturationState(NamedTuple):
    dc: DCBlockState          # [2]
    smooth: SmootherBank      # [2, 3]
    ovs: OversamplerState     # [2, ...]


def init_state(sample_rate: float, drive=0.3, warmth=0.3, mix=1.0, *,
               device) -> SaturationState:
    vals = np.array([[np.clip(drive, 0, 1), np.clip(warmth, 0, 1),
                      np.clip(mix, 0, 1)]] * 2, np.float32)
    return SaturationState(dc=DCBlockState.init((2,), device),
                           smooth=SmootherBank.init(vals, device),
                           ovs=OversamplerState.init(2, device))


def prepare(state: SaturationState, targets, *, sample_rate: float, block_size: int, device):
    """The block's kernel phase and ``finish(outputs) -> new_state``: the
    glue of the JAX package's Pallas branch (saturation.py:83-100, as
    pallas_chain._saturation_phases repeats it)."""
    coeff = smoothing_coeff(sample_rate, 30.0)
    cur = state.smooth.current
    tgt = broadcast_targets(targets, (2, 3), device)
    held = freeze.traj_all_below(cur[:, P_MIX], tgt[:, P_MIX], float(np.float32(1.0 - coeff)),
                                 block_size, 1e-4)
    phase = bus_kernels.Phase(
        "saturation_block",
        (cur.contiguous(), tgt, bus_kernels.pack_saturation(state.ovs, state.dc)),
        dict(coeff=coeff))

    def finish(outputs):
        (nst,) = outputs
        new_ovs, dc_x1, dc_y1, sm_cur = bus_kernels.unpack_saturation(nst, state.ovs)
        return SaturationState(
            dc=DCBlockState(x1=dc_x1, y1=dc_y1),
            smooth=SmootherBank(current=sm_cur, target=tgt),
            ovs=freeze.hold_where(held, state.ovs, new_ovs),
        )

    return phase, finish


def process_block(state: SaturationState, x, targets, *, sample_rate: float,
                  os_mode: int = 4):
    """One block of the stereo saturator -> ``(new_state, out[2, B])``."""
    if os_mode != 4:
        raise not_ported(f"saturation at os_mode={os_mode}")
    x = torch.where(torch.isfinite(x), x, 0.0)
    phase, finish = prepare(state, targets, sample_rate=sample_rate, block_size=x.shape[-1],
                            device=x.device)
    out, outputs = bus_kernels.run_phase(x.contiguous(), phase)
    return finish(outputs), out
