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
reference's early return, block-granular).

At ``os_mode`` 1 and 2 the block runs as the JAX package's XLA path
(saturation.py:102-144): the settle-snapped trajectories, the curve through
``ops/oversample.process`` (its allpass sections on ``affine1_bank``) and
the bypass-frozen DC blocker as two ``scan.linrec1`` calls.
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
from libgooey_tpu_torch.effects import freeze
from libgooey_tpu_torch.ops import bus_kernels
from libgooey_tpu_torch.ops import oversample as ovs_mod
from libgooey_tpu_torch.ops import scan as gscan
from libgooey_tpu_torch.ops.filters import DCBlockState, _shift1
from libgooey_tpu_torch.ops.oversample import OversamplerState

FRAC_2_PI = float(2.0 / np.pi)

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


#: the JAX module's alias (saturation.py:49) of the oversampler's helper
repeat_to_rate = ovs_mod.repeat_to_rate


def saturate(x, drive, bias):
    """The tube transfer curve (saturation.rs:106-125)."""
    driven = x * drive
    biased = driven + bias * driven.abs()
    soft = torch.atan(biased) * FRAC_2_PI
    second = soft * soft * torch.sign(soft) * 0.15
    return soft + second * bias


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
    x = torch.where(torch.isfinite(x), x, 0.0)
    if os_mode != 4:
        return _process_scans(state, x, targets, sample_rate, os_mode)
    phase, finish = prepare(state, targets, sample_rate=sample_rate, block_size=x.shape[-1],
                            device=x.device)
    out, outputs = bus_kernels.run_phase(x.contiguous(), phase)
    return finish(outputs), out


def _process_scans(state: SaturationState, x, targets, sample_rate: float, os_mode: int):
    """The block at ``os_mode`` 1 or 2 (saturation.py:102-144)."""
    B = x.shape[-1]
    coeff = smoothing_coeff(sample_rate, 30.0)
    q = float(np.float32(1.0 - coeff))
    cur = state.smooth.current
    tgt = broadcast_targets(targets, (2, 3), x.device)
    held = freeze.traj_all_below(cur[:, P_MIX], tgt[:, P_MIX], q, B, 1e-4)
    powers = pow_table(q, B, x.device)

    def traj(idx):
        return tgt[:, idx, None] + settle_snap((cur[:, idx] - tgt[:, idx])[:, None] * powers)

    drive = 1.0 + traj(P_DRIVE) * 7.0
    bias = traj(P_WARMTH) * 0.4
    mix = traj(P_MIX)
    bypass = mix < 1e-4

    def fn(v):
        return saturate(v, ovs_mod.repeat_to_rate(drive, v, B),
                        ovs_mod.repeat_to_rate(bias, v, B))

    new_ovs, sat = ovs_mod.process(state.ovs, fn, x, os_mode)
    x1 = gscan.linrec1(torch.where(bypass, 1.0, 0.0), torch.where(bypass, 0.0, sat),
                       state.dc.x1)
    x1_prev = _shift1(x1, state.dc.x1)
    y1 = gscan.linrec1(torch.where(bypass, 1.0, 0.995),
                       torch.where(bypass, 0.0, sat - x1_prev), state.dc.y1)
    out = torch.where(bypass, x, x * (1.0 - mix) + y1 * mix)
    out = torch.where(torch.isfinite(out), out, 0.0)
    # true divisions, as the JAX package divides (a scalar divisor may be
    # taken as a reciprocal product on the card)
    d_last = drive[:, -1] - 1.0
    current = torch.stack([d_last / torch.full_like(d_last, 7.0),
                           bias[:, -1] / torch.full_like(d_last, 0.4), mix[:, -1]], dim=-1)
    return SaturationState(
        dc=DCBlockState(x1=x1[:, -1], y1=y1[:, -1]),
        smooth=SmootherBank(current=current, target=tgt),
        ovs=freeze.hold_where(held, state.ovs, new_ovs),
    ), out
