"""TubeCompressor: peak-detector compressor with soft knee and tube colouring
(port of libgooey_tpu/effects/compressor.py:1-203).

Behavioral reference: src/effects/compressor.rs.

* peak envelope follower with attack/release ballistics
  (coeff = e^(-1/(ms*sr)), attack 0.1-100 ms, release 5-1000 ms);
* log-domain gain with a 6 dB quadratic soft knee; ratio 1-20,
  threshold -60..0 dB;
* one-pole gain smoothing (0.05);
* atan tube colouring (x*2/pi*1.1) engaged when gain < 0.99 but always fed
  to keep the oversampler history warm; DC blocker (0.995); dry/wet mix;
* external sidechain: the detector tracks ``sidechain`` while the gain
  applies to the input (compressor.rs:230-247).

Per block: the five parameter trajectories and the detector's coefficients
here, then two kernels, as the JAX package's Pallas branch runs them
(compressor.py:123-146): ``env_follower_block`` on the detector input and
``compressor_block`` on the input and the envelope.  ``prepare`` gives the
two as phases, also for a run of effects in one launch (``effects/chain.py``),
where the detector reads the signal as it stands at that point.  Unlike the
saturation's, the oversampler history is not held on bypass.

At ``os_mode`` 1 and 2 the block runs as the JAX package's XLA path
(compressor.py:146-200): the same detector in ``env_follower_block`` (the
step of its ``nonlinear_scan``), the knee in PyTorch, the gain smoother and
the DC blocker as ``scan.linrec1`` calls, the colour through
``ops/oversample.process``.
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
from libgooey_tpu_torch.ops import oversample as ovs_mod
from libgooey_tpu_torch.ops import scan as gscan
from libgooey_tpu_torch.ops.filters import DCBlockState, _shift1
from libgooey_tpu_torch.ops.oversample import OversamplerState

KNEE_DB = 6.0
HALF_KNEE_DB = 3.0
FRAC_2_PI = float(2.0 / np.pi)

PARAMS = ("threshold_db", "ratio", "attack_ms", "release_ms", "mix")
P_THRESH, P_RATIO, P_ATTACK, P_RELEASE, P_MIX = range(5)
RANGES = ((-60.0, 0.0), (1.0, 20.0), (0.1, 100.0), (5.0, 1000.0), (0.0, 1.0))


class CompressorState(NamedTuple):
    envelope: torch.Tensor      # [2]
    gain: torch.Tensor          # [2] smoothed gain (init 1)
    dc: DCBlockState            # [2]
    smooth: SmootherBank        # [2, 5]
    ovs: OversamplerState       # [2, ...] tube-colouring oversampler


def init_state(sample_rate: float, threshold_db=-20.0, ratio=4.0, attack_ms=10.0,
               release_ms=100.0, mix=1.0, *, device) -> CompressorState:
    vals = np.array([[np.clip(v, *r) for v, r in zip(
        (threshold_db, ratio, attack_ms, release_ms, mix), RANGES)]] * 2, np.float32)
    return CompressorState(
        envelope=torch.zeros(2, dtype=torch.float32, device=device),
        gain=torch.ones(2, dtype=torch.float32, device=device),
        dc=DCBlockState.init((2,), device),
        smooth=SmootherBank.init(vals, device),
        ovs=OversamplerState.init(2, device),
    )


def gain_reduction_db(over_db, ratio):
    """6 dB quadratic soft knee (compressor.rs:101-116)."""
    slope = 1.0 - 1.0 / ratio
    kv = over_db + HALF_KNEE_DB
    knee = kv * kv / torch.full_like(kv, 2.0 * KNEE_DB) * slope
    return torch.where(over_db <= -HALF_KNEE_DB, 0.0,
                       torch.where(over_db >= HALF_KNEE_DB, over_db * slope, knee))


def _trajectories(state: CompressorState, targets, sample_rate: float, block_size: int,
                  device):
    """``(targets [2, 5], trajectories [5, 2, B], detector coefficients
    [2, 2, B] (attack, release), bypass as float [2, B])``."""
    coeff = smoothing_coeff(sample_rate, 30.0)
    cur = state.smooth.current
    tgt = broadcast_targets(targets, (2, 5), device)
    powers = pow_table(float(np.float32(1.0 - coeff)), block_size, device)
    # [5, 2, B]: threshold, ratio, attack, release, mix trajectories
    traj = (tgt.t()[:, :, None] + settle_snap((cur - tgt).t()[:, :, None] * powers)).contiguous()
    coefs = torch.exp(-1.0 / (traj[P_ATTACK:P_RELEASE + 1] * 0.001 * sample_rate))
    byp = (traj[P_MIX] < 1e-4).to(torch.float32)
    return tgt, traj, coefs, byp


def prepare(state: CompressorState, targets, *, sample_rate: float, block_size: int, device):
    """The block's two kernel phases, detector then gain stage, and
    ``finish([detector outputs, gain-stage outputs]) -> new_state``
    (compressor.py:100-146, as pallas_chain._compressor_phases repeats it).
    The gain stage's ``env`` is ``None``: the detector's output before it."""
    tgt, traj, coefs, byp = _trajectories(state, targets, sample_rate, block_size, device)
    mix = traj[P_MIX]
    env_phase = bus_kernels.Phase(
        "env_follower_block", (coefs[0], coefs[1], byp, state.envelope.contiguous()), {})
    comp_phase = bus_kernels.Phase(
        "compressor_block",
        (None, traj[P_THRESH], traj[P_RATIO], mix,
         bus_kernels.pack_compressor(state.ovs, state.dc, state.gain)), {})

    def finish(outputs):
        (_env, env_last), (nst,) = outputs
        new_ovs, dc_x1, dc_y1, gain = bus_kernels.unpack_compressor(nst, state.ovs)
        return CompressorState(
            envelope=env_last,
            gain=gain,
            dc=DCBlockState(x1=dc_x1, y1=dc_y1),
            smooth=SmootherBank(current=traj[:, :, -1].t(), target=tgt),
            ovs=new_ovs,
        )

    return [env_phase, comp_phase], finish


def process_block(state: CompressorState, x, targets, *, sample_rate: float,
                  sidechain=None, os_mode: int = 4):
    """One block of the stereo compressor -> ``(new_state, out[2, B])``.
    ``sidechain``: optional [2, B] detector source."""
    x = torch.where(torch.isfinite(x), x, 0.0).contiguous()
    sc = x if sidechain is None else torch.where(torch.isfinite(sidechain), sidechain, 0.0)
    if os_mode != 4:
        return _process_scans(state, x, sc, targets, sample_rate, os_mode)
    (env_phase, comp_phase), finish = prepare(state, targets, sample_rate=sample_rate,
                                              block_size=x.shape[-1], device=x.device)
    _, env_out = bus_kernels.run_phase(sc.contiguous(), env_phase)
    comp_phase = comp_phase._replace(args=(env_out[0],) + comp_phase.args[1:])
    out, comp_out = bus_kernels.run_phase(x, comp_phase)
    return finish([env_out, comp_out]), out


def _process_scans(state: CompressorState, x, sc, targets, sample_rate: float, os_mode: int):
    """The block at ``os_mode`` 1 or 2 (compressor.py:146-200)."""
    tgt, traj, coefs, byp = _trajectories(state, targets, sample_rate, x.shape[-1], x.device)
    thr, ratio, mix = traj[P_THRESH], traj[P_RATIO], traj[P_MIX]
    bypass = mix < 1e-4
    env, env_last = bus_kernels.env_follower_block(
        sc.contiguous(), coefs[0], coefs[1], byp, state.envelope.contiguous())

    env_db = 20.0 * torch.log10(env + 1e-20)
    gr_db = gain_reduction_db(env_db - thr, ratio)
    gain_lin = torch.pow(10.0, -gr_db * 0.05)
    # gain smoothing: g += 0.05*(target - g), frozen on bypass
    gain = gscan.linrec1(torch.where(bypass, 1.0, 0.95),
                         torch.where(bypass, 0.0, 0.05 * gain_lin), state.gain)
    compressed = x * gain

    def color_fn(v):
        return torch.atan(v) * (FRAC_2_PI * 1.1)

    # always fed so the half-band history stays warm (compressor.rs:197-199)
    new_ovs, colored_os = ovs_mod.process(state.ovs, color_fn, compressed, os_mode)
    colored = torch.where(gain < 0.99, colored_os, compressed)
    # DC blocker frozen on bypass
    x1 = gscan.linrec1(torch.where(bypass, 1.0, 0.0), torch.where(bypass, 0.0, colored),
                       state.dc.x1)
    x1_prev = _shift1(x1, state.dc.x1)
    y1 = gscan.linrec1(torch.where(bypass, 1.0, 0.995),
                       torch.where(bypass, 0.0, colored - x1_prev), state.dc.y1)
    out = torch.where(bypass, x, x * (1.0 - mix) + y1 * mix)
    out = torch.where(torch.isfinite(out), out, 0.0)
    return CompressorState(
        envelope=env_last,
        gain=gain[:, -1],
        dc=DCBlockState(x1=x1[:, -1], y1=y1[:, -1]),
        smooth=SmootherBank(current=traj[:, :, -1].t(), target=tgt),
        ovs=new_ovs,
    ), out
