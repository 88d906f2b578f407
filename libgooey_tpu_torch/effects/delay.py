"""BPM-synced filter delay with ping-pong mode
(port of libgooey_tpu/effects/delay.py:34-199).

Behavioral reference: src/effects/delay.rs.

* timing: 9 musical divisions incl. triplets -> seconds at the current BPM,
  capped at 5 s;
* fractional circular-buffer read with linear interpolation; the delayed
  signal passes a two-pole resonant low-pass (fixed res 0.3) that sits in
  both the wet output and the feedback path, so echoes darken;
* write = inject + feedback * filtered tap;
* ping-pong: the left buffer is fed dry input + the right tap, the right
  buffer only the left tap;
* smoothing: 50 ms (time), 30 ms (feedback/mix/cutoff).

Per block: the time trajectory and the ring gather here, then the
``delay_block`` kernel (filter, write, mix), then the ring scatter.  The
delay time is at least one block at musical tempos, so a block's reads see
only earlier writes.
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
from libgooey_tpu_torch.ops import bus_kernels, ringbuf

MAX_DELAY_TIME = 5.0
FILTER_RESONANCE = 0.3

#: DELAY_TIMING_* constants (delay.rs:71-100): beats per division.
TIMING_BEATS = (4.0, 2.0, 1.0, 0.5, 0.25, 4.0 / 3.0, 2.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
TIMING_WHOLE, TIMING_HALF, TIMING_QUARTER, TIMING_EIGHTH, TIMING_SIXTEENTH = range(5)
TIMING_HALF_TRIPLET, TIMING_QUARTER_TRIPLET, TIMING_EIGHTH_TRIPLET = 5, 6, 7
TIMING_SIXTEENTH_TRIPLET = 8

PARAM_TIME, PARAM_FEEDBACK, PARAM_MIX, PARAM_CUTOFF = range(4)


def timing_to_seconds(timing: int, bpm: float) -> float:
    return min(60.0 / bpm * TIMING_BEATS[timing], MAX_DELAY_TIME)


class DelayState(NamedTuple):
    """Stereo delay state (channel axis leading on per-channel fields)."""

    ring: ringbuf.Ring          # buf [2, L]
    filter_z: torch.Tensor      # [2, 2] two-pole LP state (z1, z2)
    smooth: SmootherBank        # [2, 4]: time, feedback, mix, cutoff


def ring_length(sample_rate: float) -> int:
    """5 s of samples, rounded up to a multiple of 512 (delay.py:68)."""
    return (int(sample_rate * MAX_DELAY_TIME) + 1 + 511) // 512 * 512


def init_state(sample_rate: float, time_s: float = 0.5, feedback: float = 0.3,
               mix: float = 0.3, cutoff: float = 8000.0, *, device) -> DelayState:
    vals = np.array([
        [min(time_s, MAX_DELAY_TIME), np.clip(feedback, 0, 0.95),
         np.clip(mix, 0, 1), np.clip(cutoff, 20.0, 20000.0)],
    ] * 2, np.float32)
    return DelayState(
        ring=ringbuf.Ring.init(ring_length(sample_rate), batch=(2,), device=device),
        filter_z=torch.zeros((2, 2), dtype=torch.float32, device=device),
        smooth=SmootherBank.init(vals, device),
    )


def smoothing_coeffs(sample_rate: float):
    """(time 50 ms, others 30 ms) one-pole coefficients (delay.rs:203-213)."""
    return smoothing_coeff(sample_rate, 50.0), smoothing_coeff(sample_rate, 30.0)


def prepare(state: DelayState, targets, *, sample_rate: float, block_size: int, device,
            pingpong: bool = False):
    """The block's kernel phase and ``finish(outputs) -> new_state``: the
    time trajectory and the ring gather before the kernel, the ring scatter
    after it (delay.py:105-143, as pallas_chain._delay_phases repeats it).
    ``targets``: [4] staged time_s, feedback, mix, cutoff."""
    c_time, c_other = smoothing_coeffs(sample_rate)
    cur = state.smooth.current
    tgt = broadcast_targets(targets, (2, 4), device)
    pw_time = pow_table(float(np.float32(1.0 - c_time)), block_size, device)
    time_traj = tgt[:, PARAM_TIME, None] + settle_snap(
        (cur[:, PARAM_TIME] - tgt[:, PARAM_TIME])[:, None] * pw_time)   # [2, B] seconds

    delayed = ringbuf.read_frac(state.ring, time_traj * sample_rate, min_offset=1.0)
    phase = bus_kernels.Phase(
        "delay_block",
        (delayed, cur[:, 1:4].contiguous(), tgt[:, 1:4].contiguous(),
         state.filter_z.contiguous()),
        dict(coeff=c_other, sample_rate=sample_rate, pingpong=pingpong))

    def finish(outputs):
        write, nst = outputs
        return DelayState(
            ring=ringbuf.write_block(state.ring, write),
            filter_z=nst[:, 0:2],
            smooth=SmootherBank(current=torch.cat([time_traj[:, -1:], nst[:, 2:5]], dim=-1),
                                target=tgt),
        )

    return phase, finish


def process_block(state: DelayState, x, targets, *, sample_rate: float,
                  pingpong: bool = False):
    """One block of the stereo delay -> ``(new_state, out[2, B])``.
    ``targets``: [4] staged time_s, feedback, mix, cutoff."""
    x = torch.where(torch.isfinite(x), x, 0.0)
    phase, finish = prepare(state, targets, sample_rate=sample_rate, block_size=x.shape[-1],
                            device=x.device, pingpong=pingpong)
    out, outputs = bus_kernels.run_phase(x.contiguous(), phase)
    return finish(outputs), out


def reset(state: DelayState) -> DelayState:
    """Clear the buffer and the filter (timing change / explicit reset,
    delay.rs:229-245)."""
    buf = state.ring.buf
    return DelayState(
        ring=ringbuf.Ring.init(buf.shape[-1], batch=(2,), device=buf.device),
        filter_z=torch.zeros_like(state.filter_z),
        smooth=state.smooth,
    )
