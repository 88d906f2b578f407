"""Dattorro plate reverb: figure-eight tank with modulated allpasses
(port of libgooey_tpu/effects/reverb_plate.py:1-494).

Behavioral reference: src/effects/plate_reverb.rs — Jon Dattorro's "Effect
Design Part 1" plate: predelay (0-200 ms) -> input bandwidth one-pole
(0.9995) -> 4 input-diffusion allpasses -> two cross-coupled branches, each

    modulated allpass (gain 0.70, LFO 0.50/0.71 Hz, +-16-sample excursion)
    -> delay -> damping one-pole -> * decay -> allpass(dd2) -> delay -> cross-feed

with a 7-tap output matrix per channel across both branches, mid/side width,
and a size knob (0.25x-2x) rescaling all tank delays through fractional
reads.  The tank is shared: stereo input is mono-summed.

Per block, as the JAX package's XLA branch runs it: every tank lag exceeds
the block (``min_tank_lag``), so the tank is feed-forward at block level:
its six lines are rows of one ``[6, LT]`` matrix, read with one gather
before the block, written with one scatter and tapped by the output matrix
with one more, all plain PyTorch here as the delay's ring is.  The
sub-block recurrences (the bandwidth and damping one-poles, the input
diffusion and the two modulated allpasses) are the ``plate_block`` kernel
(ops/plate_kernels.py).  The JAX package's one-hot MXU gathers
(``ops/mxgather``) are a TPU workaround, bit-exact to these gathers, and are
not ported.  The plate always launches its own kernel: it does not join a
run of effects, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from libgooey_tpu_torch.core.smoother import SmootherBank, pow_table, settle_snap, smoothing_coeff
from libgooey_tpu_torch.ops import plate_kernels, ringbuf

DATTORRO_SR = 29_761.0
INPUT_AP_DELAYS = (142.0, 107.0, 379.0, 277.0)
INPUT_AP_GAINS = (0.750, 0.750, 0.625, 0.625)
TANK_AP1_A, TANK_DELAY1_A, TANK_AP2_A, TANK_DELAY2_A = 672.0, 4453.0, 1800.0, 3720.0
TANK_AP1_B, TANK_DELAY1_B, TANK_AP2_B, TANK_DELAY2_B = 908.0, 4217.0, 2656.0, 3163.0
DECAY_DIFFUSION_1 = 0.70
EXCURSION = 16.0
LFO_RATE_A, LFO_RATE_B = 0.50, 0.71
INPUT_BANDWIDTH = 0.9995
MAX_DECAY = 0.95
MAX_PREDELAY_MS = 200.0
OUTPUT_SCALE = 0.6
MAX_SIZE_SCALE = 2.0

#: tank matrix rows
T_D1A, T_D1B, T_AP2A, T_AP2B, T_D2A, T_D2B = range(6)
_TANK_BASES = (TANK_DELAY1_A, TANK_DELAY1_B, TANK_AP2_A, TANK_AP2_B,
               TANK_DELAY2_A, TANK_DELAY2_B)
_LINE_ROW = {"d1a": T_D1A, "d1b": T_D1B, "ap2a": T_AP2A, "ap2b": T_AP2B,
             "d2a": T_D2A, "d2b": T_D2B}

# left taps: (line, offset at 29761 Hz, sign)
LEFT_TAPS = (
    ("d1b", 266.0, +1.0), ("d1b", 2974.0, +1.0), ("ap2b", 1913.0, -1.0),
    ("d2b", 1996.0, +1.0), ("d1a", 1990.0, -1.0), ("ap2a", 187.0, -1.0),
    ("d2a", 1066.0, -1.0),
)
RIGHT_TAPS = (
    ("d1a", 353.0, +1.0), ("d1a", 3627.0, +1.0), ("ap2a", 1228.0, -1.0),
    ("d2a", 2673.0, +1.0), ("d1b", 2111.0, -1.0), ("ap2b", 335.0, -1.0),
    ("d2b", 121.0, -1.0),
)

PARAMS = ("decay", "mix", "damping", "predelay", "width", "size")
P_DECAY, P_MIX, P_DAMPING, P_PREDELAY, P_WIDTH, P_SIZE = range(6)


def size_to_scale(size):
    """0 -> 0.25x, 0.5 -> 1x, 1 -> 2x (plate_reverb.rs:83-90).  The powers
    are taken in float64 and rounded once, which is what XLA's float32
    ``power`` gives (PyTorch's differs by an ulp at ~2% of sizes, and an ulp
    of the scale moves the longest tank read by ~2e-3 samples)."""
    e = (2.0 * size - 1.0).double()
    return torch.where(size <= 0.5, torch.pow(4.0, e), torch.pow(2.0, e)).float()


def _srs(sample_rate: float) -> float:
    return sample_rate / DATTORRO_SR


def tank_len(sample_rate: float) -> int:
    """[6, LT] tank-matrix row length: covers the longest lag at 2x size,
    rounded to a multiple of 512."""
    need = int(np.ceil(max(_TANK_BASES) * MAX_SIZE_SCALE * _srs(sample_rate))) + 8
    return ((need + 511) // 512) * 512


def in_hist_len(sample_rate: float) -> int:
    return int(np.ceil(max(INPUT_AP_DELAYS) * _srs(sample_rate))) + 4


def mod_hist_len(sample_rate: float) -> int:
    srs = _srs(sample_rate)
    return int(np.ceil(max(TANK_AP1_A, TANK_AP1_B) * MAX_SIZE_SCALE * srs + EXCURSION * srs)) + 4


class PlateState(NamedTuple):
    predelay: ringbuf.Ring
    in_hist: torch.Tensor   # [4, DIN] input-AP histories, right-aligned
    mod_hist: torch.Tensor  # [2, DMOD] modulated-AP histories, right-aligned
    tank: torch.Tensor      # [6, LT] rows d1a, d1b, ap2a, ap2b, d2a, d2b
    pos: torch.Tensor       # [] int64: samples written to the tank, mod LT
    bandwidth: torch.Tensor
    damp_a: torch.Tensor
    damp_b: torch.Tensor
    fb_a: torch.Tensor
    fb_b: torch.Tensor
    lfo_phase: torch.Tensor  # [2]
    smooth: SmootherBank     # [6]

    #: the JAX package keeps ``pos`` as int32
    NUMPY_DTYPES = {"pos": np.int32}


def init_state(sample_rate: float, decay: float = 0.5, mix: float = 0.3,
               damping: float = 0.5, predelay: float = 0.0, width: float = 1.0,
               size: float = 0.5, *, device) -> PlateState:
    def z(shape=()):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return PlateState(
        # the JAX package's length, a multiple of 128 (its TPU reads)
        predelay=ringbuf.Ring.init(
            (int(np.ceil(MAX_PREDELAY_MS * 0.001 * sample_rate)) + 8 + 127) // 128 * 128,
            device=device),
        in_hist=z((4, in_hist_len(sample_rate))),
        mod_hist=z((2, mod_hist_len(sample_rate))),
        tank=z((6, tank_len(sample_rate))),
        pos=torch.zeros((), dtype=torch.int64, device=device),
        bandwidth=z(), damp_a=z(), damp_b=z(), fb_a=z(), fb_b=z(),
        lfo_phase=z((2,)),
        smooth=SmootherBank.init(np.clip(np.array(
            [decay, mix, damping, predelay, width, size], np.float32), 0.0, 1.0), device),
    )


def chunk_size(sample_rate: float, block_size: int) -> int:
    """The JAX package's chunk: not above the shortest chunk-processed lag
    at minimum size (the input diffusion and the modulated allpasses); the
    kernel steps sample by sample."""
    srs = _srs(sample_rate)
    min_lag = min(min(INPUT_AP_DELAYS) * srs,
                  TANK_AP1_A * 0.25 * srs - EXCURSION * srs,
                  TANK_AP1_B * 0.25 * srs - EXCURSION * srs)
    c = block_size
    while c > min_lag:
        c //= 2
    return max(c, 1)


def min_tank_lag(sample_rate: float) -> int:
    """Shortest possible block-level tank lag (ap2_a at 0.25x size)."""
    return int(min(_TANK_BASES) * 0.25 * _srs(sample_rate))


@functools.lru_cache(maxsize=None)
def _tables(sample_rate: float, LT: int, device):
    """Per-device constant columns: the six tank lines' lags and the 14
    output taps' lags at 1x size (float32 from float64, as the JAX package's
    ``off * srs * size_t`` rounds them), the taps' flat row offsets and
    signs."""
    srs = _srs(sample_rate)
    taps = LEFT_TAPS + RIGHT_TAPS

    def col(values, dtype=torch.float32):
        return torch.as_tensor(np.asarray(values)[:, None], dtype=dtype, device=device)

    return (col([b * srs for b in _TANK_BASES]), col([off * srs for _, off, _ in taps]),
            col([_LINE_ROW[ln] * LT for ln, _, _ in taps], torch.int64),
            col([sg for _, _, sg in taps]))


def _tank_read(tank, pos, offs):
    """Pre-write fractional read of all 6 tank rows at once: offs [6, B]
    samples ago, clamped to [1, LT-2]; one gather for both lerp endpoints."""
    LT = tank.shape[-1]
    B = offs.shape[-1]
    offs = torch.clamp(offs, 1.0, LT - 2.0)
    whole = torch.floor(offs)
    frac = offs - whole
    base = pos + torch.arange(B, device=offs.device) - whole.to(torch.int64)
    idx = torch.cat([torch.remainder(base, LT), torch.remainder(base - 1, LT)], dim=-1)
    ab = torch.gather(tank, -1, idx)
    a, b = ab[:, :B], ab[:, B:]
    return a + frac * (b - a)


def _tank_taps(tank, pos_after, offs, row_base, n_written):
    """Post-write fractional taps: offs [14, B] from the rows whose flat
    offsets are ``row_base`` [14, 1]; one flat gather for all of them."""
    LT = tank.shape[-1]
    B = offs.shape[-1]
    offs = torch.clamp(offs, 0.0, LT - 2.0)
    whole = torch.floor(offs)
    frac = offs - whole
    base = (pos_after - n_written + torch.arange(B, device=offs.device)
            - whole.to(torch.int64))
    idx = torch.cat([row_base + torch.remainder(base, LT),
                     row_base + torch.remainder(base - 1, LT)], dim=-1)
    ab = torch.take(tank, idx)
    a, b = ab[:, :B], ab[:, B:]
    return a + frac * (b - a)


def _tank_write(tank, pos, vals):
    """Append vals [6, B] at ``pos`` (a copy, as ``ringbuf.write_block``)."""
    LT = tank.shape[-1]
    idx = torch.remainder(pos + torch.arange(vals.shape[-1], device=vals.device), LT)
    return tank.index_copy(1, idx, vals)


def process_block(state: PlateState, x, targets, *, sample_rate: float):
    """One block of the plate -> ``(new_state, out[2, B])``.  ``targets``:
    [6] decay, mix, damping, predelay, width, size (0-1)."""
    B = x.shape[-1]
    if B > min_tank_lag(sample_rate):
        raise ValueError(f"plate: block {B} exceeds the shortest block-level tank lag "
                         f"{min_tank_lag(sample_rate)}; lower block_size")
    dev = x.device
    srs = _srs(sample_rate)
    exc = EXCURSION * srs
    x = torch.where(torch.isfinite(x), x, 0.0)
    mono_in = 0.5 * (x[0] + x[1])
    s = state
    LT, DMOD = s.tank.shape[-1], s.mod_hist.shape[-1]
    tank_base, tap_base, tap_rows, tap_signs = _tables(sample_rate, LT, dev)

    coeff = smoothing_coeff(sample_rate)
    tgt = torch.as_tensor(targets, dtype=torch.float32, device=dev)
    powers = pow_table(float(np.float32(1.0 - coeff)), B, dev)
    raw = tgt[:, None] + settle_snap((s.smooth.current - tgt)[:, None] * powers)   # [6, B]
    decay_t = raw[P_DECAY] * MAX_DECAY
    mix_t = raw[P_MIX]
    damping_t = raw[P_DAMPING] * 0.95
    predelay_t = raw[P_PREDELAY] * (MAX_PREDELAY_MS * 0.001 * sample_rate)
    width_t = raw[P_WIDTH]
    size_t = size_to_scale(raw[P_SIZE])
    dd2_t = torch.clamp(decay_t + 0.15, 0.25, 0.50)

    # free-running LFOs (advance-then-use)
    n_idx = torch.arange(1, B + 1, dtype=torch.float32, device=dev)
    ph_a = torch.remainder(s.lfo_phase[0] + n_idx * (LFO_RATE_A / sample_rate), 1.0)
    ph_b = torch.remainder(s.lfo_phase[1] + n_idx * (LFO_RATE_B / sample_rate), 1.0)
    lfo_a_t = torch.sin((2.0 * np.pi) * ph_a)
    lfo_b_t = torch.sin((2.0 * np.pi) * ph_b)

    # the predelay (post-write fractional tap) and the tank's block reads
    pre_ring = ringbuf.write_block(s.predelay, mono_in)
    delayed_in = ringbuf.tap_frac(pre_ring, predelay_t, B)
    reads = _tank_read(s.tank, s.pos, tank_base * size_t)
    d1a_read, d1b_read = reads[T_D1A], reads[T_D1B]
    ap2a_read, ap2b_read = reads[T_AP2A], reads[T_AP2B]
    d2a_read, d2b_read = reads[T_D2A], reads[T_D2B]
    fb_a_t = torch.cat([s.fb_a[None], (d2a_read * decay_t)[:-1]])
    fb_b_t = torch.cat([s.fb_b[None], (d2b_read * decay_t)[:-1]])

    # modulated-allpass per-sample lags (clamped like the ring reads)
    mod_off = torch.stack([
        torch.clamp(TANK_AP1_A * srs * size_t + lfo_a_t * exc, 1.0, DMOD - 2.0),
        torch.clamp(TANK_AP1_B * srs * size_t + lfo_b_t * exc, 1.0, DMOD - 2.0)])

    a1, b1, da, db, new_in_hist, new_mod_hist, seeds = plate_kernels.plate_block(
        delayed_in, fb_a_t, fb_b_t, damping_t, d1a_read, d1b_read, mod_off,
        s.in_hist, s.mod_hist, torch.stack([s.bandwidth, s.damp_a, s.damp_b]),
        sample_rate=sample_rate)

    # the tank's block-level math, one write for all six lines, the 14 taps
    v2a = da * decay_t - dd2_t * ap2a_read
    a2 = dd2_t * v2a + ap2a_read
    v2b = db * decay_t - dd2_t * ap2b_read
    b2 = dd2_t * v2b + ap2b_read
    tank = _tank_write(s.tank, s.pos, torch.stack([a1, b1, v2a, v2b, a2, b2]))
    # pos stays reduced mod LT, as in the JAX package
    pos_after = torch.remainder(s.pos + B, LT)
    tapped = _tank_taps(tank, pos_after, tap_base * size_t, tap_rows, B) * tap_signs
    yl = OUTPUT_SCALE * torch.sum(tapped[:7], dim=0)
    yr = OUTPUT_SCALE * torch.sum(tapped[7:], dim=0)
    mid = 0.5 * (yl + yr)
    side = 0.5 * (yl - yr) * width_t
    wet_l = mid + side
    wet_r = mid - side
    out = torch.stack([x[0] * (1.0 - mix_t) + wet_l * mix_t,
                       x[1] * (1.0 - mix_t) + wet_r * mix_t])
    out = torch.where(torch.isfinite(out), out, x)

    new_state = PlateState(
        predelay=pre_ring,
        in_hist=new_in_hist,
        mod_hist=new_mod_hist,
        tank=tank,
        pos=pos_after,
        bandwidth=seeds[0],
        damp_a=seeds[1],
        damp_b=seeds[2],
        fb_a=d2a_read[-1] * decay_t[-1],
        fb_b=d2b_read[-1] * decay_t[-1],
        lfo_phase=torch.stack([ph_a[-1], ph_b[-1]]),
        smooth=SmootherBank(current=raw[:, -1], target=tgt),
    )
    return new_state, out
