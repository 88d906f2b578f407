"""The bus's first-half kernels, each beside its plain version.

Counterparts of the JAX package's Pallas wrappers:

================  ======================================  ======================
wrapper           replaces (wrapper line, body)           caller in the port
================  ======================================  ======================
saturation_block  pallas_fx.py:504, _sat4_kernel          effects/saturation
lowpass_block     pallas_fx.py:1027, _lowpass_kernel      effects/lowpass
tilt_block        pallas_fx.py:880, _tilt_kernel          effects/tilt
delay_block       pallas_fx.py:962, _delay_kernel         effects/delay
bus_chain         pallas_chain.py:92, chain_fused         effects/chain
================  ======================================  ======================

Dispatch as in :mod:`ops.bank_kernels`, with no fallback: a CUDA tensor
launches the hand-written kernel (``csrc/bus_kernels.cu``) or raises; a CPU
tensor takes the ``*_plain`` version, a sample-sequential PyTorch loop in the
Pallas body's per-sample op order (the Pallas bodies solve the linear
recurrences with log-depth scans, so they differ from it at float-noise
level).  Every wrapper counts its kernel launches in ``<wrapper>.launches``
(read them all through :mod:`ops.kernels`).

Signals are the stereo bus, float32 ``[2, B]``; ``cur``/``tgt`` are the
smoothers' ``[2, P]`` currents and targets, whose per-sample trajectories the
kernels compute themselves.  An effect's block for a kernel is a
:class:`Phase`: the wrapper's name and its arguments after the signal.
``bus_chain`` runs a list of phases in one launch, each on the signal the one
before it left, through the same per-effect code as the single kernels.  What
bounds the kernels on the card is in the header of their CUDA source: two
threads stepping a serial chain.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from libgooey_tpu_torch.ops.bank_kernels import (
    _F32,
    _FBWS_COEFS,
    FBWS_S_IN,
    FBWS_S_OUT,
    _check,
    _empty,
    _host_floats,
    _launch,
    _on_cuda,
    gated_dc,
    ovs4_plain,
    pack_fbws_bank,
    unpack_fbws_bank,
)

KERNELS = ("saturation_block", "lowpass_block", "tilt_block", "delay_block", "bus_chain")

#: Source of each kernel and the TPU kernel it replaces (file:line of the
#: wrapper that reaches ``pl.pallas_call``).
SOURCES = {name: "libgooey_tpu_torch/csrc/bus_kernels.cu" for name in KERNELS}
REPLACES = {
    "saturation_block": "libgooey_tpu/ops/pallas_fx.py:504",
    "lowpass_block": "libgooey_tpu/ops/pallas_fx.py:1027",
    "tilt_block": "libgooey_tpu/ops/pallas_fx.py:880",
    "delay_block": "libgooey_tpu/ops/pallas_fx.py:962",
    "bus_chain": "libgooey_tpu/ops/pallas_chain.py:92",
}

#: rows of the saturation's output state: the packed 4x chain and DC blocker
#: (``FBWS_S_OUT``), then the smoother currents (drive, warmth, mix)
SAT_S_OUT = FBWS_S_OUT + 3

#: phases one ``bus_chain`` launch takes (``kMaxPhases`` in the CUDA source)
MAX_PHASES = 8
#: the delay stages both channels' filtered taps, 2 x B floats, in the 48 KB
#: of shared memory a launch gets by default
MAX_DELAY_B = 6144


class Phase(NamedTuple):
    """One effect's block for a kernel: the name of the wrapper that runs it
    alone and that wrapper's arguments after the signal."""

    name: str
    args: tuple
    kwargs: dict


def _f32(v) -> float:
    """A Python float rounded to float32, as the JAX package's constants are."""
    return float(np.float32(v))


def _logq(coeff) -> float:
    """``log(1 - coeff)`` in float64, rounded once to float32 (the Pallas
    bodies' ``np.float32(np.log(1.0 - coeff))``)."""
    return _f32(np.log(1.0 - coeff))


def _stereo_b(name, x) -> int:
    if x.dim() != 2 or x.shape[0] != 2 or x.shape[1] < 1:
        raise ValueError(f"{name}: expected a non-empty [2, B] tensor, got {tuple(x.shape)}")
    return x.shape[1]


def _trajectories(cur, tgt, coeff, B):
    """``[P, 2, B]``: each smoothed parameter's closed-form trajectory
    ``tgt + snap((cur - tgt) * exp(log(1 - coeff) * (n+1)))``, in the op
    order of ``_traj`` (pallas_fx.py:365-373)."""
    n1 = torch.arange(1, B + 1, dtype=_F32, device=cur.device)
    d = (cur.t()[:, :, None] - tgt.t()[:, :, None]) * torch.exp(_logq(coeff) * n1)
    return tgt.t()[:, :, None] + torch.where(d.abs() < 1e-4, 0.0, d)


# --- the launch: phases as the CUDA source's Phase structs ----------------------


def _saturation_slots(B, cur, tgt, packed, *, coeff):
    return ([("cur", cur, (2, 3)), ("tgt", tgt, (2, 3)), ("packed", packed, (FBWS_S_IN, 2))],
            [(SAT_S_OUT, 2)], [_logq(coeff)], 0)


def _lowpass_slots(B, g, fb, stages):
    return ([("g", g, (2, B)), ("fb", fb, (2, B)), ("stages", stages, (2, 2))],
            [(2, 2)], [], 0)


def _tilt_slots(B, cur, tgt, ic, *, coeff, sample_rate):
    return ([("cur", cur, (2, 2)), ("tgt", tgt, (2, 2)), ("ic", ic, (2, 2))], [(2, 4)],
            [_logq(coeff), _TILT_LP_LOG, _TILT_HP_LOG, _f32(sample_rate * 0.45), _PI,
             _f32(1.0 / sample_rate)], 0)


def _delay_slots(B, delayed, cur, tgt, z, *, coeff, sample_rate, pingpong=False):
    if B > MAX_DELAY_B:
        raise ValueError(f"delay_block: B = {B} exceeds {MAX_DELAY_B}")
    return ([("delayed", delayed, (2, B)), ("cur", cur, (2, 3)), ("tgt", tgt, (2, 3)),
             ("z", z, (2, 2))], [(2, B), (2, 5)],
            [_logq(coeff), _f32(-2.0 * np.pi / sample_rate)], int(bool(pingpong)))


#: wrapper -> (the CUDA source's ``Op``, the phase's inputs ``(label, tensor,
#: shape)``, output shapes, scalars and flag, in the order of its ``Phase``)
_SLOTS = {"saturation_block": (0, _saturation_slots), "lowpass_block": (1, _lowpass_slots),
          "tilt_block": (2, _tilt_slots), "delay_block": (3, _delay_slots)}


def _launch_phases(name, x, phases, *, fused):
    """Check and pack ``phases`` and launch them on ``x``: one effect's own
    kernel (``fused=False``, one phase) or ``bus_chain``.  Returns ``(y [2,
    B], [each phase's outputs after the signal])``."""
    B = _stereo_b(name, x)
    specs = [("x", x, _F32, (2, B))]
    ops, ptrs, floats, outs = [], [], [], []
    for ph in phases:
        op, slots = _SLOTS[ph.name]
        ins, out_shapes, f, flag = slots(B, *ph.args, **ph.kwargs)
        specs += [(f"{ph.name} {label}", t, _F32, shape) for label, t, shape in ins]
        aux = tuple(_empty(shape, x) for shape in out_shapes)
        ops += [op, flag]
        ptrs += ([t.data_ptr() for _, t, _ in ins] + [None] * (4 - len(ins))
                 + [a.data_ptr() for a in aux] + [None] * (2 - len(aux)))
        floats += f + [0.0] * (6 - len(f))
        outs.append(aux)
    _check(name, x.device, specs)
    y = _empty((2, B), x)
    c_ops = (ctypes.c_int * len(ops))(*ops)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_floats = (ctypes.c_float * len(floats))(*floats)
    keep, coefs = _host_floats(_FBWS_COEFS)
    if fused:
        _launch(name, x.device, "bus_chain_launch", x.data_ptr(), y.data_ptr(), len(phases),
                c_ops, c_ptrs, c_floats, coefs, B)
    else:
        _launch(name, x.device, "bus_block_launch", x.data_ptr(), y.data_ptr(),
                c_ops, c_ptrs, c_floats, coefs, B)
    del keep
    return y, outs


def _launch_one(name, x, args, kwargs):
    """One effect's own kernel -> ``(y, *outputs)``, the wrapper's return."""
    y, (aux,) = _launch_phases(name, x, [Phase(name, args, kwargs)], fused=False)
    return (y, *aux)


# --- 1. saturation_block --------------------------------------------------------

_ATAN_BIG = _f32(2.414213562373095)     # tan(3pi/8)
_ATAN_MID = _f32(0.41421356237309503)   # tan(pi/8)
_ATAN_P = tuple(_f32(c) for c in (8.05374449538e-2, 1.38776856032e-1,
                                  1.99777106478e-1, 3.33329491539e-1))
_PI_2, _PI_4, _FRAC_2_PI = _f32(np.pi / 2), _f32(np.pi / 4), _f32(2.0 / np.pi)


def atan_cephes(x):
    """Branchless Cephes atanf (pallas_fx.py:350-362), the kernel's and the
    TPU kernel's polynomial; ~1e-7 from libm."""
    ax = x.abs()
    big, mid = ax > _ATAN_BIG, ax > _ATAN_MID
    z = torch.where(big, torch.full_like(ax, -1.0) / torch.clamp(ax, min=_f32(1e-30)),
                    torch.where(mid, (ax - 1.0) / (ax + 1.0), ax))
    zz = z * z
    c0, c1, c2, c3 = _ATAN_P
    p = ((((c0 * zz - c1) * zz + c2) * zz - c3) * zz) * z + z
    return torch.sign(x) * torch.where(big, p + _PI_2, torch.where(mid, p + _PI_4, p))


def saturate(v, drive, bias):
    """The tube curve (saturation.rs:106-125) at one subsample."""
    driven = v * drive
    biased = driven + bias * driven.abs()
    soft = atan_cephes(biased) * _FRAC_2_PI
    return soft + soft * soft * torch.sign(soft) * 0.15 * bias


def saturation_block_plain(x, cur, tgt, packed, *, coeff):
    """Plain version of the fused tube saturation (pallas_fx.py:474-500):
    smoothed drive/warmth/mix, the 4x chain around :func:`saturate`, the
    bypass-gated DC blocker, the mix and the finite select."""
    t_drive, t_warm, mix = _trajectories(cur, tgt, coeff, x.shape[1])
    dT, bT = (1.0 + t_drive * 7.0).t(), (t_warm * 0.4).t()
    bypass = mix < 1e-4
    y1, nst = ovs4_plain(x.t(), packed, lambda n, s: saturate(s, dT[n], bT[n]),
                         gated_dc(torch.where(bypass, -1.0, 1.0).t()))
    out = torch.where(bypass, x, x * (1.0 - mix) + y1 * mix)
    out = torch.where(torch.isfinite(out), out, 0.0)
    sm = torch.stack([t_drive[:, -1], t_warm[:, -1], mix[:, -1]], dim=0)
    return out, torch.cat([nst, sm], dim=0)


def saturation_block(x, cur, tgt, packed, *, coeff):
    """One fused stereo tube-saturation block at 4x.

    ``x``: [2, B]; ``cur``/``tgt``: [2, 3] smoother state (drive, warmth,
    mix); ``packed``: [52, 2] from :func:`pack_saturation`; ``coeff``: the
    30 ms smoothing coefficient.  Returns ``(out [2, B], nst [103, 2])`` for
    :func:`unpack_saturation`."""
    if not _on_cuda("saturation_block", x):
        return saturation_block_plain(x, cur, tgt, packed, coeff=coeff)
    res = _launch_one("saturation_block", x, (cur, tgt, packed), dict(coeff=coeff))
    saturation_block.launches += 1
    return res


saturation_block.launches = 0


def pack_saturation(ovs, dc) -> torch.Tensor:
    """The saturation's ``[2]``-batched OversamplerState and DCBlockState ->
    packed ``[52, 2]`` (the ``fbws_bank`` layout, one column per channel)."""
    return pack_fbws_bank(SimpleNamespace(ovs=ovs, dc_x1=dc.x1, dc_y1=dc.y1))


def unpack_saturation(nst, ovs):
    """Packed ``[103, 2]`` -> ``(OversamplerState, dc_x1, dc_y1, smoother
    currents [2, 3])``; ``ovs`` supplies the up-samplers' untouched ``x1``."""
    new_ovs, dc_x1, dc_y1 = unpack_fbws_bank(nst[:FBWS_S_OUT], SimpleNamespace(ovs=ovs))
    return new_ovs, dc_x1, dc_y1, nst[FBWS_S_OUT:].t()


# --- 2. lowpass_block -----------------------------------------------------------


def lowpass_block_plain(x, g, fb, stages):
    """Plain version of the serial resonant LP (pallas_fx.py:985-1023):
    ``infb = x - tanh(s2*fb)*min(fb, 1)``, two one-poles, the 1e-15 flushes
    and the NaN reset; the output is ``tanh`` of the stage-2 trajectory."""
    s1, s2 = stages[:, 0], stages[:, 1]
    raw = []
    for n in range(x.shape[1]):
        fbn = fb[:, n]
        infb = x[:, n] - torch.tanh(s2 * fbn) * torch.clamp(fbn, max=1.0)
        s1 = s1 + g[:, n] * (infb - s1)
        s2 = s2 + g[:, n] * (s1 - s2)
        s1 = torch.where(s1.abs() < 1e-15, 0.0, s1)
        s2 = torch.where(s2.abs() < 1e-15, 0.0, s2)
        nan = torch.isnan(s2)
        s1 = torch.where(nan, 0.0, s1)
        s2 = torch.where(nan, 0.0, s2)
        raw.append(s2)
    return torch.tanh(torch.stack(raw, dim=1)), torch.stack([s1, s2], dim=-1)


def lowpass_block(x, g, fb, stages):
    """Serial resonant-LP block.  ``x``/``g``/``fb``: [2, B]; ``stages``:
    [2, 2] = (stage1, stage2) per channel.  Returns ``(out [2, B],
    stages' [2, 2])``."""
    if not _on_cuda("lowpass_block", x):
        return lowpass_block_plain(x, g, fb, stages)
    res = _launch_one("lowpass_block", x, (g, fb, stages), {})
    lowpass_block.launches += 1
    return res


lowpass_block.launches = 0


# --- 3. tilt_block --------------------------------------------------------------

_TILT_LP_LOG = _f32(np.log(20000.0 / 80.0))
_TILT_HP_LOG = _f32(np.log(8000.0 / 20.0))
_PI = _f32(np.pi)


def tilt_block_plain(x, cur, tgt, ic, *, coeff, sample_rate):
    """Plain version of the tilt filter (pallas_fx.py:839-876): the knob's
    LP/HP frequency maps, the TPT SVF stepped sample by sample with its
    pre-update taps, the crossfade, the finite select and the 1e-15 flush."""
    knob, res = _trajectories(cur, tgt, coeff, x.shape[1])
    lp_mix = 1.0 - knob * 2.0
    lp_freq = 80.0 * torch.exp(_TILT_LP_LOG * (knob * 2.0))
    hp_mix = (knob - 0.5) * 2.0
    hp_freq = 20.0 * torch.exp(_TILT_HP_LOG * ((knob - 0.5) * 2.0))
    use_lp = knob < 0.5
    mix = torch.where(use_lp, lp_mix, hp_mix)
    freq = torch.where(use_lp, lp_freq, hp_freq)
    q = 0.5 + res * 8.0
    passthrough = mix < 0.001
    cutoff = torch.clamp(freq, 20.0, _f32(sample_rate * 0.45))
    g = torch.tan(_PI * cutoff * _f32(1.0 / sample_rate))
    r = 1.0 / torch.clamp(q, min=0.5)
    h = 1.0 / (1.0 + r * g + g * g)
    ic1, ic2 = ic[:, 0], ic[:, 1]
    v1s, v2s = [], []
    for n in range(x.shape[1]):
        v1 = (g[:, n] * (x[:, n] - ic2) + ic1) * h[:, n]
        v2 = ic2 + g[:, n] * v1
        ic1 = 2.0 * v1 - ic1
        ic2 = 2.0 * v2 - ic2
        v1s.append(v1)
        v2s.append(v2)
    v1, v2 = torch.stack(v1s, dim=1), torch.stack(v2s, dim=1)
    wet = torch.where(use_lp, v2, x - (r * v1 + v2))
    out = torch.where(passthrough, x, x * (1.0 - mix) + wet * mix)
    out = torch.where(torch.isfinite(out), out, 0.0)
    out = torch.where(out.abs() < 1e-15, 0.0, out)
    return out, torch.stack([ic1, ic2, knob[:, -1], res[:, -1]], dim=-1)


def tilt_block(x, cur, tgt, ic, *, coeff, sample_rate):
    """One tilt-filter block.  ``x``: [2, B]; ``cur``/``tgt``: [2, 2] smoother
    state (knob, res); ``ic``: [2, 2] SVF integrators (ic1, ic2).  Returns
    ``(out [2, B], nst [2, 4])`` with nst = (ic1', ic2', knob, res)."""
    if not _on_cuda("tilt_block", x):
        return tilt_block_plain(x, cur, tgt, ic, coeff=coeff, sample_rate=sample_rate)
    res = _launch_one("tilt_block", x, (cur, tgt, ic),
                      dict(coeff=coeff, sample_rate=sample_rate))
    tilt_block.launches += 1
    return res


tilt_block.launches = 0


# --- 4. delay_block -------------------------------------------------------------

_DELAY_RES = 0.3


def delay_block_plain(x, delayed, cur, tgt, z, *, coeff, sample_rate, pingpong=False):
    """Plain version of the delay's post-read path (pallas_fx.py:907-956):
    the darkening two-pole LP on the gathered tap in its affine form, stepped
    sample by sample; the feedback write (partner taps and a left-only
    injection with ``pingpong``) and the dry/wet mix."""
    fb_t, mix_t, cut_t = _trajectories(cur, tgt, coeff, x.shape[1])
    g = 1.0 - torch.exp(_f32(-2.0 * np.pi / sample_rate) * cut_t)
    r = _DELAY_RES
    a11 = 1.0 - g + g * r
    a12 = -g * r
    b1 = g * delayed
    a21 = g * a11
    a22 = (1.0 - g) + g * a12
    b2 = g * b1
    z1, z2 = z[:, 0], z[:, 1]
    filt = []
    for n in range(x.shape[1]):
        z1, z2 = (a11[:, n] * z1 + a12[:, n] * z2 + b1[:, n],
                  a21[:, n] * z1 + a22[:, n] * z2 + b2[:, n])
        filt.append(z2)
    filtered = torch.stack(filt, dim=1)
    if pingpong:
        tap_for = filtered.flip(0)
        inject = torch.stack([x[0], torch.zeros_like(x[1])], dim=0)
    else:
        tap_for, inject = filtered, x
    write = inject + tap_for * fb_t
    write = torch.where(torch.isfinite(write) & (write.abs() > 1e-15), write, 0.0)
    out = x * (1.0 - mix_t) + filtered * mix_t
    out = torch.where(torch.isfinite(out), out, x)
    nst = torch.stack([z1, z2, fb_t[:, -1], mix_t[:, -1], cut_t[:, -1]], dim=-1)
    return out, write, nst


def delay_block(x, delayed, cur, tgt, z, *, coeff, sample_rate, pingpong=False):
    """Fused delay post-read block.  ``x``/``delayed``: [2, B] input and
    gathered fractional tap; ``cur``/``tgt``: [2, 3] smoother state
    (feedback, mix, cutoff); ``z``: [2, 2] filter state.  Returns ``(out
    [2, B], write [2, B], nst [2, 5])`` with nst = (z1, z2, feedback, mix,
    cutoff)."""
    if not _on_cuda("delay_block", x):
        return delay_block_plain(x, delayed, cur, tgt, z, coeff=coeff,
                                 sample_rate=sample_rate, pingpong=pingpong)
    res = _launch_one("delay_block", x, (delayed, cur, tgt, z),
                      dict(coeff=coeff, sample_rate=sample_rate, pingpong=pingpong))
    delay_block.launches += 1
    return res


delay_block.launches = 0


# --- 5. bus_chain ---------------------------------------------------------------


def bus_chain_plain(x, phases):
    """Plain version of a run of bus effects: each phase's plain version in
    order, on the signal the one before it left."""
    y, outs = x, []
    for ph in phases:
        y, *aux = globals()[ph.name + "_plain"](y, *ph.args, **ph.kwargs)
        outs.append(tuple(aux))
    return y, outs


def bus_chain(x, phases):
    """A run of bus effects in one launch (the counterpart of
    ``pallas_chain.chain_fused``).  ``x``: [2, B]; ``phases``: up to
    ``MAX_PHASES`` :class:`Phase` of the four effect wrappers.  Returns
    ``(y [2, B], [each phase's outputs after the signal])``, what the
    wrappers give one after the other."""
    if not _on_cuda("bus_chain", x):
        return bus_chain_plain(x, phases)
    if not 1 <= len(phases) <= MAX_PHASES:
        raise ValueError(f"bus_chain: {len(phases)} phases, expected 1 to {MAX_PHASES}")
    res = _launch_phases("bus_chain", x, phases, fused=True)
    bus_chain.launches += 1
    return res


bus_chain.launches = 0


def run_phase(x, phase):
    """One phase through its own effect's wrapper -> ``(y, outputs after the
    signal)``."""
    y, *aux = globals()[phase.name](x, *phase.args, **phase.kwargs)
    return y, tuple(aux)
