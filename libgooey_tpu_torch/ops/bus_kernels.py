"""The bus's first-half kernels, each beside its plain version.

Counterparts of the JAX package's Pallas wrappers:

==================  ======================================  ======================
wrapper             replaces (wrapper line, body)           caller in the port
==================  ======================================  ======================
saturation_block    pallas_fx.py:504, _sat4_kernel          effects/saturation
lowpass_block       pallas_fx.py:1027, _lowpass_kernel      effects/lowpass
tilt_block          pallas_fx.py:880, _tilt_kernel          effects/tilt
delay_block         pallas_fx.py:962, _delay_kernel         effects/delay
env_follower_block  pallas_fx.py:673, _env_kernel           effects/compressor
compressor_block    pallas_fx.py:758, _comp_kernel          effects/compressor
spring_block        pallas_fx.py:126, _spring_kernel        effects/reverb_spring
waveshaper_block    pallas_fx.py:614, _ws4_kernel           effects/waveshaper
fbws_fast_block     pallas_fx.py:1125, _fbws_kernel         effects/feedback_waveshaper
bus_chain           pallas_chain.py:92, chain_fused         effects/chain
==================  ======================================  ======================

Dispatch as in :mod:`ops.bank_kernels`, with no fallback: a CUDA tensor
launches the hand-written kernel (``csrc/bus_kernels.cu``) or raises; a CPU
tensor takes the ``*_plain`` version, a sample-sequential PyTorch loop in the
Pallas body's per-sample op order (the Pallas bodies solve the linear
recurrences with log-depth scans, so they differ from it at float-noise
level).  Every wrapper counts its kernel launches in ``<wrapper>.launches``
(read them all through :mod:`ops.kernels`).

Signals are the stereo bus, float32 ``[2, B]``; ``cur``/``tgt`` are the
smoothers' ``[2, P]`` currents and targets, whose per-sample trajectories the
kernels compute themselves (the compressor and the spring take theirs as
``[2, B]`` rows, computed outside as the JAX package computes them outside
its kernels).  An effect's block for a kernel is a :class:`Phase`: the
wrapper's name and its arguments after the signal.  ``bus_chain`` runs a
list of phases in one launch, each on the signal the one before it left,
through the same per-effect code as the single kernels.  The compressor is
two phases, its detector (which passes the signal through) and its gain
stage; in a run the gain stage's ``env`` is ``None``, the detector's output
before it.  The feedback waveshaper is two phases the same way.  In a
``bus_chain`` launch each phase runs on a warp of its own, the phases
pipelined a 32-sample chunk apart; what bounds the kernels on the card is
in the header of their CUDA source: the serial chains of the channels'
lanes.
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
    _TANH_HALF,
    _check,
    _div,
    _empty,
    _host_floats,
    _launch,
    _on_cuda,
    gated_dc,
    ovs4_plain,
    pack_fbws_bank,
    unpack_fbws_bank,
)

KERNELS = ("saturation_block", "lowpass_block", "tilt_block", "delay_block",
           "env_follower_block", "compressor_block", "spring_block", "waveshaper_block",
           "fbws_fast_block", "bus_chain")

#: Source of each kernel and the TPU kernel it replaces (file:line of the
#: wrapper that reaches ``pl.pallas_call``).
SOURCES = {name: "libgooey_tpu_torch/csrc/bus_kernels.cu" for name in KERNELS}
REPLACES = {
    "saturation_block": "libgooey_tpu/ops/pallas_fx.py:504",
    "lowpass_block": "libgooey_tpu/ops/pallas_fx.py:1027",
    "tilt_block": "libgooey_tpu/ops/pallas_fx.py:880",
    "delay_block": "libgooey_tpu/ops/pallas_fx.py:962",
    "env_follower_block": "libgooey_tpu/ops/pallas_fx.py:673",
    "compressor_block": "libgooey_tpu/ops/pallas_fx.py:758",
    "spring_block": "libgooey_tpu/ops/pallas_fx.py:126",
    "waveshaper_block": "libgooey_tpu/ops/pallas_fx.py:614",
    "fbws_fast_block": "libgooey_tpu/ops/pallas_fx.py:1125",
    "bus_chain": "libgooey_tpu/ops/pallas_chain.py:92",
}

#: rows of the saturation's output state: the packed 4x chain and DC blocker
#: (``FBWS_S_OUT``), then the smoother currents (drive, warmth, mix)
SAT_S_OUT = FBWS_S_OUT + 3

#: rows of the compressor's packed state: the 4x chain and DC blocker, then
#: the smoothed gain
COMP_S_IN = FBWS_S_IN + 1
COMP_S_OUT = FBWS_S_OUT + 1

#: phases one ``bus_chain`` launch takes (``kMaxPhases`` in the CUDA source):
#: the product chain's run of eight entries is ten phases
MAX_PHASES = 12
#: a phase's pointer, float and int slots (``kPhaseIn`` ... in the CUDA source)
_PHASE_IN, _PHASE_OUT, _PHASE_F, _PHASE_I = 8, 2, 16, 16
#: phases that pass the signal through and leave their result in an output
_PASSES_SIGNAL = ("env_follower_block",)


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


class _Slots(NamedTuple):
    """A phase as the CUDA source's ``Phase`` takes it: inputs ``(label,
    tensor, shape)``, output shapes, scalars, ints and flag."""

    ins: list
    outs: list
    f: tuple = ()
    iv: tuple = ()
    flag: int = 0


def _saturation_slots(B, cur, tgt, packed, *, coeff):
    return _Slots([("cur", cur, (2, 3)), ("tgt", tgt, (2, 3)), ("packed", packed, (FBWS_S_IN, 2))],
                  [(SAT_S_OUT, 2)], (_logq(coeff),))


def _lowpass_slots(B, g, fb, stages):
    return _Slots([("g", g, (2, B)), ("fb", fb, (2, B)), ("stages", stages, (2, 2))], [(2, 2)])


def _tilt_slots(B, cur, tgt, ic, *, coeff, sample_rate):
    return _Slots([("cur", cur, (2, 2)), ("tgt", tgt, (2, 2)), ("ic", ic, (2, 2))], [(2, 4)],
                  (_logq(coeff), _TILT_LP_LOG, _TILT_HP_LOG, _f32(sample_rate * 0.45), _PI,
                   _f32(1.0 / sample_rate)))


def _delay_slots(B, delayed, cur, tgt, z, *, coeff, sample_rate, pingpong=False):
    return _Slots([("delayed", delayed, (2, B)), ("cur", cur, (2, 3)), ("tgt", tgt, (2, 3)),
                   ("z", z, (2, 2))], [(2, B), (2, 5)],
                  (_logq(coeff), _f32(-2.0 * np.pi / sample_rate)), flag=int(bool(pingpong)))


def _env_slots(B, att_c, rel_c, byp, env0):
    return _Slots([("att_c", att_c, (2, B)), ("rel_c", rel_c, (2, B)), ("byp", byp, (2, B)),
                   ("env0", env0, (2,))], [(2, B), (2,)])


def _compressor_slots(B, env, thr, ratio, mix, packed):
    return _Slots([("env", env, (2, B)), ("thr", thr, (2, B)), ("ratio", ratio, (2, B)),
                   ("mix", mix, (2, B)), ("packed", packed, (COMP_S_IN, 2))],
                  [(COMP_S_OUT, 2)], (_COMP_DB, _COMP_LN, _COMP_SHAPE))


def _spring_slots(B, A, p2, fbgp, hist, damp, mix, fb0, *, delays, gains):
    D = _spring_check(hist, delays, gains)
    g, omg, alpha = _spring_gains(gains)
    return _Slots([("A", A, (2, B)), ("p2", p2, (2, B)), ("fbgp", fbgp, (2, B)),
                   ("hist", hist, (2 * SPRING_APS, D)), ("damp", damp, (2,)),
                   ("mix", mix, (2, B)), ("fb0", fb0, (2,))],
                  [(2 * SPRING_APS, D), (2,)], g + omg + (alpha,), tuple(delays) + (D,))


def _waveshaper_slots(B, prm, packed):
    return _Slots([("prm", prm, (2, 2)), ("packed", packed, (FBWS_S_IN, 2))],
                  [(FBWS_S_OUT, 2)], (_TANH_HALF,))


def _fbws_slots(B, env, prm, packed):
    return _Slots([("env", env, (2, B)), ("prm", prm, (2, 4)), ("packed", packed, (COMP_S_IN, 2))],
                  [(COMP_S_OUT, 2)], (_FBWS_MAKEUP_LN,))


#: wrapper -> (the CUDA source's ``Op``, its slots)
_SLOTS = {"saturation_block": (0, _saturation_slots), "lowpass_block": (1, _lowpass_slots),
          "tilt_block": (2, _tilt_slots), "delay_block": (3, _delay_slots),
          "env_follower_block": (4, _env_slots), "compressor_block": (5, _compressor_slots),
          "spring_block": (6, _spring_slots), "waveshaper_block": (7, _waveshaper_slots),
          "fbws_fast_block": (8, _fbws_slots)}
#: the gain stages whose ``env`` may be ``None`` in a run: the detector's
#: envelope before them
_READS_ENV = ("compressor_block", "fbws_fast_block")


def _pad(values, n, fill, what):
    values = list(values)
    if len(values) > n:
        raise ValueError(f"a phase has {len(values)} {what}, at most {n}")
    return values + [fill] * (n - len(values))


def _with_env(phase, outs):
    """A gain stage (the compressor's, the feedback waveshaper's) whose
    ``env`` is ``None`` reads the envelope of the detector phase just before
    it."""
    if phase.name not in _READS_ENV or phase.args[0] is not None:
        return phase
    if not outs or len(outs[-1]) != 2:
        raise ValueError(f"{phase.name}: env=None needs an env_follower_block phase before it")
    return phase._replace(args=(outs[-1][0],) + tuple(phase.args[1:]))


def _launch_phases(name, x, phases, *, fused):
    """Check and pack ``phases`` and launch them on ``x``: one effect's own
    kernel (``fused=False``, one phase) or ``bus_chain``.  Returns ``(y [2,
    B], [each phase's outputs after the signal])``."""
    B = _stereo_b(name, x)
    specs = [("x", x, _F32, (2, B))]
    ops, ptrs, floats, ints, outs = [], [], [], [], []
    for ph in phases:
        ph = _with_env(ph, outs)
        op, slots = _SLOTS[ph.name]
        sl = slots(B, *ph.args, **ph.kwargs)
        specs += [(f"{ph.name} {label}", t, _F32, shape) for label, t, shape in sl.ins]
        aux = tuple(_empty(shape, x) for shape in sl.outs)
        ops += [op, sl.flag]
        ptrs += (_pad([t.data_ptr() for _, t, _ in sl.ins], _PHASE_IN, None, "inputs")
                 + _pad([a.data_ptr() for a in aux], _PHASE_OUT, None, "outputs"))
        floats += _pad(sl.f, _PHASE_F, 0.0, "scalars")
        ints += _pad(sl.iv, _PHASE_I, 0, "ints")
        outs.append(aux)
    _check(name, x.device, specs)
    y = _empty((2, B), x)
    c_ops = (ctypes.c_int * len(ops))(*ops)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_floats = (ctypes.c_float * len(floats))(*floats)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    keep, coefs = _host_floats(_FBWS_COEFS)
    if fused:
        _launch(name, x.device, "bus_chain_launch", x.data_ptr(), y.data_ptr(), len(phases),
                c_ops, c_ptrs, c_floats, c_ints, coefs, B)
    else:
        _launch(name, x.device, "bus_block_launch", x.data_ptr(), y.data_ptr(),
                c_ops, c_ptrs, c_floats, c_ints, coefs, B)
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


# --- 5. env_follower_block -----------------------------------------------------


def env_follower_block_plain(x, att_c, rel_c, byp, env0):
    """Plain version of the compressor's detector (pallas_fx.py:639-669):
    ``e = c*env + (1-c)*|x|`` with ``c = att if |x| > env else rel``, 1 on
    a bypassed sample (``byp > 0.5``: the envelope holds), flushed below
    1e-15."""
    rect, frozen = x.abs(), byp > 0.5
    env, outs = env0, []
    for n in range(x.shape[1]):
        r = rect[:, n]
        c = torch.where(frozen[:, n], 1.0, torch.where(r > env, att_c[:, n], rel_c[:, n]))
        e = c * env + (1.0 - c) * r
        env = torch.where(e < 1e-15, 0.0, e)
        outs.append(env)
    return torch.stack(outs, dim=1), env


def env_follower_block(x, att_c, rel_c, byp, env0):
    """Stereo attack/release peak detector over one block.

    ``x``: [2, B] detector input, rectified in the kernel (the signal or
    its magnitude); ``att_c``/``rel_c``: [2, B] retention coefficients;
    ``byp``: [2, B], 1.0 freezes the follower; ``env0``: [2].  Returns
    ``(env [2, B], env_last [2])``.  In a ``bus_chain`` run the phase passes
    the signal through."""
    if not _on_cuda("env_follower_block", x):
        return env_follower_block_plain(x, att_c, rel_c, byp, env0)
    _, env, env_last = _launch_one("env_follower_block", x, (att_c, rel_c, byp, env0), {})
    env_follower_block.launches += 1
    return env, env_last


env_follower_block.launches = 0


# --- 6. compressor_block --------------------------------------------------------

#: the knee's dB scale, the gain's exponent scale and the tube colour's gain,
#: as the TPU kernel rounds them (pallas_fx.py:731,739,748)
_COMP_DB = _f32(20.0 / np.float32(np.log(10.0)))
_COMP_LN = _f32(np.float32(-0.05 * np.log(10.0)))
_COMP_SHAPE = _f32(np.float32(float(2.0 / np.pi) * 1.1))


def compressor_block_plain(x, env, thr, ratio, mix, packed):
    """Plain version of the compressor's gain stage (pallas_fx.py:718-754):
    the 6 dB soft knee's gain reduction on the envelope, the one-pole gain
    smoother (frozen on bypass) stepped sample by sample, ``x*g`` through the
    4x chain with the atan tube colour (used where ``g < 0.99``), the
    bypass-gated DC blocker, the mix and the finite select."""
    byp = mix < 1e-4
    env_db = _COMP_DB * torch.log(env + 1e-20)
    over = env_db - thr
    slope = 1.0 - 1.0 / ratio
    kv = over + 3.0
    knee = kv * kv / torch.full_like(kv, 12.0) * slope
    gr = torch.where(over <= -3.0, 0.0, torch.where(over >= 3.0, over * slope, knee))
    bv = 0.05 * torch.exp(_COMP_LN * gr)
    g, gs = packed[FBWS_S_IN], []
    for n in range(x.shape[1]):
        g = torch.where(byp[:, n], g, 0.95 * g + bv[:, n])
        gs.append(g)
    gain = torch.stack(gs, dim=1)
    compressed = x * gain
    gT, cT = gain.t(), compressed.t()
    dc = gated_dc(torch.where(byp, -1.0, 1.0).t())
    y1, nst = ovs4_plain(cT, packed[:FBWS_S_IN], lambda n, s: atan_cephes(s) * _COMP_SHAPE,
                         lambda c, n, y: dc(c, n, torch.where(gT[n] < 0.99, y, cT[n])))
    out = torch.where(byp, x, x * (1.0 - mix) + y1 * mix)
    out = torch.where(torch.isfinite(out), out, 0.0)
    return out, torch.cat([nst, g[None]], dim=0)


def compressor_block(x, env, thr, ratio, mix, packed):
    """The compressor's gain stage over one block.

    ``x``: [2, B]; ``env``: [2, B] detector envelope (``None`` in a
    ``bus_chain`` run: the detector phase's before it); ``thr``/``ratio``/
    ``mix``: [2, B] trajectories; ``packed``: [53, 2] from
    :func:`pack_compressor`.  Returns ``(out [2, B], nst [101, 2])`` for
    :func:`unpack_compressor`."""
    if not _on_cuda("compressor_block", x):
        return compressor_block_plain(x, env, thr, ratio, mix, packed)
    res = _launch_one("compressor_block", x, (env, thr, ratio, mix, packed), {})
    compressor_block.launches += 1
    return res


compressor_block.launches = 0


def pack_compressor(ovs, dc, gain) -> torch.Tensor:
    """The compressor's ``[2]``-batched OversamplerState, DCBlockState and
    smoothed gain -> packed ``[53, 2]``."""
    core = pack_fbws_bank(SimpleNamespace(ovs=ovs, dc_x1=dc.x1, dc_y1=dc.y1))
    return torch.cat([core, gain[None]], dim=0)


def unpack_compressor(nst, ovs):
    """Packed ``[101, 2]`` -> ``(OversamplerState, dc_x1, dc_y1, gain)``."""
    new_ovs, dc_x1, dc_y1 = unpack_fbws_bank(nst[:FBWS_S_OUT], SimpleNamespace(ovs=ovs))
    return new_ovs, dc_x1, dc_y1, nst[FBWS_S_OUT]


# --- 7. spring_block ------------------------------------------------------------

#: allpasses per channel (reverb.rs:30-39)
SPRING_APS = 6


def _spring_check(hist, delays, gains) -> int:
    """The history's length D, checked against the lags."""
    D = hist.shape[-1]
    if len(delays) != 2 * SPRING_APS or len(gains) != SPRING_APS:
        raise ValueError(f"spring_block: expected {2 * SPRING_APS} lags and {SPRING_APS} gains")
    if not 1 <= min(delays) <= max(delays) <= D:
        raise ValueError(f"spring_block: lags {delays} do not fit a history of {D}")
    return D


def _spring_gains(gains):
    """``(g, 1 - g^2, prod g)`` rounded to float32 from float64, as the
    TPU kernel's static Python constants are."""
    return (tuple(_f32(g) for g in gains), tuple(_f32(1.0 - g * g) for g in gains),
            _f32(np.prod(gains)))


def spring_block_plain(x, A, p2, fbgp, hist, damp, mix, fb0, *, delays, gains):
    """Plain version of the spring block (pallas_fx.py:83-120, stepped sample
    by sample on a ``[12, D+B]`` work buffer as the Pallas body lays it
    out): the delayed reads, their allpass chain's offset ``beta``, the
    damping recurrence, the six allpass writes a channel, and the mix
    (reverb_spring.py:193)."""
    B = x.shape[1]
    D = _spring_check(hist, delays, gains)
    g, omg, alpha = _spring_gains(gains)
    W = torch.cat([hist, hist.new_zeros((2 * SPRING_APS, B))], dim=1)
    rows = torch.arange(2 * SPRING_APS, device=x.device)
    lags = torch.as_tensor(delays, device=x.device)
    xe = x.clone()
    xe[:, 0] = x[:, 0] + fb0
    d, wets = damp, []
    for n in range(B):
        rd = W[rows, D + n - lags].reshape(2, SPRING_APS)
        beta = torch.zeros_like(d)
        for j in range(SPRING_APS):
            beta = g[j] * beta + omg[j] * rd[:, j]
        bv = p2[:, n] * (alpha * xe[:, n] + beta)
        d_prev, d = d, A[:, n] * d + bv
        sig = xe[:, n] + fbgp[:, n] * d_prev
        vs = []
        for j in range(SPRING_APS):
            v = sig - g[j] * rd[:, j]
            vs.append(v)
            sig = g[j] * v + rd[:, j]
        W[:, D + n] = torch.stack(vs, dim=1).reshape(-1)
        wets.append(sig)
    out = x * (1.0 - mix) + torch.stack(wets, dim=1) * mix
    return out, W[:, B:B + D].clone(), d


def spring_block(x, A, p2, fbgp, hist, damp, mix, fb0, *, delays, gains):
    """One stereo spring-reverb block.

    ``x``: [2, B] dry input; ``A``/``p2``/``fbgp``: [2, B] damping-loop
    trajectories (effects/reverb_spring.py); ``hist``: [12, D] right-aligned
    allpass histories (left channel's six, then the right's); ``damp``/
    ``fb0``: [2] carried damping state and feedback sample; ``mix``: [2, B];
    ``delays``: the 12 lags, ``gains``: the 6 allpass gains.  Returns
    ``(out [2, B], hist' [12, D], d_last [2])``.  The TPU kernel returns the
    wet signal and leaves the feedback carry and the mix to its caller; here
    they are in the kernel, so a lone spring and a spring in a run are one
    phase (``mix = 1``, ``fb0 = 0`` give the wet signal)."""
    if not _on_cuda("spring_block", x):
        return spring_block_plain(x, A, p2, fbgp, hist, damp, mix, fb0, delays=delays,
                                  gains=gains)
    res = _launch_one("spring_block", x, (A, p2, fbgp, hist, damp, mix, fb0),
                      dict(delays=delays, gains=gains))
    spring_block.launches += 1
    return res


spring_block.launches = 0


# --- 8. waveshaper_block -------------------------------------------------------


def waveshaper_block_plain(x, prm, packed):
    """Plain version of the bus waveshaper (pallas_fx.py:592-611):
    ``tanh(v*d)*tanh(0.5)/tanh(0.5 d)`` at 4x with block-scalar drive and
    mix, the mix, the bypass select and the finite guard."""
    drive, mix = prm[:, 0:1], prm[:, 1:2]
    d = torch.clamp(drive, min=1.0 + 1e-6)
    comp = torch.full_like(d, _TANH_HALF) / torch.tanh(0.5 * d)
    d0, c0 = d[:, 0], comp[:, 0]
    sat, nst = ovs4_plain(x.t(), packed, lambda n, s: torch.tanh(s * d0) * c0,
                          lambda c, n, y: y)
    out = torch.where((mix <= 1e-4) | (drive <= 1.0), x, x * (1.0 - mix) + sat * mix)
    return torch.where(torch.isfinite(x), out, 0.0), nst


def waveshaper_block(x, prm, packed):
    """One stereo 4x waveshaper block.  ``x``: [2, B]; ``prm``: [2, 2] per
    channel (drive, mix), block scalars; ``packed``: [52, 2] from
    ``bank_kernels.pack_ws4_bank``.  Returns ``(out [2, B], nst [100, 2])``
    for ``bank_kernels.unpack_ws4_bank``; the caller holds the state over a
    bypassed block."""
    if not _on_cuda("waveshaper_block", x):
        return waveshaper_block_plain(x, prm, packed)
    res = _launch_one("waveshaper_block", x, (prm, packed), {})
    waveshaper_block.launches += 1
    return res


waveshaper_block.launches = 0


# --- 9. fbws_fast_block --------------------------------------------------------

#: ln(10) * 5.1 / 20, the high-end makeup's exponent scale (pallas_fx.py:1099)
_FBWS_MAKEUP_LN = _f32(5.1 * np.log(10.0) / 20.0)


def fbws_gain(env, drive, feedback):
    """The feedback waveshaper's envelope-referenced makeup gain
    (feedback_waveshaper.rs:247-259) in the TPU kernel's exp/log form
    (pallas_fx.py:1087-1100)."""
    reference = torch.clamp(env, min=0.05)
    driven_ref = torch.clamp(torch.tanh(reference * drive).abs(), min=1e-6)
    comp_no_fb = torch.tanh(reference) / driven_ref
    drive_norm = torch.clamp(_div(drive - 1.0, 99.0), 0.0, 1.0)
    feedback_norm = torch.clamp(_div(feedback, 0.98), 0.0, 1.0)
    high_end = torch.exp(1.35 * torch.log(torch.clamp(drive_norm, min=1e-30))) * (
        feedback_norm * feedback_norm)
    high_end = torch.where(drive_norm <= 0.0, 0.0, high_end)
    makeup = torch.exp(_FBWS_MAKEUP_LN * high_end)
    taming = 1.0 / (1.0 + comp_no_fb * feedback * 0.25)
    return torch.clamp(comp_no_fb * taming * makeup, max=3.0)


def fbws_fast_block_plain(x, env, prm, packed):
    """Plain version of the zero-feedback feedback waveshaper
    (pallas_fx.py:1071-1122): ``drive*x`` through the 4x tanh chain, the
    makeup gain on the detector's envelope, the bypass-gated DC blocker, the
    feedback filter stepped sample by sample, and the mix."""
    drive, feedback, fbc, mix = (prm[:, i:i + 1] for i in range(4))
    bypass = (mix <= 1e-4) | (drive <= 1.0)
    cs = torch.where(bypass, -1.0, fbws_gain(env, drive, feedback))
    dc, nst = ovs4_plain((x * drive).t(), packed[:FBWS_S_IN], lambda n, s: torch.tanh(s),
                         gated_dc(cs.t()))
    a_f = torch.where(bypass, 1.0, 1.0 - fbc)[:, 0]
    b_f = (1.0 - bypass.to(_F32)) * fbc * dc
    filt = packed[FBWS_S_IN]
    for n in range(x.shape[1]):
        filt = a_f * filt + b_f[:, n]
    filt = torch.where(filt.abs() < 1e-15, 0.0, filt)
    out = torch.where(bypass, x, x * (1.0 - mix) + dc * mix)
    return out, torch.cat([nst, filt[None]], dim=0)


def fbws_fast_block(x, env, prm, packed):
    """The feedback waveshaper's zero-feedback block on the stereo bus.

    ``x``: [2, B]; ``env``: [2, B] envelope of ``env_follower_block`` on
    ``x`` (``None`` in a ``bus_chain`` run: the detector phase's before it);
    ``prm``: [2, 4] per channel (drive, feedback, filter coefficient, mix),
    block scalars; ``packed``: [53, 2] from :func:`pack_fbws_fast`.
    Returns ``(out [2, B], nst [101, 2])`` for :func:`unpack_fbws_fast`."""
    if not _on_cuda("fbws_fast_block", x):
        return fbws_fast_block_plain(x, env, prm, packed)
    res = _launch_one("fbws_fast_block", x, (env, prm, packed), {})
    fbws_fast_block.launches += 1
    return res


fbws_fast_block.launches = 0


def pack_fbws_fast(state) -> torch.Tensor:
    """A ``[2]``-batched FBShaperState -> packed ``[53, 2]``: the fbws
    layout, then the feedback filter's state."""
    return torch.cat([pack_fbws_bank(state), state.filter_state[None]], dim=0)


def unpack_fbws_fast(nst, ovs):
    """Packed ``[101, 2]`` -> ``(OversamplerState, dc_x1, dc_y1, filter)``."""
    new_ovs, dc_x1, dc_y1 = unpack_fbws_bank(nst[:FBWS_S_OUT], SimpleNamespace(ovs=ovs))
    return new_ovs, dc_x1, dc_y1, nst[FBWS_S_OUT]


# --- 10. bus_chain --------------------------------------------------------------


def _run(x, phase, plain: bool):
    """One phase through its wrapper or its plain version -> ``(y, outputs
    after the signal)``."""
    fn = globals()[phase.name + ("_plain" if plain else "")]
    res = fn(x, *phase.args, **phase.kwargs)
    if phase.name in _PASSES_SIGNAL:
        return x, tuple(res)
    y, *aux = res
    return y, tuple(aux)


def _run_all(x, phases, plain: bool):
    y, outs = x, []
    for ph in phases:
        y, aux = _run(y, _with_env(ph, outs), plain)
        outs.append(aux)
    return y, outs


def bus_chain_plain(x, phases):
    """Plain version of a run of bus effects: each phase's plain version in
    order, on the signal the one before it left."""
    return _run_all(x, phases, plain=True)


def bus_chain(x, phases):
    """A run of bus effects in one launch (the counterpart of
    ``pallas_chain.chain_fused``).  ``x``: [2, B]; ``phases``: up to
    ``MAX_PHASES`` :class:`Phase` of the effect wrappers.  Returns
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
    signal)``; a detector phase passes ``x`` through."""
    return _run(x, phase, plain=False)


def run_phases(x, phases):
    """A run's phases through their own effects' wrappers one after the
    other: what ``bus_chain`` gives in one launch."""
    return _run_all(x, phases, plain=False)
