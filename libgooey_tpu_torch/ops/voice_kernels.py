"""The kit kernels: a small voice bank's whole block in two launches, each
beside its plain version.

Counterparts of the JAX package's merged Pallas call
``pallas_voice._mega_pallas`` (pallas_voice.py:671, ``pallas_call`` at 695),
which the kit runs twice a block:

===========  ===========================================================  =========
wrapper      replaces (the merged call; the family bodies it runs)         caller
===========  ===========================================================  =========
kit_sources  pallas_voice.py:671, the sources call: _kick_a_kernel 431,    ops/voice
             _snare_a_kernel 874, _hihat2_kernel 1439, _bass_kernel 1169,
             _tom2_kernel 1646
kit_drive    pallas_voice.py:671, the drive call: _kick_b_kernel 599,      ops/voice
             _snare_b_kernel 960
===========  ===========================================================  =========

A launch takes a list of :class:`VoicePhase`, one family each, as
``_mega_pallas`` takes one ``_Phase`` per family: the phase's name (the
family body) and its arguments.  ``kit_sources`` runs the families'
parameter smoothing, trigger latches, envelopes, oscillators, noise hashes
and the filters that stay inside the TPU bodies (the kick's click high-pass,
pink poles and noise SVF; hihat2's pink poles, phases, DF-I biquads, envelope
tracker and tone SVF; the bass's phases and 4x drive; tom2's phases and
rand~), ``kit_drive`` the kick's and the snare's 4x drive.  What the JAX
package runs between the two calls (the kick's envelope follower, the
snare's Chamberlin, the bass's swept SVF, tom2's resonators) stays on the
bank kernels, in :mod:`ops.voice`.

Dispatch as in :mod:`ops.bank_kernels`, with no fallback: a CUDA tensor
launches the hand-written kernel (``csrc/voice_kernels.cu``) or raises; a
CPU tensor takes the ``*_plain`` version.  The plain versions are written as
the Pallas bodies are, ``[V, B]`` elementwise math, with each recurrence
through the port's plain sample-sequential recurrences
(``bank_kernels.*_plain``).  ``kit_sources`` gives each voice row a
block that computes the per-sample stages on every thread and steps each
recurrence on one lane (the header of ``csrc/voice_kernels.cu``);
``kit_drive`` gives each voice row a block too, its 4x chain's up- and
down-walks on lanes of their own and the per-sample work on the other
warps, 32-sample chunks a step apart.  Both keep the per-sample op order
and give their plain versions bit for bit on the card.
The Pallas bodies solve the linear recurrences with log-depth lane scans,
so the JAX package and the port differ at scan-reassociation level (<= 6e-6
on the output at V = 5, tests/test_torch_kit_fused.py).  Every constant
division is a true division on both devices (``_div``): PyTorch on
the card turns a division by a Python number into a multiply by its
reciprocal.

All tensors are float32 unless named int32: ``off``/``trig``/``bs`` (the
trigger offsets, the last trigger sample and the block start, a 0-dim
tensor) and tom2's ``seg``.  ``powq`` is ``q^k``, k = 0..B, of the
smoothers' retention ``q`` (:func:`powq_table`); ``qB`` is ``q^B`` as the
JAX package rounds it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from libgooey_tpu_torch.core import rng
from libgooey_tpu_torch.ops import bank_kernels
from libgooey_tpu_torch.ops.bank_kernels import (
    _F32,
    _FBWS_COEFS,
    _TANH_HALF,
    FBWS_S_IN,
    FBWS_S_OUT,
    _check,
    _div,
    _host_floats,
    _launch,
    _on_cuda,
)
from libgooey_tpu_torch.ops.morph import TOM_IMPULSE
from libgooey_tpu_torch.ops.noise import DIRECT_GAIN, OUTPUT_GAIN, coefficients

KERNELS = ("kit_sources", "kit_drive")

SOURCES = {name: "libgooey_tpu_torch/csrc/voice_kernels.cu" for name in KERNELS}
REPLACES = {name: "libgooey_tpu/ops/pallas_voice.py:671" for name in KERNELS}

_I32 = torch.int32
SEED = rng.DEFAULT_SEED          # core/rng.py DEFAULT_SEED
RAND_SEED = 0x12345678           # ops/morph.py RAND_SEED
_TWO_PI = float(np.float32(2.0 * np.pi))
_PI = float(np.float32(np.pi))

#: parameter indices of each family (instruments/*.py PARAM_NAMES order)
KP = dict(frequency=0, punch=1, sub=2, click=3, oscillator_decay=4,
          pitch_envelope_amount=5, pitch_envelope_curve=6, volume=7,
          pitch_start_ratio=8, phase_mod_amount=9, noise_amount=10,
          noise_cutoff=11, noise_resonance=12, overdrive=13, feedback=14,
          feedback_cutoff=15, amp_decay=16, amp_decay_curve=17, tuning=18)
SP = dict(frequency=0, tonal=1, noise=2, brightness=3, decay=4, pitch_drop=5,
          volume=6, tonal_decay=7, tonal_decay_curve=8, noise_decay=9,
          noise_tail_decay=10, filter_cutoff=11, filter_resonance=12, xfade=13,
          phase_mod_amount=14, overdrive=15, amp_decay=16, amp_decay_curve=17,
          tuning=18)
BP = dict(frequency=0, sub_level=1, osc_level=2, detune_level=3, detune_amount=4,
          osc_shape=5, filter_cutoff=6, filter_resonance=7, filter_env_amount=8,
          filter_env_decay=9, filter_env_curve=10, amp_decay=11, amp_decay_curve=12,
          overdrive=13, volume=14, tuning=15)
HP = dict(pitch=0, decay=1, attack=2, tone=3, volume=4, tuning=5)
T2P = dict(tune=0, bend=1, tone=2, color=3, decay=4, membrane=5, membrane_q=6,
           volume=7, tuning=8)
#: latch columns of the kick, the snare and the bass (pallas_voice _LAT,
#: _SLAT, _BLAT); hihat2 latches its velocity only
KLAT = dict(velocity=0, pitch_mult=1, pitch_curve=2, amp_decay=3, amp_curve=4, pm_active=5)
SLAT = dict(velocity=0, pitch_mult=1, amp_curve=2, tonal_curve=3, amp_decay=4, pm_active=5)
BLAT = dict(velocity=0, trig_freq=1, amp_decay=2, amp_curve=3, fenv_decay=4, fenv_curve=5)
#: the kick's filter columns: click one-pole, noise SVF ic1/ic2, pink poles
KFST = dict(click=0, ic1=1, ic2=2, p0=3)


class VoicePhase(NamedTuple):
    """One family's part of a kit launch: the body's name (``kick_a``,
    ``snare_a``, ``hihat2``, ``bass``, ``tom2`` for :func:`kit_sources`;
    ``kick_b``, ``snare_b`` for :func:`kit_drive`), its tensor arguments in
    the order of its plain function and its keyword arguments."""

    name: str
    args: tuple
    kwargs: dict


@functools.lru_cache(maxsize=None)
def powq_table(q: float, B: int, device) -> torch.Tensor:
    """``q^k`` for k = 0..B, each the float64 power rounded once to float32
    (XLA's float32 ``power`` on the CPU), on ``device``, made once."""
    k = np.arange(B + 1, dtype=np.float64)
    return torch.as_tensor((np.float64(np.float32(q)) ** k).astype(np.float32),
                           device=device)


@functools.lru_cache(maxsize=None)
def _seed_mix(seed: int) -> int:
    """The seed half of the counter hash, as ``rng.hash2`` folds it."""
    s = (seed * 0x9E3779B9 + 0x85EBCA6B) & 0xFFFFFFFF
    return int(rng.mix32(torch.tensor(s, dtype=torch.int64)))


# --- plain-version helpers ------------------------------------------------------


def _lin(a, b, y0):
    """``y[n] = a[n]*y[n-1] + b[n]`` through the plain ``affine1_bank``."""
    a, b = torch.broadcast_tensors(a, b)
    y, _ = bank_kernels.affine1_bank_plain(None, a.contiguous(), b.contiguous(),
                                           y0.contiguous())
    return y


def _shift(x, x0):
    """``x`` delayed one sample, ``x0`` [V] first."""
    return torch.cat([x0[:, None], x[:, :-1]], dim=1)


def _denorm(x, lo, hi):
    return lo + torch.clamp(x, 0.0, 1.0) * (hi - lo)


def _curve(p, c):
    """EnvelopeCurve::apply: ``max(p, 0) ** clip(c, 0.1, 10)``; a constant
    curve of 1 is the identity, as XLA folds it."""
    p = torch.clamp(p, min=0.0)
    if isinstance(c, torch.Tensor):
        return torch.pow(p, torch.clamp(c, 0.1, 10.0))
    return p if c == 1.0 else torch.pow(p, c)


def _adsr(el, attack: float, decay, sustain: float, acurve, dcurve):
    """Time-based ADSR amplitude, no release (pallas_voice._adsr_amp)."""
    attack_amp = _curve(_div(el, attack), acurve)
    d = el - attack
    decay_prog = _curve(_div(d, decay) if isinstance(decay, float) else d / decay, dcurve)
    decay_amp = 1.0 - (1.0 - sustain) * decay_prog
    held = torch.where(el < attack, attack_amp,
                       torch.where(el < attack + decay, decay_amp, sustain))
    return torch.where(el >= 0.0, held, 0.0)


def _phase_mod_env(el, active):
    rise = torch.pow(torch.clamp(_div(el, 0.001), min=0.0), 0.3)
    fall = 1.0 - torch.pow(torch.clamp(_div(el - 0.001, 0.005), min=0.0), 0.4)
    env = torch.where(el < 0.001, rise, fall)
    return torch.where((el >= 0.0) & (el <= 0.006) & active, env, 0.0)


def _tuning_mult(traj):
    return torch.exp2(((torch.clamp(traj, 0.0, 1.0) - 0.5) * 24.0) * (1.0 / 12.0))


def _white(counter, seed=SEED):
    return rng.white(counter, seed)


def _remainder1(x):
    return torch.remainder(x, 1.0)


def _phase(inc, reset_f, carry):
    """Mod-1 phase accumulator with trigger resets (pallas_voice
    ``_phase_cumsum_reset``, the split-increment form)."""
    B = inc.shape[1]
    n1 = torch.arange(1, B + 1, dtype=_F32, device=inc.device)[None, :]
    inc0 = inc[:, 0:1]
    hi = torch.floor(inc0 * 2048.0) * float(np.float32(1.0 / 2048.0))
    lo = inc0 - hi
    ramp_hi = hi * n1
    ramp_hi = ramp_hi - torch.floor(ramp_hi)
    ramp = ramp_hi + lo * n1
    resid = _lin(torch.ones_like(inc), inc - inc0, torch.zeros_like(inc0[:, 0]))
    p = _remainder1(ramp + resid)
    base = _lin(1.0 - reset_f, reset_f * _shift(p, torch.zeros_like(p[:, 0])), -carry)
    return _remainder1(p - base)


def _max_curve_consts(curve: float):
    """``(fp, expm1(fp))`` of max_curve's one-sided exponential, float32
    (pallas_voice ``_max_curve``'s static scalar math)."""
    hp = ((abs(curve) + 1e-20) * 1.2) ** 0.41 * 0.91
    fp = np.float32(hp / (1.0 - hp))
    return float(fp), float(np.float32(np.expm1(float(fp))))


def _max_curve(p, curve: float):
    """Max/MSP curve~ with ``exp(x) - 1`` (pallas_voice ``_max_curve``)."""
    p = torch.clamp(p, 0.0, 1.0)
    fp, den = _max_curve_consts(curve)

    def one_sided(q):
        return _div(torch.exp(fp * q) - 1.0, den)

    return 1.0 - one_sided(1.0 - p) if curve < 0.0 else one_sided(p)


class _Ctx:
    """One block's trigger, latch and trajectory context for a bank of V
    rows, single-trigger mode (pallas_voice ``_Ctx``)."""

    def __init__(self, cur, tgt, off, trig, bs, powq, sr):
        B = powq.shape[0] - 1
        n = torch.arange(B, dtype=_I32, device=off.device)[None, :]
        self.cur, self.tgt = cur, tgt
        self.off = off[:, None]
        self.has = self.off < B
        self.after = (n >= self.off) & self.has
        self.at_trig = (n == self.off) & self.has
        self.pq = powq[1:][None, :]
        self.qoff = powq[torch.clamp(off, 0, B).long()][:, None]
        self.bs = bs
        self.trig = trig
        trig_eff = torch.where(self.after, bs + self.off, trig[:, None])
        self.elapsed_i = (bs + n) - trig_eff
        self.idx_f = self.elapsed_i.to(_F32)
        self.elapsed = self.idx_f * float(np.float32(1.0 / sr))

    def ptraj(self, i):
        c, t = self.cur[:, i:i + 1], self.tgt[:, i:i + 1]
        d = (c - t) * self.pq
        return t + torch.where(d.abs() < 1e-4, 0.0, d)

    def vat(self, i):
        c, t = self.cur[:, i:i + 1], self.tgt[:, i:i + 1]
        d = (c - t) * self.qoff
        return t + torch.where(d.abs() < 1e-4, 0.0, d)

    def eff(self, new, old_col):
        return torch.where(self.after, new, old_col)

    def latch(self, new, old_col):
        return torch.where(self.has, new, old_col)

    def advance(self, qB: float):
        d = (self.cur - self.tgt) * qB
        return self.tgt + torch.where(d.abs() < 1e-4, 0.0, d)

    def new_trig(self):
        return torch.where(self.has[:, 0], self.bs + self.off[:, 0], self.trig)


def _sine(idx_f, freq, sr):
    return torch.sin(idx_f * freq * float(np.float32(2.0 * np.pi / sr)))


def _triangle(idx_f, freq, sr, max_harmonics):
    return bank_kernels.triangle_additive_bank_plain(idx_f, freq, sr, max_harmonics)


def _svf_gh(cutoff, sr, inv_q):
    """TPT SVF coefficients from a clipped cutoff: ``g = tan(pi*fc/sr)``,
    ``h = 1/(1 + r*g + g*g)``."""
    g = torch.tan(_div(_PI * cutoff, sr))
    return g, 1.0 / (1.0 + inv_q * g + g * g)


# --- kit_sources: the family bodies ---------------------------------------------


def kick_a_plain(cur, tgt, off, vel, trig, lat, fst, bs, powq, *, sample_rate, qB,
                 max_harmonics):
    """Plain version of the kick's sources body (pallas_voice.py:431-593).
    Returns ``(total, ampsc [V, B], ncur [V, 19], nlat [V, 6], ntrig [V],
    nfst [V, 6])``."""
    sr = sample_rate
    c = _Ctx(cur, tgt, off, trig, bs, powq, sr)
    vel_new = torch.clamp(vel, 0.0, 1.0)[:, None]
    pea = c.vat(KP["pitch_envelope_amount"])
    psr = _denorm(c.vat(KP["pitch_start_ratio"]), 1.0, 10.0)
    pitch_mult_new = 1.0 + (psr - 1.0) * pea
    pc = _denorm(c.vat(KP["pitch_envelope_curve"]), 0.1, 4.0)
    pitch_curve_new = torch.where((pc - 1.0).abs() < 0.01, 1.0, pc)
    decay_scale_new = 1.0 - 0.5 * vel_new * vel_new
    ad = _denorm(c.vat(KP["amp_decay"]), 0.0, 4.0) * decay_scale_new
    ac = _denorm(c.vat(KP["amp_decay_curve"]), 0.1, 10.0)
    amp_curve_new = torch.where((ac - 1.0).abs() < 0.01, 1.0, ac)
    pm_active_new = (c.vat(KP["phase_mod_amount"]) > 0.001).to(_F32)
    news = (vel_new, pitch_mult_new, pitch_curve_new, ad, amp_curve_new, pm_active_new)
    vel_e, pitch_mult, pitch_curve, amp_decay_s, amp_curve, pm_active = (
        c.eff(v, lat[:, i:i + 1]) for i, v in enumerate(news))
    el, idx_f = c.elapsed, c.idx_f

    decay_scale = 1.0 - 0.5 * vel_e * vel_e
    base_decay = _denorm(c.ptraj(KP["oscillator_decay"]), 0.01, 4.0) * decay_scale
    base_freq = _denorm(c.ptraj(KP["frequency"]), 30.0, 120.0) * _tuning_mult(
        c.ptraj(KP["tuning"]))
    pitch_env = _adsr(el, 0.001, base_decay, 0.0, 1.0, pitch_curve)
    fmult = 1.0 + (pitch_mult - 1.0) * pitch_env
    pm_amt = c.ptraj(KP["phase_mod_amount"])
    pm_env = _phase_mod_env(el, pm_active > 0.5)
    fmult = fmult * torch.where(pm_amt > 0.001, 1.0 + pm_env * pm_amt * 2.0, 1.0)

    osc_env = _adsr(el, 0.001, base_decay, 0.0, 1.0, 1.0)
    sub_out = _sine(idx_f, base_freq * fmult, sr) * osc_env * c.ptraj(KP["sub"])
    if max_harmonics > 0:
        punch_out = (_triangle(idx_f, base_freq * 2.5 * fmult, sr, max_harmonics)
                     * osc_env * (c.ptraj(KP["punch"]) * 0.7))
    else:
        punch_out = torch.zeros_like(sub_out)

    click_env = _adsr(el, 0.001, base_decay * 0.2, 0.0, 1.0, 1.0)
    click_vel_scale = 0.6 + 0.4 * vel_e
    click_white = _white(torch.floor(idx_f).to(_I32))
    pink_white = _white(c.elapsed_i)
    click_raw = click_white * click_env * (c.ptraj(KP["click"]) * 0.15 * click_vel_scale)
    alpha = np.float32(1.0 - np.exp(-2.0 * np.pi * 8000.0 / sr))
    A = torch.where(c.at_trig, 0.0, float(np.float32(1.0 - alpha)))
    y0 = fst[:, KFST["click"]]
    click_y = _lin(A, float(alpha) * click_raw, y0)
    s_prev = torch.where(c.at_trig, 0.0, _shift(click_y, y0))
    click_out = (click_raw - s_prev) * float(np.float32(1.0 + 4.0 * 0.1))

    poles, gains = coefficients(sr)
    ys = [_lin(torch.where(c.at_trig, 0.0, float(poles[i])), float(gains[i]) * pink_white,
               fst[:, KFST["p0"] + i]) for i in range(3)]
    pink = (ys[0] + ys[1] + ys[2] + pink_white * DIRECT_GAIN) * OUTPUT_GAIN

    noise_cut = _denorm(c.ptraj(KP["noise_cutoff"]), 20.0, 10_000.0)
    noise_res = _denorm(c.ptraj(KP["noise_resonance"]), 0.0, 5.0)
    cutoff = torch.clamp(noise_cut, 20.0, min(20_000.0, sr * 0.45))
    g, h = _svf_gh(cutoff, sr, 1.0 / torch.clamp(noise_res, 0.5, 10.0))
    _v1, v2, ic1, ic2 = bank_kernels.svf_bank_plain(
        pink, g, h, c.at_trig, fst[:, KFST["ic1"]], fst[:, KFST["ic2"]])
    noise_filtered = torch.where(v2.abs() < 1e-15, 0.0, v2)
    noise_amt = c.ptraj(KP["noise_amount"])
    noise_out = torch.where(noise_amt > 0.001, noise_filtered * osc_env * noise_amt * 0.5, 0.0)

    total = sub_out + punch_out + click_out + noise_out
    dmax = torch.clamp(amp_decay_s, min=0.001)
    amp_env = _adsr(el, 0.001, dmax, 0.0, 0.5, amp_curve)
    ampsc = amp_env * torch.sqrt(vel_e) * c.ptraj(KP["volume"])

    nlat = torch.cat([c.latch(v, lat[:, i:i + 1]) for i, v in enumerate(news)], dim=1)
    nfst = torch.stack([click_y[:, -1], ic1, ic2] + [y[:, -1] for y in ys], dim=1)
    return total, ampsc, c.advance(qB), nlat, c.new_trig(), nfst


def snare_a_plain(cur, tgt, off, vel, trig, lat, bs, powq, *, sample_rate, qB,
                  max_harmonics):
    """Plain version of the snare's sources body (pallas_voice.py:874-957):
    the tonal and crack layers and the noise before its Chamberlin.
    Returns ``(dry, nraw [V, B], ncur [V, 19], nlat [V, 6], ntrig [V])``."""
    sr = sample_rate
    c = _Ctx(cur, tgt, off, trig, bs, powq, sr)
    vel_new = torch.clamp(vel, 0.0, 1.0)[:, None]
    decay_scale_new = 1.0 - 0.45 * vel_new * vel_new
    pitch_mult_new = 1.0 + c.vat(SP["pitch_drop"]) * 1.5
    tc = _denorm(c.vat(SP["tonal_decay_curve"]), 0.1, 10.0)
    ad = _denorm(c.vat(SP["amp_decay"]), 0.0, 4.0) * decay_scale_new
    ac = _denorm(c.vat(SP["amp_decay_curve"]), 0.1, 10.0)
    pm_active_new = (c.vat(SP["phase_mod_amount"]) > 0.001).to(_F32)

    vel_e = c.eff(vel_new, lat[:, 0:1])
    pitch_mult = c.eff(pitch_mult_new, lat[:, 1:2])
    tonal_curve = c.eff(tc, lat[:, 3:4])
    pm_active = c.eff(pm_active_new, lat[:, 5:6])
    el, idx_f = c.elapsed, c.idx_f

    vel2 = vel_e * vel_e
    decay_scale = 1.0 - 0.45 * vel2
    pitch_decay_scale = 1.0 - 0.5 * vel2
    scaled_decay = _denorm(c.ptraj(SP["decay"]), 0.05, 3.5) * decay_scale
    pitch_decay = torch.minimum(scaled_decay * 0.3 * pitch_decay_scale, scaled_decay * 0.25)
    base_freq = _denorm(c.ptraj(SP["frequency"]), 100.0, 600.0) * _tuning_mult(
        c.ptraj(SP["tuning"]))
    pitch_env = _adsr(el, 0.001, pitch_decay, 0.0, 1.0, 1.0)
    fmult = 1.0 + (pitch_mult - 1.0) * pitch_env
    pm_amt = c.ptraj(SP["phase_mod_amount"])
    pm = _phase_mod_env(el, pm_active > 0.5)
    fmult = fmult * torch.where(pm_amt > 0.001, 1.0 + pm * pm_amt * 1.0, 1.0)
    hold_env = _adsr(el, 0.001, 0.001, 1.0, 1.0, 1.0)

    if max_harmonics > 0:
        tonal_raw = _triangle(idx_f, base_freq * fmult, sr, max_harmonics)
    else:
        tonal_raw = _sine(idx_f, base_freq * fmult, sr)
    tonal_env = _adsr(el, 0.001, _denorm(c.ptraj(SP["tonal_decay"]), 0.0, 3.5) * decay_scale,
                      0.0, 1.0, tonal_curve)
    xfade = c.ptraj(SP["xfade"])
    tonal_out = tonal_raw * hold_env * c.ptraj(SP["tonal"]) * tonal_env * (1.0 - xfade)

    white = _white(torch.floor(idx_f).to(_I32))
    nraw = white * hold_env * (c.ptraj(SP["noise"]) * 0.8)
    crack_env = _adsr(el, 0.001, scaled_decay * 0.2, 0.0, 1.0, 1.0)
    crack_out = (white * crack_env) * (c.ptraj(SP["brightness"]) * 0.4 * (0.7 + 0.3 * vel_e))
    dry = tonal_out + crack_out

    news = (vel_new, pitch_mult_new, ac, tc, ad, pm_active_new)   # SLAT order
    nlat = torch.cat([c.latch(v, lat[:, i:i + 1]) for i, v in enumerate(news)], dim=1)
    return dry, nraw, c.advance(qB), nlat, c.new_trig()


def _poly_blep(t, dt):
    dt = torch.clamp(dt, min=1e-12)
    early = t / dt
    late = (t - 1.0) / dt
    return torch.where(t < dt, 2.0 * early - early * early - 1.0,
                       torch.where(t > 1.0 - dt, late * late + 2.0 * late + 1.0, 0.0))


def bass_plain(cur, tgt, off, vel, nf, trig, lat, ph, packed, bs, powq, *, sample_rate, qB):
    """Plain version of the bass body (pallas_voice.py:1169-1263):
    oscillators, bleps, the 4x drive, the swept filter's trajectories and
    the amplitude scale.  Returns ``(satur, cut, res, ampsc [V, B], ncur
    [V, 16], nlat [V, 6], ntrig [V], nph [V, 3], nst [100, V])``."""
    sr = sample_rate
    c = _Ctx(cur, tgt, off, trig, bs, powq, sr)
    vel_new = torch.clamp(vel, 0.0, 1.0)[:, None]
    freq_new = _denorm(c.vat(BP["frequency"]), 30.0, 200.0)
    freq_new = torch.where(nf[:, None] > 0.0, nf[:, None], freq_new)
    ad_new = _denorm(c.vat(BP["amp_decay"]), 0.05, 4.0)
    ac_new = _denorm(c.vat(BP["amp_decay_curve"]), 0.1, 10.0)
    fd_new = _denorm(c.vat(BP["filter_env_decay"]), 0.01, 2.0)
    fc_new = _denorm(c.vat(BP["filter_env_curve"]), 0.1, 8.0)
    news = (vel_new, freq_new, ad_new, ac_new, fd_new, fc_new)
    vel_e, freq0, ad, ac, fd, fc = (c.eff(v, lat[:, i:i + 1]) for i, v in enumerate(news))
    el = c.elapsed
    reset_f = c.at_trig.to(_F32)

    freq = freq0 * _tuning_mult(c.ptraj(BP["tuning"]))
    detune_cents = _denorm(c.ptraj(BP["detune_amount"]), 0.0, 30.0)
    det_freq = freq * torch.exp2(_div(detune_cents, 1200.0))
    inc = _div(freq, sr)
    det_inc = _div(det_freq, sr)
    sub_phase = _phase(inc, reset_f, ph[:, 0])
    osc_phase = _phase(inc, reset_f, ph[:, 1])
    det_phase = _phase(det_inc, reset_f, ph[:, 2])

    sub_out = torch.sin(sub_phase * _TWO_PI)
    shape = c.ptraj(BP["osc_shape"])

    def blep_pair(phase, dt):
        saw = (2.0 * phase - 1.0) - _poly_blep(phase, dt)
        naive_sq = torch.where(phase < 0.5, 1.0, -1.0)
        sq = naive_sq + _poly_blep(phase, dt) - _poly_blep(_remainder1(phase + 0.5), dt)
        return saw, sq

    saw_m, sq_m = blep_pair(osc_phase, inc)
    saw_d, sq_d = blep_pair(det_phase, det_inc)
    osc_out = saw_m * (1.0 - shape) + sq_m * shape
    det_out = saw_d * (1.0 - shape) + sq_d * shape
    mix = (sub_out * c.ptraj(BP["sub_level"]) + osc_out * c.ptraj(BP["osc_level"])
           + det_out * c.ptraj(BP["detune_level"]))

    od = c.ptraj(BP["overdrive"])
    drive = 1.0 + od * 9.0
    sat, nst = bank_kernels.ws4_bank_plain(mix, drive, packed)
    ws_out = torch.where(drive <= 1.0, mix, sat)
    ws_out = torch.where(torch.isfinite(mix), ws_out, 0.0)
    satur = torch.where(od > 0.001, ws_out, mix)

    fenv = _adsr(el, 0.001, fd, 0.0, 1.0, fc)
    base_cutoff = 20.0 * torch.pow(float(np.float32(18_000.0 / 20.0)),
                                   torch.clamp(c.ptraj(BP["filter_cutoff"]), 0.0, 1.0))
    env_offset = (18_000.0 - base_cutoff) * c.ptraj(BP["filter_env_amount"]) * fenv
    cut = torch.clamp(base_cutoff + env_offset, 20.0, 18_000.0)
    res = _denorm(c.ptraj(BP["filter_resonance"]), 0.5, 15.0)
    amp_env = _adsr(el, 0.002, ad, 0.0, 1.0, ac)
    ampsc = amp_env * torch.sqrt(vel_e) * c.ptraj(BP["volume"])

    nlat = torch.cat([c.latch(v, lat[:, i:i + 1]) for i, v in enumerate(news)], dim=1)
    nph = torch.stack([sub_phase[:, -1], osc_phase[:, -1], det_phase[:, -1]], dim=1)
    return satur, cut, res, ampsc, c.advance(qB), nlat, c.new_trig(), nph, nst


def _biquad_df1(x, coeffs, reset_f, x1, x2, y1, y2):
    """DF-I biquad with trigger resets (pallas_voice ``_biquad_df1``), its
    feedback side through the plain ``linrec2_bank``.  Returns ``(out,
    (x1', x2', y1', y2'))``."""
    b0, b1, b2, a1, a2 = coeffs
    x_prev1 = _shift(x, x1)
    x_prev2 = _shift(x_prev1, x2)
    keepm = 1.0 - reset_f
    reset_prev = _shift(reset_f, torch.zeros_like(x1))
    x_prev1 = x_prev1 * keepm
    x_prev2 = x_prev2 * keepm * (1.0 - reset_prev)
    w = b0 * x + b1 * x_prev1 + b2 * x_prev2
    zeros = torch.zeros_like(w)
    s1, s2, l1, l2 = bank_kernels.linrec2_bank_plain(
        (-a1 * keepm).contiguous(), (-a2 * keepm).contiguous(), keepm.contiguous(), zeros,
        w.contiguous(), zeros, y1, y2)
    out = torch.where(s1.abs() < 1e-15, 0.0, s1)
    return out, (x[:, -1], x_prev1[:, -1], l1, l2)


def hihat2_plain(cur, tgt, off, vel, trig, lat, color, slope, ph, hpf, svf, pink, salt, bs,
                 powq, *, sample_rate, qB):
    """Plain version of the hihat2 body (pallas_voice.py:1439-1549).
    Returns ``(out [V, B], ncur [V, 6], nlat [V, 1], ntrig [V], nph [V, 3],
    nhpf [V, 8], nsvf [V, 2], npink [V, 3])``."""
    sr = sample_rate
    c = _Ctx(cur, tgt, off, trig, bs, powq, sr)
    vel_new = torch.clamp(vel, 0.0, 1.0)[:, None]
    vel_e = c.eff(vel_new, lat[:, 0:1])
    el = c.elapsed
    reset_f = c.at_trig.to(_F32)

    attack_s = _denorm(c.ptraj(HP["attack"]), 0.5, 200.0) * 0.001
    decay_s = _denorm(c.ptraj(HP["decay"]), 0.5, 4000.0) * 0.001
    pn = c.ptraj(HP["pitch"])
    pitch_hz = _denorm(pn * pn, 3500.0, 10_000.0) * _tuning_mult(c.ptraj(HP["tuning"]))

    B = powq.shape[0] - 1
    n_glob = bs + torch.arange(B, dtype=_I32, device=off.device)[None, :]
    white = _white(rng.add_mul32(n_glob, salt[:, None], 0x9E3779B9))
    poles, gains = coefficients(sr)
    pwhite = _white(n_glob)
    ys = [_lin(torch.full_like(pwhite, float(poles[i])), float(gains[i]) * pwhite, pink[:, i])
          for i in range(3)]
    pinkn = (ys[0] + ys[1] + ys[2] + pwhite * DIRECT_GAIN) * OUTPUT_GAIN
    noise_sig = torch.where(color[:, None] == 1, pinkn, white)

    mod_inc = _div(pitch_hz * 0.1, sr)
    main_inc = _div(pitch_hz, sr)
    mod_phase = _phase(mod_inc, reset_f, ph[:, 0])
    main_phase = _phase(main_inc, reset_f, ph[:, 1])
    mod_out = torch.sin(_TWO_PI * _remainder1(mod_phase + noise_sig * 0.25))
    main_out = torch.sin(_TWO_PI * _remainder1(main_phase + mod_out * 0.75))

    omega = _div(_TWO_PI * pitch_hz, sr)
    sin_o, cos_o = torch.sin(omega), torch.cos(omega)
    alpha = _div(sin_o, 2.0)
    a0 = 1.0 + alpha
    hb0 = _div(1.0 + cos_o, 2.0) / a0
    coeffs = (hb0, -(1.0 + cos_o) / a0, _div(1.0 + cos_o, 2.0) / a0, -2.0 * cos_o / a0,
              (1.0 - alpha) / a0)
    y1, st1 = _biquad_df1(main_out, coeffs, reset_f, *(hpf[:, i] for i in range(4)))
    y2, st2 = _biquad_df1(y1, coeffs, reset_f, *(hpf[:, i] for i in range(4, 8)))
    filtered = torch.where(slope[:, None] == 1, y2 * 0.8, y1)

    attack_prog = torch.where(attack_s > 0, el / torch.clamp(attack_s, min=1e-9), 1.0)
    decay_prog = torch.where(decay_s > 0, (el - attack_s) / torch.clamp(decay_s, min=1e-9), 1.0)
    env_raw = torch.where(el < attack_s, _max_curve(attack_prog, -0.3),
                          1.0 - _max_curve(torch.clamp(decay_prog, 0.0, 1.0), -0.8))
    env_raw = torch.where(el < 0.0, 0.0, env_raw)
    down = np.float32(1.0 - np.exp(-1.0 / 100.0))
    bmul = torch.where(c.at_trig, 0.0, float(np.float32(1.0 - down)))
    env = bank_kernels.affine1_bank_plain(env_raw, bmul.contiguous(),
                                          (float(down) * env_raw).contiguous(), ph[:, 2])[0]
    output = filtered * env * vel_e * 0.35

    tone_hz = _denorm(c.ptraj(HP["tone"]), 500.0, 10_000.0)
    g, h = _svf_gh(torch.clamp(tone_hz, 20.0, sr * 0.45), sr, 2.0)
    v1, v2, ic1, ic2 = bank_kernels.svf_bank_plain(output, g, h, c.at_trig, svf[:, 0], svf[:, 1])
    out = (output - (2.0 * v1 + v2)) * c.ptraj(HP["volume"])

    nph = torch.stack([mod_phase[:, -1], main_phase[:, -1], env[:, -1]], dim=1)
    return (out, c.advance(qB), c.latch(vel_new, lat[:, 0:1]), c.new_trig(), nph,
            torch.stack(st1 + st2, dim=1), torch.stack([ic1, ic2], dim=1),
            torch.stack([y[:, -1] for y in ys], dim=1))


def tom2_plain(par, off, trig, dec, ph, seg, bs, *, sample_rate, B, triangle_enabled):
    """Plain version of tom2's sources body (pallas_voice.py:1646-1810): the
    MaxCurve envelope, the bent pitch, the click, the triangle and the morph
    oscillator with rand~.  Returns ``(mixed, env, done, fade, freq [V, B],
    ntrig [V], ndec [V], nph [V, 6], nseg [V] int32)``."""
    sr = sample_rate
    n = torch.arange(B, dtype=_I32, device=off.device)[None, :]
    off_c = off[:, None]
    has = off_c < B
    after = (n >= off_c) & has
    reset_f = ((n == off_c) & has).to(_F32)
    trig_eff = torch.where(after, bs + off_c, trig[:, None])
    elapsed_i = (bs + n) - trig_eff
    el = elapsed_i.to(_F32) * float(np.float32(1.0 / sr))

    def p(name):
        return par[:, T2P[name]:T2P[name] + 1]

    decay_new = (0.5 + _div(p("decay"), 100.0) * (4000.0 - 0.5)) * 0.001
    decay_s = torch.where(after, decay_new, dec[:, None])
    env = torch.where(el < 0.001, _max_curve(_div(el, 0.001), 0.8),
                      1.0 - _max_curve(torch.clamp((el - 0.001) / decay_s, 0.0, 1.0), -0.83))
    env = torch.where(el < 0.0, 0.0, env)
    env_complete = el >= (0.001 + decay_s)

    tn = _div(p("tune"), 100.0)
    base_freq = (40.0 + tn * tn * (600.0 - 40.0)) * _tuning_mult(p("tuning"))
    bend_scaled = _div(p("bend"), 100.0) * 2.0
    raw_freq = base_freq * (1.0 + torch.square(env * bend_scaled))
    past_attack = (el >= 0.001) | (env > 0.9)
    main_done = env_complete | (past_attack & (raw_freq < 20.0))
    fade = torch.where(past_attack & (raw_freq < 40.0), _div(raw_freq - 20.0, 40.0 - 20.0), 1.0)
    freq = torch.clamp(raw_freq, min=40.0)

    table = torch.as_tensor(TOM_IMPULSE, device=off.device)
    ki = elapsed_i.to(torch.int64)
    click = torch.where((ki >= 0) & (ki < 64), table[torch.clamp(ki, 0, 63)], 0.0)
    click_out = click * 1.1

    inc = _div(freq, sr)
    tri_phase = _phase(inc, reset_f, ph[:, 0])

    def tri_wave(t):
        return torch.where(t < 0.5, 4.0 * t - 1.0, 3.0 - 4.0 * t)

    def used(phase, step):
        return _remainder1(phase - step)

    tri_out = tri_wave(used(tri_phase, inc)) * 0.5 if triangle_enabled else torch.zeros_like(el)

    tone = p("tone") + torch.zeros_like(env)
    mix_control = _div(p("tone"), 100.0) * 2.0 - 1.0
    color_midi = 30.0 + _div(p("color"), 100.0) * 20.0
    cf1 = 440.0 * torch.exp2(_div(color_midi - 69.0, 12.0))
    m_main = _phase(inc, reset_f, ph[:, 1])
    m_tri = _phase(inc, reset_f, ph[:, 2])
    fixed = float(np.float32(190.0 / sr))
    m_fixed = _phase(torch.full_like(inc, fixed), reset_f, ph[:, 3])
    m_gated = _phase(inc, reset_f, ph[:, 4])
    main_sine = torch.sin(_TWO_PI * used(m_main, inc)) * 0.5
    tri_m = tri_wave(used(m_tri, inc)) * 0.5
    fixed_sine = torch.sin(_TWO_PI * used(m_fixed, fixed)) * 0.5
    gated_sine = torch.where(tone < 99.0, torch.sin(_TWO_PI * used(m_gated, inc)) * 0.2, 0.0)
    white = _white(elapsed_i) * 0.2

    rand_freq = 440.0 * torch.exp2(_div(cf1 - 69.0, 12.0))
    inc_r = _div(rand_freq, sr) + torch.zeros_like(env)
    n1 = torch.arange(1, B + 1, dtype=_F32, device=off.device)[None, :]
    inc0 = inc_r[:, 0:1]
    hi = _div(torch.floor(inc0 * 2048.0), 2048.0)
    lo = inc0 - hi
    p_r = (hi * n1 + lo * n1) + _lin(torch.ones_like(inc_r), inc_r - inc0,
                                     torch.zeros_like(inc0[:, 0]))
    base_r = _lin(1.0 - reset_f, reset_f * _shift(p_r, torch.zeros_like(p_r[:, 0])), -ph[:, 5])
    total = p_r - base_r
    seg_local = torch.floor(total)
    frac = total - seg_local
    segs = torch.where(after, 0, seg[:, None]) + seg_local.to(_I32)
    tgt_r = torch.where(segs >= 1, _white(segs, RAND_SEED), 0.0)
    cur_r = torch.where(segs >= 2, _white(segs - 1, RAND_SEED), 0.0)
    rand_value = cur_r + (tgt_r - cur_r) * frac

    noise_combined = (white + rand_value) * 0.4
    ch1 = main_sine * fixed_sine
    ch2 = tri_m + noise_combined
    ch3 = noise_combined + gated_sine
    w1 = torch.clamp(-mix_control, 0.0, 1.0)
    w2 = torch.clamp(1.0 - mix_control.abs(), 0.0, 1.0)
    w3 = torch.clamp(mix_control, 0.0, 1.0)
    mixed = click_out + tri_out + (ch1 * w1 + ch2 * w2 + ch3 * w3)

    ntrig = torch.where(has[:, 0], bs + off, trig)
    ndec = torch.where(has[:, 0], decay_new[:, 0], dec)
    nph = torch.stack([_remainder1(tri_phase[:, -1]), m_main[:, -1], m_tri[:, -1],
                       m_fixed[:, -1], m_gated[:, -1], frac[:, -1]], dim=1)
    return (mixed, env, main_done.to(_F32), fade, freq, ntrig, ndec, nph, segs[:, -1])


# --- kit_drive: the kick's and the snare's 4x drive ------------------------------


def kick_b_plain(total, comp_signed, ampsc, cur, tgt, packed, filt0, powq, *, sample_rate):
    """Plain version of the kick's drive body (pallas_voice.py:599-638):
    ``drive*x`` through the 4x tanh chain, the signed makeup gain
    (``comp_signed < 0`` marks a bypassed sample), the gated DC blocker,
    the feedback filter's bookkeeping and the amplitude scale.  Returns
    ``(out [V, B], nst [100, V], nfilt [V])``; ``packed`` is
    ``bank_kernels.pack_fbws_bank``'s layout."""
    sr = sample_rate
    pq = powq[1:][None, :]

    def ptraj(i):
        d = (cur[:, i:i + 1] - tgt[:, i:i + 1]) * pq
        return tgt[:, i:i + 1] + torch.where(d.abs() < 1e-4, 0.0, d)

    od = ptraj(KP["overdrive"])
    drive = 1.0 + od * od * od * 40.0
    fbc_hz = 200.0 + ptraj(KP["feedback_cutoff"]) * 3800.0
    fbc = torch.clamp(1.0 - torch.exp(_div(-2.0 * np.pi * fbc_hz, sr)), 0.0, 0.9)
    bypass = comp_signed < 0.0
    dc, nst = bank_kernels.fbws_bank_plain((drive * total).contiguous(), comp_signed, packed)
    filt = _lin(torch.where(bypass, 1.0, 1.0 - fbc), torch.where(bypass, 0.0, fbc * dc), filt0)
    filt = torch.where(filt.abs() < 1e-15, 0.0, filt)
    out = torch.where(bypass, total, dc) * ampsc
    return out, nst, filt[:, -1]


def snare_b_plain(cur, tgt, off, vel, trig, lat, dry, filt, packed, bs, powq, *, sample_rate):
    """Plain version of the snare's drive body (pallas_voice.py:960-1000):
    the noise envelopes on the filtered noise, the 4x waveshaper at ``1 +
    9*overdrive`` and the amplitude envelope.  Returns ``(out [V, B], nst
    [100, V])``; ``packed`` is ``bank_kernels.pack_ws4_bank``'s layout."""
    sr = sample_rate
    c = _Ctx(cur, tgt, off, trig, bs, powq, sr)
    vel_new = torch.clamp(vel, 0.0, 1.0)[:, None]
    vel_e = c.eff(vel_new, lat[:, SLAT["velocity"]:SLAT["velocity"] + 1])
    ad = _denorm(c.vat(SP["amp_decay"]), 0.0, 4.0) * (1.0 - 0.45 * vel_new * vel_new)
    ac = _denorm(c.vat(SP["amp_decay_curve"]), 0.1, 10.0)
    amp_decay_s = c.eff(ad, lat[:, SLAT["amp_decay"]:SLAT["amp_decay"] + 1])
    amp_curve = c.eff(ac, lat[:, SLAT["amp_curve"]:SLAT["amp_curve"] + 1])
    el = c.elapsed
    decay_scale = 1.0 - 0.45 * vel_e * vel_e
    noise_env = _adsr(el, 0.001, _denorm(c.ptraj(SP["noise_decay"]), 0.0, 3.5) * decay_scale,
                      0.0, 1.0, 1.0)
    tail_env = _adsr(el, 0.001,
                     _denorm(c.ptraj(SP["noise_tail_decay"]), 0.0, 3.5) * decay_scale,
                     0.0, 1.0, 1.0)
    xfade = c.ptraj(SP["xfade"])
    total = dry + filt * (noise_env * 0.7 + tail_env * 0.3) * xfade
    drive = 1.0 + c.ptraj(SP["overdrive"]) * 9.0
    sat, nst = bank_kernels.ws4_bank_plain(total, drive, packed)
    wet = total * (1.0 - 1.0) + sat * 1.0
    shaped = torch.where(drive <= 1.0, total, wet)
    shaped = torch.where(torch.isfinite(total), shaped, 0.0)
    amp_env = _adsr(el, 0.001, torch.clamp(amp_decay_s, min=0.001), 0.0, 1.0, amp_curve)
    return shaped * amp_env * torch.sqrt(vel_e) * c.ptraj(SP["volume"]), nst


# --- the launches -----------------------------------------------------------------

_PLAIN = {"kick_a": kick_a_plain, "snare_a": snare_a_plain, "hihat2": hihat2_plain,
          "bass": bass_plain, "tom2": tom2_plain, "kick_b": kick_b_plain,
          "snare_b": snare_b_plain}
#: how many of each body's outputs lead as [V, B] signals (the rest is
#: carried state)
SIGNALS = {"kick_a": 2, "snare_a": 2, "hihat2": 1, "bass": 4, "tom2": 5, "kick_b": 1,
           "snare_b": 1}
#: which launch runs each body
_SOURCE_BODIES = ("kick_a", "snare_a", "hihat2", "bass", "tom2")
_DRIVE_BODIES = ("kick_b", "snare_b")


def _run_plain(phases, bodies, name):
    outs = []
    for ph in phases:
        if ph.name not in bodies:
            raise ValueError(f"{name}: no body {ph.name!r} (takes {bodies})")
        outs.append(tuple(_PLAIN[ph.name](*ph.args, **ph.kwargs)))
    return outs


def kit_sources_plain(phases):
    """Plain version of :func:`kit_sources`: each phase's plain body."""
    return _run_plain(phases, _SOURCE_BODIES, "kit_sources")


def kit_drive_plain(phases):
    """Plain version of :func:`kit_drive`: each phase's plain body."""
    return _run_plain(phases, _DRIVE_BODIES, "kit_drive")


#: a phase's pointer, float and int slots (``kIn`` ... in the CUDA source)
_IN, _OUT, _NF, _NI = 16, 10, 24, 8
#: body -> the CUDA source's ``Body``
_OPS = {"kick_a": 0, "snare_a": 1, "hihat2": 2, "bass": 3, "tom2": 4, "kick_b": 5,
        "snare_b": 6}


def _vb_of(ph):
    """``(V, B)`` of a phase, from its arguments."""
    if ph.name == "tom2":
        return ph.args[0].shape[0], ph.kwargs["B"]
    if ph.name == "kick_b":
        return ph.args[0].shape
    return ph.args[0].shape[0], ph.args[-1].shape[0] - 1


def _specs(ph, V, B):
    """``(inputs [(label, tensor, dtype, shape)], outputs [(shape, dtype)],
    floats, ints)`` of a phase as the CUDA source's slots take them."""
    a, kw = ph.args, ph.kwargs
    f32, i32 = _F32, _I32
    sr = float(kw["sample_rate"])
    w = float(np.float32(2.0 * np.pi / sr))
    inv_sr = float(np.float32(1.0 / sr))
    nyq = float(np.float32(sr / 2.0))
    taper_from = bank_kernels.taper_threshold(nyq)   # the additive triangles'
    poles, gains = coefficients(sr)
    pink = [float(v) for v in poles] + [float(v) for v in gains] + [
        float(np.float32(DIRECT_GAIN)), float(np.float32(OUTPUT_GAIN))]
    seed = _seed_mix(SEED)
    common = [("cur", f32, None), ("tgt", f32, None), ("off", i32, (V,)), ("vel", f32, (V,)),
              ("trig", i32, (V,))]
    vb, pw = (V, B), (B + 1,)
    if ph.name == "kick_a":
        alpha = np.float32(1.0 - np.exp(-2.0 * np.pi * 8000.0 / sr))
        ins = common + [("lat", f32, (V, 6)), ("fst", f32, (V, 6)), ("bs", i32, ()),
                        ("powq", f32, pw)]
        outs = [(vb, f32), (vb, f32), ((V, 19), f32), ((V, 6), f32), ((V,), i32),
                ((V, 6), f32)]
        fl = [inv_sr, w, nyq, float(alpha),
              float(np.float32(1.0 - alpha)), float(np.float32(min(20_000.0, sr * 0.45))),
              float(np.float32(sr)), float(kw["qB"])] + pink + [taper_from]
        iv = [seed, (int(kw["max_harmonics"]) + 1) // 2 if kw["max_harmonics"] > 0 else -1]
        shapes = {"cur": (V, 19), "tgt": (V, 19)}
    elif ph.name == "snare_a":
        ins = common + [("lat", f32, (V, 6)), ("bs", i32, ()), ("powq", f32, pw)]
        outs = [(vb, f32), (vb, f32), ((V, 19), f32), ((V, 6), f32), ((V,), i32)]
        fl = [inv_sr, w, nyq, float(kw["qB"]), taper_from]
        iv = [seed, (int(kw["max_harmonics"]) + 1) // 2 if kw["max_harmonics"] > 0 else -1]
        shapes = {"cur": (V, 19), "tgt": (V, 19)}
    elif ph.name == "bass":
        ins = common[:4] + [("nf", f32, (V,)), ("trig", i32, (V,)), ("lat", f32, (V, 6)),
                            ("ph", f32, (V, 3)), ("packed", f32, (FBWS_S_IN, V)),
                            ("bs", i32, ()), ("powq", f32, pw)]
        outs = [(vb, f32)] * 4 + [((V, 16), f32), ((V, 6), f32), ((V,), i32), ((V, 3), f32),
                                  ((FBWS_S_OUT, V), f32)]
        fl = [inv_sr, float(np.float32(sr)), float(kw["qB"]), _TWO_PI, _TANH_HALF,
              float(np.float32(18_000.0 / 20.0))]
        iv = []
        shapes = {"cur": (V, 16), "tgt": (V, 16)}
    elif ph.name == "hihat2":
        down = np.float32(1.0 - np.exp(-1.0 / 100.0))
        ins = common + [("lat", f32, (V, 1)), ("color", i32, (V,)), ("slope", i32, (V,)),
                        ("ph", f32, (V, 3)), ("hpf", f32, (V, 8)), ("svf", f32, (V, 2)),
                        ("pink", f32, (V, 3)), ("salt", i32, (V,)), ("bs", i32, ()),
                        ("powq", f32, pw)]
        outs = [(vb, f32), ((V, 6), f32), ((V, 1), f32), ((V,), i32), ((V, 3), f32),
                ((V, 8), f32), ((V, 2), f32), ((V, 3), f32)]
        fa, da = _max_curve_consts(-0.3)
        fd, dd = _max_curve_consts(-0.8)
        fl = [inv_sr, float(np.float32(sr)), float(kw["qB"]), _TWO_PI, _PI,
              float(np.float32(sr * 0.45)), float(down), float(np.float32(1.0 - down)),
              fa, da, fd, dd] + pink
        iv = [seed]
        shapes = {"cur": (V, 6), "tgt": (V, 6)}
    elif ph.name == "tom2":
        ins = [("par", f32, (V, 9)), ("off", i32, (V,)), ("trig", i32, (V,)),
               ("dec", f32, (V,)), ("ph", f32, (V, 6)), ("seg", i32, (V,)), ("bs", i32, ())]
        outs = [(vb, f32)] * 5 + [((V,), i32), ((V,), f32), ((V, 6), f32), ((V,), i32)]
        fu, du = _max_curve_consts(0.8)
        fd, dd = _max_curve_consts(-0.83)
        fl = [inv_sr, float(np.float32(sr)), _TWO_PI, float(np.float32(190.0 / sr)),
              fu, du, fd, dd]
        iv = [seed, _seed_mix(RAND_SEED), int(bool(kw["triangle_enabled"])), B]
        shapes = {}
    elif ph.name == "kick_b":
        ins = [("total", f32, vb), ("comp_signed", f32, vb), ("ampsc", f32, vb),
               ("cur", f32, (V, 19)), ("tgt", f32, (V, 19)), ("packed", f32, (FBWS_S_IN, V)),
               ("filt0", f32, (V,)), ("powq", f32, pw)]
        outs = [(vb, f32), ((FBWS_S_OUT, V), f32), ((V,), f32)]
        fl = [float(np.float32(sr)), float(np.float32(-2.0 * np.pi))]
        iv = []
        shapes = {}
    else:  # snare_b
        ins = common + [("lat", f32, (V, 6)), ("dry", f32, vb), ("filt", f32, vb),
                        ("packed", f32, (FBWS_S_IN, V)), ("bs", i32, ()), ("powq", f32, pw)]
        outs = [(vb, f32), ((FBWS_S_OUT, V), f32)]
        fl = [inv_sr, _TANH_HALF]
        iv = []
        shapes = {"cur": (V, 19), "tgt": (V, 19)}
    specs = [(label, t, dt, shapes.get(label, shape))
             for (label, dt, shape), t in zip(ins, a)]
    if len(specs) != len(a):
        raise ValueError(f"{ph.name}: {len(a)} arguments, expected {len(ins)}")
    return specs, outs, fl, iv


def _launch_kit(name, entry, phases, bodies):
    if not phases:
        raise ValueError(f"{name}: no phases")
    ops, ptrs, floats, ints, outs = [], [], [], [], []
    dev = phases[0].args[0].device
    for ph in phases:
        if ph.name not in bodies:
            raise ValueError(f"{name}: no body {ph.name!r} (takes {bodies})")
        V, B = _vb_of(ph)
        specs, out_specs, fl, iv = _specs(ph, V, B)
        _check(f"{name} {ph.name}", dev, specs)
        res = tuple(torch.empty(shape, dtype=dt, device=dev) for shape, dt in out_specs)
        ops += [_OPS[ph.name], V, B]
        ptrs += ([t.data_ptr() for _, t, _, _ in specs] + [None] * (_IN - len(specs))
                 + [r.data_ptr() for r in res] + [None] * (_OUT - len(res)))
        floats += fl + [0.0] * (_NF - len(fl))
        # a uint32 hash constant travels as the int32 of the same bits
        ints += [v - (1 << 32) if v > 0x7FFFFFFF else v for v in iv] + [0] * (_NI - len(iv))
        outs.append(res)
    c_ops = (ctypes.c_int * len(ops))(*ops)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_floats = (ctypes.c_float * len(floats))(*floats)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    keep, coefs = _host_floats(_FBWS_COEFS)
    _launch(name, dev, entry, len(phases), c_ops, c_ptrs, c_floats, c_ints, coefs)
    del keep
    return outs


#: families one launch takes at most (``kMaxPhases`` in the CUDA source)
MAX_PHASES = 5


def _count(phases, name):
    if not 1 <= len(phases) <= MAX_PHASES:
        raise ValueError(f"{name}: {len(phases)} phases, expected 1 to {MAX_PHASES}")


def kit_sources(phases):
    """The kit's sources in one launch (the counterpart of the merged
    sources ``_mega_pallas`` call): ``phases`` is a list of
    :class:`VoicePhase` of the bodies ``kick_a``, ``snare_a``, ``hihat2``,
    ``bass`` and ``tom2``.  Returns each phase's outputs, as its plain body
    returns them."""
    if not _on_cuda("kit_sources", phases[0].args[0]):
        return kit_sources_plain(phases)
    _count(phases, "kit_sources")
    outs = _launch_kit("kit_sources", "kit_sources_launch", phases, _SOURCE_BODIES)
    kit_sources.launches += 1
    return outs


kit_sources.launches = 0


def kit_drive(phases):
    """The kick's and the snare's 4x drive in one launch (the merged drive
    ``_mega_pallas`` call): ``phases`` of the bodies ``kick_b`` and
    ``snare_b``.  Returns each phase's outputs."""
    if not _on_cuda("kit_drive", phases[0].args[0]):
        return kit_drive_plain(phases)
    _count(phases, "kit_drive")
    outs = _launch_kit("kit_drive", "kit_drive_launch", phases, _DRIVE_BODIES)
    kit_drive.launches += 1
    return outs


kit_drive.launches = 0
