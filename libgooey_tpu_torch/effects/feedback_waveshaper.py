"""Feedback waveshaper: tanh distortion with a filtered feedback loop
(port of libgooey_tpu/effects/feedback_waveshaper.py:50-138,141-249).

Signal path per sample (src/effects/feedback_waveshaper.rs):

    shaped  = tanh(drive*x)                      (4x oversampled)
    env    += (1-c)(|x| - env)                   c = attack/release by direction
    comp    = gain_compensation(env, drive, feedback)   (clamped at 3x)
    dc      = dc_block(shaped*comp)
    filt   += g*(dc - filt)
    out     = x*(1-mix) + dc*mix

Bypass when mix <= 1e-4 or drive <= 1 (state frozen).

Three paths, chosen by the caller as in the JAX package:

* the zero-feedback 4x path on a ``[V, B]`` voice bank (every factory
  preset, the kick's overdrive): the envelope follower in the
  ``env_follow_bank`` kernel, the oversampled tanh chain and the gated DC
  blocker in ``fbws_bank``, the feedback-filter bookkeeping in
  ``affine1_bank`` through ``scan.linrec1``;
* the zero-feedback 4x path on the stereo bus with block-scalar parameters
  (mixer/chain.py ``EFFECT_FEEDBACK_WAVESHAPER`` with feedback 0, the TPU's
  fused stereo path, feedback_waveshaper.py:141-203): the detector in
  ``env_follower_block``, the rest in ``fbws_fast_block``, also two phases
  of a merged run (``prepare``);
* the zero-feedback path at ``os_mode`` 1 and 2 (feedback_waveshaper.py:
  251-285): the tanh through ``ops/oversample.process``, the follower in
  ``env_follow_bank``, the makeup gain in PyTorch, the gated DC blocker and
  the feedback filter as ``scan.linrec1`` calls;
* the general feedback loop (``feedback_path=True``), a true per-sample
  nonlinear recurrence at the engine rate, stepped in PyTorch as the JAX
  package steps it in a ``lax.scan`` (no TPU kernel; off the main path).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libgooey_tpu_torch.core.smoother import broadcast_targets
from libgooey_tpu_torch.effects import freeze as frz
from libgooey_tpu_torch.ops import bank_kernels, bus_kernels
from libgooey_tpu_torch.ops import oversample as ovs_mod
from libgooey_tpu_torch.ops import scan as gscan
from libgooey_tpu_torch.ops.filters import _shift1

DC_COEFF = 0.995
ENV_ATTACK_MS = 1.0
ENV_RELEASE_MS = 120.0
ENV_FLOOR = 0.05
COMP_TAMING = 0.25
HIGH_END_MAKEUP_DB = 5.1
MAX_COMP_GAIN = 3.0
RUNAWAY_LIMIT = 50.0


class FBShaperState(NamedTuple):
    """Per-voice loop state, each ``[V]``-shaped."""

    last_out: torch.Tensor
    filter_state: torch.Tensor
    dc_x1: torch.Tensor
    dc_y1: torch.Tensor
    env: torch.Tensor
    ovs: ovs_mod.OversamplerState

    @staticmethod
    def init(shape, device) -> "FBShaperState":
        shape = (shape,) if isinstance(shape, int) else tuple(shape)

        def z():
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return FBShaperState(z(), z(), z(), z(), z(), ovs_mod.OversamplerState.init(shape, device))


def env_coeffs(sample_rate: float):
    """Attack/release retention factors (feedback_waveshaper.rs:242-244)."""
    att = float(np.exp(-1.0 / (ENV_ATTACK_MS / 1000.0 * sample_rate)))
    rel = float(np.exp(-1.0 / (ENV_RELEASE_MS / 1000.0 * sample_rate)))
    return att, rel


def filter_coeff(cutoff_hz, sample_rate: float):
    """Feedback-path one-pole coefficient, clamped to 0.9 (rs:233-236)."""
    g = 1.0 - torch.exp(-2.0 * np.pi * cutoff_hz / sample_rate)
    return torch.clamp(g, 0.0, 0.9)


def gain_compensation(env, drive, feedback):
    """Envelope-referenced makeup gain (feedback_waveshaper.rs:247-259)."""
    reference = torch.clamp(env, min=ENV_FLOOR)
    driven_ref = torch.clamp(torch.tanh(reference * drive).abs(), min=1e-6)
    comp_no_fb = torch.tanh(reference) / driven_ref

    drive_norm = torch.clamp((drive - 1.0) / 99.0, 0.0, 1.0)
    feedback_norm = torch.clamp(feedback / 0.98, 0.0, 1.0)
    high_end = torch.pow(drive_norm, 1.35) * torch.pow(feedback_norm, 2.0)
    high_end_makeup = torch.pow(10.0, HIGH_END_MAKEUP_DB * high_end / 20.0)

    taming = 1.0 / (1.0 + comp_no_fb * feedback * COMP_TAMING)
    return torch.clamp(comp_no_fb * taming * high_end_makeup, max=MAX_COMP_GAIN)


def _env_follow(env0, rect, att, rel, freeze):
    """Asymmetric attack/release follower over ``[V, B]`` through the
    ``env_follow_bank`` kernel, at any V.  Returns ``(env_last, env)``."""
    env, env_last = bank_kernels.env_follow_bank(
        rect.contiguous(), freeze.contiguous(), env0.contiguous(),
        att=float(att), rel=float(rel))
    return env_last, env


def _bus_params(targets, sample_rate, device):
    """``[2, 4]`` per-channel (drive, feedback, filter coefficient, mix) from
    the chain's staged (drive, feedback, cutoff Hz, mix), and whether the
    block is bypassed (a 0-dim bool tensor)."""
    t = broadcast_targets(targets, (4,), device)
    prm = torch.stack([t[0], t[1], filter_coeff(t[2], sample_rate), t[3]]).expand(2, 4)
    return prm.contiguous(), (t[3] <= 1e-4) | (t[0] <= 1.0)


def prepare(state: FBShaperState, targets, *, sample_rate: float, block_size: int, device):
    """The zero-feedback stereo block as two kernel phases, the detector
    (``env_follower_block``, the bypass folded into its coefficients) and
    ``fbws_fast_block`` (whose ``env`` is ``None``: the detector's output
    before it), and ``finish([detector outputs, block outputs]) ->
    new_state`` (pallas_chain._fbws_phases).  ``targets``: (drive, feedback,
    cutoff Hz, mix); the caller guarantees feedback 0."""
    prm, held = _bus_params(targets, sample_rate, device)
    att, rel = env_coeffs(sample_rate)
    byp = held.to(torch.float32).expand(2, block_size)
    ac = torch.where(byp > 0.5, 1.0, float(np.float32(att))).contiguous()
    rc = torch.where(byp > 0.5, 1.0, float(np.float32(rel))).contiguous()
    env_phase = bus_kernels.Phase(
        "env_follower_block", (ac, rc, byp.contiguous(), state.env.contiguous()), {})
    main_phase = bus_kernels.Phase(
        "fbws_fast_block", (None, prm, bus_kernels.pack_fbws_fast(state)), {})

    def finish(outputs):
        (_env, env_last), (nst,) = outputs
        new_ovs, dc_x1, dc_y1, filt = bus_kernels.unpack_fbws_fast(nst, state.ovs)
        # the oversampler history holds over a bypassed block
        # (feedback_waveshaper.rs early return; effects/freeze.py)
        return FBShaperState(last_out=filt, filter_state=filt, dc_x1=dc_x1, dc_y1=dc_y1,
                             env=env_last, ovs=frz.hold_where(held, state.ovs, new_ovs))

    return [env_phase, main_phase], finish


def process_bus(state: FBShaperState, x, targets, *, sample_rate: float):
    """One zero-feedback stereo block ``x`` [2, B] with block-scalar
    ``targets`` (drive, feedback, cutoff Hz, mix) -> ``(new_state, out)``."""
    x = x.contiguous()
    (env_phase, main_phase), finish = prepare(state, targets, sample_rate=sample_rate,
                                              block_size=x.shape[-1], device=x.device)
    _, env_out = bus_kernels.run_phase(x, env_phase)
    out, main_out = bus_kernels.run_phase(
        x, main_phase._replace(args=(env_out[0],) + main_phase.args[1:]))
    return finish([env_out, main_out]), out


def _general_path(state: FBShaperState, x, drive, feedback, fbc, mix, sample_rate):
    """The true feedback loop at the engine rate, sample by sample
    (feedback_waveshaper.py:249-298): tanh of drive*x + feedback*last_out,
    the follower, the makeup gain, the DC blocker, the feedback filter, the
    runaway guard; a bypassed sample freezes the state and passes x."""
    drive, feedback, fbc, mix, x = torch.broadcast_tensors(drive, feedback, fbc, mix, x)
    att, rel = (float(np.float32(c)) for c in env_coeffs(sample_rate))
    bypass = (mix <= 1e-4) | (drive <= 1.0)
    st = (state.last_out, state.filter_state, state.dc_x1, state.dc_y1, state.env)
    outs = []
    for n in range(x.shape[-1]):
        xn, dn, fn_, gn, mn, byp = (t[..., n] for t in (x, drive, feedback, fbc, mix, bypass))
        last_out, filt, dcx, dcy, env = st
        shaped = torch.tanh(dn * xn + fn_ * last_out)
        c = torch.where(xn.abs() > env, att, rel)
        env_n = env + (1.0 - c) * (xn.abs() - env)
        env_n = torch.where(env_n.abs() < 1e-15, 0.0, env_n)
        compensated = shaped * gain_compensation(env_n, dn, fn_)
        dc_out = compensated - dcx + DC_COEFF * dcy
        dcy_n = torch.where(dc_out.abs() < 1e-15, 0.0, dc_out)
        filt_n = filt + gn * (dc_out - filt)
        filt_n = torch.where(filt_n.abs() < 1e-15, 0.0, filt_n)
        runaway = filt_n.abs() > RUNAWAY_LIMIT
        out = torch.where(runaway, xn, xn * (1.0 - mn) + dc_out * mn)
        z = torch.zeros_like(filt_n)
        new = (torch.where(runaway, z, filt_n), torch.where(runaway, z, filt_n),
               torch.where(runaway, z, compensated), torch.where(runaway, z, dcy_n),
               torch.where(runaway, z, env_n))
        st = tuple(torch.where(byp, old, nv) for old, nv in zip(st, new))
        outs.append(torch.where(byp, xn, out))
    return FBShaperState(*st, ovs=state.ovs), torch.stack(outs, dim=-1)


def _fast_path_scans(state: FBShaperState, x, drive, feedback, fbc, mix, bypass, att, rel,
                     os_mode: int):
    """The zero-feedback block at ``os_mode`` 1 or 2
    (feedback_waveshaper.py:251-285): bypassed samples neither read nor
    advance the DC blocker, whose memories are the time-varying linear
    recurrences ``x1[n] = bypass ? x1[n-1] : in[n]`` and ``y1[n] = bypass ?
    y1[n-1] : in[n] - x1[n-1] + R*y1[n-1]``."""
    new_ovs, shaped = ovs_mod.process(state.ovs, torch.tanh, drive * x, os_mode)
    env_state, env = _env_follow(state.env, x.abs(), att, rel, bypass)
    compensated = shaped * gain_compensation(env, drive, feedback)
    x1 = gscan.linrec1(torch.where(bypass, 1.0, 0.0), torch.where(bypass, 0.0, compensated),
                       state.dc_x1)
    dc_raw = compensated - _shift1(x1, state.dc_x1)
    y1 = gscan.linrec1(torch.where(bypass, 1.0, DC_COEFF), torch.where(bypass, 0.0, dc_raw),
                       state.dc_y1)
    dc = torch.where(bypass, 0.0, y1)
    filt = gscan.linrec1(torch.where(bypass, 1.0, 1.0 - fbc),
                         torch.where(bypass, 0.0, fbc * dc), state.filter_state)
    filt = torch.where(filt.abs() < 1e-15, 0.0, filt)
    out = torch.where(bypass, x, x * (1.0 - mix) + dc * mix)
    return FBShaperState(
        last_out=filt[..., -1], filter_state=filt[..., -1],
        dc_x1=x1[..., -1], dc_y1=y1[..., -1], env=env_state,
        ovs=frz.hold_where(torch.all(bypass, dim=-1), state.ovs, new_ovs)), out


def process_block(
    state: FBShaperState,
    x,
    drive,
    feedback,
    fb_filter_coeff,
    mix,
    sample_rate: float,
    feedback_path: bool = True,
    os_mode: int = 4,
):
    """Run the feedback waveshaper over a block ``x[..., B]``.

    ``drive``/``feedback``/``fb_filter_coeff``/``mix`` broadcast against x
    (per-sample trajectories from smoothed params).  ``feedback_path=False``
    selects the zero-feedback fast path — the caller guarantees
    that the feedback parameter is 0; ``feedback_path=True`` the general
    loop.  Returns ``(new_state, out)``."""

    def like_x(v):
        # a Python scalar becomes a device fill, not a blocking host copy
        if isinstance(v, torch.Tensor):
            return v.to(torch.float32).expand_as(x)
        return torch.full_like(x, float(np.float32(v)))

    if feedback_path:
        return _general_path(state, x, *(like_x(v) for v in (drive, feedback, fb_filter_coeff,
                                                             mix)), sample_rate)
    if x.dim() != 2:
        raise ValueError(f"expected a [V, B] voice bank, got {tuple(x.shape)}")

    drive, feedback, fbc, mix = (like_x(v) for v in (drive, feedback, fb_filter_coeff, mix))
    att, rel = env_coeffs(sample_rate)
    bypass = (mix <= 1e-4) | (drive <= 1.0)
    if os_mode != 4:
        return _fast_path_scans(state, x, drive, feedback, fbc, mix, bypass, att, rel, os_mode)

    env_state, env = _env_follow(state.env, x.abs(), att, rel, bypass)
    comp = gain_compensation(env, drive, feedback)
    comp_signed = torch.where(bypass, -1.0, comp)
    dc, nst = bank_kernels.fbws_bank(
        (drive * x).contiguous(), comp_signed.contiguous(),
        bank_kernels.pack_fbws_bank(state))
    new_ovs, dc_x1, dc_y1 = bank_kernels.unpack_fbws_bank(nst, state)
    new_ovs = frz.hold_where(torch.all(bypass, dim=-1), state.ovs, new_ovs)
    # feedback-filter state: pure bookkeeping on this path (the loop gain is 0)
    filt = gscan.linrec1(
        torch.where(bypass, 1.0, 1.0 - fbc),
        torch.where(bypass, 0.0, fbc * dc), state.filter_state)
    filt = torch.where(filt.abs() < 1e-15, 0.0, filt)
    new_state = FBShaperState(
        last_out=filt[..., -1], filter_state=filt[..., -1],
        dc_x1=dc_x1, dc_y1=dc_y1, env=env_state, ovs=new_ovs)
    out = torch.where(bypass, x, x * (1.0 - mix) + dc * mix)
    return new_state, out
