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

Ported: the zero-feedback 4x path (every factory preset, and the kick on the
engine's main path), at any voice count: the envelope follower runs in the
``env_follow_bank`` kernel, the oversampled tanh chain and the gated DC
blocker in ``fbws_bank``, and the feedback-filter bookkeeping in
``affine1_bank`` through ``scan.linrec1``.  The true feedback loop
(``feedback_path=True``) and the other oversampling modes raise until a
later PR ports them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libgooey_tpu_torch.effects import freeze as frz
from libgooey_tpu_torch.ops import bank_kernels
from libgooey_tpu_torch.ops import oversample as ovs_mod
from libgooey_tpu_torch.ops import scan as gscan

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
    """Run the feedback waveshaper over a block ``x[V, B]``.

    ``drive``/``feedback``/``fb_filter_coeff``/``mix`` broadcast against x
    (per-sample trajectories from smoothed params).  ``feedback_path=False``
    selects the zero-feedback fast path — the caller guarantees that the
    feedback parameter is 0.  Returns ``(new_state, out)``."""
    if feedback_path or os_mode != 4:
        from libgooey_tpu_torch import not_ported

        raise not_ported(f"feedback_waveshaper.process_block(feedback_path={feedback_path}, "
                         f"os_mode={os_mode})")
    if x.dim() != 2:
        raise ValueError(f"expected a [V, B] voice bank, got {tuple(x.shape)}")

    def like_x(v):
        # a Python scalar becomes a device fill, not a blocking host copy
        if isinstance(v, torch.Tensor):
            return v.to(torch.float32).expand_as(x)
        return torch.full_like(x, float(np.float32(v)))

    drive, feedback, fbc, mix = (like_x(v) for v in (drive, feedback, fb_filter_coeff, mix))
    att, rel = env_coeffs(sample_rate)
    bypass = (mix <= 1e-4) | (drive <= 1.0)

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
