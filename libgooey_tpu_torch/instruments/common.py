"""Shared per-block trigger/latch machinery for batched instruments
(port of libgooey_tpu/instruments/common.py:33-226).

``VoiceBlock`` holds one block's context for a V-voice bank:

* closed-form smoothed-parameter trajectories with the reference's settle
  snap (smoother.rs:120-137);
* the value a trigger reads = smoother state after ``offset`` ticks;
* per-sample latched values via ``after`` masks, and elapsed-time arrays
  from a carried last-trigger sample index;
* LFO-routed parameters (``overrides``): per-sample ``[V, B]``
  trajectories the engine computed as one-pole scans toward the routes'
  targets, in place of the closed form (ffi.rs:1237-1250 applies the
  routes before the instrument's tick).

``trig_offset`` is ``[V]`` (one trigger slot, ``block_size`` = none) or
``[V, K]`` slot arrays with offsets ascending per voice; each sample sees the
snapshot of the most recent trigger at or before it.

``fm_snap_block`` is the FM "snap" transient as a block function.
``use_ws_bank`` (common.py:212-226) has no counterpart: on the TPU it sends
wide banks to the fused ``ws4_bank`` kernel and small ones to the XLA
oversampler, while the port's snare and bass always go through
``effects/waveshaper.process_bank``, which takes ``ws4_bank`` at 4x (its
plain version on the CPU) and ``ops/oversample.process`` at ``os_mode`` 2
(no oversampling at 1), as the JAX package's XLA branch does.
"""

from __future__ import annotations

import numpy as np
import torch

from libgooey_tpu_torch.core.smoother import SmootherBank, settle_snap

NEVER = np.int32(-(2**30))  # "never triggered" sentinel


class VoiceBlock:
    """Per-block context for a V-voice instrument bank."""

    def __init__(self, bank: SmootherBank, trig_offset, block_start,
                 block_size: int, smooth_coeff: float, param_index: dict,
                 overrides=None):
        dev = bank.current.device
        self.bank = bank
        self.B = block_size
        self.q = np.float32(1.0 - smooth_coeff)
        self.param_index = param_index
        #: LFO-routed parameter trajectories ``{name: [V, B]}``
        self.overrides = overrides or {}
        self.powers = torch.pow(
            float(self.q), torch.arange(1, block_size + 1, dtype=torch.float32, device=dev))

        self.n_local = torch.arange(block_size, dtype=torch.int32, device=dev)
        off = torch.as_tensor(trig_offset, device=dev).to(torch.int32)
        #: single-trigger mode: snapshots stay [V]-shaped
        self.legacy = off.dim() == 1
        if self.legacy:
            off = off[:, None]
        self.trig_offset = off                                   # [V, K]
        self.K = off.shape[1]
        self.block_start = torch.as_tensor(block_start, device=dev).to(torch.int32)
        self.trig_global = self.block_start + off                # [V, K]
        self.has_trig_k = off < block_size                       # [V, K]
        self.has_trig = torch.any(self.has_trig_k, dim=1)        # [V]
        n = self.n_local[None, :]
        # per-slot masks [V, K, B]; `after`/`at_trig` collapse over K
        self.after_k = (n[:, None, :] >= off[:, :, None]) & self.has_trig_k[:, :, None]
        self.after = torch.any(self.after_k, dim=1)              # [V, B]
        self.at_trig = torch.any(
            (n[:, None, :] == off[:, :, None]) & self.has_trig_k[:, :, None], dim=1)

    def _as_vk(self, new):
        return new[:, None] if new.dim() == 1 else new

    def ptraj(self, name: str) -> torch.Tensor:
        """Smoothed per-sample trajectory of one param, ``[V, B]``."""
        if name in self.overrides:
            return self.overrides[name]
        idx = self.param_index[name]
        tgt = self.bank.target[:, idx, None]
        delta = (self.bank.current[:, idx] - self.bank.target[:, idx])[:, None]
        return tgt + settle_snap(delta * self.powers)

    def value_at_trigger(self, name: str) -> torch.Tensor:
        """Smoothed value as read by each trigger slot: ``[V]`` in
        single-trigger mode, ``[V, K]`` otherwise."""
        idx = self.param_index[name]
        if name in self.overrides:
            # the routed trajectory one sample before the trigger; the bank's
            # current value for a trigger at the block's first sample
            traj = self.overrides[name]                              # [V, B]
            off = torch.clamp(self.trig_offset - 1, 0, self.B - 1).to(torch.int64)
            at = torch.gather(traj, 1, off)                          # [V, K]
            out = torch.where(self.trig_offset == 0, self.bank.current[:, idx, None], at)
        else:
            tgt = self.bank.target[:, idx, None]                     # [V, 1]
            delta = self.bank.current[:, idx, None] - tgt
            decayed = delta * torch.pow(
                float(self.q), torch.clamp(self.trig_offset, 0, self.B).to(torch.float32))
            out = tgt + settle_snap(decayed)
        return out[:, 0] if self.legacy else out

    def eff(self, new, old) -> torch.Tensor:
        """Per-sample latched value ``[V, B]``: each trigger's snapshot applies
        from its offset; the most recent trigger wins (slots ascending)."""
        new = self._as_vk(new)
        out = torch.broadcast_to(old[:, None], self.after.shape)
        for k in range(self.K):
            out = torch.where(self.after_k[:, k, :], new[:, k, None], out)
        return out

    def eff_vec(self, new, old) -> torch.Tensor:
        """Vector variant: new ``[V, K, D]``, old ``[V, D]`` -> ``[V, B, D]``."""
        out = torch.broadcast_to(old[:, None, :], self.after.shape + old.shape[-1:])
        for k in range(self.K):
            out = torch.where(self.after_k[:, k, :, None], new[:, k, None, :], out)
        return out

    def latch(self, new, old) -> torch.Tensor:
        """End-of-block latched state ``[V]``: the LAST trigger's value."""
        new = self._as_vk(new)
        out = old
        for k in range(self.K):
            out = torch.where(self.has_trig_k[:, k], new[:, k].to(out.dtype), out)
        return out

    def latch_vec(self, new, old) -> torch.Tensor:
        """Vector variant: new ``[V, K, D]``, old ``[V, D]`` -> ``[V, D]``."""
        out = old
        for k in range(self.K):
            out = torch.where(self.has_trig_k[:, k, None], new[:, k, :], out)
        return out

    def trig_eff(self, prev_trig_sample) -> torch.Tensor:
        """Per-sample global index of the governing trigger ``[V, B]``."""
        out = torch.broadcast_to(prev_trig_sample[:, None], self.after.shape)
        for k in range(self.K):
            out = torch.where(self.after_k[:, k, :], self.trig_global[:, k, None], out)
        return out

    def elapsed(self, prev_trig_sample, sample_rate: float):
        """``(trig_eff, elapsed_i[V,B] int32, idx_f[V,B] f32, elapsed_s[V,B] s)``."""
        trig_eff = self.trig_eff(prev_trig_sample)
        n_global = self.block_start + self.n_local
        elapsed_i = n_global[None, :] - trig_eff
        idx_f = elapsed_i.to(torch.float32)
        return trig_eff, elapsed_i, idx_f, idx_f * float(np.float32(1.0 / sample_rate))

    def advance_bank(self) -> SmootherBank:
        """Smoother state at the end of the block (closed form + settle); a
        routed parameter ends at its trajectory's last sample."""
        delta = self.bank.current - self.bank.target
        decayed = delta * float(self.q ** np.float32(self.B))
        new_current = self.bank.target + settle_snap(decayed)
        if self.overrides:
            new_current = new_current.clone()
            for name, traj in self.overrides.items():
                new_current[:, self.param_index[name]] = traj[:, -1]
        return SmootherBank(current=new_current, target=self.bank.target)


def phase_mod_env(elapsed, active_mask):
    """DS-style PhaseModulator envelope (fm_snap.rs:102-169): 1 ms rise
    ``p^0.3``, 5 ms fall ``1 - p^0.4``, zero outside [0, 6 ms], gated by
    ``active_mask`` (armed at trigger when amount > 0.001)."""
    rise = torch.pow(torch.clamp(elapsed / 0.001, min=0.0), 0.3)
    fall = 1.0 - torch.pow(torch.clamp((elapsed - 0.001) / 0.005, min=0.0), 0.4)
    env = torch.where(elapsed < 0.001, rise, fall)
    return torch.where((elapsed >= 0.0) & (elapsed <= 0.006) & active_mask, env, 0.0)


def fm_snap_block(phase0, elapsed, sample_rate, *, attack=0.001, decay=0.008,
                  carrier_freq=50.0, modulator_freq=500.0, modulation_index=2.0):
    """FM "snap" transient blip (fm_snap.rs:3-94) as a block function.

    The reference integrates the instantaneous frequency a sample at a
    time; here it is a cumulative sum over the block (``scan.cumsum_bank``),
    the phase carried across blocks through ``phase0``.  ``elapsed``
    ``[..., B]`` is seconds since the trigger; a sample before it or past
    the envelope is silent and adds no phase.  Returns ``(phase_out, y)``
    with ``y = sin(phase) * env`` and ``phase_out`` the last phase mod 2π."""
    from libgooey_tpu_torch.ops import scan as gscan

    t = torch.as_tensor(elapsed, dtype=torch.float32)
    active = (t >= 0.0) & (t <= attack + decay)
    env = torch.where(t < attack, torch.clamp(t, min=0.0) / attack,
                      torch.clamp(torch.exp(-(t - attack) / decay), 0.0, 1.0))
    env = torch.where(active, env, 0.0)
    mod = torch.sin(2.0 * np.pi * modulator_freq * t)
    f_inst = carrier_freq + modulation_index * mod * env
    dphi = torch.where(active, 2.0 * np.pi * f_inst / sample_rate, 0.0)
    phase0 = torch.as_tensor(phase0, dtype=torch.float32, device=t.device)
    phase = phase0[..., None] + gscan.cumsum_bank(dphi)
    return torch.remainder(phase[..., -1], 2.0 * np.pi), torch.sin(phase) * env