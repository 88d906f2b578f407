"""Waveshaper: tanh soft-clip with drive compensation
(port of libgooey_tpu/effects/waveshaper.py).

Behavioral reference: src/effects/waveshaper.rs; per sample

    compensation = tanh(0.5) / tanh(0.5 * drive)
    out = x*(1-mix) + tanh(x*drive)*compensation * mix

evaluated at 4x through the half-band chains (the reference's default,
waveshaper.rs:32).  Bypass (identity) when drive <= 1 or mix <= 1e-4; a
non-finite input gives 0.  Three paths:

* ``process_bank``: the instruments' drive, mix == 1 on a ``[V, B]`` bank;
  at 4x the whole chain in the ``ws4_bank`` kernel, at ``os_mode`` 1 and 2
  through ``process_hooked`` (bass.py:285-292, snare.py:332-334);
* ``process``: the stereo chain effect (mixer/chain.py ``EFFECT_WAVESHAPER``)
  at 4x with block-scalar drive and mix, in the ``waveshaper_block`` kernel,
  also a phase of a merged run (``prepare``);
* ``process_hooked``: the JAX package's general ``process(x, drive, mix,
  oversample)`` over any shape, with an optional oversampling hook.
"""

from __future__ import annotations

import numpy as np
import torch

from libgooey_tpu_torch.core.smoother import broadcast_targets
from libgooey_tpu_torch.effects import freeze as frz
from libgooey_tpu_torch.ops import bank_kernels, bus_kernels
from libgooey_tpu_torch.ops import oversample as ovs_mod


def process_hooked(x, drive, mix=1.0, oversample=None):
    """The waveshaper over arbitrary-shape blocks (broadcasting), as the JAX
    package's ``effects/waveshaper.process(x, drive, mix=1.0,
    oversample=None)`` (waveshaper.py:25-39).  The port's ``process`` is
    the stereo chain effect, ``process(ovs, x, targets)``, so this one takes
    another name.  ``oversample`` is a hook ``(fn, x) -> y`` such as
    ``ops.oversample.stateful(...)[0]``; ``None`` evaluates at 1x."""
    def as_f32(v):
        # a Python scalar becomes a device fill, not a blocking host copy
        if isinstance(v, torch.Tensor):
            return v.to(torch.float32)
        return torch.full_like(x, float(np.float32(v)))

    drive, mix = as_f32(drive), as_f32(mix)
    B = x.shape[-1]

    def fn(v):
        d = torch.clamp(ovs_mod.repeat_to_rate(drive, v, B), min=1.0 + 1e-6)
        # a true division, as bank_kernels._ws4_gain takes it
        compensation = torch.full_like(d, bank_kernels._TANH_HALF) / torch.tanh(0.5 * d)
        return torch.tanh(v * d) * compensation

    saturated = fn(x) if oversample is None else oversample(fn, x)
    wet = x * (1.0 - mix) + saturated * mix
    bypass = (mix <= 1e-4) | (drive <= 1.0)
    out = torch.where(bypass, x, wet)
    return torch.where(torch.isfinite(x), out, 0.0)


def process_bank(ovs, x, drive, os_mode: int = 4):
    """``ws.process(x, drive, mix=1.0)`` at ``os_mode``x over a ``[V, B]``
    bank.

    ``ovs`` is the bank's ``OversamplerState``; ``drive`` a ``[V, B]``
    trajectory.  The oversampler history advances at every sample, bypassed
    or not (the block-granular freeze is the caller's, as in the JAX
    package); at 1x it is returned as it came.  Returns ``(new_ovs, out)``."""
    if os_mode == 1:
        return ovs, process_hooked(x, drive, 1.0)
    if os_mode != 4:
        wrap, box = ovs_mod.stateful(ovs, os_mode)
        out = process_hooked(x, drive, 1.0, oversample=wrap)
        return box["state"], out
    sat, nst = bank_kernels.ws4_bank(x.contiguous(), drive.contiguous(),
                                     bank_kernels.pack_ws4_bank(ovs))
    out = torch.where(drive <= 1.0, x, sat)
    out = torch.where(torch.isfinite(x), out, 0.0)
    return bank_kernels.unpack_ws4_bank(nst, ovs), out


def _params(targets, device):
    """``[2, 2]`` per-channel (drive, mix) from the chain's staged targets,
    and whether the block is bypassed (a 0-dim bool tensor)."""
    prm = broadcast_targets(targets, (2, 2), device)
    return prm, (prm[0, 1] <= 1e-4) | (prm[0, 0] <= 1.0)


def prepare(ovs, targets, *, sample_rate: float, block_size: int, device):
    """The block's ``waveshaper_block`` phase and ``finish(outputs) ->
    new_ovs`` (pallas_chain._waveshaper_phases): ``ovs`` is the entry's bare
    ``OversamplerState``, ``targets`` its (drive, mix).  A bypassed block
    holds the history exactly (waveshaper.rs:55-57 early return)."""
    del sample_rate, block_size
    prm, held = _params(targets, device)
    phase = bus_kernels.Phase("waveshaper_block", (prm, bank_kernels.pack_ws4_bank(ovs)), {})

    def finish(outputs):
        (nst,) = outputs
        return frz.hold_where(held, ovs, bank_kernels.unpack_ws4_bank(nst, ovs))

    return phase, finish


def process(ovs, x, targets):
    """One stereo block ``x`` [2, B] at 4x with block-scalar ``targets`` =
    (drive, mix) -> ``(new_ovs, out)``."""
    phase, finish = prepare(ovs, targets, sample_rate=None, block_size=x.shape[-1],
                            device=x.device)
    out, aux = bus_kernels.run_phase(x.contiguous(), phase)
    return finish(aux), out
