"""Waveshaper: tanh soft-clip with drive compensation, at 4x
(port of the voice-bank 4x path of libgooey_tpu/effects/waveshaper.py).

Behavioral reference: src/effects/waveshaper.rs; per sample

    compensation = tanh(0.5) / tanh(0.5 * drive)
    out = x*(1-mix) + tanh(x*drive)*compensation * mix

evaluated at 4x through the half-band chains (the reference's default,
waveshaper.rs:32).  Bypass (identity) when drive <= 1; a non-finite input
gives 0.  The port has the instruments' path only: mix == 1 on a ``[V, B]``
bank, whole chain in the ``ws4_bank`` kernel.  Other oversampling modes and
the stereo chain effect raise.
"""

from __future__ import annotations

import torch

from libgooey_tpu_torch import not_ported
from libgooey_tpu_torch.ops import bank_kernels


def process_bank(ovs, x, drive, os_mode: int = 4):
    """``ws.process(x, drive, mix=1.0)`` at 4x over a ``[V, B]`` bank.

    ``ovs`` is the bank's ``OversamplerState``; ``drive`` a ``[V, B]``
    trajectory.  The oversampler history advances at every sample, bypassed
    or not (the block-granular freeze is the caller's, as in the JAX
    package).  Returns ``(new_ovs, out)``."""
    if os_mode != 4:
        raise not_ported(f"waveshaper at os_mode={os_mode}")
    sat, nst = bank_kernels.ws4_bank(x.contiguous(), drive.contiguous(),
                                     bank_kernels.pack_ws4_bank(ovs))
    out = torch.where(drive <= 1.0, x, sat)
    out = torch.where(torch.isfinite(x), out, 0.0)
    return bank_kernels.unpack_ws4_bank(nst, ovs), out
