"""Waveshaper: tanh soft-clip with drive compensation, at 4x
(port of libgooey_tpu/effects/waveshaper.py).

Behavioral reference: src/effects/waveshaper.rs; per sample

    compensation = tanh(0.5) / tanh(0.5 * drive)
    out = x*(1-mix) + tanh(x*drive)*compensation * mix

evaluated at 4x through the half-band chains (the reference's default,
waveshaper.rs:32).  Bypass (identity) when drive <= 1 or mix <= 1e-4; a
non-finite input gives 0.  Two paths, both at 4x:

* ``process_bank``: the instruments' drive, mix == 1 on a ``[V, B]`` bank,
  whole chain in the ``ws4_bank`` kernel;
* ``process``: the stereo chain effect (mixer/chain.py ``EFFECT_WAVESHAPER``)
  with block-scalar drive and mix, in the ``waveshaper_block`` kernel, also
  a phase of a merged run (``prepare``).

Other oversampling modes raise.
"""

from __future__ import annotations

import torch

from libgooey_tpu_torch import not_ported
from libgooey_tpu_torch.core.smoother import broadcast_targets
from libgooey_tpu_torch.effects import freeze as frz
from libgooey_tpu_torch.ops import bank_kernels, bus_kernels


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
