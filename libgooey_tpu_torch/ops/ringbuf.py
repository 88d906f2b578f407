"""Device ring buffers with fractional reads: the delay-line substrate
(port of libgooey_tpu/ops/ringbuf.py).

A delay line keeps its audio history in a ring on the device and works per
block: reads whose lag is at least the block length reference only earlier
writes, so a block of reads is one gather and a block of writes one scatter.

Position convention: ``pos`` counts samples written, reduced mod ``L``; sample
``t`` lives at slot ``t % L``, and "offset w ago, before this sample's
write" at local sample n reads slot ``(pos + n - w) % L``.  ``pos`` is a 0-d
int64 tensor on the ring's device, so no block reads it back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Ring(NamedTuple):
    buf: torch.Tensor  # [..., L] float32
    pos: torch.Tensor  # [] int64: samples written, mod L

    #: the JAX package keeps ``pos`` as int32
    NUMPY_DTYPES = {"pos": np.int32}

    @staticmethod
    def init(length: int, batch=(), *, device) -> "Ring":
        return Ring(buf=torch.zeros(tuple(batch) + (int(length),), dtype=torch.float32,
                                    device=device),
                    pos=torch.zeros((), dtype=torch.int64, device=device))


def write_block(ring: Ring, x: torch.Tensor) -> Ring:
    """Append ``x[..., C]`` at the current position.  The buffer is copied,
    not updated in place, so a state can be rendered from more than once."""
    L = ring.buf.shape[-1]
    C = x.shape[-1]
    idx = torch.remainder(ring.pos + torch.arange(C, device=x.device), L)
    buf = ring.buf.index_copy(ring.buf.dim() - 1, idx, x)
    return Ring(buf=buf, pos=torch.remainder(ring.pos + C, L))


def read_frac(ring: Ring, offsets: torch.Tensor, min_offset: float = 1.0) -> torch.Tensor:
    """Fractional read of ``offsets[..., C]`` samples ago (pre-write), for a
    buffer with the same leading axes as ``offsets``.

    Linear interpolation between the samples ``whole`` and ``whole+1`` ago
    (plate_reverb.rs:120-129); offsets are clamped to [min_offset, L-2] and
    local sample n reads relative to ``pos + n``."""
    L = ring.buf.shape[-1]
    C = offsets.shape[-1]
    offsets = torch.clamp(offsets, min_offset, L - 2.0)
    whole = torch.floor(offsets)
    frac = offsets - whole
    base = ring.pos + torch.arange(C, device=offsets.device) - whole.to(torch.int64)
    a = torch.gather(ring.buf, -1, torch.remainder(base, L))
    b = torch.gather(ring.buf, -1, torch.remainder(base - 1, L))
    return a + frac * (b - a)


def read_int(ring: Ring, lags) -> torch.Tensor:
    """Integer-lag read: ``lags[..., C]`` samples ago (pre-write), local
    sample n relative to ``pos + n``; a buffer with the same number of axes
    as ``lags`` is read row by row, a ``[L]`` buffer at every index."""
    L = ring.buf.shape[-1]
    lags = torch.as_tensor(lags, device=ring.buf.device)
    C = lags.shape[-1]
    idx = torch.remainder(ring.pos + torch.arange(C, device=lags.device) - lags.to(torch.int64),
                          L)
    if ring.buf.dim() == idx.dim():
        return torch.gather(ring.buf, -1, idx.expand(ring.buf.shape[:-1] + (C,)))
    return ring.buf[idx]


def tap_frac(ring_after_write: Ring, offsets: torch.Tensor, n_written: int) -> torch.Tensor:
    """Post-write fractional tap: offset 0 is this sample's own write.

    ``ring_after_write.pos`` has already advanced by ``n_written``; local
    sample n reads relative to ``pos - n_written + n`` (plate_reverb.rs:
    134-142, slot ``idx - 1 - whole``).  Offsets are clamped to [0, L-2]."""
    before = Ring(buf=ring_after_write.buf, pos=ring_after_write.pos - n_written)
    return read_frac(before, offsets, min_offset=0.0)


def affine_allpass_reads(rings, gains, offsets_list, min_offset: float = 1.0):
    """A series-Schroeder-allpass chain as an affine map of its input chunk.

    Each allpass ``out = g*v + delayed`` with ``v = in - g*delayed`` is
    affine in ``in`` given its pre-chunk delayed read: ``out = g*in +
    (1-g^2)*delayed``.  Composed, ``out[n] = (prod g_i)*in[n] + beta[n]``
    and stage i's input is ``(prod_{j<i} g_j)*in[n] + gamma_i[n]``.
    Returns ``(alpha, beta, stage_direct, stage_add, delayed)``: enough to
    rebuild every stage's write ``v_i = in_i - g_i*delayed_i`` once the
    chunk's input is known (reverb.rs:189-217, plate_reverb.rs:455-462)."""
    delayed = [read_frac(r, torch.as_tensor(o, device=r.buf.device), min_offset)
               for r, o in zip(rings, offsets_list)]
    alpha, beta = 1.0, 0.0
    stage_direct, stage_add = [], []
    for g, d in zip(gains, delayed):
        stage_direct.append(alpha)
        stage_add.append(beta)
        beta = g * beta + (1.0 - g * g) * d
        alpha = alpha * g
    return alpha, beta, stage_direct, stage_add, delayed
