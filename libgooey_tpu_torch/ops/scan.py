"""First-order recurrences (port of libgooey_tpu/ops/scan.py:115-166).

``linrec1`` solves ``y[n] = a[n] * y[n-1] + b[n]`` along the trailing
(sample) axis with a carried ``y0``.  The JAX package solves it with an
associative scan, or on the TPU with the ``affine1_bank`` Pallas kernel
(``scan.py:137-147``).  Here every call goes through the bank: on a CUDA
tensor the hand-written kernel (``ops/bank_kernels.affine1_bank``), on a CPU
tensor its plain sample-sequential version.  The ``max`` branch of the bank
is disabled with the ``-3e38`` sentinel, exactly as the TPU dispatch does.

The 2-state ``linrec2`` and the cumulative-sum helpers wait for a later PR
(ROADMAP.md Queue A, item A2).
"""

from __future__ import annotations

import torch

from libgooey_tpu_torch.ops import bank_kernels

#: ``a`` value that disables the max branch of ``affine1_bank``.
NO_FLOOR = -3.0e38


def linrec1(a, b, y0) -> torch.Tensor:
    """Solve ``y[n] = a[n] * y[n-1] + b[n]`` along the last axis, ``y[-1] = y0``.

    ``a`` and ``b`` broadcast against each other; ``y0`` has the shape of one
    sample slice.  Leading axes flatten into bank rows."""
    a, b = torch.broadcast_tensors(a, b)
    lead, B = a.shape[:-1], a.shape[-1]
    R = 1
    for d in lead:
        R *= d
    y0f = torch.broadcast_to(y0.to(torch.float32), lead).reshape(R).contiguous()
    floor = torch.full((R, B), NO_FLOOR, dtype=torch.float32, device=a.device)
    y, _ = bank_kernels.affine1_bank(
        floor, a.reshape(R, B).to(torch.float32).contiguous(),
        b.reshape(R, B).to(torch.float32).contiguous(), y0f)
    return y.reshape(a.shape)


def onepole(coeff, x, y0) -> torch.Tensor:
    """One-pole lowpass toward ``x``: ``y[n] = y[n-1] + coeff*(x[n]-y[n-1])``
    with a per-sample ``coeff`` tensor broadcasting against ``x``."""
    return linrec1(1.0 - coeff, coeff * x, y0)


def linrec2(*args, **kwargs):
    from libgooey_tpu_torch import not_ported

    raise not_ported("scan.linrec2 (kernel linrec2_bank)")
