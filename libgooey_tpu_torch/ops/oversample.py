"""4x oversampling state and half-band coefficients
(port of libgooey_tpu/ops/oversample.py:33-120,400-416).

The classic elliptic half-band decomposition H(z) = (A0(z^2) + z^-1 A1(z^2))/2
with chains of first-order allpass sections ``y = a*(x - y1) + x1``
(src/utils/oversampler.rs, the hiir design).  This module holds the
coefficients and the state only: the chains themselves run inside the
``fbws_bank`` kernel (ops/bank_kernels.py), whose plain version steps them
sample by sample.  The JAX package's wide-bank matmul formulations are TPU
workarounds and are not ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def design_halfband(n_coefs: int, transition: float):
    """Analytic elliptic half-band allpass coefficients (float64 list).

    ``transition``: normalized transition bandwidth (fraction of fs)."""
    k = math.tan((1.0 - transition * 2.0) * math.pi / 4.0)
    k *= k
    ksqrt4 = (1.0 - k * k) ** 0.25
    e = 0.5 * (1.0 - ksqrt4) / (1.0 + ksqrt4)
    q = e * (1.0 + e**4 * (2.0 + e**4 * (15.0 + 150.0 * e**4)))
    order = n_coefs * 2 + 1

    def acc_num(c):
        acc, i, sign = 0.0, 0, 1.0
        while True:
            term = sign * (q ** (i * (i + 1))) * math.sin((2 * i + 1) * c)
            acc += term
            if abs(term) < 1e-100:
                break
            i += 1
            sign = -sign
        return acc

    def acc_den(c):
        acc, i, sign = 0.0, 1, -1.0
        while True:
            term = sign * (q ** (i * i)) * math.cos(2 * i * c)
            acc += term
            if abs(term) < 1e-100:
                break
            i += 1
            sign = -sign
        return acc

    coefs = []
    for idx in range(1, n_coefs + 1):
        c = math.pi * idx / order
        ww = (q**0.25) * acc_num(c) / (acc_den(c) + 0.5)
        wwsq = ww * ww
        x = math.sqrt((1.0 - wwsq * k) * (1.0 - wwsq / k)) / (1.0 + wwsq)
        coefs.append((1.0 - x) / (1.0 + x))
    return coefs


#: Stage designs: (n_coefs, transition), as in the JAX package.
STAGE1 = design_halfband(8, 0.04)    # ~>95 dB, passband to ~0.21 fs
STAGE2 = design_halfband(4, 0.20)    # wide-transition cleanup stage


def _split(coefs):
    """hiir phase split: even-indexed coefs drive the z^-1-delayed branch."""
    return coefs[0::2], coefs[1::2]


class HalfbandState(NamedTuple):
    """Per-section states for one half-band (both phases + input delay).

    ``*y2``/``*x2`` hold each section's second-to-last output/input sample,
    kept for state parity with the JAX package."""

    ap0: torch.Tensor   # [V, n0]
    ap0x: torch.Tensor  # [V, n0] previous-input memories
    ap1: torch.Tensor
    ap1x: torch.Tensor
    x1: torch.Tensor    # [V] previous input sample (odd-phase delay)
    ap0y2: torch.Tensor  # [V, n0] second-to-last outputs
    ap0x2: torch.Tensor  # [V, n0] second-to-last inputs
    ap1y2: torch.Tensor
    ap1x2: torch.Tensor

    @staticmethod
    def init(coefs, batch, device) -> "HalfbandState":
        batch = (batch,) if isinstance(batch, int) else tuple(batch)
        c0, c1 = _split(coefs)

        def z(n=None):
            shape = batch if n is None else batch + (n,)
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return HalfbandState(
            ap0=z(len(c0)), ap0x=z(len(c0)), ap1=z(len(c1)), ap1x=z(len(c1)),
            x1=z(),
            ap0y2=z(len(c0)), ap0x2=z(len(c0)), ap1y2=z(len(c1)), ap1x2=z(len(c1)),
        )


class OversamplerState(NamedTuple):
    """Full 4x state: two up stages + two down stages."""

    up1: HalfbandState
    up2: HalfbandState
    down2: HalfbandState
    down1: HalfbandState

    @staticmethod
    def init(batch, device) -> "OversamplerState":
        return OversamplerState(
            up1=HalfbandState.init(STAGE1, batch, device),
            up2=HalfbandState.init(STAGE2, batch, device),
            down2=HalfbandState.init(STAGE2, batch, device),
            down1=HalfbandState.init(STAGE1, batch, device),
        )
