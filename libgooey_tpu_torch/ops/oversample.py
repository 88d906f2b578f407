"""1x/2x/4x oversampling via polyphase IIR half-band allpass pairs
(port of libgooey_tpu/ops/oversample.py:33-120,320-464).

The classic elliptic half-band decomposition H(z) = (A0(z^2) + z^-1 A1(z^2))/2
with chains of first-order allpass sections ``y = a*x + x_prev - a*y_prev``
(src/utils/oversampler.rs, the hiir design).  This module holds the
coefficients, the state and the general up/down stages: ``process`` runs a
memoryless function at 1x, 2x or 4x, as the effects at ``os_mode`` 1 and 2
(and the oversampler examples) call it.  Each allpass section runs both
polyphase branches as the rows of one ``scan.linrec1``, i.e. one
``affine1_bank`` launch on the card, so a 2x pass costs eight launches
(STAGE1's four sections a branch, up and down) and a 4x pass twelve.  The
4x voice banks and bus effects do not come here: their whole chain runs
inside the ``fbws_bank``/``ws4_bank`` and bus kernels
(ops/bank_kernels.py, ops/bus_kernels.py).  The JAX package's wide-bank
matmul formulations (``_toeplitz_consts``, ``_lifted_consts``, the ``*_mx``
chains) are TPU workarounds and are not ported.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
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


@functools.lru_cache(maxsize=None)
def _pair_consts(coefs_key, nd: int, device) -> tuple:
    """Per-section ``(a, -a)`` tensors of shape ``[2, 1, ..]`` (``nd`` dims)
    holding section i's coefficient for each polyphase branch, cached per
    device: a tensor built from host values is a blocking copy."""
    c0, c1 = _split(list(coefs_key))
    pairs = np.stack([np.asarray(c0, np.float32), np.asarray(c1, np.float32)], axis=1)
    shape = (2,) + (1,) * (nd - 1)
    out = []
    for pair in pairs:
        a = torch.as_tensor(pair, device=device).reshape(shape)
        out.append((a, -a))
    return tuple(out)


def _allpass_chain_paired(sig, coefs, y0s, x0s):
    """Run BOTH polyphase chains as one stack of first-order allpasses
    ``y = a*x + x_prev - a*y_prev`` (oversample.py:320-356, the scan form).

    ``sig`` carries a leading branch axis [2, ..., B]; states are
    [2, ..., n].  Section i of both branches is one ``scan.linrec1`` over
    the stacked rows.  Returns ``(out, y_last, x_last, y_2nd_last,
    x_2nd_last)``, the last four [2, ..., n]."""
    from libgooey_tpu_torch.ops import scan as gscan

    new_y, new_x, new_y2, new_x2 = [], [], [], []
    for i, (a, neg_a) in enumerate(_pair_consts(tuple(coefs), sig.dim(), sig.device)):
        x_prev = torch.cat([x0s[..., i:i + 1], sig[..., :-1]], dim=-1)
        b = a * sig + x_prev
        y = gscan.linrec1(neg_a, b, y0s[..., i])
        new_x.append(sig[..., -1])
        new_y.append(y[..., -1])
        new_x2.append(sig[..., -2])
        new_y2.append(y[..., -2])
        sig = y
    return (sig, torch.stack(new_y, dim=-1), torch.stack(new_x, dim=-1),
            torch.stack(new_y2, dim=-1), torch.stack(new_x2, dim=-1))


def _stage_state(state: HalfbandState, ny, nx, ny2, nx2, x1) -> HalfbandState:
    return HalfbandState(ap0=ny[0], ap0x=nx[0], ap1=ny[1], ap1x=nx[1], x1=x1,
                         ap0y2=ny2[0], ap0x2=nx2[0], ap1y2=ny2[1], ap1x2=nx2[1])


def upsample2(state: HalfbandState, x, coefs):
    """x[..., B] -> [..., 2B] interpolated at twice the rate.

    Polyphase: even outputs = A0(x) (coefs 0,2,..), odd outputs = A1(x)
    (coefs 1,3,.., the half-sample-delayed branch)."""
    sig = torch.stack([x, x], dim=0)
    y0s = torch.stack([state.ap0, state.ap1], dim=0)
    x0s = torch.stack([state.ap0x, state.ap1x], dim=0)
    out, ny, nx, ny2, nx2 = _allpass_chain_paired(sig, coefs, y0s, x0s)
    up = torch.stack([out[0], out[1]], dim=-1).reshape(x.shape[:-1] + (2 * x.shape[-1],))
    return _stage_state(state, ny, nx, ny2, nx2, state.x1), up


def downsample2(state: HalfbandState, x, coefs):
    """x[..., 2B] -> [..., B] decimated with the half-band filter."""
    even = x[..., 0::2]
    odd = x[..., 1::2]
    # phase alignment: the z^-1 branch processes the *previous* odd sample
    odd_d = torch.cat([state.x1[..., None], odd[..., :-1]], dim=-1)
    sig = torch.stack([even, odd_d], dim=0)
    y0s = torch.stack([state.ap0, state.ap1], dim=0)
    x0s = torch.stack([state.ap0x, state.ap1x], dim=0)
    out, ny, nx, ny2, nx2 = _allpass_chain_paired(sig, coefs, y0s, x0s)
    down = 0.5 * (out[0] + out[1])
    return _stage_state(state, ny, nx, ny2, nx2, odd[..., -1]), down


def process(state: OversamplerState, fn, x, mode: int = 4):
    """Evaluate ``fn`` at 1x/2x/4x around up/down half-band stages.

    mode: 1 (off), 2, or 4 (reference OversamplingMode, oversampler.rs:8-31).
    Returns ``(new_state, y)`` with y at the input rate."""
    if mode == 1:
        return state, fn(x)
    if mode == 2:
        u1, hi = upsample2(state.up1, x, STAGE1)
        d1, y = downsample2(state.down1, fn(hi), STAGE1)
        return state._replace(up1=u1, down1=d1), y
    if mode == 4:
        u1, hi2 = upsample2(state.up1, x, STAGE1)
        u2, hi4 = upsample2(state.up2, hi2, STAGE2)
        d2, lo2 = downsample2(state.down2, fn(hi4), STAGE2)
        d1, y = downsample2(state.down1, lo2, STAGE1)
        return OversamplerState(up1=u1, up2=u2, down2=d2, down1=d1), y
    raise ValueError(f"unsupported oversampling mode {mode}")


def stateful(state: OversamplerState, mode: int = 4):
    """Adapter for the effects' ``oversample(fn, x)`` hook.

    Returns ``(wrap, box)``: ``wrap`` evaluates fn through the up/down
    chain, threading the state through ``box['state']``."""
    box = {"state": state}

    def wrap(fn, v):
        new_state, y = process(box["state"], fn, v, mode)
        box["state"] = new_state
        return y

    return wrap, box


def repeat_to_rate(param, v, block_size: int):
    """Hold an engine-rate per-sample parameter trajectory across each
    oversampled subsample group (the reference evaluates nonlinear curves
    2x/4x per engine sample with that sample's parameter values)."""
    factor = v.shape[-1] // block_size
    if (factor <= 1 or not isinstance(param, torch.Tensor) or param.dim() == 0
            or param.shape[-1] != block_size):
        return param
    return torch.repeat_interleave(param, factor, dim=-1)
