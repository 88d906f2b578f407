"""Parameter smoothing over blocks (port of libgooey_tpu/core/smoother.py:31-120).

A bank of smoothed parameters is a pair of tensors ``(current, target)`` of
identical shape (``[V, P]`` for voice banks, ``[V]`` for the mixer strips,
``[]`` for the master gain).  The per-block trajectory is the closed form

    y[k] = target + (current - target) * (1 - coeff)^(k+1),   k = 0..B-1

snapped to the target exactly once within 1e-4 (the reference's settle).
Every expression keeps the JAX package's float32 op order.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from libgooey_tpu_torch.core.constants import DEFAULT_SMOOTH_TIME_MS, SMOOTHER_SETTLE_EPS


def smoothing_coeff(sample_rate: float, smooth_time_ms: float = DEFAULT_SMOOTH_TIME_MS) -> float:
    """One-pole coefficient ``1 - e^(-1/(ms*sr/1000))`` (smoother.rs:69-77)."""
    if smooth_time_ms <= 0.0:
        return 1.0
    smooth_time_samples = (smooth_time_ms / 1000.0) * sample_rate
    return float(1.0 - np.exp(-1.0 / smooth_time_samples))


class SmootherBank(NamedTuple):
    """Smoother state: current values and staged targets."""

    current: torch.Tensor
    target: torch.Tensor

    @staticmethod
    def init(values, device) -> "SmootherBank":
        v = torch.as_tensor(np.array(values, np.float32), device=device)
        return SmootherBank(current=v, target=v)

    def with_targets(self, targets) -> "SmootherBank":
        """Stage new targets (host update between blocks)."""
        t = torch.as_tensor(np.array(targets, np.float32), device=self.current.device)
        return SmootherBank(current=self.current, target=t)

    def snapped(self) -> "SmootherBank":
        """`SmoothedParam::snap` — jump current to target (smoother.rs:99-104)."""
        return SmootherBank(current=self.target, target=self.target)


def broadcast_targets(targets, shape, device) -> torch.Tensor:
    """Staged targets as a contiguous float32 ``shape`` tensor on ``device``
    (the bus effects' ``broadcast_to(asarray(targets), (2, P))``).  A tensor
    already on the device is not copied from the host."""
    t = torch.as_tensor(targets, dtype=torch.float32, device=device)
    return t.expand(shape).contiguous()


@functools.lru_cache(maxsize=None)
def pow_table(q: float, block: int, device) -> torch.Tensor:
    """``q^(k+1)``, k = 0..block-1, each correctly rounded to float32 from
    float64 (numpy, on the host, once per ``(q, block, device)``).  This is
    what XLA's float32 ``power`` gives on the CPU (PyTorch's differs by an
    ulp at some k).  The bus delay reads its ring at ``time * sr``, where
    an ulp of the time trajectory moves the tap by ~1e-4 samples, so it takes
    its powers from here."""
    n = np.arange(1, block + 1, dtype=np.float64)
    return torch.as_tensor((np.float64(np.float32(q)) ** n).astype(np.float32),
                           device=device)


def _q(coeff) -> float:
    """``1 - f32(coeff)`` rounded to float32, as the JAX package computes it.

    Scalars stay Python numbers: a tensor built from a host value is a
    blocking copy that would stall the launch queue every block."""
    return float(np.float32(1.0) - np.float32(coeff))


def _powers(q: float, block: int, device) -> torch.Tensor:
    return torch.pow(q, torch.arange(1, block + 1, dtype=torch.float32, device=device))


def settle_snap(decayed: torch.Tensor) -> torch.Tensor:
    """Zero a decayed distance below the settle threshold (smoother.rs:131)."""
    return torch.where(decayed.abs() < SMOOTHER_SETTLE_EPS, 0.0, decayed)


def smooth_block(bank: SmootherBank, coeff, block: int):
    """Advance a smoother bank by ``block`` samples.

    Returns ``(new_bank, traj)``; ``traj`` has shape
    ``bank.current.shape + (block,)``, tick-then-return ordered with the
    exact settle-snap at 1e-4."""
    cur, tgt = bank.current, bank.target
    delta = cur - tgt
    powers = _powers(_q(coeff), block, cur.device)
    decayed = delta[..., None] * powers
    traj = tgt[..., None] + settle_snap(decayed)
    new_cur = traj[..., -1]
    return SmootherBank(current=new_cur, target=tgt), traj


def smooth_block_lazy(bank: SmootherBank, coeff, block: int):
    """:func:`smooth_block` without materializing the ``[..., block]``
    trajectory: returns ``(new_bank, traj_slice)`` where ``traj_slice(lo, hi)``
    rebuilds ``traj[lo:hi]`` with the same expressions in the same order."""
    cur, tgt = bank.current, bank.target
    delta = cur - tgt
    powers = _powers(_q(coeff), block, cur.device)

    def traj_slice(lo=None, hi=None):
        sl = slice(lo, hi)
        decayed = delta[sl][..., None] * powers
        return tgt[sl][..., None] + settle_snap(decayed)

    last = delta * powers[-1]
    new_cur = tgt + settle_snap(last)
    return SmootherBank(current=new_cur, target=tgt), traj_slice


def smooth_advance(bank: SmootherBank, coeff, block: int) -> SmootherBank:
    """Advance without materializing the trajectory; bit-identical to
    ``smooth_block(...)[0]``."""
    cur, tgt = bank.current, bank.target
    q = torch.full((), _q(coeff), dtype=torch.float32, device=cur.device)
    decayed = (cur - tgt) * torch.pow(q, float(block))
    new_cur = tgt + settle_snap(decayed)
    return SmootherBank(current=new_cur, target=tgt)


def smooth_block_traj(current, targets: torch.Tensor, coeff, axis: int = -1) -> torch.Tensor:
    """Smooth toward a per-sample target trajectory (LFO-modulated params):
    one one-pole scan from ``current`` along ``axis`` of ``targets``, with
    no settle snap (a moving target never settles).  The caller keeps the
    last sample as the new current."""
    from libgooey_tpu_torch.ops import scan as gscan

    y = gscan.onepole(coeff, targets.movedim(axis, -1), current)
    return y.movedim(-1, axis)
