"""Block-granular state freezes for bypass branches (port of
libgooey_tpu/effects/freeze.py:25-49).

When EVERY sample of a block is bypassed, the caller swaps the freshly
computed state back for the incoming one, so a bypass span longer than a
block holds state exactly like the reference's early return; only the
boundary blocks deviate (the JAX package's semantics, kept on purpose).
"""

from __future__ import annotations

import numpy as np
import torch

from libgooey_tpu_torch.core.smoother import settle_snap


def hold_where(held: torch.Tensor, old_tree, new_tree):
    """Per-row state select: ``held`` is a bool mask over the leading
    (voice) axis; held rows keep ``old_tree``'s leaves.  Trees are nested
    NamedTuples of tensors with identical structure."""
    if isinstance(new_tree, torch.Tensor):
        m = held.reshape(held.shape + (1,) * (new_tree.dim() - held.dim()))
        return torch.where(m, old_tree, new_tree)
    return type(new_tree)(*(hold_where(held, o, n) for o, n in zip(old_tree, new_tree)))


def traj_ends(cur: torch.Tensor, tgt: torch.Tensor, q: float, block_size: int):
    """``(first, last)``: a settle-snapped one-pole smoother trajectory
    ``tgt + snap(delta * q^n)`` at the block's first and last sample.  It is
    monotone in n, so these bound it over the block.  ``q`` is the float32
    retention ``1 - coeff`` as a Python number."""
    delta = cur - tgt
    first = tgt + settle_snap(delta * q)
    last = tgt + settle_snap(delta * float(np.float32(q) ** np.float32(block_size)))
    return first, last


def traj_all_below(cur: torch.Tensor, tgt: torch.Tensor, q: float, block_size: int,
                   thresh: float) -> torch.Tensor:
    """Whether the trajectory of :func:`traj_ends` stays below ``thresh``
    for the whole block, as a bool tensor on the device (no host read: the
    result feeds :func:`hold_where`)."""
    first, last = traj_ends(cur, tgt, q, block_size)
    return (first < thresh) & (last < thresh)
