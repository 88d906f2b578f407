"""Block-granular state freezes for bypass branches (port of
libgooey_tpu/effects/freeze.py:25-34).

When EVERY sample of a block is bypassed, the caller swaps the freshly
computed state back for the incoming one, so a bypass span longer than a
block holds state exactly like the reference's early return; only the
boundary blocks deviate (the JAX package's semantics, kept on purpose).
"""

from __future__ import annotations

import torch


def hold_where(held: torch.Tensor, old_tree, new_tree):
    """Per-row state select: ``held`` is a bool mask over the leading
    (voice) axis; held rows keep ``old_tree``'s leaves.  Trees are nested
    NamedTuples of tensors with identical structure."""
    if isinstance(new_tree, torch.Tensor):
        m = held.reshape(held.shape + (1,) * (new_tree.dim() - held.dim()))
        return torch.where(m, old_tree, new_tree)
    return type(new_tree)(*(hold_where(held, o, n) for o, n in zip(old_tree, new_tree)))
