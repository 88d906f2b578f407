"""State trees: dicts, lists, tuples and NamedTuples of tensors.
``clone`` snapshots a state."""

from __future__ import annotations

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if _is_namedtuple(x):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(fn, v) for v in x)
    return x


def clone(state):
    """A copy of every tensor of ``state`` (enqueued on the card, no wait)."""
    return tree_map(lambda t: t.clone(), state)
