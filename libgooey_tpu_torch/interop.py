"""Carrying state between the JAX package and the port, through numpy.

``*_from_numpy`` turns a JAX package state (or any tree whose leaves
``np.asarray`` accepts) into the port's state on ``device``, field by field:
the port's state tuples keep the JAX field names and nesting, so both
packages compute the same thing from the same state.  ``to_numpy`` goes the
other way.  Events need no conversion: they are numpy dicts with the JAX
keys (``kick_off``, ``kick_vel``, ``block_start``) that both packages take.
"""

from __future__ import annotations

import numpy as np
import torch

from libgooey_tpu_torch.core.smoother import SmootherBank
from libgooey_tpu_torch.instruments import kick


def from_numpy(template, src, device):
    """Rebuild ``template``'s structure (a port state on the CPU) with the
    leaves of ``src``, on ``device``; fields are matched by name."""
    if isinstance(template, torch.Tensor):
        arr = np.asarray(src)
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"leaf shape {arr.shape} does not match {tuple(template.shape)}")
        return torch.as_tensor(arr.astype(template.numpy().dtype), device=device)
    return type(template)(*(from_numpy(t, getattr(src, f), device)
                            for f, t in zip(template._fields, template)))


def kick_state_from_numpy(src, device) -> kick.KickState:
    """A JAX ``KickState`` (or a tree with the same fields) -> port ``KickState``."""
    V = np.asarray(src.trig_sample).shape[0]
    return from_numpy(kick.init_state(V, device="cpu"), src, device)


def smoother_from_numpy(src, device) -> SmootherBank:
    return SmootherBank(
        current=torch.as_tensor(np.array(src.current, np.float32), device=device),
        target=torch.as_tensor(np.array(src.target, np.float32), device=device))


def engine_state_from_numpy(src: dict, device) -> dict:
    """A JAX engine state dict (``kick``, ``pan``, ``gain``, ``master``) ->
    the port's engine state dict."""
    out = {}
    for key, val in src.items():
        if key == "kick":
            out[key] = kick_state_from_numpy(val, device)
        elif key in ("pan", "gain", "master"):
            out[key] = smoother_from_numpy(val, device)
        else:
            from libgooey_tpu_torch import not_ported

            raise not_ported(f"engine state entry {key!r}")
    return out


def to_numpy(tree):
    """Port state (tensors in NamedTuples, dicts, lists) -> the same structure
    with numpy leaves."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree
