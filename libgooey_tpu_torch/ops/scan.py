"""Blocked linear recurrences (port of libgooey_tpu/ops/scan.py:115-386).

``linrec1`` solves ``y[n] = a[n] * y[n-1] + b[n]`` and ``linrec2`` the
2-state ``s[n] = A[n] s[n-1] + b[n]`` along the trailing (sample) axis with
carried initial state.  The JAX package solves them with associative scans,
or on the TPU with the ``affine1_bank`` / ``linrec2_bank`` Pallas kernels
(``scan.py:137-147,205-222``).  Here every call goes through the bank
kernels: on a CUDA tensor the hand-written kernel (``ops/bank_kernels.py``),
on a CPU tensor its plain sample-sequential version.  Leading axes flatten
into bank rows.  The ``max`` branch of ``affine1_bank`` is disabled with the
``-3e38`` sentinel for the linear recurrences, exactly as the TPU dispatch
does: the port passes ``a = None``, and the kernel takes the sentinel as a
constant instead of reading a floor array (the same bits); ``maxlin`` uses
the branch live.

The JAX package's other first-order kernel, ``pallas_scan.linrec1_pallas``
(``pallas_scan.py:60``, opt-in through ``scan.USE_PALLAS``), computes the
same function as ``affine1_bank`` with that floor: the switch only picks
between two TPU lowerings of one recurrence.  So every ``linrec1`` here is
its counterpart, and the port has no such switch
(tests/test_torch_grain_kernels.py holds ``linrec1`` to it).
"""

from __future__ import annotations

import numpy as np
import torch

from libgooey_tpu_torch.ops import bank_kernels


def _rows(shape) -> int:
    n = 1
    for d in shape[:-1]:
        n *= d
    return n


def _flat(v, R, B):
    return v.reshape(R, B).to(torch.float32).contiguous()


def _flat0(y0, lead, R):
    return torch.broadcast_to(y0.to(torch.float32), lead).reshape(R).contiguous()


def _affine1(a, b, c, y0):
    """``y[n] = max(a[n], b[n]*y[n-1] + c[n])`` over any leading shape
    (``a = None``: the plain first-order recurrence)."""
    if a is None:
        b, c = torch.broadcast_tensors(b, c)
    else:
        a, b, c = torch.broadcast_tensors(a, b, c)
    lead, B = b.shape[:-1], b.shape[-1]
    R = _rows(b.shape)
    y, _ = bank_kernels.affine1_bank(None if a is None else _flat(a, R, B), _flat(b, R, B),
                                     _flat(c, R, B), _flat0(y0, lead, R))
    return y.reshape(b.shape)


def linrec1(a, b, y0) -> torch.Tensor:
    """Solve ``y[n] = a[n] * y[n-1] + b[n]`` along the last axis, ``y[-1] = y0``.

    ``a`` and ``b`` broadcast against each other; ``y0`` has the shape of one
    sample slice."""
    return _affine1(None, a, b, y0)


def onepole(coeff, x, y0) -> torch.Tensor:
    """One-pole lowpass toward ``x``: ``y[n] = y[n-1] + coeff*(x[n]-y[n-1])``
    with a per-sample ``coeff`` tensor broadcasting against ``x``, or a
    Python number, rounded to float32 before ``1 - coeff`` as the JAX
    package's ``jnp.asarray(coeff)`` rounds it (``scan.py:165-166``)."""
    if not isinstance(coeff, torch.Tensor):
        c = np.float32(coeff)
        return linrec1(torch.full_like(x, float(np.float32(1.0) - c)), float(c) * x, y0)
    return linrec1(1.0 - coeff, coeff * x, y0)


def onepole_const(coeff, x_const, y0, n: int, axis: int = -1) -> torch.Tensor:
    """Closed form of :func:`onepole` toward an input constant over ``n``
    samples: ``y[k] = x + (y0 - x) * (1-coeff)^(k+1)``, k = 0..n-1.

    ``x_const`` and ``y0`` are slice-shaped; the result gains a sample axis
    at ``axis``.  A Python ``coeff`` takes its powers correctly rounded from
    float64, as XLA's float32 ``power`` gives them (``smoother.pow_table``)."""
    from libgooey_tpu_torch.core.smoother import _q, pow_table

    x_const = torch.as_tensor(x_const, dtype=torch.float32)
    y0 = torch.as_tensor(y0, dtype=torch.float32, device=x_const.device)
    if isinstance(coeff, torch.Tensor):
        powers = torch.pow(1.0 - coeff.to(torch.float32), torch.arange(
            1, n + 1, dtype=torch.float32, device=x_const.device))
    else:
        powers = pow_table(_q(coeff), n, x_const.device)
    y = x_const[..., None] + (y0 - x_const)[..., None] * powers
    return y if axis == -1 else y.movedim(-1, axis)


def linrec2(a11, a12, a21, a22, b1, b2, s0):
    """Solve ``s[n] = A[n] s[n-1] + b[n]`` for a 2-vector state along the
    last axis; ``s0 = (s1_0, s2_0)`` slice-shaped.  Returns the post-update
    trajectories ``(s1, s2)``.

    The Chamberlin SVF, the RBJ biquads and the membrane bands run here.
    Every call is sample-sequential in the Pallas body's op order: the
    resonators are high-Q and ring across blocks, so a reassociated scan
    would drift (``scan.py:49-58``)."""
    arrs = torch.broadcast_tensors(a11, a12, a21, a22, b1, b2)
    lead, B = arrs[0].shape[:-1], arrs[0].shape[-1]
    R = _rows(arrs[0].shape)
    s1, s2, _, _ = bank_kernels.linrec2_bank(
        *(_flat(v, R, B) for v in arrs), _flat0(s0[0], lead, R), _flat0(s0[1], lead, R))
    return s1.reshape(arrs[0].shape), s2.reshape(arrs[0].shape)


def cumsum_bank(x) -> torch.Tensor:
    """Cumulative sum along the last axis through ``affine1_bank`` (``a = 1``),
    as the TPU routes it; sequential summation rounds no worse than a tree."""
    return _affine1(None, torch.ones_like(x, dtype=torch.float32), x,
                    torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device))


def cumsum_reset(x, reset, reset_base, y0) -> torch.Tensor:
    """Cumulative sum that restarts at reset points:
    ``y[n] = x[n] + (reset[n] ? reset_base[n] : y[n-1])``, ``y[-1] = y0``."""
    reset_f = reset.to(x.dtype)
    return linrec1(1.0 - reset_f, x + reset_f * reset_base, y0)


def phase_cumsum_reset(inc, reset, carry) -> torch.Tensor:
    """Mod-1 oscillator phase with trigger resets, accurate to ~1e-7 cycles
    (``scan.py:300-339``, op for op).

    ``y[n] = inc[n] + (reset[n] ? 0 : y[n-1])`` reduced mod 1.  The
    block-start increment is split ``inc0 = hi + lo`` with ``hi`` on a
    2^-11 grid, so ``hi*(n+1)`` and its mod-1 reduction are exact in f32;
    ``lo*(n+1)`` and the residual cumsum of ``inc - inc0`` carry one
    rounding each.  ``carry`` is the previous block's last phase; carry
    forward ``out[..., -1]``."""
    inc = inc.to(torch.float32)
    reset_f = reset.to(torch.float32)
    B = inc.shape[-1]
    n1 = torch.arange(1, B + 1, dtype=torch.float32, device=inc.device)
    inc0 = inc[..., 0:1]
    hi = torch.floor(inc0 * 2048.0) * float(1.0 / 2048.0)
    lo = inc0 - hi                            # exact (Sterbenz)
    ramp_hi = hi * n1                         # exact: <= 2^24 grid steps
    ramp_hi = ramp_hi - torch.floor(ramp_hi)  # exact mod-1 (2^-11 grid)
    ramp = ramp_hi + lo * n1
    resid = cumsum_bank(inc - inc0)
    p = torch.remainder(ramp + resid, 1.0)    # mod-1 prefix sums
    # base latch: the mod-1 prefix just before the governing reset
    p_prev = torch.cat([torch.zeros_like(inc0), p[..., :-1]], dim=-1)
    base = linrec1(1.0 - reset_f, reset_f * p_prev, -carry.to(torch.float32))
    return torch.remainder(p - base, 1.0)


def maxlin(a, b, c, y0) -> torch.Tensor:
    """Solve ``y[n] = max(a[n], b[n]*y[n-1] + c[n])`` through ``affine1_bank``
    (the "instant up, smoothed down" trackers, hihat2.rs:290-320)."""
    return _affine1(a, b, c, y0)


def asym_smooth(target, down_coeff: float, y0, reset=None) -> torch.Tensor:
    """Asymmetric smoother: instant up, one-pole down (hihat2.rs:290-320).

    ``reset`` forces the state to 0 at masked samples before processing
    (the trigger resets the smoother to 0, hihat2.rs:443)."""
    k = float(torch.tensor(down_coeff, dtype=torch.float32))
    one_minus_k = float(1.0 - torch.tensor(down_coeff, dtype=torch.float32))
    b = torch.full_like(target, one_minus_k)
    if reset is not None:
        b = torch.where(reset, 0.0, b)
    return maxlin(target, b, k * target, y0)


def _tree(fn, *trees):
    """``fn`` over the tensors of matching tuples, lists and dicts."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        out = [_tree(fn, *xs) for xs in zip(*trees)]
        return type(t)(*out) if hasattr(t, "_fields") else type(t)(out)
    return fn(*trees)


def nonlinear_scan(step_fn, state, xs, axis: int = -1):
    """Sequential per-sample loop for a nonlinear recurrence.

    ``step_fn(state, x_slice) -> (state, y_slice)`` on slices without the
    sample axis (``[V]``-shaped); ``xs`` is a tree (tuples, lists, dicts)
    of tensors with the sample axis at ``axis``.  B steps in order, each
    over every voice at once (the JAX package's ``lax.scan``); returns
    ``(state, ys)`` with ``ys``' sample axis at ``axis``."""
    xs_t = _tree(lambda v: v.movedim(axis, 0), xs)
    n = next(iter(_leaves(xs_t))).shape[0]
    ys = []
    for i in range(n):
        state, y = step_fn(state, _tree(lambda v: v[i], xs_t))
        ys.append(y)
    return state, _tree(lambda *vs: torch.stack(vs, dim=0).movedim(0, axis), *ys)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree
