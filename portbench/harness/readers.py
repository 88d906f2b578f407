"""Arithmetic the metrics' readers (``metrics/<name>.py``) share.  Each
returns None where its source holds nothing to read."""

from __future__ import annotations

import statistics

from portbench.harness import work


def percentile(values, q: int):
    """The ``q``-th percentile (``statistics.quantiles``, inclusive)."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def host_ms_per_block(ctx, names):
    """Host milliseconds a block inside the harness's calls ``names``, over
    the window's blocks before its traced stretch."""
    w = ctx.window
    if not w.span_blocks or not any(n in w.spans for n in names):
        return None
    return 1e3 * sum(w.spans.get(n, 0.0) for n in names) / w.span_blocks


def idle_pct(ctx):
    t = ctx.trace
    if t is None or t.window_us <= 0.0 or t.busy_us <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)


def ops_per_block(ctx, pred=lambda name: True):
    t = ctx.trace
    if t is None or not t.ops:
        return None
    return sum(1 for n, _s, _d in t.ops if pred(n)) / t.blocks


def eager_device_ms_per_block(ctx):
    """Device milliseconds a block of the operations that are not the
    program's hand-written kernels: PyTorch's kernels, copies, memsets."""
    t = ctx.trace
    if t is None or not t.ops:
        return None
    us = sum(d for n, _s, d in t.ops if not work.is_port_op(n, ctx.port_kernels))
    return us * 1e-3 / t.blocks


def roofline_pct(ctx, group):
    if ctx.trace is None:
        return None
    return work.roofline_pct(ctx, group)
