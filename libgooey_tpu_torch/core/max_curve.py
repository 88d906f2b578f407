"""Max/MSP ``curve~`` exponential interpolation (port of
libgooey_tpu/core/max_curve.py).

Behavioral reference: src/max_curve.rs:21-48, used by the Max-ported
instruments (HiHat2, Tom2), and the multi-segment ``MaxCurveEnvelope``
(src/max_curve.rs:76-180) as a pure function of elapsed time
(``segments_value``).
"""

from __future__ import annotations

import torch


def _one_sided_coeffs(cabs: torch.Tensor):
    """``(fp, expm1(fp))`` of the curve~ formula, float32."""
    hp = torch.pow((cabs + 1e-20) * 1.2, 0.41) * 0.91
    fp = hp / (1.0 - hp)
    return fp, torch.expm1(fp)


def max_curve(progress: torch.Tensor, curve: float) -> torch.Tensor:
    """Exact Max/MSP curve~ interpolation of ``progress`` in [0, 1].

    ``curve`` in [-1, 1] (a Python number, as every caller passes): 0 is
    linear, positive starts slow and ends fast, negative is mirrored.  The
    curve's constants are computed once in float32 on the host (no scalar is
    copied to the device); the per-sample math keeps the JAX op order."""
    p = torch.clamp(progress, 0.0, 1.0)
    c = torch.tensor(curve, dtype=torch.float32)
    cabs = c.abs()
    if float(cabs) < 1e-6:
        return p
    fp, den = (float(v) for v in _one_sided_coeffs(cabs))

    def one_sided(q):
        # linear for vanishing fp (the reference guards fp < 1e-6)
        return q if abs(fp) < 1e-6 else torch.expm1(fp * q) / den

    if float(c) < 0.0:
        return 1.0 - one_sided(1.0 - p)
    return one_sided(p)


def segments_value(elapsed: torch.Tensor, start_value, targets, durations, curves):
    """A multi-segment curve~ envelope at ``elapsed`` seconds (any shape).

    ``targets``, ``durations`` (seconds) and ``curves`` (Python numbers)
    hold one entry a segment; targets and durations broadcast against
    ``elapsed``.  Segment k spans ``[sum(dur[:k]), sum(dur[:k+1]))`` and
    runs from the previous segment's target; past the last segment the
    value holds its target (src/max_curve.rs:141-147), and a negative
    elapsed gives ``start_value``."""
    dev = elapsed.device
    value = torch.zeros_like(elapsed) + start_value
    seg_start_t = torch.zeros_like(elapsed)
    seg_start_v = value
    for target, dur, curve in zip(targets, durations, curves):
        dur = torch.clamp(torch.as_tensor(dur, dtype=torch.float32, device=dev), min=0.0)
        target = torch.zeros_like(elapsed) + target
        local = elapsed - seg_start_t
        prog = torch.where(dur > 0.0, local / torch.clamp(dur, min=1e-30), 1.0)
        seg_val = seg_start_v + (target - seg_start_v) * max_curve(prog, curve)
        # inside this segment: its curved value; past it: its target; before
        # it (elapsed in an earlier segment): the value so far
        value = torch.where(local < dur, torch.where(local >= 0.0, seg_val, value), target)
        seg_start_t = seg_start_t + dur
        seg_start_v = target
    return torch.where(elapsed < 0.0, torch.zeros_like(elapsed) + start_value, value)
