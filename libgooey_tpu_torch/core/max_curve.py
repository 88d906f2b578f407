"""Max/MSP ``curve~`` exponential interpolation (port of
libgooey_tpu/core/max_curve.py:19-39).

Behavioral reference: src/max_curve.rs:21-48, used by the Max-ported
instruments (HiHat2, Tom2).  The multi-segment ``segments_value`` is not
ported (no caller yet).
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
