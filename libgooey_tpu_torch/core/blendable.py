"""PresetBlender: 4-corner X/Y-pad bilinear blending of config dataclasses
(the port's own copy of libgooey_tpu/core/blendable.py).

Behavioral reference: src/utils/blendable.rs:33-104.  Field-wise lerp of
numeric fields; non-numeric fields (enums like filter_type) switch at the
midpoint, matching the reference's discrete Blendable impls
(e.g. hihat2.rs:126-149).
"""

from __future__ import annotations

import dataclasses


def lerp_configs(a, b, t: float):
    """Field-wise lerp of two config dataclasses of the same type."""
    t = min(max(t, 0.0), 1.0)
    vals = {}
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, bool) or isinstance(va, int):
            vals[f.name] = va if t < 0.5 else vb
        else:
            vals[f.name] = va * (1.0 - t) + vb * t
    return type(a)(**vals)


class PresetBlender:
    """Bilinear X/Y blend over 4 corner presets (BL, BR, TL, TR)."""

    def __init__(self, bottom_left, bottom_right=None, top_left=None, top_right=None):
        self.bottom_left = bottom_left
        self.bottom_right = bottom_right if bottom_right is not None else bottom_left
        self.top_left = top_left if top_left is not None else bottom_left
        self.top_right = top_right if top_right is not None else bottom_left

    @staticmethod
    def uniform(preset) -> "PresetBlender":
        return PresetBlender(preset, preset, preset, preset)

    def set_corner(self, corner: int, preset):
        """BLEND_CORNER_* constants: 0=BL, 1=BR, 2=TL, 3=TR (ffi.rs:2001-2007)."""
        attr = ("bottom_left", "bottom_right", "top_left", "top_right")[corner]
        setattr(self, attr, preset)

    def blend(self, x: float, y: float):
        x = min(max(x, 0.0), 1.0)
        y = min(max(y, 0.0), 1.0)
        bottom = lerp_configs(self.bottom_left, self.bottom_right, x)
        top = lerp_configs(self.top_left, self.top_right, x)
        return lerp_configs(bottom, top, y)
