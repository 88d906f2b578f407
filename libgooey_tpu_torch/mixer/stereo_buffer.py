"""StereoSampleBuffer: immutable stereo PCM + the device-side cubic reader
(port of libgooey_tpu/mixer/stereo_buffer.py).

Behavioral reference: src/mixer/stereo_buffer.rs (296 LoC) — L/R sample data
+ sample_rate + optional source_bpm tag; constructors from channels /
interleaved / WAV (mono duplicated, >2ch takes the first two); cubic
`read_interpolated` (edge-clamped taps) and wrap-aware `read_wrapped`.

The buffer stays numpy on the host.  :func:`read_cubic` is a gather that
the JAX package computes outside any Pallas kernel, so its port is plain
PyTorch in the JAX op order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class StereoSampleBuffer:
    left: np.ndarray
    right: np.ndarray
    sample_rate: float
    source_bpm: Optional[float] = None

    def __post_init__(self):
        assert self.left.shape == self.right.shape and self.left.ndim == 1

    def __len__(self):
        return len(self.left)

    @staticmethod
    def from_channels(left, right, sample_rate, source_bpm=None):
        return StereoSampleBuffer(
            np.asarray(left, np.float32), np.asarray(right, np.float32),
            float(sample_rate), source_bpm,
        )

    @staticmethod
    def from_interleaved(samples, channels: int, sample_rate, source_bpm=None):
        x = np.asarray(samples, np.float32).reshape(-1, channels)
        if channels == 1:
            return StereoSampleBuffer.from_channels(x[:, 0], x[:, 0], sample_rate, source_bpm)
        return StereoSampleBuffer.from_channels(x[:, 0], x[:, 1], sample_rate, source_bpm)

    @staticmethod
    def from_wav(path, source_bpm=None):
        from libgooey_tpu_torch.io_wav import read_wav

        data, rate = read_wav(path)
        if data.shape[0] == 1:
            return StereoSampleBuffer.from_channels(data[0], data[0], rate, source_bpm)
        return StereoSampleBuffer.from_channels(data[0], data[1], rate, source_bpm)

    def device_array(self) -> np.ndarray:
        """[2, L] array for device upload."""
        return np.stack([self.left, self.right])


def read_cubic(buf, positions, wrap: bool, length=None, base=None):
    """Cubic 4-tap read of ``buf[2, L]`` at float32 ``positions[B]``.

    ``wrap=False`` clamps the taps at the edges (stereo_buffer.rs:198-223);
    ``wrap=True`` wraps them mod len (rs:232-257), a floor-mod as
    ``jnp.mod`` (``torch.remainder``, never ``torch.fmod``).  ``length``
    (scalar or per-sample float32 [B]) bounds the valid data region of a
    capacity-padded array; ``base`` (same shape, integer) offsets into a
    pooled array holding several regions.  Returns ``[2, B]``.
    """
    L = buf.shape[-1]
    dev = positions.device
    length = torch.as_tensor(L if length is None else length, dtype=torch.float32, device=dev)
    base = torch.as_tensor(0 if base is None else base, device=dev).to(torch.int64)
    if wrap:
        pos = torch.remainder(positions, length)
    else:
        pos = torch.minimum(torch.clamp(positions, min=0.0), length - 1.0)
    idx = torch.floor(pos).to(torch.int64)
    frac = pos - torch.floor(pos)
    len_i = length.to(torch.int64)

    def tap(k):
        i = idx + k
        i = torch.remainder(i, len_i) if wrap else torch.minimum(torch.clamp(i, min=0), len_i - 1)
        return buf[:, base + i]

    p0, p1, p2, p3 = tap(-1), tap(0), tap(1), tap(2)
    a0 = -0.5 * p0 + 1.5 * p1 - 1.5 * p2 + 0.5 * p3
    a1 = p0 - 2.5 * p1 + 2.0 * p2 - 0.5 * p3
    a2 = -0.5 * p0 + 0.5 * p2
    return ((a0 * frac + a1) * frac + a2) * frac + p1
