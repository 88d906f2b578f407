"""Visualization: audio capture ring, spectrogram analyzer, waveform renderer
(port of libgooey_tpu/visualization.py).

Behavioral reference: src/visualization.rs (AudioBuffer ring),
src/visualization/spectrogram.rs (Hann-windowed FFT -> dB magnitude
history), src/visualization/waveform_display.rs (the GLFW/OpenGL scope).

The FFT runs on the card as one ``torch.fft.rfft`` over ``[frames,
fft_size]`` windows (``analyze_many``) where the JAX package calls
``jnp.fft``; no Pallas kernel is involved.  The ring and the display stay on
the host in numpy, as in the JAX package: the display renders offscreen to
an RGB array (no GL context exists headless; hosts blit the array).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List

import numpy as np
import torch

from libgooey_tpu_torch import card_or


class AudioBuffer:
    """Thread-safe mono capture ring (visualization.rs:21-58)."""

    def __init__(self, capacity: int):
        self._capacity = int(capacity)
        self._buf = deque(maxlen=self._capacity)
        self._lock = threading.Lock()

    def push(self, sample):
        """Append a sample, or a whole block (the engine produces blocks,
        so per-sample pushes would be pure overhead)."""
        arr = np.atleast_1d(np.asarray(sample, np.float32))
        with self._lock:
            self._buf.extend(arr.tolist())

    def get_samples(self) -> np.ndarray:
        with self._lock:
            return np.asarray(self._buf, np.float32)

    def capacity(self) -> int:
        return self._capacity


def _hann(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float32)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * i / n))


class SpectrogramAnalyzer:
    """Hann FFT -> dB magnitudes with bounded history (spectrogram.rs:5-83).

    ``device``: where the FFT runs; ``None`` is the card."""

    def __init__(self, fft_size: int, sample_rate: float, max_history: int, *, device=None):
        self.fft_size = int(fft_size)
        self.sample_rate = float(sample_rate)
        self.max_history = int(max_history)
        self.history: deque = deque(maxlen=self.max_history)
        self.device = card_or(device, "SpectrogramAnalyzer")
        self._window = _hann(self.fft_size)
        self._window_dev = torch.as_tensor(self._window, device=self.device)

    def _db(self, frames: np.ndarray) -> np.ndarray:
        """``[N, fft_size]`` host frames -> ``[N, fft_size/2]`` dB rows."""
        x = torch.as_tensor(frames, device=self.device) * self._window_dev
        spec = torch.fft.rfft(x, dim=-1)
        mags = spec[:, : self.fft_size // 2].abs()
        return (20.0 * torch.log10(mags + 1e-10)).cpu().numpy().astype(np.float32)

    def analyze(self, samples) -> None:
        """Window + FFT the last fft_size samples; push dB magnitudes."""
        samples = np.asarray(samples, np.float32)
        if len(samples) < self.fft_size:
            return
        self.history.append(self._db(samples[None, -self.fft_size:])[0])

    def analyze_many(self, frames) -> None:
        """Batched path: frames [N, fft_size] -> one device FFT call."""
        for row in self._db(np.asarray(frames, np.float32)):
            self.history.append(row)

    def get_history(self) -> List[np.ndarray]:
        return list(self.history)

    def bin_to_frequency(self, bin_index: int) -> float:
        return bin_index * self.sample_rate / self.fft_size

    def num_bins(self) -> int:
        return self.fft_size // 2


class WaveformDisplay:
    """Offscreen oscilloscope (waveform_display.rs:13-259, minus the GL
    window): renders the capture ring to an RGB uint8 image the host can
    blit.  ``update()`` re-renders and returns an (empty) event list;
    ``should_close()`` is always False headless."""

    BACKGROUND = (16, 16, 24)
    CENTER_LINE = (64, 64, 80)
    TRACE = (64, 220, 128)

    def __init__(self, audio_buffer: AudioBuffer, width: int, height: int,
                 sample_rate: float):
        self.audio_buffer = audio_buffer
        self.width = int(width)
        self.height = int(height)
        self.sample_rate = float(sample_rate)
        self._image = np.zeros((self.height, self.width, 3), np.uint8)
        self._closed = False

    def update(self) -> list:
        self.render()
        return []

    def should_close(self) -> bool:
        return self._closed

    def close(self):
        self._closed = True

    def render(self) -> np.ndarray:
        img = self._image
        img[:] = self.BACKGROUND
        mid = self.height // 2
        img[mid, :] = self.CENTER_LINE
        samples = self.audio_buffer.get_samples()
        if len(samples) >= 2:
            # resample the ring to one column per pixel (min/max per bin so
            # transients stay visible at any zoom)
            edges = np.linspace(0, len(samples), self.width + 1).astype(int)
            for x in range(self.width):
                seg = samples[edges[x]:max(edges[x + 1], edges[x] + 1)]
                lo = int(mid - np.clip(seg.max(), -1, 1) * (mid - 1))
                hi = int(mid - np.clip(seg.min(), -1, 1) * (mid - 1))
                img[min(lo, hi):max(lo, hi) + 1, x] = self.TRACE
        return img
