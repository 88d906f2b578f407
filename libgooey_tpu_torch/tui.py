"""Realtime terminal front-end: live scope + spectrum + peak meters
(port of libgooey_tpu/tui.py).

Behavioral reference: src/visualization/waveform_display.rs (the realtime
GLFW scope window) and the crossterm UIs of the reference examples — the
interactive surface a musician watches while playing.

The engine renders blocks on the card; this module is a host ANSI renderer
fed from the :class:`AudioBuffer` capture ring, its spectrum row from the
port's :class:`SpectrogramAnalyzer` (``torch.fft`` on ``device``).  A frame
is just a string, so it is headless-testable and works over any terminal;
``run`` drives an :class:`EngineOutput`-style adapter at a
fixed frame rate, pulling audio and repainting in place.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from libgooey_tpu_torch.visualization import AudioBuffer, SpectrogramAnalyzer

_BLOCKS = " ▁▂▃▄▅▆▇█"  # 1/8th vertical block ramp


def _meter_row(label: str, value: float, width: int) -> str:
    """One horizontal peak-meter bar, dB-scaled like the reference meters."""
    db = 20.0 * np.log10(max(float(value), 1e-6))
    frac = float(np.clip((db + 60.0) / 60.0, 0.0, 1.0))  # -60 dB..0 dB
    n = int(round(frac * width))
    return f"{label:>8s} [{'█' * n}{' ' * (width - n)}] {db:6.1f} dB"


class TerminalScope:
    """ANSI oscilloscope + spectrum for a mono capture ring.

    ``frame()`` renders one display frame as a plain string (no escape
    codes), so tests and logs can consume it; ``paint()`` wraps it in
    cursor-home ANSI codes for in-place terminal animation.  ``device``:
    where the spectrum's FFT runs; ``None`` is the card.
    """

    def __init__(self, audio_buffer: AudioBuffer, width: int = 72,
                 height: int = 12, sample_rate: float = 44100.0,
                 spectrum_rows: int = 6, fft_size: int = 1024, *, device=None):
        self.buffer = audio_buffer
        self.width = int(width)
        self.height = int(height)
        self.sr = float(sample_rate)
        self.spectrum_rows = int(spectrum_rows)
        self.analyzer = SpectrogramAnalyzer(fft_size, sample_rate, 4, device=device)
        self.meters: dict = {}

    def set_meter(self, label: str, value: float):
        """Stage a labeled peak value (strip/track meters)."""
        self.meters[label] = float(value)

    # --- rendering ----------------------------------------------------------

    def _scope_rows(self, samples: np.ndarray) -> list:
        H, W = self.height, self.width
        grid = [[" "] * W for _ in range(H)]
        mid = H // 2
        for x in range(W):
            grid[mid][x] = "·"
        if len(samples) >= 2:
            edges = np.linspace(0, len(samples), W + 1).astype(int)
            for x in range(W):
                seg = samples[edges[x]:max(edges[x + 1], edges[x] + 1)]
                lo = int(round(mid - np.clip(seg.max(), -1, 1) * (mid - 1)))
                hi = int(round(mid - np.clip(seg.min(), -1, 1) * (mid - 1)))
                for y in range(min(lo, hi), max(lo, hi) + 1):
                    grid[y][x] = "█" if abs(y - mid) > 1 else "▓"
        return ["".join(r) for r in grid]

    def _spectrum_rows(self, samples: np.ndarray) -> list:
        n = self.analyzer.fft_size
        if len(samples) < n:
            return [" " * self.width] * self.spectrum_rows
        self.analyzer.analyze(samples)
        db = self.analyzer.get_history()[-1]
        # log-frequency bins -> display columns, -72..0 dB column heights
        bins = len(db)
        idx = np.unique(np.geomspace(1, bins - 1, self.width).astype(int))
        cols = np.interp(np.linspace(0, len(idx) - 1, self.width),
                         np.arange(len(idx)), db[idx])
        frac = np.clip((cols + 72.0) / 72.0, 0.0, 1.0)
        rows = []
        for r in range(self.spectrum_rows):
            hi = 1.0 - r / self.spectrum_rows
            lo = 1.0 - (r + 1) / self.spectrum_rows
            row = []
            for f in frac:
                if f <= lo:
                    row.append(" ")
                elif f >= hi:
                    row.append("█")
                else:
                    row.append(_BLOCKS[int((f - lo) / (hi - lo) * 8)])
            rows.append("".join(row))
        return rows

    def frame(self) -> str:
        samples = self.buffer.get_samples()
        peak = float(np.abs(samples).max()) if len(samples) else 0.0
        lines = [f"┌{'─' * self.width}┐"]
        for r in self._scope_rows(samples):
            lines.append(f"│{r}│")
        lines.append(f"├{'─' * self.width}┤")
        for r in self._spectrum_rows(samples):
            lines.append(f"│{r}│")
        lines.append(f"└{'─' * self.width}┘")
        lines.append(_meter_row("master", peak, self.width - 12))
        for label, v in self.meters.items():
            lines.append(_meter_row(label, v, self.width - 12))
        return "\n".join(lines)

    def paint(self, out=None):
        """Repaint in place (ANSI cursor-home + clear-to-end)."""
        out = out or sys.stdout
        out.write("\x1b[H\x1b[J" + self.frame() + "\n")
        out.flush()

    # --- the realtime loop ----------------------------------------------------

    def run(self, output, seconds: float, fps: float = 20.0,
            frames_per_pull: int = 1024, out=None,
            clear_first: bool = True):
        """Drive an EngineOutput-style adapter and repaint at ``fps``.

        Pulls ``frames_per_pull`` frames per tick through ``output.fill``
        (the host-callback hook), pushes the downmix into the capture ring,
        and repaints.  Returns the number of painted frames.
        """
        out = out or sys.stdout
        if clear_first:
            out.write("\x1b[2J")
        painted = 0
        t_end = time.monotonic() + float(seconds)
        period = 1.0 / float(fps)
        buf = np.zeros(frames_per_pull * 2, np.float32)
        while time.monotonic() < t_end:
            t0 = time.monotonic()
            output.fill(buf, 2)
            self.buffer.push(0.5 * (buf[0::2] + buf[1::2]))
            self.paint(out)
            painted += 1
            dt = time.monotonic() - t0
            if dt < period:
                time.sleep(period - dt)
        return painted
