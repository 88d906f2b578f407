"""ClipGrid: Ableton-style 4×8 session grid over the loop channels (port of
libgooey_tpu/mixer/clip_grid.py; host numpy, copied as it is).

Behavioral reference: src/mixer/clip_grid.rs (982 LoC).

* monotonic f64 beat transport advanced ``bpm/(60*sr)`` per sample
  (rs:167-169);
* launch/stop/scene-launch quantized to 16th/quarter/bar or exact beat with
  boundary-epsilon handling (rs:174-191); a stopped transport launches at
  beat 0;
* clip = buffer + source_bpm → length_beats (rs:87-104); per-slot trim
  (wrap allowed) with immediate or next-boundary retrim, kept in a separate
  pending slot so retrims don't cancel launches (rs:114-137);
* on activate: load the clip into the column's channel, PreservePitch,
  speed 1, stored trim applied first (rs activate); states
  LOADED|PLAYING|QUEUED (rs:15-17).

Pure host control logic (exact f64) driving LoopChannelHost objects.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from libgooey_tpu_torch.mixer.loop_channel import PITCH_PRESERVE, LoopChannelHost
from libgooey_tpu_torch.mixer.stereo_buffer import StereoSampleBuffer

CLIP_COLUMNS = 4
CLIP_ROWS = 8

QUANTIZE_SIXTEENTH, QUANTIZE_QUARTER, QUANTIZE_BAR, QUANTIZE_IMMEDIATE = 0, 1, 2, 3
QUANT_BEATS = {QUANTIZE_SIXTEENTH: 0.25, QUANTIZE_QUARTER: 1.0, QUANTIZE_BAR: 4.0}

STATE_LOADED = 1 << 0
STATE_PLAYING = 1 << 1
STATE_QUEUED = 1 << 2

RETRIM_IMMEDIATE, RETRIM_NEXT_BOUNDARY = 0, 1


@dataclass
class Clip:
    buffer: StereoSampleBuffer
    length_beats: float
    trim_start: float = 0.0
    trim_end: float = 1.0

    @staticmethod
    def make(buffer: StereoSampleBuffer, source_bpm: float) -> Optional["Clip"]:
        if not np.isfinite(source_bpm) or source_bpm <= 0 or len(buffer) == 0:
            return None
        length_beats = len(buffer) / buffer.sample_rate * source_bpm / 60.0
        if not np.isfinite(length_beats) or length_beats <= 0:
            return None
        buf = StereoSampleBuffer(buffer.left, buffer.right, buffer.sample_rate,
                                 source_bpm)
        return Clip(buf, length_beats)


@dataclass
class _Pending:
    kind: str          # "launch" | "stop" | "stop_unload"
    row: int
    beat: float


@dataclass
class _PendingRetrim:
    beat: float
    start: float
    end: float


class ClipGrid:
    def __init__(self, sample_rate: float, bpm: float):
        self.sr = sample_rate
        self.bpm = bpm
        self.slots: List[List[Optional[Clip]]] = [
            [None] * CLIP_ROWS for _ in range(CLIP_COLUMNS)
        ]
        self.active_row: List[Optional[int]] = [None] * CLIP_COLUMNS
        self.launch_beat = [0.0] * CLIP_COLUMNS
        self.pending: List[Optional[_Pending]] = [None] * CLIP_COLUMNS
        self.pending_retrim: List[Optional[_PendingRetrim]] = [None] * CLIP_COLUMNS
        self.default_quantization = QUANTIZE_BAR
        self.transport_beat = 0.0
        self.transport_running = False

    # --- transport ---------------------------------------------------------------

    def beats_per_sample(self) -> float:
        return max(self.bpm, 0.0) / (60.0 * max(self.sr, 1.0))

    def set_bpm(self, bpm: float):
        self.bpm = bpm

    def transport_start(self, channels: List[LoopChannelHost]):
        self.transport_running = True
        for col, ch in enumerate(channels[:CLIP_COLUMNS]):
            if self.active_row[col] is not None:
                ch.set_playing(True)

    def transport_stop(self, channels: List[LoopChannelHost]):
        self.transport_running = False
        for ch in channels[:CLIP_COLUMNS]:
            ch.set_playing(False)

    def transport_seek(self, beat: float, channels: List[LoopChannelHost]) -> bool:
        if not np.isfinite(beat) or beat < 0:
            return False
        self.transport_beat = beat
        for col, ch in enumerate(channels[:CLIP_COLUMNS]):
            row = self.active_row[col]
            if row is not None and self.slots[col][row] is not None:
                clip = self.slots[col][row]
                phase = ((beat - self.launch_beat[col]) / clip.length_beats) % 1.0
                ch.set_window_phase(phase)
        return True

    def transport_reset(self, channels: List[LoopChannelHost]):
        self.transport_beat = 0.0
        self.transport_seek(0.0, channels)

    # --- slots ------------------------------------------------------------------

    def load(self, column: int, row: int, buffer: StereoSampleBuffer,
             source_bpm: float) -> bool:
        clip = Clip.make(buffer, source_bpm)
        if clip is None or not self._valid(column, row):
            return False
        self.slots[column][row] = clip
        return True

    def unload(self, column: int, row: int) -> bool:
        if not self._valid(column, row):
            return False
        self.slots[column][row] = None
        return True

    def _valid(self, column, row):
        return 0 <= column < CLIP_COLUMNS and 0 <= row < CLIP_ROWS

    def slot_state(self, column: int, row: int) -> int:
        state = 0
        if self._valid(column, row) and self.slots[column][row] is not None:
            state |= STATE_LOADED
        if self.active_row[column] == row:
            state |= STATE_PLAYING
        p = self.pending[column]
        if p is not None and p.kind == "launch" and p.row == row:
            state |= STATE_QUEUED
        return state

    def set_trim(self, column: int, row: int, start: float, end: float,
                 timing: int, channels: List[LoopChannelHost]) -> bool:
        if not self._valid(column, row) or self.slots[column][row] is None:
            return False
        clip = self.slots[column][row]
        clip.trim_start = min(max(start, 0.0), 1.0)
        clip.trim_end = min(max(end, 0.0), 1.0)
        if self.active_row[column] == row:
            if timing == RETRIM_IMMEDIATE or not self.transport_running:
                channels[column].set_loop_window(clip.trim_start, clip.trim_end)
            else:
                beat = self.quantized_target(self.default_quantization)
                self.pending_retrim[column] = _PendingRetrim(
                    beat, clip.trim_start, clip.trim_end
                )
        return True

    # --- scheduling (rs:174-205) ----------------------------------------------------

    def quantized_target(self, quantization: int) -> float:
        if not self.transport_running:
            return 0.0
        if quantization == QUANTIZE_IMMEDIATE:
            return self.transport_beat
        interval = QUANT_BEATS[quantization]
        scaled = self.transport_beat / interval
        nearest = round(scaled)
        base = nearest if abs(scaled - nearest) <= 1e-9 else np.floor(scaled)
        return (base + 1.0) * interval

    def _schedule(self, column: int, kind: str, row: int, beat: float) -> bool:
        if not (0 <= column < CLIP_COLUMNS):
            return False
        if not (np.isfinite(beat) and beat >= 0 and beat + 1e-9 >= self.transport_beat):
            return False
        self.pending[column] = _Pending(kind, row, beat)
        return True

    def launch_quantized(self, column: int, row: int, quantization: Optional[int] = None) -> bool:
        if not self._valid(column, row) or self.slots[column][row] is None:
            return False
        q = self.default_quantization if quantization is None else quantization
        return self._schedule(column, "launch", row, self.quantized_target(q))

    def launch_at(self, column: int, row: int, beat: float) -> bool:
        if not self._valid(column, row) or self.slots[column][row] is None:
            return False
        return self._schedule(column, "launch", row, beat)

    def launch_scene_quantized(self, row: int, quantization: Optional[int] = None) -> bool:
        q = self.default_quantization if quantization is None else quantization
        beat = self.quantized_target(q)
        ok = False
        for col in range(CLIP_COLUMNS):
            if self.slots[col][row] is not None:
                ok |= self._schedule(col, "launch", row, beat)
        return ok

    def stop_quantized(self, column: int, quantization: Optional[int] = None) -> bool:
        q = self.default_quantization if quantization is None else quantization
        return self._schedule(column, "stop", 0, self.quantized_target(q))

    def stop_at(self, column: int, beat: float) -> bool:
        return self._schedule(column, "stop", 0, beat)

    def cancel(self, column: int):
        if 0 <= column < CLIP_COLUMNS:
            self.pending[column] = None

    def cancel_all(self):
        self.pending = [None] * CLIP_COLUMNS

    def queued_row(self, column: int) -> Optional[int]:
        p = self.pending[column]
        return p.row if p is not None and p.kind == "launch" else None

    def scheduled_beat(self, column: int) -> Optional[float]:
        p = self.pending[column]
        return p.beat if p is not None else None

    def active_playhead(self, column: int) -> Optional[float]:
        row = self.active_row[column]
        if row is None or self.slots[column][row] is None:
            return None
        clip = self.slots[column][row]
        return ((self.transport_beat - self.launch_beat[column])
                / clip.length_beats) % 1.0

    # --- per-block processing ---------------------------------------------------------

    def _activate(self, column: int, row: int, channels: List[LoopChannelHost]):
        clip = self.slots[column][row]
        if clip is None:
            self._stop_now(column, channels)
            return
        ch = channels[column]
        ch.set_loop_window(clip.trim_start, clip.trim_end)
        ch.speed = 1.0
        ch.pitch_mode = PITCH_PRESERVE
        ch.cancel_queued_swap()
        ch.set_buffer(clip.buffer)
        ch.set_playing(self.transport_running)
        self.active_row[column] = row
        self.launch_beat[column] = self.transport_beat

    def _make_launch_action(self, column: int, row: int, beat: float,
                            channels: List[LoopChannelHost]):
        """Stage the clip's buffer now (device upload pre-render) and return
        the sample-exact apply function: the old clip keeps reading its own
        region until the landing sample, then the channel flips regions —
        the same double-buffer the quantized swap path uses."""
        clip = self.slots[column][row]
        ch = channels[column]
        if clip is None:
            return lambda: self._stop_now(column, channels)
        staged = 1 - ch.active_region
        ch.region_buffers[staged] = clip.buffer
        ch.region_dirty[staged] = True

        def apply():
            ch.loop_start = min(max(clip.trim_start, 0.0), 1.0)
            ch.loop_end = min(max(clip.trim_end, 0.0), 1.0)
            ch.speed = 1.0
            ch.pitch_mode = PITCH_PRESERVE
            ch.pending = None
            ch.buffer = clip.buffer
            ch.active_region = staged
            ch.cursor = ch.window(float(len(clip.buffer))).lo
            ch.playing = self.transport_running
            ch._stretcher = None
            self.active_row[column] = row
            self.launch_beat[column] = max(beat, 0.0)

        return apply

    def _stop_now(self, column: int, channels: List[LoopChannelHost]):
        channels[column].set_playing(False)
        channels[column].clear_buffer()
        self.active_row[column] = None

    def before_tick(self, channels: List[LoopChannelHost], block_size: int = 0):
        """Collect actions due within the upcoming block as sample-exact
        ``{column: [(offset, fn), ...]}`` (clip_grid.rs fires these in its
        per-sample before_tick; here the channel sweep applies them at the
        exact offset).  With ``block_size=0`` only actions already due at
        the block edge fire (legacy behavior)."""
        actions = {}
        if not self.transport_running:
            return actions
        bps = self.beats_per_sample()
        tol = bps * 0.5 + 1e-12
        horizon = self.transport_beat + block_size * bps

        def due_offset(beat: float) -> Optional[int]:
            if self.transport_beat + tol >= beat:
                return 0
            if block_size and beat < horizon + tol:
                off = int(np.ceil((beat - self.transport_beat - tol) / max(bps, 1e-12)))
                return min(max(off, 0), block_size - 1)
            return None

        for col in range(CLIP_COLUMNS):
            p = self.pending[col]
            if p is not None:
                off = due_offset(p.beat)
                if off is not None:
                    self.pending[col] = None
                    self.pending_retrim[col] = None
                    if p.kind == "launch":
                        fn = self._make_launch_action(col, p.row, p.beat, channels)
                    elif p.kind == "stop":
                        fn = (lambda c=col: self._stop_now(c, channels))
                    else:
                        def fn(c=col, r=p.row):
                            self._stop_now(c, channels)
                            self.slots[c][r] = None
                    actions.setdefault(col, []).append((off, fn))
            r = self.pending_retrim[col]
            if r is not None:
                off = due_offset(r.beat)
                if off is not None:
                    self.pending_retrim[col] = None
                    actions.setdefault(col, []).append(
                        (off, lambda c=col, rr=r: channels[c].set_loop_window(
                            rr.start, rr.end))
                    )
        return actions

    def after_tick(self, block_size: int):
        if self.transport_running:
            self.transport_beat += block_size * self.beats_per_sample()
