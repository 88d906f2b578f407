"""Performance recorder: looping chord-clip capture and replay (the port's
own copy of libgooey_tpu/performance.py).

Behavioral reference: src/performance/mod.rs (804 LoC) — a 96-PPQ looping
clip on the shared transport: records pad-press events (ChordClipEvent:
start_tick, duration, root/scale/degree/voicing/preset/octave/velocity) and
manual sampler hits; overdub vs punch-out arm modes; playback emits
Trigger/Release actions from ``update_clock(beat, running)``; overlapping
gates are cut at a new press (cut_gates_at).  Pure host-side control logic.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

TICKS_PER_QUARTER = 96
DEFAULT_LENGTH_STEPS = 16
TICKS_PER_STEP = TICKS_PER_QUARTER // 4
DEFAULT_LENGTH_TICKS = DEFAULT_LENGTH_STEPS * TICKS_PER_STEP

MODE_OVERDUB, MODE_PUNCH_OUT = 0, 1


@dataclass
class ChordClipEvent:
    start_tick: int
    duration_ticks: int
    root: int
    scale_type: int
    degree: int
    voicing: int
    preset: int
    octave: int
    velocity: float

    def end_tick(self, length_ticks: int) -> int:
        return (self.start_tick + self.duration_ticks) % max(length_ticks, 1)

    def covers(self, tick: int, length_ticks: int) -> bool:
        if length_ticks == 0:
            return False
        d = (tick - self.start_tick) % length_ticks
        return d < self.duration_ticks


@dataclass
class SamplerClipEvent:
    start_tick: int
    rack: int
    slot: int
    velocity: float


def beat_to_tick(beat: float, length_ticks: int) -> int:
    if length_ticks == 0:
        return 0
    return int(beat * TICKS_PER_QUARTER) % length_ticks


def tick_distance(start: int, end: int, length_ticks: int) -> int:
    return (end - start) % max(length_ticks, 1)


def cut_gates_at(events: List[ChordClipEvent], tick: int, length_ticks: int):
    """Truncate any gate sounding at `tick` so it ends there (rs:586+)."""
    if length_ticks == 0:
        return
    for ev in events:
        if ev.covers(tick, length_ticks):
            d = tick_distance(ev.start_tick, tick, length_ticks)
            ev.duration_ticks = max(d, 1)


class PerformanceRecorder:
    def __init__(self):
        self.length_ticks = DEFAULT_LENGTH_TICKS
        self.mode = MODE_PUNCH_OUT  # reference default (performance/mod.rs:161)
        self.events: List[ChordClipEvent] = []
        self.sampler_events: List[SamplerClipEvent] = []
        self.armed = False
        self.recording_active = False
        self.wait_for_loop_start = False
        self.punch_ticks_remaining: Optional[int] = None
        self.playback_limit = 0
        self.sampler_playback_limit = 0
        self.playing_index: Optional[int] = None
        self.open: Optional[dict] = None
        self.last_tick = 0
        self.last_beat = 0.0
        self.transport_running = False
        self.applying_playback = False
        self.last_sampler_tick: Optional[int] = None
        self.pending_sampler_hits: List[SamplerClipEvent] = []

    # --- arm / clip management -------------------------------------------------

    def set_length_steps(self, steps: int):
        self.length_ticks = max(int(steps), 1) * TICKS_PER_STEP

    def set_armed(self, armed: bool):
        """Arm/disarm; recording begins at the loop start (rs:191-218)."""
        self.armed = bool(armed)
        if not armed:
            if self.open is not None:
                self._finalize_open_at(self.last_tick)
            self.recording_active = False
            self.wait_for_loop_start = False
            self.punch_ticks_remaining = None
            self.playback_limit = len(self.events)
            self.sampler_playback_limit = len(self.sampler_events)
        elif self.transport_running:
            if self.last_tick == 0:
                self._begin_active_recording()
            else:
                self.wait_for_loop_start = True

    def is_recording(self) -> bool:
        return self.armed and self.recording_active

    def clear_clip(self):
        self.events.clear()
        self.sampler_events.clear()
        self.playback_limit = 0
        self.sampler_playback_limit = 0
        self.playing_index = None
        self.open = None

    # --- clock (rs:272-357) ------------------------------------------------------

    def update_clock(self, beat: float, running: bool):
        """Advance the clip clock; returns ('trigger', event) / ('release',) /
        None."""
        was_running = self.transport_running
        self.transport_running = running
        self.last_beat = beat

        if not running:
            if was_running:
                self._finalize_open_at(self.last_tick)
                self.recording_active = False
            self.playing_index = None
            self.last_sampler_tick = None
            self.pending_sampler_hits.clear()
            return None

        tick = beat_to_tick(beat, self.length_ticks)
        prev = self.last_tick

        if not was_running:
            self.last_tick = tick
            if self.armed:
                if tick == 0:
                    self._begin_active_recording()
                else:
                    self.wait_for_loop_start = True
                    self.recording_active = False
            self._populate_sampler_hits(tick)
            return self._playback_action_at(tick, True)

        wrapped = tick < prev

        if self.armed:
            if self.wait_for_loop_start and (wrapped or tick == 0):
                self._begin_active_recording()
            elif self.recording_active:
                if wrapped:
                    self.playback_limit = len(self.events)
                    self.sampler_playback_limit = len(self.sampler_events)
                if self.punch_ticks_remaining is not None:
                    advanced = (
                        (self.length_ticks - prev) + tick if wrapped else max(tick - prev, 0)
                    )
                    if advanced >= self.punch_ticks_remaining:
                        self._finalize_open_at(tick)
                        self.armed = False
                        self.recording_active = False
                        self.punch_ticks_remaining = None
                        self.wait_for_loop_start = False
                        self.playback_limit = len(self.events)
                        self.sampler_playback_limit = len(self.sampler_events)
                    else:
                        self.punch_ticks_remaining -= advanced
        elif wrapped:
            self.playback_limit = len(self.events)
            self.sampler_playback_limit = len(self.sampler_events)

        self.last_tick = tick
        self._populate_sampler_hits(tick)
        return self._playback_action_at(tick, wrapped)

    # --- recording ------------------------------------------------------------------

    def record_chord_on(self, root, scale_type, degree, voicing, preset, octave,
                        velocity) -> bool:
        if self.applying_playback or not self.is_recording():
            return False
        tick = beat_to_tick(self.last_beat, self.length_ticks)
        self._finalize_open_at(tick)
        cut_gates_at(self.events, tick, self.length_ticks)
        self.open = dict(
            start_tick=tick, root=root, scale_type=scale_type, degree=degree,
            voicing=voicing, preset=preset, octave=octave,
            velocity=min(max(velocity, 0.0), 1.0),
        )
        return True

    def record_chord_off(self) -> bool:
        tick = beat_to_tick(self.last_beat, self.length_ticks)
        if self.applying_playback or not self.is_recording():
            if self.open is not None:
                return self._finalize_open_at(tick)
            return False
        return self._finalize_open_at(tick)

    def record_sampler_hit(self, rack: int, slot: int, velocity: float) -> bool:
        if self.applying_playback or not self.is_recording():
            return False
        self.sampler_events.append(
            SamplerClipEvent(
                beat_to_tick(self.last_beat, self.length_ticks), rack, slot,
                min(max(velocity, 0.0), 1.0),
            )
        )
        return True

    def take_sampler_hits(self) -> List[SamplerClipEvent]:
        hits = self.pending_sampler_hits
        self.pending_sampler_hits = []
        return hits

    # --- internals ---------------------------------------------------------------------

    def _begin_active_recording(self):
        self.wait_for_loop_start = False
        self.recording_active = True
        self.playback_limit = len(self.events)
        self.sampler_playback_limit = len(self.sampler_events)
        self.punch_ticks_remaining = (
            self.length_ticks if self.mode == MODE_PUNCH_OUT else None
        )

    def _finalize_open_at(self, end_tick: int) -> bool:
        if self.open is None:
            return False
        open_ev = self.open
        self.open = None
        duration = tick_distance(open_ev["start_tick"], end_tick, self.length_ticks)
        duration = min(max(duration, 1), self.length_ticks)
        self.events.append(
            ChordClipEvent(
                start_tick=open_ev["start_tick"] % self.length_ticks,
                duration_ticks=duration, root=open_ev["root"],
                scale_type=open_ev["scale_type"], degree=open_ev["degree"],
                voicing=open_ev["voicing"], preset=open_ev["preset"],
                octave=open_ev["octave"], velocity=open_ev["velocity"],
            )
        )
        return True

    def _rank(self, start: int, tick: int) -> int:
        """Later-started (closer behind tick, wrap-aware) ranks higher."""
        return -((tick - start) % max(self.length_ticks, 1))

    def _playback_action_at(self, tick: int, force_rescan: bool):
        playable = (
            min(self.playback_limit, len(self.events))
            if self.recording_active else len(self.events)
        )
        if playable == 0:
            if self.playing_index is not None:
                self.playing_index = None
                return ("release",)
            return None

        best = None
        for i, ev in enumerate(self.events[:playable]):
            if ev.covers(tick, self.length_ticks):
                if best is None or self._rank(ev.start_tick, tick) >= self._rank(
                    self.events[best].start_tick, tick
                ):
                    best = i

        if best == self.playing_index and not force_rescan:
            return None
        if best == self.playing_index:
            if best is not None and self.events[best].start_tick == tick:
                return ("trigger", self.events[best])
            return None
        prev = self.playing_index
        self.playing_index = best
        if best is not None:
            return ("trigger", self.events[best])
        if prev is not None:
            return ("release",)
        return None

    def _populate_sampler_hits(self, tick: int):
        self.pending_sampler_hits = []
        if self.last_sampler_tick == tick:
            return
        self.last_sampler_tick = tick
        playable = (
            min(self.sampler_playback_limit, len(self.sampler_events))
            if self.recording_active else len(self.sampler_events)
        )
        self.pending_sampler_hits = [
            ev for ev in self.sampler_events[:playable] if ev.start_tick == tick
        ]
