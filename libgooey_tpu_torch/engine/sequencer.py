"""Sample-accurate 16-step sequencer — host-side control logic.

A torch-free copy of libgooey_tpu/engine/sequencer.py: the logic is numpy
only, but importing the JAX package's copy would import JAX.

Behavioral reference: src/engine/sequencer.rs (1,031 LoC).  Key semantics:

* step = one 16th note: ``samples_per_step = (60/bpm)/4 * sr`` (f32,
  sequencer.rs:583-588);
* per-step: enabled, velocity, optional blend (X/Y pad override), optional
  MIDI note (sequencer.rs:29-92);
* per-sample tick: fire when ``sample_count >= next_trigger_sample``; advance
  ``next_trigger_sample`` by ``samples_per_step ± swing_offset`` where
  off-beat (odd) steps are delayed by ``(swing-0.5)*2*samples_per_step`` and
  the following on-beat advanced by the same, keeping average tempo constant
  (sequencer.rs:935-947);
* ``set_beat_position(beat)`` silently teleports with fractional offset
  (sequencer.rs:658-682); armed start counts down (sample_count frozen) then
  teleports + starts on the same tick (sequencer.rs:885-901);
* the swing parameter itself is smoothed per running sample.

This runs on the *host* in exact arithmetic — it is pure control logic that
compiles each block's decisions into trigger (offset, velocity, blend, note)
events for the device.  ``tick_block(n)`` processes n samples in O(#events)
instead of O(n), but is tick-for-tick equivalent to the reference loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from libgooey_tpu_torch.core.constants import DEFAULT_SMOOTH_TIME_MS, SMOOTHER_SETTLE_EPS


@dataclass
class Step:
    enabled: bool = False
    velocity: float = 1.0
    blend: Optional[Tuple[float, float]] = None  # X/Y pad override
    note: Optional[int] = None                   # MIDI note override


@dataclass
class Trigger:
    """One sequencer hit, located at a sample offset within a block."""

    offset: int           # sample offset within the processed block
    step: int             # pattern index that fired
    velocity: float
    blend: Optional[Tuple[float, float]]
    note: Optional[int]


class _HostSmoother:
    """Scalar mirror of SmoothedParam for control-rate values (swing)."""

    def __init__(self, value: float, lo: float, hi: float, sample_rate: float,
                 smooth_ms: float = DEFAULT_SMOOTH_TIME_MS):
        self.lo, self.hi = lo, hi
        self.current = min(max(value, lo), hi)
        self.target = self.current
        n = (smooth_ms / 1000.0) * sample_rate
        self.coeff = 1.0 if smooth_ms <= 0 else 1.0 - float(np.exp(-1.0 / n))

    def set_target(self, v: float):
        self.target = min(max(v, self.lo), self.hi)

    def advance(self, ticks: int) -> float:
        """Apply `ticks` one-pole updates; returns the value after them."""
        if ticks <= 0:
            return self.current
        delta = self.current - self.target
        decayed = delta * (1.0 - self.coeff) ** ticks
        if abs(decayed) < SMOOTHER_SETTLE_EPS:
            decayed = 0.0
        self.current = self.target + decayed
        return self.current


class Sequencer:
    """16-step (configurable) sequencer with swing and armed start."""

    def __init__(self, bpm: float, sample_rate: float, num_steps: int = 16,
                 name: str = ""):
        self.bpm = float(bpm)
        self.sample_rate = float(sample_rate)
        self.name = name
        self.pattern: List[Step] = [Step() for _ in range(num_steps)]
        self.sample_count = 0
        self.next_trigger_sample = 0
        self.step_start_sample = 0
        self.current_step = 0
        #: SEQ toggle: advance phase but emit no triggers (ffi.rs
        #: set_sequencer_triggers_enabled — toggling back keeps step phase)
        self.triggers_enabled = True
        self.playhead_step = 0
        self.is_running = False
        self.swing = _HostSmoother(0.5, 0.0, 1.0, sample_rate)
        self._armed: Optional[Tuple[int, float]] = None  # (countdown, beat)
        self.samples_per_step = self._sps(self.bpm)

    # --- configuration -------------------------------------------------------

    def _sps(self, bpm: float) -> float:
        return float(np.float32((60.0 / bpm) / 4.0 * self.sample_rate))

    def set_bpm(self, bpm: float):
        self.bpm = float(bpm)
        self.samples_per_step = self._sps(self.bpm)

    def set_swing(self, swing: float):
        self.swing.set_target(swing)

    def set_step(self, i: int, enabled: bool):
        if 0 <= i < len(self.pattern):
            self.pattern[i].enabled = enabled

    def set_step_velocity(self, i: int, velocity: float):
        if 0 <= i < len(self.pattern):
            self.pattern[i].velocity = min(max(velocity, 0.0), 1.0)

    def set_step_with_settings(self, i: int, enabled: bool, velocity: float,
                               blend=None, note=None):
        if 0 <= i < len(self.pattern):
            s = self.pattern[i]
            s.enabled = enabled
            s.velocity = min(max(velocity, 0.0), 1.0)
            s.blend = blend
            s.note = note

    def set_step_note(self, i: int, note: Optional[int]):
        """Note 255 / None clears (sequencer.rs:781-795)."""
        if 0 <= i < len(self.pattern):
            self.pattern[i].note = None if note in (None, 255) else int(note)

    def set_step_blend(self, i: int, x: float, y: float):
        if 0 <= i < len(self.pattern):
            self.pattern[i].blend = (x, y)

    def clear_step_blend(self, i: int):
        if 0 <= i < len(self.pattern):
            self.pattern[i].blend = None

    def set_pattern(self, enabled: List[bool]):
        for i, e in enumerate(enabled[: len(self.pattern)]):
            self.pattern[i].enabled = bool(e)

    def set_pattern_string(self, s: str):
        """DSL-style pattern: 'x.x.' with digits 1-9 as velocity (dsl.rs)."""
        s = s.replace("|", "")
        for i, ch in enumerate(s[: len(self.pattern)]):
            if ch in ".-_ ":
                self.pattern[i].enabled = False
            elif ch.isdigit():
                self.pattern[i].enabled = ch != "0"
                self.pattern[i].velocity = int(ch) / 9.0
            else:
                self.pattern[i].enabled = True
                self.pattern[i].velocity = 1.0

    # --- transport -------------------------------------------------------------

    def start(self):
        self._armed = None
        self.is_running = True
        self.next_trigger_sample = self.sample_count

    def stop(self):
        self._armed = None
        self.is_running = False

    def reset(self):
        self._armed = None
        self.sample_count = 0
        self.next_trigger_sample = 0
        self.step_start_sample = 0
        self.current_step = 0
        self.playhead_step = 0

    def set_beat_position(self, beat: float):
        """Silent teleport; the landing step fires at its *next* boundary
        (sequencer.rs:658-682)."""
        self._armed = None
        n = len(self.pattern)
        if n == 0:
            return
        step_f = beat * 4.0
        self.current_step = int(np.floor(step_f)) % n
        self.playhead_step = self.current_step
        frac = step_f - np.floor(step_f)
        self.sample_count = int(frac * self.samples_per_step)
        self.step_start_sample = 0
        self.next_trigger_sample = int(
            round(self.samples_per_step - frac * self.samples_per_step)
        )

    def arm_at_samples(self, samples_until_start: int, beat: float):
        self.is_running = False
        self._armed = (int(samples_until_start), float(beat))

    def cancel_arm(self):
        self._armed = None

    @property
    def is_armed(self) -> bool:
        return self._armed is not None

    # --- queries ---------------------------------------------------------------

    def step_at_lookahead(self, lookahead: int) -> int:
        """UI latency compensation (sequencer.rs:1013-1030)."""
        if not self.is_running or not self.pattern:
            return self.playhead_step
        future = self.sample_count + lookahead
        if future >= self.next_trigger_sample:
            past = future - self.next_trigger_sample
            extra = int(past / self.samples_per_step)
            return (self.current_step + extra) % len(self.pattern)
        return self.playhead_step

    def beat_position(self) -> float:
        """Current transport position in quarter-note beats."""
        n = len(self.pattern)
        if n == 0:
            return 0.0
        span = max(self.next_trigger_sample - self.step_start_sample, 1)
        frac = min((self.sample_count - self.step_start_sample) / span, 1.0)
        return (self.playhead_step + frac) / 4.0

    # --- block processing --------------------------------------------------------

    def tick_block(self, block: int) -> List[Trigger]:
        """Advance `block` samples, returning triggers with in-block offsets.

        Equivalent to `block` calls of the reference's per-sample
        tick_with_settings (sequencer.rs:883-954), processed event-by-event.
        """
        triggers: List[Trigger] = []
        k = 0
        while k < block:
            if self._armed is not None:
                countdown, beat = self._armed
                if countdown > 0:
                    # silent countdown: sample_count frozen, nothing ticks
                    adv = min(countdown, block - k)
                    k += adv
                    countdown -= adv
                    self._armed = (countdown, beat)
                    continue
                # fire: teleport + start, then this same sample ticks normally
                self.set_beat_position(beat)
                self.start()

            if not self.is_running or not self.pattern:
                self.sample_count += block - k
                break

            delta = self.next_trigger_sample - self.sample_count
            remaining = block - k
            if delta >= remaining:
                # no boundary crossed in the rest of the block
                self.swing.advance(remaining)
                self.sample_count += remaining
                break

            # advance to the trigger sample, ticking swing for the
            # intermediate samples plus the trigger sample itself.  (delta
            # can be < 0 when extreme swing makes a step overdue — the
            # trigger then fires immediately, like the reference's >= check.)
            adv = max(delta, 0)
            self.swing.advance(adv + 1)
            self.sample_count += adv
            k += adv

            # --- the trigger sample (sequencer.rs:912-947) ---
            self.step_start_sample = self.sample_count
            self.playhead_step = self.current_step
            step = self.pattern[self.current_step]
            if step.enabled and self.triggers_enabled:
                triggers.append(
                    Trigger(
                        offset=k,
                        step=self.current_step,
                        velocity=step.velocity,
                        blend=step.blend,
                        note=step.note,
                    )
                )
            self.current_step = (self.current_step + 1) % len(self.pattern)
            swing_offset = (
                (np.float32(self.swing.current) - np.float32(0.5))
                * 2.0
                * np.float32(self.samples_per_step)
            )
            signed = swing_offset if self.current_step % 2 == 1 else -swing_offset
            self.next_trigger_sample = int(
                round(
                    float(
                        np.float32(self.next_trigger_sample)
                        + np.float32(self.samples_per_step)
                        + np.float32(signed)
                    )
                )
            )
            self.sample_count += 1
            k += 1
        return triggers
