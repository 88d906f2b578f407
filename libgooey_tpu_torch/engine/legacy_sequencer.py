"""Legacy standalone 8th-note sequencer (src/sequencer/sequencer.rs:3-107;
the port's own copy of libgooey_tpu/engine/legacy_sequencer.py).

Kept for API parity with the reference's old examples.  Host control code;
block-friendly: ``tick_block`` returns all (offset, step) firings for a
block in O(#events) instead of per-sample callbacks.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple


class LegacySequencer:
    def __init__(self, bpm: float, sample_rate: float):
        self.bpm = float(bpm)
        self.sample_rate = float(sample_rate)
        self.sample_count = 0
        self.next_trigger_sample = 0
        self.samples_per_8th = self._samples_per_8th(bpm, sample_rate)
        self.current_step = 0
        self.is_running = False

    @staticmethod
    def _samples_per_8th(bpm: float, sample_rate: float) -> float:
        return (60.0 / bpm) / 2.0 * sample_rate

    def start(self):
        self.is_running = True
        self.next_trigger_sample = self.sample_count

    def stop(self):
        self.is_running = False

    def reset(self):
        self.sample_count = 0
        self.next_trigger_sample = 0
        self.current_step = 0

    def set_bpm(self, bpm: float):
        self.bpm = float(bpm)
        self.samples_per_8th = self._samples_per_8th(bpm, self.sample_rate)

    def get_current_step(self) -> int:
        return self.current_step

    def tick(self, callback: Optional[Callable[[int], None]] = None) -> bool:
        """Per-sample parity shim (sequencer.rs:79-106)."""
        if not self.is_running:
            self.sample_count += 1
            return False
        triggered = False
        if self.sample_count >= self.next_trigger_sample:
            if callback is not None:
                callback(self.current_step)
            triggered = True
            self.current_step += 1
            self.next_trigger_sample = int(
                round(self.next_trigger_sample + self.samples_per_8th)
            )
        self.sample_count += 1
        return triggered

    def tick_block(self, block_size: int) -> List[Tuple[int, int]]:
        """All (sample_offset, step) firings within the next block."""
        events: List[Tuple[int, int]] = []
        if not self.is_running:
            self.sample_count += block_size
            return events
        end = self.sample_count + block_size
        while self.next_trigger_sample < end:
            offset = max(self.next_trigger_sample, self.sample_count) - self.sample_count
            events.append((int(offset), self.current_step))
            self.current_step += 1
            self.next_trigger_sample = int(
                round(self.next_trigger_sample + self.samples_per_8th)
            )
        self.sample_count = end
        return events
