"""LoopChannel: stereo loop player with wrap windows, warp and quantized swaps
(port of libgooey_tpu/mixer/loop_channel.py; the host logic is numpy,
copied as it is).

Behavioral reference: src/mixer/loop_channel.rs (929 LoC).

* cursor advance ``speed * (source_sr/engine_sr) * warp`` (rs:269-313), warp
  ratio ``engine_bpm / source_bpm`` for Resample/PreservePitch (rs:347-364);
* `LoopWindow` with wrap-around regions (``end < start`` plays
  ``[lo,len) ∪ [0,hi)``) via virtual coordinates (rs:58-114);
* gain + mute/solo gate smoothers (15 ms) applied to the post-effect wet so
  muting fades tails (rs:181-208);
* bar-quantized buffer swap: staged buffer lands at the grid boundary
  (rs:319-345); live loop-window resize with cursor folding (rs:487-500).

The cursor/window/swap state machine runs on the host in exact float64
(one linear sweep per block, vectorized in numpy, with an analytic split at
a landing swap); the device receives per-sample read positions and does
the cubic gathers, gain smoothing and the channel's effect chain.
PreservePitch runs through the WSOLA stretcher (mixer.wsola).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from libgooey_tpu_torch.core.smoother import SmootherBank
from libgooey_tpu_torch.mixer import chain as chain_mod
from libgooey_tpu_torch.mixer.stereo_buffer import StereoSampleBuffer

PITCH_OFF, PITCH_RESAMPLE, PITCH_PRESERVE = 0, 1, 2
DEFAULT_ENGINE_BPM = 120.0


class LoopWindow(NamedTuple):
    lo: float
    hi: float
    span: float
    wraps: bool
    len: float

    def to_virtual(self, p: float) -> float:
        return (p - self.lo) % self.len

    def to_physical(self, v: float) -> float:
        return (self.lo + v) % self.len

    def contains(self, p: float) -> bool:
        return (p >= self.lo or p < self.hi) if self.wraps else (self.lo <= p < self.hi)

    def fold(self, p: float) -> float:
        if self.contains(p):
            return p
        if self.wraps:
            return self.hi if (p - self.hi) <= (self.lo - p) else self.lo
        return min(max(p, self.lo), self.hi)


class ChannelDevState(NamedTuple):
    """Device-side loop channel state."""

    buffer: torch.Tensor      # [2, 2 * capacity]
    gains: SmootherBank       # [2]: gain, active (mute/solo) gate
    chain_states: tuple


class LoopChannelHost:
    """Host control plane for one loop channel.  Its effect chain's states
    and its WSOLA stretcher's device search live on ``device``."""

    def __init__(self, sample_rate: float, buffer_capacity: int = 1 << 21, *, device):
        self.sr = sample_rate
        self.capacity = buffer_capacity
        self.device = device
        self.buffer: Optional[StereoSampleBuffer] = None
        #: double-buffered device regions so a quantized swap can land
        #: mid-block: the active region plays, the staged one waits
        self.active_region = 0
        self.region_buffers: List[Optional[StereoSampleBuffer]] = [None, None]
        self.region_dirty = [False, False]
        self.cursor = 0.0
        self.playing = False
        self.loop_start = 0.0
        self.loop_end = 1.0
        self.speed = 1.0
        self.pitch_mode = PITCH_OFF
        self.engine_bpm = DEFAULT_ENGINE_BPM
        self.gain_target = 1.0
        self.muted = False
        self.soloed = False
        self.audible = True  # solo-aware gate set by the mixer
        self.pending: Optional[StereoSampleBuffer] = None
        self.pending_divisions = 1
        self.swaps_completed = 0
        self.chain = chain_mod.EffectChain(sample_rate, DEFAULT_ENGINE_BPM, device=device)
        self._stretcher = None  # created lazily for PreservePitch

    # --- control (loop_channel.rs setters) -----------------------------------

    def window(self, length: float) -> LoopWindow:
        lo = min(max(self.loop_start * length, 0.0), length)
        hi = min(max(self.loop_end * length, 0.0), length)
        wraps = hi < lo
        span = (length - lo + hi) if wraps else (hi - lo)
        return LoopWindow(lo, hi, span, wraps, length)

    def set_buffer(self, buffer: StereoSampleBuffer):
        if len(buffer) > self.capacity:
            raise ValueError("loop buffer exceeds channel capacity")
        self.buffer = buffer
        self.cursor = self.window(float(len(buffer))).lo
        self.region_buffers[self.active_region] = buffer
        self.region_dirty[self.active_region] = True
        self._stretcher = None

    def clear_buffer(self):
        self.buffer = None
        self.cursor = 0.0
        self.playing = False
        self._stretcher = None

    def set_playing(self, playing: bool):
        self.playing = playing

    def set_loop_window(self, start: float, end: float):
        """Live window resize with cursor folding (rs:487-500)."""
        self.loop_start = min(max(start, 0.0), 1.0)
        self.loop_end = min(max(end, 0.0), 1.0)
        if self.buffer is not None:
            w = self.window(float(len(self.buffer)))
            self.cursor = w.fold(self.cursor)

    def set_position(self, normalized: float):
        if self.buffer is not None:
            self.cursor = min(max(normalized, 0.0), 1.0) * float(len(self.buffer) - 1)
            self._stretcher = None

    def set_window_phase(self, phase: float):
        """Teleport to a phase within the loop window (clip-grid launch)."""
        if self.buffer is None:
            return
        w = self.window(float(len(self.buffer)))
        self.cursor = w.to_physical(min(max(phase, 0.0), 1.0) * w.span)
        self._stretcher = None

    def restart(self):
        if self.buffer is not None:
            self.cursor = self.window(float(len(self.buffer))).lo
            self._stretcher = None

    def queue_swap(self, buffer: StereoSampleBuffer, divisions: int = 1):
        if len(buffer) > self.capacity:
            raise ValueError("loop buffer exceeds channel capacity")
        self.pending = buffer
        self.pending_divisions = max(int(divisions), 1)
        staged = 1 - self.active_region
        self.region_buffers[staged] = buffer
        self.region_dirty[staged] = True

    def cancel_queued_swap(self):
        self.pending = None

    def warp_ratio(self) -> float:
        if self.pitch_mode == PITCH_OFF or self.buffer is None:
            return 1.0
        bpm = self.buffer.source_bpm
        if bpm and bpm > 0 and self.engine_bpm > 0:
            return self.engine_bpm / bpm
        return 1.0

    # --- per-block position sweep (exact f64) ----------------------------------

    def sweep_positions(self, block_size: int, actions=()):
        """Compute the block's read plan, advancing the cursor.

        Returns ``(positions[2, B] f64, weights[2, B] f32, region[B] i32,
        length[B] f32, wraps)`` — two gather streams (WSOLA overlap-add
        needs two; direct playback uses stream 0 with weight 1) plus the
        device region / valid length of each sample's source.  Handles a
        pending quantized swap mid-block by restarting the sweep from the
        landing sample on the staged region.  The positions are float64:
        the caller rounds them to float32 before the upload.

        ``actions``: sample-exact control changes ``[(offset, fn), ...]`` —
        the sweep runs up to each offset with the current state, applies
        ``fn()`` (which may change buffer/window/playing), and continues.
        This is how clip-grid launches/stops land on their exact sample
        (clip_grid.rs before_tick fires per sample; here per segment).
        """
        B = block_size
        positions = np.zeros((2, B), np.float64)
        weights = np.zeros((2, B), np.float32)
        region = np.full(B, self.active_region, np.int32)
        length_arr = np.ones(B, np.float32)
        wraps = False
        n0 = 0
        for off, fn in sorted(actions, key=lambda a: a[0]) + [(B, None)]:
            off = min(max(int(off), n0), B)
            if off > n0:
                w = self._sweep_segment(positions, weights, region, length_arr,
                                        n0, off)
                wraps = wraps or w
                n0 = off
            if fn is not None:
                fn()
        return positions, weights, region, length_arr, wraps

    def _sweep_segment(self, positions, weights, region, length_arr, s0, s1):
        """Fill the plan arrays for samples [s0, s1); returns the segment's
        window wrap flag.  Silent (weights 0) when stopped or empty."""
        region[s0:s1] = self.active_region
        if not self.playing or self.buffer is None:
            return False
        if self.pitch_mode == PITCH_PRESERVE and self.speed >= 0.0:
            return self._sweep_preserve(positions, weights, region, length_arr,
                                        s0, s1)

        length_arr[s0:s1] = float(len(self.buffer))
        n0 = s0
        while n0 < s1:
            length = float(len(self.buffer))
            w = self.window(length)
            span = max(w.span, 1.0)
            ratio = self.buffer.sample_rate / max(self.sr, 1.0)
            warp = self.warp_ratio() if self.pitch_mode == PITCH_RESAMPLE else 1.0
            delta = self.speed * ratio * warp
            n = np.arange(s1 - n0)
            v0 = w.to_virtual(self.cursor) if w.wraps else (self.cursor - w.lo)
            v = np.mod(v0 + n * delta, span)
            phys = np.mod(w.lo + v, w.len) if w.wraps else (w.lo + v)
            # swap landing: first grid-boundary crossing (rs:319-345)
            if self.pending is not None:
                grid = float(self.pending_divisions)
                idx = np.floor(v / span * grid)
                nxt = np.floor(np.mod(v0 + (n + 1) * delta, span) / span * grid)
                wrapped_step = np.floor((v0 + (n + 1) * delta) / span) != np.floor(
                    (v0 + n * delta) / span
                )
                crossing = np.nonzero((idx != nxt) | wrapped_step)[0]
                if len(crossing):
                    # the boundary is crossed by the advance of sample
                    # `crossing[0]`; the swap applies to the next read —
                    # possibly the first sample of the next block/segment
                    land = int(crossing[0]) + 1
                    positions[0, n0 : n0 + land] = phys[:land]
                    weights[0, n0 : n0 + land] = 1.0
                    new_buf = self.pending
                    self.pending = None
                    self.buffer = new_buf
                    self.active_region = 1 - self.active_region
                    self.swaps_completed += 1
                    self.cursor = self.window(float(len(new_buf))).lo
                    self._stretcher = None
                    n0 += land
                    region[n0:s1] = self.active_region
                    length_arr[n0:s1] = float(len(new_buf))
                    if n0 >= s1:
                        return self.window(float(len(new_buf))).wraps
                    continue
            positions[0, n0:s1] = phys
            weights[0, n0:s1] = 1.0
            # advance cursor past the segment remainder
            v_end = np.mod(v0 + (s1 - n0) * delta, span)
            self.cursor = w.to_physical(v_end) if w.wraps else (w.lo + v_end)
            break
        return self.window(float(len(self.buffer))).wraps

    def _sweep_preserve(self, positions, weights, region, length_arr, s0, s1):
        """PreservePitch: WSOLA overlap-add read plan (mixer.wsola)."""
        from libgooey_tpu_torch.mixer import wsola

        if self._stretcher is None:
            self._stretcher = wsola.WsolaHost(self.sr, self.cursor, device=self.device)
        length = float(len(self.buffer))
        w = self.window(length)
        ratio = self.buffer.sample_rate / max(self.sr, 1.0)
        prev = self.cursor
        pos, wts, new_cursor = self._stretcher.plan_block(
            s1 - s0, self.buffer, w, ratio, self.speed, self.warp_ratio()
        )
        positions[:, s0:s1] = pos
        weights[:, s0:s1] = wts
        length_arr[s0:s1] = length
        self.cursor = new_cursor
        # queued swaps land at hop granularity in this mode (wsola.rs:244-255):
        # if the analysis cursor crossed a grid boundary this block, swap now
        if self.pending is not None:
            span = max(w.span, 1.0)
            grid = float(self.pending_divisions)
            pv, cv = w.to_virtual(prev), w.to_virtual(self.cursor)
            wrapped = cv < pv
            if wrapped or np.floor(pv / span * grid) != np.floor(cv / span * grid):
                new_buf = self.pending
                self.pending = None
                self.buffer = new_buf
                self.active_region = 1 - self.active_region
                self.swaps_completed += 1
                self.cursor = self.window(float(len(new_buf))).lo
                self._stretcher = None
        return w.wraps
