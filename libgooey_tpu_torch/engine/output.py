"""Realtime output adapter: device callback → engine blocks (the port's own
copy of libgooey_tpu/engine/output.py).

Behavioral reference: src/engine/engine_output.rs — the cpal stream
wrapper with a sample counter, an overrun counter (callback slower than
buffer duration), stop_if_overruns, and the stereo→N-channel frame
mapping (engine_output.rs:446-466: 1ch = downmix, 2ch = L/R, extra
surround channels get the downmix).

TPU-native redesign: the reference ticks the engine one sample at a time
inside the OS audio callback.  On TPU the engine renders whole blocks on
the device, so this adapter instead runs a *prefetch pipeline*: a worker
thread keeps up to ``prefetch_blocks`` rendered blocks queued while the
device callback (``fill``) just copies out of the queue — device compile
or transfer hiccups don't glitch the callback until the queue drains.
An empty queue at fill time is an underrun and counts as an overrun
(the same observable the reference exposes); the callback then emits
silence, it never blocks.

There is no OS audio device in scope here (cpal's role); ``fill`` is the
hook a host (CoreAudio/ALSA/JACK shim) calls with its interleaved buffer.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

import numpy as np


class EngineOutput:
    def __init__(self, prefetch_blocks: int = 4):
        self.sample_rate = 44100.0
        self.is_active = False
        self.engine = None
        self.sample_counter = 0
        self._overruns = 0
        self._queue: deque = deque()
        self._leftover: Optional[np.ndarray] = None  # partial block [2, n]
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._prefetch = int(prefetch_blocks)
        self._block = 512

    # --- lifecycle (engine_output.rs:132-152, 469-495) ------------------------

    def initialize(self, sample_rate: float):
        self.sample_rate = float(sample_rate)

    def create_stream_with_engine(self, engine):
        """Attach any engine exposing ``render(frames) -> interleaved f32``."""
        self.engine = engine
        self._block = getattr(engine, "block", 512)

    def start(self):
        if self.engine is None:
            raise RuntimeError("Stream not created. Call create_stream_with_engine first.")
        self.sample_counter = 0
        self.is_active = True
        if self._prefetch > 0 and self._thread is None:
            self._thread = threading.Thread(target=self._prefetch_loop, daemon=True)
            self._thread.start()

    def stop(self):
        self.is_active = False
        with self._wake:
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # --- prefetch pipeline -----------------------------------------------------

    def _prefetch_loop(self):
        while self.is_active:
            with self._wake:
                while self.is_active and len(self._queue) >= self._prefetch:
                    self._wake.wait(timeout=0.1)
                if not self.is_active:
                    return
            block = self._render_block()
            with self._lock:
                self._queue.append(block)

    def _render_block(self) -> np.ndarray:
        inter = np.asarray(self.engine.render(self._block), np.float32)
        return inter.reshape(-1, 2).T  # [2, B]

    def _next_samples(self, frames: int) -> np.ndarray:
        """Pull [2, frames] from the queue/leftover; silence on underrun."""
        out = np.zeros((2, frames), np.float32)
        filled = 0
        while filled < frames:
            if self._leftover is None or self._leftover.shape[1] == 0:
                with self._lock:
                    if self._queue:
                        self._leftover = self._queue.popleft()
                    else:
                        self._leftover = None
                with self._wake:
                    self._wake.notify_all()
                if self._leftover is None:
                    if self._thread is not None:
                        # pipeline ran dry: underrun ⇒ overrun observable
                        self._overruns += 1
                        break
                    # synchronous mode: render inline
                    self._leftover = self._render_block()
            n = min(frames - filled, self._leftover.shape[1])
            out[:, filled:filled + n] = self._leftover[:, :n]
            self._leftover = self._leftover[:, n:]
            filled += n
        return out

    # --- the device callback ----------------------------------------------------

    def fill(self, output: np.ndarray, num_channels: int = 2) -> int:
        """Fill an interleaved device buffer of ``frames*num_channels`` floats.

        Returns the number of frames written.  Mirrors the cpal callback:
        measures elapsed vs buffer duration and bumps the overrun counter
        when rendering couldn't keep up (engine_output.rs:305-310)."""
        frames = len(output) // num_channels
        if not self.is_active or frames == 0:
            output[:] = 0.0
            return 0
        start = time.monotonic()
        stereo = self._next_samples(frames)
        l, r = stereo[0], stereo[1]
        downmix = 0.5 * (l + r)
        frame_view = output[: frames * num_channels].reshape(frames, num_channels)
        if num_channels == 1:
            frame_view[:, 0] = downmix
        else:
            frame_view[:, 0] = l
            frame_view[:, 1] = r
            if num_channels > 2:
                frame_view[:, 2:] = downmix[:, None]
        self.sample_counter += frames
        elapsed = time.monotonic() - start
        if elapsed > frames / self.sample_rate:
            self._overruns += 1
        return frames

    # --- overrun accounting (engine_output.rs:507-528) ---------------------------

    def overrun_count(self) -> int:
        return self._overruns

    def take_overrun_count(self) -> int:
        n = self._overruns
        self._overruns = 0
        return n

    def stop_if_overruns(self, max_overruns: int) -> bool:
        overruns = self.take_overrun_count()
        if overruns >= max_overruns and self.is_active:
            self.stop()
            return True
        return False


def sounddevice_available() -> bool:
    """Whether the optional ``sounddevice`` (PortAudio) backend can load."""
    try:
        import sounddevice  # noqa: F401
        return True
    except Exception:
        return False


class RealtimeStream:
    """Bind :class:`EngineOutput` to an actual output stream.

    The reference negotiates a CPAL device and sample format
    (engine_output.rs:162-249).  Here the device layer is pluggable:

    * ``backend="sounddevice"`` — a real PortAudio output stream when the
      optional ``sounddevice`` package is importable (the audible path on
      a host with audio hardware); the PortAudio callback calls
      :meth:`EngineOutput.fill` directly, so overruns are observed from
      the real device cadence.
    * ``backend="null"`` — a wall-clock-paced driver thread that invokes
      ``fill`` at the exact callback cadence a device would, writing into
      an optional ``sink(buf)`` — the headless twin used by tests and CI
      (this image has no audio stack at all: no ALSA/PortAudio, no
      /dev/snd).
    * ``backend="auto"`` — sounddevice if available, else null.
    """

    def __init__(self, output: EngineOutput, *, backend: str = "auto",
                 frames_per_buffer: int = 512, num_channels: int = 2,
                 sink=None, device=None):
        if backend == "auto":
            backend = "sounddevice" if sounddevice_available() else "null"
        if backend == "sounddevice" and not sounddevice_available():
            raise RuntimeError("sounddevice backend requested but the "
                               "package is not importable")
        self.output = output
        self.backend = backend
        self.frames = int(frames_per_buffer)
        self.channels = int(num_channels)
        self.sink = sink
        self.device = device
        self._stream = None
        self._thread = None
        self._running = False

    def start(self):
        self.output.start()
        self._running = True
        if self.backend == "sounddevice":
            import sounddevice as sd

            def callback(outdata, frames, time_info, status):
                buf = np.zeros(frames * self.channels, np.float32)
                self.output.fill(buf, self.channels)
                outdata[:] = buf.reshape(frames, self.channels)

            self._stream = sd.OutputStream(
                samplerate=self.output.sample_rate, blocksize=self.frames,
                channels=self.channels, dtype="float32", device=self.device,
                callback=callback)
            self._stream.start()
        else:
            self._thread = threading.Thread(target=self._null_loop, daemon=True)
            self._thread.start()

    def _null_loop(self):
        period = self.frames / self.output.sample_rate
        next_t = time.monotonic()
        buf = np.zeros(self.frames * self.channels, np.float32)
        while self._running:
            self.output.fill(buf, self.channels)
            if self.sink is not None:
                self.sink(buf.copy())
            next_t += period
            delay = next_t - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            else:
                next_t = time.monotonic()  # fell behind: resync, don't spin

    def stop(self):
        self._running = False
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
            self._stream = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.output.stop()
