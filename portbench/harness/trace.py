"""The traced stretch: ``torch.profiler`` over a few steady blocks of the
window, reduced to what the per-layer readers take.

The profiler records the device's activity only (kernels, copies,
memsets), so that it adds little to the host's enqueue of a block.  The
stretch opens after a synchronization with one marker kernel
(``torch.cuda._sleep``, a few microseconds) launched on an idle device,
and closes after another synchronization; its wall is the host's clock
from the marker's launch to the close.  The marker's start on the device
ties the device's clock to the host's, so that the harness's host spans of
the traced blocks (``portbench.<span>``: what the host was doing) can name
each stretch of the window in which no device operation ran.  Busy time is
the union of the device operations.  Nothing is written to disk."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

MARKER_CYCLES = 1000


@dataclass
class Trace:
    blocks: int
    window_us: float
    busy_us: float
    ops: list = field(default_factory=list)        # (name, start_us, dur_us)
    gaps: list = field(default_factory=list)       # (host span, dur_us)


def is_marker(name: str) -> bool:
    return "spin_kernel" in name or "sleep" in name


class Tracer:
    def __init__(self, device, blocks: int):
        self.device, self.blocks = device, blocks
        self.started = self.active = False
        self.done = 0
        self.spans = []                 # (name, host t0, host t1), perf_counter seconds
        self._prof = None
        self._t_open = self._t_close = 0.0

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        self._prof.start()
        if cuda:
            torch.cuda.synchronize(self.device)
        self._t_open = time.perf_counter()
        if cuda:
            torch.cuda._sleep(MARKER_CYCLES)
        self.started = self.active = True

    def span(self, name: str, t0: float, t1: float):
        self.spans.append((name, t0, t1))

    def count_block(self) -> bool:
        """Count a traced block; True once the stretch has its blocks."""
        self.done += 1
        return self.done >= self.blocks

    def stop(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._t_close = time.perf_counter()
        self._prof.stop()
        self.active = False

    def result(self) -> Trace:
        from torch.autograd import DeviceType

        events = [e for e in self._prof.events() if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("portbench.")]
        events.sort(key=lambda e: e.time_range.start)
        marker = next((e for e in events if is_marker(e.name)), None)
        # device microseconds -> host seconds since the stretch opened
        d0 = marker.time_range.start if marker is not None else (
            events[0].time_range.start if events else 0.0)
        ops = [(e.name, float(e.time_range.start - d0),
                float(e.time_range.end - e.time_range.start))
               for e in events if e is not marker]
        window_us = (self._t_close - self._t_open) * 1e6
        busy, gaps, cursor = 0.0, [], 0.0
        for _name, s, d in ops:
            end = min(s + d, window_us)
            if s > cursor:
                gaps.append((cursor, s))
            if end > cursor:
                busy += end - max(s, cursor)
                cursor = end
        if window_us > cursor:
            gaps.append((cursor, window_us))
        spans = sorted(((t0 - self._t_open) * 1e6, (t1 - self._t_open) * 1e6, n)
                       for n, t0, t1 in self.spans)
        named = []
        for g0, g1 in gaps:
            mid, label = 0.5 * (g0 + g1), "harness"
            for s0, s1, name in spans:
                if s0 <= mid <= s1:
                    label = name
            named.append((label, g1 - g0))
        return Trace(blocks=self.done, window_us=window_us, busy_us=busy, ops=ops, gaps=named)


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time and the idle time by
    what the host was doing, in seconds."""
    by_op, by_gap = {}, {}
    for name, _s, d in trace.ops:
        by_op[name] = by_op.get(name, 0.0) + d
    for label, d in trace.gaps:
        by_gap[label] = by_gap.get(label, 0.0) + d
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], d * 1e-6] for n, d in top],
            "idle_gaps": [[n, d * 1e-6] for n, d in gaps]}
