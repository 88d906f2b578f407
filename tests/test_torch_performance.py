"""The port's ``PerformanceRecorder`` against the JAX package's, on the same
event sequences: tests/test_performance.py's cases (the defaults, punch-out
with one chord, overdub keeping the arm, clearing the clip, a live chord
with nothing armed, record then replay, overdub gate cutting, a stop that
finalizes the open chord) plus sampler hits recorded and replayed and a
clip of a few steps, each as a script of clock advances and host calls.
The clock advances as ``GooeyEngine`` advances it: one ``update_clock`` a
64-sample block at 120 BPM.  After every step the two recorders' returned
actions, sampler hits and whole state must be equal.
"""

import dataclasses

import pytest

from libgooey_tpu import performance as jperf

from libgooey_tpu_torch import performance as tperf

SR = 44100.0
BPM = 120.0
BLOCK = 64
STEP = (60.0 / BPM) / 4.0 * SR            # samples a sixteenth
CHORD = (0, 0, 0, 0, 1, 4, 0.9)

_STATE = ("length_ticks", "mode", "armed", "recording_active", "wait_for_loop_start",
          "punch_ticks_remaining", "playback_limit", "sampler_playback_limit",
          "playing_index", "open", "last_tick", "last_beat", "transport_running",
          "last_sampler_tick")


def _plain(x):
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


class _Session:
    """A recorder driven like the engine: a sample clock and a transport."""

    def __init__(self, mod):
        self.mod = mod
        self.p = mod.PerformanceRecorder()
        self.n = 0
        self.running = False
        self.log = []

    def beat(self):
        return self.n / (SR * 60.0 / BPM)

    def clock(self, samples):
        for _ in range(int(samples) // BLOCK):
            action = self.p.update_clock(self.beat(), self.running)
            hits = self.p.take_sampler_hits()
            if action is not None or hits:
                self.log.append((self.n, _plain(action), _plain(hits)))
            if self.running:
                self.n += BLOCK

    def do(self, op, *args):
        p = self.p
        if op == "clock":
            self.clock(args[0])
        elif op == "start":
            self.running = True
        elif op == "stop":
            self.running = False
        elif op == "arm":
            p.set_armed(args[0])
        elif op == "mode":
            p.mode = args[0]
        elif op == "length":
            p.set_length_steps(args[0])
        elif op == "chord_on":
            self.log.append(("on", p.record_chord_on(*args)))
        elif op == "chord_off":
            self.log.append(("off", p.record_chord_off()))
        elif op == "hit":
            self.log.append(("hit", p.record_sampler_hit(*args)))
        elif op == "clear":
            p.clear_clip()
        return self.observe()

    def observe(self):
        p = self.p
        return dict({f: getattr(p, f) for f in _STATE}, recording=p.is_recording(),
                    events=_plain(p.events), sampler_events=_plain(p.sampler_events),
                    log=list(self.log))


PUNCH, OVERDUB = jperf.MODE_PUNCH_OUT, jperf.MODE_OVERDUB
assert (PUNCH, OVERDUB) == (tperf.MODE_PUNCH_OUT, tperf.MODE_OVERDUB)

SCRIPTS = {
    "defaults": [("clock", 256)],
    "punch_out_one_chord": [
        ("mode", PUNCH), ("arm", True), ("start",), ("clock", 64), ("chord_on", *CHORD),
        ("clock", STEP * 4), ("chord_off",), ("clock", STEP * 12 + 512)],
    "overdub_keeps_arm_and_appends": [
        ("mode", OVERDUB), ("arm", True), ("start",), ("clock", 64), ("chord_on", *CHORD),
        ("clock", STEP * 4), ("chord_off",), ("clock", STEP * 12 + 256),
        ("chord_on", 0, 0, 4, 0, 1, 4, 0.8), ("clock", STEP * 4), ("chord_off",)],
    "clear_clip": [
        ("mode", OVERDUB), ("arm", True), ("start",), ("clock", 128),
        ("chord_on", 0, 0, 1, 0, 1, 4, 1.0), ("clock", 1024), ("chord_off",), ("clear",),
        ("clock", 512)],
    "live_chord_without_arm": [
        ("start",), ("chord_on", *CHORD), ("clock", 1024), ("chord_off",)],
    "record_then_replay": [
        ("mode", PUNCH), ("arm", True), ("start",), ("clock", 64),
        ("chord_on", 0, 0, 2, 0, 1, 4, 0.9), ("clock", STEP * 2), ("chord_off",),
        ("clock", STEP * 14 + 512), ("clock", STEP * 16)],
    "overdub_gate_cutting": [
        ("mode", OVERDUB), ("arm", True), ("start",), ("clock", 64), ("chord_on", *CHORD),
        ("clock", STEP * 10), ("chord_off",), ("clock", STEP * 6 + 256), ("clock", STEP * 4),
        ("chord_on", 0, 0, 4, 0, 1, 4, 0.8), ("clock", STEP * 2), ("chord_off",),
        ("clock", STEP * 8)],
    "stop_finalizes_open_chord": [
        ("mode", OVERDUB), ("arm", True), ("start",), ("clock", 64),
        ("chord_on", 0, 0, 3, 0, 1, 4, 0.7), ("clock", STEP * 3), ("stop",), ("clock", 512)],
    "sampler_hits_replay": [
        ("mode", OVERDUB), ("length", 4), ("arm", True), ("start",), ("clock", 64),
        ("hit", 0, 3, 0.9), ("clock", STEP), ("hit", 1, 5, 1.4), ("clock", STEP * 8),
        ("arm", False), ("clock", STEP * 8)],
    "arm_mid_loop_waits_for_loop_start": [
        ("start",), ("clock", STEP * 3), ("arm", True), ("chord_on", *CHORD),
        ("clock", STEP * 14), ("chord_on", 0, 1, 5, 2, 3, 2, 0.6), ("clock", STEP * 2),
        ("chord_off",), ("arm", False), ("clock", STEP * 16)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_recorder_matches_jax(name):
    a, b = _Session(jperf), _Session(tperf)
    for i, step in enumerate(SCRIPTS[name]):
        got, want = b.do(*step), a.do(*step)
        assert got == want, (name, i, step)
    final = b.observe()
    if name == "defaults":
        assert not final["armed"] and not final["events"]
        assert final["mode"] == PUNCH and final["length_ticks"] == 384
    if name == "punch_out_one_chord":
        assert not final["armed"] and len(final["events"]) == 1
    if name == "record_then_replay":
        assert any(entry[1] is not None and entry[1][0] == "trigger"
                   for entry in final["log"] if isinstance(entry[0], int))
    if name == "sampler_hits_replay":
        assert len(final["sampler_events"]) == 2
        assert any(entry[2] for entry in final["log"] if isinstance(entry[0], int))
