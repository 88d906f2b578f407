"""The port's ``midi.py`` and ``engine/legacy_sequencer.py`` against the JAX
package's, on the CPU: ``parse_stream``, ``StreamParser`` and ``load_smf``
on ``tests/test_midi.py``'s byte streams and in-memory SMFs give the same
``MidiEvent`` lists; ``MidiInput`` over a fake port; ``MidiDispatcher`` on
the port's ``Engine`` queues the same triggers and poly notes as the JAX
one on the same events, and ``render_events`` of 2,048 samples agrees within
1e-4; ``LegacySequencer`` fires the same (offset, step) lists.  One JAX
``Engine`` is compiled (a kick, a snare and a poly, B = 256).
"""

import struct

import numpy as np
import pytest

from libgooey_tpu import midi as jmidi
from libgooey_tpu.engine.engine import Engine as JEngine
from libgooey_tpu.engine.legacy_sequencer import LegacySequencer as JLegacy
from libgooey_tpu_torch import midi as tmidi
from libgooey_tpu_torch.engine.engine import Engine as TEngine
from libgooey_tpu_torch.engine.legacy_sequencer import LegacySequencer as TLegacy

SR = 44100.0
B = 256
TOL = 1e-4


def _vlq(x):
    out = [x & 0x7F]
    x >>= 7
    while x:
        out.append(0x80 | (x & 0x7F))
        x >>= 7
    return bytes(reversed(out))


def _smf(tracks, division=480, fmt=1):
    head = b"MThd" + struct.pack(">IHHH", 6, fmt, len(tracks), division)
    body = b""
    for evs in tracks:
        t = b"".join(evs) + b"\x00\xff\x2f\x00"   # end-of-track
        body += b"MTrk" + struct.pack(">I", len(t)) + t
    return head + body


def _fields(evs):
    return [(e.kind, e.channel, e.note, e.value, e.time) for e in evs]


STREAMS = {
    "note_on_off": bytes([0x90, 60, 100, 0x80, 60, 0]),
    "running_status_vel0": bytes([0x92, 36, 90, 38, 80, 36, 0]),
    "realtime_interleave": bytes([0x90, 0xF8, 60, 0xF8, 100, 62, 0xF8, 70]),
    "cc_pitchbend": bytes([0xB0, 74, 127, 0xE0, 0x00, 0x40]),
    "sysex_clears_status": bytes([0x91, 40, 10, 0xF0, 41, 11, 0x81, 40, 5, 0xC3, 7, 0xD3, 9]),
    "orphan_data": bytes([12, 34, 0x9F, 127, 127, 0xA0, 1, 2]),
}

TEMPO_T0 = [_vlq(0) + b"\xff\x51\x03" + (500_000).to_bytes(3, "big"),
            _vlq(480) + b"\xff\x51\x03" + (1_000_000).to_bytes(3, "big")]
TEMPO_T1 = [_vlq(0) + bytes([0x90, 36, 100]), _vlq(480) + bytes([60, 90]),
            _vlq(480) + bytes([0x80, 36, 0])]
DRUM_POLY = [_vlq(0) + bytes([0x99, 36, 100]), _vlq(240) + bytes([0x91, 64, 90]),
             _vlq(240) + bytes([0x81, 64, 0])]
SMFS = {
    "tempo_map": _smf([TEMPO_T0, TEMPO_T1]),
    "drum_poly": _smf([DRUM_POLY], division=480),
    "format0_sysex_cc": _smf([[_vlq(0) + b"\xf0\x03\x01\x02\xf7",
                               _vlq(10) + bytes([0xB2, 7, 64]),
                               _vlq(5) + bytes([0xE2, 0, 0x40]),
                               _vlq(7) + bytes([0x92, 50, 60])]], division=96, fmt=0),
}

#: the drum/poly SMF of tests/test_midi.py at 1/30 of its ticks: the poly
#: note at 367 samples, its release at 735, inside a 2,048-sample render
FAST_DRUM_POLY = _smf([[_vlq(0) + bytes([0x99, 36, 100]), _vlq(8) + bytes([0x91, 64, 90]),
                        _vlq(8) + bytes([0x81, 64, 0])]], division=480)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_parse_stream_matches_jax(name):
    data = STREAMS[name]
    want = _fields(jmidi.parse_stream(data))
    assert _fields(tmidi.parse_stream(data)) == want
    # byte by byte through one parser: the same events
    p = tmidi.StreamParser()
    got = []
    for b in data:
        got += p.feed(bytes([b]))
    assert _fields(got) == want


@pytest.mark.parametrize("name", sorted(SMFS))
def test_load_smf_matches_jax(name, tmp_path):
    want = _fields(jmidi.load_smf(SMFS[name]))
    assert want
    assert _fields(tmidi.load_smf(SMFS[name])) == want
    path = tmp_path / "song.mid"
    path.write_bytes(SMFS[name])
    assert _fields(tmidi.load_smf(str(path))) == want


def test_load_smf_rejects_like_jax():
    bad = (b"RIFFnope", SMFS["tempo_map"][:14] + b"MTrx",
           b"MThd" + struct.pack(">IHHH", 6, 0, 1, 0x8000 | 25))
    for data in bad:
        with pytest.raises(ValueError) as want:
            jmidi.load_smf(data)
        with pytest.raises(ValueError) as got:
            tmidi.load_smf(data)
        assert str(got.value) == str(want.value)


class _FakePort:
    def __init__(self, ports):
        self._ports = ports
        self._cb = None
        self.closed = False

    def get_ports(self):
        return self._ports

    def open_port(self, i):
        assert 0 <= i < len(self._ports)

    def set_callback(self, fn):
        self._cb = fn

    def close_port(self):
        self.closed = True

    def inject(self, data):
        self._cb((list(data), 0.0), None)


def test_midi_input_matches_jax():
    seen = {}
    for mod in (jmidi, tmidi):
        port = _FakePort(["Fake Pad"])
        mi = mod.MidiInput(backend=port)
        got = []
        assert mi.connect(got.append) == "Fake Pad"
        for chunk in (bytes([0x90, 36, 100]), bytes([40, 0]), bytes([0x80, 36, 0])):
            port.inject(chunk)
        mi.close()
        assert port.closed
        seen[mod] = _fields(got)
        empty = mod.MidiInput(backend=_FakePort([]))
        with pytest.raises(RuntimeError, match="No MIDI input devices"):
            empty.connect(lambda e: None)
        assert empty.list_ports() == []
    assert seen[tmidi] == seen[jmidi] and len(seen[jmidi]) == 3


def _engines():
    j = JEngine(SR, B)
    t = TEngine(SR, B, device="cpu")
    for e in (j, t):
        e.add_instrument("kick", "kick")
        e.add_instrument("snare", "snare")
        e.add_instrument("keys", "poly")
    return j, t


def _dispatcher(mod, engine):
    d = mod.MidiDispatcher(engine)
    d.map_note(36, "kick")               # any channel
    d.map_note(38, "snare", channel=9)   # the drum channel only
    d.map_poly(1, "keys")
    return d


def test_dispatcher_queues_the_same_triggers():
    """Each scheduled block's dispatch queues the same triggers (offsets,
    velocities) and poly notes (lanes, notes) on the two engines."""
    j, t = _engines()
    track = [_vlq(0) + bytes([0x99, 36, 100]), _vlq(3) + bytes([38, 70]),
             _vlq(0) + bytes([0x98, 38, 50]),            # not the drum channel
             _vlq(40) + bytes([0x91, 64, 90]), _vlq(0) + bytes([67, 80]),
             _vlq(200) + bytes([0x81, 64, 0]), _vlq(5) + bytes([0x92, 36, 30]),
             _vlq(300) + bytes([0x81, 67, 0])]
    jev = jmidi.load_smf(_smf([track]))
    tev = tmidi.load_smf(_smf([track]))
    jd, td = _dispatcher(jmidi, j), _dispatcher(tmidi, t)
    jblocks, tblocks = jd.schedule(jev, SR, B), td.schedule(tev, SR, B)
    assert sorted(jblocks) == sorted(tblocks)
    n_trig = n_poly = 0
    for bi in sorted(jblocks):
        assert [(o, _fields([e])) for o, e in tblocks[bi]] == \
            [(o, _fields([e])) for o, e in jblocks[bi]]
        for (o, ev), (o2, ev2) in zip(jblocks[bi], tblocks[bi]):
            jd.dispatch(ev, o)
            td.dispatch(ev2, o2)
        assert t._trigger_queue == j._trigger_queue
        assert t._poly_queue == j._poly_queue
        n_trig += len(j._trigger_queue)
        n_poly += len(j._poly_queue)
        for e in (j, t):
            e._trigger_queue.clear()
            e._poly_queue.clear()
    assert n_trig == 3 and n_poly == 4


def test_render_events_matches_jax():
    j, t = _engines()
    want = _dispatcher(jmidi, j).render_events(jmidi.load_smf(FAST_DRUM_POLY), 2048)
    got = _dispatcher(tmidi, t).render_events(tmidi.load_smf(FAST_DRUM_POLY), 2048)
    assert got.shape == want.shape == (2, 2048) and got.dtype == np.float32
    assert np.abs(want[:, :B]).max() > 1e-5      # the kick at t = 0
    assert np.abs(want[:, 512:]).max() > 1e-4    # the poly note
    err = float(np.abs(got - want).max())
    assert err <= TOL, err


@pytest.mark.parametrize("bpm,block", [(120.0, 11025), (120.0, 512), (137.0, 100),
                                       (333.3, 1000)])
def test_legacy_sequencer_matches_jax(bpm, block):
    """``tests/test_viz_misc.py``'s 8th grid and other tempos and blocks:
    the block path's (offset, step) lists, the per-sample shim's count, a
    stop, a BPM change and a reset."""
    seqs = (JLegacy(bpm, SR), TLegacy(bpm, SR))
    for s in seqs:
        s.start()
    fired = [[], []]
    for _ in range(int(5 * seqs[0].samples_per_8th) // block + 1):
        for i, s in enumerate(seqs):
            fired[i] += s.tick_block(block)
    assert fired[1] == fired[0] and len(fired[0]) >= 4
    for s in seqs:
        s.set_bpm(bpm * 1.5)
    steps = [[s.tick() for _ in range(30000)] for s in seqs]
    assert steps[1] == steps[0] and sum(steps[0]) >= 1
    for s in seqs:
        s.stop()
    assert [s.tick_block(44100) for s in seqs] == [[], []]
    for s in seqs:
        s.reset()
        s.start()
    assert seqs[1].tick_block(block) == seqs[0].tick_block(block)
    assert [s.get_current_step() for s in seqs] == [seqs[0].get_current_step()] * 2
