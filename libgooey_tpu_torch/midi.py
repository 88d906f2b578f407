"""MIDI input: byte-stream parser, Standard MIDI File reader, dispatcher
(port of libgooey_tpu/midi.py).

Behavioral reference: the ``midi`` cargo feature (optional ``midir`` 0.10)
and the per-example MidiHandler pattern (examples/kick.rs:379-426): connect
to the first input port, parse Note On with velocity > 0, queue ``(note,
velocity)`` pairs the control thread drains into instrument triggers.  The
reference keeps MIDI OUT separately in the FFI (drain queue,
ffi.rs:2146-2168; ``Engine.drain_midi_out``); MIDI *input* is a host-side
example feature, so this module is host code: nothing here runs on the
card except the renders :class:`MidiDispatcher` asks of the port's
``Engine``.

* :func:`parse_stream` -- incremental byte parser (running status,
  velocity-0-as-note-off, channel filter) usable from any backend
  callback;
* :class:`MidiInput` -- live-input adapter over ``python-rtmidi`` when
  installed; with no backend or device it reports "no MIDI device", as the
  reference does (kick.rs:469-476), and accepts injected fake ports for
  tests;
* :func:`load_smf` -- Standard MIDI File (format 0/1) reader with tempo
  map, emitting absolute-time events -- the headless equivalent of a live
  performance, feeding :class:`MidiDispatcher`;
* :class:`MidiDispatcher` -- maps (channel, note) onto the port's engine
  triggers / poly note on-off like the examples' KICK_NOTE tables.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

__all__ = [
    "MidiEvent", "parse_stream", "StreamParser", "MidiInput",
    "load_smf", "MidiDispatcher",
]


@dataclass(frozen=True)
class MidiEvent:
    """One channel-voice event.

    ``kind``: "on" | "off" | "cc" | "pitchbend".  ``time`` is seconds for
    SMF events (0.0 for live events — the host applies its own clock).
    """

    kind: str
    channel: int
    note: int          # note number, or controller number for "cc"
    value: float       # velocity / controller value, normalized 0-1
    time: float = 0.0

    @property
    def velocity(self) -> float:
        return self.value


class StreamParser:
    """Incremental MIDI byte parser with running status.

    Mirrors what the reference's callback does inline
    (kick.rs:400-406: ``(msg[0] & 0xF0) == 0x90 && msg[2] > 0``) but
    covers note-off, velocity-0 note-ons (treated as note-off per the
    MIDI spec), CC and pitch bend, and survives arbitrary chunking of
    the byte stream.
    """

    _LEN = {0x80: 2, 0x90: 2, 0xA0: 2, 0xB0: 2, 0xC0: 1, 0xD0: 1, 0xE0: 2}

    def __init__(self):
        self._status = 0
        self._data: List[int] = []

    def feed(self, data: bytes) -> List[MidiEvent]:
        out: List[MidiEvent] = []
        for b in data:
            if b >= 0xF8:        # real-time messages: ignore, keep status
                continue
            if b & 0x80:
                if b >= 0xF0:    # system common clears running status
                    self._status = 0
                    self._data = []
                    continue
                self._status = b
                self._data = []
                continue
            if not self._status:
                continue         # data byte with no status: drop
            self._data.append(b)
            need = self._LEN[self._status & 0xF0]
            if len(self._data) < need:
                continue
            ev = self._emit(self._status, self._data)
            self._data = []      # running status: keep self._status
            if ev is not None:
                out.append(ev)
        return out

    @staticmethod
    def _emit(status: int, data: List[int]) -> Optional[MidiEvent]:
        kind = status & 0xF0
        ch = status & 0x0F
        if kind == 0x90 and data[1] > 0:
            return MidiEvent("on", ch, data[0], data[1] / 127.0)
        if kind == 0x80 or (kind == 0x90 and data[1] == 0):
            return MidiEvent("off", ch, data[0], 0.0)
        if kind == 0xB0:
            return MidiEvent("cc", ch, data[0], data[1] / 127.0)
        if kind == 0xE0:
            bend = ((data[1] << 7) | data[0]) / 16383.0 * 2.0 - 1.0
            return MidiEvent("pitchbend", ch, 0, bend)
        return None


def parse_stream(data: bytes) -> List[MidiEvent]:
    """Parse a complete MIDI byte string (one-shot convenience)."""
    return StreamParser().feed(data)


class MidiInput:
    """Live MIDI input over ``python-rtmidi`` when available.

    API mirrors the reference handler (kick.rs:385-426): connect to the
    first port (or ``port_index``), deliver parsed events to ``callback``.
    Without a backend or device this raises ``RuntimeError`` from
    ``connect`` — callers degrade to keyboard-only exactly like the
    reference example.  ``backend`` may be injected for tests: any object
    with ``get_ports() -> [str]``, ``open_port(i)``,
    ``set_callback(fn)`` and ``close_port()``.
    """

    def __init__(self, name: str = "libgooey", backend=None):
        self.name = name
        self._backend = backend
        self._parser = StreamParser()
        self._callback: Optional[Callable[[MidiEvent], None]] = None
        self._open = False

    def _resolve_backend(self):
        if self._backend is not None:
            return self._backend
        try:  # pragma: no cover - optional dependency
            import rtmidi

            self._backend = rtmidi.MidiIn()
        except Exception as exc:
            raise RuntimeError(f"no MIDI backend available: {exc}") from exc
        return self._backend

    def list_ports(self) -> List[str]:
        try:
            return list(self._resolve_backend().get_ports())
        except RuntimeError:
            return []

    def connect(self, callback: Callable[[MidiEvent], None],
                port_index: int = 0) -> str:
        be = self._resolve_backend()
        ports = be.get_ports()
        if not ports:
            raise RuntimeError("No MIDI input devices found")
        be.open_port(port_index)
        self._callback = callback

        def _raw(message, _data=None):
            # rtmidi delivers ((bytes, delta_t), data); fakes may pass bytes
            msg = message[0] if isinstance(message, tuple) else message
            for ev in self._parser.feed(bytes(msg)):
                if self._callback is not None:
                    self._callback(ev)

        be.set_callback(_raw)
        self._open = True
        return ports[port_index]

    def close(self):
        if self._open:
            self._backend.close_port()
            self._open = False


# --- Standard MIDI File reader -------------------------------------------------


def _read_vlq(data: bytes, i: int) -> Tuple[int, int]:
    val = 0
    while True:
        b = data[i]
        i += 1
        val = (val << 7) | (b & 0x7F)
        if not b & 0x80:
            return val, i


def load_smf(source) -> List[MidiEvent]:
    """Read a Standard MIDI File (format 0 or 1) → time-sorted events.

    ``source`` is a path or a ``bytes`` object.  Tick times convert to
    seconds through the tempo map (set-tempo meta events, default
    500,000 us/quarter); format-1 tracks share track 0's tempo map per
    the SMF spec.  Only channel-voice events surface (notes, CC,
    pitch bend) — the events :class:`MidiDispatcher` consumes.
    """
    data = source if isinstance(source, (bytes, bytearray)) else open(
        source, "rb").read()
    if data[:4] != b"MThd":
        raise ValueError("not a Standard MIDI File (missing MThd)")
    hlen, fmt, ntrk, division = struct.unpack(">IHHH", data[4:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division is not supported")
    i = 8 + hlen

    tracks = []
    for _ in range(ntrk):
        if data[i:i + 4] != b"MTrk":
            raise ValueError("bad track chunk")
        (tlen,) = struct.unpack(">I", data[i + 4:i + 8])
        tracks.append(data[i + 8:i + 8 + tlen])
        i += 8 + tlen

    # pass 1: tempo map in ticks (all tracks; format 0/1 both work)
    tempo_map: List[Tuple[int, int]] = [(0, 500_000)]
    parsed_tracks = []
    for trk in tracks:
        events = []           # (tick, status, d1, d2) or (tick, "tempo", us)
        tick = 0
        j = 0
        status = 0
        while j < len(trk):
            dt, j = _read_vlq(trk, j)
            tick += dt
            b = trk[j]
            if b == 0xFF:                       # meta
                mtype = trk[j + 1]
                mlen, k = _read_vlq(trk, j + 2)
                if mtype == 0x51 and mlen == 3:
                    us = int.from_bytes(trk[k:k + 3], "big")
                    tempo_map.append((tick, us))
                j = k + mlen
                status = 0
            elif b in (0xF0, 0xF7):             # sysex
                mlen, k = _read_vlq(trk, j + 1)
                j = k + mlen
                status = 0
            else:
                if b & 0x80:
                    status = b
                    j += 1
                n = StreamParser._LEN.get(status & 0xF0)
                if n is None:
                    raise ValueError(f"bad status byte 0x{status:02x}")
                d = trk[j:j + n]
                j += n
                events.append((tick, status, list(d)))
        parsed_tracks.append(events)

    tempo_map.sort()

    def tick_to_seconds(t: int) -> float:
        secs = 0.0
        prev_tick, us = tempo_map[0]
        for mt, mus in tempo_map[1:]:
            if mt >= t:
                break
            secs += (mt - prev_tick) * us / (1e6 * division)
            prev_tick, us = mt, mus
        return secs + (t - prev_tick) * us / (1e6 * division)

    out: List[MidiEvent] = []
    for events in parsed_tracks:
        for tick, status, d in events:
            ev = StreamParser._emit(status, d)
            if ev is not None:
                out.append(MidiEvent(ev.kind, ev.channel, ev.note, ev.value,
                                     tick_to_seconds(tick)))
    out.sort(key=lambda e: (e.time, e.kind != "off"))
    return out


# --- dispatcher -----------------------------------------------------------------


@dataclass
class MidiDispatcher:
    """Route MIDI events onto the port's
    :class:`~libgooey_tpu_torch.engine.engine.Engine` (or anything with its
    ``trigger`` / ``poly_note_on`` / ``poly_note_off``).

    ``note_map`` maps ``(channel, note)`` (or ``(None, note)`` for any
    channel) to a drum-instrument name — the analog of the examples'
    KICK_NOTE / KICK_NOTE_ALT tables (kick.rs:403-406).  ``poly_map``
    maps a channel to a poly-synth name; its notes become
    ``poly_note_on/off`` with the note number preserved (chords work).
    """

    engine: object
    note_map: Dict[Tuple[Optional[int], int], str] = field(default_factory=dict)
    poly_map: Dict[int, str] = field(default_factory=dict)

    def map_note(self, note: int, instrument: str,
                 channel: Optional[int] = None):
        self.note_map[(channel, note)] = instrument

    def map_poly(self, channel: int, instrument: str):
        self.poly_map[channel] = instrument

    def dispatch(self, ev: MidiEvent, offset: int = 0):
        """Apply one event (live path: offset = in-block sample offset)."""
        if ev.kind == "on":
            name = self.note_map.get((ev.channel, ev.note)) or self.note_map.get(
                (None, ev.note))
            if name is not None:
                self.engine.trigger(name, ev.value, offset)
                return
            poly = self.poly_map.get(ev.channel)
            if poly is not None:
                self.engine.poly_note_on(poly, ev.note, ev.value)
        elif ev.kind == "off":
            poly = self.poly_map.get(ev.channel)
            if poly is not None:
                self.engine.poly_note_off(poly, ev.note)

    def schedule(self, events: List[MidiEvent], sample_rate: float,
                 block_size: int):
        """Group SMF events into per-block offset lists for offline render.

        Returns ``{block_index: [(offset, MidiEvent)]}`` — the host loop
        dispatches each block's list (with offsets) before rendering it,
        mirroring the reference's sample-offset trigger application
        (ffi.rs:1152-1205).
        """
        blocks: Dict[int, List[Tuple[int, MidiEvent]]] = {}
        for ev in events:
            s = int(round(ev.time * sample_rate))
            blocks.setdefault(s // block_size, []).append((s % block_size, ev))
        for lst in blocks.values():
            lst.sort(key=lambda t: t[0])
        return blocks

    def render_events(self, events: List[MidiEvent], num_samples: int):
        """Offline render: dispatch scheduled events block-by-block.

        Returns the stereo buffer ``[2, num_samples]`` (numpy), copied from
        the device once, after the last block.
        """
        e = self.engine
        blocks = self.schedule(events, e.sample_rate, e.block_size)
        out = []
        rendered = 0
        bi = 0
        while rendered < num_samples:
            for offset, ev in blocks.get(bi, ()):
                self.dispatch(ev, offset)
            stereo, _ = e.render_block()
            out.append(stereo)
            rendered += e.block_size
            bi += 1
        return torch.cat(out, dim=1)[:, :num_samples].cpu().numpy()
