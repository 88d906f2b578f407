"""MIDI-driven drum kit: a Standard MIDI File plays the engine
(port of examples/midi_drums.py).

The headless analog of the reference's ``midi`` feature examples
(examples/kick.rs:379-476: MidiHandler -> note/velocity queue -> triggers):
a format-1 SMF (built in-code, no file dependencies) drives a GM-style
drum map plus a poly-synth channel through ``midi.MidiDispatcher``, and
the result bounces to a WAV.
"""

import struct

import numpy as np

from libgooey_tpu_torch import card_or, midi
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.io_wav import write_wav


def _vlq(x):
    out = [x & 0x7F]
    x >>= 7
    while x:
        out.append(0x80 | (x & 0x7F))
        x >>= 7
    return bytes(reversed(out))


def build_smf(bpm=120.0):
    """One bar of four-on-the-floor + off-beat hats + a held chord."""
    division = 480                     # ticks per quarter
    tempo = int(60e6 / bpm)
    t0 = [_vlq(0) + b"\xff\x51\x03" + tempo.to_bytes(3, "big")]
    drum = []
    t = 0

    def at(tick, ev):
        nonlocal t
        drum.append(_vlq(tick - t) + ev)
        t = tick

    for beat in range(4):
        q = beat * division
        at(q, bytes([0x99, 36, 110]))              # kick on the beat
        if beat in (1, 3):
            at(q, bytes([0x99, 38, 100]))          # snare on 2 and 4
        at(q + division // 2, bytes([0x99, 42, 70]))   # off-beat hat
    keys = [
        _vlq(0) + bytes([0x91, 48, 90]),           # C minor pad, channel 1
        _vlq(0) + bytes([0x91, 51, 90]),
        _vlq(0) + bytes([0x91, 55, 90]),
        _vlq(3 * division) + bytes([0x81, 48, 0]),
        _vlq(0) + bytes([0x81, 51, 0]),
        _vlq(0) + bytes([0x81, 55, 0]),
    ]

    def chunk(evs):
        body = b"".join(evs) + b"\x00\xff\x2f\x00"
        return b"MTrk" + struct.pack(">I", len(body)) + body

    head = b"MThd" + struct.pack(">IHHH", 6, 1, 3, division)
    return head + chunk(t0) + chunk(drum) + chunk(keys)


def main(out_path: str = "/tmp/gooey_midi_drums.wav", quick: bool = False, *, device=None,
         blocks=None):
    sr = 44100.0
    engine = Engine(sr, device=card_or(device, "midi_drums example"))
    engine.add_instrument("kick", "kick")
    engine.add_instrument("snare", "snare")
    engine.add_instrument("hat", "hihat2")
    engine.add_instrument("keys", "poly")

    d = midi.MidiDispatcher(engine)
    d.map_note(36, "kick")      # General MIDI drum notes, any channel
    d.map_note(38, "snare")
    d.map_note(42, "hat")
    d.map_poly(1, "keys")

    events = midi.load_smf(build_smf())
    seconds = 0.6 if quick else 2.4
    (n,) = cut([int(sr * seconds)], blocks)
    buf = d.render_events(events, n)

    write_wav(out_path, buf, int(sr))
    peak = float(np.abs(buf).max())
    print(f"rendered {buf.shape[1]} samples from "
          f"{len(events)} MIDI events -> {out_path} (peak {peak:.3f})")
    return out_path


if __name__ == "__main__":
    main()
