"""Music theory: notes, intervals, chords, scales, keys, voicings (the port's
own copy of libgooey_tpu/music/__init__.py).

Behavioral reference: src/music/ (790 LoC) — note names + midi_to_freq,
Interval, 18 ChordQualities (triads → 13ths) with interval spelling
(chord.rs:7-40), ScaleType + Key::diatonic_triads (key.rs:19-40), and
VoicingType + apply_voicing → MIDI notes (voicing.rs:57-180).
Pure host-side code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

NOTE_NAMES = ("C", "Cs", "D", "Ds", "E", "F", "Fs", "G", "Gs", "A", "As", "B")
NOTE_SEMITONE = {n: i for i, n in enumerate(NOTE_NAMES)}

# Interval semitones
UNISON, MINOR_SECOND, MAJOR_SECOND, MINOR_THIRD, MAJOR_THIRD = 0, 1, 2, 3, 4
PERFECT_FOURTH, TRITONE, PERFECT_FIFTH, MINOR_SIXTH, MAJOR_SIXTH = 5, 6, 7, 8, 9
MINOR_SEVENTH, MAJOR_SEVENTH, OCTAVE = 10, 11, 12
MAJOR_NINTH, PERFECT_ELEVENTH, MAJOR_THIRTEENTH = 14, 17, 21

#: ChordQuality → interval spelling in semitones (chord.rs:30-108)
CHORD_QUALITIES = {
    "major": (0, 4, 7),
    "minor": (0, 3, 7),
    "diminished": (0, 3, 6),
    "augmented": (0, 4, 8),
    "major7": (0, 4, 7, 11),
    "minor7": (0, 3, 7, 10),
    "dominant7": (0, 4, 7, 10),
    "diminished7": (0, 3, 6, 9),
    "half_diminished7": (0, 3, 6, 10),
    "minor_major7": (0, 3, 7, 11),
    "major9": (0, 4, 7, 11, 14),
    "minor9": (0, 3, 7, 10, 14),
    "dominant9": (0, 4, 7, 10, 14),
    "major11": (0, 4, 7, 11, 14, 17),
    "minor11": (0, 3, 7, 10, 14, 17),
    "dominant11": (0, 4, 7, 10, 14, 17),
    "major13": (0, 4, 7, 11, 14, 21),
    "minor13": (0, 3, 7, 10, 14, 21),
    "dominant13": (0, 4, 7, 10, 14, 21),
}

SCALES = {
    "major": (0, 2, 4, 5, 7, 9, 11),
    "natural_minor": (0, 2, 3, 5, 7, 8, 10),
}

#: Diatonic triad qualities per scale degree (key.rs:29-50)
DIATONIC_TRIADS = {
    "major": ("major", "minor", "minor", "major", "major", "minor", "diminished"),
    "natural_minor": ("minor", "diminished", "major", "minor", "minor", "major", "major"),
}

DIATONIC_SEVENTHS = {
    "major": ("major7", "minor7", "minor7", "major7", "dominant7", "minor7",
              "half_diminished7"),
    "natural_minor": ("minor7", "half_diminished7", "major7", "minor7", "minor7",
                      "major7", "dominant7"),
}

VOICINGS = (
    "root", "first_inversion", "second_inversion", "third_inversion",
    "open", "drop2", "drop3", "spread", "shell", "rootless",
)


def midi_to_freq(note: int) -> float:
    """A4 = 440 Hz equal temperament (note.rs:81)."""
    return 440.0 * 2.0 ** ((note - 69) / 12.0)


def note_to_midi(name: str, octave: int) -> int:
    """C4 = 60 convention (note.rs:87)."""
    return NOTE_SEMITONE[name] + (octave + 1) * 12


@dataclass(frozen=True)
class Chord:
    root: str           # note name
    quality: str        # key of CHORD_QUALITIES

    def intervals(self):
        return CHORD_QUALITIES[self.quality]


@dataclass(frozen=True)
class Key:
    root: str
    scale_type: str = "major"

    def scale_degrees(self) -> List[str]:
        base = NOTE_SEMITONE[self.root]
        return [NOTE_NAMES[(base + off) % 12] for off in SCALES[self.scale_type]]

    def diatonic_triads(self) -> List[Chord]:
        return [
            Chord(root, q)
            for root, q in zip(self.scale_degrees(), DIATONIC_TRIADS[self.scale_type])
        ]

    def diatonic_sevenths(self) -> List[Chord]:
        return [
            Chord(root, q)
            for root, q in zip(self.scale_degrees(), DIATONIC_SEVENTHS[self.scale_type])
        ]


def apply_voicing(chord: Chord, voicing: str = "root", octave: int = 4) -> List[int]:
    """Chord → voiced MIDI notes (voicing.rs:85-180)."""
    root_midi = note_to_midi(chord.root, octave)
    iv = list(chord.intervals())
    notes = [root_midi + i for i in iv]

    if voicing == "first_inversion" and notes:
        notes[0] += 12
    elif voicing == "second_inversion" and len(notes) >= 2:
        notes[0] += 12
        notes[1] += 12
    elif voicing == "third_inversion" and len(notes) >= 4:
        notes[0] += 12
        notes[1] += 12
        notes[2] += 12
    elif voicing == "open":
        for i in range(1, len(notes), 2):
            notes[i] += 12
    elif voicing == "drop2" and len(notes) >= 4:
        notes[-2] = max(notes[-2] - 12, 0)
    elif voicing == "drop3" and len(notes) >= 5:
        notes[-3] = max(notes[-3] - 12, 0)
    elif voicing == "spread":
        notes = [n + (i // 2) * 12 for i, n in enumerate(notes)]
    elif voicing == "shell":
        if len(iv) >= 4:
            notes = [root_midi + iv[0], root_midi + iv[1], root_midi + iv[3]]
        elif len(iv) >= 3:
            notes = [root_midi + iv[0], root_midi + iv[1], root_midi + iv[2] + 12]
    elif voicing == "rootless" and len(notes) >= 3:
        notes = notes[1:]
        notes[0] = max(notes[0] - 12, 0)

    return sorted(min(n, 127) for n in notes)
