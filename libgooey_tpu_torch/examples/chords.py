"""Poly-synth chord progression through the music layer
(port of examples/chords.py; the reference's chords.rs)."""

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.instruments.poly import PolySynthConfig
from libgooey_tpu_torch.io_wav import write_wav


def main(seconds: float = 4.0, out_path: str = "/tmp/gooey_chords.wav", *, device=None,
         blocks=None):
    engine = Engine(44100.0, device=card_or(device, "chords example"))
    engine.add_instrument("poly", "poly", PolySynthConfig.pad())
    progression = (("C", "major"), ("A", "minor"), ("F", "major7"),
                   ("G", "dominant7"))
    holds = cut([int(44100 * seconds / len(progression))] * len(progression), blocks)
    chunks = []
    for (root, quality), hold in zip(progression, holds):
        engine.poly_chord_on("poly", root, quality, octave=4, velocity=0.8)
        chunks.append(engine.render(hold))
        engine.poly_chord_off("poly", root, quality, octave=4)

    audio = np.concatenate([np.asarray(c) for c in chunks], axis=-1)
    write_wav(out_path, audio, 44100)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
