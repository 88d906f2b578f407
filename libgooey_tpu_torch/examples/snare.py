"""Snare tour: presets, tone/noise balance sweep, velocity response
(port of examples/snare.py; mirrors the reference's examples/snare.rs)."""

import dataclasses

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.instruments.snare import SnareConfig
from libgooey_tpu_torch.io_wav import write_wav


def main(out_path: str = "/tmp/gooey_snare.wav", quick: bool = False, *, device=None,
         blocks=None):
    L = (lambda n: max(n // 16, 2048)) if quick else (lambda n: n)
    lengths = iter(cut([L(16384)] * 4 + [L(11025)] * 4, blocks))
    engine = Engine(44100.0, device=card_or(device, "snare example"))
    engine.add_instrument("snare", "snare")
    sections = []

    for preset in (SnareConfig.tight, SnareConfig.loose,
                   SnareConfig.hiss, SnareConfig.smack):
        engine.set_config("snare", preset())
        engine.trigger("snare", 0.9)
        sections.append(engine.render_mono(next(lengths)))

    # tone vs noise balance sweep on the tight preset
    base = SnareConfig.tight()
    for noise in (0.0, 0.33, 0.66, 1.0):
        engine.set_config("snare", dataclasses.replace(base, noise=noise))
        engine.trigger("snare", 0.8)
        sections.append(engine.render_mono(next(lengths)))

    audio = np.concatenate(sections)
    write_wav(out_path, audio, 44100)
    print(f"wrote {out_path} ({len(audio)} samples, peak {np.abs(audio).max():.3f})")
    return out_path


if __name__ == "__main__":
    main()
