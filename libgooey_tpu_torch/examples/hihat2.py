"""HiHat2 (the Max-derived FFI hat): presets, pitch sweep, pink vs white
noise (port of examples/hihat2.py; mirrors the reference's
examples/hihat2.rs)."""

import dataclasses

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.instruments.hihat2 import NOISE_PINK, HiHat2Config
from libgooey_tpu_torch.io_wav import write_wav


def main(out_path: str = "/tmp/gooey_hihat2.wav", quick: bool = False, *, device=None,
         blocks=None):
    L = (lambda n: max(n // 16, 2048)) if quick else (lambda n: n)
    lengths = iter(cut([L(22050)] * 4 + [L(11025)] * 4 + [L(22050)], blocks))
    engine = Engine(44100.0, device=card_or(device, "hihat2 example"))
    engine.add_instrument("hat", "hihat2")
    sections = []

    for preset in (HiHat2Config.short, HiHat2Config.loose,
                   HiHat2Config.dark, HiHat2Config.soft):
        engine.set_config("hat", preset())
        engine.trigger("hat", 0.9)
        sections.append(engine.render_mono(next(lengths)))

    # pitch sweep (the pow^2 curve makes the top octave open up late)
    base = HiHat2Config.short()
    for pitch in (0.2, 0.5, 0.76, 1.0):
        engine.set_config("hat", dataclasses.replace(base, pitch=pitch))
        engine.trigger("hat", 0.8)
        sections.append(engine.render_mono(next(lengths)))

    # pink-noise variant
    engine.set_config("hat", dataclasses.replace(base, noise_color=NOISE_PINK))
    engine.trigger("hat", 0.9)
    sections.append(engine.render_mono(next(lengths)))

    audio = np.concatenate(sections)
    write_wav(out_path, audio, 44100)
    print(f"wrote {out_path} ({len(audio)} samples, peak {np.abs(audio).max():.3f})")
    return out_path


if __name__ == "__main__":
    main()
