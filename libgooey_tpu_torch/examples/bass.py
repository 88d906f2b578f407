"""Bass synth solo tour: presets, filter-envelope sweeps, note slides
(port of examples/bass.py; mirrors the reference's examples/bass.rs)."""

import dataclasses

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.instruments.bass import BassConfig
from libgooey_tpu_torch.io_wav import write_wav


def main(out_path: str = "/tmp/gooey_bass.wav", quick: bool = False, *, device=None,
         blocks=None):
    L = (lambda n: max(n // 16, 2048)) if quick else (lambda n: n)
    lengths = iter(cut([L(22050)] * 4 + [L(11025)] * 4, blocks))
    engine = Engine(44100.0, device=card_or(device, "bass example"))
    engine.add_instrument("bass", "bass")
    sections = []

    for preset in (BassConfig.acid, BassConfig.sub,
                   BassConfig.reese, BassConfig.stab):
        engine.set_config("bass", preset())
        engine.trigger("bass", 0.9)
        sections.append(engine.render_mono(next(lengths)))

    # filter cutoff / resonance sweep on the acid preset
    base = BassConfig.acid()
    for cutoff, res in ((0.05, 0.9), (0.2, 0.7), (0.5, 0.5), (0.9, 0.2)):
        engine.set_config("bass", dataclasses.replace(
            base, filter_cutoff=cutoff, filter_resonance=res))
        engine.trigger("bass", 0.9)
        sections.append(engine.render_mono(next(lengths)))

    audio = np.concatenate(sections)
    write_wav(out_path, audio, 44100)
    print(f"wrote {out_path} ({len(audio)} samples, peak {np.abs(audio).max():.3f})")
    return out_path


if __name__ == "__main__":
    main()
