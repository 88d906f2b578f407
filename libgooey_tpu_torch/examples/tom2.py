"""Tom2 (the Max-derived FFI tom): presets plus tune/bend/membrane sweeps
(port of examples/tom2.py; mirrors the reference's examples/tom2.rs)."""

import dataclasses

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.instruments.tom2 import Tom2Config
from libgooey_tpu_torch.io_wav import write_wav


def main(out_path: str = "/tmp/gooey_tom2.wav", quick: bool = False, *, device=None,
         blocks=None):
    L = (lambda n: max(n // 16, 2048)) if quick else (lambda n: n)
    lengths = iter(cut([L(33075)] * 4 + [L(11025)] * 7 + [L(22050)] * 3, blocks))
    engine = Engine(44100.0, device=card_or(device, "tom2 example"))
    engine.add_instrument("tom", "tom2")
    sections = []

    for preset in (Tom2Config.derp, Tom2Config.ring,
                   Tom2Config.brush, Tom2Config.void_preset):
        engine.set_config("tom", preset())
        engine.trigger("tom", 1.0)
        sections.append(engine.render_mono(next(lengths)))

    # tune ladder (pow-2 knee: 40-600 Hz), then bend depth, then membrane wet
    base = Tom2Config()
    for tune in (20.0, 40.0, 60.0, 80.0):
        engine.set_config("tom", dataclasses.replace(base, tune=tune, decay=15.0))
        engine.trigger("tom", 1.0)
        sections.append(engine.render_mono(next(lengths)))
    for bend in (0.0, 50.0, 100.0):
        engine.set_config("tom", dataclasses.replace(base, bend=bend, decay=15.0))
        engine.trigger("tom", 1.0)
        sections.append(engine.render_mono(next(lengths)))
    for membrane in (0.0, 50.0, 100.0):
        engine.set_config("tom", dataclasses.replace(base, membrane=membrane))
        engine.trigger("tom", 1.0)
        sections.append(engine.render_mono(next(lengths)))

    audio = np.concatenate(sections)
    write_wav(out_path, audio, 44100)
    print(f"wrote {out_path} ({len(audio)} samples, peak {np.abs(audio).max():.3f})")
    return out_path


if __name__ == "__main__":
    main()
