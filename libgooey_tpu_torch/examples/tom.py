"""Tom v1: the high/mid/low/floor presets and a fill
(port of examples/tom.py; mirrors the reference's examples/tom.rs)."""

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.instruments.tom import TomConfig
from libgooey_tpu_torch.io_wav import write_wav


def main(out_path: str = "/tmp/gooey_tom.wav", quick: bool = False, *, device=None,
         blocks=None):
    L = (lambda n: max(n // 16, 2048)) if quick else (lambda n: n)
    lengths = iter(cut([L(22050)] * 4 + [L(5513)] * 4, blocks))
    engine = Engine(44100.0, device=card_or(device, "tom example"))
    engine.add_instrument("tom", "tom")
    sections = []

    for preset in (TomConfig.high_tom, TomConfig.mid_tom,
                   TomConfig.low_tom, TomConfig.floor_tom):
        engine.set_config("tom", preset())
        engine.trigger("tom", 0.9)
        sections.append(engine.render_mono(next(lengths)))

    # a descending fill: high -> floor at 16th-note spacing
    for preset, vel in ((TomConfig.high_tom, 1.0), (TomConfig.mid_tom, 0.9),
                        (TomConfig.low_tom, 0.9), (TomConfig.floor_tom, 1.0)):
        engine.set_config("tom", preset())
        engine.trigger("tom", vel)
        sections.append(engine.render_mono(next(lengths)))

    audio = np.concatenate(sections)
    write_wav(out_path, audio, 44100)
    print(f"wrote {out_path} ({len(audio)} samples, peak {np.abs(audio).max():.3f})")
    return out_path


if __name__ == "__main__":
    main()
