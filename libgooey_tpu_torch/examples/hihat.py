"""HiHat v1: open/closed presets and a choke pattern
(port of examples/hihat.py; mirrors the reference's examples/hihat.rs)."""

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.instruments.hihat import HiHatConfig
from libgooey_tpu_torch.io_wav import write_wav


def main(out_path: str = "/tmp/gooey_hihat.wav", quick: bool = False, *, device=None,
         blocks=None):
    L = (lambda n: max(n // 16, 2048)) if quick else (lambda n: n)
    presets = (HiHatConfig.closed_default, HiHatConfig.closed_tight,
               HiHatConfig.closed_dark, HiHatConfig.open_default,
               HiHatConfig.open_bright, HiHatConfig.open_long)
    lengths = iter(cut([L(22050)] * len(presets) + [L(2 * 44100)], blocks))
    engine = Engine(44100.0, device=card_or(device, "hihat example"))
    engine.add_instrument("hat", "hihat")
    sections = []

    for preset in presets:
        engine.set_config("hat", preset())
        engine.trigger("hat", 0.9)
        sections.append(engine.render_mono(next(lengths)))

    # a closed 8th pattern with an open accent (the hihat.rs demo groove)
    engine.set_config("hat", HiHatConfig.closed_tight())
    seq = engine.new_sequencer("hat", 130.0)
    seq.set_pattern_string("9.5.9.5.9.5.9.5.")
    seq.start()
    sections.append(engine.render_mono(next(lengths)))

    audio = np.concatenate(sections)
    write_wav(out_path, audio, 44100)
    print(f"wrote {out_path} ({len(audio)} samples, peak {np.abs(audio).max():.3f})")
    return out_path


if __name__ == "__main__":
    main()
