"""Delay effect: times, feedback darkening, ping-pong
(port of examples/delay.py; mirrors the reference's examples/delay.rs)."""

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.io_wav import write_wav


def main(out_path: str = "/tmp/gooey_delay.wav", quick: bool = False, *, device=None,
         blocks=None):
    dev = card_or(device, "delay example")
    configs = (
        ("8th, dark feedback", [0.375, 0.55, 0.35, 2500.0], False),
        ("dotted 8th", [0.5625, 0.45, 0.35, 6000.0], False),
        ("quarter ping-pong", [0.75, 0.5, 0.4, 6000.0], True),
    )
    lengths = cut([22050 if quick else 2 * 44100] * len(configs), blocks)
    sections = []
    # one dry hit followed by its echo tail per configuration
    # targets = [time_s, feedback, mix, cutoff_hz]
    for (label, targets, pingpong), n in zip(configs, lengths):
        engine = Engine(44100.0, device=dev)
        engine.add_instrument("snare", "snare")
        engine.add_global_effect("delay", targets, pingpong=pingpong)
        engine.trigger("snare", 1.0)
        audio = engine.render(n)                  # [2, n] stereo
        sections.append(audio)
        print(f"{label}: tail peak {np.abs(audio[:, n // 2:]).max():.4f}")

    audio = np.concatenate(sections, axis=1)
    write_wav(out_path, audio, 44100)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
