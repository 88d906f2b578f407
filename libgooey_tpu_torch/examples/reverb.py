"""Spring reverb: decay/mix/damping sweeps on percussive input
(port of examples/reverb.py; mirrors the reference's examples/reverb.rs).
targets = [decay, mix, damping]."""

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.io_wav import write_wav


def main(out_path: str = "/tmp/gooey_reverb.wav", quick: bool = False, *, device=None,
         blocks=None):
    dev = card_or(device, "reverb example")
    configs = (
        ("small bright", [0.3, 0.3, 0.2]),
        ("medium", [0.6, 0.35, 0.5]),
        ("long dark", [0.85, 0.4, 0.8]),
    )
    lengths = cut([22050 if quick else 2 * 44100] * len(configs), blocks)
    sections = []
    for (label, targets), n in zip(configs, lengths):
        engine = Engine(44100.0, device=dev)
        engine.add_instrument("snare", "snare")
        engine.add_global_effect("spring", targets)
        engine.trigger("snare", 1.0)
        audio = engine.render(n)
        sections.append(audio)
        # tail energy at 1 s is the audible decay difference
        print(f"{label}: tail rms {np.sqrt(np.mean(audio[:, n // 2:] ** 2)):.5f}")

    audio = np.concatenate(sections, axis=1)
    write_wav(out_path, audio, 44100)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
