"""Granulator cloud over a captured tone (port of examples/granular.py;
the reference's granulator.rs)."""

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.gooey import GooeyEngine
from libgooey_tpu_torch.io_wav import write_wav


def main(seconds: float = 3.0, out_path: str = "/tmp/gooey_granular.wav", *, device=None,
         blocks=None):
    g = GooeyEngine(44100.0, device=card_or(device, "granular example"))
    t = np.arange(44100) / 44100.0
    source = (0.5 * np.sin(2 * np.pi * 220 * t)
              * np.exp(-2.0 * t)).astype(np.float32)
    g.granulator_load(source, 44100.0)
    for name, value in (("density", 0.7), ("grain_length", 0.5),
                        ("spray", 0.3), ("texture", 0.6),
                        ("cloud_duration", 0.8), ("volume", 0.9)):
        g.granulator_set_param(name, value)
    g.granulator_trigger(1.0)
    (n,) = cut([int(44100 * seconds)], blocks)
    inter = g.render(n)
    write_wav(out_path, inter.reshape(-1, 2).T, 44100)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
