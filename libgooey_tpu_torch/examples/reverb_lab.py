"""Plate-reverb laboratory: size/damping/width/predelay exploration with
measured T60s (port of examples/reverb_lab.py; mirrors the reference's
examples/reverb_lab.rs).  targets = [decay, mix, damping, predelay, width, size]."""

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.io_wav import write_wav

SR = 44100


def t60_estimate(tail: np.ndarray, sr: float) -> float:
    """Crude T60 from the energy-decay slope of a mono tail."""
    e = tail.astype(np.float64) ** 2
    # Schroeder backward integration
    edc = np.cumsum(e[::-1])[::-1]
    edc = 10 * np.log10(np.maximum(edc / max(edc[0], 1e-30), 1e-12))
    # fit between -5 and -25 dB
    lo = np.argmax(edc <= -5.0)
    hi = np.argmax(edc <= -25.0)
    if hi <= lo:
        return float("nan")
    slope = (edc[hi] - edc[lo]) / (hi - lo)       # dB per sample
    return -60.0 / slope / sr


def main(out_path: str = "/tmp/gooey_reverb_lab.wav", quick: bool = False, *, device=None,
         blocks=None):
    dev = card_or(device, "reverb_lab example")
    configs = (
        ("default plate", [0.5, 1.0, 0.3, 0.0, 1.0, 0.5]),
        ("small plate", [0.5, 1.0, 0.3, 0.0, 1.0, 0.15]),
        ("big hall-ish", [0.8, 1.0, 0.2, 0.04, 1.0, 0.9]),
        ("mono width=0", [0.6, 1.0, 0.3, 0.0, 0.0, 0.5]),
        ("predelay 120ms", [0.6, 1.0, 0.3, 0.6, 1.0, 0.5]),
    )
    lengths = cut([SR // 2 if quick else 3 * SR] * len(configs), blocks)
    sections = []
    for (label, targets), n in zip(configs, lengths):
        engine = Engine(44100.0, device=dev)
        engine.add_instrument("kick", "kick")
        engine.add_global_effect("plate", targets)
        engine.trigger("kick", 1.0)
        audio = engine.render(n)
        mono = audio.mean(axis=0)
        width = np.std(audio[0] - audio[1]) / max(np.std(audio[0] + audio[1]), 1e-9)
        print(f"{label}: T60≈{t60_estimate(mono[n // 4:], SR):.2f}s "
              f"side/mid {width:.3f}")
        sections.append(audio)

    audio = np.concatenate(sections, axis=1)
    write_wav(out_path, audio, SR)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
