"""Tilt filter: spectral see-saw around 1 kHz on pink-ish material
(port of examples/tilt_filter.py; mirrors the reference's
examples/tilt_filter.rs).  targets = [tilt, gain]."""

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.io_wav import write_wav


def band_energy(x: np.ndarray, sr: float, lo: float, hi: float) -> float:
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1.0 / sr)
    return float(spec[(freqs >= lo) & (freqs < hi)].sum())


def main(out_path: str = "/tmp/gooey_tilt.wav", quick: bool = False, *, device=None,
         blocks=None):
    dev = card_or(device, "tilt_filter example")
    configs = (("dark (bass boost)", 0.15), ("flat", 0.5), ("bright (treble boost)", 0.85))
    lengths = cut([8192 if quick else 44100] * len(configs), blocks)
    sections = []
    for (label, tilt), n in zip(configs, lengths):
        engine = Engine(44100.0, device=dev)
        engine.add_instrument("hat", "hihat2")
        engine.add_instrument("kick", "kick")
        engine.add_global_effect("tilt", [tilt, 0.0])
        engine.trigger("hat", 1.0)
        engine.trigger("kick", 1.0)
        audio = engine.render(n)
        mono = audio.mean(axis=0)
        lo = band_energy(mono, 44100, 40, 500)
        hi = band_energy(mono, 44100, 4000, 16000)
        print(f"{label}: low/high energy ratio {lo / max(hi, 1e-12):.2f}")
        sections.append(audio)

    audio = np.concatenate(sections, axis=1)
    write_wav(out_path, audio, 44100)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
