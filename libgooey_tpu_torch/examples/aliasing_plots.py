"""Aliasing comparison data: naive vs polyBLEP saw/square spectra across a
frequency ladder, written as CSV + WAV (port of examples/aliasing_plots.py;
mirrors the reference's examples/aliasing_plots.rs, which renders plot
images; headless here, the spectra are exported).  The waveforms are
computed on the device; the spectra on the host in numpy."""

import csv

import numpy as np
import torch

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.io_wav import write_wav
from libgooey_tpu_torch.ops import osc

SR = 44100.0
N = 1 << 15
FREQS = (440.0, 1760.0, 3520.0, 7040.0)


def spectrum_db(x):
    w = np.hanning(len(x))
    spec = np.abs(np.fft.rfft(x * w))
    return 20 * np.log10(np.maximum(spec / max(spec.max(), 1e-12), 1e-7))


def alias_power_db(x, fund):
    """Energy in non-harmonic bins relative to total, in dB."""
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    freqs = np.fft.rfftfreq(len(x), 1.0 / SR)
    harm = np.zeros_like(spec, bool)
    k = fund
    while k < SR / 2:
        harm |= np.abs(freqs - k) < (2 * SR / len(x))
        k += fund
    alias = spec[~harm].sum()
    return 10 * np.log10(max(alias, 1e-20) / spec.sum())


def main(csv_path: str = "/tmp/gooey_aliasing.csv", quick: bool = False, *, device=None,
         blocks=None, wav_path: str = "/tmp/gooey_aliasing_ab.wav"):
    dev = card_or(device, "aliasing_plots example")
    freqs = FREQS[:1] if quick else FREQS
    (n,) = cut([N], blocks)
    n_idx = torch.arange(n, dtype=torch.float32, device=dev)
    rows = []
    audio = []
    for f in freqs:
        for wave, naive_fn, blep_fn in (
            ("saw", osc.saw_naive, osc.saw_blep),
            ("square", osc.square_naive, osc.square_blep),
        ):
            freq = torch.full_like(n_idx, f)
            naive = naive_fn(n_idx, freq, SR).cpu().numpy()
            blep = blep_fn(n_idx, freq, SR).cpu().numpy()
            a_n = alias_power_db(naive, f)
            a_b = alias_power_db(blep, f)
            rows.append((wave, f, a_n, a_b, a_n - a_b))
            print(f"{wave} @ {f:.0f} Hz: naive alias {a_n:.1f} dB, "
                  f"polyBLEP {a_b:.1f} dB (improvement {a_n - a_b:.1f} dB)")
            audio.append(naive[: n // 4] * 0.5)
            audio.append(blep[: n // 4] * 0.5)

    with open(csv_path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["wave", "freq_hz", "naive_alias_db", "blep_alias_db",
                    "improvement_db"])
        w.writerows(rows)
    print(f"wrote {csv_path}")

    write_wav(wav_path, np.concatenate(audio), int(SR))
    print(f"wrote {wav_path}")
    return csv_path


if __name__ == "__main__":
    main()
