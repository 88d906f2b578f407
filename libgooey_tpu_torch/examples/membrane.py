"""Membrane resonator lab: noise burst x MaxCurve envelope exciting the
5-band resonator, with Q/gain scale sweeps (port of examples/membrane.py;
mirrors the reference's examples/membrane.rs, the same
``noise~ -> *~ envelope -> MembraneResonator`` patch, batched).  The
resonator's bands run in ``linrec2_bank`` on the card."""

import numpy as np
import torch

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.core import rng
from libgooey_tpu_torch.core.max_curve import max_curve
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.io_wav import write_wav
from libgooey_tpu_torch.ops import filters

SR = 44100.0
B = 512


def render_hit(q_scale: float, gain_scale: float, seconds: float = 2.5, *, device,
               samples=None):
    """One membrane hit: envelope [(1, 5ms, 0.8), (0, 2000ms, -0.83)].
    ``samples`` overrides the length ``seconds`` gives."""
    n = int(SR * seconds) if samples is None else int(samples)
    t = torch.as_tensor(np.arange(n, dtype=np.float32) / SR, device=device)
    attack_s, decay_s = 0.005, 2.0
    env = torch.where(
        t < attack_s,
        max_curve(t / attack_s, 0.8),
        1.0 - max_curve(torch.clamp((t - attack_s) / decay_s, 0, 1), -0.83),
    )
    noise = rng.white(torch.arange(n, dtype=torch.int64, device=device)) * 0.99
    excite = (noise * env)[None, :]

    state = filters.MembraneState.init((1,), device)
    q = torch.full((1,), q_scale, dtype=torch.float32, device=device)
    g = torch.full((1,), gain_scale, dtype=torch.float32, device=device)
    outs = []
    ring_peak = torch.zeros((), device=device)
    for s in range(0, n, B):
        state, y, ring = filters.membrane_block(state, excite[:, s:s + B], q, g, SR)
        outs.append(y[0])
        ring_peak = torch.maximum(ring_peak, ring.max())
    return torch.cat(outs).cpu().numpy(), float(ring_peak)


def main(out_path: str = "/tmp/gooey_membrane.wav", quick: bool = False, *, device=None,
         blocks=None):
    dev = card_or(device, "membrane example")
    secs = 0.25 if quick else 2.5
    hits = ([(f"q_scale={q}", q, 0.001) for q in (0.005, 0.01, 0.02)]
            + [(f"gain_scale={g}", 0.01, g) for g in (0.0005, 0.001, 0.002)])
    lengths = cut([int(SR * secs)] * len(hits), blocks)
    sections = []
    # the membrane.rs arrow-key sweeps: Q scaling then gain scaling
    for (label, q, g), n in zip(hits, lengths):
        audio, ring = render_hit(q, g, device=dev, samples=n)
        print(f"{label}: peak {np.abs(audio).max():.4f} ring {ring:.5f}")
        sections.append(audio)

    audio = np.concatenate(sections)
    write_wav(out_path, audio, 44100)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
