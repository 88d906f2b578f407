"""Offline bounce: tempo-derived lengths, preroll reset, 16/24/32-bit WAVs
(port of examples/bounce.py; mirrors the reference's examples/bounce.rs)."""

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.io_wav import write_wav


def _engine(dev):
    engine = Engine(44100.0, device=dev)
    engine.add_instrument("kick", "kick")
    engine.add_instrument("hat", "hihat2")
    for name, pattern in (("kick", "x...x...x...x..."), ("hat", "..x...x...x...x.")):
        seq = engine.new_sequencer(name, 128.0)
        seq.set_pattern_string(pattern)
        seq.start()
    return engine


def main(quick: bool = False, *, device=None, blocks=None, out_dir: str = "/tmp"):
    """``out_dir``: where the three WAVs go (``gooey_bounce_{bits}.wav``)."""
    dev = card_or(device, "bounce example")
    engine = _engine(dev)

    # bars -> samples at the engine's BPM (bounce.rs samples_for)
    n = engine.bounce_samples_for(128.0, bars=2)
    if quick:
        n = min(n, 16384)
    n, probe_n = cut([n, 4096], blocks)
    print(f"2 bars @128 BPM = {n} samples")

    # ONE bounce (bounce.rs renders once), encoded at every bit depth;
    # repeated bounces of a live engine aren't sample-identical (filter
    # tails persist across prepare_for_bounce, exactly like the reference,
    # which resets sequencers/LFOs/transport but not DSP state)
    engine.prepare_for_bounce()
    audio = engine.bounce_to_buffer(n)
    paths = []
    for bits in (16, 24, 32):
        path = f"{out_dir}/gooey_bounce_{bits}.wav"
        write_wav(path, audio, 44100, bits=bits)
        paths.append(path)
        print(f"wrote {path}")

    # bounce determinism: two freshly-built engines render identically
    # (reset == fresh-instance determinism; a REUSED engine's later bounces
    # keep decaying filter tails, exactly like the reference, so the probe
    # compares fresh instances)
    def fresh():
        e2 = _engine(dev)
        e2.prepare_for_bounce()
        return e2.bounce_to_buffer(probe_n)

    print("deterministic:", bool(np.array_equal(fresh(), fresh())))
    return paths


if __name__ == "__main__":
    main()
