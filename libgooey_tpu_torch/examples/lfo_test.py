"""LFO routing: tempo-synced wobble on the bass filter, plus a free-rate
pitch drift on the kick (port of examples/lfo_test.py; mirrors the
reference's examples/lfo_test.rs)."""

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.io_wav import write_wav


def main(out_path: str = "/tmp/gooey_lfo.wav", quick: bool = False, *, device=None,
         blocks=None):
    (n,) = cut([22050 if quick else 4 * 44100], blocks)
    engine = Engine(44100.0, device=card_or(device, "lfo_test example"))
    engine.add_instrument("bass", "bass")
    engine.add_instrument("kick", "kick")

    # LFO 0: tempo-synced 1/8 wobble on the bass filter cutoff
    engine.set_lfo(0, division=5, bpm=140.0, amount=0.5)  # 1/8 (DIVISION_BEATS)
    engine.add_lfo_route(0, "bass", "filter_cutoff", depth=0.8)

    # LFO 1: slow free-running drift on the kick pitch
    engine.set_lfo(1, frequency_hz=0.8, amount=0.2)
    engine.add_lfo_route(1, "kick", "frequency", depth=0.5)

    seq = engine.new_sequencer("bass", 140.0)
    seq.set_pattern_string("x.x.x.x.x.x.x.x.")
    seq.start()
    kseq = engine.new_sequencer("kick", 140.0)
    kseq.set_pattern_string("x...x...x...x...")
    kseq.start()

    audio = engine.render(n)
    write_wav(out_path, audio, 44100)
    print(f"wrote {out_path} (peak {np.abs(audio).max():.3f})")
    return out_path


if __name__ == "__main__":
    main()
