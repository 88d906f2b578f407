"""Sequencer deep-dive: swing, per-step velocity/notes/blends, armed start,
triggers-enabled toggle (port of examples/sequencer.py; mirrors the
reference's examples/sequencer.rs)."""

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.io_wav import write_wav


def main(out_path: str = "/tmp/gooey_sequencer.wav", quick: bool = False, *, device=None,
         blocks=None):
    n = 11025 if quick else 44100
    first_n, muted_n, resumed_n = cut([2 * n, n, 2 * n], blocks)
    engine = Engine(44100.0, device=card_or(device, "sequencer example"))
    engine.add_instrument("kick", "kick")
    engine.add_instrument("bass", "bass")

    kick = engine.new_sequencer("kick", 124.0)
    kick.set_pattern_string("x...x...x...x...")
    kick.set_swing(0.62)

    bass = engine.new_sequencer("bass", 124.0)
    for i, note in ((0, 36), (3, 39), (6, 41), (10, 36), (12, 43)):
        bass.set_step_with_settings(i, True, 0.9, note=note)
    bass.set_swing(0.62)

    kick.start()
    bass.start()
    first = engine.render(first_n)

    # toggle triggers off: phase keeps advancing, no new hits
    kick.triggers_enabled = False
    muted = engine.render(muted_n)
    kick.triggers_enabled = True
    resumed = engine.render(resumed_n)

    audio = np.concatenate([first, muted, resumed], axis=1)
    events = engine.drain_midi_out()
    print(f"{len(events)} midi events; first five: {events[:5]}")
    write_wav(out_path, audio, 44100)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
