"""Acid bass line with per-step notes and filter modulation
(port of examples/bass_sequencer.py; the reference's bass.rs,
bass_sequencer.rs, lfo_test.rs)."""

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.instruments.bass import BassConfig


def main(seconds: float = 4.0, out_path: str = "/tmp/gooey_bass.wav", *, device=None,
         blocks=None):
    engine = Engine(44100.0, device=card_or(device, "bass_sequencer example"))
    engine.add_instrument("bass", "bass", BassConfig.acid())
    seq = engine.new_sequencer("bass", 130.0)
    seq.set_pattern_string("x.x.x.xxx.x.x.x.")
    for step, note in ((0, 33), (2, 33), (4, 36), (6, 31), (7, 33),
                       (8, 40), (10, 33), (12, 38), (14, 31)):
        seq.set_step_note(step, note)
    seq.set_swing(0.56)
    seq.start()
    # LFO 0 sweeps the filter each bar
    engine.set_lfo(0, division=2, bpm=130.0, amount=0.6)
    engine.add_lfo_route(0, "bass", "filter_cutoff")

    (n,) = cut([int(44100 * seconds)], blocks)
    engine.bounce_to_wav(out_path, n)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
