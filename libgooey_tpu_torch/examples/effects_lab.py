"""Global-effects tour: delay, spring + plate reverb, tilt, saturation,
compressor (port of examples/effects_lab.py; the reference's delay.rs,
reverb.rs, reverb_lab.rs, tilt_filter.rs)."""

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut


def main(seconds: float = 3.0, out_path: str = "/tmp/gooey_fx.wav", *, device=None,
         blocks=None):
    engine = Engine(44100.0, device=card_or(device, "effects_lab example"))
    engine.add_instrument("snare", "snare")
    seq = engine.new_sequencer("snare", 100.0)
    seq.set_pattern_string("x...x...x...x...")
    seq.start()
    engine.add_global_effect("delay", [0.375, 0.45, 0.35, 6000.0])
    engine.add_global_effect("spring", [0.6, 0.25, 0.5])
    engine.add_global_effect("tilt", [0.35, 0.0])
    engine.add_global_effect("saturation", [0.4, 0.5, 0.8])

    (n,) = cut([int(44100 * seconds)], blocks)
    engine.bounce_to_wav(out_path, n)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
