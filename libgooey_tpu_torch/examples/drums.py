"""Each drum voice solo, then a full kit groove (port of examples/drums.py;
mirrors the reference's kick.rs / snare.rs / hihat.rs / hihat2.rs / tom.rs /
tom2.rs examples)."""

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.engine import Engine
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.instruments.kick import KickConfig


def main(seconds: float = 2.0, out_path: str = "/tmp/gooey_drums.wav", *, device=None,
         blocks=None):
    engine = Engine(44100.0, device=card_or(device, "drums example"))
    engine.add_instrument("kick", "kick", KickConfig.punch_preset())
    engine.add_instrument("snare", "snare")
    engine.add_instrument("hat", "hihat2")
    engine.add_instrument("tom", "tom2")

    for name, steps in (("kick", "x...x...x...x..."),
                        ("snare", "....x.......x..."),
                        ("hat", "9.5.9.5.9.5.9.7.")):
        seq = engine.new_sequencer(name, 120.0)
        seq.set_pattern_string(steps)
        seq.start()
    engine.trigger("tom", 0.9)

    (n,) = cut([int(44100 * seconds)], blocks)
    engine.bounce_to_wav(out_path, n)
    print(f"wrote {out_path} ({n} samples)")
    return out_path


if __name__ == "__main__":
    main()
