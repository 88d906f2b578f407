"""Build and bounce an engine from a text program (port of
examples/dsl_demo.py; the reference's dsl.rs, examples/programs/*.gooey)."""

from libgooey_tpu_torch import card_or, dsl
from libgooey_tpu_torch.examples import cut

PROGRAM = """
bpm 124
master 0.3
inst kick kick tight
inst hat hihat2 short
inst snare snare smack
seq kick x...x...x...x...
seq snare ....x.......x..x
seq hat 9.5.9.5.9.5.9.5. swing=0.55
lfo 1bar hat.decay amt=0.7
fx lowpass 9000 0.2
fx spring 0.4 0.25 0.4
"""


def main(seconds: float = 4.0, out_path: str = "/tmp/gooey_dsl.wav", *, device=None,
         blocks=None):
    engine = dsl.build_engine(PROGRAM, device=card_or(device, "dsl_demo example"))
    (n,) = cut([int(44100 * seconds)], blocks)
    engine.bounce_to_wav(out_path, n)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
