"""Realtime terminal scope over a sequenced kit (port of examples/scope.py):
the TUI analog of the reference's GLFW waveform window
(waveform_display.rs) driving a live engine through the output adapter."""

import io

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.engine.output import EngineOutput
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.gooey import GooeyEngine
from libgooey_tpu_torch.tui import TerminalScope
from libgooey_tpu_torch.visualization import AudioBuffer


def main(out_path: str = "/tmp/gooey_scope.txt", quick: bool = False,
         live: bool = False, *, device=None, blocks=None):
    dev = card_or(device, "scope example")
    g = GooeyEngine(44100.0, device=dev)
    g.sequencers[0].set_pattern_string("x...x...x...x...")
    g.sequencers[1].set_pattern_string("....x.......x...")
    g.sequencers[2].set_pattern_string("x.x.x.x.x.x.x.x.")
    for ch in range(3):
        g.sequencers[ch].start()

    out = EngineOutput(prefetch_blocks=0)
    out.initialize(44100.0)
    out.create_stream_with_engine(g)
    out.start()

    ring = AudioBuffer(8192)
    scope = TerminalScope(ring, width=72, height=10, sample_rate=44100.0, device=dev)

    if live:  # animate in the real terminal
        scope.run(out, seconds=2.0 if quick else 10.0, fps=20)
        out.stop()
        return out_path

    # headless: pull a few ticks and write the last frame to a file
    sink = io.StringIO()
    ticks = cut([2048] * (4 if quick else 40), blocks)
    for strip in range(3):
        scope.set_meter(f"strip{strip}", 0.0)
    for frames in ticks:
        buf = np.zeros(frames * 2, np.float32)
        out.fill(buf, 2)
        ring.push(0.5 * (buf[0::2] + buf[1::2]))
        for strip in range(3):
            scope.set_meter(f"strip{strip}", g.take_strip_peak(strip))
    frame = scope.frame()
    sink.write(frame + "\n")
    out.stop()
    with open(out_path, "w") as fh:
        fh.write(sink.getvalue())
    print(frame)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    import sys

    main(live="--live" in sys.argv)
