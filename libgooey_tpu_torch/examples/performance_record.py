"""Record a chord performance into the looping clip and replay it
(port of examples/performance_record.py; the reference's
performance_record.rs)."""

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.gooey import GooeyEngine
from libgooey_tpu_torch.io_wav import write_wav


def main(seconds: float = 4.0, out_path: str = "/tmp/gooey_perf.wav", *, device=None,
         blocks=None):
    g = GooeyEngine(44100.0, device=card_or(device, "performance_record example"))
    n = int(44100 * seconds)
    first_n, second_n, replay_n = cut([n // 4, n // 4, n - 2 * (n // 4)], blocks)
    g.transport_start()
    g.performance.update_clock(0.0, True)
    g.performance.set_armed(True)
    g.performance.update_clock(0.0, True)
    # play two pads while recording
    g.perf_chord_on(0, 0, 0, 0, 0, 4, 0.9)   # I chord
    first = g.render(first_n)
    g.perf_chord_off()
    g.perf_chord_on(9, 1, 0, 0, 0, 4, 0.8)   # vi-flavored pad
    second = g.render(second_n)
    g.perf_chord_off()
    g.performance.set_armed(False)
    # ...the recorded clip now replays by itself
    replay = g.render(replay_n)
    inter = np.concatenate([first, second, replay])
    write_wav(out_path, inter.reshape(-1, 2).T, 44100)
    print(f"wrote {out_path} with {len(g.performance.events)} recorded events")
    return out_path


if __name__ == "__main__":
    main()
