"""Loop mixer + Ableton-style clip grid: load two clips, launch quantized,
stop (port of examples/loops_and_clips.py; the reference's loop_mixer.rs,
tests/clip_grid.rs)."""

import numpy as np

from libgooey_tpu_torch import card_or
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.gooey import GooeyEngine
from libgooey_tpu_torch.io_wav import write_wav
from libgooey_tpu_torch.mixer.stereo_buffer import StereoSampleBuffer


def main(seconds: float = 4.0, out_path: str = "/tmp/gooey_clips.wav", *, device=None,
         blocks=None):
    g = GooeyEngine(44100.0, device=card_or(device, "loops_and_clips example"))
    sr, bpm = 44100.0, 120.0
    first_n, second_n = cut([int(sr * seconds / 2)] * 2, blocks)
    one_bar = int(sr * 60.0 / bpm * 4)
    t = np.arange(one_bar) / sr
    loop_a = (0.4 * np.sin(2 * np.pi * 110 * t)).astype(np.float32)
    loop_b = (0.4 * np.sign(np.sin(2 * np.pi * 165 * t))).astype(np.float32)
    grid = g.mixer.clip_grid
    grid.load(0, 0, StereoSampleBuffer(loop_a, loop_a, sr, bpm), bpm)
    grid.load(0, 1, StereoSampleBuffer(loop_b, loop_b, sr, bpm), bpm)
    g.transport_start()
    grid.launch_quantized(0, 0)                  # lands at the next bar (beat 0)
    first = g.render(first_n)
    grid.launch_quantized(0, 1)                  # quantized switch to clip B
    second = g.render(second_n)
    inter = np.concatenate([first, second])
    write_wav(out_path, inter.reshape(-1, 2).T, int(sr))
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
