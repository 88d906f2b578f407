"""Sampler rack: load slots, sequence them, route into the submix graph
(port of examples/sampler_rack.py; the reference's sampler_rack.rs,
multi_channel_submix.rs)."""

import numpy as np

from libgooey_tpu_torch import capi, card_or
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.io_wav import write_wav


def main(seconds: float = 2.0, out_path: str = "/tmp/gooey_sampler.wav", *, device=None,
         blocks=None):
    h = capi._engine_new_on(44100.0, card_or(device, "sampler_rack example"))
    rack = capi.engine_sampler_register(h)
    capi.engine_mixer_route_source(h, capi.engine_sampler_get_source_id(h, rack), 3)
    t = np.arange(4410) / 44100.0
    blip = (np.sin(2 * np.pi * 880 * t) * np.exp(-30 * t)).astype(np.float32)
    thump = (np.sin(2 * np.pi * 90 * t) * np.exp(-12 * t)).astype(np.float32)
    capi.engine_sampler_set_slot_buffer(h, rack, 0, thump, 1, 44100.0)
    capi.engine_sampler_set_slot_buffer(h, rack, 1, blip, 1, 44100.0)
    for step, slot in ((0, 0), (4, 1), (8, 0), (11, 1), (12, 0)):
        capi.engine_sampler_set_step(h, rack, step, 1, slot, 1.0)
    capi.engine_sampler_start_pattern(h, rack, 0.0)
    capi.engine_transport_start(h)
    (n,) = cut([int(44100 * seconds)], blocks)
    inter = capi.engine_render(h, n)
    write_wav(out_path, inter.reshape(-1, 2).T, 44100)
    capi.engine_free(h)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
