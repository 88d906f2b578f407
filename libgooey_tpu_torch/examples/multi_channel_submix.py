"""Multi-channel submix: drum kit on track 0, bass loop on track 1, live
gain/mute/solo plus a per-track effect rack, all through the C-API surface
(port of examples/multi_channel_submix.py; mirrors the reference's
examples/multi_channel_submix.rs)."""

import numpy as np

from libgooey_tpu_torch import capi, card_or
from libgooey_tpu_torch.examples import cut
from libgooey_tpu_torch.io_wav import write_wav
from libgooey_tpu_torch.mixer.chain import EFFECT_LOWPASS_FILTER
from libgooey_tpu_torch.mixer.graph import SOURCE_BASS, SOURCE_DRUMKIT

SR = 44100


def main(out_path: str = "/tmp/gooey_submix.wav", quick: bool = False, *, device=None,
         blocks=None):
    n = SR // 4 if quick else SR
    lengths = iter(cut([2 * n, n, n, n], blocks))
    h = capi._engine_new_on(float(SR), card_or(device, "multi_channel_submix example"))
    capi.engine_set_bpm(h, 116.0)

    # drum beat on channels 0-2 (kick/snare/hihat2 in the default kit)
    for ch, steps in ((0, (0, 4, 8, 12)), (1, (4, 12)), (2, (2, 6, 10, 14))):
        for s in steps:
            capi.engine_sequencer_set_step(h, ch, s, 1, 0.9)
        capi.engine_sequencer_start(h, ch)

    # bass loop on strip 4 (the dedicated bass sequencer) with step notes
    for s, note in ((0, 33), (3, 36), (8, 31), (11, 36), (14, 38)):
        capi.engine_sequencer_set_step(h, 4, s, 1, 0.9)
        capi.engine_sequencer_set_step_note(h, 4, s, note)
    capi.engine_sequencer_start(h, 4)

    # two-track submix layout: drums -> track 0, bass -> track 1
    capi.engine_mixer_clear_layout(h)
    t_drums = capi.engine_mixer_add_track(h, "Track 1 - Drum Beat")
    t_bass = capi.engine_mixer_add_track(h, "Track 2 - Bass Loop")
    capi.engine_mixer_route_source(h, SOURCE_DRUMKIT, t_drums)
    capi.engine_mixer_route_source(h, SOURCE_BASS, t_bass)
    capi.engine_mixer_set_track_gain(h, t_drums, 0.85)
    capi.engine_mixer_set_track_gain(h, t_bass, 0.75)

    # the small per-track rack: a lowpass on the bass submix
    capi.engine_track_effect_add(h, t_bass, EFFECT_LOWPASS_FILTER)
    capi.engine_track_effect_set_param(h, t_bass, 0, 0, 1800.0)

    capi.engine_transport_start(h)
    sections = [capi.engine_render(h, next(lengths))]
    print("peaks:",
          f"drums {capi.engine_mixer_get_track_peak(h, t_drums):.3f}",
          f"bass {capi.engine_mixer_get_track_peak(h, t_bass):.3f}")

    # mute the drums, then solo them (mute wins silence, solo isolates)
    capi.engine_mixer_set_track_mute(h, t_drums, 1)
    sections.append(capi.engine_render(h, next(lengths)))
    capi.engine_mixer_set_track_mute(h, t_drums, 0)
    capi.engine_mixer_set_track_solo(h, t_drums, 1)
    sections.append(capi.engine_render(h, next(lengths)))
    capi.engine_mixer_set_track_solo(h, t_drums, 0)
    sections.append(capi.engine_render(h, next(lengths)))

    inter = np.concatenate(sections)
    write_wav(out_path, inter.reshape(-1, 2).T, SR)
    capi.engine_free(h)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    main()
